"""Spark-exact rand() and randn(): XORShiftRandom and the polar method (port
of ``datafusion_comet_tpu/exec/random_xorshift.py``).

Spark seeds an XORShiftRandom per partition with murmur3 of seed +
partition (two 32-bit murmur rounds over the big-endian seed bytes), takes
``nextDouble = (next(26) << 27 + next(27)) x 2^-53`` for rand and Java's
``nextGaussian`` (the polar method, its second value cached) for randn, one
draw per evaluated row. Dead rows draw nothing, so a live row's draw is
fixed by its live rank in the batch.

The JAX package runs the generator as a scan over the batch's slots. Here
each row computes its own state: the xorshift step is linear over GF(2),
so the state after n steps is M^n times the seed, and a row's M^n is the
product of the precomputed M^(2^k) for the bits of n, each applied by
eight 256-entry byte tables (XOR of eight gathers). rand equals the scan
bit for bit. randn: attempt j of the polar method reads draws 2j and
2j + 1 whatever was rejected before it, so every attempt is computed at
once, a prefix count over the accepted ones gives each pair its attempt,
and a row of even rank takes v1 x mult, the next row the cached v2 x mult.
"""

from __future__ import annotations

from functools import lru_cache
from typing import Tuple

import numpy as np
import torch

from datafusion_comet_tpu_torch import types as T
from datafusion_comet_tpu_torch.exec.batch import ColumnVector

__all__ = ["init_seed_host", "rand_column", "randn_column", "xorshift_step", "jump_tables"]

_DOUBLE_UNIT = 1.1102230246251565e-16  # 2^-53
_ARRAY_SEED = 0x3C074A61
_M64 = (1 << 64) - 1


def _m3_mix(h: int, k: int) -> int:
    k = (k * 0xCC9E2D51) & 0xFFFFFFFF
    k = ((k << 15) | (k >> 17)) & 0xFFFFFFFF
    k = (k * 0x1B873593) & 0xFFFFFFFF
    h ^= k
    h = ((h << 13) | (h >> 19)) & 0xFFFFFFFF
    return (h * 5 + 0xE6546B64) & 0xFFFFFFFF


def _m3_fmix(h: int, length: int) -> int:
    h ^= length
    h ^= h >> 16
    h = (h * 0x85EBCA6B) & 0xFFFFFFFF
    h ^= h >> 13
    h = (h * 0xC2B2AE35) & 0xFFFFFFFF
    return h ^ (h >> 16)


def _murmur3_8bytes(value: int, seed: int) -> int:
    """Spark murmur3 of the 8 big-endian bytes of ``value``."""
    b = (value & _M64).to_bytes(8, "big")
    h = seed & 0xFFFFFFFF
    for off in (0, 4):
        h = _m3_mix(h, int.from_bytes(b[off:off + 4], "little"))
    return _m3_fmix(h, 8)


def init_seed_host(seed: int, partition: int = 0) -> int:
    """XORShiftRandom.hashSeed(seed + partition), a signed 64-bit state."""
    v = seed + partition
    lo = _murmur3_8bytes(v, _ARRAY_SEED)
    hi = _murmur3_8bytes(v, lo)
    s = ((hi << 32) | lo) & _M64
    return s - (1 << 64) if s >= (1 << 63) else s


def _lsr64(x: torch.Tensor, r: int) -> torch.Tensor:
    return (x >> r) & ((1 << (64 - r)) - 1)


def xorshift_step(s: torch.Tensor) -> torch.Tensor:
    s = s ^ (s << 21)
    s = s ^ _lsr64(s, 35)
    return s ^ (s << 4)


def _step_int(s: int) -> int:
    s ^= (s << 21) & _M64
    s ^= s >> 35
    return s ^ ((s << 4) & _M64)


def _apply_cols(cols, x: int) -> int:
    out, i = 0, 0
    while x:
        if x & 1:
            out ^= cols[i]
        x >>= 1
        i += 1
    return out


_LEVELS = 48  # jumps of up to 2^48 - 1 steps: 2^46 rows' draws


@lru_cache(maxsize=1)
def jump_tables() -> np.ndarray:
    """(_LEVELS, 8, 256) int64: entry [k, b, v] is M^(2^k) applied to the
    state whose only set bits are byte b = v."""
    cols = [_step_int(1 << i) for i in range(64)]  # M's columns
    out = np.zeros((_LEVELS, 8, 256), np.uint64)
    for k in range(_LEVELS):
        for b in range(8):
            t = np.zeros(256, np.uint64)
            for j in range(8):
                t[1 << j: 2 << j] = t[: 1 << j] ^ np.uint64(cols[8 * b + j])
            out[k, b] = t
        cols = [_apply_cols(cols, c) for c in cols]  # M^(2^(k+1)) = (M^(2^k))^2
    return out.view(np.int64)


_DEVICE_TABLES: dict = {}


def _tables_on(device) -> torch.Tensor:
    key = str(device)
    t = _DEVICE_TABLES.get(key)
    if t is None:
        t = torch.from_numpy(jump_tables().reshape(-1)).to(device)
        _DEVICE_TABLES[key] = t
    return t


def jump(seed0: int, n: torch.Tensor, max_n: int) -> torch.Tensor:
    """The state ``n`` xorshift steps after ``seed0``, each row its own n
    (0 <= n <= max_n, a host bound that sets the number of levels)."""
    dev = n.device
    table = _tables_on(dev)
    x = torch.full(n.shape, seed0, dtype=torch.int64, device=dev)
    shifts = torch.arange(0, 64, 8, device=dev)
    offs = torch.arange(8, device=dev) * 256
    for k in range(max(int(max_n).bit_length(), 1)):
        idx = ((x[:, None] >> shifts) & 255) + offs + k * 2048
        parts = table[idx]
        y = parts[:, 0]
        for b in range(1, 8):
            y = y ^ parts[:, b]
        x = torch.where(((n >> k) & 1).bool(), y, x)
    return x


def _doubles(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """nextDouble from the state before its two steps -> (double, state
    after them)."""
    s1 = xorshift_step(x)
    s2 = xorshift_step(s1)
    v = (((s1 & ((1 << 26) - 1)) << 27) + (s2 & ((1 << 27) - 1))).double() * _DOUBLE_UNIT
    return v, s2


def rand_column(seed0: int, row_mask: torch.Tensor) -> ColumnVector:
    """One nextDouble per live row, in live-rank order; 0.0 on dead rows.
    Only the live rows jump (a sampled batch keeps its capacity)."""
    live = torch.nonzero(row_mask)[:, 0]
    v, _ = _doubles(jump(seed0, 2 * torch.arange(live.shape[0], device=live.device),
                         2 * max(live.shape[0], 1)))
    out = torch.zeros(row_mask.shape, dtype=torch.float64, device=row_mask.device)
    out[live] = v
    return ColumnVector(out, torch.ones_like(row_mask), None, T.FLOAT64)


def randn_column(seed0: int, row_mask: torch.Tensor) -> ColumnVector:
    """nextGaussian per live row: the polar method's attempts all at once,
    pair p from the p-th accepted attempt; 0.0 on dead rows."""
    cap = row_mask.shape[0]
    dev = row_mask.device
    rank = row_mask.long().cumsum(0) - 1
    pairs = (int(row_mask.sum()) + 1) // 2
    attempts = max(int(pairs * 1.35) + 64, 64)
    while True:
        j = torch.arange(attempts, dtype=torch.int64, device=dev)
        u1, st = _doubles(jump(seed0, 4 * j, 4 * attempts))
        u2, _ = _doubles(st)
        v1, v2 = 2.0 * u1 - 1.0, 2.0 * u2 - 1.0
        s = v1 * v1 + v2 * v2
        accepted = (s < 1.0) & (s != 0.0)
        if pairs == 0 or int(accepted.sum()) >= pairs:
            break
        attempts *= 2
    which = torch.nonzero(accepted)[:, 0][:max(pairs, 1)] if pairs else \
        torch.zeros(1, dtype=torch.int64, device=dev)
    sa = s[which]
    mult = torch.sqrt(-2.0 * torch.log(sa) / sa)
    g1, g2 = v1[which] * mult, v2[which] * mult
    r = rank.clamp(min=0)
    p = (r // 2).clamp(max=which.shape[0] - 1)
    val = torch.where(r % 2 == 0, g1[p], g2[p])
    return ColumnVector(torch.where(row_mask, val, 0.0), torch.ones_like(row_mask), None,
                        T.FLOAT64)

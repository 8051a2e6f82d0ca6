"""Wide-decimal (precision > 18) column arithmetic over two-limb i128
storage (port of ``datafusion_comet_tpu/exec/decimal_wide.py``, the subset
the ported queries reach, with the float conversions).

A two-limb column stores ``data`` as a (rows, 2) int64 [hi, lo] matrix.
Aggregation splits each i128 into four 32-bit lanes whose int64 sums cannot
overflow below 2^31 rows; the per-bucket lane sums are recombined with
carries once per group (decompose4 / recombine4).
"""

from __future__ import annotations

from typing import Tuple

import torch

from datafusion_comet_tpu_torch import types as T
from datafusion_comet_tpu_torch.exec.batch import ColumnVector
from datafusion_comet_tpu_torch.utils import int128 as i128

Pair = Tuple[torch.Tensor, torch.Tensor]

_M32 = (1 << 32) - 1


def pair(cv_data: torch.Tensor) -> Pair:
    """(rows, 2) limb matrix -> (hi, lo)."""
    return cv_data[:, 0].long(), cv_data[:, 1].long()


def pack(p: Pair) -> torch.Tensor:
    return torch.stack([p[0], p[1]], dim=1)


def lift(cv: ColumnVector, k: int = 0) -> Pair:
    """Column (narrow 1-D int64 OR two-limb) -> i128, times 10^k."""
    p = pair(cv.data) if cv.is_wide_storage else i128.from_i64(cv.data.long())
    return i128.mul_pow10_i128(p, k) if k > 0 else p


def fits_i64(p: Pair) -> torch.Tensor:
    """True where the i128 value fits a signed 64-bit."""
    return p[0] == (p[1] >> 63)


def compare(a: Pair, b: Pair) -> Tuple[torch.Tensor, torch.Tensor]:
    """(eq, lt) under signed 128-bit order."""
    eq = (a[0] == b[0]) & (a[1] == b[1])
    lt = (a[0] < b[0]) | ((a[0] == b[0]) & i128._u64_lt(a[1], b[1]))
    return eq, lt


def rescale(p: Pair, k: int) -> Pair:
    """Scale by 10^k: up is exact (overflow excluded by typing), down HALF_UP."""
    if k == 0:
        return p
    if k > 0:
        return i128.mul_pow10_i128(p, k)
    return i128.div_pow10_i128_half_up(p, -k)


def f64_to_i64_sat(x: torch.Tensor) -> torch.Tensor:
    """Float to int64 as XLA converts it: truncated toward zero, saturated
    at the int64 bounds, NaN to 0 (PyTorch leaves out-of-range values
    undefined)."""
    big, small = x >= 2.0**63, x < -(2.0**63)
    out = torch.where(big | small | torch.isnan(x), torch.zeros_like(x), x).long()
    return torch.where(big, (1 << 63) - 1, torch.where(small, -(1 << 63), out))


def f64_to_i128(x: torch.Tensor) -> Pair:
    """An integral float64 -> i128 (JAX ``decimal_wide.py:215``): the
    magnitude's high limb and its low limb in two 32-bit halves, negated
    for a negative value. Beyond 2^127 the high limb saturates."""
    ax = x.abs()
    hi_f = torch.floor(ax / 2.0**64)
    lo_f = ax - hi_f * 2.0**64
    lo_hi = torch.floor(lo_f / 2.0**32)
    lo_lo = lo_f - lo_hi * 2.0**32
    p = (f64_to_i64_sat(hi_f), (lo_hi.long() << 32) | lo_lo.long())
    return i128.select(x < 0, i128.neg(p), p)


def overflow_check(p: Pair, precision: int) -> torch.Tensor:
    """True where |value| >= 10^precision (Spark decimal overflow)."""
    return i128.cmp_ge_u(i128.abs_(p), i128.const_u128(10**precision, p[1]))


def arith(op: str, l: ColumnVector, r: ColumnVector, lt: T.DataType, rt: T.DataType,
          out: T.DataType) -> Tuple[Pair, torch.Tensor]:
    """add/sub/mul/div/mod/pmod over i128; returns (value pair, invalid
    mask) where invalid marks division-by-zero rows (the caller owns ANSI
    handling)."""
    s1, s2, so = lt.scale, rt.scale, out.scale
    zero_div = torch.zeros(l.capacity, dtype=torch.bool, device=l.data.device)
    if op in ("add", "sub"):
        a, b = lift(l, so - s1), lift(r, so - s2)
        res = i128.add(a, b) if op == "add" else i128.sub(a, b)
    elif op == "mul":
        raw = s1 + s2
        if not l.is_wide_storage and not r.is_wide_storage:
            # i64 x i64 <= 2^126: always exact in i128
            res = i128.mul_i64(l.data.long(), r.data.long())
            if raw != so:
                res = rescale(res, so - raw)
        else:
            # exact wide multiply through a u256 intermediate with a fused
            # /10^k HALF_UP; rows beyond i128 come back saturated to 10^38
            res, over_m = i128.mul_i128_i128_scaled(lift(l), lift(r), max(raw - so, 0))
            if so > raw:
                big = i128.to_f64(res).abs() * (10.0 ** (so - raw)) >= 1e38
                up = i128.mul_pow10_i128(res, so - raw)
                res = i128.select(over_m | big, i128.const_u128(10**38, res[1]), up)
    elif op == "div":
        k = so - s1 + s2
        num = lift(l, max(k, 0))
        if k < 0:
            num = rescale(num, k)
        if r.is_wide_storage:
            den = lift(r)
            zero_div = (den[0] == 0) & (den[1] == 0)
            res = i128.div_i128_i128_half_up(
                num, (den[0], torch.where(zero_div, torch.ones_like(den[1]), den[1])))
        else:
            den = r.data.long()
            zero_div = den == 0
            res = _div_i128_i64_full(num, torch.where(zero_div, torch.ones_like(den), den))
    elif op in ("mod", "pmod"):
        # truncated remainder at the common scale (JAX ``decimal_wide.py:181-197``)
        s = max(s1, s2)
        a, b = lift(l, s - s1), lift(r, s - s2)
        zero_div = (b[0] == 0) & (b[1] == 0)
        safe = (b[0], torch.where(zero_div, torch.ones_like(b[1]), b[1]))
        _, rem = i128.divmod_u128_u128(i128.abs_(a), i128.abs_(safe))
        m = i128.select(a[0] < 0, i128.neg(rem), rem)
        if op == "pmod":
            m = i128.select(i128.is_negative(m), i128.add(m, i128.abs_(safe)), m)
        res = rescale(m, so - s)
    else:
        raise NotImplementedError(op)
    return res, zero_div


def _div_i128_i64_full(num: Pair, den: torch.Tensor, den_bound=None) -> Pair:
    """Signed i128 / i64 HALF_UP with the full i128 quotient. ``den_bound``:
    a host-known bound on |den| (see int128.divmod_u128_u64)."""
    sign_neg = i128.is_negative(num) ^ (den < 0)
    ua = i128.abs_(num)
    uden = torch.where(den < 0, -den, den)
    q, r = i128.divmod_u128_u64(ua[0], ua[1], uden, den_bound)
    round_up = ~i128._u64_lt(r * 2, uden)
    q = i128.add(q, (torch.zeros_like(q[0]), round_up.long()))
    return i128.select(sign_neg, i128.neg(q), q)


def digits_39(p: Pair) -> Tuple[torch.Tensor, torch.Tensor]:
    """|i128| -> (its 39 decimal digits little-endian, (rows, 39) int64,
    negative mask): two 128 / 10^18 divisions cut the magnitude into three
    chunks."""
    ua = i128.abs_(p)
    p18 = torch.full_like(ua[1], 10**18)
    q1, r1 = i128.divmod_u128_u64(ua[0], ua[1], p18)
    q2, r2 = i128.divmod_u128_u64(q1[0], q1[1], p18)
    digs = []
    for x, n in ((r1, 18), (r2, 18), (q2[1], 3)):
        for _ in range(n):
            digs.append(x % 10)
            x = x // 10
    return torch.stack(digs, dim=1), i128.is_negative(p)


def decompose4(p: Pair) -> Tuple[torch.Tensor, ...]:
    """i128 -> four int64 lanes of 32-bit limbs (l0..l2 unsigned in
    [0, 2^32), l3 the signed top limb). Each lane sums without overflow over
    fewer than 2^31 rows."""
    hi, lo = p
    return lo & _M32, (lo >> 32) & _M32, hi & _M32, hi >> 32


def recombine4(s0: torch.Tensor, s1: torch.Tensor, s2: torch.Tensor, s3: torch.Tensor) -> Pair:
    """Inverse of decompose4 after per-lane summation (carries fold mod
    2^128, exact while the true total fits i128)."""
    t0 = i128.from_i64(s0)
    t1 = i128.shl_bits(i128.from_i64(s1), 32)
    t2 = i128.shl_bits(i128.from_i64(s2), 64)
    t3 = i128.shl_bits(i128.from_i64(s3), 96)
    return i128.add(i128.add(t0, t1), i128.add(t2, t3))

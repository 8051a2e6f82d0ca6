"""Spark's runtime bloom filter: the BLOOM_FILTER aggregate and its probe
(port of the bloom part of
``datafusion_comet_tpu/exec/operators/agg_special.py``:
``bloom_num_hash_functions``, ``_bloom_hashes``, ``_bloom_bit_indices``,
``bloom_agg``, ``parse_bloom_bytes`` and ``bloom_might_contain``; the
other special aggregates of that module, collect_*, percentile, median,
approx_count_distinct and approx_percentile, are not ported).

A value's k bit indices are Spark's (``BloomFilterImpl.putLong``): h1 =
murmur3 hashLong of the value under seed 0 (a string: hashUnsafeBytes of
its bytes), h2 = the same under seed h1, and for i in 1..k the int32 sum
h1 + i * h2 (wrapping), bit-inverted where negative, mod the bit count.
The aggregate scatters each valid row's k bits into its group's bit array
and packs the bits into Spark's serialized form (``BloomFilterImpl.
writeTo``): version 1, k and the number of longs as big-endian int32s, then
each long big-endian, bit j of a long being ``1L << j``. The probe parses
such bytes on the host, copies the longs to the device once, and tests the
k bits of every row with k gathers.
"""

from __future__ import annotations

import math
from typing import List, Optional, Tuple

import numpy as np
import torch

from datafusion_comet_tpu_torch import types as T
from datafusion_comet_tpu_torch.exec.batch import ColumnVector
from datafusion_comet_tpu_torch.exec.evaluator import (_i32, murmur3_hash_bytes,
                                                      murmur3_hash_i64)
from datafusion_comet_tpu_torch.ir import expr as E

__all__ = ["bloom_num_hash_functions", "bloom_bit_indices", "bloom_agg", "parse_bloom_bytes",
           "bloom_might_contain", "DEFAULT_EXPECTED_ITEMS"]

# Spark's spark.sql.optimizer.runtime.bloomFilter.expectedNumItems default
DEFAULT_EXPECTED_ITEMS = 1_000_000


def bloom_num_hash_functions(num_bits: int, num_items: int) -> int:
    """Spark's BloomFilter.optimalNumOfHashFunctions: max(1, round(m / n ln 2))."""
    return max(1, int(round(num_bits / max(num_items, 1) * math.log(2))))


def _hashes(cv: ColumnVector) -> Tuple[torch.Tensor, torch.Tensor]:
    """(h1, h2) int32 per row. A dictionary column hashes its entries and
    gathers them by code; padded bytes hash as they are; any other value
    hashes as a long."""
    if cv.dtype.is_binary:
        if cv.is_dict:
            vals, lens = cv.dictionary.device_arrays(cv.data.device, cv.dtype.byte_width)
            h1, h2 = _byte_hashes(vals, lens)
            idx = cv.data.long().clamp(0, max(cv.dictionary.size - 1, 0))
            return h1[idx], h2[idx]
        return _byte_hashes(cv.data, cv.lengths)
    x = cv.data.long()
    h1 = murmur3_hash_i64(x, torch.zeros((), dtype=torch.int32, device=x.device))
    return h1, murmur3_hash_i64(x, h1)


def _byte_hashes(mat: torch.Tensor, lens: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    h1 = murmur3_hash_bytes(mat, lens, torch.zeros((), dtype=torch.int32, device=mat.device))
    return h1, murmur3_hash_bytes(mat, lens, h1)


def bloom_bit_indices(cv: ColumnVector, k: int, num_bits: int) -> List[torch.Tensor]:
    """The k int64 bit indices of every row (Spark's combined hashes)."""
    h1, h2 = (h.long() for h in _hashes(cv))
    out = []
    for i in range(1, k + 1):
        c = _i32((h1 + i * h2) & 0xFFFFFFFF)
        out.append(torch.where(c < 0, ~c, c).long() % num_bits)
    return out


def _num_hash_functions(a: E.AggExpr) -> int:
    items = int(a.extra[0].value) if a.extra else DEFAULT_EXPECTED_ITEMS
    return bloom_num_hash_functions(a.num_bits, items)


def bloom_agg(a: E.AggExpr, cv: ColumnVector, valid: torch.Tensor, seg: torch.Tensor, m: int,
              has: torch.Tensor) -> ColumnVector:
    """The serialized filter of each of ``m`` groups over ``cv``'s ``valid``
    rows (``seg``: each row's group, ``m`` on dead rows); null where a group
    has no valid row (``has`` false)."""
    num_bits = a.num_bits
    if num_bits % 64:
        raise ValueError(f"bloom filter of {num_bits} bits: not a multiple of 64")
    k = _num_hash_functions(a)
    dev = cv.data.device
    sink = m * num_bits
    base = torch.where(valid, seg.long().clamp(max=m) * num_bits, sink)
    bits = torch.zeros(sink + 1, dtype=torch.uint8, device=dev)
    for idx in bloom_bit_indices(cv, k, num_bits):
        bits.index_fill_(0, torch.where(valid, base + idx, sink), 1)
    W = num_bits // 64
    # bit 8j + t of a long is bit t of its little-endian byte j, which is
    # byte 7 - j of the big-endian long
    weights = torch.tensor([1 << t for t in range(8)], dtype=torch.uint8, device=dev)
    le = (bits[:sink].view(m, W, 8, 8) * weights).sum(3, dtype=torch.uint8)
    header = np.array([1, k, W], dtype=">i4").view(np.uint8)
    hdr = torch.from_numpy(header.copy()).to(dev).expand(m, 12)
    data = torch.cat([hdr, le.flip(2).reshape(m, W * 8)], 1)
    total = 12 + W * 8
    return ColumnVector(data, has, torch.full((m,), total, dtype=torch.int32, device=dev),
                        T.binary(total))


def parse_bloom_bytes(buf: bytes) -> Tuple[int, np.ndarray]:
    """(k, the filter's longs as int64) of Spark's serialized form."""
    version = int.from_bytes(buf[0:4], "big", signed=True)
    if version != 1:
        raise ValueError(f"unsupported bloom filter version {version}")
    k = int.from_bytes(buf[4:8], "big", signed=True)
    w = int.from_bytes(buf[8:12], "big", signed=True)
    return k, np.frombuffer(buf[12:12 + w * 8], dtype=">i8").astype(np.int64)


def bloom_might_contain(filter_bytes: Optional[bytes], cv: ColumnVector) -> ColumnVector:
    """Whether each row may be in the filter (no false negative); null
    where the row is null, every row null where the filter is."""
    cap, dev = cv.capacity, cv.data.device
    if filter_bytes is None:
        none = torch.zeros(cap, dtype=torch.bool, device=dev)
        return ColumnVector(none, none, None, T.BOOL)
    k, words = parse_bloom_bytes(filter_bytes)
    table = torch.from_numpy(words).to(dev)
    ok = torch.ones(cap, dtype=torch.bool, device=dev)
    for idx in bloom_bit_indices(cv, k, words.shape[0] * 64):
        ok &= ((table[idx >> 6] >> (idx & 63)) & 1).bool()
    return ColumnVector(ok, cv.validity, None, T.BOOL)

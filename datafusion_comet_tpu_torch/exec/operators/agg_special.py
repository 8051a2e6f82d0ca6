"""The special aggregates (port of
``datafusion_comet_tpu/exec/operators/agg_special.py``): Spark's runtime
bloom filter and its probe, collect_list and collect_set, the exact
percentile (of one percentage or a list of them) and median,
approx_count_distinct (a HyperLogLog sketch) and approx_percentile.

Each takes its input column ``cv``, the rows that count (``valid``) and
each row's group (``seg``, ``m`` on the rest) in one row order: the
original rows on the aggregate's dense path, the group-sorted rows on its
sorted path. Neither order matters to them: each sorts its rows by (group,
value) itself where it needs an order.

**collect_list / collect_set** (JAX :69-140): each group's valid values,
in input order (the set: its distinct values, in value order, as the JAX
package gives them), scattered into a (groups, E) element block, E =
``AggExpr.max_elems``. A group's values past E are dropped, as in the JAX
package (ROADMAP C31; Spark's lists are unbounded). A PARTIAL state is the
list itself; a merge collects the states' elements again, in state order
(``collect_merge``). A dictionary-coded string is decoded first.

**percentile / median** (JAX :142-210): Spark's exact percentile, linear
interpolation at rank (n - 1) x p among a group's valid values sorted
ascending: ``value(lo) + (value(hi) - value(lo)) x frac``, op for op as the
JAX package computes it (a -0.0 value reads as 0.0 there, and here). One
literal percentage gives a DOUBLE, a list of them an ARRAY<DOUBLE>. The
value is read as a DOUBLE, a decimal by its value (the JAX package reads a
decimal's unscaled integer, as its variance does: ROADMAP C20).

**approx_count_distinct** (JAX :213-270): a dense HyperLogLog of p = 9 (512
registers): xxhash64 of each valid value under seed 42, its top 9 bits pick
a register, the leading zeros of the other 55 plus one its rank; registers
take the max per group, and the estimate is the raw HLL one, or linear
counting in the small range. Spark's HLL++ also corrects the raw estimate
by its empirical bias table; the JAX package omits the table, and the port
copies the JAX package (ROADMAP: a reference fault).

**approx_percentile** (JAX :399-560): SINGLE mode gives the exact element
of rank ceil(p x n) (1-indexed), which meets any accuracy. PARTIAL keeps K
equi-rank samples per group (K = ``Config.approx_percentile_sketch``) and
its count, each sample stored as a float32 pair (value, residual) in 8K
bytes; FINAL places every sample of a group's sketches on the merged rank
axis, weighted by its sketch's count over K, and returns the first whose
cumulative weight reaches p x n; PARTIAL_MERGE compresses the union back to
K samples.

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

import contextlib
import contextvars
import math
from typing import List, Optional, Tuple

import numpy as np
import torch

from datafusion_comet_tpu_torch import types as T
from datafusion_comet_tpu_torch.exec.batch import ColumnVector, map_buffers
from datafusion_comet_tpu_torch.conf import Config
from datafusion_comet_tpu_torch.exec import sortkeys
from datafusion_comet_tpu_torch.exec.evaluator import (_coerce, _i32, murmur3_hash_bytes,
                                                      murmur3_hash_i64, xxhash64_column)
from datafusion_comet_tpu_torch.ir import expr as E

__all__ = ["bloom_num_hash_functions", "bloom_bit_indices", "bloom_agg", "parse_bloom_bytes",
           "bloom_might_contain", "DEFAULT_EXPECTED_ITEMS", "percentile_agg", "hll_agg",
           "approx_percentile_exact", "approx_percentile_partial", "approx_percentile_merge",
           "sketch_size", "HLL_P", "collect_agg", "collect_merge"]

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


# -------------------------------------------------------------------------------------
# shared: rows sorted by (group, value)
# -------------------------------------------------------------------------------------


def _group_sorted(cv: ColumnVector, valid: torch.Tensor, seg: torch.Tensor, m: int,
                  limbs: Optional[List[torch.Tensor]] = None):
    """(perm, sorted valid, sorted group (m where invalid), rows per group,
    each group's first sorted row): the rows by group, then by ``limbs``
    (the value's order limbs by default), the invalid ones last."""
    g = torch.where(valid, seg.long(), m)
    perm = sortkeys.lexsort([g] + (sortkeys.column_limbs(cv) if limbs is None else limbs))
    sv = valid[perm]
    g2 = g[perm]
    n = torch.zeros(m + 1, dtype=torch.int64, device=g.device).index_add_(0, g2, sv.long())[:m]
    return perm, sv, g2, n, torch.cumsum(n, 0) - n


def _at(x: torch.Tensor, start: torch.Tensor, k: torch.Tensor) -> torch.Tensor:
    """``x[start + k]`` per group, clamped into ``x``."""
    return x[(start + k).clamp(0, max(x.shape[0] - 1, 0))]


# -------------------------------------------------------------------------------------
# exact percentile / median
# -------------------------------------------------------------------------------------


def _percentages(a: E.AggExpr) -> Tuple[List[float], bool]:
    """(the percentages, whether they are a list)."""
    if a.func == E.AggFunc.MEDIAN:
        return [0.5], False
    lit = a.extra[0] if a.extra else None
    if not isinstance(lit, E.Literal):
        raise ValueError("percentile: the percentage must be a literal")
    if isinstance(lit.value, (list, tuple)):
        return [float(v) for v in lit.value], True
    return [float(lit.value)], False


def percentile_agg(a: E.AggExpr, cv: ColumnVector, valid: torch.Tensor, seg: torch.Tensor,
                   m: int, group_mask: torch.Tensor) -> ColumnVector:
    """PERCENTILE or MEDIAN of each group's valid values: a DOUBLE, or for
    a list of k percentages an ARRAY<DOUBLE> of k (JAX :201); null where a
    group has none."""
    ps, is_list = _percentages(a)
    perm, _, _, n, start = _group_sorted(cv, valid, seg, m)
    x = _coerce(cv, T.FLOAT64).data[perm]
    has = (n > 0) & group_mask
    per_p = []
    for p in ps:
        target = (n.double() - 1.0) * p
        lo, hi = target.floor(), target.ceil()
        frac = target - lo
        # + 0.0: a -0.0 value reads as 0.0, as the JAX package's segment sum reads it
        v_lo = _at(x, start, lo.long()) + 0.0
        v_hi = _at(x, start, hi.long()) + 0.0
        per_p.append(torch.where(has, v_lo + (v_hi - v_lo) * frac, 0.0))
    if not is_list:
        return ColumnVector(per_p[0], has, None, T.FLOAT64)
    k = len(ps)
    elem = ColumnVector(torch.stack(per_p, 1), has[:, None].expand(m, k).clone(), None,
                        T.FLOAT64)
    return ColumnVector(torch.full((m,), k, dtype=torch.int32, device=has.device), has, None,
                        T.list_(T.FLOAT64, k), children=(elem,))


# -------------------------------------------------------------------------------------
# collect_list / collect_set
# -------------------------------------------------------------------------------------


def collect_agg(a: E.AggExpr, cv: ColumnVector, valid: torch.Tensor, seg: torch.Tensor,
                m: int, group_mask: torch.Tensor) -> ColumnVector:
    """COLLECT_LIST or COLLECT_SET of each group's ``valid`` rows of ``cv``
    (rows in input order within a group): a LIST of at most ``a.max_elems``
    elements; a group's values past that are dropped (ROADMAP C31)."""
    cv = cv.decode()
    e_cap = a.max_elems
    g = torch.where(valid, seg.long(), m)
    if a.func == E.AggFunc.COLLECT_SET:  # the first row of each (group, value) run
        limbs = [g] + sortkeys.column_limbs(cv)
        perm = sortkeys.lexsort(limbs)
        changed = torch.zeros_like(valid)
        changed[0] = True
        for lb in limbs:
            s = lb[perm]
            changed[1:] |= s[1:] != s[:-1]
        keep = valid[perm] & changed
    else:
        perm = torch.sort(g, stable=True).indices
        keep = valid[perm]
    g2 = g[perm]
    # each kept row's slot: its rank among its group's kept rows
    cnt = keep.long().cumsum(0)
    start = torch.searchsorted(g2, g2)
    pos = cnt - 1 - torch.where(start > 0, cnt[(start - 1).clamp(min=0)], 0)
    slot_ok = keep & (pos < e_cap) & (g2 < m)
    flat = torch.where(slot_ok, g2 * e_cap + pos, m * e_cap)

    def scatter(x: torch.Tensor) -> torch.Tensor:
        out = x.new_zeros((m * e_cap + 1,) + tuple(x.shape[1:]))
        out[flat] = x[perm]
        return out[: m * e_cap].reshape((m, e_cap) + tuple(x.shape[1:]))

    elem = map_buffers(cv, scatter)
    lens = torch.zeros(m + 1, dtype=torch.int64, device=g.device).index_add_(
        0, torch.where(slot_ok, g2, m), slot_ok.long())[:m]
    return ColumnVector(lens.int(), group_mask, None, T.list_(cv.dtype, e_cap),
                        children=(elem,))


def collect_merge(a: E.AggExpr, st: ColumnVector, live: torch.Tensor, seg: torch.Tensor,
                  m: int, group_mask: torch.Tensor) -> ColumnVector:
    """Merge collect states (lists, one a row, ``live`` rows only) per
    group: their elements, row by row and in each list's order, collected
    again (the set: de-duplicated again)."""
    elem = st.children[0]
    n, e_cap = elem.validity.shape
    from datafusion_comet_tpu_torch.exec.nested import present

    ok = (present(st) & elem.validity & (live & st.validity)[:, None]).reshape(-1)
    flat = map_buffers(elem, lambda x: x.reshape((n * e_cap,) + tuple(x.shape[2:])))
    return collect_agg(a, flat, ok, seg.repeat_interleave(e_cap), m, group_mask)


# -------------------------------------------------------------------------------------
# HyperLogLog approx_count_distinct
# -------------------------------------------------------------------------------------

HLL_P = 9  # 512 registers: Spark's default relative error 0.05


def _clz64(x: torch.Tensor) -> torch.Tensor:
    """Leading zeros of each int64 (64 for 0), by halving (JAX ``_clz64``)."""
    n = torch.zeros(x.shape, dtype=torch.int32, device=x.device)
    y = x
    for shift in (32, 16, 8, 4, 2, 1):
        top_zero = (y >> (64 - shift)) == 0
        n = torch.where(top_zero, n + shift, n)
        y = torch.where(top_zero, y << shift, y)
    return torch.where(x == 0, 64, n)


def hll_agg(a: E.AggExpr, cv: ColumnVector, valid: torch.Tensor, seg: torch.Tensor, m: int,
            group_mask: torch.Tensor) -> ColumnVector:
    """APPROX_COUNT_DISTINCT of each group's valid values, an INT64, null
    where a group has none."""
    M = 1 << HLL_P
    h = xxhash64_column(cv, torch.full((), 42, dtype=torch.int64, device=seg.device))
    reg = (h >> (64 - HLL_P)) & (M - 1)
    rank = (_clz64(h << HLL_P) + 1).clamp(max=64 - HLL_P + 1)
    # rows of a group past the capacity (seg == m) go to the sink with the
    # dead ones: their run overflows and runs again
    flat = torch.where(valid & (seg < m), seg.long() * M + reg, m * M)
    regs = torch.zeros(m * M + 1, dtype=torch.int32, device=seg.device).scatter_reduce_(
        0, flat, rank, "amax")[:m * M].view(m, M)
    alpha = 0.7213 / (1.0 + 1.079 / M)
    z = torch.exp2(-regs.double()).sum(1)
    est = alpha * M * M / z
    zeros = (regs == 0).sum(1).double()
    lin = M * torch.log(M / zeros.clamp(min=1.0))
    est = torch.where((est <= 2.5 * M) & (zeros > 0), lin, est)
    has = torch.zeros(m + 1, dtype=torch.bool, device=seg.device).index_fill_(
        0, torch.where(valid, seg.long(), m), True)[:m] & group_mask
    return ColumnVector(est.round().long(), has, None, T.INT64)


# -------------------------------------------------------------------------------------
# approx_percentile
# -------------------------------------------------------------------------------------

_SKETCH = contextvars.ContextVar("approx_percentile_sketch",
                                 default=Config.approx_percentile_sketch)


def sketch_size() -> int:
    """K, the samples of an approx_percentile sketch that binding gives
    its PARTIAL state (``sketch_scope``; ``Config`` default)."""
    return _SKETCH.get()


@contextlib.contextmanager
def sketch_scope(k: int):
    """Bind plans with K = ``k`` (a session binds under its Config's)."""
    token = _SKETCH.set(int(k))
    try:
        yield
    finally:
        _SKETCH.reset(token)


def _pct_params(a: E.AggExpr) -> float:
    lit = a.extra[0] if a.extra else None
    if not isinstance(lit, E.Literal):
        raise ValueError("approx_percentile: the percentage must be a literal")
    p = float(lit.value)
    if not 0.0 <= p <= 1.0:
        raise ValueError(f"approx_percentile percentage {p} not in [0, 1]")
    if len(a.extra) > 1 and isinstance(a.extra[1], E.Literal) and int(a.extra[1].value) <= 0:
        raise ValueError(f"approx_percentile accuracy must be positive, got {a.extra[1].value}")
    return p


def _numeric(cv: ColumnVector) -> ColumnVector:
    if cv.dtype.is_binary or cv.is_wide_storage:
        raise NotImplementedError("approx_percentile over non-numeric input")
    return cv.decode() if cv.is_dict else cv


def _to_result(val: torch.Tensor, rt: T.DataType) -> torch.Tensor:
    """The JAX package's cast of a selected value to the result type: a
    float64 to an integer rounds to nearest even, else a plain cast."""
    dt = torch.from_numpy(np.empty(0, dtype=rt.np_dtype())).dtype
    if rt.is_integer and val.dtype == torch.float64:
        return torch.round(val).to(dt)
    return val.to(dt)


def _encode(samples: torch.Tensor) -> torch.Tensor:
    """(m, K) float64 -> (m, 8K) uint8: each sample a little-endian float32
    pair (value, residual)."""
    hi = samples.float()
    lo = (samples - hi.double()).float()
    return torch.stack([hi, lo], -1).contiguous().view(torch.uint8).reshape(samples.shape[0], -1)


def _decode(data: torch.Tensor, k: int) -> torch.Tensor:
    pair = data.contiguous().view(torch.float32).view(data.shape[0], k, 2)
    return pair[..., 0].double() + pair[..., 1].double()


def _sketch_columns(samples: torch.Tensor, n: torch.Tensor, group_mask: torch.Tensor
                    ) -> List[ColumnVector]:
    k = samples.shape[1]
    m = samples.shape[0]
    lens = torch.full((m,), 8 * k, dtype=torch.int32, device=samples.device)
    return [ColumnVector(_encode(samples), group_mask, lens, T.binary(8 * k)),
            ColumnVector(n, group_mask, None, T.INT64)]


def approx_percentile_exact(a: E.AggExpr, cv: ColumnVector, valid: torch.Tensor,
                            seg: torch.Tensor, m: int, group_mask: torch.Tensor) -> ColumnVector:
    """SINGLE mode: each group's valid value of rank ceil(p x n), of the
    input's type, null where a group has none."""
    p = _pct_params(a)
    cv = _numeric(cv)
    perm, _, _, n, start = _group_sorted(cv, valid, seg, m)
    k = (torch.ceil(p * n.double()).long() - 1).clamp(min=0)
    k = torch.minimum(k, (n - 1).clamp(min=0))
    val = _at(cv.data[perm], start, k)
    if val.is_floating_point():
        val = val + 0.0  # the JAX package's segment sum reads -0.0 as 0.0
    rt = a.result_dtype()
    has = (n > 0) & group_mask
    return ColumnVector(_to_result(torch.where(has, val, torch.zeros_like(val)), rt), has,
                        None, rt)


def approx_percentile_partial(a: E.AggExpr, cv: ColumnVector, valid: torch.Tensor,
                              seg: torch.Tensor, m: int, group_mask: torch.Tensor, k: int
                              ) -> List[ColumnVector]:
    """PARTIAL mode: each group's K equi-rank samples, sample t the value
    of rank floor((t + 0.5) n / K), and its count."""
    _pct_params(a)
    cv = _numeric(cv)
    xf = cv.data.double()
    perm, _, _, n, start = _group_sorted(
        cv, valid, seg, m, [sortkeys._float_limb(torch.where(valid, xf, 0.0))])
    x = xf[perm]
    t = torch.arange(k, dtype=torch.float64, device=x.device)
    within = torch.minimum(((t[None, :] + 0.5) * n[:, None].double() / k).long(),
                           (n[:, None] - 1).clamp(min=0))
    idx = (start[:, None] + within).clamp(0, max(x.shape[0] - 1, 0))
    return _sketch_columns(x[idx.reshape(-1)].view(m, k), n, group_mask)


def approx_percentile_merge(a: E.AggExpr, sketch: ColumnVector, cnt: ColumnVector,
                            live: torch.Tensor, seg: torch.Tensor, m: int,
                            group_mask: torch.Tensor, finalize: bool) -> List[ColumnVector]:
    """FINAL (``finalize``): the first sample, in value order, whose
    cumulative weight in its group reaches p x n, each sample weighing its
    sketch's count over K. PARTIAL_MERGE: slot t of the merged sketch takes
    the first sample whose cumulative weight reaches (t + 0.5) / K x n."""
    p = _pct_params(a)
    K = sketch.dtype.byte_width // 8
    dev = live.device
    v = _decode(sketch.data, K)
    ok = live & cnt.validity & (cnt.data > 0) & sketch.validity
    c = torch.where(ok, cnt.data, 0)
    gv = torch.where(c > 0, seg.long(), m).repeat_interleave(K)
    vv = v.reshape(-1)
    wv = (c.double() / K).repeat_interleave(K)
    pv = sortkeys.lexsort([gv, sortkeys._float_limb(torch.where(wv > 0, vv, 0.0))])
    g3, v3, w3 = gv[pv], vv[pv], wv[pv]
    cw = torch.cumsum(w3, 0)
    cw_excl = cw - w3
    newg = torch.ones_like(g3, dtype=torch.bool)
    newg[1:] = g3[1:] != g3[:-1]
    base = torch.cummax(torch.where(newg, cw_excl, 0.0), 0).values
    cwl, cwl_excl = cw - base, cw_excl - base
    ntot = torch.zeros(m + 1, dtype=torch.int64, device=dev).index_add_(
        0, torch.where(ok, seg.long(), m), c)[:m]
    if finalize:
        tgt = (p * ntot.double()).clamp(min=1e-9)
        # a group with no sample keeps the segment max's identity, -inf
        cmax = torch.full((m + 1,), float("-inf"), dtype=torch.float64,
                          device=dev).scatter_reduce_(0, g3, torch.where(w3 > 0, cwl, 0.0),
                                                      "amax")[:m]
        tgt = torch.minimum(tgt, cmax)
        t_row = torch.cat([tgt, tgt.new_zeros(1)])[g3.clamp(max=m)]
        hit = (w3 > 0) & (cwl >= t_row) & (cwl_excl < t_row)
        val = torch.zeros(m + 1, dtype=torch.float64, device=dev).index_add_(
            0, g3, torch.where(hit, v3, 0.0))[:m]
        rt = a.result_dtype()
        return [ColumnVector(_to_result(val, rt), (ntot > 0) & group_mask, None, rt)]
    nn = v3.shape[0]
    n_row = torch.cat([ntot.double().clamp(min=1.0), torch.ones(1, dtype=torch.float64,
                                                                device=dev)])[g3.clamp(max=m)]
    tf = (torch.floor(K * cwl_excl / n_row - 0.5) + 1.0).long().clamp(0, K - 1)
    slot = torch.where((w3 > 0) & (g3 < m), g3 * K + tf, m * K)
    pos = torch.arange(1, nn + 1, dtype=torch.int64, device=dev)
    filled = torch.zeros(m * K + 1, dtype=torch.int64, device=dev).scatter_reduce_(
        0, slot, pos, "amax")[:m * K]
    filled = torch.cummax(filled.view(m, K), 1).values.reshape(-1)
    samples = v3[(filled - 1).clamp(0, max(nn - 1, 0))].view(m, K)
    return _sketch_columns(samples, ntot, group_mask)

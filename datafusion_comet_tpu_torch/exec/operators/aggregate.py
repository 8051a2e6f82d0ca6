"""Hash aggregate: SUM, COUNT, AVG, MIN, MAX, FIRST, LAST, the variance
family (VAR_SAMP, VAR_POP, STDDEV_SAMP, STDDEV_POP), the covariance family
(COVAR_SAMP, COVAR_POP, CORR), BIT_AND, BIT_OR, BIT_XOR, BOOL_AND and
BOOL_OR in every mode, BLOOM_FILTER, PERCENTILE, MEDIAN and
APPROX_COUNT_DISTINCT in SINGLE mode, and APPROX_PERCENTILE, COLLECT_LIST
and COLLECT_SET in every mode
(port of
``datafusion_comet_tpu/exec/operators/aggregate.py``: _try_pack_keys,
_pack_sort_limbs, _segments, _seg_bounds, _seg_sum, hash_aggregate,
_sorted_aggregate, _compact_groups, _bucket_aggregate, _input_agg,
_limb_minmax, _merge_agg, _decimal_sum, _finalize). SINGLE and PARTIAL
aggregate input rows; FINAL and PARTIAL_MERGE merge the state columns
PARTIAL emits (``state_fields``). MIN and MAX take integers, dates,
decimals (narrow and two-limb), floats, strings (both layouts) and bools.
A BLOOM_FILTER, PERCENTILE, MEDIAN or APPROX_COUNT_DISTINCT has no partial
state (exec/operators/agg_special.py), so any other mode raises, naming
the mode, as in the JAX package (its ``state_fields``); APPROX_PERCENTILE's
PARTIAL state is a sketch and its count, merged by PARTIAL_MERGE and FINAL;
a collect's PARTIAL state is its list, whose elements a merge collects
again (the JAX package has no collect state and raises in those modes:
ROADMAP C31 lists the divergence).
A grouped bloom filter takes the sorted path; the other special aggregates
take either path, as the keys choose (the JAX package sends every special
aggregate down its sorted path, and the groups come out the same but for
the null group, which the dense path puts first).
An aggregate's FILTER clause (``AggExpr.filter``) narrows the live rows it
reads on input, on either path and in the tiled and grace partial runs
alike; merges never read it (JAX ``aggregate.py:665``). The special
aggregates take it too, as Spark does: the JAX package's ignore it
(ROADMAP C33).

Two paths, chosen as the JAX package chooses them:

- **Dense.** When the group keys pack into a small perfect-hash domain
  (dictionary codes, bools, int8, padded strings of at most 2 bytes; at
  most ``agg_dense_max_domain`` buckets)
  the packed key IS the bucket id: no row sort, one pass per aggregate
  input. Every per-bucket sum and count runs on the hand-written kernels of
  exec/kernels.py: sums on ``bucket_sum``, counts, presence and has-a-value
  masks on ``bucket_count``; MIN, MAX and each bucket's first row (which
  gives its key values) on ``_minmax_reduce`` below. Dead rows carry bucket
  id == B and are dropped.
  Where ``max_groups`` is below the bucket count, the live buckets are
  compacted to it in key order. An ungrouped aggregate goes through the same
  path with one bucket; its one output row is always live, so it emits
  exactly one row even over empty input (sum null, count 0), in an output of
  min(max_groups, 8) rows as the JAX package's (JAX ``aggregate.py:408``:
  a cross join over it then has the JAX package's capacity). The JAX
  package sorts there; the result is the same (its sorted inputs have no
  magnitude bound, so an ungrouped MIN or MAX carries none either).
- **Sorted.** Any other key set: a packed domain too wide for the dense
  path is one int32 sort limb (Q1 with padded one-byte flags: 2^20
  buckets); else the keys pack into one or two int64 sort limbs where each
  key's range is known (``_pack_sort_limbs``: dictionary codes, bools,
  int8, and integers and dates with a statistics range), else into the
  generic null-flag-and-value limbs (sortkeys.grouping_limbs: a padded
  string key gives a limb for each 8 bytes). The
  dead-row flag goes into bit 62 of the first limb, one stable
  ``torch.sort`` (a lexsort over several limbs) orders the rows, and every
  aggregate input, evaluated once on the unsorted batch, is gathered once
  through the permutation (the TPU carries payloads through ``lax.sort``
  because a gather is slow there; on a GPU one ``index_select`` a column is
  the plain idiom). Group ids come from the key changes; each group's
  [start, end) from a binary search below 2^16 groups and from a scatter of
  each group's first row above; sums are one int64 cumulative sum and its
  difference at the bounds (wide sums: one per 32-bit lane, exact below 2^31
  rows). The output holds ``max_groups`` rows, groups in key order; more
  groups than that flag an overflow, and the session re-runs with the
  capacity four times larger.

A float SUM (and a float or integer AVG's sum) is a float64 sum of each
group on its own (``_float_sums``): the rows in group order (the sorted
path's order, or a stable sort of the bucket ids), one deterministic
segmented reduction a group. The JAX package's sorted path takes the
difference of one cumulative sum there, which is exact for integers only:
one NaN or Inf turns every later group's sum into NaN, and a group after
groups of large magnitude loses its precision (ROADMAP C12). Never on
``bucket_sum``, which adds int64 lanes. A sum that is -0.0 comes out 0.0,
as the JAX package's does.

The variance family keeps (n, avg, m2) states, as the JAX package's
(``aggregate.py:112-117``, ``:734-746``, ``:948-965``, ``:1042-1058``): a
group's count, and float64 sums of x and x^2 each summed on their own group
(``fsum``, never the JAX sorted path's prefix difference), give avg and
m2 = max(sum x^2 - (sum x)^2 / n, 0); a merge adds the states' n, n x avg and
m2 + n x avg^2. VAR_SAMP and STDDEV_SAMP of one row are NaN, not null. The
input is read as a DOUBLE, a decimal by its value (the JAX package reads a
decimal's unscaled integer: ROADMAP C20).

The covariance family keeps (n, xavg, yavg, ck, xm2, ym2) states, as the
JAX package's (``aggregate.py:118-126``, ``:748-768``, ``:967-986``,
``:1059``), each sum taken per group on its own (``fsum``), the inputs read
as DOUBLEs by value, as the variance family's. COVAR_SAMP of one row is
NaN, and CORR is NaN where either input has no spread, as in the JAX
package.

FIRST and LAST take each group's first (last) row in input order, its
valid rows only unless nulls are respected; a merge takes the first (last)
valid state. BIT_AND, BIT_OR and BIT_XOR count each bit plane's set rows
per group (``_bitwise``), BOOL_AND and BOOL_OR the false and the true rows
(``_bool_agg``, which is also MIN and MAX of a bool): on the dense path
these counts run on ``bucket_count``.

MIN and MAX of a one-limb value fill invalid rows with the type's identity
and reduce per group (``_minmax_reduce``): a scatter-min or -max, spread
over up to 1024 lanes a group (row i updates lane i mod lanes) so that no
address takes every row of a group, then a min or max over the lanes. A
two-limb decimal runs the JAX package's limb tournament: reduce the high
limb, keep the rows that reach it, reduce the low limb among them, and
gather the lowest such row. A float runs the same tournament on its
one order limb (sortkeys._float_limb, as the JAX package runs its four
float limbs): NaN is the greatest value, and the row gathered gives the
group's -0.0 or 0.0, and its NaN's bits, as the JAX package's does. A
string runs it on its limbs (sortkeys.column_limbs: the dictionary code,
or 8 padded bytes a limb).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

import torch

from datafusion_comet_tpu_torch import types as T
from datafusion_comet_tpu_torch.exec import decimal_wide as DW
from datafusion_comet_tpu_torch.exec import kernels as K
from datafusion_comet_tpu_torch.exec import sortkeys
from datafusion_comet_tpu_torch.exec.batch import (Batch, ColumnVector, pad_capacity,
                                                  quantize_bound)
from datafusion_comet_tpu_torch.exec.evaluator import (EvalContext, _NARROW_LIMIT, _coerce,
                                                      _dec_bound, evaluate)
from datafusion_comet_tpu_torch.exec.operators.basic import compact_batch
from datafusion_comet_tpu_torch.exec.stats import DEFAULT_MAX_GROUPS
from datafusion_comet_tpu_torch.ir import expr as E
from datafusion_comet_tpu_torch.ir.plan import AggMode
from datafusion_comet_tpu_torch.observability.trace import with_trace
from datafusion_comet_tpu_torch.utils import int128

__all__ = ["state_fields", "hash_aggregate"]

_PACK_BITS_CAP = 24  # packed keys: at most 2^24 distinct codes
_BUCKET_DOMAIN, _BUCKET_ROWS = 1 << 16, 1 << 18  # see keep_bounds in hash_aggregate
_SEARCH_GROUPS = 1 << 16  # _seg_bounds: binary search below, a scatter at and above
_DEAD_BIT = 62  # _pack_sort_limbs fills bits 0..61 of a limb; bit 62 marks dead rows
_MINMAX_LANES = 1024  # lanes a group of _minmax_reduce, at most
_MINMAX_SLOTS = 1 << 22  # partial results of _minmax_reduce, at most
_MINMAX = (E.AggFunc.MIN, E.AggFunc.MAX)
_FIRST_LAST = (E.AggFunc.FIRST, E.AggFunc.LAST)
# one state column of the input's type (BOOL_*: a BOOL), merged as the input is
_ONE_VALUE = _MINMAX + _FIRST_LAST + E.BIT_FUNCS + E.BOOL_FUNCS
_COVAR_STATES = ("n", "xavg", "yavg", "ck", "xm2", "ym2")


def _sum_state_dtype(a: E.AggExpr) -> T.DataType:
    cd = a.child.dtype
    if cd.is_decimal:
        return T.decimal(min(cd.precision + 10, T.MAX_DECIMAL_PRECISION), cd.scale)
    return T.INT64 if cd.is_integer else T.FLOAT64


def state_fields(a: E.AggExpr) -> List[T.Field]:
    """State columns a PARTIAL aggregate emits for ``a``."""
    o = a.out_name
    if a.func == E.AggFunc.COUNT:
        return [T.Field(f"{o}__count", T.INT64, nullable=False)]
    if a.func == E.AggFunc.SUM:
        return [T.Field(f"{o}__sum", _sum_state_dtype(a))]
    if a.func == E.AggFunc.AVG:
        return [T.Field(f"{o}__sum", _sum_state_dtype(a)),
                T.Field(f"{o}__count", T.INT64, nullable=False)]
    if a.func in E.BOOL_FUNCS:
        return [T.Field(f"{o}__val", T.BOOL)]
    if a.func in _ONE_VALUE:
        return [T.Field(f"{o}__val", a.child.dtype)]
    if a.func in E.WELFORD_FUNCS:
        return [T.Field(f"{o}__{s}", T.FLOAT64, nullable=False) for s in ("n", "avg", "m2")]
    if a.func in E.COVAR_FUNCS:
        return [T.Field(f"{o}__{s}", T.FLOAT64, nullable=False) for s in _COVAR_STATES]
    if a.func == E.AggFunc.APPROX_PERCENTILE:
        from datafusion_comet_tpu_torch.exec.operators.agg_special import sketch_size

        return [T.Field(f"{o}__sketch", T.binary(8 * sketch_size()), nullable=False),
                T.Field(f"{o}__count", T.INT64, nullable=False)]
    if a.func in E.COLLECT_FUNCS:
        return [T.Field(f"{o}__val", a.result_dtype())]
    if a.func in E.SPECIAL_FUNCS:
        raise NotImplementedError(f"{a.func.upper()} has no partial state: it runs in SINGLE "
                                  "mode only, as in the JAX package")
    raise NotImplementedError(f"state_fields: {a.func}")


def _try_pack_keys(key_cols: Sequence[ColumnVector]):
    """(bucket id per row, bucket count) when the combined key domain is
    small: each key encodes to (value + 1, or 0 for null) in its own bit
    field, so bucket order is key order. None when a key doesn't pack."""
    total_bits = 0
    parts = []
    for cv in key_cols:
        if cv.dtype.is_boolean:
            enc, b = cv.data.int(), 1
        elif cv.dtype.type_id == "INT8":
            enc, b = cv.data.int() + 128, 8
        elif cv.is_dict:
            # dictionary codes are a perfect hash of the key domain
            k = cv.dictionary.size
            enc, b = cv.data.clamp(0, max(k - 1, 0)).int(), max(k.bit_length(), 1)
        elif cv.dtype.is_binary and cv.dtype.byte_width <= 2:
            # padded bytes of at most 2: the bytes, then the length (in [0, w])
            w = cv.dtype.byte_width
            len_bits = w.bit_length()
            enc = torch.zeros(cv.capacity, dtype=torch.int32, device=cv.data.device)
            for i in range(w):
                enc = (enc << 8) | cv.data[:, i].int()
            enc, b = (enc << len_bits) | cv.lengths.clamp(max=w).int(), 8 * w + len_bits
        else:
            return None
        enc = torch.where(cv.validity, enc + 1, 0)  # null bit: nulls group together
        b += 1
        total_bits += b
        if total_bits > _PACK_BITS_CAP:
            return None
        parts.append((enc, b))
    seg = torch.zeros(key_cols[0].capacity, dtype=torch.int32, device=key_cols[0].data.device)
    for enc, b in parts:
        seg = (seg << b) | enc
    return seg, 1 << total_bits


def _pack_sort_limbs(key_cols: Sequence[ColumnVector], key_ranges
                     ) -> Optional[List[torch.Tensor]]:
    """All group keys packed into as few int64 sort limbs as fit, 62 bits a
    limb, in grouping_limbs' order (per key a null flag, nulls last, then the
    value: dictionary codes, bools, int8 offset by 128, integers and dates
    offset by their statistics range). None when a key has no such encoding."""
    key_ranges = key_ranges or (None,) * len(key_cols)
    limbs: List[torch.Tensor] = []
    acc, bits_used = None, 0
    for cv, rng in zip(key_cols, key_ranges):
        dt = cv.dtype
        if dt.is_boolean:
            enc, b = cv.data.long(), 1
        elif cv.is_dict:
            k = cv.dictionary.size
            enc, b = cv.data.clamp(0, max(k - 1, 0)).long(), max((max(k - 1, 0)).bit_length(), 1)
        elif dt.type_id == "INT8":
            enc, b = cv.data.long() + 128, 8
        elif (dt.is_integer or dt.type_id == "DATE") and rng is not None:
            lo, hi = rng
            span = hi - lo
            if span < 0 or span >= (1 << 62):
                return None
            enc, b = cv.data.long().clamp(lo, hi) - lo, max(span.bit_length(), 1)
        else:
            return None
        enc = torch.where(cv.validity, enc, 0)
        b += 1  # the null flag, above the value
        if bits_used + b > 62:
            limbs.append(acc)
            acc, bits_used = None, 0
        piece = ((~cv.validity).long() << (b - 1)) | enc
        acc = piece if acc is None else (acc << b) | piece
        bits_used += b
    if acc is not None:
        limbs.append(acc)
    return limbs


def _minmax_reduce(x: torch.Tensor, seg: torch.Tensor, m: int, is_min: bool) -> torch.Tensor:
    """Per-group min or max of ``x`` (n,) over group ids ``seg`` in [0, m]
    (m: dead rows): (m,), the type's identity for a group with no row. The
    rows scatter into (m + 1) x lanes partial slots, row i into lane i mod
    lanes of its group, so a group's rows update up to 1024 addresses
    instead of one; a min or max over the lanes finishes."""
    n = x.shape[0]
    info = torch.iinfo(x.dtype)
    ident = info.max if is_min else info.min
    lanes = 1
    while lanes * 2 <= min(_MINMAX_LANES, _MINMAX_SLOTS // (m + 1), max(n, 1)):
        lanes *= 2
    idx = torch.arange(n, device=x.device).bitwise_and_(lanes - 1).add_(seg, alpha=lanes)
    part = torch.full(((m + 1) * lanes,), ident, dtype=x.dtype, device=x.device)
    part.scatter_reduce_(0, idx, x, "amin" if is_min else "amax")
    part = part.view(m + 1, lanes)[:m]
    return part.amin(1) if is_min else part.amax(1)


def _float_sums(x: torch.Tensor, seg: torch.Tensor, m: int) -> torch.Tensor:
    """float64 (m,) sums of ``x`` (n,) per group id ``seg`` (n,), which is
    nondecreasing (m: dead rows, last): one segmented sum a group, in row
    order; an empty group sums to 0.0, and -0.0 comes out 0.0."""
    gids = torch.arange(m + 1, dtype=seg.dtype, device=seg.device)
    offsets = torch.searchsorted(seg.contiguous(), gids)
    return torch.segment_reduce(x.double(), "sum", offsets=offsets, unsafe=True)[:m] + 0.0


class _Buckets:
    """Per-bucket reductions on the bucket kernels (the dense path): ``seg``
    the int32 bucket id of each row, dead rows ``m``. ``keep_bounds``: a
    MIN or MAX carries its input's magnitude bound (False when ungrouped,
    where the JAX package's sorted inputs have none)."""

    def __init__(self, seg: torch.Tensor, m: int, errors, keep_bounds: bool = True):
        self.seg, self.m, self.errors, self.keep_bounds = seg, m, errors, keep_bounds
        self._by_bucket = None  # (sorted ids, permutation), made by the first fsum

    def sum(self, x: torch.Tensor) -> torch.Tensor:
        """int64 (n,) or (k, n) values, zero where not summed -> (m,) or (k, m)."""
        return K.bucket_sum(self.seg, x, self.m, self.errors)

    def count(self, valid: torch.Tensor) -> torch.Tensor:
        return K.bucket_count(torch.where(valid, self.seg, self.m).int(), self.m, self.errors)

    def minmax(self, x: torch.Tensor, is_min: bool) -> torch.Tensor:
        return _minmax_reduce(x, self.seg, self.m, is_min)

    def fsum(self, x: torch.Tensor) -> torch.Tensor:
        """float (n,) values, zero where not summed -> float64 (m,): the
        rows stably sorted by bucket (one sort for every float sum of the
        aggregate), each bucket summed on its own."""
        if self._by_bucket is None:
            self._by_bucket = torch.sort(self.seg, stable=True)
        seg, perm = self._by_bucket
        return _float_sums(x[perm], seg, self.m)


class _Segments:
    """Per-group reductions over rows sorted by group (the sorted path):
    each group's rows are [starts[g], ends[g]), ``seg`` the group id of
    each sorted row (m on dead rows); a sum is the difference of a
    cumulative sum at the two ends, exact mod 2^64."""

    keep_bounds = True  # the sorted inputs hold the JAX package's bounds already

    def __init__(self, starts: torch.Tensor, ends: torch.Tensor, seg: torch.Tensor):
        self.starts, self.ends, self.seg, self.m = starts, ends, seg, starts.shape[0]

    def sum(self, x: torch.Tensor) -> torch.Tensor:
        """int64 (n,) or (k, n) -> (m,) or (k, m). The k rows are summed as
        one 1-D scan with a zero in front (a scan along the last dimension
        of a (k, n) tensor is one slow block a row on a GPU); the offsets of
        earlier rows cancel in each difference."""
        n = x.shape[-1]
        acc = torch.cumsum(x.reshape(-1), 0)
        acc = torch.cat([acc.new_zeros(1), acc])
        base = torch.arange(0, x.numel(), n, device=x.device).view(-1, 1) if x.dim() == 2 else 0
        return acc[base + self.ends] - acc[base + self.starts]

    def count(self, valid: torch.Tensor) -> torch.Tensor:
        return self.sum(valid.int()).long()

    def minmax(self, x: torch.Tensor, is_min: bool) -> torch.Tensor:
        return _minmax_reduce(x, self.seg, self.m, is_min)

    def fsum(self, x: torch.Tensor) -> torch.Tensor:
        """float (n,) sorted values, zero where not summed -> float64 (m,)."""
        return _float_sums(x, self.seg, self.m)


def hash_aggregate(
    batch: Batch,
    group_exprs: Sequence[E.Expr],
    agg_exprs: Sequence[E.AggExpr],
    mode: str,
    out_schema: T.Schema,
    ctx: Optional[EvalContext] = None,
    dense_max_domain: int = 64,
    max_groups: int = DEFAULT_MAX_GROUPS,
    key_ranges=None,
    merge_rows: Optional[int] = None,
    grow_key: Optional[int] = None,
) -> Batch:
    """Group ``batch`` by ``group_exprs``. ``max_groups``: the output's group
    capacity, times the session's growth scale, at least the groups an
    earlier attempt counted (``ctx.grown`` under ``grow_key``, the plan
    node's id) and at most the input capacity; ``key_ranges``: per key an
    exact (min, max) or None; ``merge_rows``: a merge's host-known bound on
    the rows behind one group's states, or None. Where the groups overflow
    the capacity, their count goes with the flag."""
    ctx = ctx or EvalContext()
    bloom = any(a.func == E.AggFunc.BLOOM_FILTER for a in agg_exprs)
    for a in agg_exprs:
        if a.func in E.SPECIAL_FUNCS and a.func not in (E.AggFunc.APPROX_PERCENTILE,
                                                        *E.COLLECT_FUNCS) and (
                mode != AggMode.SINGLE):
            raise NotImplementedError(f"{a.func.upper()} in {mode} mode: it has no partial "
                                      "state, as in the JAX package")
    gkey = (grow_key, "groups")
    max_groups = min(max(max_groups * max(ctx.agg_scale, 1), pad_capacity(ctx.floor(gkey))),
                     batch.capacity)
    key_cols = [evaluate(g, batch, ctx) for g in group_exprs]
    if not key_cols:
        seg = torch.where(batch.row_mask, 0, 1).int()
        return _dead_rows_to(_bucket_aggregate(batch, key_cols, agg_exprs, mode, (seg, 1),
                                               out_schema, ctx, merge_rows), min(max_groups, 8))
    packed = _try_pack_keys(key_cols)
    # a grouped bloom filter takes the sorted path, as the JAX package's
    # special aggregates do
    if packed is not None and packed[1] <= max(dense_max_domain, 0) and not bloom:
        out = _bucket_aggregate(batch, key_cols, agg_exprs, mode, packed, out_schema, ctx,
                                merge_rows)
        if out.capacity > max_groups:
            # the live buckets, in key order, packed into max_groups rows
            live = out.row_mask.sum()
            out, ovf = compact_batch(out, max_groups)
            ctx.flag_overflow(ovf, _label(group_exprs), live, gkey)
        return out
    # a packed dictionary key too wide for the dense path still sorts as
    # one int32 limb
    key_limbs = ([packed[0]] if packed is not None
                 else _pack_sort_limbs(key_cols, key_ranges))
    # the JAX package aggregates a packed domain up to 2^16 over at most 2^18
    # rows on its bucket path, which keeps the inputs' magnitude bounds: the
    # sums' storage then follows them
    keep_bounds = (packed is not None and packed[1] <= _BUCKET_DOMAIN
                   and batch.capacity <= _BUCKET_ROWS)
    return _sorted_aggregate(batch, key_cols, key_limbs, agg_exprs, mode, max_groups,
                             out_schema, ctx, keep_bounds, merge_rows, _label(group_exprs),
                             gkey)


def _label(group_exprs) -> str:
    """The aggregate's name among a run's overflowed operators."""
    return "HashAggregate " + ",".join(getattr(g, "name", "?") for g in group_exprs)


def _dead_rows_to(b: Batch, cap: int) -> Batch:
    """``b`` with dead rows appended up to ``cap`` rows, bounds kept."""
    pad = cap - b.capacity
    if pad <= 0:
        return b

    def ext(t):
        return None if t is None else torch.cat([t, t.new_zeros((pad,) + tuple(t.shape[1:]))])

    return Batch(tuple(dataclasses.replace(c, data=ext(c.data), validity=ext(c.validity),
                                           lengths=ext(c.lengths)) for c in b.columns),
                 ext(b.row_mask), b.schema)


def _sort_groups(key_cols, key_limbs, row_mask: torch.Tensor):
    """(perm, sorted row mask, key-change flags): rows by group key, stably,
    dead rows last (the flag in bit 62 of the first limb), and True at each
    group's first sorted row."""
    limbs = key_limbs if key_limbs is not None else sortkeys.grouping_limbs(key_cols)
    lead = limbs[0].long() | ((~row_mask).long() << _DEAD_BIT)
    if len(limbs) == 1:
        sorted_lead, perm = torch.sort(lead, stable=True)
        sorted_limbs = [sorted_lead]
        sorted_mask = sorted_lead < (1 << _DEAD_BIT)
    else:
        perm = sortkeys.lexsort([lead] + list(limbs[1:]))
        sorted_limbs = [lead[perm]] + [l[perm] for l in limbs[1:]]
        sorted_mask = row_mask[perm]
    changed = torch.zeros_like(sorted_mask)
    changed[:1] = True
    for s in sorted_limbs:
        changed[1:] |= s[1:] != s[:-1]
    return perm, sorted_mask, changed & sorted_mask


def _seg_bounds(seg: torch.Tensor, changed: torch.Tensor, num_groups: torch.Tensor,
                n_live: torch.Tensor, m: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """[start, end) of each of m groups in the sorted rows (an empty group:
    start == end == n). ``seg``: nondecreasing group id per sorted row, m on
    dead rows. Below 2^16 groups two binary searches (m x log n); above,
    each group's first row scattered to its slot (a scatter-min, as each
    group has one first row) and its end the next group's start."""
    n = seg.shape[0]
    if m < _SEARCH_GROUPS:
        gids = torch.arange(m, dtype=seg.dtype, device=seg.device)
        return (torch.searchsorted(seg, gids, side="left"),
                torch.searchsorted(seg, gids, side="right"))
    rows = torch.arange(n, device=seg.device)
    starts = torch.full((m + 1,), n, dtype=torch.int64, device=seg.device)
    starts.scatter_(0, torch.where(changed, seg, m), rows)
    starts[m] = n  # the sink took the other rows' writes: an empty last slot ends at n
    gids = torch.arange(m, device=seg.device)
    ends = torch.where(gids == num_groups - 1, n_live, starts[1:])
    return starts[:m], ends


def _sorted_aggregate(batch: Batch, key_cols, key_limbs, agg_exprs, mode: str,
                      max_groups: int, out_schema: T.Schema, ctx: EvalContext,
                      keep_bounds: bool = False, merge_rows: Optional[int] = None,
                      label: str = "HashAggregate", gkey: Optional[tuple] = None) -> Batch:
    """The sorted path: see the module docstring. Output capacity
    ``max_groups``, groups in key order. The sorted inputs drop their
    magnitude bounds, as the JAX package's sorted payloads do, unless
    ``keep_bounds``."""
    cap = batch.capacity
    merging = mode in (AggMode.FINAL, AggMode.PARTIAL_MERGE)
    # a count's bound: the input rows, or a merge's bound on the rows behind it
    rows = merge_rows if merging else cap
    # every aggregate input evaluated once, on the unsorted batch
    pre: List[ColumnVector] = []
    names: List[str] = []
    exprs: List[E.Expr] = []  # alive while their ids key index_of
    index_of: Dict[int, int] = {}

    def add(ex: Optional[E.Expr], name: Optional[str] = None) -> None:
        if ex is None or id(ex) in index_of or isinstance(ex, E.Literal):
            return
        index_of[id(ex)] = len(pre)
        exprs.append(ex)
        pre.append(evaluate(ex, batch, ctx))
        names.append(name or f"__agg_in_{len(pre) - 1}")

    if merging:
        for a in agg_exprs:
            for fld in state_fields(a):
                if fld.name not in names:
                    i = batch.schema.index_of(fld.name)
                    add(E.BoundRef(i, fld.name, batch.schema.fields[i].dtype), fld.name)
    else:
        for a in agg_exprs:
            for x in (a.child, a.filter) + a.extra:
                add(x)
    with with_trace("aggregate.sort"):
        perm, sorted_mask, changed = _sort_groups(key_cols, key_limbs, batch.row_mask)
        synth_cols = tuple(dataclasses.replace(cv.take(perm), mag_bound=cv.mag_bound)
                           if keep_bounds else cv.take(perm) for cv in pre)
    synth = Batch(synth_cols, sorted_mask,
                  T.Schema([T.Field(nm, c.dtype) for nm, c in zip(names, synth_cols)]))
    num_groups = changed.sum()
    seg = torch.cumsum(changed, 0) - 1
    # rows of groups past the capacity go with the dead rows: the overflow
    # flag re-runs the query, and seg stays sorted meanwhile
    seg = torch.where(sorted_mask, seg.clamp(max=max_groups), max_groups)
    if max_groups < cap:
        ctx.flag_overflow(num_groups > max_groups, label, num_groups, gkey)
    group_mask = torch.arange(max_groups, device=batch.device) < num_groups
    starts, ends = _seg_bounds(seg, changed, num_groups, sorted_mask.sum(), max_groups)
    red = _Segments(starts, ends, seg)
    first_orig = perm[torch.where(group_mask, starts.clamp(0, cap - 1), 0)]
    out_cols: List[ColumnVector] = [kc.take(first_orig) for kc in key_cols]

    def ref(ex: Optional[E.Expr]) -> Optional[E.Expr]:
        if ex is None or isinstance(ex, E.Literal):
            return ex
        i = index_of[id(ex)]
        return E.BoundRef(i, names[i], pre[i].dtype)

    for a in agg_exprs:
        if merging:
            vals = _merge_agg(a, synth, red, group_mask, ctx, mode)
        else:
            vals = _input_agg(dataclasses.replace(a, child=ref(a.child), filter=ref(a.filter),
                                                  extra=tuple(ref(x) for x in a.extra)),
                              synth, red, group_mask, ctx, mode, out_schema)
        if mode in (AggMode.SINGLE, AggMode.FINAL):
            out_cols.append(_finalize(a, vals, rows))
        else:
            out_cols.extend(vals)
    return Batch(tuple(out_cols), group_mask, out_schema)


def _bucket_aggregate(batch: Batch, key_cols, agg_exprs, mode: str, packed,
                      out_schema: T.Schema, ctx: EvalContext,
                      merge_rows: Optional[int] = None) -> Batch:
    """Direct-bucket aggregation: output capacity = bucket count; a group
    is live where its bucket holds a live row (always, when ungrouped)."""
    seg_raw, n_buckets = packed
    cap = batch.capacity
    seg = torch.where(batch.row_mask, seg_raw, n_buckets).int()
    if key_cols:
        group_mask = K.bucket_count(seg, n_buckets, ctx.errors) > 0
        # a representative row per bucket (its first), to gather its key values
        first = _minmax_reduce(torch.arange(cap, device=batch.device), seg, n_buckets, True)
        first_orig = torch.where(group_mask, first.clamp(0, cap - 1), 0)
    else:
        group_mask = torch.ones(1, dtype=torch.bool, device=batch.device)
    out_cols: List[ColumnVector] = [kc.take(first_orig) for kc in key_cols]
    merging = mode in (AggMode.FINAL, AggMode.PARTIAL_MERGE)
    red = _Buckets(seg, n_buckets, ctx.errors, keep_bounds=bool(key_cols))
    for a in agg_exprs:
        if merging:
            vals = _merge_agg(a, batch, red, group_mask, ctx, mode)
        else:
            vals = _input_agg(a, batch, red, group_mask, ctx, mode, out_schema)
        if mode in (AggMode.SINGLE, AggMode.FINAL):
            # merged counts are sums of counts: the input capacity bounds
            # them only when rows are aggregated directly
            out_cols.append(_finalize(a, vals, merge_rows if merging else cap))
        else:
            out_cols.extend(vals)
    return Batch(tuple(out_cols), group_mask, out_schema)


def _decimal_sum(cv: ColumnVector, x: torch.Tensor, valid: torch.Tensor, red,
                 st: T.DataType):
    """Per-group sum into state type ``st``: (state data, sum bound or None,
    overflow mask or None). A wide-typed sum whose sound bound (max|value| x
    rows) reaches int64 splits each value into four 32-bit lanes, sums all
    four at once and recombines them per group."""
    if st.is_decimal and st.is_wide_decimal:
        sb = _dec_bound(cv, cv.dtype if cv.dtype.is_decimal else st) * x.shape[0]
        if cv.is_wide_storage or sb >= _NARROW_LIMIT:
            p = DW.pair(x) if x.dim() == 2 else int128.from_i64(x.long())
            sums = red.sum(torch.stack([torch.where(valid, lane, 0) for lane in DW.decompose4(p)]))
            packed = DW.pack(DW.recombine4(*sums))
            # Spark nulls decimal sums that overflow the 38-digit state: the
            # exact check catches 10^38..2^127, an f64 estimate of the lane
            # sums screens totals large enough to have wrapped i128
            est = sum(s.double() * 2.0 ** (32 * i) for i, s in enumerate(sums))
            over = DW.overflow_check(DW.pair(packed), st.precision) | (est.abs() >= 1.5e38)
            return packed, None, over
        return red.sum(torch.where(valid, x, 0).long()), sb, None
    if st.is_floating:
        return red.fsum(torch.where(valid, x, 0)), None, None
    return red.sum(torch.where(valid, x, 0).long()), None, None


def _unbounded_storage(s: torch.Tensor, sb: Optional[int], cv: ColumnVector,
                       st: T.DataType, red) -> Tuple[torch.Tensor, Optional[int]]:
    """An ungrouped sum state in the storage the JAX package gives it: there
    its inputs are sorted, which drops their magnitude bounds, so its sum's
    bound is the input type's times the rows, and a wide-typed state at or
    over the int64 limit is two-limb with no bound. The sum itself stays the
    exact narrow one of the bucket kernel; only its storage widens."""
    if red.keep_bounds or not (st.is_decimal and st.is_wide_decimal) or s.dim() != 1:
        return s, sb
    bound = _dec_bound(dataclasses.replace(cv, mag_bound=None),
                       cv.dtype if cv.dtype.is_decimal else st) * red.seg.shape[0]
    if bound >= _NARROW_LIMIT:
        return DW.pack(int128.from_i64(s)), None
    return s, bound


def _input_agg(a: E.AggExpr, batch: Batch, red, group_mask: torch.Tensor,
               ctx: EvalContext, mode: str = AggMode.SINGLE,
               out_schema: Optional[T.Schema] = None) -> List[ColumnVector]:
    active = batch.row_mask
    if a.filter is not None:  # FILTER (WHERE ...): the rows where it is true
        fcv = evaluate(a.filter, batch, ctx)
        active = active & fcv.validity & fcv.data.bool()
    if a.func == E.AggFunc.COUNT and a.child is None:  # COUNT(*)
        return [ColumnVector(red.count(active), group_mask, None, T.INT64)]
    cv = evaluate(a.child, batch, ctx)
    valid = cv.validity & active
    if a.func == E.AggFunc.COUNT:
        return [ColumnVector(red.count(valid), group_mask, None, T.INT64)]
    if a.func in _MINMAX:
        return [_minmax(a.func == E.AggFunc.MIN, cv, valid, red, group_mask)]
    if a.func in _FIRST_LAST:
        # with nulls respected, a group's first (last) live row, null or not
        consider = valid if a.ignore_nulls else active
        return [_first_last(a.func == E.AggFunc.FIRST, cv, consider, red, group_mask,
                            a.ignore_nulls)]
    if a.func in E.BIT_FUNCS:
        return [_bitwise(a.func, cv, valid, red, group_mask)]
    if a.func in E.BOOL_FUNCS:
        return [_bool_agg(a.func == E.AggFunc.BOOL_AND, cv, valid, red, group_mask)]
    if a.func == E.AggFunc.BLOOM_FILTER:
        from datafusion_comet_tpu_torch.exec.operators.agg_special import bloom_agg

        return [bloom_agg(a, cv, valid, red.seg, red.m, (red.count(valid) > 0) & group_mask)]
    if a.func in E.SPECIAL_FUNCS:
        from datafusion_comet_tpu_torch.exec.operators import agg_special as SP

        if a.func == E.AggFunc.APPROX_PERCENTILE and mode == AggMode.PARTIAL:
            # K: the width of the state binding gave the sketch
            k = out_schema.field(f"{a.out_name}__sketch").dtype.byte_width // 8
            return SP.approx_percentile_partial(a, cv, valid, red.seg, red.m, group_mask, k)
        fn = {E.AggFunc.PERCENTILE: SP.percentile_agg, E.AggFunc.MEDIAN: SP.percentile_agg,
              E.AggFunc.APPROX_COUNT_DISTINCT: SP.hll_agg, E.AggFunc.COLLECT_LIST: SP.collect_agg,
              E.AggFunc.COLLECT_SET: SP.collect_agg,
              E.AggFunc.APPROX_PERCENTILE: SP.approx_percentile_exact}[a.func]
        return [fn(a, cv, valid, red.seg, red.m, group_mask)]
    if a.func in E.WELFORD_FUNCS:
        xd = torch.where(valid, _coerce(cv, T.FLOAT64).data, 0.0)
        n = red.count(valid).double()
        s1 = red.fsum(xd)
        safe_n = n.clamp(min=1.0)
        m2 = (red.fsum(xd * xd) - s1 * s1 / safe_n).clamp(min=0.0)
        return [ColumnVector(t, group_mask, None, T.FLOAT64) for t in (n, s1 / safe_n, m2)]
    if a.func in E.COVAR_FUNCS:
        ycv = evaluate(a.extra[0], batch, ctx)
        both = valid & ycv.validity
        xd = torch.where(both, _coerce(cv, T.FLOAT64).data, 0.0)
        yd = torch.where(both, _coerce(ycv, T.FLOAT64).data, 0.0)
        n = red.count(both).double()
        sx, sy = red.fsum(xd), red.fsum(yd)
        safe_n = n.clamp(min=1.0)
        ck = red.fsum(xd * yd) - sx * sy / safe_n
        xm2 = (red.fsum(xd * xd) - sx * sx / safe_n).clamp(min=0.0)
        ym2 = (red.fsum(yd * yd) - sy * sy / safe_n).clamp(min=0.0)
        return [ColumnVector(t, group_mask, None, T.FLOAT64)
                for t in (n, sx / safe_n, sy / safe_n, ck, xm2, ym2)]
    if a.func not in (E.AggFunc.SUM, E.AggFunc.AVG):
        raise NotImplementedError(f"aggregate {a.func} is not ported yet")
    st = _sum_state_dtype(a)
    s, sb, over = _decimal_sum(cv, cv.data, valid, red, st)
    s, sb = _unbounded_storage(s, sb, cv, st, red)
    cnt = red.count(valid)
    has = (cnt > 0) & group_mask
    if over is not None:
        has = has & ~over
    bound = quantize_bound(sb) if sb is not None else None
    state = ColumnVector(s, has, None, st, mag_bound=bound)
    if a.func == E.AggFunc.SUM:
        return [state]
    return [state, ColumnVector(cnt, group_mask, None, T.INT64)]


def _minmax(is_min: bool, cv: ColumnVector, valid: torch.Tensor, red,
            group_mask: torch.Tensor) -> ColumnVector:
    """MIN or MAX of ``cv`` over its ``valid`` rows per group, null where a
    group has none. One limb: the values, the identity where invalid,
    reduced per group; the result is one of the inputs, so the input's
    bound carries over. Two limbs: the limb tournament (``_limb_minmax``)."""
    dt = cv.dtype
    if dt.is_boolean:  # MIN is AND, MAX is OR
        return _bool_agg(is_min, cv, valid, red, group_mask)
    has = (red.count(valid) > 0) & group_mask
    if cv.is_wide_storage or dt.is_floating or dt.is_binary:
        return _limb_minmax(is_min, cv, valid, red, has)
    info = torch.iinfo(cv.data.dtype)
    x = torch.where(valid, cv.data, info.max if is_min else info.min)
    return ColumnVector(red.minmax(x, is_min), has, None, dt,
                        mag_bound=cv.mag_bound if red.keep_bounds else None)


def _limb_minmax(is_min: bool, cv: ColumnVector, valid: torch.Tensor, red,
                 has: torch.Tensor) -> ColumnVector:
    """MIN or MAX over two-limb decimals, floats or strings: reduce the
    first limb (for a decimal the high limb, signed; for a string its first
    8 bytes, or its dictionary code), keep the rows that reach their
    group's best, reduce the next limb (the low limb, sign bit flipped, so
    signed order is unsigned order; the next 8 bytes) among those, and
    gather each group's lowest row that is still in (row n - 1 for an empty
    group), its lengths and dictionary with it. No bound carries over, as
    in the JAX package."""
    n = valid.shape[0]
    ident = (1 << 63) - 1 if is_min else -(1 << 63)
    alive = valid
    for limb in sortkeys.column_limbs(cv):
        limb = limb.long()
        best = red.minmax(torch.where(alive, limb, ident), is_min)
        per_row = torch.cat([best, best.new_zeros(1)])[red.seg.long().clamp(max=red.m)]
        alive = alive & (limb == per_row)
    rows = torch.arange(n, device=valid.device)
    win = red.minmax(torch.where(alive, rows, n), True).clamp(0, max(n - 1, 0))
    taken = cv.take(win)
    return ColumnVector(taken.data, has, taken.lengths, cv.dtype, cv.dictionary)


def _first_last(is_first: bool, cv: ColumnVector, consider: torch.Tensor, red,
                group_mask: torch.Tensor, ignore_nulls: bool) -> ColumnVector:
    """FIRST or LAST: each group's lowest (highest) row of ``consider`` in
    the reduction's row order (the input order within a group on either
    path), gathered with its lengths and dictionary; null where the group
    has no such row, or (nulls respected) where that row's value is null.
    No bound carries over, as in the JAX package."""
    n = consider.shape[0]
    rows = torch.arange(n, device=consider.device)
    win = red.minmax(torch.where(consider, rows, n if is_first else -1), is_first)
    taken = cv.take(win.clamp(0, max(n - 1, 0)))
    has = (red.count(consider) > 0) & group_mask
    return ColumnVector(taken.data, has if ignore_nulls else has & taken.validity,
                        taken.lengths, cv.dtype, cv.dictionary)


def _bitwise(func: str, cv: ColumnVector, valid: torch.Tensor, red,
             group_mask: torch.Tensor) -> ColumnVector:
    """BIT_AND, BIT_OR or BIT_XOR of an integer column per group, a bit
    plane at a time: the rows with the bit set are counted (on the bucket
    kernel where the path is dense), and the group's bit is set where
    every valid row has it (AND), any has it (OR) or an odd number has it
    (XOR). The planes of the storage width are assembled and cast back,
    which keeps a negative result's sign."""
    x = cv.data.long()
    n_valid = red.count(valid)
    out = torch.zeros_like(n_valid)
    for b in range(8 * cv.data.element_size()):
        c = red.count(valid & (((x >> b) & 1) == 1))
        bit = (c == n_valid) if func == E.AggFunc.BIT_AND else (
            (c > 0) if func == E.AggFunc.BIT_OR else (c & 1) == 1)
        out |= bit.long() << b
    return ColumnVector(out.to(cv.data.dtype), (n_valid > 0) & group_mask, None, cv.dtype)


def _bool_agg(is_and: bool, cv: ColumnVector, valid: torch.Tensor, red,
              group_mask: torch.Tensor) -> ColumnVector:
    """BOOL_AND (MIN of a bool) or BOOL_OR (MAX): whether no valid row is
    false, or some valid row is true; null where a group has no valid row."""
    x = cv.data.bool()
    data = (red.count(valid & ~x) == 0) if is_and else (red.count(valid & x) > 0)
    return ColumnVector(data, (red.count(valid) > 0) & group_mask, None, cv.dtype)


def _merge_agg(a: E.AggExpr, batch: Batch, red, group_mask: torch.Tensor,
               ctx: EvalContext, mode: str = AggMode.FINAL) -> List[ColumnVector]:
    """Merge PARTIAL state columns per group into the same states: counts
    and sums add; a sum state is null where no input state of its group was
    valid; MIN and MAX reduce their states as they reduce input rows; an
    approx_percentile's sketches merge into its result (FINAL) or a sketch
    (PARTIAL_MERGE)."""
    sts = [batch.column(f.name) for f in state_fields(a)]
    live = batch.row_mask
    if a.func == E.AggFunc.APPROX_PERCENTILE:
        from datafusion_comet_tpu_torch.exec.operators.agg_special import approx_percentile_merge

        return approx_percentile_merge(a, sts[0], sts[1], live, red.seg, red.m, group_mask,
                                       finalize=mode == AggMode.FINAL)
    if a.func in E.COLLECT_FUNCS:
        from datafusion_comet_tpu_torch.exec.operators.agg_special import collect_merge

        return [collect_merge(a, sts[0], live, red.seg, red.m, group_mask)]
    if a.func in _MINMAX:
        return [_minmax(a.func == E.AggFunc.MIN, sts[0], sts[0].validity & live, red,
                        group_mask)]
    if a.func in _FIRST_LAST:
        # the first (last) valid state, nulls respected or not (JAX
        # ``aggregate.py:937``: its merge always ignores nulls)
        return [_first_last(a.func == E.AggFunc.FIRST, sts[0], sts[0].validity & live, red,
                            group_mask, True)]
    if a.func in E.BIT_FUNCS:
        return [_bitwise(a.func, sts[0], sts[0].validity & live, red, group_mask)]
    if a.func in E.BOOL_FUNCS:
        return [_bool_agg(a.func == E.AggFunc.BOOL_AND, sts[0], sts[0].validity & live, red,
                          group_mask)]
    if a.func in E.COVAR_FUNCS:
        n, xavg, yavg, ck, xm2, ym2 = (torch.where(live, c.data, 0.0) for c in sts)
        ntot = red.fsum(n)
        safe = ntot.clamp(min=1.0)
        xat, yat = red.fsum(n * xavg) / safe, red.fsum(n * yavg) / safe
        # co-moments of the union: each part's own plus n_i (its mean - the whole's)^2
        ckt = red.fsum(ck + n * xavg * yavg) - ntot * xat * yat
        xm2t = (red.fsum(xm2 + n * xavg * xavg) - ntot * xat * xat).clamp(min=0.0)
        ym2t = (red.fsum(ym2 + n * yavg * yavg) - ntot * yat * yat).clamp(min=0.0)
        return [ColumnVector(t, group_mask, None, T.FLOAT64)
                for t in (ntot, xat, yat, ckt, xm2t, ym2t)]
    if a.func in E.WELFORD_FUNCS:
        n, avg, m2 = (torch.where(live, c.data, 0.0) for c in sts)
        ntot = red.fsum(n)
        avgt = red.fsum(n * avg) / ntot.clamp(min=1.0)
        # m2 of the union: sum of m2_i + n_i avg_i^2, less n avg^2 of the whole
        m2t = (red.fsum(m2 + n * avg * avg) - ntot * avgt * avgt).clamp(min=0.0)
        return [ColumnVector(t, group_mask, None, T.FLOAT64) for t in (ntot, avgt, m2t)]

    def added(cv: ColumnVector) -> torch.Tensor:
        return red.sum(torch.where(cv.validity & live, cv.data, 0).long())

    if a.func == E.AggFunc.COUNT:
        return [ColumnVector(added(sts[0]), group_mask, None, T.INT64)]
    st = sts[0]
    valid = st.validity & live
    s, sb, over = _decimal_sum(st, st.data, valid, red, st.dtype)
    s, sb = _unbounded_storage(s, sb, st, st.dtype, red)
    if a.func == E.AggFunc.SUM:
        has = (red.count(valid) > 0) & group_mask
    elif a.func == E.AggFunc.AVG:
        cnt = added(sts[1])
        has = (cnt > 0) & group_mask
    else:
        raise NotImplementedError(f"merging aggregate {a.func} is not ported yet")
    if over is not None:
        has = has & ~over
    state = ColumnVector(s, has, None, st.dtype,
                         mag_bound=quantize_bound(sb) if sb is not None else None)
    if a.func == E.AggFunc.SUM:
        return [state]
    return [state, ColumnVector(cnt, group_mask, None, T.INT64)]


def _finalize(a: E.AggExpr, vals: List[ColumnVector], rows: Optional[int]) -> ColumnVector:
    """State columns -> result column. ``rows``: a bound on every count (the
    input capacity when aggregating rows), or None."""
    rt = a.result_dtype()
    if a.func in (E.AggFunc.COUNT, E.AggFunc.SUM) + E.SPECIAL_FUNCS + _ONE_VALUE:
        return vals[0]
    if a.func in E.COVAR_FUNCS:
        n, _, _, ck, xm2, ym2 = (v.data for v in vals)
        if a.func == E.AggFunc.COVAR_POP:
            d = ck / n.clamp(min=1.0)
        elif a.func == E.AggFunc.COVAR_SAMP:  # of one row NaN, not null, as VAR_SAMP
            d = torch.where(n == 1.0, float("nan"), ck / (n - 1.0).clamp(min=1.0))
        else:  # CORR: NaN where either side has no spread
            denom = (xm2 * ym2).sqrt()
            d = torch.where(denom == 0.0, float("nan"), ck / denom.clamp(min=1e-300))
        return ColumnVector(d, (n >= 1) & vals[0].validity, None, T.FLOAT64)
    if a.func in E.WELFORD_FUNCS:
        n, _, m2 = (v.data for v in vals)
        samp = a.func in (E.AggFunc.VAR_SAMP, E.AggFunc.STDDEV_SAMP)
        d = m2 / ((n - 1.0) if samp else n).clamp(min=1.0)
        if a.func in (E.AggFunc.STDDEV_SAMP, E.AggFunc.STDDEV_POP):
            d = d.sqrt()
        if samp:  # Spark: of one row NaN, not null
            d = torch.where(n == 1.0, float("nan"), d)
        return ColumnVector(d, (n >= 1) & vals[0].validity, None, T.FLOAT64)
    s, cnt = vals
    if not rt.is_decimal:  # a float or integer sum over the count, in float64
        return ColumnVector(s.data.double() / cnt.data.clamp(min=1).double(),
                            s.validity & (cnt.data > 0), None, rt)
    # avg = sum / count at the result scale, HALF_UP: lift the sum state to
    # i128, upscale, divide by the count
    k = rt.scale - s.dtype.scale
    # below 2^31 rows the division takes 4 long-division steps, else 128
    # restoring steps (about 640 elementwise ops), with the same quotient
    q = DW._div_i128_i64_full(DW.rescale(DW.lift(s), k), cnt.data.clamp(min=1).long(),
                              den_bound=rows)
    ok = s.validity & (cnt.data > 0)
    vb = _dec_bound(s, s.dtype) * 10 ** max(k, 0)
    if rt.is_wide_decimal and vb >= _NARROW_LIMIT:
        return ColumnVector(DW.pack(q), ok, None, rt)
    return ColumnVector(q[1], ok, None, rt, mag_bound=quantize_bound(vb) if rt.is_wide_decimal else None)

"""Hash aggregate, dense bucket path (port of
``datafusion_comet_tpu/exec/operators/aggregate.py``: _try_pack_keys,
hash_aggregate, _bucket_aggregate, _input_agg, _merge_agg, _decimal_sum,
_finalize), in every mode: SINGLE and PARTIAL aggregate input rows, FINAL and
PARTIAL_MERGE merge the state columns PARTIAL emits (``state_fields``).

When the group keys pack into a small perfect-hash domain (dictionary codes,
bools, int8; at most ``agg_dense_max_domain`` buckets) the packed key IS the
bucket id: no row sort, no capacity hint, one pass per aggregate input.
Every per-bucket reduction runs on the hand-written kernels of
exec/kernels.py: sums on ``bucket_sum``, counts, presence and has-a-value
masks on ``bucket_count``. Dead rows carry bucket id == B and are dropped.

An ungrouped aggregate goes through the same path with one bucket: live
rows get id 0, dead rows id 1, and its one output row is always live, so it
emits exactly one row even over empty input (sum null, count 0). The JAX
package sorts there (_segments); the result is the same. Larger key domains
take the JAX package's sorted path, which is not ported yet.
"""

from __future__ import annotations

from typing import List, Optional, Sequence

import torch

from datafusion_comet_tpu_torch import types as T
from datafusion_comet_tpu_torch.exec import decimal_wide as DW
from datafusion_comet_tpu_torch.exec import kernels as K
from datafusion_comet_tpu_torch.exec.batch import Batch, ColumnVector, quantize_bound
from datafusion_comet_tpu_torch.exec.evaluator import EvalContext, _NARROW_LIMIT, _dec_bound, evaluate
from datafusion_comet_tpu_torch.ir import expr as E
from datafusion_comet_tpu_torch.ir.plan import AggMode
from datafusion_comet_tpu_torch.utils import int128

__all__ = ["state_fields", "hash_aggregate"]

_PACK_BITS_CAP = 24  # packed keys: at most 2^24 distinct codes


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


def hash_aggregate(
    batch: Batch,
    group_exprs: Sequence[E.Expr],
    agg_exprs: Sequence[E.AggExpr],
    mode: str,
    out_schema: T.Schema,
    ctx: Optional[EvalContext] = None,
    dense_max_domain: int = 64,
) -> Batch:
    ctx = ctx or EvalContext()
    key_cols = [evaluate(g, batch, ctx) for g in group_exprs]
    if not key_cols:
        seg = torch.where(batch.row_mask, 0, 1).int()
        return _bucket_aggregate(batch, key_cols, agg_exprs, mode, (seg, 1), out_schema, ctx)
    packed = _try_pack_keys(key_cols)
    if packed is None or packed[1] > max(dense_max_domain, 0):
        raise NotImplementedError(
            "group keys outside the dense bucket domain need the sorted aggregate path, "
            "which is not ported yet")
    return _bucket_aggregate(batch, key_cols, agg_exprs, mode, packed, out_schema, ctx)


def _bucket_aggregate(batch: Batch, key_cols, agg_exprs, mode: str, packed,
                      out_schema: T.Schema, ctx: EvalContext) -> Batch:
    """Direct-bucket aggregation: output capacity = bucket count; a group
    is live where its bucket holds a live row (always, when ungrouped)."""
    seg_raw, n_buckets = packed
    cap = batch.capacity
    seg = torch.where(batch.row_mask, seg_raw, n_buckets).int()
    if key_cols:
        group_mask = K.bucket_count(seg, n_buckets, ctx.errors) > 0
        # a representative row per bucket, to gather its key values
        first = torch.full((n_buckets + 1,), cap, dtype=torch.int64, device=batch.device)
        first.scatter_reduce_(0, seg.long(), torch.arange(cap, device=batch.device), "amin")
        first_orig = torch.where(group_mask, first[:n_buckets].clamp(0, cap - 1), 0)
    else:
        group_mask = torch.ones(1, dtype=torch.bool, device=batch.device)
    out_cols: List[ColumnVector] = [kc.take(first_orig) for kc in key_cols]
    merging = mode in (AggMode.FINAL, AggMode.PARTIAL_MERGE)
    for a in agg_exprs:
        if merging:
            vals = _merge_agg(a, batch, seg, n_buckets, group_mask, ctx)
        else:
            vals = _input_agg(a, batch, seg, n_buckets, group_mask, ctx)
        if mode in (AggMode.SINGLE, AggMode.FINAL):
            # merged counts are sums of counts: the input capacity bounds
            # them only when rows are aggregated directly
            out_cols.append(_finalize(a, vals, None if merging else cap))
        else:
            out_cols.extend(vals)
    return Batch(tuple(out_cols), group_mask, out_schema)


def _count(valid: torch.Tensor, seg: torch.Tensor, m: int, errors) -> torch.Tensor:
    """Per-bucket count of rows where ``valid`` (dead rows already carry m)."""
    return K.bucket_count(torch.where(valid, seg, m).int(), m, errors)


def _decimal_sum(cv: ColumnVector, x: torch.Tensor, valid: torch.Tensor, seg: torch.Tensor,
                 m: int, st: T.DataType, errors):
    """Per-bucket sum into state type ``st``: (state data, sum bound or None,
    overflow mask or None). A wide-typed sum whose sound bound (max|value| x
    rows) reaches int64 splits each value into four 32-bit lanes, sums all
    four in one launch and recombines them per bucket."""
    if st.is_decimal and st.is_wide_decimal:
        sb = _dec_bound(cv, cv.dtype if cv.dtype.is_decimal else st) * x.shape[0]
        if cv.is_wide_storage or sb >= _NARROW_LIMIT:
            p = DW.pair(x) if x.dim() == 2 else int128.from_i64(x.long())
            lanes = torch.stack([torch.where(valid, lane, 0) for lane in DW.decompose4(p)])
            sums = K.bucket_sum(seg, lanes, m, errors)
            packed = DW.pack(DW.recombine4(*sums))
            # Spark nulls decimal sums that overflow the 38-digit state: the
            # exact check catches 10^38..2^127, an f64 estimate of the lane
            # sums screens totals large enough to have wrapped i128
            est = sum(s.double() * 2.0 ** (32 * i) for i, s in enumerate(sums))
            over = DW.overflow_check(DW.pair(packed), st.precision) | (est.abs() >= 1.5e38)
            return packed, None, over
        return K.bucket_sum(seg, torch.where(valid, x, 0).long(), m, errors), sb, None
    if st.is_floating:
        raise NotImplementedError("floating-point SUM needs a float bucket kernel (not ported)")
    return K.bucket_sum(seg, torch.where(valid, x, 0).long(), m, errors), None, None


def _input_agg(a: E.AggExpr, batch: Batch, seg: torch.Tensor, m: int,
               group_mask: torch.Tensor, ctx: EvalContext) -> List[ColumnVector]:
    active = batch.row_mask
    if a.func == E.AggFunc.COUNT and a.child is None:  # COUNT(*)
        return [ColumnVector(_count(active, seg, m, ctx.errors), group_mask, None, T.INT64)]
    cv = evaluate(a.child, batch, ctx)
    valid = cv.validity & active
    if a.func == E.AggFunc.COUNT:
        return [ColumnVector(_count(valid, seg, m, ctx.errors), group_mask, None, T.INT64)]
    st = _sum_state_dtype(a)
    s, sb, over = _decimal_sum(cv, cv.data, valid, seg, m, st, ctx.errors)
    cnt = _count(valid, seg, m, ctx.errors)
    has = (cnt > 0) & group_mask
    if over is not None:
        has = has & ~over
    bound = quantize_bound(sb) if sb is not None else None
    state = ColumnVector(s, has, None, st, mag_bound=bound)
    if a.func == E.AggFunc.SUM:
        return [state]
    if a.func == E.AggFunc.AVG:
        return [state, ColumnVector(cnt, group_mask, None, T.INT64)]
    raise NotImplementedError(f"aggregate {a.func}")


def _merge_agg(a: E.AggExpr, batch: Batch, seg: torch.Tensor, m: int,
               group_mask: torch.Tensor, ctx: EvalContext) -> List[ColumnVector]:
    """Merge PARTIAL state columns per bucket into the same states: counts
    and sums add on the bucket kernels; a sum state is null where no input
    state of its group was valid."""
    sts = [batch.column(f.name) for f in state_fields(a)]
    live = batch.row_mask

    def added(cv: ColumnVector) -> torch.Tensor:
        return K.bucket_sum(seg, torch.where(cv.validity & live, cv.data, 0).long(), m,
                            ctx.errors)

    if a.func == E.AggFunc.COUNT:
        return [ColumnVector(added(sts[0]), group_mask, None, T.INT64)]
    st = sts[0]
    valid = st.validity & live
    s, sb, over = _decimal_sum(st, st.data, valid, seg, m, st.dtype, ctx.errors)
    if a.func == E.AggFunc.SUM:
        has = (_count(valid, seg, m, ctx.errors) > 0) & group_mask
    elif a.func == E.AggFunc.AVG:
        cnt = added(sts[1])
        has = (cnt > 0) & group_mask
    else:
        raise NotImplementedError(f"merging aggregate {a.func}")
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
    if a.func in (E.AggFunc.COUNT, E.AggFunc.SUM):
        return vals[0]
    s, cnt = vals
    if not rt.is_decimal:
        raise NotImplementedError("floating-point AVG is not ported yet")
    # avg = sum / count at the result scale, HALF_UP: lift the sum state to
    # i128, upscale, divide by the count
    k = rt.scale - s.dtype.scale
    q = DW._div_i128_i64_full(DW.rescale(DW.lift(s), k), cnt.data.clamp(min=1).long(),
                              den_bound=rows)
    ok = s.validity & (cnt.data > 0)
    vb = _dec_bound(s, s.dtype) * 10 ** max(k, 0)
    if rt.is_wide_decimal and vb >= _NARROW_LIMIT:
        return ColumnVector(DW.pack(q), ok, None, rt)
    return ColumnVector(q[1], ok, None, rt, mag_bound=quantize_bound(vb) if rt.is_wide_decimal else None)

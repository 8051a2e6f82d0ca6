"""Window operator (port of ``datafusion_comet_tpu/exec/operators/window.py``):
ranking (row_number, rank, dense_rank, percent_rank, cume_dist, ntile),
lag and lead with literal or column defaults, nth_value, and the aggregates
count, sum, avg, min, max, first and last over ROWS and RANGE frames.

One stable lexsort per distinct (partition, order) layout: the dead-row
flag first, so dead rows go last as the JAX package's leading
``~row_mask`` limb puts them, then the partition's grouping limbs and the
order limbs; ties keep the input order. Each window input is evaluated on
the unsorted batch and gathered once through the permutation. Partition
starts and peer changes come from the sorted limbs; a partition never
spans the live and the dead rows. Every function is then a scan or a shift
over the sorted rows, and its result goes back to row order by one scatter
through the permutation (the JAX package sorts a second time there, as a
gather is slow on its chip).

- Positions and ranks: ``torch.cummax`` over row indices (the JAX
  package's monotonic-index trick), values only (the index outputs of
  ``cummax``/``cummin`` on ties are not specified on the card).
- Sums: an integer sum is the difference of one int64 cumulative sum,
  exact mod 2^64 as in the JAX package. A float sum restarts at each
  partition start (``_seg_scan``, a log-step doubling scan), so one
  partition's rows never cancel against another's: the JAX package's
  prefix difference over the whole capacity loses a small partition's
  precision after large ones (its ROADMAP C12 flaw, here in windows too).
- Running and whole-partition MIN/MAX: the same doubling scan with
  ``torch.minimum``/``torch.maximum`` (NaN propagates, as ``jnp.minimum``
  does), in place of the JAX package's ``associative_scan``.
- RANGE frames with value offsets: a vectorized binary search over the
  sorted (partition, key) pairs for each row's frame ends.

Where the port differs from the JAX package, the port follows Spark and its
test holds it to an oracle (ROADMAP C20): a ROWS frame with one unbounded
end (the JAX package treats it as CURRENT ROW), an AVG over a decimal (the
JAX package leaves it unscaled), and a running FIRST over a RANGE frame
(every peer sees the first value up to its peer group's end). Aggregate
functions over a two-limb decimal or a padded string raise
NotImplementedError, as the JAX package cannot run them either.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence

import torch

from datafusion_comet_tpu_torch import types as T
from datafusion_comet_tpu_torch.exec import sortkeys
from datafusion_comet_tpu_torch.exec.batch import Batch, ColumnVector
from datafusion_comet_tpu_torch.exec.evaluator import EvalContext, _literal, evaluate
from datafusion_comet_tpu_torch.ir import expr as E

__all__ = ["result_dtype", "window_op"]

_RANKING = ("row_number", "rank", "dense_rank", "percent_rank", "cume_dist", "ntile")
_I32_MAX = (1 << 31) - 1


def result_dtype(w: E.WindowExpr) -> T.DataType:
    f = w.func
    if f in ("row_number", "rank", "dense_rank", "ntile"):
        return T.INT32
    if f in ("percent_rank", "cume_dist"):
        return T.FLOAT64
    if f in ("lag", "lead", "nth_value", "first", "last", "min", "max"):
        return w.child.dtype if w.child is not None and w.child.dtype else T.NULLTYPE
    if f == "count":
        return T.INT64
    if f == "sum":
        cd = w.child.dtype
        if cd.is_decimal:
            return T.decimal(min(cd.precision + 10, T.MAX_DECIMAL_PRECISION), cd.scale)
        return T.INT64 if cd.is_integer else T.FLOAT64
    if f == "avg":
        return T.FLOAT64
    raise NotImplementedError(f"window func {f}")


class _Layout:
    """The sorted rows of one (partition, order) layout: ``perm`` (sorted
    position -> input row), ``live`` (sorted row mask), ``part_start`` and
    ``order_change`` flags, ``start`` (index of each row's partition start),
    ``pos`` (position within the partition), ``n_part`` (live rows of
    the partition, on each of its rows) and ``order_cvs`` (the order keys,
    sorted)."""

    def __init__(self, batch: Batch, partition_by, order_by, ctx):
        cap, dev = batch.capacity, batch.device
        dead = (~batch.row_mask).int()
        plimbs = (sortkeys.grouping_limbs([evaluate(p, batch, ctx) for p in partition_by])
                  if partition_by else [])
        olimbs: List[torch.Tensor] = []
        order_cvs = [evaluate(o.child, batch, ctx) for o in order_by]
        for o, cv in zip(order_by, order_cvs):
            olimbs += sortkeys.order_limbs(cv, o.ascending, o.resolved_nulls_first())
        self.perm = sortkeys.lexsort([dead] + plimbs + olimbs)
        self.order_cvs = [cv.take(self.perm) for cv in order_cvs]
        self.cap, self.idx = cap, torch.arange(cap, device=dev)
        self.live = batch.row_mask[self.perm]
        self.part_start = _changes([dead[self.perm]] + [l[self.perm] for l in plimbs], cap, dev)
        self.order_change = self.part_start | _changes([l[self.perm] for l in olimbs], cap, dev)
        self.start = _seg_start_index(self.part_start, self.idx)
        self.pos = self.idx - self.start
        self.n_part = self.seg_total_int(self.live.long())

    def seg_prefix_int(self, x: torch.Tensor) -> torch.Tensor:
        """Inclusive int64 prefix sum restarting at each partition start."""
        acc = torch.cumsum(x, 0)
        return acc - (acc - x)[self.start]

    def seg_total_int(self, x: torch.Tensor) -> torch.Tensor:
        return self.seg_prefix_int(x)[_seg_end_index(self.part_start, self.idx)]

    def seg_prefix(self, x: torch.Tensor) -> torch.Tensor:
        """Inclusive prefix sum within each partition: exact integers, or a
        float sum that restarts at each partition start."""
        if x.is_floating_point():
            return _seg_scan(x, self.start, self.idx, torch.add)
        return self.seg_prefix_int(x)


def _changes(limbs: Sequence[torch.Tensor], cap: int, dev) -> torch.Tensor:
    """True at row 0 and wherever any limb differs from the row before."""
    ch = torch.zeros(cap, dtype=torch.bool, device=dev)
    ch[:1] = True
    for s in limbs:
        ch[1:] |= s[1:] != s[:-1]
    return ch


def _seg_start_index(seg_start: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Per row: the index of the first row of its segment (a cummax over
    row indices, which only grow)."""
    return torch.cummax(torch.where(seg_start, idx, -1), 0).values


def _seg_end_index(seg_start: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Per row: the index of the last row of its segment."""
    is_end = torch.cat([seg_start[1:], seg_start.new_ones(1)])
    rev = torch.where(is_end, idx, _I32_MAX).flip(0)
    return torch.cummin(rev, 0).values.flip(0)


def _seg_scan(x: torch.Tensor, start: torch.Tensor, idx: torch.Tensor, op) -> torch.Tensor:
    """Inclusive scan of ``op`` restarting at each segment (Hillis-Steele:
    at step d a row takes in the row d before it while that row is in its
    segment). log2(n) elementwise steps."""
    d = 1
    n = x.shape[0]
    while d < n:
        ok = idx[d:] - d >= start[d:]
        x = torch.cat([x[:d], torch.where(ok, op(x[d:], x[:-d]), x[d:])])
        d *= 2
    return x


def window_op(batch: Batch, window_exprs: Sequence[E.WindowExpr], out_schema: T.Schema,
              ctx: Optional[EvalContext] = None) -> Batch:
    """The batch's columns, then one per window expression, in row order.
    Expressions with the same partition and order share one sort."""
    ctx = ctx or EvalContext()
    layouts: Dict[tuple, List[int]] = {}
    for wi, w in enumerate(window_exprs):
        layouts.setdefault((repr(w.partition_by), repr(w.order_by)), []).append(wi)
    results: List[Optional[ColumnVector]] = [None] * len(window_exprs)
    for members in layouts.values():
        w0 = window_exprs[members[0]]
        lay = _Layout(batch, w0.partition_by, w0.order_by, ctx)
        sorted_of: Dict[int, ColumnVector] = {}

        def sorted_cv(ex) -> Optional[ColumnVector]:
            if ex is None:
                return None
            if isinstance(ex, E.Literal):
                return _literal(ex, batch.capacity, batch.device)
            if id(ex) not in sorted_of:
                sorted_of[id(ex)] = evaluate(ex, batch, ctx).take(lay.perm)
            return sorted_of[id(ex)]

        for wi in members:
            w = window_exprs[wi]
            cv = _one_window(w, sorted_cv(w.child), sorted_cv(w.default), lay, result_dtype(w))
            results[wi] = _unsort(cv, lay.perm)
    return Batch(tuple(batch.columns) + tuple(results), batch.row_mask, out_schema)


def _unsort(cv: ColumnVector, perm: torch.Tensor) -> ColumnVector:
    """Sorted rows back to row order: one scatter through the permutation."""

    def back(t):
        if t is None:
            return None
        out = torch.empty_like(t)
        out[perm] = t
        return out

    return ColumnVector(back(cv.data), back(cv.validity), back(cv.lengths), cv.dtype,
                        cv.dictionary)


def _one_window(w: E.WindowExpr, child: Optional[ColumnVector], default: Optional[ColumnVector],
                lay: _Layout, rd: T.DataType) -> ColumnVector:
    f, live, n_part = w.func, lay.live, lay.n_part
    if f in _RANKING:
        return ColumnVector(_ranking(w, lay), live, None, rd)
    if f in ("lag", "lead"):
        return _lag_lead(w, child, default, lay, rd)
    if f == "nth_value":
        tgt = (lay.start + (w.offset - 1)).clamp(0, lay.cap - 1)
        ok = (w.offset - 1) < n_part
        taken = child.take(tgt)
        return ColumnVector(taken.data, taken.validity & ok & live, taken.lengths, rd,
                            child.dictionary)
    # aggregates over a frame
    if child is None:  # count(*)
        x, v = torch.ones(lay.cap, dtype=torch.int64, device=live.device), live
    else:
        if child.data.dim() != 1 or child.lengths is not None:
            raise NotImplementedError(
                f"window {f} over {child.dtype!r} in two-limb or padded storage")
        x, v = child.data, child.validity & live
        if f == "avg" and child.dtype.is_decimal:
            # Spark's AVG of a decimal is of its value, not of its unscaled
            # integer (the JAX package divides the latter: ROADMAP C20)
            x = x.double() / torch.full((), 10.0 ** child.dtype.scale, dtype=torch.float64,
                                        device=x.device)
    frame = w.frame
    if frame.lower is None and frame.upper == 0:
        return _running_agg(f, x, v, lay, frame.frame_type == "range", rd)
    if frame.lower is None and frame.upper is None:
        return _whole_partition_agg(f, x, v, lay, rd)
    if frame.frame_type == "rows":
        return _sliding_rows_agg(f, x, v, lay, frame.lower, frame.upper, rd)
    if frame.frame_type == "range":
        return _sliding_range_agg(w, f, x, v, lay, frame.lower, frame.upper, rd)
    raise NotImplementedError(f"window frame {frame}")


def _rank(lay: _Layout) -> torch.Tensor:
    """Within-partition position of the last peer-group start, plus one."""
    last_change = torch.cummax(torch.where(lay.order_change, lay.idx, -1), 0).values
    return last_change - lay.start + 1


def _ranking(w: E.WindowExpr, lay: _Layout) -> torch.Tensor:
    f, pos, n_part = w.func, lay.pos, lay.n_part
    if f == "row_number":
        return (pos + 1).int()
    if f == "rank":
        return _rank(lay).int()
    if f == "dense_rank":
        return lay.seg_prefix_int(lay.order_change.long()).int()
    if f == "percent_rank":
        data = (_rank(lay) - 1).double() / (n_part - 1).clamp(min=1).double()
        return torch.where(n_part == 1, 0.0, data)
    if f == "cume_dist":
        # rows ordered at or before this one: the peer group's last position + 1
        peer_end = pos[_seg_end_index(lay.order_change, lay.idx)]
        return (peer_end + 1).double() / n_part.clamp(min=1).double()
    n = w.offset  # ntile: the bucket count; the first n_part % n buckets get one row more
    np_ = n_part.clamp(min=1)
    base, rem = np_ // n, np_ % n
    big = rem * (base + 1)
    data = torch.where(pos < big, pos // (base + 1).clamp(min=1),
                       rem + (pos - big) // base.clamp(min=1)) + 1
    return data.int()


def _lag_lead(w, child: ColumnVector, default: Optional[ColumnVector], lay: _Layout,
              rd: T.DataType) -> ColumnVector:
    """The row ``offset`` before (lag) or after (lead) in the partition;
    outside it the default, or null."""
    cv = child
    if default is not None:  # codes of one dictionary, or bytes on both sides
        cv, default = cv.unify_encoding(default)
    off = w.offset if w.func == "lag" else -w.offset
    in_seg = (lay.pos >= w.offset) if w.func == "lag" else (lay.pos + w.offset < lay.n_part)
    data, valid = torch.roll(cv.data, off, 0), torch.roll(cv.validity, off, 0)
    lengths = None if cv.lengths is None else torch.roll(cv.lengths, off, 0)
    if default is None:
        valid = valid & in_seg
        if lengths is not None:
            lengths = torch.where(in_seg, lengths, 0)
    else:
        ddata = default.data
        if ddata.dim() == 2 and ddata.shape[1] != data.shape[1]:  # padded widths differ
            w_ = max(ddata.shape[1], data.shape[1])
            data = torch.nn.functional.pad(data, (0, w_ - data.shape[1]))
            ddata = torch.nn.functional.pad(ddata, (0, w_ - ddata.shape[1]))
        sel = in_seg.view(-1, *([1] * (data.dim() - 1)))
        data = torch.where(sel, data, ddata)
        valid = torch.where(in_seg, valid, default.validity)
        if lengths is not None:
            lengths = torch.where(in_seg, lengths, default.lengths)
    return ColumnVector(data, valid & lay.live, lengths, rd, cv.dictionary)


def _acc(f: str, x: torch.Tensor, v: torch.Tensor, rd: T.DataType) -> torch.Tensor:
    """The summand of a sum, count or avg: float64 for a float result or an
    avg, else int64; zero on rows that do not count."""
    if f == "count":
        return v.long()
    dt = torch.float64 if rd.is_floating or f == "avg" else torch.int64
    return torch.where(v, x.to(dt), torch.zeros((), dtype=dt, device=x.device))


def _sum_result(f: str, s: torch.Tensor, c: torch.Tensor, live: torch.Tensor,
                rd: T.DataType) -> ColumnVector:
    if f == "count":
        return ColumnVector(c, live, None, rd)
    if f == "avg":
        return ColumnVector(s / c.clamp(min=1).double(), live & (c > 0), None, rd)
    return ColumnVector(s, live & (c > 0), None, rd)


def _ident(x: torch.Tensor, is_min: bool):
    """The identity of MIN (MAX) for ``x``'s dtype: +inf (-inf), or the
    integer type's largest (smallest) value."""
    if x.is_floating_point():
        return float("inf") if is_min else float("-inf")
    info = torch.iinfo(x.dtype)
    return info.max if is_min else info.min


def _minmax_input(f: str, x: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    return torch.where(v, x, torch.full_like(x, _ident(x, f == "min")))


def _minmax_op(f: str):
    return torch.minimum if f == "min" else torch.maximum


def _peer_end(t: torch.Tensor, lay: _Layout) -> torch.Tensor:
    """RANGE frames take peer rows as one: each row sees its peer group's
    last row's value."""
    return t[_seg_end_index(lay.order_change, lay.idx)]


def _running_agg(f: str, x, v, lay: _Layout, peers: bool, rd: T.DataType) -> ColumnVector:
    """UNBOUNDED PRECEDING .. CURRENT ROW (ROWS), or .. the current peer
    group's end (RANGE)."""
    live = lay.live
    smear = (lambda t: _peer_end(t, lay)) if peers else (lambda t: t)
    cnt = smear(lay.seg_prefix_int(v.long()))
    if f in ("sum", "avg", "count"):
        return _sum_result(f, smear(lay.seg_prefix(_acc(f, x, v, rd))), cnt, live, rd)
    if f in ("min", "max"):
        pre = _seg_scan(_minmax_input(f, x, v), lay.start, lay.idx, _minmax_op(f))
        return ColumnVector(smear(pre), live & (cnt > 0), None, rd)
    if f in ("first", "last"):
        is_first = f == "first"
        marked = torch.where(v, lay.idx, lay.cap if is_first else -1)
        m = smear(_seg_scan(marked, lay.start, lay.idx,
                            torch.minimum if is_first else torch.maximum))
        ok = (m < lay.cap) & (m >= 0)
        return ColumnVector(x[m.clamp(0, lay.cap - 1)], live & ok, None, rd)
    raise NotImplementedError(f"running window agg {f}")


def _whole_partition_agg(f: str, x, v, lay: _Layout, rd: T.DataType) -> ColumnVector:
    end = _seg_end_index(lay.part_start, lay.idx)
    cnt = lay.seg_prefix_int(v.long())[end]
    if f in ("sum", "avg", "count"):
        return _sum_result(f, lay.seg_prefix(_acc(f, x, v, rd))[end], cnt, lay.live, rd)
    if f in ("min", "max"):
        pre = _seg_scan(_minmax_input(f, x, v), lay.start, lay.idx, _minmax_op(f))
        return ColumnVector(pre[end], lay.live & (cnt > 0), None, rd)
    raise NotImplementedError(f"whole-partition window agg {f}")


def _frame_sum(prefix: torch.Tensor, lay: _Layout, a: torch.Tensor, b: torch.Tensor):
    """Per row the sum over sorted rows [a, b] (inclusive, within the
    partition; empty where a > b) from a within-partition prefix sum."""
    empty = a > b
    hi = prefix[b.clamp(0, lay.cap - 1)]
    lo = torch.where(a > lay.start, prefix[(a - 1).clamp(0, lay.cap - 1)], torch.zeros_like(hi))
    return torch.where(empty, torch.zeros_like(hi), hi - lo)


def _sliding_rows_agg(f: str, x, v, lay: _Layout, lower, upper, rd) -> ColumnVector:
    """ROWS BETWEEN ``lower`` AND ``upper`` (row offsets, negative
    preceding; None unbounded): sums as prefix differences within the
    partition, MIN/MAX as a max over the frame's shifted rows."""
    last = lay.start + (lay.n_part - 1)  # dead rows are never in a live row's frame
    a = lay.start if lower is None else torch.maximum(lay.idx + lower, lay.start)
    b = last if upper is None else torch.minimum(lay.idx + upper, last)
    if f in ("sum", "count", "avg"):
        c = _frame_sum(lay.seg_prefix_int(v.long()), lay, a, b)
        return _sum_result(f, _frame_sum(lay.seg_prefix(_acc(f, x, v, rd)), lay, a, b), c,
                           lay.live, rd)
    if f in ("min", "max"):
        if lower is None or upper is None:
            raise NotImplementedError("sliding window min/max with an unbounded end")
        assert upper - lower + 1 <= 1024, "sliding min/max window too wide for shift method"
        xs = _minmax_input(f, x, v)
        acc = torch.full_like(xs, _ident(xs, f == "min"))
        any_v = torch.zeros_like(v)
        for off in range(lower, upper + 1):
            j = lay.idx + off
            here = (j >= a) & (j <= b) & torch.roll(v, -off, 0)
            acc = torch.where(here, _minmax_op(f)(acc, torch.roll(xs, -off, 0)), acc)
            any_v |= here
        return ColumnVector(acc, lay.live & any_v, None, rd)
    raise NotImplementedError(f"sliding window agg {f}")


def _lex_search(part_id, key, q_key, left: bool) -> torch.Tensor:
    """Per row i, over the sorted (partition id, key) pairs: the first index
    whose pair is >= (part_id[i], q_key[i]) (``left``) or > it. A
    vectorized binary search, log2(n) gathers."""
    n = part_id.shape[0]
    lo = torch.zeros_like(part_id, dtype=torch.int64)
    hi = torch.full_like(lo, n)
    for _ in range(max(n.bit_length(), 1)):
        mid = (lo + hi) // 2
        midc = mid.clamp(0, n - 1)
        pm, km = part_id[midc], key[midc]
        less = (pm < part_id) | ((pm == part_id) & ((km < q_key) if left else (km <= q_key)))
        lo = torch.where(less & (mid < hi), mid + 1, lo)
        hi = torch.where(less, hi, mid)
    return lo


def _sliding_range_agg(w, f: str, x, v, lay: _Layout, lower, upper, rd) -> ColumnVector:
    """RANGE frames with value offsets over one integer, date, timestamp or
    decimal order key: the frame of a row is its partition's rows whose key
    lies in [k - lower, k + upper] along the sort direction (null keys:
    their peers only). SUM, COUNT and AVG."""
    if len(w.order_by) != 1:
        raise NotImplementedError("a RANGE frame needs exactly one ORDER BY key")
    if f not in ("sum", "count", "avg"):
        raise NotImplementedError(f"range-frame window agg {f}")
    o = w.order_by[0]
    kcv = lay.order_cvs[0]
    if kcv.dtype.is_binary or kcv.dtype.is_floating or kcv.data.dim() != 1:
        raise NotImplementedError("RANGE offsets need an integer, date or decimal key")
    limb = kcv.data.long()
    if not o.ascending:
        limb = ~limb  # reversed order: an offset along the sort is limb + d
    sentinel = -(1 << 62) if o.resolved_nulls_first() else (1 << 62)
    limb = torch.where(kcv.validity, limb, sentinel)
    part_id = torch.where(lay.live, torch.cumsum(lay.part_start.long(), 0) - 1, 1 << 40)
    a = lay.start if lower is None else _lex_search(part_id, limb, limb - lower, True)
    end = (lay.start + lay.n_part if upper is None
           else _lex_search(part_id, limb, limb + upper, False))
    c = _frame_sum(lay.seg_prefix_int(v.long()), lay, a, end - 1)
    return _sum_result(f, _frame_sum(lay.seg_prefix(_acc(f, x, v, rd)), lay, a, end - 1), c,
                       lay.live, rd)

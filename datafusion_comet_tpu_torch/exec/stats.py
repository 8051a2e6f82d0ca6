"""Table statistics and the group capacities derived from them (port of the
subset of ``datafusion_comet_tpu/exec/stats.py`` that the ported TPC-H and
TPC-DS queries reach: ``collect_stats`` :42,
``derive_capacities`` :129, ``_walk`` :220 over Scan, Filter, Projection,
HashJoin, SortMergeJoin, BroadcastNestedLoopJoin, Union, Expand,
HashAggregate, Sort, Limit, Window and ShuffleExchange, ``_column_range`` :167,
``_source_column`` :480, ``_pad`` :490).

``collect_stats`` sketches each registered table on the host: its rows, a
distinct-count estimate per column (exact up to 65,536 rows, else from a
seeded sample) and the exact (min, max) of each integer and date column.
``derive_capacities`` walks a bound plan bottom-up with (row estimate,
{column: distinct estimate}) and fills each aggregate's ``max_groups`` (the
estimate twice over, a power of two, at least 1024) and its
``group_key_ranges``. An estimate that is too small costs a re-run: the
aggregate flags the overflow and the session runs again with the capacity
four times larger.

The walk also leaves the JAX package's planner hints on the nodes, where
a hint is None (a hint set already wins):

- a Filter's ``out_rows_hint``, its row estimate (:231-236), from which the
  engine compacts a filter that keeps under an eighth of its capacity;
- on a semi, anti or existence join (:251-305) ``build_key_range``, the
  exact range of a single build key; with a condition, ``cond_col_ranges``,
  the exact range of each column the condition names (:271-291), from the
  build side's scans, else the probe side's; and for LEFT_SEMI
  ``out_rows_hint``, the probe rows times the share of the probe key's
  distinct values the build side can hold;
- on an INNER join (:306-404): the build side moves to the left input when
  that is at most half the right's estimate (an outer join keeps its build
  side: it probes its preserved side); then, on outer joins too,
  ``build_key_range``
  (after the swap), ``unique_build_hint`` where the build key's distinct
  estimate is at least 0.8 x the build rows, ``key_pack`` where every key
  of a multi-key join has a range on both sides (their union, the spans'
  product under 2^62), ``fanout_hint`` (twice the build rows over the
  build keys' distinct product, a power of two in [2, 256]) and
  ``out_rows_hint``, the foreign-key-to-primary-key estimate: the smaller
  side thins the larger by its rows over its key's distinct count (an outer
  join's at least its preserved side's rows; the estimate the walk hands up
  stays the formula's, as in the JAX walk).

A runtime filter's semi join (exec/runtime_filter.py) comes with its row
estimate set, and its key table is registered with statistics, so the walk
gives it the key table's range as ``build_key_range``; the INNER join above
it keeps the estimate the injector set, and the estimates above follow it,
as in the JAX walk.

"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, Optional, Tuple

import numpy as np

from datafusion_comet_tpu_torch import types as T
from datafusion_comet_tpu_torch.ir import expr as E
from datafusion_comet_tpu_torch.ir import plan as P

__all__ = ["TableStats", "collect_stats", "derive_capacities", "DEFAULT_MAX_GROUPS"]

DEFAULT_MAX_GROUPS = 1 << 16
_SAMPLE = 65536
_RANGE_SELECTIVITY = 0.4
_FILTER_SELECTIVITY = 0.5


@dataclasses.dataclass
class TableStats:
    rows: int
    ndv: Dict[str, int]  # per-column distinct-count estimate
    # exact (min, max) of each integer and date column
    ranges: Dict[str, Tuple[int, int]] = dataclasses.field(default_factory=dict)


def collect_stats(data: Dict[str, np.ndarray], schema: T.Schema) -> TableStats:
    """Rows, distinct-count estimates and integer ranges of host columns.
    Beyond 65,536 rows a seeded sample's distinct count is scaled up by
    inverting the coupon collector's expectation."""
    n = len(next(iter(data.values()))) if data else 0
    ndv: Dict[str, int] = {}
    ranges: Dict[str, Tuple[int, int]] = {}
    for f in schema.fields:
        col = data.get(f.name)
        if col is None or n == 0 or f.dtype.is_nested:  # no scalar NDV (JAX ``stats.py:54``)
            continue
        arr = np.asarray(col)
        if arr.ndim != 1:
            continue
        if n <= _SAMPLE:
            sample = arr
        else:
            sample = arr[np.random.default_rng(0).choice(n, _SAMPLE, replace=False)]
        try:
            u = len(np.unique(sample[~_null_mask(sample)])) or 1
        except TypeError:  # an unorderable mix of objects
            ndv[f.name] = min(n, DEFAULT_MAX_GROUPS)
        else:
            ndv[f.name] = max(u, 1) if n <= _SAMPLE else _invert_coupon(u, _SAMPLE, n)
        if (f.dtype.is_integer or f.dtype.type_id == "DATE") and np.issubdtype(arr.dtype,
                                                                               np.integer):
            ranges[f.name] = (int(arr.min()), int(arr.max()))
    return TableStats(rows=n, ndv=ndv, ranges=ranges)


def _invert_coupon(u: int, s: int, n: int) -> int:
    """Distinct-count estimate of an n-row column whose size-s sample shows
    u distinct values: the d with E[u] = d (1 - (1 - 1/d)^s), by bisection."""
    if u >= s:  # every sampled row distinct: a mostly unique column
        return n
    lo, hi = u, n
    for _ in range(60):
        if hi - lo <= max(1, lo // 1000):
            break
        d = (lo + hi) / 2
        exp_u = d * (1.0 - math.exp(s * math.log1p(-1.0 / d)))
        if exp_u < u:
            lo = d
        else:
            hi = d
    return max(int((lo + hi) / 2), 1)


def _null_mask(arr: np.ndarray) -> np.ndarray:
    if arr.dtype == object:
        return np.array([v is None for v in arr], dtype=bool)
    return np.zeros(len(arr), bool)


def derive_capacities(plan: P.PlanNode, stats: Dict[str, TableStats]) -> None:
    """Fill, in place, every aggregate's ``max_groups`` that is None with
    min(product of its keys' distinct estimates, its input row estimate)
    padded, and its ``group_key_ranges`` where a key's source column has a
    known range; and the filters' and joins' hints (the module docstring).
    Distinct estimates are the base tables' (filters never shrink them, so
    they stay upper bounds); each use caps them by the row estimate."""
    _walk(plan, stats)


def _conjuncts(e: E.Expr):
    if isinstance(e, E.BinaryOp) and e.op == "and":
        return _conjuncts(e.left) + _conjuncts(e.right)
    return [e]


def _pred_selectivity(pred: E.Expr, ndv: Dict[str, int]) -> float:
    """Per conjunct: equality 1/ndv, IN-list k/ndv, a range 0.4, anything
    else 0.5 (System R's defaults)."""
    sel = 1.0
    for c in _conjuncts(pred):
        if isinstance(c, E.BinaryOp) and c.op == "or":
            sel *= min(_pred_selectivity(c.left, ndv) + _pred_selectivity(c.right, ndv), 1.0)
            continue
        if isinstance(c, E.BinaryOp):
            col = _source_column(c.left) or _source_column(c.right)
            if c.op == "eq" and col and col in ndv:
                sel *= 1.0 / max(ndv[col], 1)
            elif c.op in ("lt", "le", "gt", "ge"):
                sel *= _RANGE_SELECTIVITY
            else:
                sel *= _FILTER_SELECTIVITY
        elif isinstance(c, E.InList):
            col = _source_column(c.child)
            k = len(c.values)
            sel *= min(k / max(ndv.get(col, 10), 1), 1.0) if col else _FILTER_SELECTIVITY
        else:
            sel *= _FILTER_SELECTIVITY
    return max(sel, 1e-6)


def _column_range(plan: P.PlanNode, name: str, stats: Dict[str, TableStats]):
    """Exact (min, max) of a named column in a subtree, following renames
    (projections, group keys) down to the Scans; None when scans disagree.
    Filters and joins only remove values, so the base range bounds them."""
    hits = []

    def walk(p, nm):
        if isinstance(p, P.Scan):
            st = stats.get(p.table)
            if st is not None and nm in st.ranges and any(
                    f.name == nm for f in p.out_schema().fields):
                hits.append(st.ranges[nm])
            return
        if isinstance(p, (P.Projection, P.HashAggregate)):
            exprs = p.exprs if isinstance(p, P.Projection) else p.group_exprs
            for e in exprs:
                if e.name == nm:
                    src = _source_column(e)
                    if src:
                        walk(p.child, src)
                    return
            return  # computed values have no source range
        for c in p.children():
            walk(c, nm)

    walk(plan, name)
    return hits[0] if len(set(hits)) == 1 else None


def _walk(plan: P.PlanNode, stats: Dict[str, TableStats]) -> Tuple[int, Dict[str, int]]:
    """(row estimate, {output column: base distinct estimate})."""
    if isinstance(plan, P.Scan):
        st = stats.get(plan.table)
        if st is None:
            return DEFAULT_MAX_GROUPS, {}
        names = [f.name for f in plan.out_schema().fields]
        return max(st.rows, 1), {k: v for k, v in st.ndv.items() if k in names}

    kids = [_walk(c, stats) for c in plan.children()]

    if isinstance(plan, P.Filter):
        rows, ndv = kids[0]
        rows = max(int(rows * _pred_selectivity(plan.predicate, ndv)), 1)
        if plan.out_rows_hint is None:
            plan.out_rows_hint = rows
        return rows, ndv

    if isinstance(plan, P.Projection):
        rows, ndv = kids[0]
        out: Dict[str, int] = {}
        for e in plan.exprs:
            src = _source_column(e)
            if src is not None and src in ndv:
                out[e.name] = ndv[src]
        return rows, out

    if isinstance(plan, P.EQUI_JOINS):  # a SortMergeJoin as a HashJoin (JAX :247)
        (lr, ln), (rr, rn) = kids
        if plan.join_type in _SEMI_LIKE:
            _set_build_range(plan, stats)
            if plan.condition is not None and plan.cond_col_ranges is None:
                crs = {}
                for name in _condition_columns(plan.condition):
                    r = (_column_range(plan.right, name, stats)
                         or _column_range(plan.left, name, stats))
                    if r is not None:
                        crs[name] = r
                plan.cond_col_ranges = crs or None
            lk0 = _source_column(plan.left_keys[0]) if plan.left_keys else None
            if plan.join_type == P.JoinType.LEFT_SEMI and lk0 and lk0 in ln:
                # the probe rows that survive: lr x (build rows / probe-key
                # distinct values); it sizes the engine's semi-output
                # compaction (the >= 8x rule: a mild overestimate costs nothing)
                est = max(int(lr * min(1.0, rr / max(ln[lk0], 1))), 1)
                if plan.out_rows_hint is None:
                    plan.out_rows_hint = est
                ln = dict(ln)
                ln[lk0] = min(ln[lk0], max(rr, 1))
                return est, ln
            return lr, ln
        # INNER and the outer joins (JAX :355-395)
        lk = [_source_column(k) for k in plan.left_keys]
        rk = [_source_column(k) for k in plan.right_keys]
        # an INNER join's build goes to the smaller input, with a 2x margin
        # against noisy estimates; an outer join probes its preserved side.
        # A SortMergeJoin's build side is its join type's (JAX: only a
        # HashJoin swaps)
        if (isinstance(plan, P.HashJoin) and plan.join_type == P.JoinType.INNER
                and plan.build_side == "right" and lr * 2 <= rr):
            plan.build_side = "left"
        _set_build_range(plan, stats)
        _set_inner_hints(plan, stats, (lr, ln, lk), (rr, rn, rk))
        # foreign key to primary key: the smaller side thins the larger by
        # its rows over its key's distinct count, and caps the larger
        # side's key's distinct count
        rows = max(lr, rr)
        ndv = {**rn, **ln}
        if rr <= lr and rk and rk[0] in rn:
            rows = max(int(lr * min(1.0, rr / max(rn[rk[0]], 1))), 1)
            if lk and lk[0]:
                ndv[lk[0]] = min(ndv.get(lk[0], rr), rr)
        elif lr < rr and lk and lk[0] in ln:
            rows = max(int(rr * min(1.0, lr / max(ln[lk[0]], 1))), 1)
            if rk and rk[0]:
                ndv[rk[0]] = min(ndv.get(rk[0], lr), lr)
        # the output estimate: an outer join keeps every row of its preserved
        # side; the estimate handed up stays the key formula's, as in JAX
        est = rows
        if plan.join_type in (P.JoinType.LEFT, P.JoinType.FULL):
            est = max(est, lr)
        if plan.join_type in (P.JoinType.RIGHT, P.JoinType.FULL):
            est = max(est, rr)
        if plan.out_rows_hint is None:
            plan.out_rows_hint = est
        else:  # a hint set already wins, and the estimates above follow it
            rows = max(int(plan.out_rows_hint), 1)
        return rows, ndv

    if isinstance(plan, P.BroadcastNestedLoopJoin):  # every pair (JAX :406)
        (lr, ln), (rr, rn) = kids
        return max(lr * rr, 1), {**rn, **ln}

    if isinstance(plan, P.Union):  # JAX :411
        rows = sum(r for r, _ in kids)
        ndv = {}
        for _, n in kids:
            for k, v in n.items():
                ndv[k] = ndv.get(k, 0) + v
        return rows, {k: min(v, rows) for k, v in ndv.items()}

    if isinstance(plan, P.Expand):  # JAX :419; a tag or literal column: n_proj values
        rows, ndv = kids[0]
        n_proj = len(plan.projections)
        out = {name: min(ndv[name] + n_proj, rows * n_proj) if name in ndv else n_proj
               for name in plan.names}
        return rows * n_proj, out

    if isinstance(plan, P.HashAggregate):
        rows, ndv = kids[0]
        est, known = 1, True
        for g in plan.group_exprs:
            src = _source_column(g)
            if src is not None and src in ndv:
                est *= max(min(ndv[src], rows), 1)
            else:
                known = False
        if not plan.group_exprs:
            groups = 1
        elif known:
            groups = min(est, rows)
        elif est > 1:
            groups = min(est * DEFAULT_MAX_GROUPS, rows)
        else:
            groups = min(DEFAULT_MAX_GROUPS, rows)
        if plan.max_groups is None:
            plan.max_groups = _pad(groups)
        if plan.group_exprs and plan.group_key_ranges is None:
            krs = []
            for g in plan.group_exprs:
                src = _source_column(g)
                krs.append(_column_range(plan.child, src, stats) if src else None)
            if any(r is not None for r in krs):
                plan.group_key_ranges = tuple(krs)
        out = {}
        for g in plan.group_exprs:
            src = _source_column(g)
            out[g.name] = min(ndv.get(src, groups), groups) if src else groups
        return max(groups, 1), out

    if isinstance(plan, (P.Sort, P.Limit)):
        rows, ndv = kids[0]
        cut = plan.fetch if isinstance(plan, P.Sort) else plan.limit
        if cut is not None:
            rows = min(rows, cut)
        return rows, {k: min(v, rows) for k, v in ndv.items()}

    # the JAX walk's default (a Window, an exchange, a Sample, a MapInBatch,
    # an extension's node); an Explode's rows as its child's (ROADMAP C32)
    return kids[0] if kids else (DEFAULT_MAX_GROUPS, {})


_SEMI_LIKE = (P.JoinType.LEFT_SEMI, P.JoinType.LEFT_ANTI, P.JoinType.LEFT_ANTI_NULL_AWARE,
              P.JoinType.EXISTENCE)


def _set_build_range(plan: P.HashJoin, stats: Dict[str, TableStats]) -> None:
    """The exact (min, max) of a single build key, from its source column's
    statistics: it lets the join test membership in a bitmap over the key's
    span instead of sorting the build side."""
    if len(plan.right_keys) != 1 or plan.build_key_range is not None:
        return
    left = plan.build_side == "left"
    bkey = _source_column((plan.left_keys if left else plan.right_keys)[0])
    if bkey:
        r = _column_range(plan.left if left else plan.right, bkey, stats)
        if r is not None:
            plan.build_key_range = r


def _set_inner_hints(plan: P.HashJoin, stats: Dict[str, TableStats], left, right) -> None:
    """An INNER or outer join's ``unique_build_hint``, ``key_pack`` and
    ``fanout_hint`` from each side's (row estimate, distinct estimates,
    key source columns)."""
    (lr, ln, lk), (rr, rn, rk) = left, right
    build_left = plan.build_side == "left"
    # a primary-key-like build side: a wrong hint is caught by the join's
    # duplicate-key flag, and the retry runs the general path
    if len(plan.right_keys) == 1 and not build_left and rk[0] in rn:
        if rn[rk[0]] >= int(0.8 * rr):
            plan.unique_build_hint = True
    elif len(plan.left_keys) == 1 and build_left and lk and lk[0] in ln:
        if ln[lk[0]] >= int(0.8 * lr):
            plan.unique_build_hint = True
    # a key tuple of integer columns with known ranges packs injectively
    # into one int64: the ranges are merged over both sides, so both pack
    # alike; a value outside them at run time raises the overflow flag
    if len(plan.left_keys) > 1 and plan.key_pack is None and lk and rk and all(lk) and all(rk):
        spans = []
        prod = 1
        for a, b in zip(lk, rk):
            ra = _column_range(plan.left, a, stats)
            rb = _column_range(plan.right, b, stats)
            if ra is None or rb is None:
                spans = None
                break
            lo, hi = min(ra[0], rb[0]), max(ra[1], rb[1])
            spans.append((lo, hi))
            prod *= hi - lo + 1
            if prod >= 1 << 62:
                spans = None
                break
        if spans:
            plan.key_pack = tuple(spans)
    # expected matches per probe row: build rows over the build keys'
    # distinct product, with a 2x margin
    if plan.fanout_hint is None:
        b_rows, b_ndv, b_keys = (lr, ln, lk) if build_left else (rr, rn, rk)
        if b_keys and all(k in b_ndv for k in b_keys if k) and all(b_keys):
            ndv_prod = 1
            for k in b_keys:
                ndv_prod = min(ndv_prod * max(b_ndv[k], 1), max(b_rows, 1))
            matches = max(b_rows / max(ndv_prod, 1), 1.0)
            plan.fanout_hint = int(min(max(2, 1 << math.ceil(math.log2(2.0 * matches))), 256))


def _condition_columns(e: E.Expr) -> set:
    """The source column of every node of a condition (JAX ``refs``)."""
    out = set()
    name = _source_column(e)
    if name:
        out.add(name)
    for c in e.children():
        out |= _condition_columns(c)
    return out


def _source_column(e: E.Expr) -> Optional[str]:
    """The column name under aliases and casts, or None for a computed expr."""
    while isinstance(e, (E.Alias, E.Cast)):
        e = e.child
    if isinstance(e, (E.BoundRef, E.ColumnRef)):
        return e.col_name
    return None


def _pad(groups: int) -> int:
    """Twice the estimate, the next power of two, at least 1024."""
    target = max(groups * 2, 1024)
    return 1 << max(int(math.ceil(math.log2(target))), 0)

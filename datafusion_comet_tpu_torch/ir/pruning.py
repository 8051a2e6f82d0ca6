"""Column pruning (port of ``datafusion_comet_tpu/ir/pruning.py`` for the
nodes of ir/plan.py, joins included): walk the UNBOUND plan top-down with the set of columns
each node must produce and narrow every Scan to the columns it must read.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Set

from datafusion_comet_tpu_torch.ir import expr as E
from datafusion_comet_tpu_torch.ir import plan as P

__all__ = ["prune_columns"]

ALL = None  # sentinel: every column required


def _expr_refs(e: Optional[E.Expr], out: Set[str]) -> None:
    if e is None:
        return
    if isinstance(e, (E.ColumnRef, E.BoundRef)):
        out.add(e.col_name)
    for c in e.children():  # Like's and TemporalFunc's arguments included
        _expr_refs(c, out)


def prune_columns(plan: P.PlanNode, required: Optional[Set[str]] = ALL) -> P.PlanNode:
    """Return a plan with Scan projections narrowed to the required columns.
    ``required=None`` means all output columns are needed (the root)."""
    if isinstance(plan, P.Scan):
        if required is ALL:
            return plan
        avail = [f.name for f in plan.source_schema.fields]
        keep = tuple(n for n in (plan.projection or avail) if n in required)
        if not keep:  # degenerate (e.g. COUNT(*)): keep one narrow column
            keep = (avail[0],)
        if keep == tuple(plan.projection or avail):
            return plan
        return P.Scan(plan.table, plan.source_schema, keep)
    if isinstance(plan, P.Projection):
        need: Set[str] = set()
        for x in plan.exprs:
            _expr_refs(x, need)
        return P.Projection(prune_columns(plan.child, need), plan.exprs)
    if isinstance(plan, P.Filter):
        need = set() if required is ALL else set(required)
        _expr_refs(plan.predicate, need)
        return P.Filter(prune_columns(plan.child, ALL if required is ALL else need),
                        plan.predicate, plan.out_rows_hint)
    if isinstance(plan, P.HashAggregate):
        if plan.mode in (P.AggMode.FINAL, P.AggMode.PARTIAL_MERGE):
            # a merge reads state columns by name: nothing to prune below it
            return P.HashAggregate(prune_columns(plan.child, ALL), plan.group_exprs,
                                   plan.agg_exprs, plan.mode, plan.max_groups,
                                   plan.group_key_ranges)
        need = set()
        for g in plan.group_exprs:
            _expr_refs(g, need)
        for a in plan.agg_exprs:
            for x in (a.child, a.filter) + a.extra:  # a covariance's second input too
                _expr_refs(x, need)
        return P.HashAggregate(prune_columns(plan.child, need), plan.group_exprs,
                               plan.agg_exprs, plan.mode, plan.max_groups,
                               plan.group_key_ranges)
    if isinstance(plan, P.Sort):
        need = None if required is ALL else set(required)
        if need is not None:
            for o in plan.orders:
                _expr_refs(o.child, need)
        return P.Sort(prune_columns(plan.child, need), plan.orders, plan.fetch, plan.skip)
    if isinstance(plan, P.Limit):
        return P.Limit(prune_columns(plan.child, required), plan.limit, plan.offset)
    if isinstance(plan, P.EQUI_JOINS):  # JAX ``pruning.py:108-136``
        lneed: Optional[Set[str]] = None if required is ALL else set()
        rneed: Optional[Set[str]] = None if required is ALL else set()
        if required is not ALL:
            lnames, rnames = _subtree_columns(plan.left), _subtree_columns(plan.right)
            lneed |= required & lnames
            rneed |= required & rnames
            for k in plan.left_keys:
                _expr_refs(k, lneed)
            for k in plan.right_keys:
                _expr_refs(k, rneed)
            if plan.condition is not None:
                cond: Set[str] = set()
                _expr_refs(plan.condition, cond)
                lneed |= cond & lnames
                rneed |= cond & rnames
        # every hint field carries over
        return dataclasses.replace(plan, left=prune_columns(plan.left, lneed),
                                   right=prune_columns(plan.right, rneed))
    if isinstance(plan, P.ShuffleExchange):  # JAX ``pruning.py:157-166``
        need = None if required is ALL else set(required)
        if need is not None:
            for k in plan.keys:
                _expr_refs(k, need)
            for o in plan.sort_orders:
                _expr_refs(o.child, need)
        return P.ShuffleExchange(prune_columns(plan.child, need), plan.partitioning,
                                 plan.keys, plan.num_partitions, plan.sort_orders)
    if isinstance(plan, P.Window):  # JAX ``pruning.py:138-148``
        need = None if required is ALL else set(required)
        if need is not None:
            for w in plan.window_exprs:
                _expr_refs(w.child, need)
                _expr_refs(w.default, need)
                for pb in w.partition_by:
                    _expr_refs(pb, need)
                for o in w.order_by:
                    _expr_refs(o.child, need)
                need.discard(w.out_name)
        return P.Window(prune_columns(plan.child, need), plan.window_exprs)
    if isinstance(plan, P.Explode):  # JAX ``pruning.py:150``; the port also sets ``keep``
        if required is ALL:
            return P.Explode(prune_columns(plan.child, ALL), plan.expr, plan.outer, plan.pos,
                             plan.keep)
        keep = set(required) - {"pos", "col", "key", "value"}
        need = set(keep)
        _expr_refs(plan.expr, need)
        kept = tuple(n for n in sorted(_subtree_columns(plan.child)) if n in keep)
        return P.Explode(prune_columns(plan.child, need), plan.expr, plan.outer, plan.pos, kept)
    # as the JAX package's default branch, the children keep every column:
    # both sides of a nested-loop join, a Union's inputs (pruning through it
    # would map columns by position) and an Expand's child
    if isinstance(plan, P.BroadcastNestedLoopJoin):
        return P.BroadcastNestedLoopJoin(prune_columns(plan.left, ALL),
                                         prune_columns(plan.right, ALL), plan.join_type,
                                         plan.condition)
    if isinstance(plan, P.Union):
        return P.Union(tuple(prune_columns(c, ALL) for c in plan.inputs))
    if isinstance(plan, P.Expand):
        return P.Expand(prune_columns(plan.child, ALL), plan.projections, plan.names)
    if isinstance(plan, (P.Sample, P.MapInBatch)):  # the function reads every column
        return dataclasses.replace(plan, child=prune_columns(plan.child, ALL))
    if isinstance(plan, (P.CollectLimit, P.TakeOrderedAndProject)):
        return dataclasses.replace(plan, child=prune_columns(plan.child, ALL))
    raise NotImplementedError(f"prune_columns: {type(plan).__name__}")


def _subtree_columns(plan: P.PlanNode) -> Set[str]:
    """Every column name a subtree can output (before binding)."""
    if isinstance(plan, P.Scan):
        return set(plan.projection or [f.name for f in plan.source_schema.fields])
    if isinstance(plan, P.Projection):
        return {x.name for x in plan.exprs}
    if isinstance(plan, P.HashAggregate):
        # partial modes emit state columns prefixed by the output name
        return ({g.name for g in plan.group_exprs} | {a.out_name for a in plan.agg_exprs}
                | {f"{a.out_name}__{s}" for a in plan.agg_exprs
                   for s in ("sum", "count", "val", "n", "avg", "m2", "xavg", "yavg", "ck",
                             "xm2", "ym2", "sketch")})
    if isinstance(plan, P.Window):  # JAX ``pruning.py:196``
        return _subtree_columns(plan.child) | {w.out_name for w in plan.window_exprs}
    if isinstance(plan, P.Explode):  # JAX ``pruning.py:198``
        return _subtree_columns(plan.child) | {"pos", "col", "key", "value"}
    if isinstance(plan, P.MapInBatch):
        return {f.name for f in plan.out_fields}
    out: Set[str] = set()
    for c in plan.children():
        out |= _subtree_columns(c)
    return out

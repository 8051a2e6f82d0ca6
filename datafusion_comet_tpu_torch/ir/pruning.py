"""Column pruning (port of ``datafusion_comet_tpu/ir/pruning.py`` for the
nodes of ir/plan.py): walk the UNBOUND plan top-down with the set of columns
each node must produce and narrow every Scan to the columns it must read.
"""

from __future__ import annotations

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
    for c in e.children():
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
                        plan.predicate)
    if isinstance(plan, P.HashAggregate):
        need = set()
        for g in plan.group_exprs:
            _expr_refs(g, need)
        for a in plan.agg_exprs:
            _expr_refs(a.child, need)
        return P.HashAggregate(prune_columns(plan.child, need), plan.group_exprs,
                               plan.agg_exprs, plan.mode)
    if isinstance(plan, P.Sort):
        need = None if required is ALL else set(required)
        if need is not None:
            for o in plan.orders:
                _expr_refs(o.child, need)
        return P.Sort(prune_columns(plan.child, need), plan.orders)
    raise NotImplementedError(f"prune_columns: {type(plan).__name__}")

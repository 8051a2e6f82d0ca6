"""Sort-order propagation over bound plans (port of
``datafusion_comet_tpu/ir/ordering.py``).

Knowing the order of a node's live rows lets the planner delete a Sort whose
child already delivers it (``engine._apply_orderings``):

- ``out_ordering(plan)`` is the (field name, ascending, nulls_first) prefix
  ordering of the node's live rows, () when unknown;
- a SINGLE or FINAL HashAggregate is ordered by its group keys, ascending,
  the null group last: the sorted path leaves groups in grouping-limb
  order, and the dense path's bucket id packs the keys' codes, the first
  key in the most significant bits (a null key takes code 0 there, but a
  Sort asking for nulls last over a nullable key is elided in both
  packages alike);
- Filter and Limit keep their child's order; a Projection keeps it through
  passthrough and alias columns; a Sort establishes its own; a
  ShuffleExchange delivers none (the JAX module has no branch for it), so
  the Sort above an exchange in Spark's sort-merge-join shape stays.
"""

from __future__ import annotations

from typing import Optional, Tuple

from datafusion_comet_tpu_torch.ir import expr as E
from datafusion_comet_tpu_torch.ir import plan as P

__all__ = ["out_ordering", "order_key_name", "ordering_satisfies"]

# (field name, ascending, nulls_first); nulls_first None: the field cannot
# be null, so any null placement is satisfied
OrderKey = Tuple[str, bool, Optional[bool]]


def order_key_name(e: E.Expr, schema) -> Optional[str]:
    """A bound order or key expression's input field name (None for a
    computed expression)."""
    if isinstance(e, E.Alias):
        return order_key_name(e.child, schema)
    if isinstance(e, E.BoundRef):
        return schema.fields[e.index].name
    if isinstance(e, E.ColumnRef):
        return e.name
    return None


def _field_nullable(schema, name: str) -> bool:
    for f in schema.fields:
        if f.name == name:
            return f.nullable
    return True


def out_ordering(plan: P.PlanNode) -> Tuple[OrderKey, ...]:
    if isinstance(plan, P.Sort):
        child_schema = plan.child.schema
        out = []
        for o in plan.orders:
            name = order_key_name(o.child, child_schema)
            if name is None:
                break
            nf: Optional[bool] = o.resolved_nulls_first()
            if not _field_nullable(child_schema, name):
                nf = None
            out.append((name, o.ascending, nf))
        return tuple(out)
    if isinstance(plan, (P.Filter, P.Limit)):
        return out_ordering(plan.child)
    if isinstance(plan, P.Projection):
        child = out_ordering(plan.child)
        if not child:
            return ()
        rename = {}  # input field -> output name, through passthrough and aliases
        for e in plan.exprs:
            src = order_key_name(e, plan.child.schema)
            if src is not None:
                rename.setdefault(src, e.name)
        out = []
        for name, asc, nf in child:
            if name not in rename:
                break
            out.append((rename[name], asc, nf))
        return tuple(out)
    if isinstance(plan, P.HashAggregate) and plan.mode in (P.AggMode.SINGLE, P.AggMode.FINAL):
        out = []
        for g in plan.group_exprs:
            nf: Optional[bool] = False
            if plan.schema is not None and not _field_nullable(plan.schema, g.name):
                nf = None
            out.append((g.name, True, nf))
        return tuple(out)
    return ()


def ordering_satisfies(have: Tuple[OrderKey, ...], want_keys) -> bool:
    """Whether rows ordered by ``have`` are ordered by ``want_keys`` too (a
    prefix match; each wanted key is (name, ascending, nulls_first))."""
    if len(want_keys) > len(have):
        return False
    for (hn, ha, hnf), (wn, wa, wnf) in zip(have, want_keys):
        if hn != wn or ha != wa:
            return False
        if hnf is not None and wnf is not None and hnf != wnf:
            return False
    return True

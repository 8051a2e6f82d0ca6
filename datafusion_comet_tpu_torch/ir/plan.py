"""Operator plan IR (port of ``datafusion_comet_tpu/ir/plan.py``: the Scan,
Filter, Projection, HashAggregate, Sort, Limit, Expand, HashJoin,
SortMergeJoin, BroadcastNestedLoopJoin, Union, Window, ShuffleExchange,
Sample, Explode and MapInBatch nodes, and the two sinks CollectLimit and
TakeOrderedAndProject).

Plans are built unbound; ``bind_plan`` binds expressions bottom-up against
child schemas and computes each node's output schema, and rewrites a
COUNT(DISTINCT) aggregate into two plain ones (``_rewrite_distinct``). An
outer join's output keeps each input field's nullability, as the JAX
package's does: the join itself nulls the side it did not match. As in the
JAX package, a CollectLimit binds to a Limit and a TakeOrderedAndProject to
a Sort with its fetch and skip under a Projection; a SortMergeJoin stays
itself (the engine runs it as a hash join whose build side its join type
fixes, ``SortMergeJoin.build_side``), and a ShuffleExchange is the identity
on one device.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

from datafusion_comet_tpu_torch import types as T
from datafusion_comet_tpu_torch.ir import expr as E

__all__ = ["PlanNode", "Scan", "Filter", "Projection", "HashAggregate", "AggMode",
           "Sort", "Limit", "CollectLimit", "TakeOrderedAndProject", "Expand", "HashJoin",
           "SortMergeJoin", "EQUI_JOINS", "BroadcastNestedLoopJoin", "Union", "Window",
           "ShuffleExchange", "Sample", "Explode", "MapInBatch", "JoinType", "bind_plan",
           "scan_tables"]


class JoinType:
    """Join types of the IR. The hash join runs every type; the nested-loop
    join every type but the null-aware anti (NOT IN) and EXISTENCE."""

    INNER = "inner"
    LEFT = "left"
    RIGHT = "right"
    FULL = "full"
    LEFT_SEMI = "left_semi"
    LEFT_ANTI = "left_anti"
    LEFT_ANTI_NULL_AWARE = "left_anti_null_aware"
    EXISTENCE = "existence"


class AggMode:
    PARTIAL = "partial"
    FINAL = "final"
    PARTIAL_MERGE = "partial_merge"
    SINGLE = "single"  # partial+final in one step (no exchange)


@dataclasses.dataclass
class PlanNode:
    """Base plan node; ``schema`` is filled in by bind_plan."""

    schema: Optional[T.Schema] = dataclasses.field(default=None, init=False)

    def children(self) -> Tuple["PlanNode", ...]:
        return ()

    def filter(self, predicate: E.Expr) -> "Filter":
        return Filter(self, predicate)

    def project(self, exprs: Sequence[E.Expr]) -> "Projection":
        return Projection(self, tuple(exprs))

    def aggregate(self, group_by, aggs, mode: str = AggMode.SINGLE) -> "HashAggregate":
        return HashAggregate(self, tuple(group_by), tuple(aggs), mode)

    def sort(self, orders, fetch: Optional[int] = None) -> "Sort":
        return Sort(self, tuple(orders), fetch)

    def limit(self, n: int, offset: int = 0) -> "Limit":
        return Limit(self, n, offset)


@dataclasses.dataclass
class Scan(PlanNode):
    """Leaf: reads a registered table, optionally a column subset."""

    table: str
    source_schema: T.Schema
    projection: Optional[Tuple[str, ...]] = None

    def out_schema(self) -> T.Schema:
        if self.projection is None:
            return self.source_schema
        return T.Schema([self.source_schema.field(n) for n in self.projection])


@dataclasses.dataclass
class Filter(PlanNode):
    """``out_rows_hint``: the estimated rows that pass (exec/stats.py); a
    filter that keeps under an eighth of its input's capacity is compacted
    to a margin over it."""

    child: PlanNode
    predicate: E.Expr
    out_rows_hint: Optional[int] = None

    def children(self):
        return (self.child,)


@dataclasses.dataclass
class Projection(PlanNode):
    child: PlanNode
    exprs: Tuple[E.Expr, ...]

    def children(self):
        return (self.child,)


@dataclasses.dataclass
class HashAggregate(PlanNode):
    """Group-by aggregation. Output schema: group columns, then aggregate
    columns (SINGLE/FINAL) or their state columns (partial modes).

    ``max_groups``: the output's group capacity (None: derived from table
    statistics, exec/stats.py; a run with more groups re-runs with it four
    times larger). ``group_key_ranges``: per group key, the exact (min, max)
    of its source column where statistics know it, so the keys pack into
    few sort limbs. ``merge_rows``: where the executor knows it, a bound on
    the input rows behind one group's merged states (a FINAL's AVG divides
    by merged counts, on a short path below 2^31); None: unknown."""

    child: PlanNode
    group_exprs: Tuple[E.Expr, ...]
    agg_exprs: Tuple[E.AggExpr, ...]
    mode: str = AggMode.SINGLE
    max_groups: Optional[int] = None
    group_key_ranges: Optional[Tuple[Optional[Tuple[int, int]], ...]] = None
    merge_rows: Optional[int] = None

    def children(self):
        return (self.child,)


@dataclasses.dataclass
class Sort(PlanNode):
    """Total sort, dead rows last; ``fetch`` keeps the first rows of the
    order (top-K) after ``skip`` of them."""

    child: PlanNode
    orders: Tuple[E.SortOrder, ...]
    fetch: Optional[int] = None
    skip: int = 0

    def children(self):
        return (self.child,)


@dataclasses.dataclass
class Limit(PlanNode):
    """The live rows [offset, offset + limit), in order."""

    child: PlanNode
    limit: int
    offset: int = 0

    def children(self):
        return (self.child,)


@dataclasses.dataclass
class CollectLimit(PlanNode):
    """The sink of a Spark ``LIMIT`` query (CometCollectLimitExec): the
    first ``limit`` live rows after ``offset``; binds to a Limit."""

    child: PlanNode
    limit: int
    offset: int = 0

    def children(self):
        return (self.child,)


@dataclasses.dataclass
class TakeOrderedAndProject(PlanNode):
    """The sink of a Spark ``ORDER BY ... LIMIT`` query
    (CometTakeOrderedAndProjectExec): sort by ``orders``, keep ``limit``
    rows after ``offset``, project ``exprs`` (none: every column); binds to
    a Sort with that fetch and skip under a Projection."""

    child: PlanNode
    orders: Tuple[E.SortOrder, ...]
    limit: int
    exprs: Tuple[E.Expr, ...] = ()
    offset: int = 0

    def children(self):
        return (self.child,)


@dataclasses.dataclass
class Expand(PlanNode):
    """Each input row gives one output row per projection (ROLLUP, CUBE and
    grouping sets); ``names`` names the output columns."""

    child: PlanNode
    projections: Tuple[Tuple[E.Expr, ...], ...]
    names: Tuple[str, ...]

    def children(self):
        return (self.child,)


@dataclasses.dataclass
class HashJoin(PlanNode):
    """Equi-join; ``build_side`` names the input that is sorted and searched,
    the other is probed. Output schema: left fields then right fields (the
    left fields alone for semi and anti joins, plus ``exists`` for
    EXISTENCE).

    Planner attributes, filled from statistics (exec/stats.py) where None:
    ``build_key_range``, the exact (min, max) of a single build key, which
    lets a semi-like join test membership in a bitmap and a unique INNER
    build a position table over that span; ``out_rows_hint``, the estimated
    output rows, which sizes the compaction of a semi or anti join's output
    and an INNER join's compacted pair list; ``fanout_hint``, an INNER
    join's first K (build matches per probe row); ``unique_build_hint``,
    that the build keys look unique (one match per probe row at most);
    ``key_pack``, per key of a multi-key join the (min, max) over both
    sides, which packs the key tuple into one int64; ``cond_col_ranges``,
    on a semi-like join with a condition, the exact (min, max) of each
    column the condition names, which lets the min/max pushdown keep its
    per-key table in a biased int32.

    Set by the runtime-filter injector (exec/runtime_filter.py) on the
    LEFT_SEMI join it adds: ``rf_dense_range``, the exact (min, max) of its
    constant key table, which the membership bitmap covers, and
    ``rf_injected``, which keeps the join out of the stage split's counts."""

    left: PlanNode
    right: PlanNode
    left_keys: Tuple[E.Expr, ...]
    right_keys: Tuple[E.Expr, ...]
    join_type: str = JoinType.INNER
    build_side: str = "right"  # left|right
    condition: Optional[E.Expr] = None  # extra non-equi filter over the pair
    build_key_range: Optional[Tuple[int, int]] = None
    out_rows_hint: Optional[int] = None
    fanout_hint: Optional[int] = None
    unique_build_hint: Optional[bool] = None
    key_pack: Optional[Tuple[Tuple[int, int], ...]] = None
    rf_dense_range: Optional[Tuple[int, int]] = None
    rf_injected: bool = False
    cond_col_ranges: Optional[Dict[str, Tuple[int, int]]] = None

    def children(self):
        return (self.left, self.right)


def smj_build_side(join_type: str) -> str:
    """The build side of a SortMergeJoin run as a hash join (JAX
    ``engine.py:275``): an outer join probes its preserved side, so RIGHT
    builds the left input; every other type builds the right one."""
    return "left" if join_type == JoinType.RIGHT else "right"


@dataclasses.dataclass
class SortMergeJoin(PlanNode):
    """The equi-join Spark plans where both sides exceed the broadcast
    threshold, over sorted, hash-exchanged inputs. JAX's fields, then the
    planner hints a HashJoin carries (exec/stats.py fills them alike) and
    ``presorted_build``: the build child delivers its rows ordered
    ascending on the keys with nulls last (``engine.apply_orderings``), so
    the join may search them without sorting them (the merge path,
    exec/operators/join.py). The JAX package's grace join takes a HashJoin
    only, and so does the port's."""

    left: PlanNode
    right: PlanNode
    left_keys: Tuple[E.Expr, ...]
    right_keys: Tuple[E.Expr, ...]
    join_type: str = JoinType.INNER
    condition: Optional[E.Expr] = None
    build_key_range: Optional[Tuple[int, int]] = None
    out_rows_hint: Optional[int] = None
    fanout_hint: Optional[int] = None
    unique_build_hint: Optional[bool] = None
    key_pack: Optional[Tuple[Tuple[int, int], ...]] = None
    rf_dense_range: Optional[Tuple[int, int]] = None
    rf_injected: bool = False
    cond_col_ranges: Optional[Dict[str, Tuple[int, int]]] = None
    presorted_build: bool = False

    @property
    def build_side(self) -> str:
        return smj_build_side(self.join_type)

    def children(self):
        return (self.left, self.right)


# the equi-joins: the stats walk, the runtime filters, pruning and the
# memory estimate treat both alike
EQUI_JOINS = (HashJoin, SortMergeJoin)


@dataclasses.dataclass
class BroadcastNestedLoopJoin(PlanNode):
    """Every left row paired with every right row, kept where ``condition``
    holds (all pairs without one); for joins with no equi-key, one side
    small (exec/operators/join.py::nested_loop_join). Output schema as for
    HashJoin."""

    left: PlanNode
    right: PlanNode
    join_type: str = JoinType.INNER
    condition: Optional[E.Expr] = None

    def children(self):
        return (self.left, self.right)


@dataclasses.dataclass
class Union(PlanNode):
    """UNION ALL: the inputs' rows, one input after another; the schema is
    the first input's."""

    inputs: Tuple[PlanNode, ...] = ()

    def children(self):
        return self.inputs


@dataclasses.dataclass
class Window(PlanNode):
    """Window functions over the child's rows (exec/operators/window.py):
    the output is the child's columns, then one per window expression."""

    child: PlanNode
    window_exprs: Tuple[E.WindowExpr, ...]

    def children(self):
        return (self.child,)


@dataclasses.dataclass
class ShuffleExchange(PlanNode):
    """Repartition by ``partitioning`` (hash, range, round_robin or
    single) on ``keys`` or ``sort_orders``: on one device the identity, and
    it delivers no ordering (ir/ordering.py)."""

    child: PlanNode
    partitioning: str
    keys: Tuple[E.Expr, ...] = ()
    num_partitions: int = 0
    sort_orders: Tuple[E.SortOrder, ...] = ()

    def children(self):
        return (self.child,)


@dataclasses.dataclass
class Sample(PlanNode):
    """Spark's Sample: the rows whose draw falls in [lower_bound,
    upper_bound) (without replacement), or Poisson copies of each
    (exec/operators/basic.py ``sample_op``)."""

    child: PlanNode
    lower_bound: float
    upper_bound: float
    with_replacement: bool
    seed: int

    def children(self):
        return (self.child,)


@dataclasses.dataclass
class Explode(PlanNode):
    """One output row per element of a LIST or MAP (explode, posexplode and
    their ``_outer`` forms; exec/operators/basic.py ``explode_op``): the
    child's columns, then ``pos`` (posexplode), then ``col`` (a list) or
    ``key`` and ``value`` (a map). ``outer`` keeps one row with a null
    element for a null or empty input. ``keep``: where set (by pruning),
    the child's columns the output carries, the others left out, as XLA
    drops the JAX package's unused ones (each is repeated E times)."""

    child: PlanNode
    expr: E.Expr
    outer: bool = False
    pos: bool = False
    keep: Optional[Tuple[str, ...]] = None

    def children(self):
        return (self.child,)


@dataclasses.dataclass
class MapInBatch(PlanNode):
    """A host Python function over the whole materialized child (Spark's
    MapInPandas/MapInArrow, the reference's CometMapInBatchExec): ``fn``
    takes a pandas DataFrame of the child's live rows and returns one with
    the ``out_fields`` columns. The session runs the child, the function on
    the host and stages the result as a table (exec/engine.py)."""

    child: PlanNode
    fn: object
    out_fields: Tuple[T.Field, ...]

    def children(self):
        return (self.child,)


def _join_out_schema(ls: T.Schema, rs: T.Schema, join_type: str) -> T.Schema:
    if join_type in (JoinType.LEFT_SEMI, JoinType.LEFT_ANTI, JoinType.LEFT_ANTI_NULL_AWARE):
        return ls
    if join_type == JoinType.EXISTENCE:
        return T.Schema(list(ls.fields) + [T.Field("exists", T.BOOL)])
    return T.Schema(list(ls.fields) + list(rs.fields))


def _expr_nullable(e: E.Expr, schema: T.Schema) -> bool:
    """Conservative bind-time nullability: False only when provably non-null."""
    if isinstance(e, E.Alias):
        return _expr_nullable(e.child, schema)
    if isinstance(e, E.BoundRef):
        return schema.fields[e.index].nullable
    if isinstance(e, E.Literal):
        return e.value is None
    return True


def bind_plan(plan: PlanNode) -> PlanNode:
    """Bottom-up: bind expressions against child schemas, compute output
    schemas. Returns new nodes; Scan nodes get their schema slot filled."""
    if isinstance(plan, Scan):
        plan.schema = plan.out_schema()
        return plan
    kids = [bind_plan(c) for c in plan.children()]
    if isinstance(plan, Filter):
        out = Filter(kids[0], E.bind(plan.predicate, kids[0].schema), plan.out_rows_hint)
        out.schema = kids[0].schema
        return out
    if isinstance(plan, Projection):
        child = kids[0]
        exprs = tuple(E.bind(x, child.schema) for x in plan.exprs)
        out = Projection(child, exprs)
        out.schema = T.Schema(
            [T.Field(x.name, x.dtype, _expr_nullable(x, child.schema)) for x in exprs])
        return out
    if isinstance(plan, HashAggregate):
        child = kids[0]
        if plan.mode == AggMode.SINGLE and any(
                a.func == E.AggFunc.COUNT_DISTINCT for a in plan.agg_exprs):
            return _rewrite_distinct(plan)
        groups = tuple(E.bind(g, child.schema) for g in plan.group_exprs)
        if plan.mode in (AggMode.FINAL, AggMode.PARTIAL_MERGE):
            # the merge reads state columns by name; the aggregates stay bound
            # against the partial stage's input, which types their results
            aggs = plan.agg_exprs
        else:
            aggs = tuple(
                dataclasses.replace(
                    a, child=E.bind(a.child, child.schema) if a.child is not None else None,
                    extra=tuple(E.bind(x, child.schema) for x in a.extra),
                    filter=E.bind(a.filter, child.schema) if a.filter is not None else None)
                for a in plan.agg_exprs)
        out = HashAggregate(child, groups, aggs, plan.mode, plan.max_groups,
                            plan.group_key_ranges)
        fields = [T.Field(g.name, g.dtype, _expr_nullable(g, child.schema)) for g in groups]
        if plan.mode in (AggMode.SINGLE, AggMode.FINAL):
            fields += [T.Field(a.out_name, a.result_dtype()) for a in aggs]
        else:
            from datafusion_comet_tpu_torch.exec.operators import aggregate as AGG

            for a in aggs:
                fields += AGG.state_fields(a)
        out.schema = T.Schema(fields)
        return out
    if isinstance(plan, Sort):
        child = kids[0]
        orders = tuple(dataclasses.replace(o, child=E.bind(o.child, child.schema))
                       for o in plan.orders)
        out = Sort(child, orders, plan.fetch, plan.skip)
        out.schema = child.schema
        return out
    if isinstance(plan, (Limit, CollectLimit)):
        out = Limit(kids[0], plan.limit, plan.offset)
        out.schema = kids[0].schema
        return out
    if isinstance(plan, TakeOrderedAndProject):
        srt = bind_plan(Sort(kids[0], plan.orders, plan.limit, plan.offset))
        return bind_plan(Projection(srt, plan.exprs)) if plan.exprs else srt
    if isinstance(plan, ShuffleExchange):
        child = kids[0]
        out = ShuffleExchange(child, plan.partitioning,
                              tuple(E.bind(k, child.schema) for k in plan.keys),
                              plan.num_partitions,
                              tuple(dataclasses.replace(o, child=E.bind(o.child, child.schema))
                                    for o in plan.sort_orders))
        out.schema = child.schema
        return out
    if isinstance(plan, Expand):
        # the first projection types the output, as in the JAX package
        child = kids[0]
        projections = tuple(tuple(E.bind(x, child.schema) for x in proj)
                            for proj in plan.projections)
        out = Expand(child, projections, plan.names)
        out.schema = T.Schema([T.Field(n, x.dtype) for n, x in zip(plan.names, projections[0])])
        return out
    if isinstance(plan, Union):
        out = Union(tuple(kids))
        out.schema = kids[0].schema
        return out
    if isinstance(plan, Sample):
        out = Sample(kids[0], plan.lower_bound, plan.upper_bound, plan.with_replacement,
                     plan.seed)
        out.schema = kids[0].schema
        return out
    if isinstance(plan, EQUI_JOINS):
        left, right = kids
        pair = T.Schema(list(left.schema.fields) + list(right.schema.fields))
        out = dataclasses.replace(
            plan, left=left, right=right,
            left_keys=tuple(E.bind(k, left.schema) for k in plan.left_keys),
            right_keys=tuple(E.bind(k, right.schema) for k in plan.right_keys),
            condition=E.bind(plan.condition, pair) if plan.condition is not None else None)
        out.schema = _join_out_schema(left.schema, right.schema, plan.join_type)
        return out
    if isinstance(plan, BroadcastNestedLoopJoin):
        left, right = kids
        pair = T.Schema(list(left.schema.fields) + list(right.schema.fields))
        cond = E.bind(plan.condition, pair) if plan.condition is not None else None
        out = BroadcastNestedLoopJoin(left, right, plan.join_type, cond)
        out.schema = _join_out_schema(left.schema, right.schema, plan.join_type)
        return out
    if isinstance(plan, Window):
        child = kids[0]

        def b(x):
            return E.bind(x, child.schema) if x is not None else None

        wexprs = tuple(dataclasses.replace(
            w, child=b(w.child), default=b(w.default),
            partition_by=tuple(b(p) for p in w.partition_by),
            order_by=tuple(dataclasses.replace(o, child=b(o.child)) for o in w.order_by))
            for w in plan.window_exprs)
        from datafusion_comet_tpu_torch.exec.operators import window as W

        out = Window(child, wexprs)
        out.schema = T.Schema(list(child.schema.fields)
                              + [T.Field(w.out_name, W.result_dtype(w)) for w in wexprs])
        return out
    if isinstance(plan, Explode):  # JAX ``ir/plan.py:519``
        child = kids[0]
        ex = E.bind(plan.expr, child.schema)
        out = Explode(child, ex, plan.outer, plan.pos, plan.keep)
        kept = [f for f in child.schema.fields if plan.keep is None or f.name in plan.keep]
        gen = [T.Field("pos", T.INT32)] if plan.pos else []
        if ex.dtype.is_map:
            gen += [T.Field("key", ex.dtype.key_type), T.Field("value", ex.dtype.value_type)]
        else:
            assert ex.dtype.is_list, f"explode over {ex.dtype!r}"
            gen.append(T.Field("col", ex.dtype.element))
        out.schema = T.Schema(kept + gen)
        return out
    if isinstance(plan, MapInBatch):  # JAX ``ir/plan.py:536``
        out = MapInBatch(kids[0], plan.fn, tuple(plan.out_fields))
        out.schema = T.Schema(list(plan.out_fields))
        return out
    if plan.schema is not None and hasattr(plan, "with_children"):
        # an extension's node (exec/registry.py OPERATORS) declares its own
        # schema and rebuilds itself over its bound children (JAX :557)
        out = plan.with_children(tuple(kids))
        out.schema = plan.schema
        return out
    raise NotImplementedError(f"bind_plan: {type(plan).__name__}")


def _rewrite_distinct(plan: HashAggregate) -> PlanNode:
    """COUNT(DISTINCT x) as two aggregates (JAX ``ir/plan.py:571``): a
    group-only aggregate over (groups, x) drops the duplicates, then COUNT(x)
    per group over it (a null x is a group of the first and is not counted
    by the second). Every aggregate must be a COUNT(DISTINCT) of one and the
    same input, as in the JAX package; mixed ones would need Spark's
    Expand-based rewrite."""
    distinct = [a for a in plan.agg_exprs if a.func == E.AggFunc.COUNT_DISTINCT]
    if len(distinct) != len(plan.agg_exprs):
        raise NotImplementedError("mixed DISTINCT and plain aggregates")
    first = distinct[0].child
    if any(repr(a.child) != repr(first) for a in distinct[1:]):
        raise NotImplementedError("multiple different DISTINCT columns")
    dname = "__distinct_key"
    inner = HashAggregate(plan.child, plan.group_exprs + (E.Alias(first, dname),), (),
                          AggMode.SINGLE, plan.max_groups)
    outer = HashAggregate(
        inner, tuple(E.col(g.name) for g in plan.group_exprs),
        tuple(E.AggExpr(E.AggFunc.COUNT, E.col(dname), a.out_name) for a in distinct),
        AggMode.SINGLE, plan.max_groups)
    return bind_plan(outer)


def scan_tables(plan: PlanNode) -> List[str]:
    """The tables a plan's Scans read, in tree order."""
    out = [plan.table] if isinstance(plan, Scan) else []
    for c in plan.children():
        out.extend(scan_tables(c))
    return out

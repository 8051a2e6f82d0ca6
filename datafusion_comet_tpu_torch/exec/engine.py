"""Query engine: a bound plan tree executed operator by operator over
device-resident tables (port of the ``Session`` subset of
``datafusion_comet_tpu/exec/engine.py`` that the ported TPC-H and TPC-DS
queries reach: a ``Union`` runs as one row concatenation of its inputs, an
``Expand`` as ``basic.expand_op``, a ``Window`` as ``window.window_op``, an
``Explode`` as ``basic.explode_op``, a ``MapInBatch`` as a host pandas step
staged as a table; ``Session.explain`` and ``Session.validate``).

``run_plan`` resolves each node's executor through the operator registry
(exec/registry.py); every stage's operator and expression gates
(``Config.gates``) are checked before it runs, and a gate that is off, or
an operator or expression the port refuses, raises UnsupportedPlanError
with the reasons ``validate`` reports.

PyTorch runs eagerly, so there is no whole-plan compile. ``execute`` prunes
the plan, injects the runtime filters (exec/runtime_filter.py), binds it,
fills each aggregate's group capacity from the tables' statistics
(exec/stats.py, collected by ``register_numpy``), splits the plan into
stages, and runs them in order. Data enters once per table and leaves
once at ``collect``; everything between stays on the session's device.

Stages (``_plan_stages``, as the JAX package splits them): a plan with more
joins than ``Config.stage_max_joins`` puts its join-heaviest children into
stages of their own (``_split_stages``), and a stage with more heavy
operators (joins, sorts, expands, windows, grouping aggregates) than
``Config.stage_max_heavy_ops`` is cut below a Window, Sort or grouping
aggregate (``_split_heavy``). Each named stage's result is compacted to its
live rows (``_aqe_shrink``) and read by the next stage as a temporary table: so Q3's
top-K sorts the aggregate's live groups, not its input's capacity. The JAX
package splits to bound compile time; here the split changes which
capacities the later operators run at. Before the split, a Sort over an
aggregate already ordered by its keys is dropped (``apply_orderings``, the
Sort branch of the JAX package's ``_apply_orderings``): Q1, Q4 and Q12 end
in their aggregate, which keeps its outputs' magnitude bounds as the JAX
package's does. A runtime filter's semi join does not count toward the
split (``_count_joins``, ``_count_heavy``), as in the JAX package. A
SortMergeJoin whose build child is sorted on its keys takes the merge path
(``_mark_presorted``, the merge half of the JAX package's
``_apply_orderings``).

The operators read the planner's hints (exec/stats.py) as the JAX package
does: a filter estimated to keep under an eighth of its capacity is
compacted to a margin over its estimate, and each join takes its K,
unique-build, key-packing and compacted-list capacity from its hints
(``_exec_hash_join``).

Two loops wrap a stage's run, as in the JAX package:
- the overflow retry: a join whose probe rows have more matches than its
  fan-out K, a unique build with a repeated key, a packed key out of its
  range, a compacted pair list or filter shrink too small, an aggregate
  with more groups than its capacity, or a compaction that overflows,
  flags the run, which then re-runs with K and the growth scale four times
  larger and without the unique-build and key-packing hints, at most
  ``join.MAX_JOIN_RETRIES`` times (then JoinOverflowError);
- the memory budget (``_budget_plan``): while a plan's resident-bytes
  estimate is over ``device_budget_bytes`` (the card's memory times
  ``Config.memory_fraction``), a SINGLE aggregate over one table runs tiled
  (exec/streaming.py, under the overflow retry too), else an over-budget
  join runs hash-partitioned (exec/grace.py), and its result, the aggregate
  above it, or the whole stage comes back as a temporary table.

Scalar subqueries (``Session.scalar_subquery``, JAX ``engine.py:535-580``):
a subquery's plan is bound when it is registered, without pruning (so no
runtime filter is injected into it), and structurally equal subqueries
(the same ``ir/serde.py`` JSON and column) share one id. Before a plan's
stages run, ``execute`` runs each subquery the plan holds, once, through
``execute`` itself (the same memory budget, so a subquery may take the
grace join), on a fresh copy of its bound plan, and keeps its one value
for the evaluator (``EvalContext.subquery_values``). The values live for
one top-level ``execute``, as Spark evaluates a scalar subquery once per
query execution; the JAX package keeps them for the session's life, so a
table registered again leaves a stale value there (ROADMAP C21).
"""

from __future__ import annotations

import copy
import dataclasses
import gc
import itertools
import time
import warnings
from typing import Callable, Dict, List, Optional, Tuple, Union

import numpy as np
import torch

from datafusion_comet_tpu_torch import types as T
from datafusion_comet_tpu_torch.conf import JSON_DEVICE_ENABLED, Config
from datafusion_comet_tpu_torch.exec import registry as REG
from datafusion_comet_tpu_torch.exec import grace as G
from datafusion_comet_tpu_torch.exec.batch import (Batch, concat_batches, from_numpy, pad_capacity,
                                                  to_numpy)
from datafusion_comet_tpu_torch.exec.evaluator import EvalContext
from datafusion_comet_tpu_torch.exec.host_filter import HostColumns
from datafusion_comet_tpu_torch.exec.memory import (device_budget_bytes, plan_peak_bytes,
                                                   plan_tiles)
from datafusion_comet_tpu_torch.exec.operators import aggregate as AGG
from datafusion_comet_tpu_torch.exec.operators import basic as B
from datafusion_comet_tpu_torch.exec.operators import join as J
from datafusion_comet_tpu_torch.exec.operators import window as W
from datafusion_comet_tpu_torch.exec.operators.agg_special import sketch_scope
from datafusion_comet_tpu_torch.exec.runtime_filter import inject_runtime_filters
from datafusion_comet_tpu_torch.exec.stats import (DEFAULT_MAX_GROUPS, TableStats, collect_stats,
                                                  derive_capacities)
from datafusion_comet_tpu_torch.exec.streaming import TiledAggregator, pseudo_scan, slice_tiles
from datafusion_comet_tpu_torch.ir import expr as E
from datafusion_comet_tpu_torch.ir import plan as P
from datafusion_comet_tpu_torch.ir.ordering import order_key_name, ordering_satisfies, out_ordering
from datafusion_comet_tpu_torch.ir.pruning import prune_columns
from datafusion_comet_tpu_torch.ir.serde import plan_to_json
from datafusion_comet_tpu_torch.observability.trace import tracer, with_trace

__all__ = ["Session", "run_plan", "QueryExecutionError", "JoinOverflowError",
           "UnsupportedPlanError"]

UnsupportedPlanError = REG.UnsupportedPlanError


# the times a stage attempt that ran out of the card's memory is planned
# again under a smaller budget before the error stands
_OOM_REPLANS = 3

# a semi or anti join's output is compacted to this many times its row
# estimate (the JAX package's margin for estimates from statistics; 2 for a
# runtime filter's)
_SEMI_MARGIN = 4


class QueryExecutionError(RuntimeError):
    """An ANSI-mode runtime error raised by the query (Spark's SparkError)."""


@dataclasses.dataclass
class _Prepared:
    """What ``Session.prepare``'s warm-up keeps of one plan: its scalar
    subqueries' prepared runs ((id, column, _Prepared) in run order), each
    stage's (name, bound stage, budget presteps), and the run's records
    (stages, temporary table names, grace runners, tiled aggregates,
    planning ms)."""

    subqueries: list = dataclasses.field(default_factory=list)
    stages: list = dataclasses.field(default_factory=list)
    record: Optional[tuple] = None


class JoinOverflowError(RuntimeError):
    """A join's fan-out or an aggregate's group capacity still overflowed
    after every retry."""


def run_plan(plan: P.PlanNode, tables: Dict[str, Batch], ctx: EvalContext, conf: Config,
             fanout: int) -> Batch:
    """Execute a bound plan over registered tables, each node by the
    executor ``OPERATORS`` resolves for its class (exec/registry.py).
    ``fanout`` is the joins' K; their overflow flags go to
    ``ctx.overflow_flags``. Each operator's output goes to ``ctx.metrics``
    where it is set, and through ``debug.check_batch`` under
    ``Config.debug_validate_batches`` (JAX ``engine.py:60-85``)."""
    ctx.json_device = conf.gate(JSON_DEVICE_ENABLED)
    out = REG.OPERATORS.resolve(type(plan))(plan, tables, ctx, conf, fanout)
    if ctx.metrics is not None:
        ctx.metrics.record(plan, out)
    if conf.debug_validate_batches:
        from datafusion_comet_tpu_torch.exec.debug import check_batch

        check_batch(out, type(plan).__name__)
    return out


# the registered executors (JAX ``engine.py:85-270``): ``(plan, tables,
# ctx, conf, fanout) -> Batch``, a child run through ``run_plan``


def _child(plan, tables, ctx, conf, fanout) -> Batch:
    return run_plan(plan.children()[0], tables, ctx, conf, fanout)


@REG.OPERATORS.register(P.Scan)
def _exec_scan(plan, tables, ctx, conf, fanout) -> Batch:
    b = tables[plan.table]
    if plan.projection is not None:
        b = b.select([b.schema.index_of(n) for n in plan.projection], plan.schema)
    return b


@REG.OPERATORS.register(P.Filter)
def _exec_filter(plan, tables, ctx, conf, fanout) -> Batch:
    out = B.filter_op(_child(plan, tables, ctx, conf, fanout), plan.predicate, ctx)
    # a filter estimated to keep under an eighth of its capacity is
    # compacted to 4x its estimate (grown by the retry loop), so the
    # operators above run at the estimate (JAX ``engine.py:103-119``)
    est = plan.out_rows_hint
    if est:
        key = (id(plan), "rows")
        target = pad_capacity(max(max(4 * est, 1024) * ctx.agg_scale, ctx.floor(key)))
        if target * 8 <= out.capacity:
            live = out.row_mask.sum()
            out, covf = B.compact_batch(out, target)
            ctx.flag_overflow(covf, "filter_shrink", live, key)
    return out


@REG.OPERATORS.register(P.Projection)
def _exec_projection(plan, tables, ctx, conf, fanout) -> Batch:
    return B.project_op(_child(plan, tables, ctx, conf, fanout), plan.exprs, plan.schema, ctx)


@REG.OPERATORS.register(P.HashAggregate)
def _exec_hash_aggregate(plan, tables, ctx, conf, fanout) -> Batch:
    return AGG.hash_aggregate(_child(plan, tables, ctx, conf, fanout), plan.group_exprs,
                              plan.agg_exprs, plan.mode, plan.schema, ctx,
                              conf.agg_dense_max_domain, plan.max_groups or DEFAULT_MAX_GROUPS,
                              plan.group_key_ranges, plan.merge_rows, grow_key=id(plan))


@REG.OPERATORS.register(P.Sort)
def _exec_sort(plan, tables, ctx, conf, fanout) -> Batch:
    return B.sort_op(_child(plan, tables, ctx, conf, fanout), plan.orders, plan.fetch,
                     plan.skip, ctx)


@REG.OPERATORS.register(P.Limit)
def _exec_limit(plan, tables, ctx, conf, fanout) -> Batch:
    return B.limit_op(_child(plan, tables, ctx, conf, fanout), plan.limit, plan.offset)


@REG.OPERATORS.register(P.Expand)
def _exec_expand(plan, tables, ctx, conf, fanout) -> Batch:
    return B.expand_op(_child(plan, tables, ctx, conf, fanout), plan.projections, plan.schema,
                       ctx)


@REG.OPERATORS.register(P.Explode)
def _exec_explode(plan, tables, ctx, conf, fanout) -> Batch:
    out = B.explode_op(_child(plan, tables, ctx, conf, fanout), plan.expr, plan.schema,
                       plan.outer, plan.pos, ctx)
    # the E-fold output is sparse: where its live rows fit in half of it, it
    # is compacted to them (one host read of the count; the JAX package
    # keeps the E-fold capacity)
    target = pad_capacity(int(out.num_rows()))
    if target * 2 <= out.capacity:
        out = B.compact_batch(out, target, tag="explode")[0]
    return out


@REG.OPERATORS.register(P.Sample)
def _exec_sample(plan, tables, ctx, conf, fanout) -> Batch:
    return B.sample_op(_child(plan, tables, ctx, conf, fanout), plan.lower_bound,
                       plan.upper_bound, plan.with_replacement, plan.seed, ctx.partition_id)


@REG.OPERATORS.register(P.BroadcastNestedLoopJoin)
def _exec_bnlj(plan, tables, ctx, conf, fanout) -> Batch:
    left = run_plan(plan.left, tables, ctx, conf, fanout)
    right = run_plan(plan.right, tables, ctx, conf, fanout)
    if ctx.join_log is not None:
        ctx.join_log.append({"path": "nested_loop", "capacities": [left.capacity, right.capacity]})
    return J.nested_loop_join(left, right, plan.join_type, plan.schema, plan.condition, ctx)


@REG.OPERATORS.register(P.Window)
def _exec_window(plan, tables, ctx, conf, fanout) -> Batch:
    return W.window_op(_child(plan, tables, ctx, conf, fanout), plan.window_exprs, plan.schema,
                       ctx)


@REG.OPERATORS.register(P.ShuffleExchange, gated=False)
def _exec_exchange(plan, tables, ctx, conf, fanout) -> Batch:
    return _child(plan, tables, ctx, conf, fanout)  # one device: the identity (JAX :262)


@REG.OPERATORS.register(P.Union)
def _exec_union(plan, tables, ctx, conf, fanout) -> Batch:
    # JAX ``engine.py:270-330``: dictionaries unified, mixed decimal storage
    # widened, strings padded to the widest input
    return concat_batches([run_plan(c, tables, ctx, conf, fanout) for c in plan.inputs],
                          plan.schema)


def _join_label(plan) -> str:
    """A join's name in ``Session.runs[...]["overflow_ops"]``: its type and
    its first key pair."""
    names = [getattr(k, "col_name", None) or getattr(k, "name", "?")
             for k in (plan.left_keys[:1] + plan.right_keys[:1])]
    return f"{type(plan).__name__} {plan.join_type} {'='.join(names)}"


@REG.OPERATORS.register(P.HashJoin)
@REG.OPERATORS.register(P.SortMergeJoin)
def _exec_hash_join(plan, tables, ctx, conf, fanout) -> Batch:
    """A join with its planner hints (JAX ``engine.py:185-247``): K is the
    join's ``fanout_hint`` times the growth scale (at most 256), else the
    session's fan-out; an INNER or outer join with a row estimate lays its
    pairs out in a compacted list of twice the estimate (at least 4096, times
    the growth scale, at most 64x the larger input's capacity); the
    unique-build and key-packing hints hold on a plan's first run only. An
    INNER or outer join's output (FULL's with its build-capacity tail of
    unmatched build rows, as in the JAX engine) is compacted to the larger
    input's capacity times max(2, K / 2)
    (times the growth scale without a hint): chained joins then stay linear
    in capacity instead of multiplying their K's. A semi-like join's output
    keeps the probe's capacity with a thinned mask; with an output-row
    estimate it is compacted to a margin over the estimate (4x, grown by the
    retry loop; 2x where a runtime filter's exact key set gave the
    estimate) when that cuts its capacity at least 8x, so the operators
    above run at the post-join size. A SortMergeJoin runs here too, its
    build side fixed by its join type and its build-side sort skipped where
    ``presorted_build`` is set (JAX ``engine.py:173-212``)."""
    left = run_plan(plan.left, tables, ctx, conf, fanout)
    right = run_plan(plan.right, tables, ctx, conf, fanout)
    hint = plan.fanout_hint
    k = min(hint * ctx.agg_scale, 256) if hint else fanout
    # an earlier attempt's largest match count (a probe row with more than
    # 256 matches grows K past the hinted cap)
    k = max(k, pad_capacity(ctx.floor((id(plan), "K")), 1))
    compact_rows = None
    if plan.out_rows_hint and plan.join_type not in J.SEMI_LIKE:
        # the scale multiplies outside the floor, so a tiny wrong estimate
        # still grows on every retry
        lim = max(left.capacity, right.capacity) * 64
        compact_rows = pad_capacity(max(min(max(2 * plan.out_rows_hint, 4096) * ctx.agg_scale,
                                            lim), ctx.floor((id(plan), "rows"))))
    out, ovf = J.hash_join(left, right, plan.left_keys, plan.right_keys, plan.join_type,
                           plan.build_side, plan.schema, plan.condition,
                           max_build_matches=k, ctx=ctx,
                           build_key_range=plan.build_key_range,
                           unique_build=bool(plan.unique_build_hint) and ctx.unique_join_ok,
                           key_pack=plan.key_pack if ctx.unique_join_ok else None,
                           compact_rows=compact_rows, dense_range=plan.rf_dense_range,
                           cond_col_ranges=plan.cond_col_ranges,
                           presorted_build=getattr(plan, "presorted_build", False))
    label = _join_label(plan)
    need, ctx.join_need = ctx.join_need, None
    ctx.flag_overflow(ovf, label, *((need[1], (id(plan), need[0])) if need else ()))
    if plan.join_type in J.SEMI_LIKE:
        est = plan.out_rows_hint
        if est and plan.join_type != P.JoinType.EXISTENCE:
            rf = plan.rf_dense_range is not None  # a runtime filter's exact key set
            key = (id(plan), "out")
            target = pad_capacity(max(max((2 if rf else _SEMI_MARGIN) * est, 1024)
                                      * ctx.agg_scale, ctx.floor(key)))
            if target * 8 <= out.capacity:
                live = out.row_mask.sum()
                out, covf = B.compact_batch(out, target, tag="rf" if rf else None)
                ctx.flag_overflow(covf, label + " output", live, key)
        return out
    grow = max(2, k // 2) * (1 if hint else ctx.agg_scale)
    key = (id(plan), "out")
    target = pad_capacity(max(max(left.capacity, right.capacity) * grow, ctx.floor(key)))
    if target < out.capacity:
        live = out.row_mask.sum()
        out, covf = B.compact_batch(out, target)
        ctx.flag_overflow(covf, label + " output", live, key)
    return out


# -------------------------------------------------------------------------------------
# plan rewriting
# -------------------------------------------------------------------------------------


def replace_child_pure(plan: P.PlanNode, old: P.PlanNode, new: P.PlanNode) -> P.PlanNode:
    """A shallow copy of ``plan`` with its child ``old`` replaced: the
    caller's tree stays as it was."""
    cp = copy.copy(plan)
    for f in dataclasses.fields(cp):
        v = getattr(cp, f.name, None)
        if v is old:
            setattr(cp, f.name, new)
        elif isinstance(v, tuple) and any(x is old for x in v):
            setattr(cp, f.name, tuple(new if x is old else x for x in v))
    return cp


def replace_child_pure_deep(plan: P.PlanNode, old: P.PlanNode, new: P.PlanNode) -> P.PlanNode:
    """``old`` replaced by ``new`` anywhere in the tree, copying the path."""
    if plan is old:
        return new
    out = plan
    for c in plan.children():
        repl = replace_child_pure_deep(c, old, new)
        if repl is not c:
            out = replace_child_pure(out, c, repl)
    return out


def _sort_below(p: P.PlanNode) -> bool:
    """Whether ``p``'s rows come straight from a Sort through projections
    and limits only: its dead rows and null keys are then its last rows, as
    the merge path needs (a Filter keeps the order but kills rows in the
    middle)."""
    while isinstance(p, (P.Projection, P.Limit)):
        p = p.child
    return isinstance(p, P.Sort)


def _mark_presorted(plan: P.SortMergeJoin) -> P.PlanNode:
    """The merge half of JAX ``_apply_orderings`` (:1414-1427): a copy of
    the SortMergeJoin with ``presorted_build`` set where its build child is
    ordered ascending on the build keys with nulls last (non-nullable keys
    satisfy either placement), and comes from a Sort (``_sort_below``)."""
    left = plan.build_side == "left"
    bchild = plan.left if left else plan.right
    want = []
    for k in plan.left_keys if left else plan.right_keys:
        name = order_key_name(k, bchild.schema)
        if name is None:
            return plan
        want.append((name, True, False))
    if not (ordering_satisfies(out_ordering(bchild), want) and _sort_below(bchild)):
        return plan
    out = copy.copy(plan)
    out.presorted_build = True
    return out


def apply_orderings(plan: P.PlanNode) -> P.PlanNode:
    """A copy of the bound plan in which every Sort whose child already
    delivers its order (ir/ordering.py) is gone: replaced by its child, or
    by a Limit where it has a fetch or a skip (JAX ``engine.py:1386``, its
    Sort branch), and every SortMergeJoin whose build child is sorted on its
    keys takes the merge path (``_mark_presorted``). The caller's tree is
    not changed."""
    for old in plan.children():
        new = apply_orderings(old)
        if new is not old:
            plan = replace_child_pure(plan, old, new)
    if isinstance(plan, P.SortMergeJoin):
        return _mark_presorted(plan)
    if not isinstance(plan, P.Sort):
        return plan
    child = plan.child
    want = []
    for o in plan.orders:
        name = order_key_name(o.child, child.schema)
        if name is None:
            return plan
        want.append((name, o.ascending, o.resolved_nulls_first()))
    if not ordering_satisfies(out_ordering(child), want):
        return plan
    if plan.fetch is None and not plan.skip:
        return child
    out = P.Limit(child, plan.fetch or (1 << 62), plan.skip)
    out.schema = child.schema
    return out


def subquery_ids(v, out: Optional[set] = None) -> set:
    """The ids of every ``ScalarSubquery`` in a plan, an expression or a
    spec (their dataclass fields walked)."""
    out = set() if out is None else out
    if isinstance(v, E.ScalarSubquery):
        out.add(v.subquery_id)
    elif isinstance(v, (P.PlanNode, E.Expr, E.AggExpr, E.WindowExpr, E.SortOrder)):
        for f in dataclasses.fields(v):
            if f.init:
                subquery_ids(getattr(v, f.name), out)
    elif isinstance(v, tuple):
        for x in v:
            subquery_ids(x, out)
    return out


def _contains(plan: P.PlanNode, node_type) -> bool:
    return isinstance(plan, node_type) or any(_contains(c, node_type) for c in plan.children())


def _is_join(plan: P.PlanNode) -> bool:
    return isinstance(plan, (P.HashJoin, P.SortMergeJoin, P.BroadcastNestedLoopJoin))


def _is_counted_join(plan: P.PlanNode) -> bool:
    """A join the stage split counts: not a runtime filter's bitmap semi
    join (one scatter and one gather; JAX ``engine.py:1276``)."""
    return _is_join(plan) and not getattr(plan, "rf_injected", False)


def _count_joins(plan: P.PlanNode) -> int:
    return int(_is_counted_join(plan)) + sum(_count_joins(c) for c in plan.children())


def _count_heavy(plan: P.PlanNode) -> int:
    """Joins (but a runtime filter's), windows, sorts, expands and grouping
    aggregates in a subtree (JAX ``engine.py:1283``)."""
    own = _is_counted_join(plan) or isinstance(plan, (P.Window, P.Sort, P.Expand)) or (
        isinstance(plan, P.HashAggregate) and bool(plan.group_exprs))
    return int(own) + sum(_count_heavy(c) for c in plan.children())


_ROW_PRESERVING = (P.Filter, P.Projection, P.Expand, P.Sample)  # JAX ``engine.py:1452``


def find_stream_agg(plan: P.PlanNode, tables) -> Optional[Tuple[P.HashAggregate, str]]:
    """The aggregate the JAX package would run tiled over the budget
    (JAX ``engine.py:1455``): a SINGLE HashAggregate over filters,
    projections, expands and samples of one resident table, the one over the
    largest table; (aggregate, table) or None."""
    best = None

    def subtree_scan(p) -> Optional[str]:
        if isinstance(p, P.Scan):
            return p.table
        if not isinstance(p, _ROW_PRESERVING):
            return None
        return subtree_scan(p.children()[0])

    def walk(p) -> None:
        nonlocal best
        if isinstance(p, P.HashAggregate) and p.mode == P.AggMode.SINGLE:
            t = subtree_scan(p.child)
            if t is not None and t in tables:
                if best is None or tables[t].capacity > best[2]:
                    best = (p, t, tables[t].capacity)
                return
        for c in p.children():
            walk(c)

    walk(plan)
    return (best[0], best[1]) if best else None


# -------------------------------------------------------------------------------------
# Session
# -------------------------------------------------------------------------------------


class Session:
    """Table registry + plan executor on one device.

    ``device`` defaults to ``"cuda"``: without a card that raises, and a
    caller that means the CPU passes ``device="cpu"``. ``stats`` holds each
    table's statistics (``register_numpy`` collects them; a table registered
    as a batch has none, and its aggregates take the default capacities).
    Of the last ``execute``: ``stages`` holds its (temporary table name or
    None, bound subplan) stages in run order, ``grace_runners`` its grace
    joins (K, mode, partition sizes), ``tiled`` its tiled aggregates
    (table, tiles), ``plan_ms`` the host ms ``_plan_stages`` took, and
    ``subqueries`` each scalar subquery it ran, in run order: its ``id``,
    ``value`` and ``valid``, and its own run's ``stages``, ``runs``,
    ``grace_runners``, ``tiled`` and ``plan_ms``. The runtime filters' key
    tables (``__rf_*``) stay registered."""

    def __init__(self, device: Union[str, torch.device, None] = None,
                 conf: Optional[Config] = None):
        self.device = torch.device(device or "cuda")
        if self.device.type == "cuda":
            if not torch.cuda.is_available():
                raise RuntimeError("Session runs on a CUDA card and none is available; "
                                   "pass device='cpu' to run on the CPU")
            if self.device.index is None:
                self.device = torch.device("cuda", torch.cuda.current_device())
        self.conf = conf or Config()
        if self.conf.tracing_enabled:
            tracer.enabled = True
        self.tables: Dict[str, Batch] = {}
        self.stats: Dict[str, TableStats] = {}
        self.stages: List[Tuple[Optional[str], P.PlanNode]] = []
        self.grace_runners: List[G.GraceJoinRunner] = []
        self.tiled: List[Tuple[str, int]] = []  # (table, tiles) of each tiled aggregate
        # every run of the last ``execute``: where it ran ("stage", a grace
        # "pair" or a "tiled" aggregate), its growth scale, unique_join_ok,
        # whether it overflowed, its hash joins' types, paths and output
        # capacities (semi-like joins apart) and its nested-loop joins'
        # input capacities
        self.runs: List[dict] = []
        # the re-runs of the last execute held to the budget (``_rebudget``):
        # their scale, estimates before and after, and grace joins and tiles
        self.rebudgets: List[dict] = []
        self.plan_ms: Optional[float] = None
        self.subqueries: List[dict] = []
        self._ids = itertools.count()
        self._host_cols: Dict[str, HostColumns] = {}
        # registered scalar subqueries: (bound plan, column) by id, the id
        # of each (JSON, column), and, during a top-level execute, the values
        self._subquery_plans: List[Tuple[P.PlanNode, int]] = []
        self._subquery_keys: Dict[Tuple[str, int], int] = {}
        self._subquery_values: Optional[Dict[int, Tuple[object, bool]]] = None
        # under ``prepare``: each settled attempt by id of its key, and
        # whether a prepared call is running (then the attempts replay)
        self._attempts: Optional[Dict[int, tuple]] = None
        self._replay = False
        # a budget below the card's, while a stage that ran out of memory is
        # planned again (``_oom_rebudget``)
        self._budget_cap: Optional[int] = None
        # the tables MapInBatch results were staged as, freed at the end of
        # the execute that made them
        self._map_tables: List[str] = []

    def register_batch(self, name: str, batch: Batch) -> None:
        if batch.device != self.device:
            raise ValueError(f"batch lives on {batch.device}, session on {self.device}")
        self.tables[name] = batch

    def register_numpy(self, name: str, data: Dict[str, np.ndarray], schema: T.Schema,
                       **kw) -> None:
        """Stage host columns on the session's device (see batch.from_numpy)
        and collect their statistics."""
        kw.setdefault("dict_max_size", self.conf.scan_dictionary_max_size)
        self.stats[name] = collect_stats(data, schema)
        self.tables[name] = from_numpy(data, schema, self.device, **kw)

    def host_columns(self, table: str) -> HostColumns:
        """Host copies of a registered table's columns, for the runtime
        filters' plan-time evaluation: made on first use and kept while the
        same batch stays registered under ``table``."""
        batch = self.tables[table]
        hit = self._host_cols.get(table)
        if hit is None or hit.batch is not batch:
            hit = self._host_cols[table] = HostColumns(batch)
        return hit

    def budget_bytes(self) -> int:
        budget = device_budget_bytes(self.device, self.conf.memory_fraction)
        return budget if self._budget_cap is None else min(budget, self._budget_cap)

    def scalar_subquery(self, plan: P.PlanNode, column: int = 0) -> E.ScalarSubquery:
        """Register an uncorrelated scalar subquery: the value of ``column``
        in its plan's first row, null where there is none (JAX
        ``engine.py:535``). Bound without pruning; structurally equal
        subqueries share one id, and so one run an ``execute``."""
        with sketch_scope(self.conf.approx_percentile_sketch):
            bound = plan if plan.schema is not None else P.bind_plan(plan)
        key = (plan_to_json(bound), column)
        sid = self._subquery_keys.get(key)
        if sid is None:
            sid = self._subquery_keys[key] = len(self._subquery_plans)
            self._subquery_plans.append((bound, column))
        return E.ScalarSubquery(sid, bound.schema.fields[column].dtype)

    def subquery_plan(self, sid: int) -> P.PlanNode:
        """The bound plan of the registered subquery ``sid``."""
        return self._subquery_plans[sid][0]

    def _materialize_subqueries(self, plan: P.PlanNode,
                                prep: Optional["_Prepared"] = None) -> None:
        """Run each subquery ``plan`` holds that this top-level execute has
        not run yet, in id order (a subquery holds only earlier ones), and
        keep its value and its run's records (``subqueries``); under
        ``prepare`` (``prep``), keep each subquery's own prepared run."""
        for sid in sorted(subquery_ids(plan) - set(self._subquery_values)):
            sub, column = self._subquery_plans[sid]
            sub_prep = None if prep is None else _Prepared()
            # a fresh copy: the planner fills its hints in place
            out = self._execute_stages(copy.deepcopy(sub), sub_prep)
            if prep is not None:
                prep.subqueries.append((sid, column, sub_prep))
            self._keep_value(sid, out, column)

    def _keep_value(self, sid: int, out: Batch, column: int) -> None:
        """A scalar subquery's value from its result: the column's value in
        its one live row, null where it has none; more than one live row
        raises QueryExecutionError, as Spark's SCALAR_SUBQUERY_TOO_MANY_ROWS
        does (the JAX package takes the first row, ROADMAP C22)."""
        field = self._subquery_plans[sid][0].schema.fields[column]
        host = to_numpy(out.select([column], T.Schema([field])))
        rows = host[field.name]
        if len(rows) > 1:
            raise QueryExecutionError(
                f"[SCALAR_SUBQUERY_TOO_MANY_ROWS] scalar subquery {sid} returned {len(rows)} "
                "rows; more than one row returned by a subquery used as an expression")
        value = (rows[0], bool(host[field.name + "__valid"][0])) if len(rows) else (None, False)
        self._subquery_values[sid] = value
        self.subqueries.append({"id": sid, "value": value[0], "valid": value[1],
                                "stages": self.stages, "runs": self.runs,
                                "grace_runners": self.grace_runners, "tiled": self.tiled,
                                "rebudgets": self.rebudgets, "plan_ms": self.plan_ms})

    def execute(self, plan: P.PlanNode) -> Batch:
        """Run the plan's scalar subqueries (``_materialize_subqueries``),
        plan the stages (``_plan_stages``) and run them in order, each
        fitted to the memory budget and run with the overflow retry; a named
        stage's result, compacted, is the temporary table the next stages
        read. Raises QueryExecutionError when a flag of the error side
        channel fired: an ANSI error, or a kernel's code out of range."""
        if self._subquery_values is not None:  # a subquery's run inside an execute
            return self._execute_stages(plan)
        self._subquery_values, self.subqueries = {}, []
        try:
            return self._execute_stages(plan)
        finally:
            self._subquery_values = None

    def _execute_stages(self, plan: P.PlanNode, prep: Optional["_Prepared"] = None) -> Batch:
        """``execute``'s run of one plan; under ``prepare`` (``prep``), each
        stage's budget presteps (its grace runners and tiled aggregates) are
        kept, and its settled attempt is in ``_attempts``."""
        self._materialize_subqueries(plan, prep)
        n_udf = len(self._map_tables)
        try:
            return self._run_stages(plan, prep)
        finally:
            if prep is None:  # a prepared plan's stages read them again
                for n in self._map_tables[n_udf:]:
                    self.tables.pop(n, None)
                del self._map_tables[n_udf:]

    def _run_stages(self, plan: P.PlanNode, prep: Optional["_Prepared"]) -> Batch:
        t0 = time.perf_counter()
        self.stages = self._plan_stages(plan)
        self.plan_ms = (time.perf_counter() - t0) * 1e3
        self.grace_runners = []
        self.tiled = []
        self.runs = []
        self.rebudgets = []
        temp_names: List[str] = [n for n, _ in self.stages if n]
        out = None
        try:
            for name, sub in self.stages:
                # every stage's gates before it runs (JAX ``engine.py:792``)
                reasons = REG.gate_reasons(sub, self.conf)
                if reasons:
                    raise UnsupportedPlanError(reasons)
                presteps = None if prep is None else []
                try:
                    out = self._run_subtree(sub, temp_names, presteps)
                except UnsupportedPlanError:
                    raise
                except NotImplementedError as e:
                    # the evaluator's and the operators' refusals, as the
                    # reasons validate() reports
                    raise UnsupportedPlanError([f"unsupported: {e}"]) from e
                if prep is not None:
                    prep.stages.append((name, sub, presteps))
                if name:
                    self.tables[name] = self._aqe_shrink(out)
            return out
        finally:
            for n in temp_names:  # free the temporary tables
                self.tables.pop(n, None)
            if prep is not None:
                prep.record = (self.stages, temp_names, self.grace_runners, self.tiled,
                               self.plan_ms)

    def prepare(self, plan: P.PlanNode) -> Callable[[], Batch]:
        """A reusable runner of ``plan``, the benchmarking and serving entry
        point (JAX ``engine.py:812-849``): one warm-up run plans the stages
        (runtime filters and hints included) and settles each stage's
        attempt (fan-out, growth scale, whether the unique-build and packing
        hints hold) and its budget presteps (grace joins and tiled
        aggregates); each call re-runs the presteps and the settled stages
        with no planning and records ``runs``. ``plan_ms`` on the runner is
        the warm-up's planning. Unlike the JAX package's runner, a call
        reads the stages' error and overflow flags in its one device-to-host
        copy and raises JoinOverflowError where a settled capacity
        overflows (the tables changed; ROADMAP divergence a), and re-runs
        the plan's scalar subqueries, each prepared too (divergence b)."""
        prep = _Prepared()
        self._attempts, self._subquery_values, self.subqueries = {}, {}, []
        try:
            self._execute_stages(plan, prep)
        finally:
            attempts, self._attempts, self._subquery_values = self._attempts, None, None

        def run() -> Batch:
            self._attempts, self._replay = attempts, True
            self._subquery_values, self.subqueries = {}, []
            try:
                return self._replay_stages(prep)
            finally:
                self._attempts, self._replay, self._subquery_values = None, False, None

        run.plan_ms = prep.record[4]
        return run

    def _replay_stages(self, prep: "_Prepared") -> Batch:
        """One call of a prepared plan: its subqueries' prepared runs, then
        each stage's presteps and its settled attempt."""
        for sid, column, sub_prep in prep.subqueries:
            self._keep_value(sid, self._replay_stages(sub_prep), column)
        self.stages, temp_names, self.grace_runners, self.tiled, _ = prep.record
        self.plan_ms, self.runs, self.rebudgets = 0.0, [], []
        out = None
        try:
            for name, sub, presteps in prep.stages:
                for step in presteps:
                    step()
                out = self._execute_retry(sub, key=sub)
                if name:
                    self.tables[name] = self._aqe_shrink(out)
            return out
        finally:
            for n in temp_names:
                self.tables.pop(n, None)

    def collect(self, plan: P.PlanNode) -> Dict[str, np.ndarray]:
        return to_numpy(self.execute(plan))

    def validate(self, plan: P.PlanNode) -> List[str]:
        """Why the plan cannot run, [] where it can (JAX ``engine.py:
        1117-1145``, the reference's fallback reasons): ``planning: ...``
        where it does not bind, the gates' reasons, ``unsupported: ...``
        where an operator or the evaluator refuses it and ``invalid: ...``
        for any other error. The JAX package traces the plan abstractly
        (``jax.eval_shape``); eager PyTorch has no such trace of a plan that
        reads counts on the host, so the bound plan runs on the session's
        device over a copy of each table with a few rows, none of them live,
        its scalar subqueries as null placeholders and its Python UDFs
        returning nulls without running."""
        try:
            with sketch_scope(self.conf.approx_percentile_sketch):
                bound = plan if plan.schema is not None else P.bind_plan(plan)
        except (NotImplementedError, KeyError, TypeError, AssertionError) as e:
            return [f"planning: {type(e).__name__}: {e}"]
        reasons = REG.gate_reasons(bound, self.conf)
        if reasons:
            return reasons
        dead = {}
        for name, b in self.tables.items():
            rows = torch.arange(min(b.capacity, 8), device=b.device)
            dead[name] = b.take(rows, torch.zeros_like(rows, dtype=torch.bool))
        ctx = EvalContext(errors=[], overflow_flags=[], join_log=[], validating=True,
                          subquery_values={i: (None, False)
                                           for i in range(len(self._subquery_plans))})
        try:
            with sketch_scope(self.conf.approx_percentile_sketch):
                run_plan(bound, dead, ctx, self.conf, J.JOIN_FANOUT)
        except NotImplementedError as e:
            return [f"unsupported: {e}"]
        except Exception as e:  # a type or shape error
            return [f"invalid: {type(e).__name__}: {e}"]
        return []

    def _stage_map_in_batch(self, plan: P.PlanNode) -> P.PlanNode:
        """Bottom-up, each MapInBatch as a table: its child run through
        ``execute``, the function over the live rows as a pandas DataFrame
        on the host, the result staged on the device (JAX ``engine.py:707``,
        which imports pandas there too) and read by a scan."""
        for old in plan.children():
            new = self._stage_map_in_batch(old)
            if new is not old:
                plan = replace_child_pure(plan, old, new)
        if not isinstance(plan, P.MapInBatch):
            return plan
        import pandas as pd

        host = to_numpy(self.execute(plan.child))
        df = pd.DataFrame({k: v for k, v in host.items() if not k.endswith("__valid")})
        for k in list(df.columns):  # nulls as None
            valid = host[k + "__valid"]
            if not valid.all():
                df[k] = [v if ok else None for v, ok in zip(df[k], valid)]
        out_df = plan.fn(df)
        schema = T.Schema(list(plan.out_fields))
        data = {f.name: (list(out_df[f.name]) if f.dtype.is_nested
                         else [None if pd.isna(v) else v for v in out_df[f.name]])
                for f in schema.fields}
        name = f"__mapinbatch{next(self._ids)}"
        self.tables[name] = from_numpy(data, schema, self.device,
                                       dict_max_size=self.conf.scan_dictionary_max_size)
        self._map_tables.append(name)
        return pseudo_scan(name, schema)

    # -- observability -------------------------------------------------------------
    def explain(self, plan: P.PlanNode, with_metrics: bool = False, profile_ops: bool = False,
                as_tree: bool = False):
        """The bound plan as a tree of operators (JAX ``engine.py:1149``);
        ``with_metrics`` runs it once as it stands (no stage split, no
        statistics, no retry, as the JAX package's ``run_plan`` does) and
        fills in each operator's live output rows, capacity and bytes: the
        row counts stay on the device until one copy at the end.
        ``profile_ops`` times each subtree on its own (warm, best of two;
        CUDA events on the card) and keeps each operator's marginal ms (its
        subtree's less its children's). ``as_tree`` returns the
        ``MetricsNode`` instead of its rendering. ``collect`` is untouched."""
        from datafusion_comet_tpu_torch.observability.metrics import (MetricsCollector,
                                                                      build_metrics_tree)

        with sketch_scope(self.conf.approx_percentile_sketch):
            bound = plan if plan.schema is not None else P.bind_plan(plan)
        tree = build_metrics_tree(bound, self.device.type)
        if not with_metrics:
            return tree if as_tree else tree.render()
        mc = MetricsCollector()
        self._subquery_values, self.subqueries = {}, []
        try:
            self._materialize_subqueries(bound)
            with with_trace("explain_execute"):
                t0 = time.perf_counter()
                self._bare_run(bound, mc)
                resolved = mc.resolved()
                tree.elapsed_ms = (time.perf_counter() - t0) * 1e3
            mc.fill(tree, bound, resolved)
            if profile_ops:
                self._profile_subtrees(tree, bound)
        finally:
            self._subquery_values = None
        return tree if as_tree else tree.render()

    def _bare_run(self, plan: P.PlanNode, metrics=None) -> Batch:
        ctx = EvalContext(errors=[], overflow_flags=[], join_log=[],
                          subquery_values=self._subquery_values, metrics=metrics)
        return run_plan(plan, self.tables, ctx, self.conf, J.JOIN_FANOUT)

    def _profile_subtrees(self, tree, plan: P.PlanNode) -> None:
        """Each operator's marginal ms: its subtree timed alone (a warm run,
        then the best of two), less its children's subtrees (JAX
        ``engine.py:1196``)."""
        cuda = self.device.type == "cuda"

        def subtree_ms(node: P.PlanNode) -> float:
            self._bare_run(node)
            best = float("inf")
            for _ in range(2):
                if cuda:
                    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
                    start.record()
                    self._bare_run(node)
                    end.record()
                    end.synchronize()
                    best = min(best, start.elapsed_time(end))
                else:
                    t0 = time.perf_counter()
                    self._bare_run(node)
                    best = min(best, (time.perf_counter() - t0) * 1e3)
            return best

        def walk(t, node) -> float:
            mine = subtree_ms(node)
            kids = sum(walk(sub, child) for sub, child in zip(t.children, node.children()))
            t.elapsed_ms = max(mine - kids, 0.0)
            return mine

        walk(tree, plan)

    # -- stages --------------------------------------------------------------------
    def _plan_stages(self, plan: P.PlanNode) -> List[Tuple[Optional[str], P.PlanNode]]:
        """Prune, inject the runtime filters and bind (unless ``plan`` is
        bound; the injector keeps the hints pruning would not carry), fill
        the aggregates' capacities from statistics, drop the Sorts their
        input already satisfies (``apply_orderings``), and split:
        [(temporary table name, subplan)] in run order, the last one (None,
        the query's root)."""
        with sketch_scope(self.conf.approx_percentile_sketch):
            bound = plan if plan.schema is not None else P.bind_plan(
                inject_runtime_filters(prune_columns(plan), self))
        derive_capacities(bound, self.stats)
        bound = apply_orderings(bound)
        if _contains(bound, P.MapInBatch):
            bound = self._stage_map_in_batch(bound)
        stages: List[Tuple[Optional[str], P.PlanNode]] = []
        root = bound
        max_joins = self.conf.stage_max_joins
        if max_joins and _count_joins(bound) > max_joins:
            root = self._split_stages(bound, max_joins, stages)
        stages.append((None, root))
        if not self.conf.stage_max_heavy_ops:
            return stages
        out: List[Tuple[Optional[str], P.PlanNode]] = []
        for name, sub in stages:
            pre: List[Tuple[Optional[str], P.PlanNode]] = []
            sub = self._split_heavy(sub, self.conf.stage_max_heavy_ops, pre)
            out.extend(pre)
            out.append((name, sub))
        return out

    def _stage(self, child: P.PlanNode, stages) -> P.Scan:
        """``child`` as a stage of its own: the scan that reads its result."""
        name = f"__stage{next(self._ids)}"
        stages.append((name, child))
        return pseudo_scan(name, child.schema)

    def _split_stages(self, plan: P.PlanNode, max_joins: int, stages) -> P.PlanNode:
        """Bottom-up: where a node's stage would hold more than ``max_joins``
        joins, its join-heaviest children become stages of their own until
        it fits. The caller's tree is not changed."""
        for old in plan.children():
            new = self._split_stages(old, max_joins, stages)
            if new is not old:
                plan = replace_child_pure(plan, old, new)
        total = sum(_count_joins(k) for k in plan.children()) + int(_is_join(plan))
        for child in sorted(plan.children(), key=_count_joins, reverse=True):
            if total <= max_joins or _count_joins(child) == 0:
                break
            plan = replace_child_pure(plan, child, self._stage(child, stages))
            total -= _count_joins(child)
        return plan

    def _split_heavy(self, plan: P.PlanNode, max_heavy: int, stages) -> P.PlanNode:
        """Bottom-up: while a stage holds more than ``max_heavy`` heavy
        operators, the child of a Window, Sort or aggregate that holds one
        becomes a stage of its own (JAX ``engine.py:906-930``)."""
        for old in plan.children():
            new = self._split_heavy(old, max_heavy, stages)
            if new is not old:
                plan = replace_child_pure(plan, old, new)
        if _count_heavy(plan) > max_heavy and isinstance(plan,
                                                         (P.Window, P.Sort, P.HashAggregate)):
            child = plan.children()[0]
            if not isinstance(child, P.Scan) and _count_heavy(child) >= 1:
                plan = replace_child_pure(plan, child, self._stage(child, stages))
        return plan

    # -- running -------------------------------------------------------------------
    def _run_subtree(self, plan: P.PlanNode, temp_names: List[str],
                     presteps: Optional[list] = None) -> Batch:
        """A stage fitted to the budget (``_budget_plan``) and run with the
        overflow retry; ``presteps`` collects its grace runners and tiled
        fills for ``prepare``."""
        return self._execute_retry(self._budget_plan(plan, temp_names, presteps=presteps),
                                   temp_names=temp_names, key=plan, presteps=presteps)

    def _execute_retry(self, plan: Union[P.PlanNode, Callable[[EvalContext], Batch]],
                       tables: Optional[Dict[str, Batch]] = None, where: str = "stage",
                       temp_names: Optional[List[str]] = None, key=None,
                       presteps: Optional[list] = None) -> Batch:
        """Run ``plan``, again with the joins' fan-out and the growth scale
        four times larger while a capacity overflows; the joins' unique-build
        and key-packing hints hold on the first attempt only. ``plan`` is a
        bound plan, or a function that runs one attempt in the context it is
        given (the tiled aggregate's tiles, ``where="tiled"``). With
        ``temp_names`` (a stage of the session's tables), each re-run is
        first held to the memory budget at its scale (``_rebudget``).

        Under ``prepare`` the attempt that succeeds is kept by ``key`` (the
        plan where None); a prepared call runs that attempt once, and raises
        where it overflows."""
        key = plan if key is None else key
        hit = self._attempts.get(id(key)) if self._attempts is not None else None
        if hit is not None and self._replay:
            _, kept, fanout, scale, attempt, grown = hit
            run = plan if callable(plan) or kept is None else kept
            out, overflowed = self._run_once(run, fanout, scale, tables,
                                             unique_join_ok=attempt == 0, where=where,
                                             grown=grown, floors=True)
            if overflowed:
                raise JoinOverflowError(
                    f"a prepared run overflowed its settled capacities (scale {scale}): "
                    f"{self.runs[-1]['overflow_ops']}; the tables changed since prepare")
            return out
        fanout, scale = J.JOIN_FANOUT, 1
        grown: Dict[tuple, int] = {}  # the capacities the attempts proved needed
        for attempt in range(J.MAX_JOIN_RETRIES):
            # the counted capacities hold where the JAX package's growth has
            # run out: on the last attempt, a re-run held to the budget, and
            # after running out of memory (C24); elsewhere the attempts are
            # the JAX package's
            floors = attempt == J.MAX_JOIN_RETRIES - 1
            if attempt and temp_names is not None and not callable(plan):
                rebudgeted = self._rebudget(plan, temp_names, scale, presteps)
                floors = floors or rebudgeted is not plan
                plan = rebudgeted
            for cut in range(_OOM_REPLANS + 1):
                try:
                    if cut:
                        plan, floors = self._oom_rebudget(plan, temp_names, scale, presteps,
                                                          cut), True
                    out, overflowed = self._run_once(plan, fanout, scale, tables,
                                                     unique_join_ok=attempt == 0, where=where,
                                                     grown=grown, floors=floors)
                    break
                except torch.OutOfMemoryError:
                    if cut == _OOM_REPLANS or temp_names is None or callable(plan):
                        raise
                # out of the handler, whose traceback holds the failed
                # attempt's tensors: free them before planning again
                gc.collect()
                torch.cuda.empty_cache()
            if not overflowed:
                if self._attempts is not None:
                    # a stage's plan is kept with its presteps, which fill
                    # the temporary tables it reads again; any other run
                    # replays the plan its caller plans again
                    kept = plan if presteps is not None and not callable(plan) else None
                    self._attempts[id(key)] = (key, kept, fanout, scale, attempt,
                                               grown if floors else {})
                return out
            fanout *= 4
            scale *= 4
        raise JoinOverflowError(
            f"a join's fan-out or an aggregate's groups exceeded after {J.MAX_JOIN_RETRIES} "
            f"retries: {self.runs[-1]['overflow_ops']}")

    def _settled(self, key) -> Optional[Tuple[int, int, int]]:
        """Under ``prepare``: (fan-out, scale, attempt) kept for ``key``."""
        hit = self._attempts.get(id(key)) if self._attempts is not None else None
        return None if hit is None else hit[2:5]

    def _settle(self, key, fanout: int, scale: int, attempt: int) -> None:
        if self._attempts is not None:
            self._attempts[id(key)] = (key, None, fanout, scale, attempt, {})

    def _oom_rebudget(self, plan: P.PlanNode, temp_names: List[str], scale: int,
                      presteps: Optional[list], cut: int = 1) -> P.PlanNode:
        """A stage attempt that ran out of the card's memory for the
        ``cut``-th time: its estimate undercounts what the run allocates
        (sort limbs, gathers and other intermediates the estimate leaves
        out), so the stage is planned again under a budget of its estimate
        over 4^cut (``_budget_plan``: a tiled aggregate or a grace join) and
        run again at the same attempt; here a join under the stage's
        aggregate is partitioned whatever its share of the estimate (the
        estimate's error is what ran out). Each is a ``rebudgets`` entry
        (``oom``); where nothing can be cut, the error stands."""
        peak = self._stage_peak(plan, scale) or 0
        cap = max(peak // 4 ** cut, 1)
        prev, self._budget_cap = self._budget_cap, cap
        try:
            out = self._record_rebudget(plan, temp_names, scale, presteps, peak, oom=True,
                                        budget=cap, grace_margin=0)
        finally:
            self._budget_cap = prev
        if out is plan:
            raise torch.OutOfMemoryError(
                f"a stage ran out of device memory at growth scale {scale} and has no aggregate "
                f"to tile or join to partition under a budget of {cap >> 20} MiB")
        return out

    def _rebudget(self, plan: P.PlanNode, temp_names: List[str], scale: int,
                  presteps: Optional[list] = None) -> P.PlanNode:
        """A re-run at growth ``scale`` held to the memory budget: where the
        stage's estimate at that scale (memory.plan_peak_bytes) is over the
        budget, it goes back through ``_budget_plan`` at that scale, so an
        aggregate runs tiled or a join grace-partitioned (its pairs with
        their own retry) instead of the whole x4 plan being allocated; where
        it fits, the attempt is the JAX package's. Each such re-budget is a
        ``rebudgets`` entry."""
        peak = self._stage_peak(plan, scale)
        if peak is None or peak <= self.budget_bytes():
            return plan
        return self._record_rebudget(plan, temp_names, scale, presteps, peak)

    def _record_rebudget(self, plan: P.PlanNode, temp_names: List[str], scale: int,
                         presteps: Optional[list], peak: int, grace_margin: float = 2,
                         **extra) -> P.PlanNode:
        """``_budget_plan`` at ``scale``, recorded in ``rebudgets``; each
        grace runner it made is marked ``rebudget``."""
        grace, tiled = len(self.grace_runners), len(self.tiled)
        out = self._budget_plan(plan, temp_names, scale, presteps, grace_margin)
        for r in self.grace_runners[grace:]:
            r.rebudget = True
        self.rebudgets.append({"scale": scale, "peak_estimate": peak, **extra,
                               "grace": [(r.K, r.downstream and r.downstream[0])
                                         for r in self.grace_runners[grace:]],
                               "tiled": self.tiled[tiled:],
                               "after": self._stage_peak(out, scale)})
        return out

    def _stage_peak(self, plan: P.PlanNode, scale: int) -> Optional[int]:
        """The stage's resident-bytes estimate at growth ``scale`` over its
        largest registered input, or None where it reads none."""
        caps = [self.tables[t].capacity for t in P.scan_tables(plan) if t in self.tables]
        return plan_peak_bytes(plan, max(caps), scale) if caps else None

    def _run_once(self, plan: Union[P.PlanNode, Callable[[EvalContext], Batch]], fanout: int,
                  scale: int, tables: Optional[Dict[str, Batch]] = None,
                  unique_join_ok: bool = True, where: str = "stage",
                  grown: Optional[Dict[tuple, int]] = None,
                  floors: bool = False) -> Tuple[Batch, bool]:
        """One run of a bound plan (or of a function of the run's context):
        (result, whether a capacity overflowed). Every error and overflow
        flag of the run, and the capacity each overflowed operator would have
        needed, is read in one device-to-host copy at its end; the needs go
        to ``grown``, which an attempt with ``floors`` gives its operators as
        the least capacities they take (``EvalContext.grown``). The run is
        recorded in ``runs`` with the operators whose overflow flags fired
        and, for a stage, its resident-bytes estimate."""
        errs: List[Tuple[torch.Tensor, str]] = []
        grown = {} if grown is None else grown
        ctx = EvalContext(errors=errs, overflow_flags=[], overflow_ops=[], overflow_needs=[],
                          grown=grown if floors else None, agg_scale=scale,
                          unique_join_ok=unique_join_ok, join_log=[],
                          subquery_values=self._subquery_values)
        out = (plan(ctx) if callable(plan) else
               run_plan(plan, self.tables if tables is None else tables, ctx, self.conf, fanout))
        flags = [f for f, _ in errs] + ctx.overflow_flags
        needs = [n for n in ctx.overflow_needs if n is not None]
        vals = (torch.stack([f.any().long() for f in flags]
                            + [n.reshape(()).long() for _, n in needs]).tolist()
                if flags else [])
        hit, counts = vals[:len(flags)], iter(vals[len(flags):])
        fired = [m for (_, m), h in zip(errs, hit) if h]
        if fired:
            raise QueryExecutionError("; ".join(dict.fromkeys(fired)))
        for need, h in zip(ctx.overflow_needs, hit[len(errs):]):
            if need is not None:
                count = next(counts)
                if h:
                    grown[need[0]] = max(grown.get(need[0], 0), count)
        ops = [op for op, h in zip(ctx.overflow_ops, hit[len(errs):]) if h]
        estimate = (self._stage_peak(plan, scale)
                    if where == "stage" and tables is None and not callable(plan) else None)
        self.runs.append({"where": where, "scale": scale, "unique_join_ok": unique_join_ok,
                          "overflowed": bool(ops), "overflow_ops": ops, "estimate": estimate,
                          "joins": ctx.join_log})
        return out, bool(ops)

    def _aqe_shrink(self, b: Batch) -> Batch:
        """Compact a batch to twice its live rows (at least 1024, a power of
        two) when that cuts its capacity at least four times: one host read
        of the live count. Bounds and dictionaries carry over. (The JAX
        package skips a moderate shrink of a very large batch to save a
        compile; here nothing is compiled, so every such shrink runs.)"""
        target = pad_capacity(max(2 * int(b.num_rows()), 1024))
        if target * 4 > b.capacity:
            return b
        return B.compact_batch(b, target, keep_bounds=True)[0]

    # -- the memory budget ---------------------------------------------------------
    def _tiled_rewrite(self, stage: P.PlanNode, agg: P.HashAggregate, table: str,
                       budget: int, temp_names: List[str], scale: int = 1,
                       presteps: Optional[list] = None) -> P.PlanNode:
        """Run ``agg`` tiled over ``table`` (exec/streaming.py), at the
        JAX package's tile count (``plan_tiles`` snapped to a power of two,
        at most an eighth of the capacity), with the overflow retry (each
        attempt a ``runs`` entry where "tiled"), register its result as a
        temporary table and put a scan of it in the aggregate's place. The
        fill is a prestep of ``prepare``."""
        batch = self.tables[table]
        tiles = max(plan_tiles(agg, batch.capacity, budget, scale), 1)
        tiles = min(1 << max(int(tiles - 1).bit_length(), 0), max(batch.capacity // 8, 1))
        tmp = f"__budget{next(self._ids)}"
        temp_names.append(tmp)
        tiled = TiledAggregator(agg, table, self.conf)

        def fill() -> None:
            b = self.tables[table]
            pieces = list(slice_tiles(b, max(b.capacity // tiles, 8)))
            with with_trace("tiled.aggregate"):
                self.tables[tmp] = self._execute_retry(lambda ctx: tiled.run(pieces, ctx),
                                                       where="tiled", key=tiled)

        fill()
        if presteps is not None:
            presteps.append(fill)
        self.tiled.append((table, tiles))
        scan = pseudo_scan(tmp, self.tables[tmp].schema)
        return scan if agg is stage else replace_child_pure_deep(stage, agg, scan)

    def _budget_plan(self, stage: P.PlanNode, temp_names: List[str],
                     scale: int = 1, presteps: Optional[list] = None,
                     grace_margin: float = 2) -> P.PlanNode:
        """While the stage's peak estimate at growth ``scale`` is over the
        budget, run a SINGLE aggregate over one table tiled
        (``_tiled_rewrite``), else an over-budget join hash-partitioned
        (GraceJoinRunner), and splice its result back in as a
        temporary-table scan, in the JAX package's order. A stage over
        budget with neither proceeds with a warning (the estimate is
        conservative). ``presteps`` collects each grace runner and tiled
        fill, which ``prepare`` runs again on each call; ``grace_margin``:
        how many budgets a join's own estimate must exceed to be
        partitioned."""
        for _ in range(16):  # each pass peels one over-budget subtree
            peak = self._stage_peak(stage, scale)
            if peak is None:
                break
            budget = self.budget_bytes()
            if peak <= budget:
                break
            target = find_stream_agg(stage, self.tables)
            if target is not None:
                stage = self._tiled_rewrite(stage, *target, budget, temp_names, scale, presteps)
                continue
            gj = G.find_grace_join(stage, self.tables, budget, scale, grace_margin)
            if gj is None:
                warnings.warn(f"stage peak estimate {peak >> 20} MiB exceeds the memory budget "
                              f"{budget >> 20} MiB and has no partitionable join; proceeding")
                break
            jpeak = self._stage_peak(gj, scale)
            K = 2
            while K * (budget // 2) < jpeak and K < G.GRACE_MAX_PARTITIONS:
                K *= 2
            ds = G.plan_grace_downstream(stage, gj)
            runner = G.GraceJoinRunner(self, gj, K, temp_names, stage=stage, downstream=ds)
            temp_names.append(runner.tmp)
            runner()
            if presteps is not None:
                presteps.append(runner)
            self.grace_runners.append(runner)
            scan = pseudo_scan(runner.tmp, runner.out_schema)
            if ds is None:
                stage = replace_child_pure_deep(stage, gj, scan)
            elif ds[0] == "partial":
                stage = replace_child_pure_deep(stage, ds[1], scan)
            elif isinstance(stage, P.Sort):
                # local under a top-K root: each pair ran the stage, its own
                # top-K included; the sort (order, fetch and skip) runs again
                # over the union of the pairs' top-Ks
                stage = replace_child_pure(stage, stage.child, scan)
            else:  # local: the whole stage ran inside each pair
                stage = scan
        return stage

"""Query engine: a bound plan tree executed operator by operator over
device-resident tables (port of the ``Session`` subset of
``datafusion_comet_tpu/exec/engine.py`` that the ported TPC-H and TPC-DS
queries reach: a ``Union`` runs as one row concatenation of its inputs, an
``Expand`` as ``basic.expand_op``, a ``Window`` as ``window.window_op``).

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
split (``_count_joins``, ``_count_heavy``), as in the JAX package. The
merge-join half of the JAX package's ``_apply_orderings`` is not ported.

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
import itertools
import time
import warnings
from typing import Callable, Dict, List, Optional, Tuple, Union

import numpy as np
import torch
from torch.profiler import record_function

from datafusion_comet_tpu_torch import types as T
from datafusion_comet_tpu_torch.conf import Config
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
from datafusion_comet_tpu_torch.exec.runtime_filter import inject_runtime_filters
from datafusion_comet_tpu_torch.exec.stats import (DEFAULT_MAX_GROUPS, TableStats, collect_stats,
                                                  derive_capacities)
from datafusion_comet_tpu_torch.exec.streaming import TiledAggregator, pseudo_scan, slice_tiles
from datafusion_comet_tpu_torch.ir import expr as E
from datafusion_comet_tpu_torch.ir import plan as P
from datafusion_comet_tpu_torch.ir.ordering import order_key_name, ordering_satisfies, out_ordering
from datafusion_comet_tpu_torch.ir.pruning import prune_columns
from datafusion_comet_tpu_torch.ir.serde import plan_to_json

__all__ = ["Session", "run_plan", "QueryExecutionError", "JoinOverflowError"]


# a semi or anti join's output is compacted to this many times its row
# estimate (the JAX package's margin for estimates from statistics; 2 for a
# runtime filter's)
_SEMI_MARGIN = 4


class QueryExecutionError(RuntimeError):
    """An ANSI-mode runtime error raised by the query (Spark's SparkError)."""


class JoinOverflowError(RuntimeError):
    """A join's fan-out or an aggregate's group capacity still overflowed
    after every retry."""


def run_plan(plan: P.PlanNode, tables: Dict[str, Batch], ctx: EvalContext, conf: Config,
             fanout: int) -> Batch:
    """Execute a bound plan over registered tables. ``fanout`` is the
    joins' K; their overflow flags go to ``ctx.overflow_flags``."""
    if isinstance(plan, P.Scan):
        b = tables[plan.table]
        if plan.projection is not None:
            b = b.select([b.schema.index_of(n) for n in plan.projection], plan.schema)
        return b
    if isinstance(plan, P.HashJoin):
        return _exec_hash_join(plan, tables, ctx, conf, fanout)
    if isinstance(plan, P.Union):
        # JAX ``engine.py:270-330``: dictionaries unified, mixed decimal
        # storage widened, strings padded to the widest input
        return concat_batches([run_plan(c, tables, ctx, conf, fanout) for c in plan.inputs],
                              plan.schema)
    if isinstance(plan, P.BroadcastNestedLoopJoin):
        left = run_plan(plan.left, tables, ctx, conf, fanout)
        right = run_plan(plan.right, tables, ctx, conf, fanout)
        if ctx.join_log is not None:
            ctx.join_log.append({"path": "nested_loop",
                                 "capacities": [left.capacity, right.capacity]})
        return J.nested_loop_join(left, right, plan.join_type, plan.schema, plan.condition,
                                  ctx)
    child = run_plan(plan.children()[0], tables, ctx, conf, fanout)
    if isinstance(plan, P.Filter):
        out = B.filter_op(child, plan.predicate, ctx)
        # a filter estimated to keep under an eighth of its capacity is
        # compacted to 4x its estimate (grown by the retry loop), so the
        # operators above run at the estimate (JAX ``engine.py:103-119``)
        est = plan.out_rows_hint
        if est:
            target = pad_capacity(max(4 * est, 1024) * ctx.agg_scale)
            if target * 8 <= out.capacity:
                out, covf = B.compact_batch(out, target)
                ctx.overflow_flags.append(covf)
        return out
    if isinstance(plan, P.Projection):
        return B.project_op(child, plan.exprs, plan.schema, ctx)
    if isinstance(plan, P.HashAggregate):
        return AGG.hash_aggregate(child, plan.group_exprs, plan.agg_exprs, plan.mode,
                                  plan.schema, ctx, conf.agg_dense_max_domain,
                                  plan.max_groups or DEFAULT_MAX_GROUPS,
                                  plan.group_key_ranges, plan.merge_rows)
    if isinstance(plan, P.Sort):
        return B.sort_op(child, plan.orders, plan.fetch, plan.skip, ctx)
    if isinstance(plan, P.Limit):
        return B.limit_op(child, plan.limit, plan.offset)
    if isinstance(plan, P.Expand):
        return B.expand_op(child, plan.projections, plan.schema, ctx)
    if isinstance(plan, P.Window):
        return W.window_op(child, plan.window_exprs, plan.schema, ctx)
    raise NotImplementedError(f"run_plan: {type(plan).__name__}")


def _exec_hash_join(plan: P.HashJoin, tables, ctx, conf, fanout) -> Batch:
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
    above run at the post-join size."""
    left = run_plan(plan.left, tables, ctx, conf, fanout)
    right = run_plan(plan.right, tables, ctx, conf, fanout)
    hint = plan.fanout_hint
    k = min(hint * ctx.agg_scale, 256) if hint else fanout
    compact_rows = None
    if plan.out_rows_hint and plan.join_type not in J.SEMI_LIKE:
        # the scale multiplies outside the floor, so a tiny wrong estimate
        # still grows on every retry
        lim = max(left.capacity, right.capacity) * 64
        compact_rows = pad_capacity(min(max(2 * plan.out_rows_hint, 4096) * ctx.agg_scale, lim))
    out, ovf = J.hash_join(left, right, plan.left_keys, plan.right_keys, plan.join_type,
                           plan.build_side, plan.schema, plan.condition,
                           max_build_matches=k, ctx=ctx,
                           build_key_range=plan.build_key_range,
                           unique_build=bool(plan.unique_build_hint) and ctx.unique_join_ok,
                           key_pack=plan.key_pack if ctx.unique_join_ok else None,
                           compact_rows=compact_rows, dense_range=plan.rf_dense_range,
                           cond_col_ranges=plan.cond_col_ranges)
    ctx.overflow_flags.append(ovf)
    if plan.join_type in J.SEMI_LIKE:
        est = plan.out_rows_hint
        if est and plan.join_type != P.JoinType.EXISTENCE:
            rf = plan.rf_dense_range is not None  # a runtime filter's exact key set
            target = pad_capacity(max((2 if rf else _SEMI_MARGIN) * est, 1024) * ctx.agg_scale)
            if target * 8 <= out.capacity:
                out, covf = B.compact_batch(out, target, tag="rf" if rf else None)
                ctx.overflow_flags.append(covf)
        return out
    grow = max(2, k // 2) * (1 if hint else ctx.agg_scale)
    target = pad_capacity(max(left.capacity, right.capacity) * grow)
    if target < out.capacity:
        out, covf = B.compact_batch(out, target)
        ctx.overflow_flags.append(covf)
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


def apply_orderings(plan: P.PlanNode) -> P.PlanNode:
    """A copy of the bound plan in which every Sort whose child already
    delivers its order (ir/ordering.py) is gone: replaced by its child, or
    by a Limit where it has a fetch or a skip (JAX ``engine.py:1386``, its
    Sort branch). The caller's tree is not changed."""
    for old in plan.children():
        new = apply_orderings(old)
        if new is not old:
            plan = replace_child_pure(plan, old, new)
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


def _is_join(plan: P.PlanNode) -> bool:
    return isinstance(plan, (P.HashJoin, P.BroadcastNestedLoopJoin))


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


def find_stream_agg(plan: P.PlanNode, tables) -> Optional[Tuple[P.HashAggregate, str]]:
    """The aggregate the JAX package would run tiled over the budget
    (JAX ``engine.py:1455``): a SINGLE HashAggregate over filters,
    projections and expands of one resident table, the one over the
    largest table; (aggregate, table) or None."""
    best = None

    def subtree_scan(p) -> Optional[str]:
        if isinstance(p, P.Scan):
            return p.table
        if not isinstance(p, (P.Filter, P.Projection, P.Expand)):
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
        self.plan_ms: Optional[float] = None
        self.subqueries: List[dict] = []
        self._ids = itertools.count()
        self._host_cols: Dict[str, HostColumns] = {}
        # registered scalar subqueries: (bound plan, column) by id, the id
        # of each (JSON, column), and, during a top-level execute, the values
        self._subquery_plans: List[Tuple[P.PlanNode, int]] = []
        self._subquery_keys: Dict[Tuple[str, int], int] = {}
        self._subquery_values: Optional[Dict[int, Tuple[object, bool]]] = None

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
        return device_budget_bytes(self.device, self.conf.memory_fraction)

    def scalar_subquery(self, plan: P.PlanNode, column: int = 0) -> E.ScalarSubquery:
        """Register an uncorrelated scalar subquery: the value of ``column``
        in its plan's first row, null where there is none (JAX
        ``engine.py:535``). Bound without pruning; structurally equal
        subqueries share one id, and so one run an ``execute``."""
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

    def _materialize_subqueries(self, plan: P.PlanNode) -> None:
        """Run each subquery ``plan`` holds that this top-level execute has
        not run yet, in id order (a subquery holds only earlier ones), and
        keep its value and its run's records (``subqueries``)."""
        for sid in sorted(subquery_ids(plan) - set(self._subquery_values)):
            sub, column = self._subquery_plans[sid]
            field = sub.schema.fields[column]
            # a fresh copy: the planner fills its hints in place
            out = self.execute(copy.deepcopy(sub))
            host = to_numpy(out.select([column], T.Schema([field])))
            rows = host[field.name]
            value = (rows[0], bool(host[field.name + "__valid"][0])) if len(rows) else (None, False)
            self._subquery_values[sid] = value
            self.subqueries.append({"id": sid, "value": value[0], "valid": value[1],
                                    "stages": self.stages, "runs": self.runs,
                                    "grace_runners": self.grace_runners, "tiled": self.tiled,
                                    "plan_ms": self.plan_ms})

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

    def _execute_stages(self, plan: P.PlanNode) -> Batch:
        self._materialize_subqueries(plan)
        t0 = time.perf_counter()
        self.stages = self._plan_stages(plan)
        self.plan_ms = (time.perf_counter() - t0) * 1e3
        self.grace_runners = []
        self.tiled = []
        self.runs = []
        temp_names: List[str] = [n for n, _ in self.stages if n]
        out = None
        try:
            for name, sub in self.stages:
                out = self._run_subtree(sub, temp_names)
                if name:
                    self.tables[name] = self._aqe_shrink(out)
            return out
        finally:
            for n in temp_names:  # free the temporary tables
                self.tables.pop(n, None)

    def collect(self, plan: P.PlanNode) -> Dict[str, np.ndarray]:
        return to_numpy(self.execute(plan))

    # -- stages --------------------------------------------------------------------
    def _plan_stages(self, plan: P.PlanNode) -> List[Tuple[Optional[str], P.PlanNode]]:
        """Prune, inject the runtime filters and bind (unless ``plan`` is
        bound; the injector keeps the hints pruning would not carry), fill
        the aggregates' capacities from statistics, drop the Sorts their
        input already satisfies (``apply_orderings``), and split:
        [(temporary table name, subplan)] in run order, the last one (None,
        the query's root)."""
        bound = plan if plan.schema is not None else P.bind_plan(
            inject_runtime_filters(prune_columns(plan), self))
        derive_capacities(bound, self.stats)
        bound = apply_orderings(bound)
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
    def _run_subtree(self, plan: P.PlanNode, temp_names: List[str]) -> Batch:
        return self._execute_retry(self._budget_plan(plan, temp_names))

    def _execute_retry(self, plan: Union[P.PlanNode, Callable[[EvalContext], Batch]],
                       tables: Optional[Dict[str, Batch]] = None, where: str = "stage") -> Batch:
        """Run ``plan``, again with the joins' fan-out and the growth scale
        four times larger while a capacity overflows; the joins' unique-build
        and key-packing hints hold on the first attempt only. ``plan`` is a
        bound plan, or a function that runs one attempt in the context it is
        given (the tiled aggregate's tiles, ``where="tiled"``)."""
        fanout, scale = J.JOIN_FANOUT, 1
        for attempt in range(J.MAX_JOIN_RETRIES):
            out, overflowed = self._run_once(plan, fanout, scale, tables,
                                             unique_join_ok=attempt == 0, where=where)
            if not overflowed:
                return out
            fanout *= 4
            scale *= 4
        raise JoinOverflowError(
            f"a join's fan-out or an aggregate's groups exceeded after {J.MAX_JOIN_RETRIES} retries")

    def _run_once(self, plan: Union[P.PlanNode, Callable[[EvalContext], Batch]], fanout: int,
                  scale: int, tables: Optional[Dict[str, Batch]] = None,
                  unique_join_ok: bool = True, where: str = "stage") -> Tuple[Batch, bool]:
        """One run of a bound plan (or of a function of the run's context):
        (result, whether a capacity overflowed). Every error and overflow
        flag of the run is read in one device-to-host copy at its end, and
        the run is recorded in ``runs``."""
        errs: List[Tuple[torch.Tensor, str]] = []
        ctx = EvalContext(errors=errs, overflow_flags=[], agg_scale=scale,
                          unique_join_ok=unique_join_ok, join_log=[],
                          subquery_values=self._subquery_values)
        out = (plan(ctx) if callable(plan) else
               run_plan(plan, self.tables if tables is None else tables, ctx, self.conf, fanout))
        flags = [f for f, _ in errs] + ctx.overflow_flags
        hit = torch.stack([f.any() for f in flags]).tolist() if flags else []
        fired = [m for (_, m), h in zip(errs, hit) if h]
        if fired:
            raise QueryExecutionError("; ".join(dict.fromkeys(fired)))
        overflowed = any(hit[len(errs):])
        self.runs.append({"where": where, "scale": scale, "unique_join_ok": unique_join_ok,
                          "overflowed": overflowed, "joins": ctx.join_log})
        return out, overflowed

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
                       budget: int, temp_names: List[str]) -> P.PlanNode:
        """Run ``agg`` tiled over ``table`` (exec/streaming.py), at the
        JAX package's tile count (``plan_tiles`` snapped to a power of two,
        at most an eighth of the capacity), with the overflow retry (each
        attempt a ``runs`` entry where "tiled"), register its result as a
        temporary table and put a scan of it in the aggregate's place."""
        batch = self.tables[table]
        tiles = max(plan_tiles(agg, batch.capacity, budget), 1)
        tiles = min(1 << max(int(tiles - 1).bit_length(), 0), max(batch.capacity // 8, 1))
        tmp = f"__budget{next(self._ids)}"
        temp_names.append(tmp)
        tiled = TiledAggregator(agg, table, self.conf)
        pieces = list(slice_tiles(batch, max(batch.capacity // tiles, 8)))
        with record_function("tiled.aggregate"):
            self.tables[tmp] = self._execute_retry(lambda ctx: tiled.run(pieces, ctx),
                                                   where="tiled")
        self.tiled.append((table, tiles))
        scan = pseudo_scan(tmp, self.tables[tmp].schema)
        return scan if agg is stage else replace_child_pure_deep(stage, agg, scan)

    def _budget_plan(self, stage: P.PlanNode, temp_names: List[str]) -> P.PlanNode:
        """While the stage's peak estimate is over the budget, run a
        SINGLE aggregate over one table tiled (``_tiled_rewrite``), else an
        over-budget join hash-partitioned (GraceJoinRunner), and splice its
        result back in as a temporary-table scan, in the JAX package's
        order. A stage over budget with neither proceeds with a warning
        (the estimate is conservative)."""
        for _ in range(16):  # each pass peels one over-budget subtree
            caps = [self.tables[t].capacity for t in P.scan_tables(stage) if t in self.tables]
            if not caps:
                break
            budget = self.budget_bytes()
            peak = plan_peak_bytes(stage, max(caps))
            if peak <= budget:
                break
            target = find_stream_agg(stage, self.tables)
            if target is not None:
                stage = self._tiled_rewrite(stage, *target, budget, temp_names)
                continue
            gj = G.find_grace_join(stage, self.tables, budget)
            if gj is None:
                warnings.warn(f"stage peak estimate {peak >> 20} MiB exceeds the memory budget "
                              f"{budget >> 20} MiB and has no partitionable join; proceeding")
                break
            jpeak = plan_peak_bytes(gj, max(self.tables[t].capacity for t in P.scan_tables(gj)
                                            if t in self.tables))
            K = 2
            while K * (budget // 2) < jpeak and K < G.GRACE_MAX_PARTITIONS:
                K *= 2
            ds = G.plan_grace_downstream(stage, gj)
            runner = G.GraceJoinRunner(self, gj, K, temp_names, stage=stage, downstream=ds)
            temp_names.append(runner.tmp)
            runner()
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

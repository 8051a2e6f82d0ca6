"""Grace (hash-partitioned) join execution (port of
``datafusion_comet_tpu/exec/grace.py``).

When a join's resident-bytes estimate is over the device budget
(exec/memory.py), the engine splits it into K hash partitions: both inputs
are partition-sorted by Spark's murmur3 of the join keys mod K (the stable
partition ``kernels.partition_columns``, a CUDA kernel on the card, moves
every column of a side into partition order in one pass), and the join then
runs K times, once per pair of partitions, at about 1/K of the size:
partition k of one side can only match partition k of the other. Each pair's
rows are slices of the two sorted sides, which replace the unsorted ones as
soon as they are made. The pair outputs are compacted and unioned; when an
aggregate sits above the join, either each pair runs the whole stage (its
groups are partition-local, possibly under a top-K root) or each pair emits
PARTIAL aggregate states and one FINAL aggregate merges them
(``plan_grace_downstream``).

Partition sizes are read on the host after the partition sort (K + 1
starts per side), so every pair's capacity is exact. The JAX package
compiles and caches each piece; here everything runs eagerly on every call.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from datafusion_comet_tpu_torch import types as T
from datafusion_comet_tpu_torch.exec.batch import (Batch, ColumnVector, concat_batches, map_buffers,
                                                  pad_capacity)
from datafusion_comet_tpu_torch.exec.evaluator import EvalContext, evaluate, murmur3_column
from datafusion_comet_tpu_torch.exec.memory import plan_peak_bytes
from datafusion_comet_tpu_torch.exec.operators import basic as BASIC
from datafusion_comet_tpu_torch.exec.operators import join as J
from datafusion_comet_tpu_torch.exec.stats import DEFAULT_MAX_GROUPS
from datafusion_comet_tpu_torch.exec.streaming import dead_batch, partial_schema, pseudo_scan
from datafusion_comet_tpu_torch.ir import expr as E
from datafusion_comet_tpu_torch.ir import plan as P
from datafusion_comet_tpu_torch.observability.trace import with_trace

__all__ = ["GraceJoinRunner", "find_grace_join", "plan_grace_downstream", "partition_sort",
           "hash_pids", "grace_key_cast", "GRACE_MAX_PARTITIONS"]

GRACE_MAX_PARTITIONS = 64

_INT_IDS = ("INT8", "INT16", "INT32", "INT64")


def grace_key_cast(ldt: T.DataType, rdt: T.DataType) -> Optional[T.DataType]:
    """The common hash type of one join-key pair (None: hash as they are),
    or ValueError when both sides cannot hash equal keys alike: integer
    keys of mixed widths hash as INT64; strings hash their bytes (a
    dictionary side decoded first), so equal strings of either encoding
    land in one partition; floats and decimals are refused."""
    for dt in (ldt, rdt):
        if not (dt.type_id in _INT_IDS or dt.type_id in ("DATE", "TIMESTAMP")
                or dt.is_boolean or dt.is_binary):
            raise ValueError(f"grace join: unhashable key dtype {dt.type_id}")
    if ldt.type_id == rdt.type_id:
        return None
    if ldt.type_id in _INT_IDS and rdt.type_id in _INT_IDS:
        return T.INT64
    raise ValueError(f"grace join: mixed key dtypes {ldt.type_id}/{rdt.type_id}")


def hash_pids(batch: Batch, keys: Sequence[E.Expr], casts, K: int,
              ctx: Optional[EvalContext] = None) -> torch.Tensor:
    """Partition id per row: murmur3 (seed 42) over the key columns, then
    Spark's pmod by K, the scheme of Spark's hash partitioner."""
    h = torch.full((batch.capacity,), 42, dtype=torch.int32, device=batch.device)
    for kexpr, tgt in zip(keys, casts):
        cv = evaluate(kexpr, batch, ctx)
        if tgt is not None and cv.dtype.type_id != tgt.type_id:
            cv = ColumnVector(cv.data.long(), cv.validity, None, tgt)
        h = murmur3_column(cv, h)
    return torch.remainder(h, K).int()  # the divisor's sign: pmod for K > 0


def partition_sort(batch: Batch, pids: torch.Tensor, K: int,
                   errors: Optional[List[Tuple[torch.Tensor, str]]] = None
                   ) -> Tuple[Batch, torch.Tensor]:
    """(sorted batch, starts int64 (K + 1,)): the rows ordered by partition
    id, stably, dead rows last, every column and the row mask moved by one
    call of the partition kernel; partition k is rows [starts[k],
    starts[k+1]). Bounds do not carry over, as in the JAX package."""
    key = torch.where(batch.row_mask, pids, K).int()
    out, sizes = BASIC.partition_batch(batch, key, K, errors=errors)
    return out, torch.cat([sizes.new_zeros(1), sizes[:K].cumsum(0)])


def _extract(b: Batch, start: int, end: int, cap: int) -> Batch:
    """Partition rows [start, end) of the partition-sorted ``b`` as a
    ``cap``-row batch: a slice of every column, padded with dead rows where
    ``b`` ends first."""
    stop = min(start + cap, b.capacity)
    pad = cap - (stop - start)

    def cut(t: torch.Tensor) -> torch.Tensor:
        t = t[start:stop]
        return torch.cat([t, t.new_zeros((pad,) + tuple(t.shape[1:]))]) if pad else t

    cols = tuple(dataclasses.replace(map_buffers(c, cut), mag_bound=c.mag_bound)
                 for c in b.columns)
    return Batch(cols, torch.arange(cap, device=b.device) < end - start, b.schema)


def find_grace_join(stage: P.PlanNode, tables, budget: int, scale: int = 1,
                    margin: float = 2) -> Optional[P.HashJoin]:
    """Topmost HashJoin whose subtree estimate at growth ``scale`` exceeds
    ``margin`` times the budget (the estimate sums every operator's output,
    so a margin of two keeps estimate noise from partitioning) and whose
    keys hash alike on both sides. A SortMergeJoin is never taken, as in
    the JAX package (its ``grace.py:146``)."""

    def walk(p) -> Optional[P.HashJoin]:
        if isinstance(p, P.HashJoin) and p.join_type != P.JoinType.LEFT_ANTI_NULL_AWARE:
            caps = [tables[t].capacity for t in P.scan_tables(p) if t in tables]
            if caps and plan_peak_bytes(p, max(caps), scale) > margin * budget:
                try:
                    for lk, rk in zip(p.left_keys, p.right_keys):
                        grace_key_cast(lk.dtype, rk.dtype)
                except ValueError:
                    pass
                else:
                    return p
        for c in p.children():
            hit = walk(c)
            if hit is not None:
                return hit
        return None

    return walk(stage)


def _src_name(e: E.Expr):
    while isinstance(e, (E.Alias, E.Cast)):
        e = e.child
    if isinstance(e, (E.ColumnRef, E.BoundRef)):
        return e.col_name
    return None


def plan_grace_downstream(stage: P.PlanNode, gj: P.HashJoin):
    """Whether the stage's operators above the join can run inside each
    pair instead of over the union of the pairs' outputs:

    * ("local", A): the one SINGLE HashAggregate A groups by a join key, so
      its groups are partition-local and the whole stage runs per pair. Only
      filters and projections may sit above A, or a top-K Sort root over
      them (``root_sort_ok``): then each pair keeps its own top-K and the
      sort runs again over the union; else the union of the pair outputs is
      the stage output.
    * ("partial", A): any other grouping: each pair emits A's PARTIAL states
      and a FINAL aggregate merges them, unless A may hold more than 2^20
      groups (K pairs of such partials would be the join's size again).
    * None: no pushdown; the pair join outputs are unioned.
    """
    chain: List[P.PlanNode] = []
    node = stage
    while node is not gj:
        kids = node.children()
        if len(kids) != 1:
            return None  # another join above gj
        chain.append(node)
        node = kids[0]
    aggs = [n for n in chain if isinstance(n, P.HashAggregate)]
    if len(aggs) != 1 or aggs[0].mode != P.AggMode.SINGLE:
        return None
    A = aggs[0]
    ai = chain.index(A)
    if not all(isinstance(n, (P.Filter, P.Projection)) for n in chain[ai + 1:]):
        return None
    above = chain[:ai]

    def at_join(name):
        """A group key's source column name at the join output."""
        cur = name
        for n in chain[ai + 1:]:
            if isinstance(n, P.Projection):
                src = None
                for x in n.exprs:
                    if x.name == cur:
                        src = _src_name(x)
                if src is None:
                    return None
                cur = src
        return cur

    keynames = {nm for nm in (_src_name(k) for k in list(gj.left_keys) + list(gj.right_keys))
                if nm}
    local = False
    for g in A.group_exprs:
        nm = _src_name(g)
        nm = at_join(nm) if nm else None
        if nm and nm in keynames:
            local = True
            break
    root_sort_ok = (isinstance(stage, P.Sort) and bool(stage.fetch)
                    and all(isinstance(n, (P.Filter, P.Projection)) for n in above[1:]))
    chain_ok = all(isinstance(n, (P.Filter, P.Projection)) for n in above)
    if local and (root_sort_ok or chain_ok):
        return ("local", A)
    try:  # every aggregate function needs partial states
        partial_schema(A)
    except NotImplementedError:
        return None
    if (A.max_groups or DEFAULT_MAX_GROUPS) > (1 << 20):
        return None
    return ("partial", A)


class GraceJoinRunner:
    """Runs one HashJoin hash-partitioned into K pairs and registers the
    result (the union, or the FINAL aggregate of the pairs' partial states)
    as the temporary table ``tmp``. Calling it again re-runs all of it."""

    def __init__(self, session, join: P.HashJoin, K: int, temp_names: List[str],
                 stage: Optional[P.PlanNode] = None, downstream=None):
        self.session = session
        self.join = join
        self.K = K
        self.stage = stage
        self.downstream = downstream  # None | ("local" | "partial", aggregate node)
        sid = next(session._ids)
        self.tmp = f"__grace{sid}"
        self.gl = f"__gracel{sid}"
        self.gr = f"__gracer{sid}"
        self.temp_names = temp_names
        if downstream is None:
            self.out_schema = join.schema
        elif downstream[0] == "local":
            self.out_schema = stage.schema
        else:
            self.out_schema = downstream[1].schema
        self.template: Optional[P.PlanNode] = None  # each pair's plan, set by a run
        # what the last run saw: each side's capacity and partition sizes,
        # the pair retries and the pairs' join output capacities summed
        self.capacities: Optional[Tuple[int, int]] = None
        self.sizes: Optional[Tuple[np.ndarray, np.ndarray]] = None
        self.retries = 0
        self.pair_rows = 0
        self._finish_key = object()  # the FINAL merge's attempt under Session.prepare
        self.rebudget = False  # made for a re-run held to the budget (Session._rebudget)

    def _mini_plan(self) -> P.HashJoin:
        """The join over two temporary tables holding one pair, with the
        join's hints (build-key range, fan-out, unique build, key packing,
        a runtime filter's key range, the condition columns' ranges) and a
        K-th of its row estimate (at least 2048), as in the JAX package:
        each pair takes the whole join's path."""
        j = self.join
        est = max(j.out_rows_hint // self.K, 2048) if j.out_rows_hint else None
        mini = P.HashJoin(pseudo_scan(self.gl, j.left.schema), pseudo_scan(self.gr, j.right.schema),
                          j.left_keys, j.right_keys, j.join_type, j.build_side, j.condition,
                          j.build_key_range, est, j.fanout_hint, j.unique_build_hint, j.key_pack,
                          j.rf_dense_range, cond_col_ranges=j.cond_col_ranges)
        mini.schema = j.schema
        return mini

    def _build_template(self, pair_bound: int) -> P.PlanNode:
        """Each pair's plan: the mini join alone, the whole stage over it
        (local), or the aggregate's PARTIAL run over it (partial). Its
        aggregate holds at most ``pair_bound`` groups (twice the largest
        partition, padded); under a top-K root each pair keeps skip + fetch
        rows, and the skip applies to the union."""
        from datafusion_comet_tpu_torch.exec.engine import replace_child_pure_deep

        mini = self._mini_plan()
        if self.downstream is None:
            return mini
        mode, A = self.downstream
        max_groups = min(A.max_groups or pair_bound, pair_bound)
        if mode == "local":
            stage = replace_child_pure_deep(self.stage, self.join, mini)  # copies the path
            agg = stage
            while not isinstance(agg, P.HashAggregate):
                agg = agg.children()[0]
            agg.max_groups = max_groups
            if isinstance(stage, P.Sort) and stage.skip:
                stage.fetch = (stage.fetch or 0) + stage.skip
                stage.skip = 0
            return stage
        child = mini if A.child is self.join else replace_child_pure_deep(A.child, self.join, mini)
        partial = P.HashAggregate(child, A.group_exprs, A.agg_exprs, P.AggMode.PARTIAL,
                                  max_groups, A.group_key_ranges)
        partial.schema = partial_schema(A)
        return partial

    def _finish(self, union: Batch) -> Batch:
        """After the union: nothing (plain and local modes), or the FINAL
        aggregate of the partial states at A's group capacity, on whichever
        path its keys take, re-run four times larger while its groups
        overflow."""
        if self.downstream is None or self.downstream[0] == "local":
            return union
        _, A = self.downstream
        groups = tuple(E.bind(E.col(g.name), self.template.schema) for g in A.group_exprs)
        node = P.HashAggregate(pseudo_scan("__acc", union.schema), groups, A.agg_exprs,
                               P.AggMode.FINAL, A.max_groups, A.group_key_ranges,
                               merge_rows=self.pair_rows)
        node.schema = A.schema
        return self.session._execute_retry(node, {"__acc": union}, key=self._finish_key)

    def __call__(self) -> None:
        # the spans name the runner's phases in a torch.profiler trace; with
        # no profiler running each costs about a microsecond
        s = self.session
        j = self.join
        K = self.K
        with with_trace("grace.inputs"):
            sides = [s._aqe_shrink(s._run_subtree(side, self.temp_names))
                     for side in (j.left, j.right)]
        self.capacities = (sides[0].capacity, sides[1].capacity)
        with with_trace("grace.partition"):
            left, right, sl, sr = self._partition(sides)
        self.sizes = (np.diff(sl), np.diff(sr))
        self.template = self._build_template(pad_capacity(
            2 * max(int(self.sizes[0].max(initial=0)), int(self.sizes[1].max(initial=0)), 8)))
        with with_trace("grace.pairs"):
            outs = self._run_pairs(left, right, sl, sr)
        with with_trace("grace.finish"):
            live = [o for o in outs if o is not None]
            if not live:
                s.tables[self.tmp] = dead_batch(self.out_schema, 8, s.device)
                return
            union = live[0] if len(live) == 1 else concat_batches(live, self.template.schema)
            s.tables[self.tmp] = self._finish(union)

    def _partition(self, sides: List[Batch]):
        """Partition-sort both sides, taking each out of ``sides`` so that
        its unsorted copy is freed once the sorted one exists: (left, right,
        starts_l, starts_r), the K + 1 starts read with every error flag in
        one host read."""
        j, K = self.join, self.K
        casts = [grace_key_cast(lk.dtype, rk.dtype) for lk, rk in zip(j.left_keys, j.right_keys)]
        errs: List[Tuple[torch.Tensor, str]] = []
        ctx = EvalContext(errors=errs)
        out = []
        for keys in (j.left_keys, j.right_keys):
            b = sides.pop(0)
            out.append(partition_sort(b, hash_pids(b, keys, casts, K, ctx), K, errs))
            del b
        (left, starts_l), (right, starts_r) = out
        host = torch.cat([starts_l, starts_r] + [f.any().long().view(1) for f, _ in errs]).tolist()
        fired = [m for (_, m), hit in zip(errs, host[2 * K + 2:]) if hit]
        if fired:
            from datafusion_comet_tpu_torch.exec.engine import QueryExecutionError

            raise QueryExecutionError("; ".join(dict.fromkeys(fired)))
        return left, right, np.array(host[:K + 1]), np.array(host[K + 1:2 * K + 2])

    def _run_pairs(self, left: Batch, right: Batch, sl: np.ndarray, sr: np.ndarray
                   ) -> List[Optional[Batch]]:
        """Each non-empty pair's output, with the pair retry: a pair whose
        join overflowed runs again with the fan-out and the growth scale
        four times larger, and without the unique-build and key-packing
        hints. ``pair_rows``: the pairs' join output capacities summed (a
        semi-like join's is its probe side's), which bound the rows behind
        any group of the partial states."""
        s, K = self.session, self.K
        sizes_l, sizes_r = self.sizes
        outs: List[Optional[Batch]] = [None] * K
        # under Session.prepare a call starts at the warm-up's settled
        # attempt, and an overflow there raises
        settled = s._settled(self)
        fanout, scale, first = settled or (J.JOIN_FANOUT, 1, 0)
        # partial mode always runs pair 0, so an ungrouped aggregate still
        # emits its one row
        force_k0 = self.downstream is not None and self.downstream[0] == "partial"
        self.retries = first
        self.pair_rows = 0
        grown: dict = {}  # the capacities the pairs' attempts counted
        for attempt in range(first, J.MAX_JOIN_RETRIES):
            overflowed = False
            for k in range(K):
                if outs[k] is not None or (sizes_l[k] == 0 and sizes_r[k] == 0
                                           and not (force_k0 and k == 0)):
                    continue
                cap_l = pad_capacity(max(int(sizes_l[k]), 8))
                cap_r = pad_capacity(max(int(sizes_r[k]), 8))
                s.tables[self.gl] = _extract(left, int(sl[k]), int(sl[k + 1]), cap_l)
                s.tables[self.gr] = _extract(right, int(sr[k]), int(sr[k + 1]), cap_r)
                # the last attempt takes the counted capacities (ROADMAP C24)
                out, ovf = s._run_once(self.template, fanout, scale,
                                       unique_join_ok=scale == 1, where="pair", grown=grown,
                                       floors=attempt == J.MAX_JOIN_RETRIES - 1)
                if ovf and settled and s._replay:
                    from datafusion_comet_tpu_torch.exec.engine import JoinOverflowError

                    raise JoinOverflowError(
                        f"a prepared grace pair overflowed its settled capacities (scale "
                        f"{scale}); the tables changed since prepare")
                if ovf:
                    overflowed = True
                    continue
                self.pair_rows += max([cap_l, cap_r] + [j.get("out_capacity", 0)
                                                        for j in s.runs[-1]["joins"]])
                outs[k] = s._aqe_shrink(out)
            if not overflowed:
                break
            fanout *= 4
            scale *= 4
            self.retries += 1
        else:
            from datafusion_comet_tpu_torch.exec.engine import JoinOverflowError

            raise JoinOverflowError(
                f"grace join fan-out exceeded after {J.MAX_JOIN_RETRIES} retries")
        s._settle(self, fanout, scale, self.retries)
        s.tables.pop(self.gl, None)
        s.tables.pop(self.gr, None)
        return outs

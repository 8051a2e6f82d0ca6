#!/usr/bin/env python3
"""Warm latency, peak device memory, kernel launches, retries, runtime
filters, planning host time and (with ``--profile``) device-time
breakdowns of TPC-H Q1, Q6, Q12, Q3, Q4, Q15, Q5, Q10, Q18, Q2, Q9, Q19,
Q13, Q16, Q20, Q21 and Q22 (all but Q1, Q6 and Q15 directly, and through
the grace join at K = 16, the budget ``grace_fraction`` finds) for the port
in any checkout; a checkout whose port lacks Q3, Q4 and Q15, Q5, Q10 and
Q18, Q2, Q9 and Q19, Q13, Q16 and Q20, or Q21 and Q22, runs the others.
``--suite tpcds`` runs the checkout's ported TPC-DS queries instead
(``models.tpcds.QUERIES``, all 24 tables at ``--sf``, the TPC-DS generator's
scale), each directly and, where it holds a hash join, under the budget
``grace_fraction`` finds for it.
Each checkout runs in its own process, so two of them can be compared in
turns on one card:

    python3 datafusion_comet_tpu_torch/tools/query_times.py [--tree DIR] [--sf 1] [--profile]
        [--queries q3,q5,q10] [--suite tpch|tpcds]

DIR (default: the checkout holding this file) goes first on sys.path, and
only the port's public entry points are called (``Session``, ``Config``,
``models.tpch``, ``exec.memory``, the kernel wrappers' launch counts). One
JSON line per query: the median and every one of ``--reps`` warm runs
(host clock, each ending in a device sync), the peak device memory of one
run, and of one run the launches of each kernel wrapper and the retries
(the plan runs that overflowed a capacity and ran again, grace pairs
and tiled aggregates included), the runtime filters injected (each one's key count) and the
median host ms of ``_plan_stages`` over the warm runs (where the
checkout's ``Session`` records them). With ``--profile``, one torch.profiler run of each run: wall
ms, the device kernels and host events it recorded, device busy ms and idle share, the device
ms of index gathers (advanced indexing and
index_select kernels), of scatter_reduce, of the partition kernels (B3), of
sort kernels, the top kernels, the host ms of the grace runner's spans, and
the host and device ms of the sorted aggregate's ``aggregate.sort`` span
(its sort and gathers).
"""

from __future__ import annotations

import argparse
import copy
import json
import statistics
import subprocess
import sys
import time
import warnings
from pathlib import Path

GRACE_K = 16
# kernel-name fragments of each device-time class of the profile
CLASSES = {
    "index_gather": ("index_elementwise_kernel", "vectorized_gather_kernel", "indexSelect"),
    "scatter_reduce": ("_scatter_gather_elementwise_kernel",),
    "partition": ("b3_", "partition_"),
    "sort": ("RadixSort", "radixSort", "bitonicSort", "sortKeyValue"),
}
SPANS = ("grace.", "aggregate.", "tiled.")  # the port's record_function spans


def grace_session(sess, fraction: float):
    """A session over ``sess``'s device tables and statistics whose memory
    budget is ``fraction`` of the card. A plan that holds scalar subqueries
    is built for the session that runs it (``tpcds.plan(q, session)``): its
    subqueries then run under that session's budget."""
    from datafusion_comet_tpu_torch.conf import Config
    from datafusion_comet_tpu_torch.exec.engine import Session

    s = Session(sess.device, Config(memory_fraction=fraction))
    for t, b in sess.tables.items():
        s.register_batch(t, b)
    if hasattr(sess, "stats"):
        s.stats.update(sess.stats)
    return s


def grace_fraction(sess, plan, K: int = GRACE_K):
    """(fraction, jpeak): the Config(memory_fraction) under which a run of
    the plan splits a join into K partitions (K >= 8), and the peak
    estimate jpeak of the first stage's top join (Q5's first stage joins
    lineitem, orders and customer). The engine doubles K from 2 until
    K x budget / 2 covers a join's peak, so a budget of 3 x jpeak / K,
    inside [2 jpeak / K, 4 jpeak / K), stops it at K.

    The estimate counts every operator at the largest capacity the join
    reads. Where a side of the join is an aggregate the budget runs tiled
    first, and the join reads that largest table only there (Q20's sums
    over lineitem), the capacity it is partitioned at is the tiled
    result's, known only from a run (the tiled run re-runs larger where its
    groups overflow). Then grace runs read the K taken and scale the
    fraction by K taken / K wanted (K doubles as the budget halves), or
    halve it where no join was partitioned, until a run takes K;
    RuntimeError after four runs. The first stage is the plan's, or, where
    its stages join nothing (q88's one-row projection), its first scalar
    subquery's."""
    from datafusion_comet_tpu_torch.exec import engine
    from datafusion_comet_tpu_torch.exec.memory import device_budget_bytes, plan_peak_bytes
    from datafusion_comet_tpu_torch.ir import plan as P

    def top_join(node):
        """The first HashJoin in pre-order, as the engine's find_grace_join
        walks (a Union's first input first)."""
        if isinstance(node, P.HashJoin):
            return node
        return next((j for j in map(top_join, node.children()) if j), None)

    def below_filters(node):
        while isinstance(node, (P.Filter, P.Projection)):
            node = node.child
        return node

    stages = sess._plan_stages(plan)
    # a checkout from before the scalar subqueries has no subquery_ids
    for sid in sorted(getattr(engine, "subquery_ids", lambda p: ())(plan)):
        stages += sess._plan_stages(copy.deepcopy(sess.subquery_plan(sid)))
    node = next(j for j in (top_join(sub) for _, sub in stages) if j)
    read = P.scan_tables(node)
    cap = max(sess.tables[t].capacity for t in read)
    jpeak = plan_peak_bytes(node, cap)
    fraction = 3 * jpeak / K / device_budget_bytes(sess.device, 1.0)
    # a checkout from before the tiled aggregate has no find_stream_agg
    find = getattr(engine, "find_stream_agg", None)
    tiled = find and find(node, sess.tables)
    if not tiled or not any(tiled[0] is below_filters(side) for side in (node.left, node.right)):
        return fraction, jpeak
    for t in P.scan_tables(tiled[0]):
        read.remove(t)
    if max((sess.tables[t].capacity for t in read), default=0) >= cap:
        return fraction, jpeak
    for _ in range(4):
        g = grace_session(sess, fraction)
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")  # over-budget stages proceed with a warning
            g.execute(plan)
        ks = [r.K for r in g.grace_runners]
        if K in ks:
            return fraction, jpeak
        fraction *= ks[0] / K if ks else 0.5
    raise RuntimeError(f"no memory fraction found that partitions a join into K = {K}")


WRAPPERS = ("bucket_count", "bucket_sum", "partition_columns", "partition_sort")


def hash_joins(plan, sess=None) -> int:
    """The HashJoin nodes of a plan, and with ``sess`` those of the scalar
    subqueries it holds there."""
    from datafusion_comet_tpu_torch.exec import engine
    from datafusion_comet_tpu_torch.ir import plan as P

    subs = ([sess.subquery_plan(i) for i in getattr(engine, "subquery_ids", lambda p: ())(plan)]
            if sess is not None else [])
    return (int(isinstance(plan, P.HashJoin)) + sum(map(hash_joins, plan.children()))
            + sum(map(hash_joins, subs)))


def launches_and_retries(sess, plan):
    """Of one run: each kernel wrapper's launches, and the runs of a plan
    (a stage, a grace pair or a tiled aggregate) that overflowed and ran
    again."""
    from datafusion_comet_tpu_torch.exec import kernels as K

    runs = []
    run_once = sess._run_once

    def counted(*a, **kw):
        out = run_once(*a, **kw)
        runs.append(bool(out[1]))
        return out

    sess._run_once = counted
    for w in WRAPPERS:
        getattr(K, w).launches = 0
    try:
        sess.collect(plan)
    finally:
        del sess._run_once
    return {w: getattr(K, w).launches for w in WRAPPERS}, sum(runs)


def warm_times(sess, plan, reps: int):
    """(median ms, all ms, peak bytes of one run, median planning host ms or
    None) after one warm-up run."""
    import torch

    sess.collect(plan)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    times, plans = [], []
    for _ in range(reps):
        t0 = time.perf_counter()
        sess.collect(plan)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
        plans.append(getattr(sess, "plan_ms", None))
    plan_ms = statistics.median(plans) if None not in plans else None
    return statistics.median(times), times, torch.cuda.max_memory_allocated(), plan_ms


def runtime_filters(sess):
    """Key counts of the runtime filters of the session's last run, or None
    where the checkout's port has none."""
    try:
        from datafusion_comet_tpu_torch.exec.runtime_filter import injected_filters
    except ImportError:
        return None
    return [f["keys"] for f in injected_filters(sess)]


def profile(sess, plan):
    """One warm run under torch.profiler: wall, busy, idle share, device ms
    by class (CLASSES), the top 12 kernels, the grace spans' host ms and the
    aggregate.sort span's host ms and device ms (its extent on the device's
    timeline, where the profiler records one)."""
    import torch
    from torch.profiler import ProfilerActivity, profile as torch_profile

    sess.collect(plan)
    torch.cuda.synchronize()
    with torch_profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        sess.collect(plan)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    events = prof.key_averages()
    rows = sorted(((ev.self_device_time_total / 1e3, ev.key, ev.count) for ev in events
                   if ev.device_type == torch.autograd.DeviceType.CUDA
                   and ev.self_device_time_total and not ev.key.startswith(SPANS)),
                  reverse=True)
    busy = sum(r[0] for r in rows)
    out = {"wall_ms": wall_ms, "device_events": sum(r[2] for r in rows),
           "host_events": sum(ev.count for ev in events
                              if ev.device_type == torch.autograd.DeviceType.CPU),
           "device_busy_ms": busy,
           "device_idle_share": 1 - busy / wall_ms if wall_ms else None}
    for name, frags in CLASSES.items():
        hit = [r for r in rows if any(f in r[1] for f in frags)]
        out[f"{name}_ms"] = sum(r[0] for r in hit)
        out[f"{name}_calls"] = sum(r[2] for r in hit)
    out["grace_span_host_ms"] = {ev.key: ev.cpu_time_total / 1e3 for ev in events
                                 if ev.device_type == torch.autograd.DeviceType.CPU
                                 and ev.key.startswith("grace.")}
    for ev in events:
        if ev.key == "aggregate.sort":
            side = "host" if ev.device_type == torch.autograd.DeviceType.CPU else "device"
            t = ev.cpu_time_total if side == "host" else ev.self_device_time_total
            out[f"aggregate_sort_{side}_ms"] = t / 1e3
            out["aggregate_sort_calls"] = ev.count
    out["top"] = [{"kernel": k[:90], "device_ms": ms, "calls": c} for ms, k, c in rows[:12]]
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--tree", type=Path, default=Path(__file__).resolve().parents[2],
                    help="the checkout whose port is timed (default: this one)")
    ap.add_argument("--sf", type=float, default=1.0, help="the suite's scale factor")
    ap.add_argument("--reps", type=int, default=7, help="warm runs per query")
    ap.add_argument("--profile", action="store_true",
                    help="add a profile of every run")
    ap.add_argument("--queries", default="",
                    help="comma-separated queries to run (q3 runs q3_direct and q3_grace); "
                         "default every one the tree has")
    ap.add_argument("--suite", choices=("tpch", "tpcds"), default="tpch",
                    help="TPC-H (default) or the ported TPC-DS queries")
    args = ap.parse_args(argv)
    tree = args.tree.resolve()
    sys.path.insert(0, str(tree))

    import torch

    if not torch.cuda.is_available():
        print("query_times: no CUDA card visible", file=sys.stderr)
        return 2
    from datafusion_comet_tpu_torch.exec.engine import Session
    from datafusion_comet_tpu_torch.models import tpch

    if not Path(tpch.__file__).resolve().is_relative_to(tree):
        raise RuntimeError(f"imported {tpch.__file__}, not the port in {tree}")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    print(json.dumps({"tree": str(tree), "suite": args.suite, "sf": args.sf, "nvidia_smi": smi}),
          flush=True)

    def grace(plan):
        return grace_session(sess, grace_fraction(sess, plan)[0])

    if args.suite == "tpcds":
        from datafusion_comet_tpu_torch.models import tpcds

        sess = Session()
        for t in tpcds.SCHEMAS:
            sess.register_numpy(t, tpcds.generate_table(t, args.sf), tpcds.SCHEMAS[t])
        runs = []
        # a checkout from before the scalar subqueries has no tpcds.plan
        build = getattr(tpcds, "plan", lambda q, s: tpcds.QUERIES[q]())
        for q in tpcds.QUERIES:
            runs.append((f"{q}_direct", sess, build(q, sess)))
            # a plan of nested-loop joins alone has no join to split; q88's
            # joins are its subqueries', and its plan is built for each session
            if hash_joins(build(q, sess), sess):
                g = grace(build(q, sess))
                runs.append((f"{q}_grace", g, build(q, g)))
        return _report(runs, args)
    has_q3, has_q4, has_q5 = hasattr(tpch, "q3"), hasattr(tpch, "q4"), hasattr(tpch, "q5")
    has_q18, has_q9, has_q13 = hasattr(tpch, "q18"), hasattr(tpch, "q9"), hasattr(tpch, "q13")
    has_q21 = hasattr(tpch, "q21")
    sess = Session()
    for t in (("lineitem", "orders") + (("customer",) if has_q3 else ())
              + (("supplier",) if has_q4 else ()) + (("nation", "region") if has_q5 else ())
              + (("part", "partsupp") if has_q9 else ())):
        sess.register_numpy(t, tpch.generate_table(t, args.sf), tpch.SCHEMAS[t])

    runs = [("q1", sess, tpch.q1()), ("q6", sess, tpch.q6()), ("q12_direct", sess, tpch.q12()),
            ("q12_grace", grace(tpch.q12()), tpch.q12())]
    if has_q3:
        runs += [("q3_direct", sess, tpch.q3()), ("q3_grace", grace(tpch.q3()), tpch.q3())]
    if has_q4:
        runs += [("q4_direct", sess, tpch.q4()), ("q4_grace", grace(tpch.q4()), tpch.q4()),
                 ("q15", sess, tpch.q15())]
    if has_q5:
        runs += [("q5_direct", sess, tpch.q5()), ("q5_grace", grace(tpch.q5()), tpch.q5())]
    for q in ((("q10", "q18") if has_q18 else ()) + (("q2", "q9", "q19") if has_q9 else ())
              + (("q13", "q16", "q20") if has_q13 else ()) + (("q21", "q22") if has_q21 else ())):
        plan = getattr(tpch, q)()
        runs += [(f"{q}_direct", sess, plan), (f"{q}_grace", grace(plan), plan)]
    return _report(runs, args)


def _report(runs, args) -> int:
    """One line per run of ``runs`` ((name, session, plan) each, those
    ``--queries`` keeps), then its profile with ``--profile``."""
    if args.queries:
        keep = set(args.queries.split(","))
        runs = [r for r in runs if r[0].split("_")[0] in keep]
    for name, s, plan in runs:
        ms, times, peak, plan_ms = warm_times(s, plan, args.reps)
        launches, retries = launches_and_retries(s, plan)
        line = {"query": name, "warm_ms": ms, "warm_ms_all": times, "peak_mem_bytes": peak,
                "launches": launches, "retries": retries, "runtime_filters": runtime_filters(s),
                "plan_ms": plan_ms}
        # a run's grace joins, its scalar subqueries' first
        runners = [r for sq in getattr(s, "subqueries", []) for r in sq["grace_runners"]]
        runners += s.grace_runners
        if name.endswith("_grace") and runners:
            # the first runner to finish, and every runner's K and mode
            r = runners[0]
            line.update(K=r.K, mode=r.downstream and r.downstream[0],
                        sizes=[x.tolist() for x in r.sizes],
                        grace=[{"K": g.K, "mode": g.downstream and g.downstream[0]}
                               for g in runners], tiled=getattr(s, "tiled", []),
                        tiled_attempts=[[r["scale"], r["overflowed"]] for r in
                                        getattr(s, "runs", []) if r["where"] == "tiled"])
        print(json.dumps(line), flush=True)
    if args.profile:
        for name, s, plan in runs:
            print(json.dumps({"profile": name, **profile(s, plan)}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

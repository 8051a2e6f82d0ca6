#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port (datafusion_comet_tpu_torch).

On a machine with one NVIDIA card, from the root of a checkout:

    python3 chip_smoke.py            # TPC-H SF1
    python3 chip_smoke.py --sf 10    # another scale
    python3 chip_smoke.py --profile  # add torch.profiler breakdowns of Q1 and Q12's grace run

Phases, one JSON line each:
  1. device: the card's name, count, and nvidia-smi's name and power limit;
  2. build: compiles the CUDA sources in csrc/ with nvcc, one process each,
     all started together, and prints ptxas's registers, shared memory and
     spills for each kernel (each bucket-kernel layout apart);
  3. kernels: holds bucket_count and bucket_sum against their plain PyTorch
     versions, exactly, on the card, at Q1's shape and at every layout
     boundary of kernels.bucket_layout, ragged and misaligned inputs
     included; times wrapper, plain version and one library call at Q1's
     shape (the sum at four lanes and at one), with L2 flushed before each
     timed run (tools/bucket_times.py's timing);
  4. q1, q6, q12: runs each query through the port's Session, checks the
     result against an exact integer oracle written with numpy alone, and
     reports warm time, peak device memory and the kernel launch counts of
     one run with the counts zeroed just before it. Q12 runs twice:
     directly, and under a Config(memory_fraction) that makes the engine
     split its join into K = 16 hash partitions (the grace join);
  grace_pair_kernels: times both bucket kernels at the grace run's pair
     shape (a pair's block, B = 16, its mean live rows);
  5. partition: holds partition_sort against its plain version, exactly, at
     the shapes Q12's grace run gave it, at the TPU kernel's probe shape
     (tile-local) and at edge shapes; times kernel, plain version and
     torch.sort at Q12's shapes, with L2 flushed.
Then a {"kernels": [...]} line, nvidia-smi's line, and last
{"ok": true, "device": {...}}. Any failure raises and exits non-zero. The
script imports no JAX; without a card, or without the package beside it, it
exits non-zero and prints no result.
"""

from __future__ import annotations

import argparse
import concurrent.futures
import json
import re
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent
REPLACES = {
    "bucket_count": "datafusion_comet_tpu/exec/pallas_kernels.py:43",
    "bucket_sum": "datafusion_comet_tpu/exec/pallas_kernels.py:84",
    "partition_sort": "benchmarks/pallas_scatter_probe.py:62",
}
SOURCES = {
    "bucket_count": "datafusion_comet_tpu_torch/csrc/bucket_kernels.cu",
    "bucket_sum": "datafusion_comet_tpu_torch/csrc/bucket_kernels.cu",
    "partition_sort": "datafusion_comet_tpu_torch/csrc/partition_kernels.cu",
}
KERNELS = tuple(REPLACES)
GRACE_K = 16  # the partition count the grace run of Q12 is sized to


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


# ---- phase 3: kernels against their plain versions -----------------------------------


def ptxas_by_kernel(log: str):
    """nvcc's ptxas line (registers, static shared memory, spills) for each
    kernel in a build log, the bucket kernels named by their layout."""
    from datafusion_comet_tpu_torch.exec import kernels as K

    out, fn = {}, None
    for ln in log.splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", ln)
        if m:
            fn = m.group(1)
            v = re.search(r"bucket_kernelILi(\d+)E", fn)
            fn = f"bucket_kernel<{K.LAYOUTS[int(v.group(1))]}>" if v else fn
        elif fn and ("registers" in ln or "spill" in ln):
            out.setdefault(fn, []).append(ln.split(":", 1)[-1].strip())
    return out


def time_buckets(K, codes, vals, B: int, reps: int, flush,
                 which=("bucket_count", "bucket_sum")):
    """Wrapper, plain and library times of bucket_count over ``codes`` and of
    bucket_sum over (k, n) ``vals`` (those named in ``which``), with each
    one's byte bound and layout."""
    import torch
    from datafusion_comet_tpu_torch.tools import bucket_times as BT

    dev = codes.device
    k = int(vals.shape[0])
    codes_l = codes.long()
    res = BT.time_wrappers(K, codes, vals, B, reps, flush, which)
    for name, r in res.items():
        lay = K.bucket_layout(k if name == "bucket_sum" else 0, B)
        r.update(layout=lay.name, smem_bytes=lay.smem_bytes, lanes_per_launch=lay.lanes,
                 blocks=K.grid_for(lay, int(codes.shape[0]), K._most_blocks(lay, dev.index or 0)))
        if name == "bucket_sum":
            r["plain_ms"] = BT.cuda_ms(lambda: K.bucket_sum_plain(codes, vals, B), reps,
                                       flush=flush)
            r["library_ms"] = BT.cuda_ms(
                lambda: torch.zeros(k, B + 1, dtype=torch.int64, device=dev)
                .index_add_(1, codes_l, vals), reps, flush=flush)
        else:
            r["plain_ms"] = BT.cuda_ms(lambda: K.bucket_count_plain(codes, B), reps, flush=flush)
            r["library_ms"] = BT.cuda_ms(lambda: torch.bincount(codes, minlength=B + 1), reps,
                                         flush=flush)
    return res


def kernel_phase(sf: float, reps: int, seed: int):
    import torch
    from datafusion_comet_tpu_torch.exec import kernels as K
    from datafusion_comet_tpu_torch.exec.batch import pad_capacity
    from datafusion_comet_tpu_torch.models import tpch
    from datafusion_comet_tpu_torch.tools import bucket_times as BT

    dev = torch.device("cuda", 0)
    rng = np.random.default_rng(seed)

    def cuda(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(dev)

    def full(shape):  # full-range int64, so the kernels' carries are exercised
        return rng.integers(-(1 << 63), (1 << 63) - 1, shape, dtype=np.int64)

    rows = tpch.table_rows("lineitem", sf)
    q1_codes, lanes = BT.q1_inputs(pad_capacity(rows), rows, rng)
    odd = 1_000_003  # not a multiple of 4 or of a block's rows

    def uniform(n, B):
        return rng.integers(0, B + 1, n).astype(np.int32)

    # (name, codes, B, values, offset): offset > 0 passes codes and values
    # as views that start that many elements into a larger tensor
    cases = [
        ("q1_sf", q1_codes, 64, lanes, 0),
        ("q1_sf_one_lane", q1_codes, 64, lanes[0], 0),
        ("b1", rng.integers(0, 2, odd).astype(np.int32), 1,
         rng.integers(-(1 << 40), 1 << 40, odd), 0),
        # the largest B of count_private, and of sum_replicated at four lanes
        # (both exactly 232,448 shared bytes), then the first B past them
        ("b227_k4", uniform(odd, 227), 227, full((4, odd)), 0),
        ("b228_k4", uniform(odd, 228), 228, full((4, odd)), 0),
        ("b908_k2", uniform(odd, 908), 908, full((2, odd)), 0),
        ("b909", uniform(odd, 909), 909, full(odd), 0),
        ("b4096", uniform(odd, 4096), 4096, full((2, odd)), 0),
        # odd n: lane 1 of the values starts 8- but not 16-byte aligned
        ("odd_n_k3", uniform(odd, 64), 64, full((3, odd)), 0),
        # codes not 16-byte aligned: three rows before the first vector
        ("offset1", uniform(odd, 64), 64, full((2, odd)), 1),
        ("offset1_b4096", uniform(65_538, 4096), 4096, full(65_538), 1),
        ("n3", uniform(3, 16), 16, full((2, 3)), 1),
        ("skewed_b4096", rng.choice(np.array([5, 6, 4095, 4096], np.int32), odd), 4096,
         full((2, odd)), 0),
        ("all_dead", np.full(65_537, 64, np.int32), 64,
         rng.integers(-(1 << 40), 1 << 40, 65_537), 0),
        ("pm2_62", uniform(odd, 64), 64,
         np.where(rng.random(odd) < 0.5, -(1 << 62), 1 << 62).astype(np.int64), 0),
    ]
    checked = []
    max_err = {"bucket_count": 0, "bucket_sum": 0}
    for name, codes_np, B, vals_np, off in cases:
        codes, vals = cuda(codes_np), cuda(vals_np.astype(np.int64))
        if off:
            codes = torch.cat([codes[:off], codes])[off:]
            vals = torch.cat([vals[..., :off], vals], -1)[..., off:]
        got = {"bucket_count": (K.bucket_count(codes, B), K.bucket_count_plain(codes, B)),
               "bucket_sum": (K.bucket_sum(codes, vals, B), K.bucket_sum_plain(codes, vals, B))}
        torch.cuda.synchronize()
        for kname, (a, b) in got.items():
            # sums wrap mod 2^64: compare as Python ints so the error can't wrap
            err = max((abs(x - y) for x, y in zip(a.flatten().tolist(), b.flatten().tolist())),
                      default=0)
            max_err[kname] = max(max_err[kname], err)
            if err:
                raise AssertionError(f"{kname} != plain on {name}: max abs err {err}")
        k = int(vals.shape[0]) if vals.dim() == 2 else 1
        checked.append({"case": name, "n": int(codes.shape[0]), "B": B, "lanes": k,
                        "codes_offset_bytes": codes.data_ptr() % 16,
                        "layouts": [K.bucket_layout(0, B).name, K.bucket_layout(k, B).name]})
    bad = cuda(np.array([0, 65, 3], np.int32))
    try:
        K.bucket_count(bad, 64)
    except ValueError:
        pass
    else:
        raise AssertionError("bucket_count accepted a code outside [0, B]")

    # timing at Q1's shape: count over all rows; sum over the four i128
    # lanes and over one lane. SF1's codes (34 MB) fit the H100's 50 MB L2:
    # a larger buffer is rewritten before each run to evict them
    flush = torch.zeros(BT.L2_FLUSH_BYTES // 4, dtype=torch.int32, device=dev)
    codes, vals = cuda(q1_codes), cuda(lanes)
    timing = time_buckets(K, codes, vals, 64, reps, flush)
    timing["bucket_sum_one_lane"] = time_buckets(K, codes, vals[:1], 64, reps, flush,
                                                 ("bucket_sum",))["bucket_sum"]
    for kname in ("bucket_count", "bucket_sum"):
        timing[kname]["max_abs_err"] = max_err[kname]
    return checked, timing


def pair_phase(sizes, reps: int, seed: int):
    """Both bucket kernels at the shape of the grace run's pairs: the pair
    block (lineitem, the probe side, padded, times the join's fan-out),
    Q12's 16 buckets, the pairs' mean live rows."""
    import torch
    from datafusion_comet_tpu_torch.exec import kernels as K
    from datafusion_comet_tpu_torch.exec.batch import pad_capacity
    from datafusion_comet_tpu_torch.exec.operators.join import JOIN_FANOUT
    from datafusion_comet_tpu_torch.tools import bucket_times as BT

    probe = sizes["lineitem"]
    n = pad_capacity(max(probe["max"], 8)) * JOIN_FANOUT
    codes, vals = (torch.from_numpy(a).cuda() for a in BT.pair_inputs(
        n, probe["rows"] // GRACE_K, np.random.default_rng(seed)))
    flush = torch.zeros(BT.L2_FLUSH_BYTES // 4, dtype=torch.int32, device=codes.device)
    return time_buckets(K, codes, vals, BT.PAIR_BUCKETS, reps, flush)


# ---- phase 4: Q1 and Q6 through the Session, against a numpy oracle ------------------


def _group_index(values: np.ndarray):
    keys = sorted(set(values.tolist()))
    lut = {v: i for i, v in enumerate(keys)}
    return keys, np.fromiter(map(lut.__getitem__, values.tolist()), np.int64, len(values))


def _exact_sum(x: np.ndarray) -> int:
    """Exact integer sum; int64 where the bound proves it cannot wrap."""
    if len(x) and int(np.abs(x).max()) * len(x) >= (1 << 63):
        return sum(int(v) for v in x)
    return int(x.sum(dtype=np.int64))


def oracle_q1(d, cut: int):
    m = d["l_shipdate"] <= cut
    rf_keys, rf = _group_index(d["l_returnflag"][m])
    ls_keys, ls = _group_index(d["l_linestatus"][m])
    qty, price = d["l_quantity"][m], d["l_extendedprice"][m]
    disc, tax = d["l_discount"][m], d["l_tax"][m]
    disc4 = price * (100 - disc)  # scale 4
    charge6 = disc4 * (100 + tax)  # scale 6
    g = rf * len(ls_keys) + ls
    rows = []
    for gi in range(len(rf_keys) * len(ls_keys)):
        sel = g == gi
        c = int(sel.sum())
        if not c:
            continue
        sq, sp, sd = _exact_sum(qty[sel]), _exact_sum(price[sel]), _exact_sum(disc[sel])

        def avg(s):  # HALF_UP(s * 10^4 / c), s >= 0: decimal(15,2) avg -> decimal(19,6)
            return (2 * s * 10**4 + c) // (2 * c)

        rows.append({
            "l_returnflag": rf_keys[gi // len(ls_keys)], "l_linestatus": ls_keys[gi % len(ls_keys)],
            "sum_qty": sq, "sum_base_price": sp, "sum_disc_price": _exact_sum(disc4[sel]),
            "sum_charge": _exact_sum(charge6[sel]), "avg_qty": avg(sq), "avg_price": avg(sp),
            "avg_disc": avg(sd), "count_order": c,
        })
    return rows


def oracle_q6(d, lo: int, hi: int) -> int:
    m = ((d["l_shipdate"] >= lo) & (d["l_shipdate"] < hi) & (d["l_discount"] >= 5)
         & (d["l_discount"] <= 7) & (d["l_quantity"] < 2400))
    return _exact_sum(d["l_extendedprice"][m] * d["l_discount"][m])


def check_q1(out, expect) -> None:
    if len(out["count_order"]) != len(expect):
        raise AssertionError(f"q1: {len(out['count_order'])} groups, expected {len(expect)}")
    for i, row in enumerate(expect):
        for col, want in row.items():
            got = out[col][i]
            got = got if isinstance(got, str) else int(got)
            if got != want or not out[col + "__valid"][i]:
                raise AssertionError(f"q1 row {i} {col}: got {got}, expected {want}")


def oracle_q12(li, od, lo: int, hi: int):
    """Q12 with numpy alone: the filter, the join through np.searchsorted on
    the unique o_orderkey, and per ship mode the counts of high- and
    low-priority lines. Returns [(mode, high, low)] in mode order."""
    sm = li["l_shipmode"]
    m = (((sm == "MAIL") | (sm == "SHIP")) & (li["l_commitdate"] < li["l_receiptdate"])
         & (li["l_shipdate"] < li["l_commitdate"]) & (li["l_receiptdate"] >= lo)
         & (li["l_receiptdate"] < hi))
    okeys = od["o_orderkey"]
    order = np.argsort(okeys, kind="stable")
    sk = okeys[order]
    if len(np.unique(sk)) != len(sk):
        raise AssertionError("o_orderkey is not unique")
    keys = li["l_orderkey"][m]
    pos = np.clip(np.searchsorted(sk, keys), 0, len(sk) - 1)
    found = sk[pos] == keys
    prio = od["o_orderpriority"][order][pos[found]]
    mode = sm[m][found]
    high = (prio == "1-URGENT") | (prio == "2-HIGH")
    return [(md, int((high & (mode == md)).sum()), int((~high & (mode == md)).sum()))
            for md in sorted(set(mode.tolist()))]


def check_q12(out, expect, what: str) -> None:
    got = [(out["l_shipmode"][i], int(out["high_line_count"][i]), int(out["low_line_count"][i]))
           for i in range(len(out["l_shipmode"]))]
    valid = all(out[c + "__valid"].all() for c in ("l_shipmode", "high_line_count",
                                                    "low_line_count"))
    if got != expect or not valid:
        raise AssertionError(f"{what}: got {got}, expected {expect}")


def grace_fraction(sess, plan, K: int = GRACE_K):
    """The Config(memory_fraction) under which the session splits ``plan``'s
    join into K partitions (K >= 8), from the port's own estimate: the
    engine doubles K from 2 until K x budget / 2 covers the join's peak
    estimate jpeak, so a budget of 3 x jpeak / K, inside [2 jpeak / K,
    4 jpeak / K), stops it at K. Returns (fraction, jpeak)."""
    from datafusion_comet_tpu_torch.exec.memory import device_budget_bytes, plan_peak_bytes
    from datafusion_comet_tpu_torch.ir import plan as P
    from datafusion_comet_tpu_torch.ir.pruning import prune_columns

    node = P.bind_plan(prune_columns(plan))
    while not isinstance(node, P.HashJoin):
        node = node.children()[0]
    jpeak = plan_peak_bytes(node, max(sess.tables[t].capacity for t in P.scan_tables(node)))
    return 3 * jpeak / K / device_budget_bytes(sess.device, 1.0), jpeak


def _zero_counts(K) -> None:
    for name in KERNELS:
        getattr(K, name).launches = 0


def _counts(K):
    return {name: getattr(K, name).launches for name in KERNELS}


def run_query(sess, plan, reps: int):
    """One run with the launch counts zeroed just before it and read just
    after, then ``reps`` warm runs. Returns (first output, launches,
    first-run s, warm ms list, peak bytes)."""
    import torch
    from datafusion_comet_tpu_torch.exec import kernels as K

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _zero_counts(K)
    t0 = time.perf_counter()
    out = sess.collect(plan)
    first_s = time.perf_counter() - t0
    launches = _counts(K)
    peak = torch.cuda.max_memory_allocated()
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        sess.collect(plan)
        times.append((time.perf_counter() - t0) * 1e3)
    return out, launches, first_s, times, peak


def query_phase(sf: float, reps: int, profile: bool):
    import torch
    from datafusion_comet_tpu_torch.conf import Config
    from datafusion_comet_tpu_torch.exec.engine import Session
    from datafusion_comet_tpu_torch.models import tpch

    data, gen_s = {}, {}
    for t in ("lineitem", "orders"):
        t0 = time.perf_counter()
        data[t] = tpch.generate_table(t, sf)
        gen_s[t] = time.perf_counter() - t0
    sess = Session()  # the card, the default device
    stage_s = {}
    for t in ("lineitem", "orders"):
        t0 = time.perf_counter()
        sess.register_numpy(t, data[t], tpch.SCHEMAS[t])
        torch.cuda.synchronize()
        stage_s[t] = time.perf_counter() - t0
    n_rows = len(data["lineitem"]["l_orderkey"])
    emit({"phase": "stage", "sf": sf, "rows": {t: len(next(iter(d.values())))
                                               for t, d in data.items()},
          "capacity": {t: b.capacity for t, b in sess.tables.items()},
          "generate_s": gen_s, "stage_s": stage_s})
    launches = {}
    for q in ("q1", "q6"):
        out, launches[q], first_s, times, peak = run_query(sess, getattr(tpch, q)(), reps)
        if q == "q1":
            check_q1(out, oracle_q1(data["lineitem"], tpch._d("1998-09-02")))
            need = ("bucket_count", "bucket_sum")
        else:
            want = oracle_q6(data["lineitem"], tpch._d("1994-01-01"), tpch._d("1995-01-01"))
            if int(out["revenue"][0]) != want or not out["revenue__valid"][0]:
                raise AssertionError(f"q6: got {out['revenue'][0]}, expected {want}")
            need = ("bucket_sum",)
        if min(launches[q][k] for k in need) == 0:
            raise AssertionError(f"{q} did not launch {need}: {launches[q]}")
        warm_ms = statistics.median(times)
        emit({"phase": q, "sf": sf, "rows": n_rows, "correct": True, "first_run_s": first_s,
              "warm_ms": warm_ms, "warm_ms_all": times, "rows_per_s": n_rows / (warm_ms / 1e3),
              "peak_mem_bytes": peak, "launches": launches[q]})
    if profile:
        emit(profile_run(sess, tpch.q1(), "profile_q1"))

    # Q12 directly, then through the grace join on a second session over the
    # same device tables, under a memory fraction sized for K = 16
    expect = oracle_q12(data["lineitem"], data["orders"], tpch._d("1994-01-01"),
                        tpch._d("1995-01-01"))
    fraction, jpeak = grace_fraction(sess, tpch.q12())
    grace = Session(conf=Config(memory_fraction=fraction))
    for t, b in sess.tables.items():
        grace.register_batch(t, b)
    q12 = {}
    for run, s in (("direct", sess), ("grace", grace)):
        out, launches[f"q12_{run}"], first_s, times, peak = run_query(s, tpch.q12(), reps)
        check_q12(out, expect, f"q12 {run}")
        got = launches[f"q12_{run}"]
        # both runs compact the join's output with the partition sort
        if min(got.values()) == 0:
            raise AssertionError(f"q12 {run} did not launch every kernel: {got}")
        q12[run] = {"first_run_s": first_s, "warm_ms": statistics.median(times),
                    "warm_ms_all": times, "peak_mem_bytes": peak, "launches": got}
    if grace.grace_runners and not sess.grace_runners:
        r = grace.grace_runners[0]
    else:
        raise AssertionError("q12: the grace run did not partition, or the direct run did")
    if r.K != GRACE_K or r.downstream[0] != "partial":
        raise AssertionError(f"q12 grace: K={r.K} mode={r.downstream[0]}, "
                             f"expected K={GRACE_K} partial")
    sizes = {side: {"capacity": int(cap), "rows": int(sz.sum()), "min": int(sz.min()),
                    "max": int(sz.max())}
             for side, cap, sz in zip(("lineitem", "orders"), r.capacities, r.sizes)}
    emit({"phase": "q12", "sf": sf, "correct": True, "result": expect,
          "memory_fraction": fraction, "budget_bytes": grace.budget_bytes(),
          "join_peak_estimate_bytes": jpeak, "K": r.K, "mode": r.downstream[0],
          "pair_retries": r.retries, "partitions": sizes, **q12})
    if profile:
        emit(profile_run(grace, tpch.q12(), "profile_q12_grace"))
    return launches, sizes


def profile_run(sess, plan, phase: str):
    """Device time by kernel over one warm run (torch.profiler)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    sess.collect(plan)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        sess.collect(plan)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    # device-side events only (kernels, memcpy, memset): a CPU op's device
    # time is the sum of the kernels it launched, which are listed as well.
    # The grace runner's spans (grace.*) may also appear on the device side as
    # annotations covering its kernels; they are not kernels.
    events = prof.key_averages()
    rows = sorted(((ev.self_device_time_total, ev.key, ev.count) for ev in events
                   if ev.device_type == torch.autograd.DeviceType.CUDA
                   and ev.self_device_time_total and not ev.key.startswith("grace.")),
                  reverse=True)
    if not rows:
        raise AssertionError(f"torch.profiler recorded no device activity for {phase}")
    busy_ms = sum(r[0] for r in rows) / 1e3
    part_ms = sum(r[0] for r in rows if "partition_" in r[1]) / 1e3
    # host time inside each phase of the grace runner, from its spans
    spans = {ev.key: ev.cpu_time_total / 1e3 for ev in events
             if ev.device_type == torch.autograd.DeviceType.CPU and ev.key.startswith("grace.")}
    return {"phase": phase, "wall_ms": wall_ms, "device_busy_ms": busy_ms,
            "device_idle_share": (1 - busy_ms / wall_ms) if wall_ms else None,
            "partition_kernel_ms": part_ms, "grace_span_host_ms": spans,
            "top": [{"kernel": k[:90], "device_ms": us / 1e3, "calls": c}
                    for us, k, c in rows[:12]]}


# ---- phase 5: the partition sort against its plain version ---------------------------


def partition_phase(sizes, reps: int, seed: int):
    """partition_sort against partition_sort_plain, exactly, at the shapes of
    Q12's grace run (each side's capacity, its live rows spread over K = 16
    codes and the rest dead), at the TPU kernel's probe shape in tile-local
    mode, and at edge shapes; then timing at Q12's shapes."""
    import torch
    from datafusion_comet_tpu_torch.exec import kernels as K
    from datafusion_comet_tpu_torch.tools import bucket_times as BT

    dev = torch.device("cuda", 0)
    rng = np.random.default_rng(seed)

    def codes_for(n: int, live: int, k: int):
        c = np.full(n, k, np.int32)
        c[:live] = rng.integers(0, k, live)
        return torch.from_numpy(rng.permutation(c) if live < n else c).to(dev)

    cases = [(f"q12_{side}", codes_for(v["capacity"], v["rows"], GRACE_K), GRACE_K, False)
             for side, v in sizes.items()]
    probe_n = 1 << 23  # pallas_scatter_probe.py's default N, K = 16, tile 512
    cases += [
        ("probe_tile_local", codes_for(probe_n, probe_n, 16), 16, True),
        ("k1", codes_for(1_000_003, 900_000, 1), 1, False),
        ("k64_ragged", codes_for(1_000_003, 950_000, 64), 64, False),
        ("k128_local_ragged", codes_for(70_001, 70_001, 128), 128, True),
        ("all_dead", codes_for(65_537, 0, 16), 16, False),
        ("one_row", codes_for(1, 1, 16), 16, False),
    ]
    checked = []
    max_err = 0
    for name, codes, k, local in cases:
        perm, counts = K.partition_sort(codes, k, local=local)
        want_perm, want_counts = K.partition_sort_plain(codes, k, local=local)
        torch.cuda.synchronize()
        err = max(int((perm.long() - want_perm.long()).abs().max()) if len(perm) else 0,
                  int((counts.long() - want_counts.long()).abs().max()) if counts.numel() else 0)
        max_err = max(max_err, err)
        if err or perm.shape != want_perm.shape or counts.shape != want_counts.shape:
            raise AssertionError(f"partition_sort != plain on {name}: max abs err {err}")
        checked.append({"case": name, "n": int(codes.shape[0]), "K": k, "local": local,
                        "dead": int((codes == k).sum())})
    try:
        K.partition_sort(torch.tensor([0, 17, 3], dtype=torch.int32, device=dev), 16)
    except ValueError:
        pass
    else:
        raise AssertionError("partition_sort accepted a code outside [0, K]")

    flush = torch.zeros(BT.L2_FLUSH_BYTES // 4, dtype=torch.int32, device=dev)
    timing = {}
    for name, codes, k, local in cases[:len(sizes)] + [cases[len(sizes)]]:
        n = int(codes.shape[0])
        t = -(-n // K.PARTITION_TILE)
        counts = torch.empty(t, k + 1, dtype=torch.int32, device=dev)
        perm = torch.empty(n, dtype=torch.int32, device=dev)
        bad = torch.zeros(1, dtype=torch.int64, device=dev)

        def run(codes=codes, k=k, local=local, counts=counts, bad=bad, perm=perm):
            K._launch_partition(codes, k, local, counts, bad, perm)

        timing[name] = {
            "shape": f"n={n} K={k} {'local' if local else 'global'}",
            "ms": BT.cuda_ms(run, reps, flush=flush),
            "plain_ms": BT.cuda_ms(lambda: K.partition_sort_plain(codes, k, local), reps,
                                   flush=flush),
            "library_ms": BT.cuda_ms(lambda: torch.sort(codes, stable=True), reps,
                                     flush=flush),
            # each input read once, each output written once: the codes,
            # the permutation and the (tile, code) counts
            "bound_ms": (4 * n + 4 * n + 4 * t * (k + 1)) / BT.HBM_BYTES_PER_S * 1e3,
            "max_abs_err": max_err,
        }
    return checked, timing


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--sf", type=float, default=1.0, help="TPC-H scale factor (default 1)")
    ap.add_argument("--reps", type=int, default=25, help="timed warm runs per measurement")
    ap.add_argument("--seed", type=int, default=7, help="seed of the kernel-phase inputs")
    ap.add_argument("--profile", action="store_true",
                    help="add profiled runs of Q1 and of Q12's grace run")
    args = ap.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA card visible; nothing was run", file=sys.stderr)
        return 2
    if not (ROOT / "datafusion_comet_tpu_torch" / "csrc").is_dir():
        print("chip_smoke: run it from a checkout of the repository", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    from datafusion_comet_tpu_torch.exec import _build

    kind = torch.cuda.get_device_name(0)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    emit({"phase": "device", "kind": kind, "count": torch.cuda.device_count(),
          "nvidia_smi": smi, "torch": torch.__version__, "cuda": torch.version.cuda})

    t0 = time.perf_counter()
    sources = sorted({Path(src).stem for src in SOURCES.values()})
    with concurrent.futures.ThreadPoolExecutor(len(sources)) as pool:
        logs = list(pool.map(_build.build, sources))
    emit({"phase": "build", "seconds": time.perf_counter() - t0,
          "ptxas": {name: ptxas_by_kernel(log) for name, log in zip(sources, logs)}})

    checked, timing = kernel_phase(args.sf, args.reps, args.seed)
    emit({"phase": "kernels", "checked_exact": checked, "timing": timing})

    launches, sizes = query_phase(args.sf, max(3, args.reps // 5), args.profile)
    pair = pair_phase(sizes, args.reps, args.seed)
    emit({"phase": "grace_pair_kernels", "timing": pair})
    timing["bucket_count"]["other_shapes"] = {"grace_pair": pair["bucket_count"]}
    timing["bucket_sum"]["other_shapes"] = {"one_lane": timing.pop("bucket_sum_one_lane"),
                                            "grace_pair": pair["bucket_sum"]}

    pchecked, ptiming = partition_phase(sizes, args.reps, args.seed)
    emit({"phase": "partition", "checked_exact": pchecked, "timing": ptiming})
    timing["partition_sort"] = dict(ptiming["q12_orders"], other_shapes={
        k: v for k, v in ptiming.items() if k != "q12_orders"})

    kernels = []
    for name in KERNELS:
        t = timing[name]
        per_query = {q: launches[q][name] for q in launches}
        kernels.append({
            "name": name, "route": "cuda", "source": SOURCES[name], "replaces": REPLACES[name],
            "launches": sum(per_query.values()), "launches_by_query": per_query,
            "max_abs_err": t["max_abs_err"], "ms": t["ms"], "plain_ms": t["plain_ms"],
            "bound_ms": t["bound_ms"], "bound_by": "bytes", "library_ms": t["library_ms"],
            "shape": t["shape"], **({"other_shapes": t["other_shapes"]}
                                    if "other_shapes" in t else {}),
        })
    emit({"kernels": kernels})
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())

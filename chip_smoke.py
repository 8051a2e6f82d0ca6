#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port (datafusion_comet_tpu_torch).

On a machine with one NVIDIA card, from the root of a checkout:

    python3 chip_smoke.py            # TPC-H SF1
    python3 chip_smoke.py --sf 10    # another scale
    python3 chip_smoke.py --profile  # add a torch.profiler breakdown of Q1

Phases, one JSON line each:
  1. device: the card's name, count, and nvidia-smi's name and power limit;
  2. build: compiles the CUDA kernels from csrc/ with nvcc;
  3. kernels: holds bucket_count and bucket_sum against their plain PyTorch
     versions, exactly, on the card, at Q1's SF1 shape and at edge shapes;
     times kernel, plain version and one library call at Q1's shape,
     with L2 flushed before each timed run;
  4. q1, q6: runs each query through the port's Session, checks the result
     against an exact integer oracle written with numpy alone, and reports
     warm time, rows/s, peak device memory and the kernel launch counts of
     one run with the counts zeroed just before it.
Then a {"kernels": [...]} line, nvidia-smi's line, and last
{"ok": true, "device": {...}}. Any failure raises and exits non-zero. The
script imports no JAX; without a card, or without the package beside it, it
exits non-zero and prints no result.
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

HBM_BYTES_PER_S = 3.35e12  # H100 SXM device memory rate (NVIDIA data sheet)
L2_FLUSH_BYTES = 256 << 20  # over five times the H100's 50 MB L2
ROOT = Path(__file__).resolve().parent
REPLACES = {
    "bucket_count": "datafusion_comet_tpu/exec/pallas_kernels.py:43",
    "bucket_sum": "datafusion_comet_tpu/exec/pallas_kernels.py:84",
}
SOURCE = "datafusion_comet_tpu_torch/csrc/bucket_kernels.cu"


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def cuda_ms(fn, reps: int, warm: int = 3, flush=None) -> float:
    """Median device time of ``fn`` over ``reps`` warm runs, CUDA events.
    ``flush`` (a device buffer larger than L2) is rewritten before each
    timed run, outside the events, so ``fn`` reads its inputs from memory."""
    import torch

    for _ in range(warm):
        fn()
    pairs = []
    for _ in range(reps):
        e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        if flush is not None:
            flush.add_(1)
        e0.record()
        fn()
        e1.record()
        pairs.append((e0, e1))
    torch.cuda.synchronize()
    return statistics.median(a.elapsed_time(b) for a, b in pairs)


# ---- phase 3: kernels against their plain versions -----------------------------------


def kernel_phase(sf: float, reps: int, seed: int):
    import torch
    from datafusion_comet_tpu_torch.exec import kernels as K
    from datafusion_comet_tpu_torch.exec.batch import pad_capacity
    from datafusion_comet_tpu_torch.models import tpch

    dev = torch.device("cuda", 0)
    rng = np.random.default_rng(seed)

    def cuda(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(dev)

    # Q1's shape: the staged capacity, 64 buckets, six live (returnflag x
    # linestatus), ~1.5% of live rows filtered out, padding rows dead
    rows = tpch.table_rows("lineitem", sf)
    cap = pad_capacity(rows)
    live_buckets = np.array([9, 10, 17, 18, 25, 26], np.int32)
    q1_codes = np.full(cap, 64, np.int32)
    q1_codes[:rows] = live_buckets[rng.integers(0, 6, rows)]
    q1_codes[:rows][rng.random(rows) < 0.015] = 64
    lanes = np.stack([rng.integers(0, 1 << 32, cap) for _ in range(3)]
                     + [rng.integers(-(1 << 20), 1 << 20, cap)]).astype(np.int64)
    odd = 1_000_003  # not a multiple of the block
    cases = [
        ("q1_sf", q1_codes, 64, lanes),
        ("q1_sf_one_lane", q1_codes, 64, lanes[0]),
        ("b1", rng.integers(0, 2, odd).astype(np.int32), 1,
         rng.integers(-(1 << 40), 1 << 40, odd)),
        ("b4096", rng.integers(0, 4097, odd).astype(np.int32), 4096,
         rng.integers(-(1 << 40), 1 << 40, (2, odd))),
        ("all_dead", np.full(65_537, 64, np.int32), 64,
         rng.integers(-(1 << 40), 1 << 40, 65_537)),
        ("pm2_62", rng.integers(0, 65, odd).astype(np.int32), 64,
         np.where(rng.random(odd) < 0.5, -(1 << 62), 1 << 62).astype(np.int64)),
    ]
    checked = []
    max_err = {"bucket_count": 0, "bucket_sum": 0}
    for name, codes_np, B, vals_np in cases:
        codes, vals = cuda(codes_np), cuda(vals_np.astype(np.int64))
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
        checked.append({"case": name, "n": int(codes.shape[0]), "B": B,
                        "lanes": int(vals.shape[0]) if vals.dim() == 2 else 1})
    bad = cuda(np.array([0, 65, 3], np.int32))
    try:
        K.bucket_count(bad, 64)
    except ValueError:
        pass
    else:
        raise AssertionError("bucket_count accepted a code outside [0, B]")

    # timing at Q1's shape: count over all rows; sum over the four i128 lanes
    codes, vals = cuda(q1_codes), cuda(lanes)
    n, B, k = cap, 64, lanes.shape[0]
    out_c = torch.zeros(B, dtype=torch.int64, device=dev)
    out_s = torch.zeros(k, B, dtype=torch.int64, device=dev)
    bad = torch.zeros(1, dtype=torch.int64, device=dev)

    def run_count():
        out_c.zero_()
        bad.zero_()
        K._launch_count(codes, B, out_c, bad)

    def run_sum():
        out_s.zero_()
        bad.zero_()
        K._launch_sum(codes, vals, B, out_s, bad)

    codes_l = codes.long()
    live = int((q1_codes < B).sum())  # the sum kernel reads values of live rows only
    # SF1's codes (34 MB) fit the H100's 50 MB L2: evict them before each run
    flush = torch.zeros(L2_FLUSH_BYTES // 4, dtype=torch.int32, device=dev)

    def t(fn):
        return cuda_ms(fn, reps, flush=flush)

    timing = {
        "bucket_count": {
            "shape": f"n={n} B={B}",
            "ms": t(run_count),
            "plain_ms": t(lambda: K.bucket_count_plain(codes, B)),
            "library_ms": t(lambda: torch.bincount(codes, minlength=B + 1)),
            "bound_ms": (4 * n + 8 * B) / HBM_BYTES_PER_S * 1e3,
        },
        "bucket_sum": {
            "shape": f"n={n} B={B} lanes={k}",
            "ms": t(run_sum),
            "plain_ms": t(lambda: K.bucket_sum_plain(codes, vals, B)),
            "library_ms": t(lambda: torch.zeros(k, B + 1, dtype=torch.int64, device=dev)
                            .index_add_(1, codes_l, vals)),
            "bound_ms": (4 * n + 8 * k * live + 8 * k * B) / HBM_BYTES_PER_S * 1e3,
        },
    }
    for kname in timing:
        timing[kname]["max_abs_err"] = max_err[kname]
    return checked, timing


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


def query_phase(sf: float, reps: int, profile: bool):
    import torch
    from datafusion_comet_tpu_torch.exec import kernels as K
    from datafusion_comet_tpu_torch.exec.engine import Session
    from datafusion_comet_tpu_torch.models import tpch

    t0 = time.perf_counter()
    data = tpch.generate_table("lineitem", sf)
    gen_s = time.perf_counter() - t0
    n_rows = len(data["l_orderkey"])
    sess = Session()  # the card, the default device
    t0 = time.perf_counter()
    sess.register_numpy("lineitem", data, tpch.SCHEMAS["lineitem"])
    torch.cuda.synchronize()
    stage_s = time.perf_counter() - t0
    emit({"phase": "stage", "sf": sf, "rows": n_rows,
          "capacity": sess.tables["lineitem"].capacity,
          "generate_s": gen_s, "stage_s": stage_s})
    results, launches = {}, {}
    for q in ("q1", "q6"):
        plan = getattr(tpch, q)()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        K.bucket_count.launches = 0
        K.bucket_sum.launches = 0
        t0 = time.perf_counter()
        out = sess.collect(plan)
        first_s = time.perf_counter() - t0
        launches[q] = {"bucket_count": K.bucket_count.launches,
                       "bucket_sum": K.bucket_sum.launches}
        peak = torch.cuda.max_memory_allocated()
        if q == "q1":
            check_q1(out, oracle_q1(data, tpch._d("1998-09-02")))
            if min(launches[q].values()) == 0:
                raise AssertionError(f"q1 did not launch both kernels: {launches[q]}")
        else:
            want = oracle_q6(data, tpch._d("1994-01-01"), tpch._d("1995-01-01"))
            if int(out["revenue"][0]) != want or not out["revenue__valid"][0]:
                raise AssertionError(f"q6: got {out['revenue'][0]}, expected {want}")
            if launches[q]["bucket_sum"] == 0:
                raise AssertionError(f"q6 did not launch bucket_sum: {launches[q]}")
        times = []
        for _ in range(reps):
            t0 = time.perf_counter()
            sess.collect(plan)
            times.append((time.perf_counter() - t0) * 1e3)
        warm_ms = statistics.median(times)
        results[q] = {"phase": q, "sf": sf, "rows": n_rows, "correct": True,
                      "first_run_s": first_s, "warm_ms": warm_ms, "warm_ms_all": times,
                      "rows_per_s": n_rows / (warm_ms / 1e3), "peak_mem_bytes": peak,
                      "launches": launches[q]}
        emit(results[q])
    if profile:
        emit(profile_q1(sess, tpch.q1()))
    return launches


def profile_q1(sess, plan):
    """Device time by kernel over one warm Q1 run (torch.profiler)."""
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
    # time is the sum of the kernels it launched, which are listed as well
    rows = sorted(((ev.self_device_time_total, ev.key, ev.count) for ev in prof.key_averages()
                   if ev.device_type == torch.autograd.DeviceType.CUDA
                   and ev.self_device_time_total), reverse=True)
    if not rows:
        raise AssertionError("torch.profiler recorded no device activity for Q1")
    busy_ms = sum(r[0] for r in rows) / 1e3
    return {"phase": "profile_q1", "wall_ms": wall_ms, "device_busy_ms": busy_ms,
            "device_idle_share": (1 - busy_ms / wall_ms) if wall_ms else None,
            "top": [{"kernel": k[:90], "device_ms": us / 1e3, "calls": c}
                    for us, k, c in rows[:12]]}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--sf", type=float, default=1.0, help="TPC-H scale factor (default 1)")
    ap.add_argument("--reps", type=int, default=25, help="timed warm runs per measurement")
    ap.add_argument("--seed", type=int, default=7, help="seed of the kernel-phase inputs")
    ap.add_argument("--profile", action="store_true", help="add a profiled Q1 run")
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
    log = _build.build("bucket_kernels")
    emit({"phase": "build", "seconds": time.perf_counter() - t0,
          "ptxas": [ln.strip() for ln in log.splitlines() if "registers" in ln or "smem" in ln]})

    checked, timing = kernel_phase(args.sf, args.reps, args.seed)
    emit({"phase": "kernels", "checked_exact": checked, "timing": timing})

    launches = query_phase(args.sf, max(3, args.reps // 5), args.profile)

    kernels = []
    for name in ("bucket_count", "bucket_sum"):
        t = timing[name]
        kernels.append({
            "name": name, "route": "cuda", "source": SOURCE, "replaces": REPLACES[name],
            "launches": launches["q1"][name] + launches["q6"][name],
            "launches_q1": launches["q1"][name], "launches_q6": launches["q6"][name],
            "max_abs_err": t["max_abs_err"], "ms": t["ms"], "plain_ms": t["plain_ms"],
            "bound_ms": t["bound_ms"], "bound_by": "bytes", "library_ms": t["library_ms"],
            "shape": t["shape"],
        })
    emit({"kernels": kernels})
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())

#!/usr/bin/env python3
"""Times of the bucket kernels' public wrappers (``exec/kernels.py``:
``bucket_count`` and ``bucket_sum``) at fixed shapes, for the port in any
checkout. Each checkout runs in its own process, so two of them can be timed
in turns on one card:

    python3 datafusion_comet_tpu_torch/tools/bucket_times.py [--tree DIR] [--sf 1]

DIR (default: the checkout holding this file) goes first on sys.path, and
only the wrappers' public signatures are called, with an ``errors`` list as
a query passes it (no host read of the bad-code flag). One JSON line per
shape: ``ms``, the median device time (CUDA events) of one wrapper call
(zeroing its output and launching), with a 256 MB buffer rewritten before
each timed call so inputs come from device memory; ``host_us``, the host
time of one call while the card keeps up; ``bound_ms``, each input byte
read once (values of live rows only) and each output written once at the
H100's 3.35 TB/s. Shapes:

- ``q1``: Q1's aggregate, n = lineitem's staged capacity at ``--sf``,
  B = 64, six live buckets, padding and filtered rows dead; a count, a sum
  over four lanes and one over one lane;
- ``pair_<n>``: a pair of Q12's grace join, n = 16,384 and 262,144 (the
  pair block at SF1 and SF10), B = 16, a pair's mean live rows; a count
  and a one-lane sum;
- ``b500_k4``: a mid-range domain, n as Q1's, codes uniform over [0, 500],
  a four-lane sum.

chip_smoke.py takes its timing and Q1's inputs from here.
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
PAIR_BUCKETS = 16  # Q12's aggregate: l_shipmode's dictionary codes
Q12_MODES = (2, 5)  # MAIL and SHIP in l_shipmode's sorted dictionary
# a grace pair's block rows -> its live rows: Q12's lineitem side holds
# 58,451 rows over 16 pairs at SF1 and 589,729 at SF10 (chip_smoke's q12 line)
PAIRS = {16_384: 3_653, 262_144: 36_858}


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


def host_us(fn, calls: int = 100) -> float:
    """Host microseconds of one call of ``fn``, over ``calls`` calls queued
    without a sync (the card's queue holds them all)."""
    import torch

    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    dt = time.perf_counter() - t0
    torch.cuda.synchronize()
    return dt / calls * 1e6


def q1_inputs(capacity: int, rows: int, rng):
    """Q1's aggregate inputs: int32 codes (capacity,) over 64 buckets, six
    live (returnflag x linestatus), ~1.5% of the rows filtered out and the
    padding dead; int64 values (4, capacity) as the i128 sums split them
    (three unsigned 32-bit lanes and a signed top lane)."""
    live_buckets = np.array([9, 10, 17, 18, 25, 26], np.int32)
    codes = np.full(capacity, 64, np.int32)
    codes[:rows] = live_buckets[rng.integers(0, 6, rows)]
    codes[:rows][rng.random(rows) < 0.015] = 64
    lanes = np.stack([rng.integers(0, 1 << 32, capacity) for _ in range(3)]
                     + [rng.integers(-(1 << 20), 1 << 20, capacity)]).astype(np.int64)
    return codes, lanes


def pair_inputs(n: int, live: int, rng):
    """One grace pair's aggregate inputs: codes (n,) over the join's pair
    block (probe rows x JOIN_FANOUT slots), where the first ``live`` probe
    rows each have one match, in one of Q12's two ship modes, and every other
    slot is dead; one value lane."""
    from datafusion_comet_tpu_torch.exec.operators.join import JOIN_FANOUT

    codes = np.full(n, PAIR_BUCKETS, np.int32)
    codes[:live * JOIN_FANOUT:JOIN_FANOUT] = np.array(Q12_MODES, np.int32)[
        rng.integers(0, 2, live)]
    return codes, rng.integers(0, 1 << 20, (1, n)).astype(np.int64)


def time_wrappers(K, codes, vals, B: int, reps: int, flush,
                  which=("bucket_count", "bucket_sum")):
    """{name: {shape, live, ms, host_us, bound_ms}} of the wrappers named in
    ``which``: ``bucket_count(codes, B)``, ``bucket_sum(codes, vals, B)``
    with (k, n) ``vals``."""
    n, k = int(codes.shape[0]), int(vals.shape[0])
    live = int((codes < B).sum())
    calls = {
        "bucket_count": (lambda: K.bucket_count(codes, B, []), f"n={n} B={B}",
                         4 * n + 8 * B),
        "bucket_sum": (lambda: K.bucket_sum(codes, vals, B, []), f"n={n} B={B} lanes={k}",
                       4 * n + 8 * k * live + 8 * k * B),
    }
    return {name: {"shape": shape, "live": live, "ms": cuda_ms(fn, reps, flush=flush),
                   "host_us": host_us(fn), "bound_ms": bound / HBM_BYTES_PER_S * 1e3}
            for name, (fn, shape, bound) in calls.items() if name in which}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--tree", type=Path, default=Path(__file__).resolve().parents[2],
                    help="the checkout whose port is timed (default: this one)")
    ap.add_argument("--sf", type=float, default=1.0, help="TPC-H scale of Q1's shape")
    ap.add_argument("--reps", type=int, default=25, help="timed runs per shape")
    ap.add_argument("--seed", type=int, default=7)
    args = ap.parse_args(argv)
    tree = args.tree.resolve()
    sys.path.insert(0, str(tree))

    import torch

    if not torch.cuda.is_available():
        print("bucket_times: no CUDA card visible", file=sys.stderr)
        return 2
    from datafusion_comet_tpu_torch.exec import kernels as K
    from datafusion_comet_tpu_torch.exec.batch import pad_capacity
    from datafusion_comet_tpu_torch.models import tpch

    if not Path(K.__file__).resolve().is_relative_to(tree):
        raise RuntimeError(f"imported {K.__file__}, not the port in {tree}")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    print(json.dumps({"tree": str(tree), "nvidia_smi": smi}), flush=True)

    dev = torch.device("cuda", 0)
    rng = np.random.default_rng(args.seed)
    rows = tpch.table_rows("lineitem", args.sf)
    cap = pad_capacity(rows)
    q1_codes, q1_lanes = (torch.from_numpy(a).to(dev) for a in q1_inputs(cap, rows, rng))
    cases = [("q1", q1_codes, q1_lanes, 64, ("bucket_count", "bucket_sum")),
             ("q1_one_lane", q1_codes, q1_lanes[:1], 64, ("bucket_sum",))]
    for n, live in PAIRS.items():
        codes, vals = (torch.from_numpy(a).to(dev) for a in pair_inputs(n, live, rng))
        cases.append((f"pair_{n}", codes, vals, PAIR_BUCKETS, ("bucket_count", "bucket_sum")))
    mid = torch.from_numpy(rng.integers(0, 501, cap).astype(np.int32)).to(dev)
    cases.append(("b500_k4", mid, q1_lanes, 500, ("bucket_sum",)))

    flush = torch.zeros(L2_FLUSH_BYTES // 4, dtype=torch.int32, device=dev)
    for name, codes, vals, B, which in cases:
        for kname, r in time_wrappers(K, codes, vals, B, args.reps, flush, which).items():
            print(json.dumps({"case": name, "kernel": kname, **r}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

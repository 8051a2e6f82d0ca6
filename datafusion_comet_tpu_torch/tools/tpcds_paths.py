#!/usr/bin/env python3
"""The path each TPC-DS query of a checkout's port takes on the card: its
stages, every run (where: a stage, a grace pair or a tiled aggregate; its
growth scale; whether it overflowed, and, where the checkout records them,
the operators that did and the stage's resident-bytes estimate), its grace
joins (K, mode, pair retries), its tiled aggregates, the re-runs held to
the memory budget, its first-run seconds and peak device memory. Two
checkouts run in turns (parent, new, new, parent) show which queries an
engine change moves to another path:

    python3 datafusion_comet_tpu_torch/tools/tpcds_paths.py [--tree DIR] [--sf 10]
        [--queries q4,q5] [--out FILE]

DIR (default: the checkout holding this file) goes first on sys.path; only
the port's public entry points are called (``Session``, ``models.tpcds``).
One JSON line per query to stdout (and to ``--out``). A query that fails
is recorded with its error and the runs it made before it, and the next
query runs: this is a diagnostic, and chip_smoke.py, which fails on any
query's failure, is the check.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path


def record(sess) -> dict:
    """The path of the session's last run."""
    out = {"stages": len(sess.stages),
           "runs": [{k: r.get(k) for k in ("where", "scale", "overflowed", "overflow_ops",
                                           "estimate")} for r in sess.runs],
           "grace": [{"K": g.K, "mode": g.downstream and g.downstream[0],
                      "pair_retries": g.retries} for g in sess.grace_runners],
           "tiled": [list(t) for t in sess.tiled],
           "rebudgets": [{k: v for k, v in r.items()} for r in getattr(sess, "rebudgets", [])]}
    subs = getattr(sess, "subqueries", [])
    if subs:
        out["subqueries"] = [{"runs": [[r["scale"], r["overflowed"]] for r in sq["runs"]],
                              "grace": [g.K for g in sq["grace_runners"]]} for sq in subs]
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--tree", type=Path, default=Path(__file__).resolve().parents[2],
                    help="the checkout whose port runs (default: this one)")
    ap.add_argument("--sf", type=float, default=10.0, help="the TPC-DS generator's scale")
    ap.add_argument("--queries", default="", help="comma-separated queries (default: all)")
    ap.add_argument("--out", type=Path, default=None, help="also append the lines here")
    args = ap.parse_args(argv)
    tree = args.tree.resolve()
    sys.path.insert(0, str(tree))

    import torch

    if not torch.cuda.is_available():
        print("tpcds_paths: no CUDA card visible", file=sys.stderr)
        return 2
    from datafusion_comet_tpu_torch.exec.engine import Session
    from datafusion_comet_tpu_torch.models import tpcds

    if not Path(tpcds.__file__).resolve().is_relative_to(tree):
        raise RuntimeError(f"imported {tpcds.__file__}, not the port in {tree}")
    sink = open(args.out, "a") if args.out else None

    def emit(rec):
        line = json.dumps(rec, default=str)
        print(line, flush=True)
        if sink:
            print(line, file=sink, flush=True)

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    emit({"tree": str(tree), "sf": args.sf, "nvidia_smi": smi})
    sess = Session()
    for t in tpcds.SCHEMAS:
        sess.register_numpy(t, tpcds.generate_table(t, args.sf), tpcds.SCHEMAS[t])
    torch.cuda.synchronize()
    queries = [q for q in args.queries.split(",") if q] or list(tpcds.QUERIES)
    for q in queries:
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        rec = {"query": q}
        t0 = time.perf_counter()
        try:
            plan = tpcds.plan(q, sess) if hasattr(tpcds, "plan") else tpcds.QUERIES[q]()
            out = sess.collect(plan)
            rec["rows"] = len(next(iter(out.values())))
        except Exception as err:  # noqa: BLE001 (a diagnostic records every failure)
            rec["error"] = f"{type(err).__name__}: {str(err)[:300]}"
            rec["error_at"] = {"runs": len(sess.runs), "stages": len(sess.stages),
                               "allocated_gb": torch.cuda.memory_allocated() / 1e9}
        torch.cuda.synchronize()
        rec["first_run_s"] = time.perf_counter() - t0
        rec["peak_gb"] = torch.cuda.max_memory_allocated() / 1e9
        rec.update(record(sess))
        emit(rec)
    return 0


if __name__ == "__main__":
    sys.exit(main())

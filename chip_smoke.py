#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port (datafusion_comet_tpu_torch).

On a machine with one NVIDIA card, from the root of a checkout:

    python3 chip_smoke.py            # TPC-H SF1, TPC-DS SF10
    python3 chip_smoke.py --sf 10    # another scale (TPC-DS at ten times it)
    python3 chip_smoke.py --profile  # add torch.profiler breakdowns of Q1, Q20's
                                     # variant, Q21 direct, TPC-DS q3, q27, q33, q64, q96, q88,
                                     # three expr_* plans and the five nested_* plans

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
  4. q1, q6, q12, q3: runs each query through the port's Session, checks
     the result against an exact integer oracle written with numpy alone,
     and reports warm time, peak device memory and the kernel launch counts
     of one run with the counts zeroed just before it. Q12 and Q3 run twice:
     directly, and under a Config(memory_fraction) that makes the engine
     split the (top) join into K = 16 hash partitions (the grace join; Q3's
     aggregate then runs inside each pair, its local mode); Q3's lines add
     its stages and group count;
  q4, q15: Q4 (orders LEFT_SEMI lineitem, COUNT(*) per priority on the
     dense path) directly and through the grace join (K = 16, partial
     mode), then a LEFT_SEMI whose output the engine compacts (lineitem
     against the orders of one day); Q15 (revenue per supplier, its MAX, a
     LEFT_SEMI join on the decimal revenue, an INNER join with supplier)
     directly. Each against a numpy oracle, with Q3's fields plus the
     membership path each semi join took (bitmap or sorted);
  q5: Q5 (five INNER joins over six tables, one on two packed keys,
     revenue per nation on the dense path) directly and through the grace
     join (its first join at K = 16), against a numpy oracle, each run
     launching B1 and B2, the grace run B3, with Q4's fields plus its
     grace joins;
  q10, q18: Q10 (three INNER joins, grouped by c_custkey, c_name, c_acctbal
     and n_name, a top-20) and Q18 (the per-order quantity sums over 300, a
     LEFT_SEMI join against them, a five-key aggregate with c_name, a
     top-100) directly and through the grace join (K = 16; Q18's per-order
     aggregate runs tiled first), against numpy oracles, with Q5's fields
     plus the tiled aggregates and the sort limbs of the grouping aggregate
     (c_name is padded from SF1 up: four int64 limbs);
  q2, q9, q19: over the part and partsupp tables, Q2 (the EUROPE suppliers'
     least supply cost per part, LIKE '%BRASS' over p_type, a two-key
     LEFT_SEMI join back, a top-100), Q9 (LIKE '%green%' over the padded
     p_name, five INNER joins, profit per nation and year(o_orderdate)) and
     Q19 (lineitem joined to part under three brand, container, quantity
     and size clauses, an ungrouped SUM) directly and through the grace
     join (the first stage's top join at K = 16), against numpy oracles;
  q7, q8, q11, q14, q17: the floats and the nested-loop join: Q7 (the
     FRANCE-GERMANY trade), Q8 (BRAZIL's DOUBLE market share: two float
     SUMs per year and their division), Q11 (GERMANY's part values against
     0.0001 / SF of the total, TPC-H's FRACTION, by a broadcast nested-loop
     join under a DOUBLE condition; its lines add the join's two input
     capacities), Q14 (the
     PROMO share, decimal sums cast to DOUBLE) and Q17 (a per-part AVG
     joined back under a DOUBLE condition) directly and through the grace
     join (K = 16), against numpy oracles: Q8's FLOAT64 sums within
     ``FLOAT_SUM_RTOL`` (1e-9), every other value exact, Q11's threshold,
     Q14's ratio and Q17's average bit-equal (the same float operations in
     numpy);
  q13, q16, q20, q20_variant: the outer join and COUNT(DISTINCT): Q13
     (customer LEFT JOIN orders, COUNT(o_orderkey) per customer, then the
     customers per count; its lines add each outer join's path and output
     capacity), Q16 (a LEFT ANTI join against the suppliers with
     complaints, COUNT(DISTINCT ps_suppkey) per brand, type and size, as a
     group-only aggregate and a COUNT), Q20 at TPC-H's literals (empty at
     every scale: the generator draws l_suppkey and ps_suppkey apart) and
     with ``Q20_VARIANT``'s (every part name, ship dates 1992-1998), each
     directly and through the grace join (K = 16), against numpy oracles;
  q21, q22: Q21 (late suppliers: a LEFT SEMI and a LEFT ANTI join with the
     condition ``l_suppkey <>``, on the min/max pushdown; its lines add
     each such join's path, ``minmax_dense`` at SF1 and ``minmax_sorted``
     at SF10, checked, in the stage and in every grace pair) and Q22
     (``substring(c_phone, 1, 2)``, the positive balances' AVG through a
     nested-loop join, a LEFT ANTI join against the orders), directly and
     through the grace join (K = 16), against numpy oracles (Q21's by
     distinct suppliers per order, not by min/max);
  q12_smj, q3_smj, q16_not_in: Q12 and Q3 in Spark's plan at scale (every
     join SortMergeJoin(Sort(ShuffleExchange(...)), ...), Q3's top 10 a
     TakeOrderedAndProject) and Q16 with its NOT IN a null-aware anti join,
     against the oracles their hash plans are held to; warm ms beside the
     hash plan's, the SortMergeJoins planned and each join's path and merge
     path;
  prepare_q1, prepare_q6, prepare_q12, prepare_q12_grace: Session.prepare's
     runner, five calls each equal to collect's answer, none re-running;
     prepared against collected warm ms and the warm-up's planning ms;
  padded (at SF1, or the smaller --sf): Q1, Q3, Q4, Q5 and Q12 over tables
     staged with every string padded (no dictionary codes), against the
     same oracles;
  tpcds: the 24 TPC-DS tables at ten times --sf (``tpcds_stage``: rows,
     capacities, staged GB), all 99 TPC-DS queries directly (one line
     each: warm ms, peak GB, launches, hints, retries, rows, planning ms;
     q22's line the sort limbs of its rollup aggregate; q88's its eight
     scalar subqueries' runs, attempts, stages and grace joins), q3, q52,
     q55, q43, q96, q88 (eight half-hour counts, each a scalar subquery), q7,
     q73, q33, q27, q98 (window class sums and ratios) and q51 (running sums
     and maxima through a FULL join) against exact numpy oracles and q39
     (stddev_samp) within ``FLOAT_SUM_RTOL`` (``TPCDS_ORACLES``), q3, q7,
     q27, q33, q65, q73, q95, q96, q98, q47 and q88 also through the grace
     join (K = 16; partition sizes with the largest beside the mean), the
     same answer as directly; q90 in its scalar-subquery form
     (``tpcds_q90_scalar``) and Spark's runtime bloom filter (``bloom``: a
     BLOOM_FILTER of Spark's default size built by a scalar subquery over
     5% of the items, store_sales filtered by its probe and aggregated; the
     filter's bytes, the probe's false negatives and the aggregate held to
     numpy; build, probe and whole-query ms) against numpy; then all 99
     queries at TPC-DS SF1 (SF 0.1 with --sf above 1) on the card against
     the port's CPU run of them. Every query must run (a failure fails the
     script); ``TPCDS_C19``'s lines add each attempt's overflowed operators
     and the re-runs planned again (``went``: grace or tiled). q3, q64 and
     q88 also run through Session.prepare (``ds_prepare_*``), and
     ``ds_agg_*`` holds median, percentile, approx_count_distinct and
     approx_percentile over store_sales, per state (the dense path) and per
     item (the sorted path), SINGLE and as PARTIAL states merged by a FINAL
     (tiled, and the grace join's partial mode), to numpy oracles
     (percentiles and HLL exactly, the sketch within its rank error).
     Every query line carries its joins' ``hints`` (per INNER join: build
     side, K, unique build, key packing, compacted-list rows and the path
     taken: dense_unique, sorted_unique, pair_list or block), its
     ``attempts`` and ``retries`` (the stage runs, and those that
     overflowed and ran again), its ``runtime_filters`` (per injected semi
     join: key table, keys, key range, row estimate; Q3, Q5, Q10, Q9, Q2,
     Q8 and Q17 at SF1, Q9, Q2, Q8, Q11, Q17, Q20 and Q21 at SF10, and the
     direct runs but Q3's compact the filter's output: ``RF_EXPECTED``,
     checked)
     and ``plan_ms``, the host ms of
     ``Session._plan_stages`` (the first run's, with the host copies of the
     dimension tables, and the warm runs' median);
  expr_time, expr_strings, expr_casts, expr_sample (the ``expr`` phase,
     ``expr_phase``, over the staged TPC-DS tables): the scalar evaluator at
     scale through Session.collect, each against its oracle (the TPC-DS
     oracle worker's): expr_time (store_sales joined to date_dim and
     time_dim; make_date, unix_date, timestamp_seconds, from_utc_timestamp
     in America/New_York where the machine has its tzdata, else -05:00,
     date_trunc, hour, add_months and the truncated timestamp as a string,
     COUNT and SUM per local month and hour; zoneinfo's offsets),
     expr_strings (customer: concat_ws, initcap, lower, upper, trim, lpad
     of a cast, instr, replace, substring_index, format_number, translate
     and soundex; COUNT, MAX(length), SUM(xxhash64), MIN/MAX of strings per
     soundex; Python string code), expr_casts (store_sales:
     cast(cast(ss_net_paid as string) as decimal(7,2)) and the Ryu string
     of ss_net_paid / 3 cast back to a double, both counts of rows that do
     not round-trip 0; hash and xxhash64 of that string summed per store,
     against numpy's hashes of the device's strings, a seeded sample of
     them against Java's Double.toString) and expr_sample (a 1% Bernoulli
     Sample, then rand, randn and monotonically_increasing_id: the sampled
     ids, SUM(ss_net_paid) and every rand value exactly, the first 1,000
     randn values within ``EXPR_RANDN_RTOL``, against a numpy XORShiftRandom
     held to a sequential Python one); warm ms, peak memory, rows and
     launches each;
  nested_basket, nested_explode, nested_struct_map, nested_split,
     nested_percentile (the ``nested`` phase, ``nested_phase``, after the
     expr phase on the same TPC-DS session): collect_list / collect_set of
     each ticket's items and stores (``NESTED_CAP`` 32) with size,
     array_contains, sort_array, array_distinct, element_at, transform,
     filter and aggregate over them, counted per basket size; posexplode of
     the lists joined to item, COUNT and SUMs per category (equal to the
     direct join's); a named_struct and a map_from_arrays with colliding
     keys over customer; split(i_item_desc, ' ') exploded and counted per
     word; percentile(ss_net_paid, array(0.25, 0.5, 0.75)) per store. Each
     against its numpy oracle (the TPC-DS worker's; the percentiles within
     ``NESTED_PCT_RTOL``), with warm ms, peak GB, launches and
     ``truncated_groups`` (ROADMAP C31); nested_explode adds the package's
     ``device_profile`` (device events above 0) and the stage estimates
     beside the peak (ROADMAP C32);
  text_rlike, text_regexp, text_digest, text_json, text_udf,
     text_udf_staged (the ``text`` phase, ``text_phase``, after the nested
     phase on the same TPC-DS session): RLIKE over item's descriptions (one
     automaton within the JAX package's select-tree thresholds, one over
     them) in FILTER clauses of an aggregate over store_sales joined to
     item; regexp_extract, regexp_replace and regexp_extract_all over every
     customer; md5, sha1, sha2 at 224/256/384/512, crc32, hex, base64,
     unbase64, conv and bin of every customer's name; a JSON document built
     on the card for every store_sales row, three get_json_object paths and
     json_array_length summed per store; Python UDFs over item and
     parse_url, from_json, to_json and format_string over a seeded
     10,000-row table. Each against Python oracles (``re``, ``hashlib``,
     ``zlib``, ``base64``, ``json``, ``urllib``) from the TPC-DS worker,
     strings by a sha256 of their buffers; warm ms, peak, rows; then each
     digest's kernels and ms alone (``text_digest_kernels``) and
     Session.validate over the TPC-H and TPC-DS plans on the card and the
     CPU (``text_validate``), and the phase's seconds;
  explain: Session.explain(tpch.q3(), with_metrics=True) at TPC-H SF 0.1
     on the card equals the CPU's tree, operator by operator;
  grace_pair_kernels: times both bucket kernels at the grace run's pair
     shape (a pair's block, B = 16, its mean live rows);
  5. partition: holds B3 against its plain versions, exactly: the
     payload-moving partition_columns at every distinct B3 call of Q12's,
     Q3's, Q4's, Q15's, Q6's, Q5's, Q10's, Q18's, Q2's, Q9's, Q19's, Q7's,
     Q8's, Q11's, Q14's, Q17's, Q13's, Q16's, Q20's, Q21's, Q22's, the
     padded phase's and the TPC-DS grace queries' runs (Q18's grace
     calls move c_name's 25-byte rows; the
     grace runs' input shrinks, sides and per-pair shrinks, the filter
     shrinks, the semi outputs' compactions, the runtime filters' among
     them, named ``rf_compact``, the stage shrinks), each on the
     codes the query gave it (logged by one extra run of each query) with
     random columns of the call's types and widths; at the TPU kernel's
     probe shape (n = 2^23, four int64
     columns, tile-local) and at every row width on misaligned inputs; the
     permutation-only partition_sort at Q12's sides, the probe shape and
     edge shapes. Times the wrapper (device ms and host µs a call), its
     plain version and the library composition (torch.sort + one
     index_select a column) at the query and probe shapes, with L2 flushed,
     beside the byte bound; nested rows too: nested_explode's compaction
     and a list's (32,) int64 and (16, 40) string element blocks at K = 16.
     The query lines list every B3 call's n;
  dense_minmax: the dense aggregate's MIN/MAX reduction at Q1's shape
     against one scatter into a slot a group, equal, both timed.
Then a {"kernels": [...]} line, nvidia-smi's line, and last
{"ok": true, "device": {...}}. Any failure raises and exits non-zero. The
numpy oracles run in worker processes of their own (``start_oracles``:
spawned at the start, each generating its own seeded tables, ended at
exit) while the card runs the queries. The script imports no JAX; without
a card, or without the package beside it, it exits non-zero and prints no
result.
"""

from __future__ import annotations

import argparse
import concurrent.futures
import gc
import json
import re
import statistics
import subprocess
import sys
import time
from pathlib import Path
from typing import Optional

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
# the public wrappers whose launches are each TPU kernel's
WRAPPERS = {"bucket_count": ("bucket_count",), "bucket_sum": ("bucket_sum",),
            "partition_sort": ("partition_sort", "partition_columns")}
GRACE_K = 16  # the partition count every grace run is sized to
TABLES = ("lineitem", "orders", "customer", "supplier", "nation", "region")
PART_TABLES = ("part", "partsupp")  # Q2, Q9 and Q19's


_START = time.perf_counter()


def emit(obj) -> None:
    """One JSON line; a phase's line carries the script's seconds so far."""
    if "phase" in obj:
        obj = dict(obj, elapsed_s=round(time.perf_counter() - _START, 1))
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


def oracle_q3(li, od, cu, cut: int):
    """Q3 with numpy alone: customers of segment BUILDING, their orders
    before ``cut`` (joined by np.searchsorted on the unique c_custkey), the
    lines shipped after it (joined on the unique o_orderkey), revenue per
    order summed exactly in int64 (at most 7 lines of at most 1.05e9 at
    scale 4), and the top 10 by revenue descending, then order date, then
    order key (the aggregate's key order, which decides the engine's ties).
    Returns ([(l_orderkey, revenue, o_orderdate, o_shippriority)], the
    number of groups)."""
    def lookup(keys, probe):
        """Index into ``keys`` (sorted, unique) of each probe key, and found."""
        if not len(keys):
            return np.zeros(len(probe), np.int64), np.zeros(len(probe), bool)
        pos = np.clip(np.searchsorted(keys, probe), 0, len(keys) - 1)
        return pos, keys[pos] == probe

    ckeys = np.sort(cu["c_custkey"][cu["c_mktsegment"] == "BUILDING"])
    if len(np.unique(ckeys)) != len(ckeys) or len(np.unique(od["o_orderkey"])) != len(
            od["o_orderkey"]):
        raise AssertionError("c_custkey or o_orderkey is not unique")
    om = od["o_orderdate"] < cut
    _, hit = lookup(ckeys, od["o_custkey"][om])
    okey, odate, oprio = (od[c][om][hit] for c in ("o_orderkey", "o_orderdate",
                                                   "o_shippriority"))
    order = np.argsort(okey, kind="stable")
    okey, odate, oprio = okey[order], odate[order], oprio[order]
    lm = li["l_shipdate"] > cut
    pos, found = lookup(okey, li["l_orderkey"][lm])
    line_rev = li["l_extendedprice"][lm][found] * (100 - li["l_discount"][lm][found])
    rev = np.zeros(len(okey), np.int64)
    np.add.at(rev, pos[found], line_rev)
    has = np.zeros(len(okey), bool)
    has[pos[found]] = True
    okey, odate, oprio, rev = okey[has], odate[has], oprio[has], rev[has]
    top = np.lexsort((okey, odate, -rev))[:10]
    return [(int(okey[i]), int(rev[i]), int(odate[i]), int(oprio[i])) for i in top], int(
        has.sum())


def check_q3(out, expect, what: str) -> None:
    want, _ = expect
    cols = ("l_orderkey", "revenue", "o_orderdate", "o_shippriority")
    got = [tuple(int(out[c][i]) for c in cols) for i in range(len(out["l_orderkey"]))]
    if got != want or not all(out[c + "__valid"].all() for c in cols):
        raise AssertionError(f"{what}: got {got}, expected {want}")


def oracle_q4(li, od, lo: int, hi: int):
    """Q4 with numpy alone: the orders of [lo, hi), those whose key is among
    the keys of lines committed before received (np.isin), counted per
    priority. Returns [(priority, count)] in priority order."""
    om = (od["o_orderdate"] >= lo) & (od["o_orderdate"] < hi)
    late = li["l_orderkey"][li["l_commitdate"] < li["l_receiptdate"]]
    prio = od["o_orderpriority"][om][np.isin(od["o_orderkey"][om], late)]
    return [(p, int((prio == p).sum())) for p in sorted(set(prio.tolist()))]


def check_q4(out, expect, what: str) -> None:
    got = [(out["o_orderpriority"][i], int(out["order_count"][i]))
           for i in range(len(out["o_orderpriority"]))]
    valid = out["o_orderpriority__valid"].all() and out["order_count__valid"].all()
    if got != expect or not valid:
        raise AssertionError(f"{what}: got {got}, expected {expect}")


def oracle_q15(li, su, lo: int, hi: int):
    """Q15 with numpy alone: each supplier's revenue over the lines shipped
    in [lo, hi), summed exactly in int64 (scale 4, at most 1.05e9 a line),
    the largest, and every supplier that reaches it, joined to ``supplier``
    by key. Returns [(s_suppkey, s_name, total_revenue)] by key."""
    m = (li["l_shipdate"] >= lo) & (li["l_shipdate"] < hi)
    keys, inv = np.unique(li["l_suppkey"][m], return_inverse=True)
    total = np.zeros(len(keys), np.int64)
    np.add.at(total, inv, li["l_extendedprice"][m] * (100 - li["l_discount"][m]))
    best = int(total.max())
    top = keys[total == best]
    sel = np.isin(su["s_suppkey"], top)
    names = dict(zip(su["s_suppkey"][sel].tolist(), su["s_name"][sel]))
    return [(k, names[k], best) for k in sorted(top.tolist()) if k in names]


def check_q15(out, expect, what: str) -> None:
    cols = ("s_suppkey", "s_name", "total_revenue")
    got = [(int(out["s_suppkey"][i]), out["s_name"][i], int(out["total_revenue"][i]))
           for i in range(len(out["s_suppkey"]))]
    if got != expect or not all(out[c + "__valid"].all() for c in cols):
        raise AssertionError(f"{what}: got {got}, expected {expect}")


def _lookup(keys, probe):
    """Index into ``keys`` (sorted, unique) of each probe key, and found."""
    if not len(keys):
        return np.zeros(len(probe), np.int64), np.zeros(len(probe), bool)
    pos = np.clip(np.searchsorted(keys, probe), 0, len(keys) - 1)
    return pos, keys[pos] == probe


def _by_key(table, key: str, *cols):
    """``table``'s ``key`` column sorted (it must be unique) and ``cols`` in
    its order."""
    order = np.argsort(table[key], kind="stable")
    keys = table[key][order]
    if len(np.unique(keys)) != len(keys):
        raise AssertionError(f"{key} is not unique")
    return (keys,) + tuple(table[c][order] for c in cols)


def oracle_q5(li, od, cu, su, na, re, lo: int, hi: int):
    """Q5 with numpy alone: the nations of region ASIA, their suppliers, the
    orders of [lo, hi) with their customers, and the lines whose supplier
    and customer are of one such nation (each join by np.searchsorted on
    the unique key), revenue per nation summed exactly in int64 (scale 4,
    at most 1.05e9 a line). Returns [(n_name, revenue)] by revenue
    descending, then name."""
    asia = re["r_regionkey"][re["r_name"] == "ASIA"]
    nkeys, nnames, nreg = _by_key(na, "n_nationkey", "n_name", "n_regionkey")
    skeys, snat = _by_key(su, "s_suppkey", "s_nationkey")
    ckeys, cnat = _by_key(cu, "c_custkey", "c_nationkey")
    om = (od["o_orderdate"] >= lo) & (od["o_orderdate"] < hi)
    okeys, ocust = _by_key({k: od[k][om] for k in ("o_orderkey", "o_custkey")},
                           "o_orderkey", "o_custkey")
    opos, ofound = _lookup(okeys, li["l_orderkey"])
    cpos, cfound = _lookup(ckeys, ocust[opos])
    spos, sfound = _lookup(skeys, li["l_suppkey"])
    nat = snat[spos]
    npos, nfound = _lookup(nkeys, nat)
    m = (ofound & cfound & sfound & nfound & (cnat[cpos] == nat)
         & np.isin(nreg[npos], asia))
    rev = li["l_extendedprice"][m] * (100 - li["l_discount"][m])
    names = nnames[npos[m]]
    out = [(n, int(rev[names == n].sum())) for n in sorted(set(names.tolist()))]
    return sorted(out, key=lambda r: (-r[1], r[0]))


def check_q5(out, expect, what: str) -> None:
    got = [(out["n_name"][i], int(out["revenue"][i])) for i in range(len(out["n_name"]))]
    if got != expect or not (out["n_name__valid"].all() and out["revenue__valid"].all()):
        raise AssertionError(f"{what}: got {got}, expected {expect}")


def oracle_q10(li, od, cu, na, lo: int, hi: int):
    """Q10 with numpy alone: the returned lines (flag R) of the orders of
    [lo, hi), joined to their orders, customers and nations by
    np.searchsorted on the unique keys, revenue per customer summed exactly
    in int64 (scale 4, at most 1.05e9 a line), the top 20 by revenue
    descending, then customer key (the aggregate's key order, which decides
    the engine's ties). Returns [(c_custkey, c_name, c_acctbal, n_name,
    revenue)]."""
    okeys, ocust, odate = _by_key(od, "o_orderkey", "o_custkey", "o_orderdate")
    ckeys, cname, cbal, cnat = _by_key(cu, "c_custkey", "c_name", "c_acctbal", "c_nationkey")
    nkeys, nname = _by_key(na, "n_nationkey", "n_name")
    lm = li["l_returnflag"] == "R"
    opos, ofound = _lookup(okeys, li["l_orderkey"][lm])
    ofound &= (odate[opos] >= lo) & (odate[opos] < hi)
    cpos, cfound = _lookup(ckeys, ocust[opos])
    npos, nfound = _lookup(nkeys, cnat[cpos])
    m = ofound & cfound & nfound
    rev = li["l_extendedprice"][lm][m] * (100 - li["l_discount"][lm][m])
    cust, inv = np.unique(cpos[m], return_inverse=True)
    total = np.zeros(len(cust), np.int64)
    np.add.at(total, inv, rev)
    nat = nname[_lookup(nkeys, cnat[cust])[0]]
    top = np.lexsort((ckeys[cust], -total))[:20]
    return [(int(ckeys[cust[i]]), cname[cust[i]], int(cbal[cust[i]]), nat[i], int(total[i]))
            for i in top]


def check_q10(out, expect, what: str) -> None:
    cols = ("c_custkey", "c_name", "c_acctbal", "n_name", "revenue")
    got = [tuple(out[c][i] if c in ("c_name", "n_name") else int(out[c][i]) for c in cols)
           for i in range(len(out["c_custkey"]))]
    if got != expect or not all(out[c + "__valid"].all() for c in cols):
        raise AssertionError(f"{what}: got {got}, expected {expect}")


def oracle_q18(li, od, cu, min_qty: int = 300):
    """Q18 with numpy alone: the orders whose lines' quantities sum past
    ``min_qty`` (scale 0; the sums are exact int64 at scale 2), with their
    customers (np.searchsorted on the unique c_custkey), the top 100 by
    total price descending, then order date, then customer name, customer
    key and order key (the aggregate's key order, which decides the
    engine's ties). Returns [(c_name, c_custkey, o_orderkey, o_orderdate,
    o_totalprice, sum_qty)]."""
    keys, inv = np.unique(li["l_orderkey"], return_inverse=True)
    qty = np.zeros(len(keys), np.int64)
    np.add.at(qty, inv, li["l_quantity"])
    big = qty > min_qty * 100
    okeys, ocust, odate, oprice = _by_key(od, "o_orderkey", "o_custkey", "o_orderdate",
                                          "o_totalprice")
    opos, ofound = _lookup(okeys, keys[big])
    ckeys, cname = _by_key(cu, "c_custkey", "c_name")
    cpos, cfound = _lookup(ckeys, ocust[opos])
    m = ofound & cfound
    rows = [(cname[c], int(ckeys[c]), int(okeys[o]), int(odate[o]), int(oprice[o]), int(q))
            for o, c, q in zip(opos[m], cpos[m], qty[big][m])]
    return sorted(rows, key=lambda r: (-r[4], r[3], r[0].encode(), r[1], r[2]))[:100]


def check_q18(out, expect, what: str) -> None:
    cols = ("c_name", "c_custkey", "o_orderkey", "o_orderdate", "o_totalprice", "sum_qty")
    got = [tuple(out[c][i] if c == "c_name" else int(out[c][i]) for c in cols)
           for i in range(len(out["c_custkey"]))]
    if got != expect or not all(out[c + "__valid"].all() for c in cols):
        raise AssertionError(f"{what}: got {got}, expected {expect}")


def _year(days: np.ndarray) -> np.ndarray:
    """The calendar year of days since 1970-01-01 (numpy datetime64)."""
    return (np.datetime64("1970-01-01", "D") + days.astype("timedelta64[D]")).astype(
        "datetime64[Y]").astype(np.int64) + 1970


def oracle_q19(li, pa):
    """Q19 with numpy alone: the lines shipped by AIR or REG AIR, their part
    (np.searchsorted on the unique p_partkey), the three brand, container,
    quantity and size clauses, revenue summed exactly in int64 (scale 4, at
    most 1.05e9 a line). Returns the revenue, or None where no line
    qualifies (SQL's SUM of no rows)."""
    pkeys, brand, cont, size = _by_key(pa, "p_partkey", "p_brand", "p_container", "p_size")
    sm = li["l_shipmode"]
    lm = (sm == "AIR") | (sm == "REG AIR")
    pos, found = _lookup(pkeys, li["l_partkey"][lm])
    b, c, sz = brand[pos], cont[pos], size[pos]
    qty = li["l_quantity"][lm]
    m = np.zeros(len(pos), bool)
    for br, ct, qlo, qhi, szhi in (("Brand#12", "SM CASE", 1, 11, 5),
                                   ("Brand#23", "MED BAG", 10, 20, 10),
                                   ("Brand#34", "LG BOX", 20, 30, 15)):
        m |= ((b == br) & (c == ct) & (qty >= qlo * 100) & (qty <= qhi * 100) & (sz >= 1)
              & (sz <= szhi))
    m &= found
    if not m.any():
        return None
    return _exact_sum(li["l_extendedprice"][lm][m] * (100 - li["l_discount"][lm][m]))


def check_q19(out, expect, what: str) -> None:
    valid = bool(out["revenue__valid"][0]) if len(out["revenue"]) == 1 else None
    got = int(out["revenue"][0]) if valid else None
    if len(out["revenue"]) != 1 or got != expect or valid != (expect is not None):
        raise AssertionError(f"{what}: got {out['revenue'].tolist()} "
                             f"(valid {out['revenue__valid'].tolist()}), expected {expect}")


def oracle_q2(pa, su, ps, na, re):
    """Q2 with numpy alone: the EUROPE suppliers (their nation and region by
    np.searchsorted on the unique keys), their partsupp rows, the least
    supply cost of each part among them, the rows of the parts of size 15
    whose type ends in BRASS at that cost, the top 100 by supplier balance
    descending, then nation name, supplier name and part key. Returns
    [(s_acctbal, s_name, n_name, p_partkey, p_brand)]."""
    europe = re["r_regionkey"][re["r_name"] == "EUROPE"]
    nkeys, nname, nreg = _by_key(na, "n_nationkey", "n_name", "n_regionkey")
    skeys, snat, sbal, sname = _by_key(su, "s_suppkey", "s_nationkey", "s_acctbal", "s_name")
    pkeys, psize, ptype, pbrand = _by_key(pa, "p_partkey", "p_size", "p_type", "p_brand")
    spos, sfound = _lookup(skeys, ps["ps_suppkey"])
    npos, nfound = _lookup(nkeys, snat[spos])
    eu = sfound & nfound & np.isin(nreg[npos], europe)
    part, cost, spos, npos = ps["ps_partkey"][eu], ps["ps_supplycost"][eu], spos[eu], npos[eu]
    parts, inv = np.unique(part, return_inverse=True)
    least = np.full(len(parts), np.iinfo(np.int64).max)
    np.minimum.at(least, inv, cost)
    ppos, pfound = _lookup(pkeys, part)
    brass = np.array([t.endswith("BRASS") for t in ptype[ppos]], bool)
    m = pfound & (psize[ppos] == 15) & brass & (cost == least[inv])
    rows = [(int(sbal[s]), sname[s], nname[n], int(p), pbrand[pp])
            for s, n, p, pp in zip(spos[m], npos[m], part[m], ppos[m])]
    return sorted(rows, key=lambda r: (-r[0], r[2].encode(), r[1].encode(), r[3]))[:100]


def check_q2(out, expect, what: str) -> None:
    cols = ("s_acctbal", "s_name", "n_name", "p_partkey", "p_brand")
    got = [tuple(int(out[c][i]) if c in ("s_acctbal", "p_partkey") else out[c][i] for c in cols)
           for i in range(len(out["p_partkey"]))]
    if got != expect or not all(out[c + "__valid"].all() for c in cols):
        raise AssertionError(f"{what}: got {got[:5]}..., expected {expect[:5]}...")


def oracle_q9(li, pa, ps, su, od, na):
    """Q9 with numpy alone: the parts whose name holds 'green', their lines,
    every partsupp row of each line's (supplier, part) pair (the pairs
    repeat: an INNER join multiplies), the supplier's nation and the
    order's year (np.searchsorted on the unique keys), profit summed
    exactly per nation and year (scale 4: price x (1 - discount) less
    supply cost x quantity). Returns [(nation, o_year, sum_profit)] by
    nation, then year descending."""
    green = pa["p_partkey"][np.array(["green" in n for n in pa["p_name"]], bool)]
    lm = np.isin(li["l_partkey"], green)
    lsupp, lpart = li["l_suppkey"][lm], li["l_partkey"][lm]
    span = int(max(ps["ps_suppkey"].max(), lsupp.max(initial=0))) + 1
    pair = ps["ps_partkey"] * span + ps["ps_suppkey"]
    order = np.argsort(pair, kind="stable")
    spair, scost = pair[order], ps["ps_supplycost"][order]
    want = lpart * span + lsupp
    lo, hi = np.searchsorted(spair, want, "left"), np.searchsorted(spair, want, "right")
    counts = hi - lo  # one row a matching partsupp row
    line = np.repeat(np.arange(len(want)), counts)
    first = np.repeat(lo - (np.cumsum(counts) - counts), counts)
    cost = scost[first + np.arange(int(counts.sum()))]
    skeys, snat = _by_key(su, "s_suppkey", "s_nationkey")
    okeys, odate = _by_key(od, "o_orderkey", "o_orderdate")
    nkeys, nname = _by_key(na, "n_nationkey", "n_name")
    spos, sfound = _lookup(skeys, lsupp[line])
    opos, ofound = _lookup(okeys, li["l_orderkey"][lm][line])
    npos, nfound = _lookup(nkeys, snat[spos])
    m = sfound & ofound & nfound
    price, disc = li["l_extendedprice"][lm][line][m], li["l_discount"][lm][line][m]
    amount = price * (100 - disc) - cost[m] * li["l_quantity"][lm][line][m]
    nation, year = nname[npos[m]], _year(odate[opos[m]])
    sums = {}
    for k, a in zip(zip(nation.tolist(), year.tolist()), amount.tolist()):
        sums[k] = sums.get(k, 0) + a
    return [(n, y, sums[(n, y)]) for n, y in sorted(sums, key=lambda k: (k[0].encode(), -k[1]))]


def check_q9(out, expect, what: str) -> None:
    cols = ("nation", "o_year", "sum_profit")
    got = [(out["nation"][i], int(out["o_year"][i]), int(out["sum_profit"][i]))
           for i in range(len(out["nation"]))]
    if got != expect or not all(out[c + "__valid"].all() for c in cols):
        raise AssertionError(f"{what}: got {got[:5]}..., expected {expect[:5]}...")


# FLOAT64 results that are sums of floats over many rows (Q8's volumes):
# their order of addition differs from the oracle's, so they are held to it
# within this relative tolerance; the other float results (Q11's threshold,
# Q14's ratio, Q17's average) are exact decimals converted and divided by
# the same float operations in numpy, and must come out bit-equal
FLOAT_SUM_RTOL = 1e-9
# TPC-H Q11's FRACTION at SF1 (the spec's is 0.0001 / SF)
Q11_FRACTION = 0.0001


def oracle_q7(li, su, od, cu, na, lo: int, hi: int):
    """Q7 with numpy alone: the lines shipped in [lo, hi], their supplier's
    and their order's customer's nation (np.searchsorted on the unique
    keys), kept where one is FRANCE and the other GERMANY, revenue (scale 4)
    summed exactly per supplier nation, customer nation and ship year.
    Returns [(supp_nation, cust_nation, l_year, revenue)] in that order."""
    lm = (li["l_shipdate"] >= lo) & (li["l_shipdate"] <= hi)
    skeys, snat = _by_key(su, "s_suppkey", "s_nationkey")
    okeys, ocust = _by_key(od, "o_orderkey", "o_custkey")
    ckeys, cnat = _by_key(cu, "c_custkey", "c_nationkey")
    nkeys, nname = _by_key(na, "n_nationkey", "n_name")
    spos, sfound = _lookup(skeys, li["l_suppkey"][lm])
    opos, ofound = _lookup(okeys, li["l_orderkey"][lm])
    cpos, cfound = _lookup(ckeys, ocust[opos])
    sn = nname[_lookup(nkeys, snat[spos])[0]]
    cn = nname[_lookup(nkeys, cnat[cpos])[0]]
    m = (sfound & ofound & cfound & (((sn == "FRANCE") & (cn == "GERMANY"))
                                      | ((sn == "GERMANY") & (cn == "FRANCE"))))
    vol = li["l_extendedprice"][lm][m] * (100 - li["l_discount"][lm][m])
    keys = list(zip(sn[m].tolist(), cn[m].tolist(), _year(li["l_shipdate"][lm][m]).tolist()))
    sums = {}
    for k, v in zip(keys, vol.tolist()):
        sums[k] = sums.get(k, 0) + v
    return [k + (sums[k],) for k in sorted(sums, key=lambda k: (k[0].encode(), k[1].encode(),
                                                                 k[2]))]


def check_q7(out, expect, what: str) -> None:
    cols = ("supp_nation", "cust_nation", "l_year", "revenue")
    got = [(out["supp_nation"][i], out["cust_nation"][i], int(out["l_year"][i]),
            int(out["revenue"][i])) for i in range(len(out["revenue"]))]
    if got != expect or not all(out[c + "__valid"].all() for c in cols):
        raise AssertionError(f"{what}: got {got}, expected {expect}")


def oracle_q8(li, pa, od, cu, su, na, re, lo: int, hi: int):
    """Q8 with numpy alone: the lines of ECONOMY ANODIZED STEEL parts whose
    order falls in [lo, hi] and whose customer's nation is in AMERICA (each
    join by np.searchsorted on the unique keys); each line's volume, its
    exact scale-4 decimal converted to float64 and divided by 1e4 as the
    engine casts it, summed per order year in float64, BRAZIL's suppliers'
    apart. Returns [(o_year, BRAZIL's volume / all volume)] by year."""
    america = re["r_regionkey"][re["r_name"] == "AMERICA"]
    parts = pa["p_partkey"][pa["p_type"] == "ECONOMY ANODIZED STEEL"]
    lm = np.isin(li["l_partkey"], parts)
    om = (od["o_orderdate"] >= lo) & (od["o_orderdate"] <= hi)
    okeys, ocust, odate = _by_key({k: od[k][om] for k in ("o_orderkey", "o_custkey",
                                                         "o_orderdate")},
                                  "o_orderkey", "o_custkey", "o_orderdate")
    ckeys, cnat = _by_key(cu, "c_custkey", "c_nationkey")
    skeys, snat = _by_key(su, "s_suppkey", "s_nationkey")
    nkeys, nname, nreg = _by_key(na, "n_nationkey", "n_name", "n_regionkey")
    opos, ofound = _lookup(okeys, li["l_orderkey"][lm])
    cpos, cfound = _lookup(ckeys, ocust[opos])
    spos, sfound = _lookup(skeys, li["l_suppkey"][lm])
    cnpos, cnfound = _lookup(nkeys, cnat[cpos])
    snpos, snfound = _lookup(nkeys, snat[spos])
    m = ofound & cfound & sfound & cnfound & snfound & np.isin(nreg[cnpos], america)
    vol = (li["l_extendedprice"][lm][m] * (100 - li["l_discount"][lm][m])).astype(
        np.float64) / 1e4
    brazil = np.where(nname[snpos[m]] == "BRAZIL", vol, 0.0)
    year = _year(odate[opos[m]])
    return [(int(y), float(brazil[year == y].sum() / vol[year == y].sum()))
            for y in sorted(set(year.tolist()))]


def check_q8(out, expect, what: str) -> None:
    years = [int(y) for y in out["o_year"]]
    share = np.asarray(out["mkt_share"], np.float64)
    want = np.array([s for _, s in expect], np.float64)
    if (years != [y for y, _ in expect] or not out["mkt_share__valid"].all()
            or not np.allclose(share, want, rtol=FLOAT_SUM_RTOL, atol=0)):
        raise AssertionError(f"{what}: got {list(zip(years, share.tolist()))}, "
                             f"expected {expect} (rtol {FLOAT_SUM_RTOL})")


def oracle_q11(ps, su, na, fraction: float):
    """Q11 with numpy alone: the partsupp rows of GERMANY's suppliers, value
    = supply cost x available quantity (scale 2) summed exactly per part
    and in all; the threshold is the total converted to float64, divided
    by 100 and times ``fraction``, as the engine computes it, and a part is
    kept where its value, converted alike, is above it. Returns (threshold,
    [(ps_partkey, value)] by value descending, then part key)."""
    ger = na["n_nationkey"][na["n_name"] == "GERMANY"]
    supp = su["s_suppkey"][np.isin(su["s_nationkey"], ger)]
    m = np.isin(ps["ps_suppkey"], supp)
    value = ps["ps_supplycost"][m] * ps["ps_availqty"][m].astype(np.int64)
    parts, inv = np.unique(ps["ps_partkey"][m], return_inverse=True)
    per_part = np.zeros(len(parts), np.int64)
    np.add.at(per_part, inv, value)
    threshold = np.float64(_exact_sum(value)) / 100.0 * fraction
    keep = per_part.astype(np.float64) / 100.0 > threshold
    rows = sorted(zip(parts[keep].tolist(), per_part[keep].tolist()), key=lambda r: (-r[1], r[0]))
    return float(threshold), rows


def check_q11(out, expect, what: str) -> None:
    got = [(int(out["ps_partkey"][i]), int(out["value"][i])) for i in range(len(out["value"]))]
    if got != expect[1] or not (out["ps_partkey__valid"].all() and out["value__valid"].all()):
        raise AssertionError(f"{what}: got {got[:5]}... ({len(got)} rows), "
                             f"expected {expect[1][:5]}... ({len(expect[1])} rows)")


def oracle_q14(li, pa, lo: int, hi: int) -> float:
    """Q14 with numpy alone: the lines shipped in [lo, hi), their part
    (np.searchsorted on the unique p_partkey), the PROMO parts' revenue and
    all revenue summed exactly (scale 4), each converted to float64 and
    divided by 1e4, then 100 x promo / total, the engine's operations."""
    pkeys, ptype = _by_key(pa, "p_partkey", "p_type")
    lm = (li["l_shipdate"] >= lo) & (li["l_shipdate"] < hi)
    pos, found = _lookup(pkeys, li["l_partkey"][lm])
    rev = (li["l_extendedprice"][lm] * (100 - li["l_discount"][lm]))[found]
    promo = np.array([t.startswith("PROMO") for t in ptype[pos[found]]], bool)
    a = np.float64(_exact_sum(rev[promo])) / 1e4
    b = np.float64(_exact_sum(rev)) / 1e4
    return float(np.float64(100.0) * a / b)


def oracle_q17(li, pa) -> float:
    """Q17 with numpy alone: each part's average quantity over all of
    lineitem (decimal(19,6): the exact sum at scale 6 over the count,
    HALF_UP), the lines of Brand#23 MED BAG parts whose quantity, converted
    to float64, is below 0.2 x that average converted alike, their price
    summed exactly and the sum's float64 over 7.0."""
    parts = pa["p_partkey"][(pa["p_brand"] == "Brand#23") & (pa["p_container"] == "MED BAG")]
    pk = li["l_partkey"]
    # per part key: the quantity sum (float64 weights: exact below 2^53) and count
    qsum = np.bincount(pk, weights=li["l_quantity"]).astype(np.int64)
    cnt = np.maximum(np.bincount(pk), 1).astype(np.int64)
    avg6 = (2 * qsum * 10**4 + cnt) // (2 * cnt)  # HALF_UP, the sums are >= 0
    lm = np.isin(pk, parts)
    qty = li["l_quantity"][lm].astype(np.float64) / 100.0
    thr = 0.2 * (avg6[pk[lm]].astype(np.float64) / 1e6)
    s = _exact_sum(li["l_extendedprice"][lm][qty < thr])
    return float(np.float64(s) / 100.0 / 7.0)


def check_scalar_f64(out, col: str, expect: float, what: str) -> None:
    """One FLOAT64 row, bit-equal to the oracle's."""
    if len(out[col]) != 1 or not out[col + "__valid"][0] or float(out[col][0]) != expect:
        raise AssertionError(f"{what}: got {out[col].tolist()} "
                             f"(valid {out[col + '__valid'].tolist()}), expected {expect!r}")


def _like(values, pattern: str) -> np.ndarray:
    """SQL LIKE over host strings ('%' any run, '_' one character)."""
    rx = re.compile("".join(".*" if c == "%" else "." if c == "_" else re.escape(c)
                            for c in pattern), re.S)
    return np.array([rx.fullmatch(v) is not None for v in values], bool)


def oracle_q13(cu, od):
    """Q13 with numpy alone, following the plan (ROADMAP C15): the orders
    whose o_orderpriority is NOT LIKE '%special%requests%' (all of them),
    their count per customer (0 for a customer with none: the LEFT join
    keeps it, and COUNT(o_orderkey) skips its null order), then the
    customers per count. Returns [(c_count, custdist)] by custdist
    descending, then c_count descending."""
    keep = ~_like(od["o_orderpriority"], "%special%requests%")
    ckeys = np.sort(cu["c_custkey"])
    pos, found = _lookup(ckeys, od["o_custkey"][keep])
    per_cust = np.bincount(pos[found], minlength=len(ckeys))
    counts, dist = np.unique(per_cust, return_counts=True)
    return sorted(zip(counts.tolist(), dist.tolist()), key=lambda r: (-r[1], -r[0]))


def check_q13(out, expect, what: str) -> None:
    got = list(zip(out["c_count"].tolist(), out["custdist"].tolist()))
    if got != expect or not (out["c_count__valid"].all() and out["custdist__valid"].all()):
        raise AssertionError(f"{what}: got {got}, expected {expect}")


def oracle_q16(pa, ps, su):
    """Q16 with numpy alone: the parts of another brand than Brand#45, a
    type NOT LIKE 'MEDIUM POLISHED%' and one of eight sizes, their partsupp
    rows (np.searchsorted on the unique p_partkey) less those of suppliers
    whose comment is LIKE '%Customer%Complaints%', the distinct suppliers
    per (brand, type, size). Returns [(p_brand, p_type, p_size,
    supplier_cnt)] by the count descending, then brand, type and size."""
    pm = ((pa["p_brand"] != "Brand#45") & ~_like(pa["p_type"], "MEDIUM POLISHED%")
          & np.isin(pa["p_size"], [49, 14, 23, 45, 19, 3, 36, 9]))
    pkeys, brand, ptype, size = _by_key({k: pa[k][pm] for k in pa}, "p_partkey", "p_brand",
                                        "p_type", "p_size")
    pos, found = _lookup(pkeys, ps["ps_partkey"])
    bad = su["s_suppkey"][_like(su["s_comment"], "%Customer%Complaints%")]
    m = found & ~np.isin(ps["ps_suppkey"], bad)
    groups = {}
    for b, t, z, sk in zip(brand[pos[m]], ptype[pos[m]], size[pos[m]].tolist(),
                           ps["ps_suppkey"][m].tolist()):
        groups.setdefault((b, t, z), set()).add(sk)
    return sorted(((b, t, z, len(v)) for (b, t, z), v in groups.items()),
                  key=lambda r: (-r[3], r[0].encode(), r[1].encode(), r[2]))


def check_q16(out, expect, what: str) -> None:
    cols = ("p_brand", "p_type", "p_size", "supplier_cnt")
    got = [(out["p_brand"][i], out["p_type"][i], int(out["p_size"][i]),
            int(out["supplier_cnt"][i])) for i in range(len(out["p_size"]))]
    if got != expect or not all(out[c + "__valid"].all() for c in cols):
        raise AssertionError(f"{what}: got {got[:5]}..., expected {expect[:5]}...")


# Q20 at TPC-H's literals is empty at every scale (ROADMAP C16); these keep
# the plan's shape and give rows
Q20_VARIANT = {"pattern": "%", "ship_from": "1992-01-01", "ship_to": "1999-01-01"}


def oracle_q20(pa, li, ps, su, na, pattern: str, lo: int, hi: int):
    """Q20 with numpy alone: the parts whose name is LIKE ``pattern``, the
    quantity shipped per (part, supplier) in [lo, hi) (exact, scale 2), the
    partsupp rows of those parts whose availqty as a DOUBLE is over 0.005 x
    that quantity as a DOUBLE (the plan's float operations), and the CANADA
    suppliers among theirs. Returns [(s_name, s_suppkey)] by name."""
    parts = pa["p_partkey"][_like(pa["p_name"], pattern)]
    lm = (li["l_shipdate"] >= lo) & (li["l_shipdate"] < hi)
    span = int(max(li["l_suppkey"].max(), ps["ps_suppkey"].max())) + 1
    pairs, inv = np.unique(li["l_partkey"][lm] * span + li["l_suppkey"][lm],
                           return_inverse=True)
    qty = np.zeros(len(pairs), np.int64)
    np.add.at(qty, inv, li["l_quantity"][lm])
    pm = np.isin(ps["ps_partkey"], parts)
    pos, found = _lookup(pairs, ps["ps_partkey"][pm] * span + ps["ps_suppkey"][pm])
    shipped = qty[pos].astype(np.float64) / np.float64(100.0)
    ok = found & (ps["ps_availqty"][pm].astype(np.int64).astype(np.float64)
                  > np.float64(0.005) * shipped)
    canada = na["n_nationkey"][na["n_name"] == "CANADA"]
    sm = np.isin(su["s_nationkey"], canada) & np.isin(su["s_suppkey"], ps["ps_suppkey"][pm][ok])
    return sorted(zip(su["s_name"][sm].tolist(), su["s_suppkey"][sm].tolist()),
                  key=lambda r: r[0].encode())


def check_q20(out, expect, what: str) -> None:
    got = list(zip(out["s_name"].tolist(), out["s_suppkey"].tolist()))
    if got != expect or not (out["s_name__valid"].all() and out["s_suppkey__valid"].all()):
        raise AssertionError(f"{what}: got {got[:5]}..., expected {expect[:5]}...")


def oracle_q21(li, od, su, na):
    """Q21 with numpy alone, by distinct suppliers and not by the join's
    min/max: a late lineitem row (receipt after commit) of an 'F' order
    from a SAUDI ARABIA supplier counts where its order has at least two
    distinct suppliers and exactly one distinct late supplier (np.unique
    over (orderkey, suppkey) pairs). Returns [(s_name, numwait)] by
    numwait descending, then name, the first 100."""
    late = li["l_receiptdate"] > li["l_commitdate"]
    ok, sk = li["l_orderkey"], li["l_suppkey"]
    span = int(sk.max()) + 1
    n_ord = int(ok.max()) + 1

    def distinct_suppliers(m):
        pairs = np.sort(ok[m] * span + sk[m])  # np.unique by a sort: fast in any numpy
        pairs = pairs[np.concatenate(([True], pairs[1:] != pairs[:-1]))]
        return np.bincount(pairs // span, minlength=n_ord)

    saudi = na["n_nationkey"][na["n_name"] == "SAUDI ARABIA"]
    sm = np.isin(su["s_nationkey"], saudi)
    skeys, names = _by_key({k: su[k][sm] for k in su}, "s_suppkey", "s_name")
    pos, found = _lookup(skeys, sk)
    f_orders = od["o_orderkey"][od["o_orderstatus"] == "F"]
    m = (late & found & np.isin(ok, f_orders) & (distinct_suppliers(np.ones_like(late))[ok] >= 2)
         & (distinct_suppliers(late)[ok] == 1))
    counts = np.bincount(pos[m], minlength=len(skeys))
    rows = [(names[i], int(c)) for i, c in enumerate(counts.tolist()) if c]
    return sorted(rows, key=lambda r: (-r[1], r[0].encode()))[:100]


def check_q21(out, expect, what: str) -> None:
    got = list(zip(out["s_name"].tolist(), out["numwait"].tolist()))
    if got != expect or not (out["s_name__valid"].all() and out["numwait__valid"].all()):
        raise AssertionError(f"{what}: got {got[:5]}..., expected {expect[:5]}...")


Q22_CODES = ("13", "31", "23", "29", "30", "18", "17")


def oracle_q22(cu, od):
    """Q22 with numpy alone: the code is c_phone's first two bytes; the
    decimal AVG of the positive balances over the seven codes, HALF_UP at
    the AVG's result scale (6: c_acctbal's 2 plus 4), compared as DOUBLEs
    (each balance / 100, the average / 10^6, as the plan casts them); the
    customers of those codes with a balance over it and no order, counted
    and their balances summed (scale 2) per code, exactly. Returns
    [(cntrycode, numcust, totacctbal)] by code."""
    code = np.asarray(cu["c_phone"]).astype("U2")
    bal = cu["c_acctbal"].astype(np.int64)
    m = np.isin(code, Q22_CODES)
    pos = m & (bal > 0)
    total, n = _exact_sum(bal[pos]), int(pos.sum())
    avg = (2 * total * 10**4 + n) // (2 * n)  # HALF_UP, positive
    rich = m & (bal.astype(np.float64) / np.float64(100.0)
                > np.float64(avg) / np.float64(10.0**6))
    keep = rich & ~np.isin(cu["c_custkey"], od["o_custkey"])
    return [(c, int((keep & (code == c)).sum()), _exact_sum(bal[keep & (code == c)]))
            for c in sorted(Q22_CODES) if (keep & (code == c)).any()]


def check_q22(out, expect, what: str) -> None:
    cols = ("cntrycode", "numcust", "totacctbal")
    got = [(out["cntrycode"][i], int(out["numcust"][i]), int(out["totacctbal"][i]))
           for i in range(len(out["numcust"]))]
    if got != expect or not all(out[c + "__valid"].all() for c in cols):
        raise AssertionError(f"{what}: got {got}, expected {expect}")


# ---- TPC-DS: numpy oracles of one query of each shape ---------------------------------


def _where(table, mask):
    """The rows of a table dict where ``mask`` holds."""
    return {k: v[mask] for k, v in table.items()}


def _codes(values):
    """(sorted distinct values, each row's rank among them): a string
    column of a small table coded once, its codes gathered through joins."""
    uniq, inv = np.unique(np.asarray(values), return_inverse=True)
    return uniq, inv.ravel()


def _group_by(*parts):
    """Rows grouped by key columns, each an int array or a (distinct
    values, codes) pair from ``_codes``: (group key tuples in ascending key
    order, each row's group)."""
    cols, lookups = [], []
    for p in parts:
        if isinstance(p, tuple):
            lookups.append(p[0])
            cols.append(p[1])
        else:
            lookups.append(None)
            cols.append(np.asarray(p))
    n = len(cols[0])
    if not n:
        return [], np.zeros(0, np.int64)
    order = np.lexsort(cols[::-1])  # the first key most significant
    ranked = [c[order] for c in cols]
    first = np.zeros(n, bool)
    first[0] = True
    for c in ranked:
        first[1:] |= c[1:] != c[:-1]
    inv = np.empty(n, np.int64)
    inv[order] = np.cumsum(first) - 1
    heads = np.flatnonzero(first)
    keys = [tuple(v.item() if lk is None else lk[v] for v, lk in zip(row, lookups))
            for row in zip(*(c[heads] for c in ranked))]
    return keys, inv


def _group_sums(inv, n: int, values) -> list:
    """Each group's exact integer sum."""
    out = np.zeros(n, np.int64)
    np.add.at(out, inv, np.asarray(values, np.int64))
    return [int(v) for v in out]


def _avg_half_up(total: int, count: int, k: int) -> int:
    """total / count at k more decimal places, rounded HALF_UP (the decimal
    AVG's result scale is its input's plus 4)."""
    num, sign = abs(total) * 10**k, -1 if total < 0 else 1
    return sign * ((2 * num + count) // (2 * count))


def _decimal_avgs(inv, n: int, cols) -> list:
    """Per group: each column's decimal AVG (the input scale plus 4)."""
    cnt = np.bincount(inv, minlength=n)
    sums = [_group_sums(inv, n, c) for c in cols]
    return [[_avg_half_up(s[g], int(cnt[g]), 4) for s in sums] for g in range(n)]


def _int_avgs(inv, n: int, col) -> list:
    """Per group: an integer column's AVG, a DOUBLE (its exact sum over the
    count, one float64 division)."""
    cnt = np.bincount(inv, minlength=n)
    return [float(np.float64(s) / np.float64(c)) for s, c in zip(_group_sums(inv, n, col), cnt)]


def _ordered(rows, key, fetch=None):
    """Rows (in the aggregate's key order) stably sorted by ``key``, the
    first ``fetch`` of them."""
    out = sorted(rows, key=key)
    return out if fetch is None else out[:fetch]


def _ds_star(fact, joins):
    """A fact table's rows that find their key in each dimension: joins is
    [(fact key column, sorted unique dimension keys)]; (row mask, each
    join's position into its dimension)."""
    m = np.ones(len(fact[joins[0][0]]), bool)
    pos = []
    for fk, keys in joins:
        p, found = _lookup(keys, fact[fk])
        m &= found
        pos.append(p)
    return m, pos


def oracle_ds_q3(d):
    """TPC-DS q3: store_sales joined to November dates and manufacturer
    128's items, SUM(ss_ext_sales_price) per (d_year, i_brand_id, i_brand),
    by year, the sum descending, brand id; the first 100."""
    dt, it, ss = d["date_dim"], d["item"], d["store_sales"]
    dk, year = _by_key(_where(dt, dt["d_moy"] == 11), "d_date_sk", "d_year")
    ik, bid, brand = _by_key(_where(it, it["i_manufact_id"] == 128), "i_item_sk", "i_brand_id",
                             "i_brand")
    return _brand_rows(ss, dk, year, ik, bid, brand)


def _brand_rows(ss, dk, year, ik, bid, brand):
    m, (dp, ip) = _ds_star(ss, [("ss_sold_date_sk", dk), ("ss_item_sk", ik)])
    bcodes = _codes(brand)
    keys, inv = _group_by(year[dp[m]], bid[ip[m]], (bcodes[0], bcodes[1][ip[m]]))
    sums = _group_sums(inv, len(keys), ss["ss_ext_sales_price"][m])
    rows = [k + (s,) for k, s in zip(keys, sums)]
    return _ordered(rows, lambda r: (r[0], -r[3], r[1]), 100)


def oracle_ds_brand_month(d, manager: int, moy: int, year: int):
    """``_brand_month_query`` (q52, q55): store_sales of one month and year
    joined to one manager's items, SUM(ss_ext_sales_price) per (d_year,
    i_brand_id, i_brand), by year, the sum descending, brand id; 100."""
    dt, it, ss = d["date_dim"], d["item"], d["store_sales"]
    dk, yr = _by_key(_where(dt, (dt["d_moy"] == moy) & (dt["d_year"] == year)), "d_date_sk",
                     "d_year")
    ik, bid, brand = _by_key(_where(it, it["i_manager_id"] == manager), "i_item_sk",
                             "i_brand_id", "i_brand")
    return _brand_rows(ss, dk, yr, ik, bid, brand)


TPCDS_DAYS = ("Sunday", "Monday", "Tuesday", "Wednesday", "Thursday", "Friday", "Saturday")


def oracle_ds_q43(d):
    """TPC-DS q43: store_sales of 2000 joined to store, per (s_store_name,
    s_store_id) the SUM of ss_sales_price on each day name (null where the
    store sold nothing that day), by name and id; 100."""
    dt, st, ss = d["date_dim"], d["store"], d["store_sales"]
    dk, day = _by_key(_where(dt, dt["d_year"] == 2000), "d_date_sk", "d_day_name")
    sk, name, sid = _by_key(st, "s_store_sk", "s_store_name", "s_store_id")
    m, (dp, sp) = _ds_star(ss, [("ss_sold_date_sk", dk), ("ss_store_sk", sk)])
    ncodes, icodes = _codes(name), _codes(sid)
    keys, inv = _group_by((ncodes[0], ncodes[1][sp[m]]), (icodes[0], icodes[1][sp[m]]))
    price, days = ss["ss_sales_price"][m], day[dp[m]]
    cols = []
    for dn in TPCDS_DAYS:
        hit = days == dn
        sums = _group_sums(inv[hit], len(keys), price[hit])
        seen = np.bincount(inv[hit], minlength=len(keys)) > 0
        cols.append([s if h else None for s, h in zip(sums, seen)])
    rows = [k + tuple(c[g] for c in cols) for g, k in enumerate(keys)]
    return _ordered(rows, lambda r: (r[0], r[1]), 100)


def oracle_ds_q96(d):
    """TPC-DS q96: COUNT(*) of store_sales at 20:30-20:59 by households of
    5 dependents at store_0."""
    hd, td, st, ss = d["household_demographics"], d["time_dim"], d["store"], d["store_sales"]
    hk = np.sort(hd["hd_demo_sk"][hd["hd_dep_count"] == 5])
    tk = np.sort(td["t_time_sk"][(td["t_hour"] == 20) & (td["t_minute"] >= 30)])
    sk = np.sort(st["s_store_sk"][st["s_store_name"] == "store_0"])
    m, _ = _ds_star(ss, [("ss_hdemo_sk", hk), ("ss_sold_time_sk", tk), ("ss_store_sk", sk)])
    return [(int(m.sum()),)]


def oracle_ds_q88(d):
    """TPC-DS q88: for each half hour from 8:00 to 11:59, COUNT(*) of
    store_sales by households of 5 dependents at store_0 (each count a
    scalar subquery): one row of eight counts. The household and store
    joins are looked up once, the time of day only over the rows they keep."""
    hd, td, st, ss = d["household_demographics"], d["time_dim"], d["store"], d["store_sales"]
    hk = np.sort(hd["hd_demo_sk"][hd["hd_dep_count"] == 5])
    sk = np.sort(st["s_store_sk"][st["s_store_name"] == "store_0"])
    m, _ = _ds_star(ss, [("ss_hdemo_sk", hk), ("ss_store_sk", sk)])
    times = ss["ss_sold_time_sk"][m]
    counts = []
    for h in (8, 9, 10, 11):
        for lo in (0, 30):
            tk = np.sort(td["t_time_sk"][(td["t_hour"] == h) & (td["t_minute"] >= lo)
                                         & (td["t_minute"] <= lo + 29)])
            counts.append(int(_lookup(tk, times)[1].sum()))
    return [tuple(counts)]


def oracle_ds_q90_scalar(d):
    """TPC-DS q90 in its scalar-subquery form: web_sales sold from 8:00 to
    9:59 over those sold from 19:00 to 20:59, a DOUBLE (null where the
    second count is 0: a division by zero)."""
    ws, td = d["web_sales"], d["time_dim"]

    def count(lo, hi):
        tk = np.sort(td["t_time_sk"][(td["t_hour"] >= lo) & (td["t_hour"] <= hi)])
        return int(_ds_star(ws, [("ws_sold_time_sk", tk)])[0].sum())

    am, pm = count(8, 9), count(19, 20)
    return [(float(np.float64(am) / np.float64(pm)) if pm else None,)]


# ---- Spark's runtime bloom filter, in numpy --------------------------------------------

_U32 = np.uint64(0xFFFFFFFF)


def _mul32(x, c: int):
    return (x * np.uint64(c)) & _U32


def _rotl32(x, r: int):
    return ((x << np.uint64(r)) | (x >> np.uint64(32 - r))) & _U32


def mm3_hash_long(values: np.ndarray, seeds: np.ndarray) -> np.ndarray:
    """Spark's Murmur3_x86_32.hashLong of int64 ``values`` under int32
    ``seeds``: the low 32-bit half, then the high half, then fmix with the
    length 8. int32 hashes."""
    def mix_k1(k):
        return _mul32(_rotl32(_mul32(k, 0xCC9E2D51), 15), 0x1B873593)

    def mix_h1(h, k):
        return (_mul32(_rotl32(h ^ k, 13), 5) + np.uint64(0xE6546B64)) & _U32

    u = values.astype(np.int64).view(np.uint64)
    h = seeds.astype(np.int64).view(np.uint64) & _U32
    h = mix_h1(mix_h1(h, mix_k1(u & _U32)), mix_k1(u >> np.uint64(32)))
    h ^= np.uint64(8)
    h = _mul32(h ^ (h >> np.uint64(16)), 0x85EBCA6B)
    h = _mul32(h ^ (h >> np.uint64(13)), 0xC2B2AE35)
    h ^= h >> np.uint64(16)
    return h.astype(np.uint32).view(np.int32)


def bloom_bits(values: np.ndarray, k: int, num_bits: int) -> np.ndarray:
    """(k, n) bit indices of int64 ``values`` (Spark's BloomFilterImpl.
    putLong: h1 + i * h2 as an int32, bit-inverted where negative, mod the
    bit count)."""
    h1 = mm3_hash_long(values, np.zeros(len(values), np.int32)).astype(np.int64)
    h2 = mm3_hash_long(values, h1.astype(np.int32)).astype(np.int64)
    out = []
    for i in range(1, k + 1):
        c = (h1 + i * h2) & 0xFFFFFFFF
        c = np.where(c >= 1 << 31, c - (1 << 32), c)
        out.append(np.where(c < 0, ~c, c) % num_bits)
    return np.array(out, np.int64).reshape(k, len(values))


def bloom_oracle(values: np.ndarray, k: int, num_bits: int) -> bytes:
    """Spark's serialized bloom filter (BloomFilterImpl.writeTo) of int64
    ``values``: version 1, k and the number of longs as big-endian int32s,
    then each long big-endian, bit j of a long being 1L << j."""
    bits = np.zeros(num_bits, bool)
    bits[bloom_bits(values, k, num_bits).reshape(-1)] = True
    body = np.packbits(bits.reshape(-1, 64)[:, ::-1], axis=1, bitorder="big")
    return np.array([1, k, num_bits // 64], ">i4").tobytes() + body.tobytes()


def bloom_probe_oracle(filter_bytes: bytes, values: np.ndarray) -> np.ndarray:
    """Whether each int64 value's k bits are all set in the filter."""
    k = int.from_bytes(filter_bytes[4:8], "big")
    bits = np.unpackbits(np.frombuffer(filter_bytes[12:], np.uint8).reshape(-1, 8)[:, ::-1],
                         axis=1, bitorder="little").reshape(-1).astype(bool)
    return bits[bloom_bits(values, k, len(bits))].all(0)


def oracle_ds_q7(d):
    """TPC-DS q7: store_sales of single male college customers in 2000 under
    a promotion off email or events, per i_item_id the AVG of ss_quantity (a
    DOUBLE) and of three prices (decimals, HALF_UP at scale 6), by
    i_item_id; 100."""
    cd, dt, pr, it, ss = (d[t] for t in ("customer_demographics", "date_dim", "promotion",
                                         "item", "store_sales"))
    ck = np.sort(cd["cd_demo_sk"][(cd["cd_gender"] == "M") & (cd["cd_marital_status"] == "S")
                                  & (cd["cd_education_status"] == "College")])
    dk = np.sort(dt["d_date_sk"][dt["d_year"] == 2000])
    pk = np.sort(pr["p_promo_sk"][(pr["p_channel_email"] == "N")
                                  | (pr["p_channel_event"] == "N")])
    ik, iid = _by_key(it, "i_item_sk", "i_item_id")
    m, (_, _, _, ip) = _ds_star(ss, [("ss_cdemo_sk", ck), ("ss_sold_date_sk", dk),
                                     ("ss_promo_sk", pk), ("ss_item_sk", ik)])
    icodes = _codes(iid)
    keys, inv = _group_by((icodes[0], icodes[1][ip[m]]))
    qty = _int_avgs(inv, len(keys), ss["ss_quantity"][m])
    decs = _decimal_avgs(inv, len(keys), [ss[c][m] for c in ("ss_list_price", "ss_coupon_amt",
                                                             "ss_sales_price")])
    rows = [k + (q,) + tuple(v) for k, q, v in zip(keys, qty, decs)]
    return _ordered(rows, lambda r: r[0], 100)


def oracle_ds_q73(d):
    """TPC-DS q73: tickets (per ss_ticket_number and ss_customer_sk) of the
    first two days of the months of 1999-2001, at any store, by households
    of high or unknown buying potential with more dependents than vehicles
    (a DOUBLE ratio over 1.0), with 1-5 items, joined to their customer; by
    count descending, last name, ticket; (c_last_name, c_first_name,
    c_salutation, c_preferred_cust_flag, ss_ticket_number, cnt)."""
    dt, st, hd, cu, ss = (d[t] for t in ("date_dim", "store", "household_demographics",
                                         "customer", "store_sales"))
    dk = np.sort(dt["d_date_sk"][(dt["d_dom"] >= 1) & (dt["d_dom"] <= 2)
                                 & np.isin(dt["d_year"], (1999, 2000, 2001))])
    veh = hd["hd_vehicle_count"]
    ratio = hd["hd_dep_count"].astype(np.float64) / np.where(veh > 0, veh, 1).astype(np.float64)
    hk = np.sort(hd["hd_demo_sk"][np.isin(hd["hd_buy_potential"], (">10000", "Unknown"))
                                  & (veh > 0) & (ratio > 1.0)])
    m, _ = _ds_star(ss, [("ss_sold_date_sk", dk), ("ss_store_sk", np.sort(st["s_store_sk"])),
                         ("ss_hdemo_sk", hk)])
    keys, inv = _group_by(ss["ss_ticket_number"][m], ss["ss_customer_sk"][m])
    cnt = np.bincount(inv, minlength=len(keys))
    ticket = np.array([k[0] for k in keys], np.int64)
    cust = np.array([k[1] for k in keys], np.int64)
    ck, last, first, sal, flag = _by_key(cu, "c_customer_sk", "c_last_name", "c_first_name",
                                         "c_salutation", "c_preferred_cust_flag")
    p, found = _lookup(ck, cust)
    keep = np.flatnonzero((cnt >= 1) & (cnt <= 5) & found)
    rows = [(last[p[g]], first[p[g]], sal[p[g]], flag[p[g]], int(ticket[g]), int(cnt[g]))
            for g in keep]
    return _ordered(rows, lambda r: (-r[5], r[0], r[4]))


def _ds_channel(d, fact: str, date_col: str, item_col: str, addr_col: str, price_col: str):
    """One channel of q33: sales of May 1998 shipped to GMT-5 addresses of
    Electronics items, SUM(price) per i_manufact_id: {manufact: sum}."""
    dt, ca, it, f = d["date_dim"], d["customer_address"], d["item"], d[fact]
    dk = np.sort(dt["d_date_sk"][(dt["d_year"] == 1998) & (dt["d_moy"] == 5)])
    ak = np.sort(ca["ca_address_sk"][ca["ca_gmt_offset"] == -5])
    ik, manu = _by_key(_where(it, it["i_category"] == "Electronics"), "i_item_sk",
                       "i_manufact_id")
    m, (_, _, ip) = _ds_star(f, [(date_col, dk), (addr_col, ak), (item_col, ik)])
    keys, inv = _group_by(manu[ip[m]])
    return dict(zip((k[0] for k in keys), _group_sums(inv, len(keys), f[price_col][m])))


def oracle_ds_q33(d):
    """TPC-DS q33: the three channels' ``_ds_channel`` sums under a UNION
    ALL, summed per i_manufact_id, by the total, then the id; 100."""
    total = {}
    for args in (("store_sales", "ss_sold_date_sk", "ss_item_sk", "ss_addr_sk",
                  "ss_ext_sales_price"),
                 ("catalog_sales", "cs_sold_date_sk", "cs_item_sk", "cs_ship_addr_sk",
                  "cs_ext_sales_price"),
                 ("web_sales", "ws_sold_date_sk", "ws_item_sk", "ws_ship_addr_sk",
                  "ws_ext_sales_price")):
        for k, v in _ds_channel(d, *args).items():
            total[k] = total.get(k, 0) + v
    return _ordered(sorted(total.items()), lambda r: (r[1], r[0]), 100)


def oracle_ds_q27(d):
    """TPC-DS q27: store_sales of single male college customers in 2000 at
    stores in TN or CA, under ROLLUP(i_item_id, s_state): per (item, state)
    (lochierarchy 0), per item (1, state null) and in all (2, both null)
    the AVG of ss_quantity (a DOUBLE) and of three prices (decimals); by
    item, then state, nulls first; 100."""
    cd, dt, st, it, ss = (d[t] for t in ("customer_demographics", "date_dim", "store", "item",
                                         "store_sales"))
    ck = np.sort(cd["cd_demo_sk"][(cd["cd_gender"] == "M") & (cd["cd_marital_status"] == "S")
                                  & (cd["cd_education_status"] == "College")])
    dk = np.sort(dt["d_date_sk"][dt["d_year"] == 2000])
    sk, state = _by_key(_where(st, np.isin(st["s_state"], ("TN", "CA"))), "s_store_sk",
                        "s_state")
    ik, iid = _by_key(it, "i_item_sk", "i_item_id")
    m, (_, sp, _, ip) = _ds_star(ss, [("ss_sold_date_sk", dk), ("ss_store_sk", sk),
                                      ("ss_cdemo_sk", ck), ("ss_item_sk", ik)])
    icodes, scodes = _codes(iid), _codes(state)
    item_part, state_part = (icodes[0], icodes[1][ip[m]]), (scodes[0], scodes[1][sp[m]])
    decs = [ss[c][m] for c in ("ss_list_price", "ss_coupon_amt", "ss_sales_price")]
    rows = []
    for level, parts in ((0, (item_part, state_part)), (1, (item_part,)),
                         (2, (np.zeros(int(m.sum()), np.int64),))):
        keys, inv = _group_by(*parts)
        qty = _int_avgs(inv, len(keys), ss["ss_quantity"][m])
        avgs = _decimal_avgs(inv, len(keys), decs)
        for k, q, v in zip(keys, qty, avgs):
            key = (k + (None,) * 2)[:2] if level < 2 else (None, None)
            rows.append(key + (level, q) + tuple(v))

    def nulls_first(v):
        return (v is not None, v or "")

    return _ordered(rows, lambda r: (nulls_first(r[0]), nulls_first(r[1])), 100)


def oracle_ds_q98(d):
    """TPC-DS q98: store_sales of February-March 1999 joined to items of
    Sports, Books or Home, SUM(ss_ext_sales_price) per (i_item_id,
    i_item_desc, i_category, i_class, i_current_price), each sum's share
    of its class's total as a DOUBLE (itemrevenue * 100 / class revenue,
    both cast as the plan casts them); by category, class, item id,
    description and ratio; 100."""
    dt, it, ss = d["date_dim"], d["item"], d["store_sales"]
    dk = np.sort(dt["d_date_sk"][(dt["d_year"] == 1999) & (dt["d_moy"] >= 2)
                                 & (dt["d_moy"] <= 3)])
    ik, *attrs = _by_key(_where(it, np.isin(it["i_category"], ("Sports", "Books", "Home"))),
                         "i_item_sk", "i_item_id", "i_item_desc", "i_category", "i_class",
                         "i_current_price")
    m, (_, ip) = _ds_star(ss, [("ss_sold_date_sk", dk), ("ss_item_sk", ik)])
    p = ip[m]
    parts = [(c[0], c[1][p]) for c in map(_codes, attrs[:4])] + [attrs[4][p]]
    keys, inv = _group_by(*parts)
    revenue = _group_sums(inv, len(keys), ss["ss_ext_sales_price"][m])
    class_total = {}
    for k, r in zip(keys, revenue):
        class_total[k[3]] = class_total.get(k[3], 0) + r
    rows = [k + (r, r / 100.0 * 100.0 / (class_total[k[3]] / 100.0))
            for k, r in zip(keys, revenue)]
    return _ordered(rows, lambda r: (r[2], r[3], r[0], r[1], r[6]), 100)


def oracle_ds_q51(d):
    """TPC-DS q51: per item, the running sum over dates of its daily web and
    store sales (ws/ss_sales_price) in month_seq 12-23; the two channels'
    (item, date) rows FULL-joined, a missing side's running sum 0; per item
    over dates the running maxima of both; the rows where the web's maximum
    is above the store's, by item and date; 100. Exact integers: each
    (item, date) key packs into one int64, and a running maximum restarts
    at each item by an offset of the item's rank times a bound over the
    values (the running sums are never negative)."""
    dt = d["date_dim"]
    dk = np.sort(dt["d_date_sk"][(dt["d_month_seq"] >= 12) & (dt["d_month_seq"] <= 23)])

    def restarts(keys):
        """Each position's first index of its item's run of keys."""
        item = keys >> 32
        start = np.r_[True, item[1:] != item[:-1]] if len(keys) else np.zeros(0, bool)
        return np.maximum.accumulate(np.where(start, np.arange(len(keys)), 0)), start

    def cumulative(fact, item_col, date_col, price_col):
        f = d[fact]
        m, _ = _ds_star(f, [(date_col, dk)])
        comb = (f[item_col][m].astype(np.int64) << 32) | f[date_col][m].astype(np.int64)
        order = np.argsort(comb, kind="stable")
        cs = comb[order]
        heads = np.flatnonzero(np.r_[True, cs[1:] != cs[:-1]]) if len(cs) else np.zeros(0, int)
        sums = np.add.reduceat(f[price_col][m][order].astype(np.int64), heads) \
            if len(cs) else np.zeros(0, np.int64)
        total = np.cumsum(sums)
        first, _ = restarts(cs[heads])
        return cs[heads], total - (total - sums)[first]

    (wk, wrun), (sk, srun) = (cumulative(*a) for a in (
        ("web_sales", "ws_item_sk", "ws_sold_date_sk", "ws_sales_price"),
        ("store_sales", "ss_item_sk", "ss_sold_date_sk", "ss_sales_price")))
    keys = np.union1d(wk, sk)
    w, s = np.zeros(len(keys), np.int64), np.zeros(len(keys), np.int64)
    w[np.searchsorted(keys, wk)], s[np.searchsorted(keys, sk)] = wrun, srun
    _, start = restarts(keys)
    rank = np.cumsum(start) - 1
    big = int(max(w.max(initial=0), s.max(initial=0))) + 1
    assert min(w.min(initial=0), s.min(initial=0)) >= 0 and int(rank.max(initial=0)) * big < 2**62
    wmax = np.maximum.accumulate(w + rank * big) - rank * big
    smax = np.maximum.accumulate(s + rank * big) - rank * big
    keep = np.flatnonzero(wmax > smax)[:100]
    return [(int(keys[i] >> 32), int(keys[i] & 0xFFFFFFFF), int(w[i]), int(s[i]), int(wmax[i]),
             int(smax[i])) for i in keep]


def oracle_ds_q39(d):
    """TPC-DS q39: inventory of 2000 per (warehouse, item, month): the mean
    of inv_quantity_on_hand and its sample standard deviation (two-pass:
    the squared deviations from the mean; NaN for one row), kept where
    stdev / mean > 1 or is NaN (a zero mean: null, dropped); each kept month joined
    to the same warehouse and item's next kept month; by warehouse, item,
    month and cov; 100. (w1, i1, m1, mean1, cov1, w2, i2, m2_off, mean2,
    cov2)."""
    inv, dt = d["inventory"], d["date_dim"]
    dk, moy = _by_key(_where(dt, dt["d_year"] == 2000), "d_date_sk", "d_moy")
    m, (dp, _, _) = _ds_star(inv, [("inv_date_sk", dk),
                                   ("inv_item_sk", np.sort(d["item"]["i_item_sk"])),
                                   ("inv_warehouse_sk",
                                    np.sort(d["warehouse"]["w_warehouse_sk"]))])
    keys, g = _group_by(inv["inv_warehouse_sk"][m], inv["inv_item_sk"][m], moy[dp[m]])
    q = inv["inv_quantity_on_hand"][m].astype(np.float64)
    n = np.bincount(g, minlength=len(keys)).astype(np.float64)
    mean = np.bincount(g, weights=q, minlength=len(keys)) / n
    m2 = np.bincount(g, weights=(q - mean[g]) ** 2, minlength=len(keys))
    with np.errstate(divide="ignore", invalid="ignore"):
        std = np.where(n > 1, np.sqrt(m2 / np.maximum(n - 1, 1)), np.nan)
        cov = std / mean
    # NaN (one row) is above every number in Spark's order: it passes
    kept = {k: (float(mean[i]), float(cov[i])) for i, k in enumerate(keys)
            if mean[i] != 0 and (cov[i] > 1.0 or np.isnan(cov[i]))}
    rows = [(w, i, mo, mn, cv, w, i, mo, *kept[(w, i, mo + 1)])
            for (w, i, mo), (mn, cv) in kept.items() if (w, i, mo + 1) in kept]
    return _ordered(rows, lambda r: r[:3], 100)  # (w, i, month) is unique


# per oracle query: its oracle, its output columns and the sort keys that
# order its rows (rows tied on them may come in any order)
TPCDS_ORACLES = {
    "q3": (oracle_ds_q3, ("d_year", "i_brand_id", "i_brand", "sum_agg"),
           ("d_year", "sum_agg", "i_brand_id")),
    "q52": (lambda d: oracle_ds_brand_month(d, 1, 12, 2000),
            ("d_year", "i_brand_id", "i_brand", "ext_price"), ("d_year", "ext_price", "i_brand_id")),
    "q55": (lambda d: oracle_ds_brand_month(d, 28, 11, 1999),
            ("d_year", "i_brand_id", "i_brand", "ext_price"), ("d_year", "ext_price", "i_brand_id")),
    "q43": (oracle_ds_q43, ("s_store_name", "s_store_id")
            + tuple(f"{dn[:3].lower()}_sales" for dn in TPCDS_DAYS),
            ("s_store_name", "s_store_id")),
    "q96": (oracle_ds_q96, ("cnt",), ()),
    "q88": (oracle_ds_q88, tuple(f"h{i}" for i in range(8)), ()),
    "q7": (oracle_ds_q7, ("i_item_id", "agg1", "agg2", "agg3", "agg4"), ("i_item_id",)),
    "q73": (oracle_ds_q73, ("c_last_name", "c_first_name", "c_salutation",
                            "c_preferred_cust_flag", "ss_ticket_number", "cnt"),
            ("cnt", "c_last_name", "ss_ticket_number")),
    "q33": (oracle_ds_q33, ("i_manufact_id", "total_sales"), ("total_sales", "i_manufact_id")),
    "q27": (oracle_ds_q27, ("i_item_id", "s_state", "lochierarchy", "agg1", "agg2", "agg3",
                            "agg4"), ("i_item_id", "s_state")),
    "q98": (oracle_ds_q98, ("i_item_id", "i_item_desc", "i_category", "i_class",
                            "i_current_price", "itemrevenue", "revenueratio"),
            ("i_category", "i_class", "i_item_id", "i_item_desc", "revenueratio")),
    "q51": (oracle_ds_q51, ("item_sk", "d_date_sk", "web_cumulative", "store_cumulative",
                            "web_max", "store_max"), ("item_sk", "d_date_sk")),
    "q39": (oracle_ds_q39, ("w1", "i1", "m1", "mean1", "cov1", "w2", "i2", "m2_off", "mean2",
                            "cov2"), ("w1", "i1", "m1")),
}
# the oracle queries whose DOUBLE columns are held within ``FLOAT_SUM_RTOL``
# (q39's standard deviations: the port sums x and x^2, the oracle two-pass)
TPCDS_FLOAT_ORACLES = ("q39",)


def out_rows(out, cols):
    """A collected answer's rows as tuples, None where a value is null."""
    n = len(out[cols[0]])

    def val(c, i):
        if not out[c + "__valid"][i]:
            return None
        v = out[c][i]
        return v if isinstance(v, (str, bytes)) else v.item() if hasattr(v, "item") else v

    return [tuple(val(c, i) for c in cols) for i in range(n)]


def same_ties(got, want, key_idx, close: bool = False) -> bool:
    """Row lists equal in the order of their sort keys (the columns at
    ``key_idx``), and as multisets within each run of tied keys; with
    ``close`` the keys untied and the other values equal by ``_close``."""
    if len(got) != len(want):
        return False
    if close:
        return all(all(map(_close, g, w)) for g, w in zip(got, want))
    if [tuple(r[i] for i in key_idx) for r in got] != [tuple(r[i] for i in key_idx)
                                                         for r in want]:
        return False
    i = 0
    while i < len(got):
        j = i
        while j < len(got) and tuple(got[j][k] for k in key_idx) == tuple(
                got[i][k] for k in key_idx):
            j += 1
        if sorted(got[i:j], key=repr) != sorted(want[i:j], key=repr):
            return False
        i = j
    return True


def check_tpcds(q: str, out, expect, what: str) -> None:
    """A TPC-DS answer against its oracle's rows: values exact (the DOUBLE
    averages bit-equal; ``TPCDS_FLOAT_ORACLES``' within ``FLOAT_SUM_RTOL``),
    order exact up to ties in the sort keys."""
    _, cols, keys = TPCDS_ORACLES[q]
    got = out_rows(out, cols)
    if not same_ties(got, expect, [cols.index(k) for k in keys], q in TPCDS_FLOAT_ORACLES):
        raise AssertionError(f"{what}: got {got[:5]}... ({len(got)} rows), expected "
                             f"{expect[:5]}... ({len(expect)} rows)")


# the ported TPC-DS queries whose sort keys tie at the scales run (q65:
# stores 1 and 7 are both named store_0): their answers compare as multisets
# of rows between runs
TPCDS_TIED_ORDER = ("q65",)


def _close(x, y) -> bool:
    """Equal values; two floats within ``FLOAT_SUM_RTOL`` (a float sum adds
    in another order on another device), NaN equal to NaN."""
    if isinstance(x, float) and isinstance(y, float):
        return x == y or (x != x and y != y) or abs(x - y) <= FLOAT_SUM_RTOL * max(abs(x), abs(y))
    return x == y


def same_rows(a, b, ordered: bool = True) -> bool:
    """Two collected answers equal (``_close``): every column in order, or
    (``ordered`` false) the rows as multisets."""
    if list(a) != list(b):
        return False
    cols = [c for c in a if not c.endswith("__valid")]
    ra, rb = out_rows(a, cols), out_rows(b, cols)
    if not ordered:
        ra, rb = sorted(ra, key=repr), sorted(rb, key=repr)
    return len(ra) == len(rb) and all(all(map(_close, x, y)) for x, y in zip(ra, rb))


def grace_fraction(sess, plan, K: int = GRACE_K):
    """The Config(memory_fraction) under which a run of ``plan`` splits a
    join into K partitions (corrected by grace runs where a join side is
    tiled first), and the first stage's top join's peak estimate:
    (fraction, jpeak), from tools/query_times.py."""
    from datafusion_comet_tpu_torch.tools import query_times as QT

    return QT.grace_fraction(sess, plan, K)


def _zero_counts(K) -> None:
    for names in WRAPPERS.values():
        for w in names:
            getattr(K, w).launches = 0


def _counts(K):
    return {name: sum(getattr(K, w).launches for w in names) for name, names in WRAPPERS.items()}


def b3_call_shapes(log):
    """The B3 calls of one run, from partition_columns' log: n, K, limit,
    codes type, each tensor's dtype and row shape, and the code totals."""
    return [{"n": c["n"], "K": c["K"], "local": c["local"], "limit": c["limit"],
             "codes": c["codes"], "tensors": c["tensors"], "rf": c["rf"],
             "sizes": c["sizes"].tolist() if not c["local"] else None} for c in log]


def run_record(sess):
    """The join hints and retries of a session's last run: ``hints``, per
    INNER join of each stage's last attempt, its build side, K, unique
    build, key packing, compacted-list rows and path (dense_unique,
    sorted_unique, pair_list or block); ``pair_hints``, the distinct ones of
    the grace pairs; ``attempts``, per stage run its growth scale,
    unique_join_ok and whether it overflowed; ``retries``, the stage runs
    that overflowed."""
    stage = [r for r in sess.runs if r["where"] == "stage"]
    pairs = {json.dumps(j, sort_keys=True) for r in sess.runs
             if r["where"] == "pair" and not r["overflowed"] for j in r["joins"]}
    return {"hints": [j for r in stage if not r["overflowed"] for j in r["joins"]],
            "pair_hints": [json.loads(j) for j in sorted(pairs)],
            "attempts": [[r["scale"], r["unique_join_ok"], r["overflowed"]] for r in stage],
            "retries": sum(r["overflowed"] for r in stage)}


# the runtime filters each query's runs inject at SF1 and SF10, by the JAX
# package's gates (PERF.md): "compact" where the direct run compacts the
# filter's semi output (a B3 call the engine tags "rf"), "mask" where the
# filter only thins the row mask; a query not named injects none (Q13, Q16,
# Q22 at both, Q20 and Q21 at SF1: their supplier scan passes 65,536 rows at
# SF10). Other scale factors are not checked.
RF_EXPECTED = {1: {"q3": "mask", "q5": "compact", "q10": "compact", "q9": "compact",
                   "q2": "compact", "q8": "compact", "q17": "compact"},
               10: {"q9": "compact", "q2": "compact", "q8": "compact", "q11": "compact",
                    "q17": "compact", "q20": "compact", "q20_variant": "compact",
                    "q21": "compact"}}


def check_rf(q: str, sf: float, run: str, record: dict) -> None:
    """Fail where a run's runtime filters are not those ``RF_EXPECTED``
    gives its query at its scale factor."""
    if sf not in RF_EXPECTED:
        return
    want = RF_EXPECTED[sf].get(q)
    got = record["runtime_filters"]
    rf_calls = sum(c["rf"] for c in record["b3_calls"])
    if bool(got) != bool(want) or (want == "compact" and run == "direct" and not rf_calls):
        raise AssertionError(f"{q} {run} at SF{sf:g}: runtime filters {got}, {rf_calls} "
                             f"rf compactions; expected {want or 'none'}")


def run_query(sess, plan, reps: int, log_b3: bool = True):
    """One run with the launch counts zeroed just before it and read just
    after, ``reps`` warm runs, then (``log_b3``) one run that logs each B3
    call with a copy of its codes (apart, so that the copies touch no
    measured run; else the log is empty).
    Returns (first output, launches, first-run s, warm ms list, peak bytes,
    the B3 log, the semi-like joins of the first run by membership path,
    ``_plan_stages``' host ms: the first run's and the warm runs' median).
    A logged call that compacts a runtime filter's semi output (the
    engine's tag "rf") is marked ``rf``."""
    import torch
    from datafusion_comet_tpu_torch.exec import kernels as K
    from datafusion_comet_tpu_torch.exec.operators.join import hash_join

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _zero_counts(K)
    semi = dict(hash_join.semi_paths)
    t0 = time.perf_counter()
    out = sess.collect(plan)
    first_s = time.perf_counter() - t0
    launches = _counts(K)
    semi = {path: n - semi[path] for path, n in hash_join.semi_paths.items()}
    peak = torch.cuda.max_memory_allocated()
    plan_first = sess.plan_ms
    times, plans = [], []
    for _ in range(reps):
        t0 = time.perf_counter()
        sess.collect(plan)
        times.append((time.perf_counter() - t0) * 1e3)
        plans.append(sess.plan_ms)
    log = []
    if log_b3:
        K.partition_columns.log = []
        sess.collect(plan)
        log, K.partition_columns.log = K.partition_columns.log, None
    for c in log:
        c["rf"] = c["tag"] == "rf"
        # held on the host until the partition phase: the copies of every
        # query's codes would otherwise crowd the card's memory
        c["code_values"] = c["code_values"].cpu()
    return out, launches, first_s, times, peak, log, semi, {"first": plan_first,
                                                          "warm": statistics.median(plans)}


def query_phase(sf: float, reps: int, profile: bool):
    import torch
    from datafusion_comet_tpu_torch.exec.engine import Session
    from datafusion_comet_tpu_torch.models import tpch

    data, gen_s = {}, {}
    for t in TABLES + PART_TABLES:
        t0 = time.perf_counter()
        data[t] = tpch.generate_table(t, sf)
        gen_s[t] = time.perf_counter() - t0
    sess = Session()  # the card, the default device
    stage_s = {}
    for t in TABLES + PART_TABLES:
        t0 = time.perf_counter()
        sess.register_numpy(t, data[t], tpch.SCHEMAS[t])
        torch.cuda.synchronize()
        stage_s[t] = time.perf_counter() - t0
    n_rows = len(data["lineitem"]["l_orderkey"])
    emit({"phase": "stage", "sf": sf, "rows": {t: len(next(iter(d.values())))
                                               for t, d in data.items()},
          "capacity": {t: b.capacity for t, b in sess.tables.items()},
          "generate_s": gen_s, "stage_s": stage_s})
    launches, b3_calls = {}, {}
    for q in ("q1", "q6"):
        out, launches[q], first_s, times, peak, b3_calls[q], _, plan_ms = run_query(
            sess, getattr(tpch, q)(), reps)
        if q == "q1":
            check_q1(out, tpch_oracle("q1", data, sf))
            need = ("bucket_count", "bucket_sum")
        else:
            want = tpch_oracle("q6", data, sf)
            if int(out["revenue"][0]) != want or not out["revenue__valid"][0]:
                raise AssertionError(f"q6: got {out['revenue'][0]}, expected {want}")
            need = ("bucket_sum",)
        if min(launches[q][k] for k in need) == 0:
            raise AssertionError(f"{q} did not launch {need}: {launches[q]}")
        warm_ms = statistics.median(times)
        emit({"phase": q, "sf": sf, "rows": n_rows, "correct": True, "first_run_s": first_s,
              "warm_ms": warm_ms, "warm_ms_all": times, "rows_per_s": n_rows / (warm_ms / 1e3),
              "peak_mem_bytes": peak, "launches": launches[q],
              "b3_call_n": [c["n"] for c in b3_calls[q]], **plan_record(sess, plan_ms),
              **run_record(sess)})
    profile_tpch(profile, sess, tpch.q1(), "profile_q1")

    # Q12 directly, then through the grace join on a second session over the
    # same device tables, under a memory fraction sized for K = 16
    expect = tpch_oracle("q12", data, sf)
    fraction, jpeak = grace_fraction(sess, tpch.q12())
    grace = grace_session(sess, fraction)
    q12 = {}
    for run, s in (("direct", sess), ("grace", grace)):
        key = f"q12_{run}"
        out, launches[key], first_s, times, peak, b3_calls[key], _, plan_ms = run_query(
            s, tpch.q12(), reps)
        check_q12(out, expect, f"q12 {run}")
        got = launches[f"q12_{run}"]
        # the direct run shrinks the filtered lineitem (the filter's row
        # estimate is under an eighth of its capacity), the grace run
        # partitions both sides, both with the partition sort
        if min(got.values()) == 0:
            raise AssertionError(f"q12 {run} did not launch every kernel: {got}")
        q12[run] = {"first_run_s": first_s, "warm_ms": statistics.median(times),
                    "warm_ms_all": times, "peak_mem_bytes": peak, "launches": got,
                    "b3_call_n": [c["n"] for c in b3_calls[f"q12_{run}"]],
                    "b3_calls": b3_call_shapes(b3_calls[f"q12_{run}"]),
                    **plan_record(s, plan_ms), **run_record(s)}
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
    profile_tpch(profile, grace, tpch.q12(), "profile_q12_grace")
    del grace
    q3_phase(sess, data, sf, reps, profile, launches, b3_calls)
    q4_phase(sess, data, sf, reps, profile, launches, b3_calls)
    q15_phase(sess, data, sf, reps, profile, launches, b3_calls)
    q5_phase(sess, data, sf, reps, profile, launches, b3_calls)
    for q in ("q10", "q18"):
        q10_q18_phase(q, sess, data, sf, reps, profile, launches, b3_calls)
    for q in ("q2", "q9", "q19", "q7", "q8", "q11", "q14", "q17", "q13", "q16", "q20",
              "q20_variant", "q21", "q22"):
        part_phase(q, sess, data, sf, reps, profile, launches, b3_calls)
    smj_phase(sess, data, sf, reps, launches, b3_calls)
    prepare_phase_tpch(sess, sf, reps, launches)
    return launches, sizes, b3_calls


# ---- the sort-merge joins, NOT IN and prepare -----------------------------------------

_ORACLES: dict = {}  # an oracle's answer by key, computed once a run
_PREFETCH: dict = {}  # an oracle's pending answer by key, from a worker process
_POOLS: list = []


def tpch_oracles(d, sf: float) -> dict:
    """Every TPC-H oracle of the query phases, by key, as a function of the
    tables ``d`` at ``sf``."""
    from datafusion_comet_tpu_torch.models import tpch

    day = tpch._d
    li, od, cu = d["lineitem"], d["orders"], d["customer"]
    return {
        "q1": lambda: oracle_q1(li, day("1998-09-02")),
        "q6": lambda: oracle_q6(li, day("1994-01-01"), day("1995-01-01")),
        "q12": lambda: oracle_q12(li, od, day("1994-01-01"), day("1995-01-01")),
        "q3": lambda: oracle_q3(li, od, cu, day("1995-03-15")),
        "q4": lambda: oracle_q4(li, od, day("1993-07-01"), day("1993-10-01")),
        "q15": lambda: oracle_q15(li, d["supplier"], day("1996-01-01"), day("1996-04-01")),
        "q5": lambda: oracle_q5(*(d[t] for t in TABLES), day("1994-01-01"), day("1995-01-01")),
        "q10": lambda: oracle_q10(li, od, cu, d["nation"], day("1993-10-01"),
                                  day("1994-01-01")),
        "q18": lambda: oracle_q18(li, od, cu),
        "q2": lambda: oracle_q2(d["part"], d["supplier"], d["partsupp"], d["nation"],
                                d["region"]),
        "q9": lambda: oracle_q9(li, d["part"], d["partsupp"], d["supplier"], od, d["nation"]),
        "q19": lambda: oracle_q19(li, d["part"]),
        "q7": lambda: oracle_q7(li, d["supplier"], od, cu, d["nation"], day("1995-01-01"),
                                day("1996-12-31")),
        "q8": lambda: oracle_q8(li, d["part"], od, cu, d["supplier"], d["nation"],
                                d["region"], day("1995-01-01"), day("1996-12-31")),
        "q11": lambda: oracle_q11(d["partsupp"], d["supplier"], d["nation"], Q11_FRACTION / sf),
        "q14": lambda: oracle_q14(li, d["part"], day("1995-09-01"), day("1995-10-01")),
        "q17": lambda: oracle_q17(li, d["part"]),
        "q13": lambda: oracle_q13(cu, od),
        "q16": lambda: oracle_q16(d["part"], d["partsupp"], d["supplier"]),
        "q20": lambda: oracle_q20(d["part"], li, d["partsupp"], d["supplier"], d["nation"],
                                  "forest%", day("1994-01-01"), day("1995-01-01")),
        "q20_variant": lambda: oracle_q20(d["part"], li, d["partsupp"], d["supplier"],
                                          d["nation"], Q20_VARIANT["pattern"],
                                          day(Q20_VARIANT["ship_from"]),
                                          day(Q20_VARIANT["ship_to"])),
        "q21": lambda: oracle_q21(li, od, d["supplier"], d["nation"]),
        "q22": lambda: oracle_q22(cu, od),
    }


def tpcds_oracles(d) -> dict:
    """Every TPC-DS oracle of the TPC-DS phase, by key, as a function of
    the tables ``d``."""
    out = {q: (lambda q=q: TPCDS_ORACLES[q][0](d)) for q in TPCDS_ORACLES}
    out["q90_scalar"] = lambda: oracle_ds_q90_scalar(d)
    out["agg_state"] = lambda: agg_oracle(d, "state")
    out["agg_item"] = lambda: agg_oracle(d, "item")
    out.update(expr_oracles(d))
    out.update(nested_oracles(d))
    out.update(text_oracles(d))
    return out


_WORKER = {}  # a worker process's own tables


def _worker_init(kind: str, sf: float) -> None:
    """A worker process generates its suite's tables at ``sf`` once: the
    generators are seeded, so they are the main process's tables."""
    sys.path.insert(0, str(ROOT))
    if kind == "tpch":
        from datafusion_comet_tpu_torch.models import tpch

        _WORKER["data"] = {t: tpch.generate_table(t, sf) for t in TABLES + PART_TABLES}
    else:
        from datafusion_comet_tpu_torch.models import tpcds

        _WORKER["data"] = {t: tpcds.generate_table(t, sf) for t in tpcds.SCHEMAS}


def _worker_oracle(kind: str, sf: float, key: str):
    d = _WORKER["data"]
    return (tpch_oracles(d, sf) if kind == "tpch" else tpcds_oracles(d))[key]()


def start_oracles(sf: float) -> None:
    """Compute the numpy oracles in worker processes of their own while the
    card runs the queries (the host's other cores): two for TPC-H at ``sf``,
    one for TPC-DS at ten times it, each over its own copy of the seeded
    tables, the oracles in the order the phases ask for them. Nothing
    changes but where the host seconds go; ``stop_oracles`` ends them."""
    import multiprocessing

    ctx = multiprocessing.get_context("spawn")  # no fork of a process holding the card
    for kind, ksf, workers, keys in (
            ("tpch", sf, 2, list(tpch_oracles({t: {} for t in TABLES + PART_TABLES}, sf))),
            ("tpcds", TPCDS_SCALE * sf, 1, list(tpcds_oracles({})))):
        pool = ctx.Pool(workers, initializer=_worker_init, initargs=(kind, ksf))
        _POOLS.append(pool)
        for key in keys:
            _PREFETCH[(kind, key, ksf)] = pool.apply_async(_worker_oracle, (kind, ksf, key))


def stop_oracles() -> None:
    for pool in _POOLS:
        pool.terminate()
        pool.join()
    _POOLS.clear()
    _PREFETCH.clear()


def memo_oracle(key, fn):
    """An oracle's answer: from its worker process where one computes it
    (``start_oracles``), else computed here; once a run (the sort-merge and
    prepared plans are held to the answers their hash plans were held
    to)."""
    if key not in _ORACLES:
        pending = _PREFETCH.pop(key, None)
        _ORACLES[key] = pending.get() if pending is not None else fn()
    return _ORACLES[key]


def tpch_oracle(q: str, d, sf: float):
    return memo_oracle(("tpch", q, sf), tpch_oracles(d, sf)[q])


def tpcds_oracle(q: str, d, sf: float):
    return memo_oracle(("tpcds", q, sf), tpcds_oracles(d)[q])


def plan_nodes(stages, cls):
    """The nodes of type ``cls`` in a session's stages."""
    out, stack = [], [p for _, p in stages]
    while stack:
        p = stack.pop()
        out += [p] if isinstance(p, cls) else []
        stack.extend(p.children())
    return out


def smj_phase(sess, data, sf: float, reps: int, launches, b3_calls) -> None:
    """TPC-H Q12 and Q3 in Spark's plan at scale, every join
    SortMergeJoin(Sort(ShuffleExchange(left)), Sort(ShuffleExchange(right)))
    and Q3's top 10 a TakeOrderedAndProject, and Q16 with its NOT IN a
    LEFT_ANTI_NULL_AWARE join: each against the numpy oracle its hash plan
    is held to; warm ms beside the hash plan's, the SortMergeJoins planned
    and, per join run, its path and whether it took the merge path (the
    build side searched unsorted)."""
    from datafusion_comet_tpu_torch.ir import plan as P
    from datafusion_comet_tpu_torch.models import tpch

    cases = {
        "q12_smj": (lambda: tpch.q12(sort_merge=True), tpch.q12, check_q12, "q12"),
        "q3_smj": (lambda: tpch.q3(sort_merge=True), tpch.q3, check_q3, "q3"),
        "q16_not_in": (lambda: tpch.q16(null_aware=True), tpch.q16, check_q16, "q16"),
    }
    for key, (plan, hash_plan, check, q) in cases.items():
        out, launches[key], first_s, times, peak, b3_calls[key], semi, plan_ms = run_query(
            sess, plan(), reps, log_b3=False)
        check(out, tpch_oracle(q, data, sf), key)
        smjs = plan_nodes(sess.stages, P.SortMergeJoin)
        joins = [{"type": j["type"], "path": j["path"], "merge": j.get("merge", False)}
                 for r in sess.runs if r["where"] == "stage" and not r["overflowed"]
                 for j in r["joins"]]
        if key != "q16_not_in" and (len(smjs) != (1 if key == "q12_smj" else 2)
                                    or not all(j.presorted_build for j in smjs)):
            raise AssertionError(f"{key}: {len(smjs)} SortMergeJoins, presorted "
                                 f"{[j.presorted_build for j in smjs]}")
        if key == "q16_not_in" and not any(
                j.join_type == P.JoinType.LEFT_ANTI_NULL_AWARE
                for j in plan_nodes(sess.stages, P.HashJoin)):
            raise AssertionError(f"{key}: no null-aware anti join planned")
        _, _, _, hash_times, _, _, _, _ = run_query(sess, hash_plan(), reps, log_b3=False)
        emit({"phase": key, "sf": sf, "correct": True, "first_run_s": first_s,
              "warm_ms": statistics.median(times), "hash_plan_warm_ms":
              statistics.median(hash_times), "peak_gb": peak / 1e9,
              "launches": launches[key], "smj": len(smjs), "joins": joins,
              "semi_paths": {k: v for k, v in semi.items() if v},
              "stages": len(sess.stages), **plan_record(sess, plan_ms), **run_record(sess)})


def prepare_check(sess, key: str, plan_of, reps: int, launches, calls: int = 5) -> dict:
    """``Session.prepare`` of ``plan_of()``: ``calls`` calls, each equal to
    ``collect``'s answer, none re-running a stage, grace pair or tiled
    aggregate; the launches of one call (counts zeroed just before it), the
    prepared and the collected warm ms and the warm-up's planning ms."""
    import torch
    from datafusion_comet_tpu_torch.exec import kernels as K
    from datafusion_comet_tpu_torch.exec.batch import to_numpy

    want = sess.collect(plan_of())
    collect_ms = []
    for _ in range(reps):
        t0 = time.perf_counter()
        sess.collect(plan_of())
        collect_ms.append((time.perf_counter() - t0) * 1e3)
    run = sess.prepare(plan_of())
    times = []
    for i in range(calls):
        torch.cuda.synchronize()
        if i == 0:
            _zero_counts(K)
        t0 = time.perf_counter()
        got = to_numpy(run())
        times.append((time.perf_counter() - t0) * 1e3)
        if i == 0:
            launches[key] = _counts(K)
        runs = list(sess.runs) + [r for sq in sess.subqueries for r in sq["runs"]]
        if not same_rows(want, got) or any(r["overflowed"] for r in runs):
            raise AssertionError(f"{key}: prepared call {i} differs from collect, or re-ran: "
                                 f"{[(r['where'], r['scale'], r['overflow_ops']) for r in runs]}")
    return {"phase": key, "correct": True, "calls": calls,
            "prepared_warm_ms": statistics.median(times), "prepared_ms_all": times,
            "collect_warm_ms": statistics.median(collect_ms), "plan_ms": run.plan_ms,
            "runs_per_call": len(sess.runs), "subquery_runs": len(sess.subqueries),
            "grace": [r.K for r in all_grace_runners(sess)], "launches": launches[key]}


def prepare_phase_tpch(sess, sf: float, reps: int, launches) -> None:
    """Q1, Q6 and Q12 through ``Session.prepare``, and Q12 under the budget
    that splits its join into K = 16 pairs (its grace join a prestep run on
    every call)."""
    from datafusion_comet_tpu_torch.models import tpch

    for q in ("q1", "q6", "q12"):
        emit(dict(prepare_check(sess, f"prepare_{q}", getattr(tpch, q), reps, launches), sf=sf))
    grace = grace_session(sess, grace_fraction(sess, tpch.q12())[0])
    rec = prepare_check(grace, "prepare_q12_grace", tpch.q12, reps, launches)
    if rec["grace"] != [GRACE_K]:
        raise AssertionError(f"prepare_q12_grace: grace joins {rec['grace']}")
    emit(dict(rec, sf=sf))


# ---- the TPC-DS phase -----------------------------------------------------------------

TPCDS_SCALE = 10  # the TPC-DS generator runs at ten times --sf
# the scale at which the card is held to the port's CPU run: SF1 in the
# default run (--sf 1); a tenth of it in a deeper run (--sf above 1), cut to
# keep `--sf 10 --profile` inside its time limit (the default run keeps SF1)
TPCDS_REF_SF = 1.0
TPCDS_GRACE = ("q3", "q7", "q27", "q33", "q65", "q73", "q95", "q96", "q98", "q47", "q88")
# the queries whose overflow re-runs outgrew the card at TPC-DS SF100 before
# the re-runs were held to the memory budget (ROADMAP C19): their lines add
# each attempt's overflowed operators and the re-runs' re-budgets
TPCDS_C19 = ("q4", "q5", "q16", "q23", "q47", "q51", "q58", "q67", "q75", "q80", "q93")
TPCDS_PREPARE = ("q3", "q64", "q88")  # run through Session.prepare as well
TPCDS_PROFILE = ("q3", "q27", "q33", "q64", "q96", "q88")
# the grace runs profiled (not q88's: 17 s at SF100, cut to hold the run's time)
TPCDS_GRACE_PROFILE = ("q3", "q27", "q33", "q96")


# Spark's runtime bloom filter defaults (spark.sql.optimizer.runtime.bloomFilter.
# numBits and .expectedNumItems): k = round(8,388,608 / 1,000,000 ln 2) = 6
BLOOM_BITS = 8_388_608
BLOOM_ITEMS = 1_000_000


def all_grace_runners(s):
    """The grace joins of a session's last run, its scalar subqueries' first."""
    return [r for sq in s.subqueries for r in sq["grace_runners"]] + list(s.grace_runners)


def subquery_record(s):
    """The scalar subqueries of a session's last run: how many ran, and per
    run its id, value (a filter's byte count), attempts (growth scale,
    unique_join_ok, overflowed), stages and grace joins (K, mode, pair
    retries, largest and mean partition)."""
    def value(v):
        return {"bytes": len(v)} if isinstance(v, bytes) else (
            v.item() if hasattr(v, "item") else v)

    return {"subquery_runs": len(s.subqueries), "subqueries": [
        {"id": sq["id"], "value": value(sq["value"]) if sq["valid"] else None,
         "attempts": [[r["scale"], r["unique_join_ok"], r["overflowed"]] for r in sq["runs"]
                      if r["where"] == "stage"],
         "stages": len(sq["stages"]),
         "grace": [{"K": r.K, "mode": r.downstream and r.downstream[0],
                    "pair_retries": r.retries,
                    "largest": [int(sz.max()) for sz in r.sizes],
                    "mean": [float(sz.mean()) for sz in r.sizes]} for r in sq["grace_runners"]]}
        for sq in s.subqueries]}


def staged_bytes(sess) -> int:
    """Device bytes of every buffer of the session's registered tables."""
    return sum(t.numel() * t.element_size() for b in sess.tables.values()
               for c in b.columns for t in (c.data, c.validity, c.lengths) if t is not None)


def tpcds_tables(sess, sf: float):
    """All 24 TPC-DS tables generated at ``sf`` and registered in ``sess``:
    (data, generate s, stage s)."""
    import torch
    from datafusion_comet_tpu_torch.models import tpcds

    data, gen_s, stage_s = {}, 0.0, 0.0
    for t in tpcds.SCHEMAS:
        t0 = time.perf_counter()
        data[t] = tpcds.generate_table(t, sf)
        t1 = time.perf_counter()
        sess.register_numpy(t, data[t], tpcds.SCHEMAS[t])
        if sess.device.type == "cuda":
            torch.cuda.synchronize()
        gen_s += t1 - t0
        stage_s += time.perf_counter() - t1
    return data, gen_s, stage_s


def tpcds_phase(sf: float, reps: int, profile: bool, launches, b3_calls) -> None:
    """TPC-DS at generator scale ``TPCDS_SCALE * sf``: every query run
    directly on the card (warm ms, peak memory, retries, launches, rows,
    planning ms; q88 its eight scalar subqueries' runs, each with its
    attempts, stages and grace joins); q3, q52, q55, q43, q96, q88, q7, q73,
    q33, q27, q98, q51 and q39 against their numpy oracles
    (``TPCDS_ORACLES``; q39 within ``FLOAT_SUM_RTOL``); ``TPCDS_GRACE``
    directly and
    under the budget that splits a join into K = 16 pairs, the same answer
    (q65's as multisets of rows, ``TPCDS_TIED_ORDER``), with K, mode,
    partition sizes (largest and mean) and pair retries; q90 in its
    scalar-subquery form (``q90_scalar_phase``) and Spark's runtime bloom
    filter (``bloom_phase``) against numpy; then every
    query at ``TPCDS_REF_SF`` (a tenth of it where ``sf`` is above 1) on the
    card against the port's own CPU run of
    it (``same_rows``: exact, FLOAT64 within ``FLOAT_SUM_RTOL``). B1, B2 and
    B3 must each launch in the phase's runs. Every query must run: one that
    runs out of the card's memory or of overflow retries fails the script.
    ``TPCDS_C19``'s lines add each attempt's overflowed operators and the
    re-runs held to the budget (``rebudget``: the grace joins and tiled
    aggregates they took); ``TPCDS_PREPARE`` also run through
    ``Session.prepare`` (``prepare_check``), and ``agg_phase`` runs the
    special aggregates over store_sales."""
    import torch
    from datafusion_comet_tpu_torch.exec.engine import Session
    from datafusion_comet_tpu_torch.models import tpcds

    ds_sf = TPCDS_SCALE * sf
    gc.collect()  # a session and its grace runners hold each other: free the TPC-H tables
    torch.cuda.empty_cache()
    sess = Session()
    data, gen_s, stage_s = tpcds_tables(sess, ds_sf)
    emit({"phase": "tpcds_stage", "sf": ds_sf,
          "rows": {t: len(next(iter(d.values()))) for t, d in data.items()},
          "capacity": {t: b.capacity for t, b in sess.tables.items()},
          "staged_gb": staged_bytes(sess) / 1e9, "generate_s": gen_s, "stage_s": stage_s,
          "padded_strings": sorted(f"{t}.{f.name}" for t, b in sess.tables.items()
                                   for f, c in zip(b.schema.fields, b.columns)
                                   if f.dtype.is_binary and not c.is_dict)})
    total = {k: 0 for k in WRAPPERS}
    oracle_s, oracles, graces = 0.0, [], []
    for q in tpcds.QUERIES:
        key = f"ds_{q}"
        grace_q = q in TPCDS_GRACE

        def plan(s=sess, q=q):  # q88 registers its subqueries in the session that runs it
            return tpcds.plan(q, s)

        torch.cuda.empty_cache()  # the last query's cached blocks go back to the card
        # C19's re-runs repeat in every warm run: one warm run of those
        out, launches[key], first_s, times, peak, log, semi, plan_ms = run_query(
            sess, plan(), 1 if q in TPCDS_C19 else reps, log_b3=grace_q)
        if grace_q:
            b3_calls[key] = log
        rec = {"phase": f"tpcds_{q}", "sf": ds_sf, "rows": len(next(iter(out.values()))),
               "first_run_s": first_s, "warm_ms": statistics.median(times),
               "peak_gb": peak / 1e9, "launches": launches[key], "plan_ms": plan_ms,
               "stages": len(sess.stages), "runtime_filters": plan_record(sess, plan_ms)[
                   "runtime_filters"], **run_record(sess)}
        if q in tpcds.NEEDS_SESSION:
            rec.update(subquery_record(sess))
            if rec["subquery_runs"] != 8 or not (launches[key]["bucket_count"]
                                                 or launches[key]["partition_sort"]):
                raise AssertionError(f"{key}: {rec['subquery_runs']} subquery runs, "
                                     f"launches {launches[key]}; expected 8 and B1 or B3")
        if q in TPCDS_ORACLES:
            t0 = time.perf_counter()
            check_tpcds(q, out, tpcds_oracle(q, data, ds_sf), key)
            oracle_s += time.perf_counter() - t0
            rec["oracle"] = True
            oracles.append(q)
        if q == "q22":
            rec["sort_limbs"] = agg_sort_limbs(sess, plan(), "lochierarchy")
        if q in TPCDS_C19:
            rec.update(rerun_record(sess))
        for k in total:
            total[k] += launches[key][k]
        emit(rec)
        if grace_q:
            tpcds_grace(q, sess, plan, out, reps, profile, launches, b3_calls, total)
            graces.append(q)
        if profile and q in TPCDS_PROFILE:
            emit(profile_run(sess, plan(), f"profile_tpcds_{q}"))
        if q in TPCDS_PREPARE:
            pkey = f"ds_prepare_{q}"
            emit(dict(prepare_check(sess, pkey, plan, reps, launches), sf=ds_sf))
            for k in total:
                total[k] += launches[pkey][k]
    agg_phase(sess, data, ds_sf, reps, launches, total)
    q90_scalar_phase(sess, data, ds_sf, reps, launches, total)
    bloom_phase(sess, data, ds_sf, reps, launches, total)
    expr_phase(sess, data, ds_sf, reps, profile, launches, total)
    nested_phase(sess, data, ds_sf, reps, profile, launches, total, b3_calls)
    text_phase(sess, data, ds_sf, reps, launches, total)
    if min(total.values()) == 0:
        raise AssertionError(f"the TPC-DS runs did not launch every kernel: {total}")
    del sess, data
    torch.cuda.empty_cache()
    emit({"phase": "tpcds", "sf": ds_sf, "queries": len(tpcds.QUERIES),
          "launches": total, "oracles_checked": sorted(oracles),
          "grace_checked": sorted(graces), "oracle_s": oracle_s,
          "against_cpu": tpcds_against_cpu(TPCDS_REF_SF if sf <= 1 else TPCDS_REF_SF / 10)})


def rerun_record(sess) -> dict:
    """A run's overflow re-runs: per stage attempt its scale, the operators
    whose flags fired and its resident-bytes estimate; the re-runs held to
    the memory budget (scale, estimate before and after, the grace joins'
    K and mode and the tiled aggregates they took, ``oom`` where an attempt
    ran out of the card's memory first)."""
    return {"rerun_attempts": [[r["where"], r["scale"], r["overflow_ops"], r["estimate"]]
                               for r in sess.runs if r["where"] == "stage"],
            "rebudgets": [{k: v for k, v in r.items()} for r in sess.rebudgets],
            "went": sorted({w for r in sess.rebudgets
                            for w in ("grace",) * bool(r["grace"]) + ("tiled",) * bool(r["tiled"])})}


def tpcds_grace(q, sess, plan, direct, reps, profile, launches, b3_calls, total) -> None:
    """``q`` under the budget that splits its first stage's top join (q88:
    its first subquery's) into K = 16 pairs: its answer is the direct one.
    ``plan(s)`` builds the query for the session ``s`` that runs it."""
    fraction, jpeak = grace_fraction(sess, plan())
    grace = grace_session(sess, fraction)
    key = f"ds_{q}_grace"
    out, launches[key], first_s, times, peak, b3_calls[key], _, plan_ms = run_query(
        grace, plan(grace), reps)
    if not same_rows(direct, out, ordered=q not in TPCDS_TIED_ORDER):
        raise AssertionError(f"{key}: the grace answer is not the direct one")
    # the direct run partitions only where a re-run of it was planned again
    # (a grace join marked ``rebudget``: q47 at SF100)
    if [r for r in all_grace_runners(sess) if not r.rebudget] or not any(
            r.K == GRACE_K and not r.rebudget for r in all_grace_runners(grace)):
        raise AssertionError(f"{key}: the direct run partitioned, or no grace join of "
                             f"K={GRACE_K}: {_grace_record(grace)['grace_runners']}")
    for k in total:
        total[k] += launches[key][k]
    emit({"phase": f"tpcds_{q}_grace", "correct": True, "memory_fraction": fraction,
          "join_peak_estimate_bytes": jpeak, "first_run_s": first_s,
          "warm_ms": statistics.median(times), "peak_gb": peak / 1e9,
          "launches": launches[key], "plan_ms": plan_ms, **_grace_record(grace),
          **run_record(grace), **(subquery_record(grace) if grace.subqueries else {})})
    if profile and q in TPCDS_GRACE_PROFILE:
        emit(profile_run(grace, plan(grace), f"profile_tpcds_{q}_grace"))


# ---- the special aggregates over store_sales -------------------------------------------

AGG_PCT = 0.9  # percentile(ss_quantity, 0.9)
AGG_APPROX = (0.5, 10000)  # approx_percentile(ss_sales_price, 0.5, 10000)


def agg_exprs(E):
    return [E.AggExpr("median", E.col("ss_net_paid"), "median_net_paid"),
            E.AggExpr("percentile", E.col("ss_quantity"), "p90_quantity",
                      extra=(E.lit(AGG_PCT),)),
            E.AggExpr("approx_count_distinct", E.col("ss_customer_sk"), "customers"),
            E.AggExpr("approx_percentile", E.col("ss_sales_price"), "median_price",
                      extra=tuple(E.lit(v) for v in AGG_APPROX))]


def agg_plan(grouping: str, exprs=agg_exprs):
    """The special aggregates over store_sales: per store state (store_sales
    joined to store; s_state's dictionary codes take the dense path) or per
    item (ss_item_sk, the sorted path)."""
    from datafusion_comet_tpu_torch.ir import expr as E
    from datafusion_comet_tpu_torch.ir import plan as P
    from datafusion_comet_tpu_torch.models import tpcds

    ss = P.Scan("store_sales", tpcds.SCHEMAS["store_sales"])
    if grouping == "item":
        return ss.aggregate([E.col("ss_item_sk")], exprs(E))
    st = P.Scan("store", tpcds.SCHEMAS["store"])
    j = P.HashJoin(ss, st, (E.col("ss_store_sk"),), (E.col("s_store_sk"),), P.JoinType.INNER,
                   "right")
    return j.aggregate([E.col("s_state")], exprs(E))


def _xxhash64_long(v: np.ndarray, seed: int) -> np.ndarray:
    """Spark's XXH64.hashLong of int64 values, in numpy uint64 (wrapping)."""
    p1, p2, p3, p4, p5 = (np.uint64(c) for c in (
        0x9E3779B185EBCA87, 0xC2B2AE3D27D4EB4F, 0x165667B19E3779F9, 0x85EBCA77C2B2AE63,
        0x27D4EB2F165667C5))

    def rotl(x, r):
        return (x << np.uint64(r)) | (x >> np.uint64(64 - r))

    with np.errstate(over="ignore"):
        h = np.uint64(seed) + p5 + np.uint64(8)
        h = h ^ (rotl(v.astype(np.uint64) * p2, 31) * p1)
        h = rotl(h, 27) * p1 + p4
        h ^= h >> np.uint64(33)
        h *= p2
        h ^= h >> np.uint64(29)
        h *= p3
        h ^= h >> np.uint64(32)
    return h


def hll_oracle(values: np.ndarray, group: np.ndarray, m: int) -> np.ndarray:
    """The port's HyperLogLog (p = 9) of int64 ``values`` per group in
    [0, m), in numpy: xxhash64 under seed 42, the top 9 bits a register,
    the leading zeros of the rest plus one its rank, the max rank a
    register, the raw estimate or linear counting, rounded."""
    P_, M = 9, 512
    h = _xxhash64_long(values, 42)
    reg = (h >> np.uint64(64 - P_)).astype(np.int64)
    rest = h << np.uint64(P_)
    lz = np.zeros(len(h), np.int64)
    y = rest.copy()
    for shift in (32, 16, 8, 4, 2, 1):
        top = (y >> np.uint64(64 - shift)) == 0
        lz += np.where(top, shift, 0)
        y = np.where(top, y << np.uint64(shift), y)
    lz = np.where(rest == 0, 64, lz)
    rank = np.minimum(lz + 1, 64 - P_ + 1).astype(np.uint8)
    order = np.argsort(rank, kind="stable")  # the max rank lands last on each register
    regs = np.zeros(m * M, np.int64)
    regs[(group * M + reg)[order]] = rank[order]
    regs = regs.reshape(m, M)
    alpha = 0.7213 / (1.0 + 1.079 / M)
    est = alpha * M * M / np.exp2(-regs.astype(np.float64)).sum(1)
    zeros = (regs == 0).sum(1).astype(np.float64)
    lin = M * np.log(M / np.maximum(zeros, 1.0))
    est = np.where((est <= 2.5 * M) & (zeros > 0), lin, est)
    return np.rint(est).astype(np.int64)


def group_sorted(group: np.ndarray, values: np.ndarray, bits: int) -> np.ndarray:
    """``values`` (non-negative, below 2^bits) sorted within groups, the
    groups in order: one sort of group << bits | value, in chunks of groups
    on eight threads (numpy's sort lets go of the interpreter lock)."""
    key = (group.astype(np.int64) << bits) | values.astype(np.int64)
    bucket = (group * 8 // max(int(group.max()) + 1, 1)).astype(np.uint8)
    order = np.argsort(bucket, kind="stable")
    key = key[order]
    bounds = np.searchsorted(bucket[order], np.arange(9))
    with concurrent.futures.ThreadPoolExecutor(8) as pool:
        list(pool.map(lambda i: key[bounds[i]:bounds[i + 1]].sort(), range(8)))
    return key & ((1 << bits) - 1)


def agg_oracle(data, grouping: str):
    """Per group, in key order: (group key, median(ss_net_paid),
    percentile(ss_quantity, 0.9), approx_count_distinct(ss_customer_sk),
    approx_percentile(ss_sales_price, 0.5)'s exact element, and the sorted
    sales prices for the rank check of the sketch's answer). The exact
    percentiles by the port's formula, v(lo) + (v(hi) - v(lo)) x frac at
    rank (n - 1) x p among a group's sorted values, in float64 (not
    np.percentile, whose interpolation rounds differently)."""
    ss = data["store_sales"]
    if grouping == "item":
        keys, group = np.unique(ss["ss_item_sk"], return_inverse=True)
    else:
        st = data["store"]
        state_keys, state_code = np.unique(st["s_state"].astype(str), return_inverse=True)
        pos = np.searchsorted(st["s_store_sk"], ss["ss_store_sk"])
        keys, group = state_keys, state_code[pos]
    m = len(keys)
    n = np.bincount(group, minlength=m)
    start = np.concatenate([[0], np.cumsum(n)[:-1]])
    net = group_sorted(group, ss["ss_net_paid"], 21).astype(np.float64) / 100.0
    qty = group_sorted(group, ss["ss_quantity"], 8).astype(np.float64)
    price = group_sorted(group, ss["ss_sales_price"], 16)

    def interp(x, p):
        t = (n.astype(np.float64) - 1.0) * p
        lo, hi = np.floor(t), np.ceil(t)
        v_lo = x[start + lo.astype(np.int64)] + 0.0
        v_hi = x[start + hi.astype(np.int64)] + 0.0
        return v_lo + (v_hi - v_lo) * (t - lo)

    k = np.clip(np.ceil(AGG_APPROX[0] * n.astype(np.float64)).astype(np.int64) - 1, 0, n - 1)
    return {"keys": keys, "median_net_paid": interp(net, 0.5),
            "p90_quantity": interp(qty, AGG_PCT),
            "customers": hll_oracle(ss["ss_customer_sk"], group, m),
            "median_price": price[start + k], "n": n, "start": start, "prices": price,
            "group": group}


def approx_rank_ok(oracle, got_prices: np.ndarray, eps: float) -> float:
    """The largest distance of each group's answer from rank p: the
    fraction of its group's prices below it and at most it, against
    AGG_APPROX's p; raises where one is farther than ``eps``."""
    worst = 0.0
    prices, n, start = oracle["prices"], oracle["n"], oracle["start"]
    for g in range(len(n)):
        seg = prices[start[g]:start[g] + n[g]]
        lo = np.searchsorted(seg, got_prices[g], "left") / n[g]
        hi = np.searchsorted(seg, got_prices[g], "right") / n[g]
        d = max(lo - AGG_APPROX[0], AGG_APPROX[0] - hi, 0.0)
        worst = max(worst, d)
    if worst > eps:
        raise AssertionError(f"approx_percentile: rank error {worst} over {eps}")
    return worst


def agg_phase(sess, data, ds_sf: float, reps: int, launches, total) -> None:
    """median(ss_net_paid), percentile(ss_quantity, 0.9),
    approx_count_distinct(ss_customer_sk) and approx_percentile(
    ss_sales_price, 0.5, 10000) over store_sales, per store state (the
    dense path) and per item (the sorted path), in SINGLE mode, against
    the numpy oracle (``agg_oracle``): the percentiles and HLL's estimate
    exactly, HLL's relative error against the exact distinct count printed,
    approx_percentile's exact element. Then approx_percentile alone as
    PARTIAL states merged by a FINAL: per item tiled under a budget that
    takes two tiles (the tiled aggregate's plan), per state through the
    grace join at K = 16 in its partial mode, each within its sketch's rank
    error (a sketch of K = 512 samples, a rank error of about 1/(2K) a
    compression)."""
    from datafusion_comet_tpu_torch.exec.memory import plan_peak_bytes
    from datafusion_comet_tpu_torch.ir import expr as E
    from datafusion_comet_tpu_torch.ir import plan as P

    for grouping in ("state", "item"):
        t0 = time.perf_counter()
        want = tpcds_oracle(f"agg_{grouping}", data, ds_sf)
        oracle_s = time.perf_counter() - t0
        key = f"ds_agg_{grouping}"
        out, launches[key], first_s, times, peak, _, _, plan_ms = run_query(
            sess, agg_plan(grouping), reps, log_b3=False)
        kcol = "ss_item_sk" if grouping == "item" else "s_state"
        got_keys = np.asarray(out[kcol]).astype(want["keys"].dtype)
        if not np.array_equal(got_keys, want["keys"]):
            raise AssertionError(f"{key}: groups differ")
        for col in ("median_net_paid", "p90_quantity", "customers", "median_price"):
            if not out[col + "__valid"].all() or not np.array_equal(
                    np.asarray(out[col]), want[col]):
                bad = np.nonzero(np.asarray(out[col]) != want[col])[0][:3]
                raise AssertionError(f"{key} {col}: rows {bad.tolist()} "
                                     f"{np.asarray(out[col])[bad]} != {want[col][bad]}")
        # HLL's error against the exact distinct customers of each group
        ukey = np.unique((want["group"].astype(np.int64) << 21)
                         | data["store_sales"]["ss_customer_sk"])
        exact = np.bincount(ukey >> 21, minlength=len(want["keys"]))
        rel = np.abs(want["customers"] - exact) / np.maximum(exact, 1)
        hll_err = {"hll_max_rel_err": float(rel.max()), "hll_mean_rel_err": float(rel.mean()),
                   "hll_rel_err_of_the_largest_group": float(rel[np.argmax(exact)])}
        if launches[key]["bucket_count"] == 0 and grouping == "state":
            raise AssertionError(f"{key}: the dense path launched no B1: {launches[key]}")
        for k in total:
            total[k] += launches[key][k]
        emit({"phase": key, "sf": ds_sf, "correct": True, "groups": len(want["keys"]),
              "first_run_s": first_s, "warm_ms": statistics.median(times),
              "peak_gb": peak / 1e9, "launches": launches[key], "oracle_s": oracle_s,
              "path": "dense" if grouping == "state" else "sorted", **hll_err,
              **plan_record(sess, plan_ms), **run_record(sess)})

        # approx_percentile as PARTIAL states and a FINAL
        def one(Ex):
            return [Ex.AggExpr("approx_percentile", Ex.col("ss_sales_price"), "median_price",
                               extra=tuple(Ex.lit(v) for v in AGG_APPROX))]

        plan = agg_plan(grouping, one)
        if grouping == "item":
            bound = sess._plan_stages(plan)[-1][1]
            peak_est = plan_peak_bytes(bound, sess.tables["store_sales"].capacity)
            fraction = peak_est / 1.5 / device_memory(sess)
        else:
            fraction = grace_fraction(sess, plan)[0]
        g = grace_session(sess, fraction)
        pkey = f"{key}_partial_final"
        out, launches[pkey], first_s, times, peak, _, _, plan_ms = run_query(
            g, plan, reps, log_b3=False)
        tiles = [t for _, t in g.tiled]
        modes = [r.downstream and r.downstream[0] for r in g.grace_runners]
        if (grouping == "item" and tiles != [2]) or (
                grouping == "state" and modes != ["partial"]):
            raise AssertionError(f"{pkey}: tiles {tiles}, grace modes {modes}")
        got = np.asarray(out["median_price"])
        if not np.array_equal(np.asarray(out[kcol]).astype(want["keys"].dtype), want["keys"]):
            raise AssertionError(f"{pkey}: groups differ")
        # the sketch's rank error, about 1/(2K) a compression, over the
        # PARTIAL, a fold of eight and the FINAL (an exact element is 0)
        eps = 4.0 / 512
        worst = approx_rank_ok(want, got, eps)
        for k in total:
            total[k] += launches[pkey][k]
        emit({"phase": pkey, "sf": ds_sf, "correct": True, "rank_error_max": worst,
              "rank_error_bound": eps, "tiles": tiles, "grace_modes": modes,
              "memory_fraction": fraction, "first_run_s": first_s,
              "warm_ms": statistics.median(times), "peak_gb": peak / 1e9,
              "launches": launches[pkey], **run_record(g)})


# ---- the expression query set: the scalar evaluator at scale ----------------------------

EXPR_SEED, EXPR_SEED2 = 17, 23  # Sample's seed, then rand's and randn's
EXPR_FRACTION = 0.01  # Sample(store_sales, 0.0, 0.01, false, EXPR_SEED)
EXPR_RANDN_HEAD = 1000  # the randn values reported and checked
EXPR_FORMAT_SAMPLE = 1_000_000  # the rows of cast(d as string) checked as Java prints them
EXPR_ZONE = "America/New_York"


def expr_zone() -> str:
    """The session zone of expr_time: America/New_York where the machine's
    tzdata has it (utils/tz.py reads TZDIR, else /usr/share/zoneinfo), else
    its standard offset, -05:00 (no DST)."""
    import os

    tzdir = os.environ.get("TZDIR", "/usr/share/zoneinfo")
    return EXPR_ZONE if os.path.exists(os.path.join(tzdir, EXPR_ZONE)) else "-05:00"


def expr_plans(E, P, T, schemas, zone: str) -> dict:
    """The four plans of the expr phase, built from either package's IR
    (the tests build the JAX package's twins): expr_time, expr_strings,
    expr_casts and expr_sample."""
    def scan(t):
        return P.Scan(t, schemas[t])

    def tf(f, *args, **kw):
        return E.TemporalFunc(f, tuple(args), **kw)

    def sf(f, *args):
        return E.StringFunc(f, tuple(args))

    c = E.col
    # expr_time: each sale's instant, on the zone's wall clock by month and hour
    j = P.HashJoin(scan("store_sales"), scan("date_dim"), (c("ss_sold_date_sk"),),
                   (c("d_date_sk"),), P.JoinType.INNER, "right")
    j = P.HashJoin(j, scan("time_dim"), (c("ss_sold_time_sk"),), (c("t_time_sk"),),
                   P.JoinType.INNER, "right")
    day = E.Cast(tf("unix_date", tf("make_date", c("d_year"), c("d_moy"), c("d_dom"))), T.INT64)
    ts = tf("timestamp_seconds", day * E.lit(86400) + c("t_hour") * E.lit(3600)
            + c("t_minute") * E.lit(60))
    local = tf("from_utc_timestamp", ts, E.lit(zone))
    month = tf("date_trunc", E.lit("MONTH"), local)
    time_plan = j.project([E.Alias(E.Cast(month, T.string(26)), "month"),
                           E.Alias(tf("hour", local), "hour"),
                           E.Alias(tf("add_months", E.Cast(month, T.DATE), E.lit(1)), "next_month"),
                           c("ss_net_paid")]).aggregate(
        [c("month"), c("hour"), c("next_month")],
        [E.AggExpr("count", None, "n"), E.AggExpr("sum", c("ss_net_paid"), "paid")]).sort(
        [E.SortOrder(c("month")), E.SortOrder(c("hour"))])
    # expr_strings: names cleaned, padded, searched, hashed, by soundex
    full = sf("concat_ws", E.lit(" "), sf("initcap", sf("lower", c("c_first_name"))),
              sf("upper", sf("trim", c("c_last_name"))))
    strings_plan = scan("customer").project([
        E.Alias(E.Soundex(sf("translate", c("c_last_name"), E.lit("0123456789"),
                             E.lit("bcdlmrfgjk"))), "code"),
        E.Alias(full, "full"),
        E.Alias(sf("lpad", E.Cast(c("c_birth_year"), T.string(12)), E.lit(6), E.lit("0")), "by"),
        E.Alias(sf("instr", full, E.lit("A")), "at"),
        E.Alias(sf("replace", c("c_last_name"), E.lit("a"), E.lit("4")), "rep"),
        E.Alias(E.SubstringIndex(full, " ", 1), "first"),
        E.Alias(E.FormatNumber(c("c_customer_sk") * E.lit(37), 2), "fmt")]).aggregate(
        [c("code")],
        [E.AggExpr("count", None, "n"), E.AggExpr("max", sf("length", c("full")), "max_len"),
         E.AggExpr("sum", E.HashFunc("xxhash64", (c("full"),)), "hash"),
         E.AggExpr("sum", c("at"), "at"), E.AggExpr("max", c("by"), "by"),
         E.AggExpr("max", c("rep"), "rep"), E.AggExpr("min", c("first"), "first"),
         E.AggExpr("max", c("fmt"), "fmt")]).sort([E.SortOrder(c("code"))])
    # expr_casts: decimals and doubles through their strings and back, the strings
    # hashed (s computed once, in a projection of its own)
    paid = c("ss_net_paid")
    d = E.Cast(paid, T.FLOAT64) / E.lit(3)
    s = E.Cast(d, T.string(24))

    def bad(cond):
        return E.if_(E.coalesce(cond, E.lit(True)), E.lit(1), E.lit(0))

    casts_plan = scan("store_sales").project(
        [c("ss_store_sk"), paid, E.Alias(d, "d"), E.Alias(s, "s")]).project([
        c("ss_store_sk"),
        E.Alias(bad(E.Cast(E.Cast(paid, T.string(12)), T.decimal(7, 2)) != paid), "bad_dec"),
        E.Alias(bad(E.Cast(c("s"), T.FLOAT64) != c("d")), "bad_double"),
        E.Alias(E.HashFunc("murmur3", (c("s"),)), "mm3"),
        E.Alias(E.HashFunc("xxhash64", (c("s"),)), "xx")]).aggregate(
        [c("ss_store_sk")],
        [E.AggExpr("count", None, "n"), E.AggExpr("sum", c("bad_dec"), "bad_dec"),
         E.AggExpr("sum", c("bad_double"), "bad_double"), E.AggExpr("sum", c("mm3"), "mm3"),
         E.AggExpr("sum", c("xx"), "xx")]).sort([E.SortOrder(c("ss_store_sk"))])
    # expr_sample: a 1% Bernoulli sample, then rand, randn and the row ids
    sample_plan = P.Sample(scan("store_sales"), 0.0, EXPR_FRACTION, False, EXPR_SEED).project([
        c("ss_net_paid"), E.Alias(E.RandExpr("rand", EXPR_SEED2), "r"),
        E.Alias(E.RandExpr("randn", EXPR_SEED2), "g"),
        E.Alias(E.MonotonicallyIncreasingId(), "id")])
    return {"expr_time": time_plan, "expr_strings": strings_plan, "expr_casts": casts_plan,
            "expr_sample": sample_plan}


def expr_s_plan(E, P, T, schemas):
    """cast(cast(ss_net_paid as double) / 3 as string) with its store, the
    column the expr_casts hashes read, for the host's check of it."""
    d = E.Cast(E.col("ss_net_paid"), T.FLOAT64) / E.lit(3)
    return P.Scan("store_sales", schemas["store_sales"]).project(
        [E.col("ss_store_sk"), E.Alias(E.Cast(d, T.string(24)), "s")])


# -- the oracles: numpy, zoneinfo and Python strings

def _zone_offsets(instants: np.ndarray, zone: str) -> np.ndarray:
    """UTC offset (s) of each distinct instant (s), from zoneinfo (a fixed
    offset from its text): read at each UTC hour's start and end, and per
    instant only in an hour where the two differ."""
    import datetime
    import zoneinfo

    if zone.startswith(("+", "-")):
        sign = -1 if zone[0] == "-" else 1
        hh, mm = zone[1:].split(":")
        return np.full(len(instants), sign * (int(hh) * 3600 + int(mm) * 60), np.int64)
    zi = zoneinfo.ZoneInfo(zone)

    def off(t):
        return int(datetime.datetime.fromtimestamp(int(t), zi).utcoffset().total_seconds())

    hours, inv = np.unique(instants // 3600, return_inverse=True)
    start = np.array([off(h * 3600) for h in hours], np.int64)
    end = np.array([off(h * 3600 + 3599) for h in hours], np.int64)
    out = start[inv]
    mixed = (start != end)[inv]
    out[mixed] = [off(t) for t in instants[mixed]]
    return out


def oracle_expr_time(d, zone: str):
    """expr_time's rows: (month text, hour, next month's first day, count,
    paid), sorted by month and hour; a date_dim row that is no date (Feb
    30) makes a null instant, whose sales are the null group, first. The
    zone offsets come from zoneinfo over the date_dim x time_dim grid."""
    import datetime

    ss, dd, td = d["store_sales"], d["date_dim"], d["time_dim"]
    di, dfound = _lookup(dd["d_date_sk"], ss["ss_sold_date_sk"])
    ti, tfound = _lookup(td["t_time_sk"], ss["ss_sold_time_sk"])
    keep = dfound & tfound
    di, ti, paid = di[keep], ti[keep], ss["ss_net_paid"][keep]
    epoch = datetime.date(1970, 1, 1)
    days = np.zeros(len(dd["d_year"]), np.int64)
    real = np.zeros(len(days), bool)
    for i, (y, m, dm) in enumerate(zip(dd["d_year"], dd["d_moy"], dd["d_dom"])):
        try:
            days[i], real[i] = (datetime.date(int(y), int(m), int(dm)) - epoch).days, True
        except ValueError:
            pass
    grid = days[:, None] * 86400 + (td["t_hour"].astype(np.int64) * 3600
                                     + td["t_minute"].astype(np.int64) * 60)[None, :]
    local = grid + _zone_offsets(grid.ravel(), zone).reshape(grid.shape)
    month = local.astype("datetime64[s]").astype("datetime64[M]").astype(np.int64)
    m0 = month[real].min()
    key = (month - m0) * 24 + (local % 86400) // 3600  # per grid cell
    ok = real[di]
    rows = []
    if not ok.all():
        rows.append((None, None, None, int((~ok).sum()), int(paid[~ok].sum())))
    k = key[di[ok], ti[ok]]
    counts = np.bincount(k)
    sums = np.bincount(k, weights=paid[ok].astype(np.float64))  # exact: under 2^53
    for g in np.nonzero(counts)[0]:
        first = np.datetime64(int(m0 + g // 24), "M")
        rows.append((str(first.astype("datetime64[D]")) + " 00:00:00", int(g % 24),
                     int((first + 1).astype("datetime64[D]").astype(np.int64)),
                     int(counts[g]), int(sums[g])))
    return rows


def _initcap(s: str) -> str:
    """The first byte and each byte after a space upper, the rest lower
    (ASCII letters only)."""
    return "".join(ch.upper() if i == 0 or s[i - 1] == " " else ch.lower()
                   for i, ch in enumerate(s))


_SOUNDEX = {ch: str(v) for chars, v in (("BFPV", 1), ("CGJKQSXZ", 2), ("DT", 3), ("L", 4),
                                        ("MN", 5), ("R", 6)) for ch in chars}


def _soundex(s: str) -> str:
    """American Soundex as the port and the JAX package have it (H and W
    transparent, other non-letters resetting the previous code)."""
    if not s or not ("A" <= s[0].upper() <= "Z"):
        return s
    up = s.upper()
    out, prev = up[0], _SOUNDEX.get(up[0], "0")
    for ch in up[1:]:
        code = _SOUNDEX.get(ch, "0")
        if code != "0" and code != prev and len(out) < 4:
            out += code
        if ch not in "HW":
            prev = code
    return out.ljust(4, "0")


def _to_matrix(strs, w: int):
    """Python bytes -> ((n, w) uint8, lengths)."""
    mat = np.zeros((len(strs), w), np.uint8)
    lens = np.zeros(len(strs), np.int64)
    for i, b in enumerate(strs):
        mat[i, : len(b)] = np.frombuffer(b, np.uint8)
        lens[i] = len(b)
    return mat, lens


def xxhash64_bytes_np(mat: np.ndarray, lens: np.ndarray, seed: int = 42) -> np.ndarray:
    """Spark's XXH64.hashUnsafeBytes of each row's first ``lens`` bytes, in
    numpy uint64 (wrapping): 32-byte stripes, 8-byte words, one 4-byte
    word, then single bytes, little-endian."""
    p1, p2, p3, p4, p5 = (np.uint64(c) for c in (
        0x9E3779B185EBCA87, 0xC2B2AE3D27D4EB4F, 0x165667B19E3779F9, 0x85EBCA77C2B2AE63,
        0x27D4EB2F165667C5))
    n, w = mat.shape
    m = mat.astype(np.uint64)
    lens = lens.astype(np.int64)

    def rotl(x, r):
        return (x << np.uint64(r)) | (x >> np.uint64(64 - r))

    def word(j, k):
        out = np.zeros(n, np.uint64)
        for b in range(k):
            if j + b < w:
                out |= m[:, j + b] << np.uint64(8 * b)
        return out

    def rnd(acc, x):
        return rotl(acc + x * p2, 31) * p1

    with np.errstate(over="ignore"):
        s = np.uint64(seed)
        v = [np.full(n, s + p1 + p2), np.full(n, s + p2), np.full(n, s), np.full(n, s - p1)]
        stripes = np.zeros(n, np.int64)
        for st in range(w // 32):
            act = (st + 1) * 32 <= lens
            v = [np.where(act, rnd(acc, word(32 * st + 8 * k, 8)), acc) for k, acc in enumerate(v)]
            stripes += act
        hl = rotl(v[0], 1) + rotl(v[1], 7) + rotl(v[2], 12) + rotl(v[3], 18)
        for acc in v:
            hl = (hl ^ rnd(np.uint64(0), acc)) * p1 + p4
        h = np.where(lens >= 32, hl, np.full(n, s + p5)) + lens.astype(np.uint64)
        done = np.where(lens >= 32, stripes * 32, 0)
        for j in range(w // 8):
            act = (8 * j >= done) & (8 * j + 8 <= lens)
            h = np.where(act, rotl(h ^ rnd(np.uint64(0), word(8 * j, 8)), 27) * p1 + p4, h)
        done = (lens // 8) * 8
        for j in range(w // 4 + 1):
            act = (4 * j == done) & (4 * j + 4 <= lens)
            h = np.where(act, rotl(h ^ (word(4 * j, 4) * p1), 23) * p2 + p3, h)
        done = (lens // 4) * 4
        for j in range(w):
            act = (j >= done) & (j < lens)
            h = np.where(act, rotl(h ^ (m[:, j] * p5), 11) * p1, h)
        h ^= h >> np.uint64(33)
        h *= p2
        h ^= h >> np.uint64(29)
        h *= p3
        h ^= h >> np.uint64(32)
    return h.view(np.int64)


def mm3_hash_bytes_np(mat: np.ndarray, lens: np.ndarray, seed: int = 42) -> np.ndarray:
    """Spark's Murmur3_x86_32.hashUnsafeBytes: the 4-byte little-endian
    words, then each tail byte as a signed int, then fmix with the length.
    int32 hashes."""
    n, w = mat.shape
    m = mat.astype(np.uint64)
    lens = lens.astype(np.int64)

    def mix_k1(k):
        return _mul32(_rotl32(_mul32(k, 0xCC9E2D51), 15), 0x1B873593)

    def mix_h1(h, k):
        return (_mul32(_rotl32(h ^ k, 13), 5) + np.uint64(0xE6546B64)) & _U32

    h = np.full(n, np.uint64(seed) & _U32)
    for i in range(w // 4):
        wd = m[:, 4 * i] | (m[:, 4 * i + 1] << np.uint64(8)) | (m[:, 4 * i + 2] << np.uint64(16)) \
            | (m[:, 4 * i + 3] << np.uint64(24))
        h = np.where(4 * (i + 1) <= lens, mix_h1(h, mix_k1(wd)), h)
    for j in range(w):
        signed = mat[:, j].astype(np.int8).astype(np.int64).astype(np.uint64) & _U32
        h = np.where((j >= (lens // 4) * 4) & (j < lens), mix_h1(h, mix_k1(signed)), h)
    h ^= lens.astype(np.uint64)
    h = _mul32(h ^ (h >> np.uint64(16)), 0x85EBCA6B)
    h = _mul32(h ^ (h >> np.uint64(13)), 0xC2B2AE35)
    h ^= h >> np.uint64(16)
    return h.astype(np.uint32).view(np.int32)


def oracle_expr_strings(d):
    """expr_strings' rows: (code, n, max_len, hash, at, by, rep, first,
    fmt), sorted by code; Python string code over the customers."""
    cu = d["customer"]
    table = str.maketrans("0123456789", "bcdlmrfgjk")
    groups = {}
    full_cache = {}
    for sk, first, last, year in zip(cu["c_customer_sk"], cu["c_first_name"], cu["c_last_name"],
                                     cu["c_birth_year"]):
        key = (first, last)
        if key not in full_cache:
            full = _initcap(first.lower()) + " " + last.strip(" ").upper()
            full_cache[key] = (full, _soundex(last.translate(table)), full.find("A") + 1,
                               last.replace("a", "4"), full.split(" ")[0])
        full, code, at, rep, head = full_cache[key]
        g = groups.setdefault(code, [0, 0, [], 0, "", "", None, ""])
        g[0] += 1
        g[1] = max(g[1], len(full))
        g[2].append(full)
        g[3] += at
        g[4] = max(g[4], str(int(year)).rjust(6, "0")[:6])
        g[5] = max(g[5], rep)
        g[6] = head if g[6] is None else min(g[6], head)
        g[7] = max(g[7], f"{int(sk) * 37:,.2f}")
    rows = []
    for code in sorted(groups):
        n, mx, fulls, at, by, rep, head, fmt = groups[code]
        uniq, counts = np.unique(np.array(fulls, object), return_counts=True)
        mat, lens = _to_matrix([u.encode() for u in uniq], 64)
        h = xxhash64_bytes_np(mat, lens).astype(np.uint64) * counts.astype(np.uint64)
        total = int(np.sum(h, dtype=np.uint64).view(np.int64))
        rows.append((code.encode(), n, mx, total, at, by.encode(), rep.encode(), head.encode(),
                     fmt.encode()))
    return rows


def java_double(v: float) -> str:
    """Java's Double.toString: the shortest round-trip digits (Python's
    repr), plainly for 1e-3 <= |v| < 1e7, else d.dddE±x."""
    import math
    from decimal import Decimal

    if v != v:
        return "NaN"
    if math.isinf(v):
        return "Infinity" if v > 0 else "-Infinity"
    if v == 0:
        return "-0.0" if math.copysign(1.0, v) < 0 else "0.0"
    _, digs, exp = Decimal(repr(abs(v))).as_tuple()
    s = "".join(map(str, digs)).rstrip("0") or "0"
    sci = exp + len(digs) - 1
    if -3 <= sci < 7:
        body = (s[: sci + 1].ljust(sci + 1, "0") + "." + (s[sci + 1:] or "0") if sci >= 0
                else "0." + "0" * (-sci - 1) + s)
    else:
        body = s[0] + "." + (s[1:] or "0") + "E" + str(sci)
    return ("-" if v < 0 else "") + body


def oracle_expr_casts_base(d):
    """expr_casts' rows but the hash sums: (store, count, 0, 0) per store;
    every cast must round-trip."""
    ss = d["store_sales"]
    stores, counts = np.unique(ss["ss_store_sk"], return_counts=True)
    return [(int(k), int(n), 0, 0) for k, n in zip(stores, counts)]


# -- xorshift, apart from the port's: the state's powers as 64 column images
# (Python ints), lanes of a block each stepped in numpy

_M64_INT = (1 << 64) - 1


def _xs_step_int(s: int) -> int:
    s ^= (s << 21) & _M64_INT
    s ^= s >> 35
    return s ^ ((s << 4) & _M64_INT)


def _xs_apply(cols, x: int) -> int:
    out = 0
    for i in range(64):
        if (x >> i) & 1:
            out ^= cols[i]
    return out


def xorshift_seed(seed: int) -> int:
    """XORShiftRandom.hashSeed(seed) (partition 0), unsigned: murmur3 of the
    8 big-endian bytes, twice."""
    def mm3(data: bytes, h: int) -> int:
        for off in (0, 4):
            k = int.from_bytes(data[off:off + 4], "little")
            k = (k * 0xCC9E2D51) & 0xFFFFFFFF
            k = ((k << 15) | (k >> 17)) & 0xFFFFFFFF
            k = (k * 0x1B873593) & 0xFFFFFFFF
            h ^= k
            h = ((h << 13) | (h >> 19)) & 0xFFFFFFFF
            h = (h * 5 + 0xE6546B64) & 0xFFFFFFFF
        h ^= 8
        h ^= h >> 16
        h = (h * 0x85EBCA6B) & 0xFFFFFFFF
        h ^= h >> 13
        h = (h * 0xC2B2AE35) & 0xFFFFFFFF
        return h ^ (h >> 16)

    b = (seed & _M64_INT).to_bytes(8, "big")
    lo = mm3(b, 0x3C074A61)
    return ((mm3(b, lo) << 32) | lo) & _M64_INT


def xorshift_doubles(seed: int, n: int, lanes: int = 4096) -> np.ndarray:
    """The first n nextDouble draws of XORShiftRandom(seed): each of
    ``lanes`` lanes starts a block of draws by a jump and steps it in
    numpy."""
    per = max(-(-n // lanes), 1)
    lanes = -(-n // per)
    starts, s = [], xorshift_seed(seed)
    stride = _xs_jump_cols(2 * per)
    for _ in range(lanes):
        starts.append(s)
        s = _xs_apply(stride, s)
    x = np.array(starts, np.uint64)
    out = np.zeros((lanes, per), np.float64)
    with np.errstate(over="ignore"):
        for j in range(per):
            x = _np_step(x)
            a = x & np.uint64((1 << 26) - 1)
            x = _np_step(x)
            out[:, j] = ((a << np.uint64(27)) | (x & np.uint64((1 << 27) - 1))).astype(
                np.float64) * 2.0**-53
    return out.reshape(-1)[:n]


def _xs_jump_cols(n: int):
    """The column images of M^n."""
    cols = [_xs_step_int(1 << i) for i in range(64)]
    out = [1 << i for i in range(64)]
    while n:
        if n & 1:
            out = [_xs_apply(cols, c) for c in out]
        cols = [_xs_apply(cols, c) for c in cols]
        n >>= 1
    return out


def _np_step(x):
    x = x ^ (x << np.uint64(21))
    x = x ^ (x >> np.uint64(35))
    return x ^ (x << np.uint64(4))


def xorshift_sequential(seed: int, n: int) -> list:
    """The first n nextDouble draws, one step at a time in Python."""
    s, out = xorshift_seed(seed), []
    for _ in range(n):
        s = _xs_step_int(s)
        a = s & ((1 << 26) - 1)
        s = _xs_step_int(s)
        out.append(((a << 27) + (s & ((1 << 27) - 1))) * 2.0**-53)
    return out


def gaussians(draws, n: int) -> list:
    """Java's nextGaussian over a stream of nextDouble draws: the polar
    method, the second value cached."""
    import math

    out, i = [], 0
    while len(out) < n:
        v1, v2 = 2 * draws[i] - 1, 2 * draws[i + 1] - 1
        i += 2
        s = v1 * v1 + v2 * v2
        if s < 1 and s != 0:
            mult = math.sqrt(-2 * math.log(s) / s)
            out += [v1 * mult, v2 * mult]
    return out[:n]


def oracle_expr_sample(d):
    """The sampled rows' ids, sum(ss_net_paid), their rand values and the
    first randn values; the lanes generator held to the sequential one over
    the first 100,000 draws."""
    ss = d["store_sales"]
    n = len(ss["ss_net_paid"])
    u = xorshift_doubles(EXPR_SEED, max(n, 100_000))
    head = xorshift_sequential(EXPR_SEED, 100_000)
    if not np.array_equal(u[:100_000], np.array(head)):
        raise AssertionError("expr_sample oracle: the lanes generator is not the sequential one")
    u = u[:n]
    ids = np.nonzero((u >= 0.0) & (u < EXPR_FRACTION))[0]
    r = xorshift_doubles(EXPR_SEED2, len(ids))
    g = gaussians(xorshift_sequential(EXPR_SEED2, 4 * EXPR_RANDN_HEAD), EXPR_RANDN_HEAD)
    return {"ids": ids, "paid": int(ss["ss_net_paid"][ids].sum()), "rand": r, "randn": g}


def expr_oracles(d) -> dict:
    zone = expr_zone()
    return {"expr_time": lambda: oracle_expr_time(d, zone),
            "expr_strings": lambda: oracle_expr_strings(d),
            "expr_casts": lambda: oracle_expr_casts_base(d),
            "expr_sample": lambda: oracle_expr_sample(d)}


EXPR_RANDN_RTOL = 1e-12  # randn: torch's log and sqrt against libm's


def check_expr(name: str, out, expect, what: str, sess=None, data=None) -> dict:
    """An expr_* answer against its oracle; returns the line's checked
    figures."""
    if name == "expr_time":
        got = out_rows(out, ("month", "hour", "next_month", "n", "paid"))
        got = [(r[0].decode() if isinstance(r[0], bytes) else r[0],) + r[1:] for r in got]
        if got != expect:
            raise AssertionError(f"{what}: {got[:3]}... ({len(got)} rows), expected "
                                 f"{expect[:3]}... ({len(expect)} rows)")
        return {"groups": len(got), "rows_joined": sum(r[3] for r in got)}
    if name == "expr_strings":
        cols = ("code", "n", "max_len", "hash", "at", "by", "rep", "first", "fmt")
        got = [tuple(v.encode() if isinstance(v, str) else v for v in r)
               for r in out_rows(out, cols)]
        if got != expect:
            raise AssertionError(f"{what}: {got[:2]}, expected {expect[:2]}")
        return {"groups": len(got), "customers": sum(r[1] for r in got)}
    if name == "expr_casts":
        got = out_rows(out, ("ss_store_sk", "n", "bad_dec", "bad_double"))
        if got != expect:
            raise AssertionError(f"{what}: {got[:3]}, expected {expect[:3]} (a cast that "
                                 "does not round-trip counts in bad_dec or bad_double)")
        return expr_hash_check(out, sess, data, what)
    ids = out["id"]
    if not np.array_equal(ids, expect["ids"]):
        raise AssertionError(f"{what}: {len(ids)} rows sampled, expected {len(expect['ids'])}")
    paid = int(out["ss_net_paid"].sum())
    if paid != expect["paid"]:
        raise AssertionError(f"{what}: sum(ss_net_paid) {paid}, expected {expect['paid']}")
    if not np.array_equal(out["r"], expect["rand"]):
        raise AssertionError(f"{what}: rand differs from XORShiftRandom's draws")
    head = out["g"][:EXPR_RANDN_HEAD]
    np.testing.assert_allclose(head, expect["randn"][: len(head)], rtol=EXPR_RANDN_RTOL, atol=0,
                               err_msg=f"{what}: randn")
    return {"rows": len(ids), "sum_net_paid": paid, "sum_rand": float(out["r"].sum()),
            "randn_head": [float(x) for x in head]}


def expr_hash_check(out, sess, data, what: str) -> dict:
    """expr_casts' hash sums against numpy's hashes of the device's own
    strings (gathered to the host; every row of one ss_net_paid value holds
    the same string, so each distinct value is hashed once), and the
    values of a seeded sample of ``EXPR_FORMAT_SAMPLE`` rows against Java's
    Double.toString of the same doubles."""
    from datafusion_comet_tpu_torch import types as T
    from datafusion_comet_tpu_torch.ir import expr as E
    from datafusion_comet_tpu_torch.ir import plan as P
    from datafusion_comet_tpu_torch.models import tpcds

    b = sess.execute(expr_s_plan(E, P, T, tpcds.SCHEMAS))
    live = b.row_mask.cpu().numpy()
    store = b.columns[0].data.cpu().numpy()[live]
    mat, lens = b.columns[1].data.cpu().numpy()[live], b.columns[1].lengths.cpu().numpy()[live]
    del b
    paid = data["store_sales"]["ss_net_paid"]
    # the distinct values and each row's, by their range (no sort)
    lo = int(paid.min())
    inv = paid - lo
    first = np.full(int(paid.max()) - lo + 1, -1, np.int64)
    first[inv[::-1]] = np.arange(len(paid) - 1, -1, -1)
    present = np.nonzero(first >= 0)[0]
    ids = np.zeros(len(first), np.int64)
    ids[present] = np.arange(len(present))
    inv, first = ids[inv], first[present]
    rep_mat, rep_lens = mat[first], lens[first]
    if not (np.array_equal(lens, rep_lens[inv]) and (mat == rep_mat[inv]).all()):
        raise AssertionError(f"{what}: one ss_net_paid value cast to two strings")
    dbl = (present + lo).astype(np.float64) / 100.0 / 3.0
    rng = np.random.default_rng(EXPR_SEED)
    pick = np.unique(inv[rng.integers(0, len(paid), min(EXPR_FORMAT_SAMPLE, len(paid)))])
    java = np.array([java_double(float(x)).encode() for x in dbl[pick]], f"S{mat.shape[1]}")
    wrong = np.nonzero(np.ascontiguousarray(rep_mat[pick]).view(java.dtype)[:, 0] != java)[0]
    if len(wrong):
        i = pick[wrong[0]]
        raise AssertionError(f"{what}: cast({dbl[i]!r} as string) gave "
                             f"{bytes(rep_mat[i, : rep_lens[i]])!r}, Java prints "
                             f"{java_double(float(dbl[i]))}")
    h32 = mm3_hash_bytes_np(rep_mat, rep_lens).astype(np.int64)[inv]
    h64 = xxhash64_bytes_np(rep_mat, rep_lens).view(np.uint64)[inv]
    want = []
    with np.errstate(over="ignore"):
        for k in np.unique(store):
            sel = store == k
            want.append((int(k), int(h32[sel].sum()),
                         int(np.sum(h64[sel], dtype=np.uint64).view(np.int64))))
    got = out_rows(out, ("ss_store_sk", "mm3", "xx"))
    if got != want:
        raise AssertionError(f"{what}: hash sums {got[:2]}, numpy's {want[:2]}")
    return {"stores": len(got), "distinct_strings": len(present), "format_checked": len(pick),
            "bad_dec": 0, "bad_double": 0}


# the expr plans profiled under --profile (not expr_casts': 20 s at SF100, cut
# to hold the run's time)
EXPR_PROFILE = ("expr_time", "expr_strings", "expr_sample")


def expr_phase(sess, data, ds_sf: float, reps: int, profile: bool, launches, total) -> None:
    """The expression query set over the staged TPC-DS tables (SF100 with
    --sf 10): expr_time, expr_strings, expr_casts and expr_sample
    (``expr_plans``), each through Session.collect against its oracle (the
    TPC-DS oracle worker's, but expr_casts' hash sums, which numpy checks
    here over the device's own strings): warm ms, peak device memory, rows
    and the launches of B1, B2 and B3."""
    from datafusion_comet_tpu_torch import types as T
    from datafusion_comet_tpu_torch.ir import expr as E
    from datafusion_comet_tpu_torch.ir import plan as P
    from datafusion_comet_tpu_torch.models import tpcds

    zone = expr_zone()
    t_phase = time.perf_counter()
    for name, plan in expr_plans(E, P, T, tpcds.SCHEMAS, zone).items():
        key = f"ds_{name}"
        out, launches[key], first_s, times, peak, _, _, _ = run_query(sess, plan, reps,
                                                                      log_b3=False)
        for k in total:
            total[k] += launches[key][k]
        t0 = time.perf_counter()
        expect = memo_oracle(("tpcds", name, ds_sf), expr_oracles(data)[name])
        t1 = time.perf_counter()
        rec = {"phase": name, "sf": ds_sf, "first_run_s": first_s,
               "warm_ms": statistics.median(times), "peak_gb": peak / 1e9,
               "rows": len(next(iter(out.values()))), "launches": launches[key],
               **check_expr(name, out, expect, key, sess, data),
               "oracle_wait_s": t1 - t0, "check_s": time.perf_counter() - t1}
        if name == "expr_time":
            rec["zone"] = zone
        emit(rec)
        if profile and name in EXPR_PROFILE:
            emit(profile_run(sess, plan, f"profile_{name}"))
    emit({"phase": "expr", "sf": ds_sf, "phase_s": time.perf_counter() - t_phase})


NESTED_CAP = 32  # the collects' max_elems (ROADMAP C31: values past it are dropped)
NESTED_ITEM = 7  # array_contains(items, NESTED_ITEM)
NESTED_FILTER = 100  # filter(items, x -> x > NESTED_FILTER)
NESTED_PCTS = (0.25, 0.5, 0.75)
NESTED_SPLIT_PARTS = 8
NESTED_PROFILE = "nested_explode"


def nested_plans(E, P, T, schemas) -> dict:
    """The nested query set over the TPC-DS tables (ROADMAP A.3):
    nested_basket (store_sales grouped by ticket: collect_list and
    collect_set, then size, array_contains, sort_array, array_distinct,
    element_at, transform, filter and aggregate over the lists, the
    baskets counted per size), nested_explode (posexplode of each ticket's
    items joined to item, COUNT and SUMs per category), nested_struct_map
    (customer: named_struct read back by GetStructField, map_from_arrays
    with colliding keys, element_at, map_contains_key, size),
    nested_split (split(i_item_desc, ' ') exploded, a count per word) and
    nested_percentile (percentile(ss_net_paid, array(0.25, 0.5, 0.75)) per
    store)."""
    A = lambda f, *a: E.ArrayExpr(f, tuple(a))  # noqa: E731
    x, acc = E.LambdaVar("x"), E.LambdaVar("acc")
    ss = P.Scan("store_sales", schemas["store_sales"])
    tk = E.col("ss_ticket_number")

    def collect(f, c, name):
        return E.AggExpr(f, E.col(c), name, max_elems=NESTED_CAP)

    items = E.col("items")
    basket = ss.aggregate([tk], [collect("collect_list", "ss_item_sk", "items"),
                                 collect("collect_set", "ss_store_sk", "stores"),
                                 collect("collect_list", "ss_quantity", "qtys"),
                                 E.AggExpr("sum", E.col("ss_quantity"), "sq")])

    def fold(arr):
        return E.HigherOrderFunc("aggregate", (arr, E.lit(0, T.INT64)), ("acc", "x"), acc + x)

    per_basket = basket.project([
        E.Alias(A("size", items), "n_items"),
        E.Alias(E.if_(A("array_contains", items, E.lit(NESTED_ITEM, T.INT64)), 1, 0), "has"),
        E.Alias(A("element_at", A("sort_array", items), E.lit(1)), "min_item"),
        E.Alias(A("size", A("array_distinct", items)), "n_distinct"),
        E.Alias(A("element_at", items, E.lit(1)), "first"),
        E.Alias(fold(E.HigherOrderFunc("transform", (items,), ("x",),
                                       E.BinaryOp("mod", x, E.lit(7)))), "mod7"),
        E.Alias(A("size", E.HigherOrderFunc("filter", (items,), ("x",),
                                            x > E.lit(NESTED_FILTER, T.INT64))), "n_filter"),
        E.Alias(fold(E.col("qtys")), "hof_sum"), E.col("sq"),
        E.Alias(A("size", E.col("stores")), "n_stores")])
    sums = ("has", "min_item", "n_distinct", "first", "mod7", "n_filter", "hof_sum", "sq",
            "n_stores")
    plans = {"nested_basket": per_basket.aggregate(
        [E.col("n_items")], [E.AggExpr("count", None, "baskets")]
        + [E.AggExpr("sum", E.col(c), f"s_{c}") for c in sums]).sort(
        [E.SortOrder(E.col("n_items"))])}

    lists = ss.aggregate([tk], [collect("collect_list", "ss_item_sk", "items")])
    exploded = P.Explode(lists, items, False, True)
    joined = P.HashJoin(exploded, P.Scan("item", schemas["item"]), (E.col("col"),),
                        (E.col("i_item_sk"),), "inner")
    plans["nested_explode"] = joined.aggregate(
        [E.col("i_category")], [E.AggExpr("count", None, "n"),
                                E.AggExpr("sum", E.col("col"), "s_item"),
                                E.AggExpr("sum", E.col("pos"), "s_pos")]).sort(
        [E.SortOrder(E.col("i_category"))])

    names = ("c_first_name", "c_last_name", "c_birth_year")
    st = E.col("s")
    m = E.col("m")
    cu = P.Scan("customer", schemas["customer"]).project([
        E.Alias(E.StructExpr(tuple(E.col(n) for n in names), names), "s"),
        E.Alias(E.MapExpr("map_from_arrays", (
            A("array", E.lit(1930), E.col("c_birth_year"), E.lit(1990)),
            A("array", E.col("c_customer_sk"), E.col("c_current_cdemo_sk"),
              E.col("c_current_hdemo_sk")))), "m")])
    year = E.GetStructField(st, "c_birth_year")
    fields = cu.project([
        E.Alias(year, "year"),
        E.Alias(E.StringFunc("length", (E.GetStructField(st, "c_last_name"),)), "last_len"),
        E.Alias(E.if_(E.GetStructField(st, "c_first_name") == E.lit("First000"), 1, 0),
                "first0"),
        E.Alias(E.MapExpr("element_at", (m, E.lit(1930))), "v1930"),
        E.Alias(E.MapExpr("element_at", (m, year)), "vyear"),
        E.Alias(E.if_(E.MapExpr("map_contains_key", (m, E.lit(1960))), 1, 0), "has1960"),
        E.Alias(E.MapExpr("size", (m,)), "msize")])
    plans["nested_struct_map"] = fields.aggregate(
        [E.col("year")], [E.AggExpr("count", None, "n")]
        + [E.AggExpr("sum", E.col(c), f"s_{c}")
           for c in ("last_len", "first0", "v1930", "vyear", "has1960", "msize")]).sort(
        [E.SortOrder(E.col("year"))])

    words = P.Scan("item", schemas["item"]).project([
        E.Alias(E.Split(E.col("i_item_desc"), " ", NESTED_SPLIT_PARTS), "words")])
    plans["nested_split"] = P.Explode(words, E.col("words")).aggregate(
        [E.col("col")], [E.AggExpr("count", None, "n")])

    plans["nested_percentile"] = ss.aggregate([E.col("ss_store_sk")], [E.AggExpr(
        "percentile", E.col("ss_net_paid"), "p",
        extra=(E.lit(NESTED_PCTS, T.list_(T.FLOAT64, len(NESTED_PCTS))),))]).sort(
        [E.SortOrder(E.col("ss_store_sk"))])
    return plans


def _tickets(ss):
    """store_sales by ticket in input order: (order, group id of each sorted
    row, each group's first sorted row, group sizes, rank in the group)."""
    order = np.argsort(ss["ss_ticket_number"], kind="stable")
    t = ss["ss_ticket_number"][order]
    starts = np.flatnonzero(np.r_[True, t[1:] != t[:-1]])
    sizes = np.diff(np.r_[starts, len(t)])
    g = np.repeat(np.arange(len(starts)), sizes)
    return order, g, starts, sizes, np.arange(len(t)) - starts[g]


def _distinct_per_group(g, v, keep, n):
    """Distinct ``v`` per group among the ``keep`` rows."""
    o = np.lexsort((v[keep], g[keep]))
    gs, vs = g[keep][o], v[keep][o]
    first = np.r_[True, (gs[1:] != gs[:-1]) | (vs[1:] != vs[:-1])]
    return np.bincount(gs[first], minlength=n)


def oracle_nested_basket(d):
    """Per basket size: the baskets and the sums the plan takes, over each
    ticket's first ``NESTED_CAP`` items in input order (C31's cut), and the
    groups over the cap."""
    ss = d["store_sales"]
    order, g, starts, sizes, rank = _tickets(ss)
    n = len(starts)
    keep = rank < NESTED_CAP
    it = ss["ss_item_sk"][order]
    q = ss["ss_quantity"][order].astype(np.int64)
    st = ss["ss_store_sk"][order]

    def gsum(v):
        return np.bincount(g[keep], weights=v[keep].astype(np.float64), minlength=n).astype(
            np.int64) if len(v) else np.zeros(n, np.int64)

    big = np.iinfo(np.int64).max
    mins = np.minimum.reduceat(np.where(keep, it, big), starts)
    per = {"n_items": np.minimum(sizes, NESTED_CAP),
           "has": (np.bincount(g[keep & (it == NESTED_ITEM)], minlength=n) > 0).astype(np.int64),
           "min_item": mins, "n_distinct": _distinct_per_group(g, it, keep, n),
           "first": it[starts], "mod7": gsum(it % 7),
           "n_filter": np.bincount(g[keep & (it > NESTED_FILTER)], minlength=n),
           "hof_sum": gsum(q), "sq": np.add.reduceat(q, starts),
           "n_stores": np.minimum(_distinct_per_group(g, st, np.ones(len(g), bool), n),
                                  NESTED_CAP)}
    out = {}
    for size in np.unique(per["n_items"]):
        sel = per["n_items"] == size
        out[int(size)] = [int(sel.sum())] + [int(per[c][sel].sum()) for c in
                                             ("has", "min_item", "n_distinct", "first", "mod7",
                                              "n_filter", "hof_sum", "sq", "n_stores")]
    return {"rows": out, "truncated_groups": int((sizes > NESTED_CAP).sum())}


def oracle_nested_explode(d):
    """Per category: the rows, the items' sum and the positions' sum over
    each ticket's first ``NESTED_CAP`` items; the direct store_sales x item
    COUNT and SUM beside them."""
    ss, it = d["store_sales"], d["item"]
    order, g, starts, sizes, rank = _tickets(ss)
    keep = rank < NESTED_CAP
    items = ss["ss_item_sk"][order]
    cat_of = dict(zip(it["i_item_sk"].tolist(), it["i_category"].tolist()))
    cats = sorted(set(cat_of.values()))
    code = {c: i for i, c in enumerate(cats)}
    lut = np.full(int(it["i_item_sk"].max()) + 1, -1, np.int64)
    lut[it["i_item_sk"]] = [code[c] for c in it["i_category"]]
    ci = lut[items]
    hit = keep & (ci >= 0)
    n = np.bincount(ci[hit], minlength=len(cats))
    s_item = np.bincount(ci[hit], weights=items[hit].astype(np.float64), minlength=len(cats))
    s_pos = np.bincount(ci[hit], weights=rank[hit].astype(np.float64), minlength=len(cats))
    di = lut[ss["ss_item_sk"]]
    direct_n = np.bincount(di[di >= 0], minlength=len(cats))
    return {"rows": {c: [int(n[i]), int(s_item[i]), int(s_pos[i])]
                     for i, c in enumerate(cats) if n[i]},
            "direct_n": {c: int(direct_n[i]) for i, c in enumerate(cats) if direct_n[i]},
            "truncated_groups": int((sizes > NESTED_CAP).sum())}


def oracle_nested_struct_map(d):
    cu = d["customer"]
    year = cu["c_birth_year"].astype(np.int64)
    v1930 = np.where(year == 1930, cu["c_current_cdemo_sk"], cu["c_customer_sk"])
    vyear = np.where(year == 1990, cu["c_current_hdemo_sk"], cu["c_current_cdemo_sk"])
    cols = {"last_len": np.array([len(s) for s in cu["c_last_name"]], np.int64),
            "first0": (cu["c_first_name"] == "First000").astype(np.int64),
            "v1930": v1930, "vyear": vyear, "has1960": (year == 1960).astype(np.int64),
            "msize": 3 - (year == 1930) - (year == 1990)}
    out = {}
    for y in np.unique(year):
        sel = year == y
        out[int(y)] = [int(sel.sum())] + [int(cols[c][sel].sum()) for c in cols]
    return {"rows": out, "truncated_groups": 0}


def oracle_nested_split(d):
    import collections

    words = collections.Counter(w for s in d["item"]["i_item_desc"] for w in s.split(" "))
    return {"rows": dict(words), "truncated_groups": 0,
            "max_fields": max(len(s.split(" ")) for s in d["item"]["i_item_desc"])}


def oracle_nested_percentile(d):
    """Per store, Spark's exact percentile at each of ``NESTED_PCTS``: the
    linear interpolation at rank (n - 1) p of the sorted values."""
    ss = d["store_sales"]
    out = {}
    store, paid = ss["ss_store_sk"], ss["ss_net_paid"]
    order = np.lexsort((paid, store))
    s, x = store[order], paid[order] / 100.0
    starts = np.flatnonzero(np.r_[True, s[1:] != s[:-1]])
    ends = np.r_[starts[1:], len(s)]
    for a, b in zip(starts, ends):
        n, vals = b - a, []
        for p in NESTED_PCTS:
            t = (n - 1.0) * p
            lo, hi = int(np.floor(t)), int(np.ceil(t))
            vals.append(float(x[a + lo] + (x[a + hi] - x[a + lo]) * (t - lo)))
        out[int(s[a])] = vals
    return {"rows": out, "truncated_groups": 0}


def nested_oracles(d) -> dict:
    return {"nested_basket": lambda: oracle_nested_basket(d),
            "nested_explode": lambda: oracle_nested_explode(d),
            "nested_struct_map": lambda: oracle_nested_struct_map(d),
            "nested_split": lambda: oracle_nested_split(d),
            "nested_percentile": lambda: oracle_nested_percentile(d)}


NESTED_PCT_RTOL = 1e-12


def check_nested(name: str, out, expect, what: str) -> None:
    """A nested_* answer against its oracle: every value exact, the
    percentile lists within ``NESTED_PCT_RTOL``."""
    keys = next(iter(out))
    want = expect["rows"]
    if name == "nested_percentile":
        got = dict(zip(out["ss_store_sk"].tolist(), out["p"]))
        ok = set(got) == set(want) and all(
            len(got[k]) == len(want[k]) and all(abs(a - b) <= NESTED_PCT_RTOL * abs(b)
                                                for a, b in zip(got[k], want[k])) for k in want)
    elif name == "nested_split":
        got = dict(zip(out["col"], out["n"].tolist()))
        ok = got == want
    else:
        cols = [c for c in out if not c.endswith("__valid")]
        got = {(k.item() if isinstance(k, np.generic) else k):
               [int(out[c][i]) for c in cols[1:]] for i, k in enumerate(out[keys])}
        ok = got == want
    if not ok:
        raise AssertionError(f"{what}: differs from its oracle")
    if name == "nested_explode" and {c: v[0] for c, v in want.items()} != expect["direct_n"]:
        raise AssertionError(f"{what}: the oracle's rows differ from the direct join's")


def nested_phase(sess, data, ds_sf: float, reps: int, profile: bool, launches, total,
                 b3_calls) -> None:
    """The nested query set (``nested_plans``) through Session.collect on
    the TPC-DS session, each against its numpy oracle (the TPC-DS oracle
    worker's): warm ms, peak memory, rows, B1/B2/B3 launches and
    ``truncated_groups`` (the groups a collect's cap cut: ROADMAP C31);
    nested_explode's B3 calls are logged for the partition phase, and its
    ``device_profile`` report (the package's torch.profiler API) must hold
    device events (ROADMAP P2)."""
    from datafusion_comet_tpu_torch import types as T
    from datafusion_comet_tpu_torch.ir import expr as E
    from datafusion_comet_tpu_torch.ir import plan as P
    from datafusion_comet_tpu_torch.models import tpcds
    from datafusion_comet_tpu_torch.observability.profile import device_profile

    t_phase = time.perf_counter()
    for name, plan in nested_plans(E, P, T, tpcds.SCHEMAS).items():
        out, launches[name], first_s, times, peak, log, _, _ = run_query(
            sess, plan, reps, log_b3=name == "nested_explode")
        if log:
            b3_calls[name] = log
        for k in total:
            total[k] += launches[name][k]
        t0 = time.perf_counter()
        expect = memo_oracle(("tpcds", name, ds_sf), nested_oracles(data)[name])
        t1 = time.perf_counter()
        check_nested(name, out, expect, name)
        rec = {"phase": name, "sf": ds_sf, "correct": True, "first_run_s": first_s,
               "warm_ms": statistics.median(times), "peak_gb": peak / 1e9,
               "rows": len(next(iter(out.values()))), "launches": launches[name],
               "truncated_groups": expect["truncated_groups"], "cap": NESTED_CAP,
               "oracle_wait_s": t1 - t0, "check_s": time.perf_counter() - t1,
               **run_record(sess)}
        if name == NESTED_PROFILE:
            rep = device_profile(lambda p=plan: sess.collect(p))
            if not rep["device_events"]:
                raise AssertionError(f"device_profile recorded no device event for {name}")
            rec["device_profile"] = {"device_events": rep["device_events"],
                                     "host_events": rep["host_events"],
                                     "top_device_ops": [(op[:80], us) for op, us in
                                                        rep["top_device_ops"][:8]]}
        # ROADMAP C32: the stage estimates the budget saw, beside the peak
        rec["stage_estimates_gb"] = [r["estimate"] / 1e9 for r in sess.runs
                                     if r["where"] == "stage" and r["estimate"]]
        emit(rec)
        if profile:
            emit(profile_run(sess, plan, f"profile_{name}"))
    emit({"phase": "nested", "sf": ds_sf, "phase_s": time.perf_counter() - t_phase})


# ---- the text phase: regex, bytes, JSON and Python UDFs over TPC-DS -----------------

# RLIKE patterns: the first's automaton within the JAX package's select-tree
# thresholds (at most 64 states and 24 byte classes), the second's over both
TEXT_P1 = "item [0-9]*7$"
TEXT_P2 = "desc of item 1|abcdefghijklmnopqrstuvwxyz"
TEXT_UDF_ROWS = 10_000  # the staged table of the host-bridge functions
TEXT_SEED = 41
TEXT_DIGESTS = ("md5", "sha1", "sha2_224", "sha2_256", "sha2_384", "sha2_512", "hex",
                "base64", "unbase64")


def _brand_prefix(b):
    return None if b is None else b[:7]


def _price_over_50(p):
    return None if p is None else p >= 50.0


def text_staged_table(n: int = TEXT_UDF_ROWS):
    """The host-bridge functions' table: a URL and a JSON document a row,
    from ``TEXT_SEED``."""
    rng = np.random.default_rng(TEXT_SEED)
    host = rng.integers(0, 37, n)
    k = rng.integers(0, 11, n)
    url = np.array([f"http://host{h}.example.com/p/{i}?k={kk}&z=1" if i % 13 else None
                    for i, (h, kk) in enumerate(zip(host, k))], dtype=object)
    doc = np.array([('{"a": %d, "b": "w%d"}' % (i, i % 5)) if i % 17 else "oops"
                    for i in range(n)], dtype=object)
    return {"url": url, "doc": doc}


def text_plans(E, P, T, F, schemas) -> dict:
    """The text phase's plans over the TPC-DS tables and the staged one
    (``text_staged``)."""
    c = E.col
    item = P.Scan("item", schemas["item"])
    flags = item.project([c("i_item_sk"), c("i_category"),
                          E.RLike(c("i_item_desc"), TEXT_P1).alias("m1"),
                          E.RLike(c("i_item_desc"), TEXT_P2, True).alias("m2")])
    sales = P.Scan("store_sales", schemas["store_sales"])
    rlike = P.HashJoin(sales, flags, (c("ss_item_sk"),), (c("i_item_sk"),), P.JoinType.INNER,
                       "right").aggregate([c("i_category")], [
        E.AggExpr("count", None, "n"),
        E.AggExpr("count", None, "n_p1", filter=c("m1")),
        E.AggExpr("sum", c("ss_net_paid"), "paid_not_p2", filter=c("m2"))]).sort(
        [E.SortOrder(c("i_category"))])
    cust = P.Scan("customer", schemas["customer"])
    regexp = cust.project([
        E.RegexpExtract(c("c_customer_id"), "^CUST(0+)([1-9])", 2).alias("x_id"),
        E.RegexpExtract(c("c_last_name"), r"([a-z]+)(\d+)", 1).alias("x_last"),
        E.RegexpReplace(c("c_customer_id"), "0+", "-").alias("r_id"),
        E.RegexpReplace(c("c_last_name"), "[aeiou]", "**").alias("r_last"),
        E.RegexpExtractAll(c("c_customer_id"), "[1-9]0*", 0, 16).alias("all_id")])
    name = E.StringFunc("concat", (c("c_first_name"), E.lit(" "), c("c_last_name")))
    digest = cust.project([
        E.StringFunc("md5", (name,)).alias("md5"), E.StringFunc("sha1", (name,)).alias("sha1"),
        *[E.StringFunc("sha2", (name, E.lit(b))).alias(f"sha2_{b}") for b in (224, 256, 384, 512)],
        E.StringFunc("crc32", (name,)).alias("crc32"), E.StringFunc("hex", (name,)).alias("hex"),
        E.StringFunc("base64", (name,)).alias("base64"),
        E.StringFunc("unbase64", (E.StringFunc("base64", (name,)),)).alias("unbase64"),
        E.StringFunc("conv", (E.Cast(c("c_customer_sk"), T.string(20)), E.lit(10),
                              E.lit(16))).alias("conv"),
        E.StringFunc("bin", (c("c_customer_sk"),)).alias("bin")])
    doc = E.StringFunc("concat", (
        E.lit('{"store":'), E.Cast(c("ss_store_sk"), T.string(20)), E.lit(',"item":'),
        E.Cast(c("ss_item_sk"), T.string(20)), E.lit(',"paid":'),
        E.Cast(c("ss_net_paid"), T.string(12)), E.lit(',"tags":["t'),
        E.Cast(E.BinaryOp("mod", c("ss_quantity"), E.lit(4)), T.string(2)), E.lit('","q'),
        E.Cast(c("ss_quantity"), T.string(11)), E.lit('"]}')))
    docs = sales.project([c("ss_store_sk"), doc.alias("doc")])
    parsed = docs.project([
        c("ss_store_sk"),
        E.Cast(F.get_json_object(c("doc"), "$.paid"), T.decimal(7, 2)).alias("paid"),
        F.get_json_object(c("doc"), "$.tags[1]").alias("tag1"),
        F.json_array_length(F.get_json_object(c("doc"), "$.tags")).alias("ntags")])
    json_plan = parsed.aggregate([c("ss_store_sk")], [
        E.AggExpr("sum", c("paid"), "paid"), E.AggExpr("count", c("tag1"), "tag1"),
        E.AggExpr("sum", c("ntags"), "ntags")]).sort([E.SortOrder(c("ss_store_sk"))])
    udf_group = item.filter(F.python_udf(_price_over_50, [c("i_current_price")], T.BOOL)).project(
        [F.python_udf(_brand_prefix, [c("i_brand")], T.string(7)).alias("bp"),
         c("i_current_price")]).aggregate(
        [c("bp")], [E.AggExpr("count", None, "n"),
                    E.AggExpr("sum", c("i_current_price"), "price")]).sort(
        [E.SortOrder(c("bp"))])
    staged = T.Schema([T.Field("url", T.string(48)), T.Field("doc", T.string(32))])
    st = T.struct(("a", T.INT64), ("b", T.string(8)))
    udf_staged = P.Scan("text_staged", staged).project([
        F.parse_url(c("url"), "HOST").alias("host"),
        F.parse_url(c("url"), "QUERY", "k").alias("k"),
        F.to_json(F.from_json(c("doc"), st)).alias("tj"),
        F.format_string("%s/%s", F.parse_url(c("url"), "HOST"),
                        F.parse_url(c("url"), "PATH")).alias("fs")])
    return {"text_rlike": rlike, "text_regexp": regexp, "text_digest": digest,
            "text_json": json_plan, "text_udf": udf_group, "text_udf_staged": udf_staged}


def fingerprint(lens, valid, blob: bytes, counts=None) -> str:
    """sha256 of a string column: its lengths (0 for a null), validity and
    the live bytes in row order (a list column's element counts first)."""
    import hashlib

    h = hashlib.sha256()
    if counts is not None:
        h.update(np.asarray(counts, np.int64).tobytes())
    h.update(np.asarray(lens, np.int64).tobytes())
    h.update(np.asarray(valid, bool).tobytes())
    h.update(blob)
    return h.hexdigest()


def fingerprint_values(values) -> str:
    """``fingerprint`` of Python values (str, bytes or None; a list of them
    for a list column)."""
    if any(isinstance(v, list) for v in values):
        counts = [len(v) if v is not None else 0 for v in values]
        flat = [x.encode() if isinstance(x, str) else x for v in values if v for x in v]
        return fingerprint([len(x) for x in flat], [True] * len(flat), b"".join(flat), counts)
    enc = [v.encode() if isinstance(v, str) else v for v in values]
    return fingerprint([len(v) if v is not None else 0 for v in enc],
                       [v is not None for v in enc], b"".join(v for v in enc if v))


def fingerprint_column(cv, live) -> str:
    """``fingerprint`` of a port string or LIST<STRING> column's ``live``
    rows, from its device buffers (no Python string a row)."""
    import torch

    cv = cv.decode() if cv.is_dict else cv
    valid = cv.validity[live]
    if cv.dtype.is_list:
        counts = torch.where(valid, cv.data[live], 0)
        el = cv.children[0]
        el = el.decode() if el.is_dict else el
        E_ = el.data.shape[1]
        exists = torch.arange(E_, device=counts.device)[None, :] < counts[:, None]
        lens = el.lengths[live][exists]
        mat = el.data[live][exists]
        keep = torch.arange(mat.shape[1], device=mat.device)[None, :] < lens[:, None]
        return fingerprint(lens.cpu().numpy(), np.ones(len(lens), bool),
                           mat[keep].cpu().numpy().tobytes(), counts.cpu().numpy())
    lens = torch.where(valid, cv.lengths[live], 0)
    mat = cv.data[live]
    keep = torch.arange(mat.shape[1], device=mat.device)[None, :] < lens[:, None]
    return fingerprint(lens.cpu().numpy(), valid.cpu().numpy(), mat[keep].cpu().numpy().tobytes())


def _exact_cents(values) -> np.ndarray:
    return np.asarray(values, dtype=np.int64)


def text_oracles(d) -> dict:
    """The text phase's oracles over the tables ``d``: Python ``re``,
    ``hashlib``, ``zlib``, ``base64``, ``json`` and ``urllib``, then numpy;
    string columns as ``fingerprint``s."""

    def rlike():
        import re as _re

        it, ss = d["item"], d["store_sales"]
        descs = it["i_item_desc"]
        m1 = np.array([v is not None and _re.search(TEXT_P1, v) is not None for v in descs])
        m2 = np.array([v is not None and _re.search(TEXT_P2, v) is None for v in descs])
        v1 = np.array([v is not None for v in descs])  # RLIKE of a null: null
        pos = np.searchsorted(it["i_item_sk"], ss["ss_item_sk"])
        pos = np.clip(pos, 0, len(it["i_item_sk"]) - 1)
        hit = it["i_item_sk"][pos] == ss["ss_item_sk"]
        if "ss_item_sk__valid" in ss:
            hit &= ss["ss_item_sk__valid"]
        cat = it["i_category"][pos[hit]]
        rows = pos[hit]
        paid = ss["ss_net_paid"][hit]
        paid_ok = ss.get("ss_net_paid__valid", np.ones(len(hit), bool))[hit]
        out = {}
        for key in sorted({c for c in cat if c is not None}) + ([None] if any(
                c is None for c in cat) else []):
            sel = np.array([c == key for c in cat]) if key is None else (cat == key)
            n1 = sel & m1[rows] & v1[rows]
            p2 = sel & m2[rows] & v1[rows] & paid_ok
            out[key] = (int(sel.sum()), int(n1.sum()), int(paid[p2].sum()) if p2.any() else None)
        return out

    def regexp():
        import re as _re

        cu = d["customer"]
        ids, lasts = cu["c_customer_id"], cu["c_last_name"]

        def ext(pat, idx, vals):
            rx = _re.compile(pat)
            out = []
            for v in vals:
                if v is None:
                    out.append(None)
                    continue
                m = rx.search(v)
                out.append("" if m is None or m.group(idx) is None else m.group(idx))
            return out

        def sub(pat, repl, vals):
            rx = _re.compile(pat)
            return [None if v is None else rx.sub(repl, v) for v in vals]

        return {"x_id": fingerprint_values(ext("^CUST(0+)([1-9])", 2, ids)),
                "x_last": fingerprint_values(ext(r"([a-z]+)(\d+)", 1, lasts)),
                "r_id": fingerprint_values(sub("0+", "-", ids)),
                "r_last": fingerprint_values(sub("[aeiou]", "**", lasts)),
                "all_id": fingerprint_values([None if v is None else _re.findall("[1-9]0*", v)
                                              for v in ids])}

    def digest():
        import base64 as _b64
        import hashlib
        import zlib

        cu = d["customer"]
        names = [None if f is None or last is None else (f + " " + last).encode()
                 for f, last in zip(cu["c_first_name"], cu["c_last_name"])]
        fns = {"md5": lambda b: hashlib.md5(b).hexdigest(),
               "sha1": lambda b: hashlib.sha1(b).hexdigest(),
               "sha2_224": lambda b: hashlib.sha224(b).hexdigest(),
               "sha2_256": lambda b: hashlib.sha256(b).hexdigest(),
               "sha2_384": lambda b: hashlib.sha384(b).hexdigest(),
               "sha2_512": lambda b: hashlib.sha512(b).hexdigest(),
               "hex": lambda b: b.hex().upper(), "base64": _b64.b64encode,
               "unbase64": lambda b: b}
        out = {k: fingerprint_values([None if b is None else fn(b) for b in names])
               for k, fn in fns.items()}
        out["crc32"] = np.array([zlib.crc32(b) if b is not None else -1 for b in names])
        sk = cu["c_customer_sk"]
        out["conv"] = fingerprint_values([format(int(v), "X") for v in sk])
        out["bin"] = fingerprint_values([format(int(v), "b") for v in sk])
        return out

    def json_sums():
        ss = d["store_sales"]
        ok = np.ones(len(ss["ss_store_sk"]), bool)
        for col in ("ss_store_sk", "ss_item_sk", "ss_net_paid", "ss_quantity"):
            ok &= ss.get(col + "__valid", np.ones_like(ok))
        stores = ss["ss_store_sk"]
        valid_store = ss.get("ss_store_sk__valid", np.ones_like(ok))
        out = {}
        for key in np.unique(stores[valid_store]):
            sel = ok & valid_store & (stores == key)
            n = int(sel.sum())
            out[int(key)] = (int(ss["ss_net_paid"][sel].sum()) if n else None, n,
                             2 * n if n else None)
        nulls = ok & ~valid_store  # a null store: a null document
        if (~valid_store).any():
            out[None] = (None, 0, None)
        assert not nulls.any()
        return out

    def udf():
        import json as _json
        from urllib.parse import parse_qs, urlparse

        it = d["item"]
        price, ok = it["i_current_price"], it.get("i_current_price__valid",
                                                    np.ones(len(it["i_current_price"]), bool))
        groups = {}
        for b, p, v in zip(it["i_brand"], price, ok):
            if not v or p < 5000:
                continue
            key = _brand_prefix(b)
            n, s = groups.get(key, (0, 0))
            groups[key] = (n + 1, s + int(p))
        st = text_staged_table()
        hosts, ks, tjs, fss = [], [], [], []
        for u, doc in zip(st["url"], st["doc"]):
            pu = urlparse(u) if u is not None else None
            hosts.append(pu.hostname if pu else None)
            ks.append((parse_qs(pu.query).get("k") or [None])[0] if pu else None)
            fss.append(f"{pu.hostname}/{pu.path}" if pu else None)
            try:
                j = _json.loads(doc)
                tjs.append(_json.dumps({"a": int(j["a"]), "b": str(j["b"])},
                                       separators=(",", ":")))
            except ValueError:
                tjs.append(None)
        return {"groups": groups, "host": fingerprint_values(hosts),
                "k": fingerprint_values(ks), "tj": fingerprint_values(tjs),
                "fs": fingerprint_values(fss)}

    return {"text_rlike": rlike, "text_regexp": regexp, "text_digest": digest,
            "text_json": json_sums, "text_udf": udf}


def _rows_by_key(out, key, cols):
    """A collected answer's rows as {key: tuple of cols} (None for a null)."""
    res = {}
    for i in range(len(out[key])):
        k = out[key][i] if out[key + "__valid"][i] else None
        k = k.item() if hasattr(k, "item") else k
        res[k] = tuple((out[c][i].item() if hasattr(out[c][i], "item") else out[c][i])
                       if out[c + "__valid"][i] else None for c in cols)
    return res


def check_text(name: str, b, expect) -> dict:
    """Hold one text plan's result batch to its oracle; what the line
    reports of it. Row-shaped results compare by ``fingerprint`` on their
    device buffers, grouped ones as collected rows."""
    import torch

    from datafusion_comet_tpu_torch.exec.batch import to_numpy

    keys = {"text_rlike": ("i_category", ("n", "n_p1", "paid_not_p2")),
            "text_json": ("ss_store_sk", ("paid", "tag1", "ntags")),
            "text_udf": ("bp", ("n", "price"))}
    if name in keys:
        got = _rows_by_key(to_numpy(b), *keys[name])
        want = expect["groups"] if name == "text_udf" else expect
        ok = got == want
        info = {"groups": len(got)}
        if name == "text_rlike":
            info["matched_p1"] = sum(v[1] for v in got.values())
        elif name == "text_json":
            info["docs"] = sum(v[1] for v in got.values())
    else:
        live = b.row_mask.nonzero().squeeze(1)
        ok, info = True, {}
        for f, cv in zip(b.schema.fields, b.columns):
            if f.dtype.is_binary or f.dtype.is_list:
                good = fingerprint_column(cv, live) == expect[f.name]
            else:  # crc32: its int64 values, -1 for a null
                vals = torch.where(cv.validity, cv.data, -1)[live].cpu().numpy()
                good = np.array_equal(vals, expect[f.name])
            if not good:
                info.setdefault("wrong", []).append(f.name)
            ok &= good
    if not ok:
        raise AssertionError(f"{name}: differs from its oracle ({info})")
    return info


def run_text(sess, plan, reps: int):
    """``run_query`` on ``Session.execute``: the result stays on the card
    (a collect of a million rows of strings would time the host's
    conversion). (result batch, launches, first-run s, warm ms, peak
    bytes)."""
    import torch
    from datafusion_comet_tpu_torch.exec import kernels as K

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _zero_counts(K)
    t0 = time.perf_counter()
    out = sess.execute(plan)
    torch.cuda.synchronize()
    first_s = time.perf_counter() - t0
    launches = _counts(K)
    peak = torch.cuda.max_memory_allocated()
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        sess.execute(plan)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return out, launches, first_s, times, peak


TEXT_DIGEST_PROFILED = ("md5", "sha1", "sha2_256", "sha2_512")
TEXT_PROFILE_ROWS = 1 << 16  # the kernel count does not depend on the rows


def digest_launches(sess, reps: int) -> dict:
    """Each digest and bytes function alone over customer's name strings:
    warm ms (CUDA events) and, for ``TEXT_DIGEST_PROFILED``, the device
    kernels of one call (torch.profiler, over the first
    ``TEXT_PROFILE_ROWS`` rows)."""
    import torch

    from datafusion_comet_tpu_torch import types as T
    from datafusion_comet_tpu_torch.exec.evaluator import evaluate
    from datafusion_comet_tpu_torch.ir import expr as E
    from datafusion_comet_tpu_torch.models import tpcds
    from datafusion_comet_tpu_torch.observability.profile import device_profile

    cust = sess.tables["customer"]
    schema = tpcds.SCHEMAS["customer"]
    name = E.bind(E.StringFunc("concat", (E.col("c_first_name"), E.lit(" "),
                                          E.col("c_last_name"))), schema)
    names = evaluate(name, cust)
    sch = T.Schema([T.Field("s", name.dtype)])
    b = type(cust)((names,), cust.row_mask, sch)
    out = {}
    for f, args in (("md5", ()), ("sha1", ()), ("sha2", (256,)), ("sha2", (512,)), ("crc32", ()),
                    ("hex", ()), ("base64", ()), ("conv", None)):
        if f == "conv":
            e = E.StringFunc("conv", (E.col("s"), E.lit(36), E.lit(16)))
        else:
            e = E.StringFunc(f, (E.col("s"),) + tuple(E.lit(a) for a in args))
        be = E.bind(e, sch)
        evaluate(be, b)
        times = []
        for _ in range(reps):
            start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
            start.record()
            evaluate(be, b)
            end.record()
            end.synchronize()
            times.append(start.elapsed_time(end))
        key = f + "".join(f"_{a}" for a in (args or ()))
        out[key] = {"ms": statistics.median(times)}
        if key in TEXT_DIGEST_PROFILED:
            rows = torch.arange(min(TEXT_PROFILE_ROWS, b.capacity), device=b.device)
            few = type(b)(tuple(c.take(rows) for c in b.columns), b.row_mask[rows], sch)
            out[key]["kernels"] = device_profile(lambda: evaluate(be, few))["device_events"]
    return out


# the TPC-DS plans Session.validate runs on the card (every one on the
# CPU): each tenth (121 plans took 9-17 s there, 42 took 8.3-8.8 s: a
# few hundred tiny launches and host reads a plan)
TEXT_VALIDATE_CARD_DS = 10


def text_validate() -> dict:
    """Session.validate over the 22 TPC-H and 99 TPC-DS plans on the CPU and
    over TPC-H's and every ``TEXT_VALIDATE_CARD_DS``-th TPC-DS plan on the
    card, each over its package's tables with no rows: every result [], TPC-H
    Q3 with the HashJoin gate off the JAX package's reason, the card's
    results equal to the CPU's."""
    from datafusion_comet_tpu_torch.conf import Config
    from datafusion_comet_tpu_torch.exec.batch import from_numpy
    from datafusion_comet_tpu_torch.exec.engine import Session
    from datafusion_comet_tpu_torch.models import tpcds, tpch

    key = "comet.exec.operator.HashJoin.enabled"
    results, ms = {}, {}
    for dev in ("cuda", "cpu"):
        t0 = time.perf_counter()
        res = []
        for schemas, plans, conf in ((tpch.SCHEMAS, None, None), (tpcds.SCHEMAS, None, None),
                                     (tpch.SCHEMAS, "q3", Config(gates={key: False}))):
            s = Session(device=dev, conf=conf)
            for t, sch in schemas.items():
                empty = {f.name: np.array([], dtype=object if f.dtype.is_binary
                                          else f.dtype.np_dtype()) for f in sch.fields}
                s.register_batch(t, from_numpy(empty, sch, s.device))
            if plans == "q3":
                res.append(("q3_gate", s.validate(tpch.q3())))
            elif schemas is tpch.SCHEMAS:
                res += [(f"h_{q}", s.validate(b())) for q, b in tpch.QUERIES.items()]
            else:
                step = TEXT_VALIDATE_CARD_DS if dev == "cuda" else 1
                res += [(f"ds_{q}", s.validate(tpcds.plan(q, s)))
                        for q in list(tpcds.QUERIES)[::step]]
        results[dev], ms[dev] = dict(res), (time.perf_counter() - t0) * 1e3
    want = {q: [] for q in results["cpu"]}
    want["q3_gate"] = [f"operator HashJoin disabled by {key}"]
    card = results["cuda"]
    if results["cpu"] != want or card != {q: results["cpu"][q] for q in card}:
        bad = [(q, r) for q, r in list(results["cpu"].items()) + list(card.items())
               if r != want[q]]
        raise AssertionError(f"validate: {bad[:4]}, or the card's results differ from the CPU's")
    return {"phase": "text_validate", "cpu_plans": len(results["cpu"]) - 1,
            "card_plans": len(card) - 1, "card_ms": ms["cuda"], "cpu_ms": ms["cpu"],
            "equal_to_cpu": True, "q3_gate": card["q3_gate"]}


def text_phase(sess, data, ds_sf: float, reps: int, launches, total) -> None:
    """The text phase (``text_plans``) on the TPC-DS session, each plan
    against its oracle (the TPC-DS oracle worker's ``text_oracles``): warm
    ms, peak GB, rows and B1/B2/B3 launches a plan; then the digests'
    kernels and ms alone (``digest_launches``) and Session.validate
    (``text_validate``); the phase's seconds, oracles included."""
    from datafusion_comet_tpu_torch import types as T
    from datafusion_comet_tpu_torch.exec.regex_dfa import _byte_classes, compile_dfa
    from datafusion_comet_tpu_torch.ir import expr as E
    from datafusion_comet_tpu_torch.ir import functions as F
    from datafusion_comet_tpu_torch.ir import plan as P
    from datafusion_comet_tpu_torch.models import tpcds

    t_phase = time.perf_counter()
    for pat, small in ((TEXT_P1, True), (TEXT_P2, False)):
        trans, _ = compile_dfa(pat)
        if (trans.shape[0] <= 64 and _byte_classes(trans)[2] <= 24) != small:
            raise AssertionError(f"{pat!r} is on the wrong side of the select-tree thresholds")
    st = text_staged_table()
    sess.register_numpy("text_staged", st, T.Schema([T.Field("url", T.string(48)),
                                                     T.Field("doc", T.string(32))]))
    plans = text_plans(E, P, T, F, tpcds.SCHEMAS)
    oracle_wait = 0.0
    for name, plan in plans.items():
        # one warm run of the host bridges' plans (a Python call a row) and
        # of the JSON documents over store_sales (seconds each)
        out, launches[name], first_s, times, peak = run_text(
            sess, plan, 1 if name.startswith("text_udf") or name == "text_json" else reps)
        for k in total:
            total[k] += launches[name][k]
        key = "text_udf" if name == "text_udf_staged" else name
        t0 = time.perf_counter()
        expect = memo_oracle(("tpcds", key, ds_sf), text_oracles(data)[key])
        oracle_wait += time.perf_counter() - t0
        info = check_text("text_regexp" if name == "text_udf_staged" else name, out, expect)
        emit({"phase": name, "sf": ds_sf, "correct": True, "first_run_s": first_s,
              "warm_ms": statistics.median(times), "peak_gb": peak / 1e9,
              "rows": int(out.num_rows()), "launches": launches[name], **info})
        del out
    emit({"phase": "text_digest_kernels", "rows": sess.tables["customer"].capacity,
          "functions": digest_launches(sess, reps)})
    emit(text_validate())
    sess.tables.pop("text_staged", None)
    emit({"phase": "text", "sf": ds_sf, "phase_s": time.perf_counter() - t_phase,
          "oracle_wait_s": oracle_wait})


EXPLAIN_SF = 0.1  # TPC-H Q3's Session.explain, on the card and on the CPU


def explain_phase() -> None:
    """Session.explain(tpch.q3(), with_metrics=True, as_tree=True) at TPC-H
    SF 0.1 on the card equals the same call on the CPU, operator by
    operator (op, detail, live rows, capacity, bytes); prints the card's
    rendering."""
    from datafusion_comet_tpu_torch.exec.engine import Session
    from datafusion_comet_tpu_torch.models import tpch

    names = ("lineitem", "orders", "customer")
    data = tpch.generate_tables(names, EXPLAIN_SF)
    trees = {}
    for dev in ("cuda", "cpu"):
        s = Session(device=dev)
        for t in names:
            s.register_numpy(t, data[t], tpch.SCHEMAS[t])
        trees[dev] = s.explain(tpch.q3(), with_metrics=True, as_tree=True)

    def flat(node, out):
        out.append((node.op, node.detail, node.output_rows, node.capacity, node.output_bytes))
        for c in node.children:
            flat(c, out)
        return out

    card, cpu = flat(trees["cuda"], []), flat(trees["cpu"], [])
    if card != cpu:
        raise AssertionError(f"explain: the card's tree {card} differs from the CPU's {cpu}")
    emit({"phase": "explain", "sf": EXPLAIN_SF, "operators": len(card), "equal_to_cpu": True,
          "render": trees["cuda"].render().splitlines()})


def device_memory(sess) -> int:
    import torch

    return torch.cuda.get_device_properties(sess.device).total_memory


def q90_scalar_phase(sess, data, ds_sf, reps, launches, total) -> None:
    """TPC-DS q90 in its scalar-subquery form: two subqueries an execute,
    its one DOUBLE equal to the numpy oracle's bit for bit."""
    from datafusion_comet_tpu_torch.models import tpcds

    key = "ds_q90_scalar"
    out, launches[key], first_s, times, peak, _, _, plan_ms = run_query(
        sess, tpcds.q90_scalar(sess), reps, log_b3=False)
    got, want = out_rows(out, ("am_pm_ratio",)), tpcds_oracle("q90_scalar", data, ds_sf)
    rec = subquery_record(sess)
    if got != want or rec["subquery_runs"] != 2:
        raise AssertionError(f"{key}: {got} ({rec['subquery_runs']} subquery runs), "
                             f"expected {want} (2)")
    for k in total:
        total[k] += launches[key][k]
    emit({"phase": "tpcds_q90_scalar", "sf": ds_sf, "correct": True, "result": got[0][0],
          "first_run_s": first_s, "warm_ms": statistics.median(times), "peak_gb": peak / 1e9,
          "launches": launches[key], "plan_ms": plan_ms, **run_record(sess), **rec})


def bloom_phase(sess, data, ds_sf, reps, launches, total) -> None:
    """Spark's runtime bloom filter at Spark's default size (``BLOOM_BITS``,
    ``BLOOM_ITEMS``: k = 6): a scalar subquery builds BLOOM_FILTER(i_item_sk)
    over the Books items of managers 1-50 (about 5% of the items), and
    store_sales filtered by BloomMightContain(subquery, ss_item_sk) is
    aggregated (COUNT(*), SUM(ss_quantity), SUM(ss_ext_sales_price)). Held
    to the numpy oracle: the filter's bytes exactly, no false negative (every
    filtered item passes its own probe), and the aggregate over the rows the
    oracle's probe keeps, exactly. Warm ms of the filter's build alone, of
    the probe and aggregate with the filter as a literal, and of the whole
    query (the subquery runs in every execute)."""
    from datafusion_comet_tpu_torch import types as T
    from datafusion_comet_tpu_torch.ir import expr as E
    from datafusion_comet_tpu_torch.ir import plan as P
    from datafusion_comet_tpu_torch.models import tpcds

    it, ss = data["item"], data["store_sales"]
    pick = (it["i_category"] == "Books") & (it["i_manager_id"] <= 50)
    items = P.Scan("item", tpcds.SCHEMAS["item"]).filter(
        (E.col("i_category") == E.lit("Books")) & (E.col("i_manager_id") <= E.lit(50)))
    build = items.aggregate([], [E.AggExpr("bloom_filter", E.col("i_item_sk"), "f",
                                           num_bits=BLOOM_BITS, extra=(E.lit(BLOOM_ITEMS),))])
    sub = sess.scalar_subquery(build)

    def probe(flt):
        return P.Scan("store_sales", tpcds.SCHEMAS["store_sales"]).filter(
            E.BloomMightContain(flt, E.col("ss_item_sk"))).aggregate([], [
                E.AggExpr("count", None, "n"), E.AggExpr("sum", E.col("ss_quantity"), "qty"),
                E.AggExpr("sum", E.col("ss_ext_sales_price"), "sales")])

    want_bytes = bloom_oracle(it["i_item_sk"][pick], 6, BLOOM_BITS)
    rec = {"phase": "bloom", "sf": ds_sf, "num_bits": BLOOM_BITS, "expected_items": BLOOM_ITEMS,
           "k": 6, "build_items": int(pick.sum()), "items": len(pick)}
    for name, plan in (("build", build), ("probe", probe(E.lit(want_bytes,
                                                                 T.binary(len(want_bytes))))),
                       ("query", probe(sub))):
        key = f"ds_bloom_{name}"
        out, launches[key], first_s, times, peak, _, _, _ = run_query(sess, plan, reps,
                                                                      log_b3=False)
        for k in total:
            total[k] += launches[key][k]
        rec[name] = {"warm_ms": statistics.median(times), "first_run_s": first_s,
                     "peak_gb": peak / 1e9, "launches": launches[key]}
        if name == "build" and out["f"][0] != want_bytes:
            raise AssertionError("bloom: the filter's bytes are not the oracle's")
        if name == "query":
            rec["query"].update(subquery_record(sess))
            if sess.subqueries[0]["value"] != want_bytes:
                raise AssertionError("bloom: the subquery's filter is not the oracle's")
        if name != "build":
            hit_by_key = bloom_probe_oracle(want_bytes, np.arange(len(pick) + 1, dtype=np.int64))
            kept = hit_by_key[ss["ss_item_sk"]]
            want = [(int(kept.sum()), int(ss["ss_quantity"][kept].sum()),
                     int(ss["ss_ext_sales_price"][kept].sum()))]
            got = out_rows(out, ("n", "qty", "sales"))
            if got != want:
                raise AssertionError(f"bloom {name}: {got}, expected {want}")
            rec["rows_kept"] = want[0][0]
    # no false negative: every item the filter was built from passes its probe
    own = items.filter(E.BloomMightContain(sub, E.col("i_item_sk"))).aggregate(
        [], [E.AggExpr("count", None, "n")])
    n_own = int(sess.collect(own)["n"][0])
    if n_own != int(pick.sum()):
        raise AssertionError(f"bloom: {n_own} of the {int(pick.sum())} items pass their filter")
    rec["false_negatives"] = 0
    rec["store_sales_rows"] = len(ss["ss_item_sk"])
    emit(rec)


def tpcds_against_cpu(sf: float):
    """Every ported query at ``sf`` on the card and through the port on the
    CPU, the same answer (``same_rows``; ``TPCDS_TIED_ORDER``'s as
    multisets): the number of queries and of answer rows compared, and the
    CPU's seconds."""
    import torch
    from datafusion_comet_tpu_torch.exec.engine import Session
    from datafusion_comet_tpu_torch.models import tpcds

    card, cpu = Session(), Session(device="cpu")
    data, _, _ = tpcds_tables(card, sf)
    for t, d in data.items():
        cpu.register_numpy(t, d, tpcds.SCHEMAS[t])
    rows, cpu_s = 0, 0.0
    for q in tpcds.QUERIES:
        got = card.collect(tpcds.plan(q, card))
        t0 = time.perf_counter()
        want = cpu.collect(tpcds.plan(q, cpu))
        cpu_s += time.perf_counter() - t0
        if not same_rows(want, got, ordered=q not in TPCDS_TIED_ORDER):
            raise AssertionError(f"tpcds {q} at SF{sf:g}: the card's answer is not the CPU's")
        rows += len(next(iter(got.values())))
    del card
    torch.cuda.empty_cache()
    return {"sf": sf, "queries": len(tpcds.QUERIES), "rows": rows, "cpu_s": cpu_s}


def grace_session(sess, fraction: float):
    """A session over the same device tables and statistics whose memory
    budget is ``fraction`` of the card, from tools/query_times.py."""
    from datafusion_comet_tpu_torch.tools import query_times as QT

    return QT.grace_session(sess, fraction)


def q3_phase(sess, data, sf: float, reps: int, profile: bool, launches, b3_calls) -> None:
    """Q3 directly and under a budget that makes the engine split its top
    join into K = 16 pairs, each running the whole aggregate stage (local
    mode): checked against the numpy oracle, timed, its launches counted."""
    from datafusion_comet_tpu_torch.exec.memory import plan_peak_bytes
    from datafusion_comet_tpu_torch.models import tpch

    expect = tpch_oracle("q3", data, sf)
    fraction, jpeak = grace_fraction(sess, tpch.q3())
    grace = grace_session(sess, fraction)
    runs = {}
    for run, s in (("direct", sess), ("grace", grace)):
        key = f"q3_{run}"
        out, launches[key], first_s, times, peak, b3_calls[key], _, plan_ms = run_query(
            s, tpch.q3(), reps)
        check_q3(out, expect, key)
        # the grace run partitions with B3; the direct run's joins are
        # unique builds, which need no compaction, and its aggregate is the
        # sorted one: no kernel of the port
        if run == "grace" and launches[key]["partition_sort"] == 0:
            raise AssertionError(f"{key} did not launch B3: {launches[key]}")
        agg_stage = s.stages[0][1]
        runs[run] = {
            "first_run_s": first_s, "warm_ms": statistics.median(times), "warm_ms_all": times,
            "peak_mem_bytes": peak, "launches": launches[key],
            "stages": [[n, type(p).__name__] for n, p in s.stages],
            "max_groups": agg_stage.max_groups,
            "stage_peak_estimate_bytes": plan_peak_bytes(
                agg_stage, max(s.tables[t].capacity for t in TABLES)),
            "partitioned": bool(s.grace_runners),
            "b3_call_n": [c["n"] for c in b3_calls[key]],
            "b3_calls": b3_call_shapes(b3_calls[key]), **plan_record(s, plan_ms),
            **run_record(s)}
        check_rf("q3", sf, run, runs[run])
    if len(grace.grace_runners) != 1:
        raise AssertionError(f"q3 grace: {len(grace.grace_runners)} grace joins, expected 1")
    r = grace.grace_runners[0]
    if r.K != GRACE_K or r.downstream[0] != "local":
        raise AssertionError(f"q3 grace: K={r.K} mode={r.downstream and r.downstream[0]}, "
                             f"expected K={GRACE_K} local")
    sizes = {side: {"capacity": int(cap), "rows": int(sz.sum()), "min": int(sz.min()),
                    "max": int(sz.max()), "sizes": sz.tolist()}
             for side, cap, sz in zip(("lineitem", "orders_customer"), r.capacities, r.sizes)}
    emit({"phase": "q3", "sf": sf, "correct": True, "result": expect[0], "groups": expect[1],
          "budget_bytes": sess.budget_bytes(), "memory_fraction": fraction,
          "grace_budget_bytes": grace.budget_bytes(), "join_peak_estimate_bytes": jpeak,
          "K": r.K, "mode": r.downstream[0], "pair_retries": r.retries, "partitions": sizes,
          **runs})
    profile_tpch(profile, sess, tpch.q3(), "profile_q3_direct")
    profile_tpch(profile, grace, tpch.q3(), "profile_q3_grace")


def semi_compact_plan(day: int):
    """``lineitem`` LEFT_SEMI the orders of one day, counted by return flag:
    the join's row estimate is far below the lineitem's capacity, so the
    engine compacts the semi output (the >= 8x rule), one B3 call."""
    from datafusion_comet_tpu_torch import types as T
    from datafusion_comet_tpu_torch.ir import expr as E
    from datafusion_comet_tpu_torch.ir import plan as P
    from datafusion_comet_tpu_torch.models import tpch

    o = P.Scan("orders", tpch.SCHEMAS["orders"]).filter(
        E.col("o_orderdate") == E.lit(day, T.DATE))
    j = P.HashJoin(P.Scan("lineitem", tpch.SCHEMAS["lineitem"]), o, (E.col("l_orderkey"),),
                   (E.col("o_orderkey"),), P.JoinType.LEFT_SEMI, "right")
    return j.aggregate([E.col("l_returnflag")], [E.AggExpr("count", None, "n")]).sort(
        [E.SortOrder(E.col("l_returnflag"))])


def _query_run(s, key, first_s, times, peak, launches, b3_calls, semi, plan_ms):
    """The fields of one run in a query line: as Q3's, plus the semi-like
    joins of the counted run by membership path."""
    return {"first_run_s": first_s, "warm_ms": statistics.median(times), "warm_ms_all": times,
            "peak_mem_bytes": peak, "launches": launches[key],
            "stages": [[n, type(p).__name__] for n, p in s.stages],
            "partitioned": bool(s.grace_runners), "semi_paths": semi,
            "b3_call_n": [c["n"] for c in b3_calls[key]],
            "b3_calls": b3_call_shapes(b3_calls[key]), **plan_record(s, plan_ms),
            **run_record(s)}


def plan_record(s, plan_ms):
    """The runtime filters of a session's last run (key table, keys, range,
    row estimate each) and ``_plan_stages``' host ms."""
    from datafusion_comet_tpu_torch.exec.runtime_filter import injected_filters

    return {"runtime_filters": injected_filters(s), "plan_ms": plan_ms}


def q4_phase(sess, data, sf: float, reps: int, profile: bool, launches, b3_calls) -> None:
    """Q4 (``orders`` LEFT_SEMI ``lineitem``, COUNT(*) per priority on the
    dense path) directly and under a budget that makes the engine split the
    semi join into K = 16 pairs (partial mode: each pair a PARTIAL
    aggregate, one FINAL), then a semi join whose output the engine
    compacts: each checked against a numpy oracle, timed, its launches
    counted, and the membership path of its semi joins reported (the bitmap
    where the build key's span is at most 2^24: o_orderkey spans 6M at SF1,
    60M at SF10)."""
    from datafusion_comet_tpu_torch.models import tpch

    li, od = data["lineitem"], data["orders"]
    expect = tpch_oracle("q4", data, sf)
    fraction, jpeak = grace_fraction(sess, tpch.q4())
    grace = grace_session(sess, fraction)
    runs = {}
    for run, s, key in (("direct", sess, "q4"), ("grace", grace, "q4_grace")):
        out, launches[key], first_s, times, peak, b3_calls[key], semi, plan_ms = run_query(
            s, tpch.q4(), reps)
        check_q4(out, expect, key)
        need = ("bucket_count",) + (("partition_sort",) if run == "grace" else ())
        if min(launches[key][k] for k in need) == 0:
            raise AssertionError(f"{key} did not launch {need}: {launches[key]}")
        if sum(semi.values()) == 0:
            raise AssertionError(f"{key} ran no semi join: {semi}")
        runs[run] = _query_run(s, key, first_s, times, peak, launches, b3_calls, semi, plan_ms)
        runs[run]["max_groups"] = [a.max_groups for a in _plan_nodes(s.stages, "HashAggregate")]
        runs[run]["joins"] = [[j.join_type, j.build_key_range, j.out_rows_hint]
                              for j in _plan_nodes(s.stages, "HashJoin")]
    if len(grace.grace_runners) != 1 or sess.grace_runners:
        raise AssertionError("q4: the grace run did not partition, or the direct run did")
    r = grace.grace_runners[0]
    if r.K != GRACE_K or r.downstream[0] != "partial":
        raise AssertionError(f"q4 grace: K={r.K} mode={r.downstream and r.downstream[0]}, "
                             f"expected K={GRACE_K} partial")
    sizes = {side: {"capacity": int(cap), "rows": int(sz.sum()), "min": int(sz.min()),
                    "max": int(sz.max()), "sizes": sz.tolist()}
             for side, cap, sz in zip(("orders", "lineitem"), r.capacities, r.sizes)}
    # the semi-output compaction, on the orders of the busiest day
    day = int(np.bincount(od["o_orderdate"]).argmax())
    keep = np.isin(li["l_orderkey"], od["o_orderkey"][od["o_orderdate"] == day])
    flags = li["l_returnflag"][keep]
    want = [(f, int((flags == f).sum())) for f in sorted(set(flags.tolist()))]
    key = "q4_semi_compact"
    out, launches[key], first_s, times, peak, b3_calls[key], semi, plan_ms = run_query(
        sess, semi_compact_plan(day), reps)
    got = [(out["l_returnflag"][i], int(out["n"][i])) for i in range(len(out["n"]))]
    if got != want or not out["n__valid"].all():
        raise AssertionError(f"{key}: got {got}, expected {want}")
    if not any(c["codes"] == "bool" for c in b3_calls[key]):
        raise AssertionError(f"{key}: the semi output was not compacted")
    runs["semi_compact"] = dict(_query_run(sess, key, first_s, times, peak, launches, b3_calls,
                                           semi, plan_ms), day=day, result=want)
    emit({"phase": "q4", "sf": sf, "correct": True, "result": expect,
          "memory_fraction": fraction, "grace_budget_bytes": grace.budget_bytes(),
          "join_peak_estimate_bytes": jpeak, "K": r.K, "mode": r.downstream[0],
          "pair_retries": r.retries, "partitions": sizes, **runs})
    profile_tpch(profile, sess, tpch.q4(), "profile_q4_direct")
    profile_tpch(profile, grace, tpch.q4(), "profile_q4_grace")


def q15_phase(sess, data, sf: float, reps: int, profile: bool, launches, b3_calls) -> None:
    """Q15 (per-supplier revenue, its ungrouped MAX, a LEFT_SEMI join on the
    decimal revenue, an INNER join with ``supplier``, a sort): checked
    against the numpy oracle, timed, its launches counted."""
    from datafusion_comet_tpu_torch.models import tpch

    expect = tpch_oracle("q15", data, sf)
    out, launches["q15"], first_s, times, peak, b3_calls["q15"], semi, plan_ms = run_query(
        sess, tpch.q15(), reps)
    check_q15(out, expect, "q15")
    # the MAX's presence on B1 (B3 shrinks the stage boundary where the
    # join's output is four times its live rows: SF1 and up)
    if launches["q15"]["bucket_count"] == 0:
        raise AssertionError(f"q15 did not launch B1: {launches['q15']}")
    if semi["sorted"] == 0:
        raise AssertionError(f"q15 ran no semi join on the sorted path: {semi}")
    run = _query_run(sess, "q15", first_s, times, peak, launches, b3_calls, semi, plan_ms)
    top = sess.stages[0][1]  # stage 0: supplier INNER JOIN (revenue LEFT_SEMI max)
    # the semi join's two key sides, each run alone: limbs of their storage
    semi_join = top.right
    emit({"phase": "q15", "sf": sf, "correct": True, "result": expect,
          "key_storage_limbs": [sess.execute(side).columns[-1].data.dim()
                                for side in (semi_join.left, semi_join.right)],
          **run})
    profile_tpch(profile, sess, tpch.q15(), "profile_q15")


def q5_phase(sess, data, sf: float, reps: int, profile: bool, launches, b3_calls) -> None:
    """Q5 (five INNER joins over six tables, one on two packed keys, revenue
    per nation on the dense path) directly and under a budget that makes
    the engine split its first join (lineitem, orders, customer) into K =
    16 pairs: each checked against the numpy oracle, timed, its launches
    counted (B1 and B2 for the aggregate in both runs; B3 partitions in the
    grace run, and in the direct run shrinks the first stage's output where
    that is four times its live rows, at SF1 but not at SF10), its joins'
    hints and retries reported."""
    from datafusion_comet_tpu_torch.models import tpch

    expect = tpch_oracle("q5", data, sf)
    fraction, jpeak = grace_fraction(sess, tpch.q5())
    grace = grace_session(sess, fraction)
    runs = {}
    for run, s, key in (("direct", sess, "q5_direct"), ("grace", grace, "q5_grace")):
        out, launches[key], first_s, times, peak, b3_calls[key], semi, plan_ms = run_query(
            s, tpch.q5(), reps)
        check_q5(out, expect, key)
        need = ("bucket_count", "bucket_sum") + (("partition_sort",) if run == "grace" else ())
        if min(launches[key][k] for k in need) == 0:
            raise AssertionError(f"{key} did not launch {need}: {launches[key]}")
        runs[run] = _query_run(s, key, first_s, times, peak, launches, b3_calls, semi, plan_ms)
        check_rf("q5", sf, run, runs[run])
        runs[run]["grace_runners"] = [
            {"K": r.K, "mode": r.downstream and r.downstream[0], "pair_retries": r.retries,
             "capacities": list(r.capacities),
             "sizes": [{"rows": int(sz.sum()), "min": int(sz.min()), "max": int(sz.max())}
                       for sz in r.sizes]} for r in s.grace_runners]
    if sess.grace_runners or not any(r.K == GRACE_K for r in grace.grace_runners):
        raise AssertionError(f"q5: the direct run partitioned, or no grace join of K={GRACE_K}: "
                             f"{runs['grace']['grace_runners']}")
    emit({"phase": "q5", "sf": sf, "correct": True, "result": expect,
          "memory_fraction": fraction, "grace_budget_bytes": grace.budget_bytes(),
          "join_peak_estimate_bytes": jpeak, **runs})
    profile_tpch(profile, sess, tpch.q5(), "profile_q5_direct")
    profile_tpch(profile, grace, tpch.q5(), "profile_q5_grace")


def _grace_record(s):
    """Each grace join of a session's last run (in the order they finished),
    each tiled aggregate (table, tiles) and each attempt of a tiled
    aggregate (growth scale, whether it overflowed and ran again)."""
    return {"grace_runners": [
        {"K": r.K, "mode": r.downstream and r.downstream[0], "pair_retries": r.retries,
         "capacities": list(r.capacities),
         "sizes": [{"rows": int(sz.sum()), "min": int(sz.min()), "max": int(sz.max()),
                    "mean": float(sz.mean())} for sz in r.sizes]} for r in s.grace_runners],
        "tiled": [list(t) for t in s.tiled],
        "tiled_attempts": [[r["scale"], r["overflowed"]] for r in s.runs
                           if r["where"] == "tiled"]}


def agg_sort_limbs(sess, plan, key: Optional[str] = None) -> dict:
    """The sort limbs the root stage's grouping aggregate (with ``key``: the
    grouping aggregate, in any stage, that groups by ``key``) takes, rebuilt
    as ``aggregate.hash_aggregate`` picks them (one packed int32 limb, packed
    int64 limbs, or a null flag and the value limbs per key) from its key
    columns as the query's output holds them (the storage of its input):
    {"keys", "limbs", "limb_dtypes"}."""
    from datafusion_comet_tpu_torch.exec import sortkeys
    from datafusion_comet_tpu_torch.exec.operators import aggregate as AGG

    (agg,) = [a for a in _plan_nodes(sess.stages if key else sess.stages[-1:], "HashAggregate")
              if a.group_exprs and (key is None or key in [g.name for g in a.group_exprs])]
    out = sess.execute(plan)
    keys = [out.columns[out.schema.index_of(g.name)] for g in agg.group_exprs]
    packed = AGG._try_pack_keys(keys)
    limbs = ([packed[0]] if packed is not None
             else AGG._pack_sort_limbs(keys, agg.group_key_ranges)
             or sortkeys.grouping_limbs(keys))
    return {"keys": [g.name for g in agg.group_exprs], "limbs": len(limbs),
            "limb_dtypes": sorted({str(x.dtype) for x in limbs})}


def q10_q18_phase(q: str, sess, data, sf: float, reps: int, profile: bool, launches,
                  b3_calls) -> None:
    """Q10 (three INNER joins, grouped by c_custkey, c_name, c_acctbal and
    n_name, a top-20) or Q18 (a HAVING filter over the per-order sums, a
    LEFT_SEMI join against it, two INNER joins, a five-key aggregate with
    c_name, a top-100) directly and under a budget that makes the engine
    split its first join into K = 16 pairs (Q18's per-order aggregate then
    runs tiled first): each checked against its numpy oracle, timed, its
    launches counted (B3 partitions in the grace run), its stages, hints,
    attempts, grace joins and tiled aggregates, and the sort limbs of its
    grouping aggregate reported."""
    from datafusion_comet_tpu_torch.models import tpch

    li, od, cu = data["lineitem"], data["orders"], data["customer"]
    if q == "q10":
        expect = tpch_oracle("q10", data, sf)
        check, plan = check_q10, tpch.q10
    else:
        expect, check, plan = tpch_oracle("q18", data, sf), check_q18, tpch.q18
    fraction, jpeak = grace_fraction(sess, plan())
    grace = grace_session(sess, fraction)
    runs = {}
    for run, s in (("direct", sess), ("grace", grace)):
        key = f"{q}_{run}"
        out, launches[key], first_s, times, peak, b3_calls[key], semi, plan_ms = run_query(
            s, plan(), reps)
        check(out, expect, key)
        if run == "grace" and launches[key]["partition_sort"] == 0:
            raise AssertionError(f"{key} did not launch B3: {launches[key]}")
        runs[run] = dict(_query_run(s, key, first_s, times, peak, launches, b3_calls, semi,
                                    plan_ms), **_grace_record(s),
                         sort_limbs=agg_sort_limbs(s, plan()))
        check_rf(q, sf, run, runs[run])
    if sess.grace_runners or not any(r.K == GRACE_K for r in grace.grace_runners):
        raise AssertionError(f"{q}: the direct run partitioned, or no grace join of K={GRACE_K}: "
                             f"{runs['grace']['grace_runners']}")
    c_name = sess.tables["customer"].column("c_name")
    emit({"phase": q, "sf": sf, "correct": True, "rows": len(expect), "result": expect[:5],
          "c_name_padded": not c_name.is_dict, "memory_fraction": fraction,
          "grace_budget_bytes": grace.budget_bytes(), "join_peak_estimate_bytes": jpeak,
          **runs})
    profile_tpch(profile, sess, plan(), f"profile_{q}_direct")
    profile_tpch(profile, grace, plan(), f"profile_{q}_grace")


def part_phase(q: str, sess, data, sf: float, reps: int, profile: bool, launches,
               b3_calls) -> None:
    """Q2 (the EUROPE suppliers' least cost per part, LIKE '%BRASS' over
    p_type, a two-key LEFT_SEMI join back, a top-100), Q9 (LIKE '%green%'
    over the padded p_name, five INNER joins, one on partsupp's two keys,
    profit per nation and year), Q19 (lineitem joined to part under three
    clauses, an ungrouped SUM: B2's one bucket), or one of the float
    queries: Q7 (the FRANCE-GERMANY trade, five INNER joins, two nation
    scans), Q8 (BRAZIL's market share: seven INNER joins, a DOUBLE volume,
    a float CASE, two float SUMs per year and their division), Q11
    (GERMANY's partsupp value per part against TPC-H's FRACTION, 0.0001 /
    SF, of the total: a broadcast nested-loop join under a DOUBLE
    condition), Q14 (the PROMO
    revenue share: two decimal sums cast to DOUBLE) or Q17 (a per-part
    decimal AVG over all of lineitem, joined back under a DOUBLE
    condition), or Q13 (customer LEFT JOIN orders, the orders per customer
    and the customers per count), Q16 (a LEFT ANTI join, COUNT(DISTINCT
    ps_suppkey)), Q20 (a packed two-key join under a DOUBLE condition, two
    LEFT_SEMI joins; empty at TPC-H's literals, ROADMAP C16), Q20's
    variant ``Q20_VARIANT``, Q21 (a LEFT SEMI and a LEFT ANTI join with a
    condition, their paths checked by ``check_q21_paths``) or Q22
    (``substring``, B1 and B2 in its ungrouped AVG); directly and under a
    budget that makes the
    engine split a join into K = 16 pairs (Q20's lineitem aggregate runs
    tiled first, each attempt reported): each checked against its
    numpy oracle (FLOAT64 sums within ``FLOAT_SUM_RTOL``, the other float
    results bit-equal), timed, its launches (B1 and B2 in the one-bucket
    sums of the direct runs of Q19, Q11, Q14 and Q17, B3 in every grace
    run), B3 calls, runtime filters, planning host ms, stages, hints,
    attempts, grace joins, outer joins (path and output capacity) and
    semi-like joins with a condition (path) reported, with the host seconds
    of the oracle, the budget search and each run (``phase_s``); Q11's lines add the nested-loop join's two input capacities,
    whose product must stay under
    ``join.BNLJ_MAX_PRODUCT_ROWS``."""
    from datafusion_comet_tpu_torch.exec.operators.join import BNLJ_MAX_PRODUCT_ROWS
    from datafusion_comet_tpu_torch.models import tpch

    d, day = data, tpch._d
    t0 = time.perf_counter()
    scalar = (lambda col: lambda out, e, what: check_scalar_f64(out, col, e, what))
    check = {"q2": check_q2, "q9": check_q9, "q19": check_q19, "q7": check_q7, "q8": check_q8,
             "q11": check_q11, "q14": scalar("promo_revenue"), "q17": scalar("avg_yearly"),
             "q13": check_q13, "q16": check_q16, "q20": check_q20, "q20_variant": check_q20,
             "q21": check_q21, "q22": check_q22}[q]
    expect = tpch_oracle(q, data, sf)
    # Q11 at TPC-H's FRACTION for the scale factor (the plan's default is SF1's)
    plan = {"q11": lambda: tpch.q11(Q11_FRACTION / sf),
            "q20_variant": lambda: tpch.q20(**Q20_VARIANT)}.get(q) or getattr(tpch, q)
    seconds = {"oracle": time.perf_counter() - t0}
    t0 = time.perf_counter()
    fraction, jpeak = grace_fraction(sess, plan())
    grace = grace_session(sess, fraction)
    seconds["grace_fraction"] = time.perf_counter() - t0
    runs = {}
    for run, s in (("direct", sess), ("grace", grace)):
        key = f"{q}_{run}"
        t0 = time.perf_counter()
        out, launches[key], first_s, times, peak, b3_calls[key], semi, plan_ms = run_query(
            s, plan(), reps)
        seconds[run] = time.perf_counter() - t0
        check(out, expect, key)
        need = ("partition_sort",) if run == "grace" else {
            "q19": ("bucket_sum",), "q11": ("bucket_count", "bucket_sum"),
            "q14": ("bucket_count", "bucket_sum"), "q17": ("bucket_count", "bucket_sum"),
            "q22": ("bucket_count", "bucket_sum"),
        }.get(q, ())
        if any(launches[key][k] == 0 for k in need):
            raise AssertionError(f"{key} did not launch {need}: {launches[key]}")
        runs[run] = dict(_query_run(s, key, first_s, times, peak, launches, b3_calls, semi,
                                    plan_ms), **_grace_record(s), outer_joins=outer_joins(s),
                         semi_cond_joins=semi_cond_joins(s))
        if q == "q13" and not runs[run]["outer_joins"]:
            raise AssertionError(f"{key} ran no outer join")
        if q == "q21":
            check_q21_paths(runs[run]["semi_cond_joins"], sf, key)
        if q == "q11":
            caps = [j["capacities"] for r in s.runs if r["where"] == "stage"
                    and not r["overflowed"] for j in r["joins"] if j["path"] == "nested_loop"]
            if len(caps) != 1 or caps[0][0] * caps[0][1] > BNLJ_MAX_PRODUCT_ROWS:
                raise AssertionError(f"{key}: nested-loop join capacities {caps}")
            runs[run]["bnlj_capacities"] = caps[0]
        check_rf(q, sf, run, runs[run])
    if sess.grace_runners or not any(r.K == GRACE_K for r in grace.grace_runners):
        raise AssertionError(f"{q}: the direct run partitioned, or no grace join of K={GRACE_K}: "
                             f"{runs['grace']['grace_runners']}")
    rows = expect[1] if q == "q11" else expect
    p_name = sess.tables["part"].column("p_name")
    emit({"phase": q, "sf": sf, "correct": True,
          "rows": len(rows) if isinstance(rows, list) else 1,
          "result": rows[:5] if isinstance(rows, list) else rows,
          **({"threshold": expect[0]} if q == "q11" else {}),
          "p_name_padded": not p_name.is_dict,
          "c_phone_padded": not sess.tables["customer"].column("c_phone").is_dict,
          "memory_fraction": fraction,
          "grace_budget_bytes": grace.budget_bytes(), "join_peak_estimate_bytes": jpeak,
          "phase_s": seconds, **runs})
    profile_tpch(profile, sess, plan(), f"profile_{q}_direct")
    profile_tpch(profile, grace, plan(), f"profile_{q}_grace")


def outer_joins(s):
    """The outer joins of a session's last run, each distinct one once:
    where it ran (a stage or a grace pair), its type, path, compacted-list
    rows and output capacity."""
    seen = {json.dumps(dict(where=r["where"], **{k: j[k] for k in (
        "type", "path", "compact_rows", "out_capacity")}), sort_keys=True)
        for r in s.runs if not r["overflowed"] for j in r["joins"]
        if j.get("type") in ("left", "right", "full")}
    return [json.loads(j) for j in sorted(seen)]


def semi_cond_joins(s):
    """The semi-like joins with a condition of a session's last run, each
    distinct one once: where it ran (a stage or a grace pair), its type and
    path (minmax_dense, minmax_sorted or pairs)."""
    seen = {json.dumps({"where": r["where"], "type": j["type"], "path": j["path"]},
                       sort_keys=True)
            for r in s.runs if not r["overflowed"] for j in r["joins"]
            if j["path"] in ("minmax_dense", "minmax_sorted", "pairs")}
    return [json.loads(j) for j in sorted(seen)]


def check_q21_paths(joins, sf: float, what: str) -> None:
    """Q21's LEFT SEMI and LEFT ANTI joins with a condition take the dense
    min/max table at SF1 (l_orderkey's span under 2^24) and the sorted
    build's runs at SF10 (over it), in a stage and in every grace pair;
    other scale factors are not checked."""
    want = {1: "minmax_dense", 10: "minmax_sorted"}.get(sf)
    types = {j["type"] for j in joins}
    if types != {"left_semi", "left_anti"} or (want and {j["path"] for j in joins} != {want}):
        raise AssertionError(f"{what} at SF{sf:g}: joins with a condition {joins}, "
                             f"expected a left_semi and a left_anti on {want}")


def padded_phase(sf: float, reps: int, launches, b3_calls) -> None:
    """Q1, Q3, Q4, Q5 and Q12 over tables staged with every string padded
    (``Config(scan_dictionary_max_size=0)``: no dictionary codes; Q1 groups
    by the padded one-byte flags on the sorted path), each against its
    numpy oracle, timed, its launches counted."""
    import torch
    from datafusion_comet_tpu_torch.conf import Config
    from datafusion_comet_tpu_torch.exec.engine import Session
    from datafusion_comet_tpu_torch.models import tpch

    data = tpch.generate_tables(TABLES, sf)
    sess = Session(conf=Config(scan_dictionary_max_size=0))
    t0 = time.perf_counter()
    for t in TABLES:
        sess.register_numpy(t, data[t], tpch.SCHEMAS[t])
    torch.cuda.synchronize()
    stage_s = time.perf_counter() - t0
    if any(c.is_dict for b in sess.tables.values() for c in b.columns):
        raise AssertionError("padded: a string column was dictionary-coded")
    li, od, cu = data["lineitem"], data["orders"], data["customer"]
    checks = {
        "q1": lambda out: check_q1(out, oracle_q1(li, tpch._d("1998-09-02"))),
        "q3": lambda out: check_q3(out, oracle_q3(li, od, cu, tpch._d("1995-03-15")),
                                   "padded q3"),
        "q4": lambda out: check_q4(out, oracle_q4(li, od, tpch._d("1993-07-01"),
                                                  tpch._d("1993-10-01")), "padded q4"),
        "q5": lambda out: check_q5(out, oracle_q5(*(data[t] for t in TABLES),
                                                  tpch._d("1994-01-01"),
                                                  tpch._d("1995-01-01")), "padded q5"),
        "q12": lambda out: check_q12(out, oracle_q12(li, od, tpch._d("1994-01-01"),
                                                     tpch._d("1995-01-01")), "padded q12"),
    }
    runs = {}
    for q, check in checks.items():
        key = f"padded_{q}"
        out, launches[key], first_s, times, peak, b3_calls[key], semi, plan_ms = run_query(
            sess, getattr(tpch, q)(), reps)
        check(out)
        runs[q] = _query_run(sess, key, first_s, times, peak, launches, b3_calls, semi, plan_ms)
    emit({"phase": "padded", "sf": sf, "correct": True, "stage_s": stage_s, **runs})


def _plan_nodes(stages, kind: str):
    """Every node of a type (by class name) in a stage list's plans."""
    out, stack = [], [p for _, p in stages]
    while stack:
        node = stack.pop()
        out += [node] if type(node).__name__ == kind else []
        stack.extend(node.children())
    return out


def minmax_phase(sf: float, reps: int, seed: int):
    """The dense path's MIN/MAX reduction (aggregate._minmax_reduce: each
    group's rows spread over up to 1024 lanes of scatter-min slots, then a
    min over the lanes) at Q1's shape (64 buckets, the lineitem capacity,
    Q1's codes) against one scatter-min into 65 slots, the plain form that
    funnels a group's rows into one address: equal, and both timed on the
    card (L2 rewritten before each run). Also MAX, and one group (an
    ungrouped MIN)."""
    import torch
    from datafusion_comet_tpu_torch.exec.batch import pad_capacity
    from datafusion_comet_tpu_torch.exec.operators import aggregate as AGG
    from datafusion_comet_tpu_torch.models import tpch
    from datafusion_comet_tpu_torch.tools import bucket_times as BT

    dev = torch.device("cuda", 0)
    rng = np.random.default_rng(seed)
    rows = tpch.table_rows("lineitem", sf)
    codes_np, _ = BT.q1_inputs(pad_capacity(rows), rows, rng)
    flush = torch.zeros(BT.L2_FLUSH_BYTES // 4, dtype=torch.int32, device=dev)
    out = {}
    for name, m, is_min in (("min_b64", 64, True), ("max_b64", 64, False),
                            ("min_b1", 1, True)):
        codes = torch.from_numpy(codes_np if m == 64 else np.where(codes_np < 64, 0, 1)
                                 .astype(np.int32)).to(dev)
        n = int(codes.shape[0])
        x = torch.randint(-(1 << 62), 1 << 62, (n,), dtype=torch.int64, device=dev)
        info = torch.iinfo(torch.int64)

        def one_address():
            t = torch.full((m + 1,), info.max if is_min else info.min, dtype=torch.int64,
                           device=dev)
            return t.scatter_reduce_(0, codes.long(), x, "amin" if is_min else "amax")[:m]

        got = AGG._minmax_reduce(x, codes, m, is_min)
        want = one_address()
        torch.cuda.synchronize()
        if not torch.equal(got, want):
            raise AssertionError(f"dense {name}: the lane reduction != one scatter")
        out[name] = {
            "n": n, "buckets": m, "max_abs_err": 0,
            "ms": BT.cuda_ms(lambda: AGG._minmax_reduce(x, codes, m, is_min), reps, flush=flush),
            "one_address_ms": BT.cuda_ms(one_address, reps, flush=flush),
            # codes and values read once, m results written
            "bound_ms": (4 * n + 8 * n + 8 * m) / BT.HBM_BYTES_PER_S * 1e3}
    return out


# the TPC-H profiles --profile takes: the runs PERF.md section 5 cites (Q1,
# each process's first profile; Q2's grace pairs' host dispatch; Q20's
# variant; Q21's min/max scatters and its grace run's idle share). The
# other TPC-H runs were profiled in earlier PRs (PERF.md) and are no longer
# cited; cut to keep `--sf 10 --profile` inside its time limit
# (not Q2's and Q21's grace profiles: 28 and 22 s of a --sf 10 run, cut to
# hold the run's time with the nested phase added)
TPCH_PROFILE = ("profile_q1", "profile_q20_variant_direct", "profile_q21_direct")


def profile_tpch(profile: bool, sess, plan, phase: str) -> None:
    """Emit ``profile_run`` of a TPC-H run where --profile is on and
    ``TPCH_PROFILE`` names it."""
    if profile and phase in TPCH_PROFILE:
        emit(profile_run(sess, plan, phase))


def profile_run(sess, plan, phase: str):
    """Device time by kernel over one warm run (torch.profiler), from
    tools/query_times.py: busy and idle share, index gathers, scatter_reduce
    and partition kernels apart, the top kernels, the grace spans' host ms.
    Only device-side events count: a CPU op's device time is the sum of the
    kernels it launched, and the grace spans are annotations, not kernels."""
    from datafusion_comet_tpu_torch.tools import query_times as QT

    out = QT.profile(sess, plan)
    if not out["device_busy_ms"]:
        raise AssertionError(f"torch.profiler recorded no device activity for {phase}")
    return {"phase": phase, **out}


# ---- phase 5: the partition sort against its plain version ---------------------------


def call_inputs(call, gen, dev):
    """Inputs of one logged B3 call: the codes the query gave it (so the
    live rows sit where the query put them) and a random tensor of each of
    the call's tensors' dtype and row shape (the kernel's work does not
    depend on the payload's values)."""
    n = call["n"]
    return call["code_values"].to(dev), [random_tensor(dt, (n,) + tuple(row), gen, dev)
                                         for dt, row in call["tensors"]]


def random_tensor(dtype: str, shape, gen, dev):
    import torch

    dt = getattr(torch, dtype)
    if dt == torch.bool:
        return torch.rand(shape, device=dev, generator=gen) < 0.5
    if dt.is_floating_point:
        return torch.rand(shape, device=dev, generator=gen).to(dt)
    info = torch.iinfo(dt)
    return torch.randint(info.min, info.max, shape, dtype=dt, device=dev, generator=gen)


def b3_bound_ms(codes, tensors, rows_out: int, k: int) -> float:
    """Least time for one call at the H100's memory rate: the codes read
    once, each moved row of each tensor read once and written once, the
    code totals written."""
    from datafusion_comet_tpu_torch.tools import bucket_times as BT

    n = int(codes.shape[0])
    row_bytes = sum(t.numel() // max(n, 1) * t.element_size() for t in tensors)
    nbytes = codes.element_size() * n + 2 * row_bytes * rows_out + 8 * (k + 1)
    return nbytes / BT.HBM_BYTES_PER_S * 1e3


def time_payload(K, codes, k: int, tensors, local: bool, limit, reps: int, flush):
    """Wrapper, plain and library times of one partition_columns shape."""
    import torch
    from datafusion_comet_tpu_torch.tools import bucket_times as BT

    n = int(codes.shape[0])
    rows = n if limit is None else min(limit, n)
    # the library composition: one stable sort of the codes (the mask as
    # bytes, descending: live rows first), then one index_select a tensor
    key = codes.view(torch.uint8) if codes.dtype == torch.bool else codes

    def library():
        perm = torch.sort(key, stable=True, descending=codes.dtype == torch.bool).indices[:rows]
        return [t.index_select(0, perm) for t in tensors]

    def wrapper():
        return K.partition_columns(codes, k, tensors, local=local, limit=limit, errors=[])

    t = -(-n // K.PARTITION_TILE)
    return {
        "shape": f"n={n} K={k} {'local' if local else 'global'} limit={limit} "
                 f"tensors={[(str(x.dtype), tuple(x.shape[1:])) for x in tensors]}",
        "ms": BT.cuda_ms(wrapper, reps, flush=flush),
        "host_us": BT.host_us(wrapper),
        "plain_ms": BT.cuda_ms(lambda: K.partition_columns_plain(codes, k, tensors, local, limit),
                               reps, flush=flush),
        "library_ms": BT.cuda_ms(library, reps, flush=flush),
        "bound_ms": b3_bound_ms(codes, tensors, rows, k),
        # the bound of the permutation-only contract: codes in,
        # int32 indices and the (tile, code) counts out
        "perm_bound_ms": (codes.element_size() * n + 4 * n + 4 * t * (k + 1))
        / BT.HBM_BYTES_PER_S * 1e3,
    }


def _words(t):
    """``t`` as int64 values of its 4-byte words (its bytes for 1-byte
    types), so that a difference of two such views cannot wrap."""
    import torch

    t = t.contiguous()
    if t.element_size() == 1:
        return t.view(torch.uint8).long()
    return t.view(torch.int32).long() if t.element_size() in (4, 8) else t.view(
        torch.int16).long()


def check_payload(K, name, codes, k, tensors, local=False, limit=None):
    """partition_columns against its plain version, exactly: the case's
    record and its max abs error, over the sizes and every output's 4-byte
    words (bytes for 1-byte types). Raises unless it is 0."""
    outs, sizes = K.partition_columns(codes, k, tensors, local=local, limit=limit)
    want, want_sizes = K.partition_columns_plain(codes, k, tensors, local, limit)
    pairs = [(sizes, want_sizes)] + list(zip(outs, want))
    if any(o.dtype != w.dtype or o.shape != w.shape for o, w in pairs):
        raise AssertionError(f"partition_columns != plain on {name}: dtypes or shapes differ")
    err = max(int((_words(o) - _words(w)).abs().max()) if o.numel() else 0 for o, w in pairs)
    if err:
        raise AssertionError(f"partition_columns != plain on {name}: max abs err {err}")
    n = int(codes.shape[0])
    return {"case": name, "n": n, "K": k, "local": local, "limit": limit,
            "codes": str(codes.dtype), "codes_offset_bytes": codes.data_ptr() % 16,
            "row_bytes": [t.numel() // max(n, 1) * t.element_size() for t in tensors]}, err


def b3_call_names(calls):
    """Each distinct B3 call of Q12's, Q3's, Q4's, Q15's, Q6's, Q5's, Q10's
    and Q18's runs (Q18's grace calls move c_name's 25-byte rows), then of
    every other run (Q2, Q9, Q19, Q7, Q8, Q11, Q14, Q17, Q13, Q16, Q20, Q20's
    variant and the padded phase) in name order, named by run, place in the run and kind: [(name,
    call)], a repeated shape once."""
    out, seen = [], set()
    first = ("q12_grace", "q12_direct", "q3_grace", "q3_direct", "q4_grace", "q4",
             "q4_semi_compact", "q15", "q6", "q5_grace", "q5_direct", "q18_grace", "q18_direct",
             "q10_grace", "q10_direct")
    for run in first + tuple(sorted(set(calls) - set(first))):
        for i, c in enumerate(calls[run]):
            shape = (c["n"], c["K"], c["local"], c["limit"], c["codes"], tuple(c["tensors"]))
            if shape not in seen:
                seen.add(shape)
                kind = ("rf_compact" if c["rf"] else "compact") if c["codes"] == "bool" \
                    else f"k{c['K']}"
                out.append((f"{run}_{i}_{kind}", c))
    return out


def partition_phase(sizes, calls, reps: int, seed: int):
    """B3 against its plain versions, exactly, then timed. Payload-moving
    (partition_columns): every distinct B3 call of the queries' runs
    (``b3_call_names``; the TPC-DS runs' untimed), on the codes the query
    gave it, the TPU kernel's probe shape in tile-local
    mode, and every row width on misaligned inputs. Permutation-only
    (partition_sort): the grace sides' shapes (each side's capacity, its
    live rows spread over K = 16 codes), the probe shape and edge shapes.
    Returns (cases, timing by shape, the name of the grace run's largest
    K = 16 call)."""
    import torch
    from datafusion_comet_tpu_torch.exec import kernels as K
    from datafusion_comet_tpu_torch.tools import bucket_times as BT

    dev = torch.device("cuda", 0)
    rng = np.random.default_rng(seed)
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    flush = torch.zeros(BT.L2_FLUSH_BYTES // 4, dtype=torch.int32, device=dev)

    # -- payload-moving: the queries' calls --------------------------------------------
    shapes = b3_call_names(calls)
    sides = [(c["n"], name) for name, c in shapes
             if name.startswith("q12_grace") and c["K"] == GRACE_K]
    if len(sides) != 2:
        raise AssertionError(f"q12 grace made {len(sides)} partitions of K={GRACE_K}")
    checked, timing, max_err = [], {}, 0
    for name, call in shapes:
        codes, tensors = call_inputs(call, gen, dev)
        rec, err = check_payload(K, name, codes, call["K"], tensors, call["local"],
                                 call["limit"])
        checked.append(rec)
        max_err = max(max_err, err)
        if not name.startswith("ds_"):  # the TPC-DS runs' calls are checked, not timed
            # the nested explode's compaction spans the E-fold capacity (its
            # plain and library versions take seconds): fewer runs
            timing[name] = time_payload(K, codes, call["K"], tensors, call["local"],
                                        call["limit"],
                                        max(3, reps // 5) if name.startswith("nested_") else reps,
                                        flush)
        del codes, tensors, call["code_values"]
        torch.cuda.empty_cache()
    probe_n = 1 << 23  # pallas_scatter_probe.py's default N, K = 16, tile 512
    codes = torch.randint(0, 16, (probe_n,), dtype=torch.int32, device=dev, generator=gen)
    limbs = [random_tensor("int64", (probe_n,), gen, dev) for _ in range(4)]
    rec, err = check_payload(K, "probe_tile_local", codes, 16, limbs, local=True)
    checked.append(rec)
    max_err = max(max_err, err)
    timing["probe_tile_local"] = time_payload(K, codes, 16, limbs, True, None, reps, flush)
    # every row width (1, 4, 8, 16 and 25 bytes, and 6: 2-byte words), codes
    # and tensors starting one element off their allocation, ragged n
    odd = 1_000_003
    widths = [("bool", ()), ("int32", ()), ("int64", ()), ("int64", (2,)), ("uint8", (25,)),
              ("uint8", (6,))]
    off = [random_tensor(dt, (odd + 1,) + row, gen, dev)[1:] for dt, row in widths]
    for name, k, dead, limit in (("widths_k16_offset1", 16, 0.3, None),
                                 ("widths_k64_offset1", 64, 0.1, None),
                                 ("widths_k1_limit", 1, 0.5, 262_144)):
        c = np.where(rng.random(odd + 1) < dead, k, rng.integers(0, k, odd + 1)).astype(np.int32)
        rec, err = check_payload(K, name, torch.from_numpy(c).to(dev)[1:], k, off, limit=limit)
        checked.append(rec)
        max_err = max(max_err, err)
    # nested rows: a list's (E,) int64 element block (32 elements, 256
    # bytes) and a list of padded strings' (16, 40) byte block, with their
    # counts and validity, partitioned at K = 16 as a grace side is
    for name, n, rows in (("nested_int64x32", 1 << 22, [("int32", ()), ("bool", (32,)),
                                                       ("int64", (32,))]),
                          ("nested_strings16x40", 1 << 20, [("int32", ()), ("bool", (16,)),
                                                           ("uint8", (16, 40)),
                                                           ("int32", (16,))])):
        c = np.where(rng.random(n) < 0.2, 16, rng.integers(0, 16, n)).astype(np.int32)
        ncodes = torch.from_numpy(c).to(dev)
        tensors = [random_tensor(dt, (n,) + row, gen, dev) for dt, row in rows]
        rec, err = check_payload(K, name, ncodes, 16, tensors)
        checked.append(rec)
        max_err = max(max_err, err)
        timing[name] = time_payload(K, ncodes, 16, tensors, False, None, reps, flush)
        del ncodes, tensors
        torch.cuda.empty_cache()
    mask = (torch.rand(odd + 1, device=dev, generator=gen) < 0.3)[1:]
    dead = torch.full((65_537,), 16, dtype=torch.int32, device=dev)
    for rec, err in (
            check_payload(K, "widths_mask_limit_offset1", mask, 1, off, limit=262_144),
            check_payload(K, "all_dead", dead, 16, [random_tensor("int64", (65_537,), gen, dev)]),
            check_payload(K, "one_row", torch.zeros(1, dtype=torch.int32, device=dev), 16,
                          [random_tensor("int64", (1, 2), gen, dev)])):
        checked.append(rec)
        max_err = max(max_err, err)
    try:
        K.partition_columns(torch.tensor([0, 17, 3], dtype=torch.int32, device=dev), 16, [])
    except ValueError:
        pass
    else:
        raise AssertionError("partition_columns accepted a code outside [0, K]")
    del codes, limbs, off, mask
    torch.cuda.empty_cache()

    # -- permutation-only: partition_sort ----------------------------------------------
    def codes_for(n: int, live: int, k: int):
        c = np.full(n, k, np.int32)
        c[:live] = rng.integers(0, k, live)
        return torch.from_numpy(rng.permutation(c) if live < n else c).to(dev)

    cases = [(f"perm_q12_{side}", codes_for(v["capacity"], v["rows"], GRACE_K), GRACE_K, False)
             for side, v in sizes.items()]
    cases += [
        ("perm_probe_tile_local", codes_for(probe_n, probe_n, 16), 16, True),
        ("perm_k1", codes_for(1_000_003, 900_000, 1), 1, False),
        ("perm_k64_ragged", codes_for(1_000_003, 950_000, 64), 64, False),
        ("perm_k128_local_ragged", codes_for(70_001, 70_001, 128), 128, True),
        ("perm_all_dead", codes_for(65_537, 0, 16), 16, False),
        ("perm_one_row", codes_for(1, 1, 16), 16, False),
    ]
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
    for name, codes, k, local in cases[:len(sizes)]:
        n = int(codes.shape[0])
        t = -(-n // K.PARTITION_TILE)
        timing[name] = {
            "shape": f"n={n} K={k} {'local' if local else 'global'} permutation only",
            "ms": BT.cuda_ms(lambda: K.partition_sort(codes, k, local=local, errors=[]), reps,
                             flush=flush),
            "plain_ms": BT.cuda_ms(lambda: K.partition_sort_plain(codes, k, local), reps,
                                   flush=flush),
            "library_ms": BT.cuda_ms(lambda: torch.sort(codes, stable=True), reps, flush=flush),
            "bound_ms": (4 * n + 4 * n + 4 * t * (k + 1)) / BT.HBM_BYTES_PER_S * 1e3,
        }
    for r in timing.values():
        r["max_abs_err"] = max_err
    return checked, timing, max(sides)[1]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--sf", type=float, default=1.0, help="TPC-H scale factor (default 1)")
    ap.add_argument("--reps", type=int, default=25, help="timed warm runs per measurement")
    ap.add_argument("--seed", type=int, default=7, help="seed of the kernel-phase inputs")
    ap.add_argument("--profile", action="store_true",
                    help="add profiled runs of Q1, of Q20's variant and Q21 directly "
                         "(TPCH_PROFILE), of TPC-DS q3's, q27's, q33's and "
                         "q96's two runs and q64's and q88's, of EXPR_PROFILE's plans "
                         "and of the nested_* plans")
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
    start_oracles(args.sf)
    try:
        return run_phases(args, kind, smi)
    finally:
        stop_oracles()


def run_phases(args, kind: str, smi: str) -> int:
    import torch
    from datafusion_comet_tpu_torch.exec import _build

    t0 = time.perf_counter()
    sources = sorted({Path(src).stem for src in SOURCES.values()})
    with concurrent.futures.ThreadPoolExecutor(len(sources)) as pool:
        logs = list(pool.map(_build.build, sources))
    emit({"phase": "build", "seconds": time.perf_counter() - t0,
          "ptxas": {name: ptxas_by_kernel(log) for name, log in zip(sources, logs)}})

    checked, timing = kernel_phase(args.sf, args.reps, args.seed)
    emit({"phase": "kernels", "checked_exact": checked, "timing": timing})

    launches, sizes, b3_calls = query_phase(args.sf, max(3, args.reps // 5), args.profile)
    if args.sf <= 1:  # the padded phase runs at SF1 (or the smaller scale asked for)
        padded_phase(args.sf, max(3, args.reps // 5), launches, b3_calls)
    tpcds_phase(args.sf, max(3, args.reps // 8), args.profile, launches, b3_calls)
    explain_phase()
    pair = pair_phase(sizes, args.reps, args.seed)
    emit({"phase": "grace_pair_kernels", "timing": pair})
    timing["bucket_count"]["other_shapes"] = {"grace_pair": pair["bucket_count"]}
    timing["bucket_sum"]["other_shapes"] = {"one_lane": timing.pop("bucket_sum_one_lane"),
                                            "grace_pair": pair["bucket_sum"]}

    pchecked, ptiming, head = partition_phase(sizes, b3_calls, args.reps, args.seed)
    emit({"phase": "partition", "checked_exact": pchecked, "timing": ptiming})
    emit({"phase": "dense_minmax", "timing": minmax_phase(args.sf, args.reps, args.seed)})
    # the kernels line: one bound a shape (the perm-only bound stays in the
    # partition line)
    ptiming = {k: {a: b for a, b in v.items() if a != "perm_bound_ms"}
               for k, v in ptiming.items()}
    timing["partition_sort"] = dict(ptiming.pop(head), other_shapes=ptiming)

    kernels = []
    for name in KERNELS:
        t = timing[name]
        per_query = {q: launches[q][name] for q in launches}
        kernels.append({
            "name": name, "route": "cuda", "source": SOURCES[name], "replaces": REPLACES[name],
            "launches": sum(per_query.values()), "launches_by_query": per_query,
            "max_abs_err": t["max_abs_err"], "ms": t["ms"], "plain_ms": t["plain_ms"],
            "bound_ms": t["bound_ms"], "bound_by": "bytes", "library_ms": t["library_ms"],
            "shape": t["shape"], **({"host_us": t["host_us"]} if "host_us" in t else {}),
            **({"other_shapes": t["other_shapes"]} if "other_shapes" in t else {}),
        })
    emit({"kernels": kernels})
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())

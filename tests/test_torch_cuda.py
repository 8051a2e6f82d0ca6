"""PyTorch port on the card: the CUDA kernels against their plain versions,
Q1, Q6, Q12, Q3, Q4, Q5, Q10, Q18, Q2, Q9, Q19, Q7, Q8, Q11, Q14, Q17, Q13,
Q16 and Q20
(all but Q1 and Q6 directly and through the grace join; Q4 on both
semi-join membership paths; Q10, Q18 and the last eleven with the default
staging and every string padded), Q15, and Q3, Q9 and Q10 with their
runtime filters on the card against the same queries on the CPU, the
dense path's MIN/MAX, the string operations (padded limbs, comparisons,
CASE WHEN, murmur3, LIKE) and the fields of a date, and the float
operations (order limbs, expressions, SUM/AVG/MIN/MAX) and the
nested-loop join, the outer hash joins on every path, Q13, Q16, Q20
and Q20's variant, the semi-like joins with a condition on each path,
``substring``, Q21 and Q22 directly and through the grace join, the 99
TPC-DS queries, Union, Expand, NOT and the null tests, every window
function and frame, the other scalar aggregates (FIRST, LAST, the bit,
bool and covariance families, MIN and MAX of strings and bools) on the
dense and sorted paths and under the grace join's partial mode, the bloom
filter and its probe through a scalar subquery, q88 and q90_scalar
directly and under the grace join, the special aggregates (median,
percentile, approx_count_distinct, approx_percentile; SINGLE and tiled),
TPC-H Q12 and Q3 in the SortMergeJoin shape on the merge path, Q16 with
NOT IN, Session.prepare directly and under the grace join, each family
of the scalar evaluator (temporal functions in named zones, the string
casts with Ryu, the string functions, the hashes, rand and randn), the
nested expressions (arrays, maps, structs, higher-order functions,
split), Explode, collect_list/collect_set in every mode, the percentile
list and Session.explain on the card against the CPU, the partition
kernel at nested row shapes against its plain version, and the text
functions (RLIKE, the regexp forms, the bytes family and digests, JSON
paths, a Python UDF, the aggregate FILTER clause) on the card against the
CPU. Marked
``cuda``;
without a card every test here skips. This file imports no JAX, so it runs
on a machine without it (tests/conftest.py imports JAX, hence --noconftest):

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py
"""

import dataclasses
import json

import numpy as np
import pytest
import torch

import chip_smoke
from datafusion_comet_tpu_torch import types as PT
from datafusion_comet_tpu_torch.conf import Config
from datafusion_comet_tpu_torch.exec import kernels as K
from datafusion_comet_tpu_torch.exec.engine import Session
from datafusion_comet_tpu_torch.ir import plan as PP
from datafusion_comet_tpu_torch.models import tpch

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", 0)


@pytest.mark.parametrize("n,B,lanes", [(8_388_608, 64, 4), (1_000_003, 1, 1),
                                       (1_000_003, 4096, 3), (4097, 64, 0)])
def test_kernels_equal_plain_versions(dev, n, B, lanes):
    rng = np.random.default_rng(n + B)
    codes = torch.from_numpy(rng.integers(0, B + 1, n).astype(np.int32)).to(dev)
    shape = (lanes, n) if lanes else (n,)
    vals = torch.from_numpy(rng.integers(-(2**63), 2**63 - 1, shape, dtype=np.int64)).to(dev)
    assert torch.equal(K.bucket_count(codes, B), K.bucket_count_plain(codes, B))
    assert torch.equal(K.bucket_sum(codes, vals, B), K.bucket_sum_plain(codes, vals, B))
    torch.cuda.synchronize()


# every layout boundary of kernels.bucket_layout (227/228 for counts, 908/909
# and four lanes at 227/228 for sums), B = 4096, n % 4 != 0, codes (and one
# lane of values) that start off a 16-byte boundary, odd n with three lanes
# (lane 1 only 8-byte aligned), fewer rows than a vector, all rows dead
@pytest.mark.parametrize("n,B,lanes,offset,dead", [
    (1_000_003, 227, 4, 0, 0.1), (1_000_003, 228, 4, 0, 0.1), (100_003, 908, 2, 0, 0.0),
    (100_003, 909, 1, 1, 0.0), (300_001, 4096, 2, 1, 0.2), (300_001, 64, 3, 0, 0.3),
    (300_002, 64, 2, 1, 0.0), (300_003, 64, 2, 3, 0.0), (300_001, 64, 1, 1, 0.05),
    (3, 16, 2, 1, 0.0), (70_001, 16, 1, 0, 1.0)])
def test_kernels_equal_plain_at_layout_boundaries(dev, n, B, lanes, offset, dead):
    rng = np.random.default_rng(n + B + offset)
    codes = np.where(rng.random(n + offset) < dead, B, rng.integers(0, B, n + offset))
    codes = torch.from_numpy(codes.astype(np.int32)).to(dev)[offset:]
    vals = torch.from_numpy(rng.integers(-(2**63), 2**63 - 1, (lanes, n + offset),
                                         dtype=np.int64)).to(dev)[:, offset:]
    if lanes == 1:  # one lane stays a view, so its values start off 16 bytes too
        vals = vals[0]
    assert codes.data_ptr() % 16 == 4 * offset % 16
    before = (K.bucket_count.launches, K.bucket_sum.launches)
    assert torch.equal(K.bucket_count(codes, B), K.bucket_count_plain(codes, B))
    assert torch.equal(K.bucket_sum(codes, vals, B), K.bucket_sum_plain(codes, vals, B))
    per = K.bucket_layout(lanes, B).lanes
    assert (K.bucket_count.launches, K.bucket_sum.launches) == (before[0] + 1,
                                                                before[1] - (-lanes // per))
    torch.cuda.synchronize()


def test_kernels_raise_on_bad_codes(dev):
    codes = torch.tensor([0, 70, 2], dtype=torch.int32, device=dev)
    with pytest.raises(ValueError):
        K.bucket_count(codes, 64)
    with pytest.raises(ValueError):
        K.bucket_sum(codes, torch.ones(3, dtype=torch.int64, device=dev), 64)


def test_kernels_defer_bad_codes_to_error_list(dev):
    codes = torch.tensor([0, 70, 2], dtype=torch.int32, device=dev)
    errs = []
    K.bucket_count(codes, 64, errs)
    K.bucket_sum(codes, torch.ones(3, dtype=torch.int64, device=dev), 64, errs)
    assert [bool(f.any()) for f, _ in errs] == [True, True]
    assert all("outside [0, 64]" in m for _, m in errs)


@pytest.mark.parametrize("q", ["q1", "q6"])
def test_queries_on_card_equal_cpu(dev, q):
    data = tpch.generate_table("lineitem", 0.01)
    gpu, cpu = Session(), Session(device="cpu")
    for s in (gpu, cpu):
        s.register_numpy("lineitem", data, tpch.SCHEMAS["lineitem"])
    K.bucket_count.launches = K.bucket_sum.launches = 0
    got = gpu.collect(getattr(tpch, q)())
    assert K.bucket_sum.launches > 0 and K.bucket_count.launches > 0
    want = cpu.collect(getattr(tpch, q)())
    assert list(got) == list(want)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


@pytest.mark.parametrize("n,parts,dead,local", [
    (2_097_152, 16, 0.3, False), (1_000_003, 1, 0.1, False), (1_000_003, 64, 0.0, False),
    (70_001, 128, 0.2, True), (1 << 20, 16, 0.0, True), (65_537, 16, 1.0, False), (1, 3, 0.0, False)])
def test_partition_sort_equals_plain(dev, n, parts, dead, local):
    rng = np.random.default_rng(n + parts)
    codes = np.where(rng.random(n) < dead, parts, rng.integers(0, parts, n)).astype(np.int32)
    codes = torch.from_numpy(codes).to(dev)
    before = K.partition_sort.launches
    perm, counts = K.partition_sort(codes, parts, local=local)
    # the count pass and the scatter pass; tile-local mode the scatter pass alone
    assert K.partition_sort.launches == before + (1 if local else 2)
    want_perm, want_counts = K.partition_sort_plain(codes, parts, local=local)
    assert torch.equal(perm, want_perm) and torch.equal(counts, want_counts)
    torch.cuda.synchronize()


def test_partition_sort_raises_and_defers_bad_codes(dev):
    codes = torch.tensor([0, 17, 2], dtype=torch.int32, device=dev)
    with pytest.raises(ValueError):
        K.partition_sort(codes, 16)
    errs = []
    K.partition_sort(codes, 16, errors=errs)
    assert [bool(f.any()) for f, _ in errs] == [True]
    assert "outside [0, 16]" in errs[0][1]


def _payload(rng, n: int, offset: int):
    """One tensor of each row width the queries move, each starting
    ``offset`` elements into a larger one (misaligned for offset > 0): bool
    (1 byte), int32 (4), int64 (8), two-limb decimal (16), f32 limb planes
    (16), padded strings of width 25 and 6 (words of 1 and 2 bytes)."""
    def cut(a):
        return torch.from_numpy(a).cuda()[offset:]

    m = n + offset
    return [cut(rng.random(m) < 0.5),
            cut(rng.integers(-2**31, 2**31, m).astype(np.int32)),
            cut(rng.integers(-2**63, 2**63 - 1, m, dtype=np.int64)),
            cut(rng.integers(-2**63, 2**63 - 1, (m, 2), dtype=np.int64)),
            cut(rng.integers(0, 1 << 16, (m, 4)).astype(np.float32)),
            cut(rng.integers(0, 256, (m, 25)).astype(np.uint8)),
            cut(rng.integers(0, 256, (m, 6)).astype(np.uint8))]


# (n, K, dead share, local, limit, offset, codes as the bool row mask)
@pytest.mark.parametrize("n,parts,dead,local,limit,offset,mask", [
    (1_000_003, 16, 0.3, False, None, 0, False), (1_000_003, 16, 0.3, False, None, 1, False),
    (300_001, 64, 0.1, False, None, 3, False), (70_001, 128, 0.2, True, None, 0, False),
    (1 << 20, 16, 0.0, True, None, 1, False), (1_000_003, 1, 0.6, False, 262_144, 0, True),
    (1_000_003, 1, 0.9, False, 262_144, 1, True), (1_000_003, 1, 0.5, False, 500_000, 0, False),
    (65_537, 16, 1.0, False, None, 0, False), (1, 16, 0.0, False, None, 0, False),
    (1, 1, 0.0, False, 1, 0, True), (3, 4, 0.0, True, None, 1, False)])
def test_partition_columns_equals_plain(dev, n, parts, dead, local, limit, offset, mask):
    rng = np.random.default_rng(n + parts + offset)
    codes = np.where(rng.random(n + offset) < dead, parts, rng.integers(0, parts, n + offset))
    codes = torch.from_numpy(codes.astype(np.int32)).to(dev)
    codes = (codes == 0)[offset:] if mask else codes[offset:]
    tensors = _payload(rng, n, offset)
    before = K.partition_columns.launches
    outs, sizes = K.partition_columns(codes, parts, tensors, local=local, limit=limit)
    assert K.partition_columns.launches == before + (1 if local else 2)
    want, want_sizes = K.partition_columns_plain(codes, parts, tensors, local, limit)
    torch.cuda.synchronize()
    assert sizes.dtype == want_sizes.dtype and torch.equal(sizes, want_sizes)
    for o, w in zip(outs, want):
        assert o.dtype == w.dtype and torch.equal(o, w)


def test_partition_columns_raises_and_defers_bad_codes(dev):
    codes = torch.tensor([0, 17, 2, -1], dtype=torch.int32, device=dev)
    vals = torch.arange(4, device=dev)
    with pytest.raises(ValueError, match=r"outside \[0, 16\]"):
        K.partition_columns(codes, 16, [vals])
    errs = []
    (got,), sizes = K.partition_columns(codes, 16, [vals], errors=errs)
    assert [bool(f.any()) for f, _ in errs] == [True]
    # bad codes are sorted as dead meanwhile
    assert got.tolist() == [0, 2, 1, 3] and sizes[16] == 2
    with pytest.raises(ValueError):
        K.partition_columns(codes, 16, [vals], local=True)


def test_q12_on_card_equals_cpu_direct_and_grace(dev):
    data = {t: tpch.generate_table(t, 0.01) for t in ("lineitem", "orders")}
    cpu = Session(device="cpu")
    for t, d in data.items():
        cpu.register_numpy(t, d, tpch.SCHEMAS[t])
    want = cpu.collect(tpch.q12())
    fraction, _ = chip_smoke.grace_fraction(cpu, tpch.q12(), 16)
    for grace, conf in ((False, Config()),
                        (True, Config(memory_fraction=fraction * 4 * 2**30
                                      / torch.cuda.get_device_properties(dev).total_memory))):
        gpu = Session(conf=conf)
        for t, d in data.items():
            gpu.register_numpy(t, d, tpch.SCHEMAS[t])
        for name in ("bucket_count", "bucket_sum", "partition_sort", "partition_columns"):
            getattr(K, name).launches = 0
        got = gpu.collect(tpch.q12())
        assert K.bucket_count.launches > 0 and K.bucket_sum.launches > 0
        # the filter shrink of the lineitem runs the partition, the grace
        # run also its partitioning; neither makes a permutation
        assert K.partition_columns.launches > 0 and K.partition_sort.launches == 0
        assert bool(gpu.grace_runners) == grace
        assert list(got) == list(want)
        for k in want:
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    assert gpu.grace_runners[0].K == 16


def test_two_limb_take_on_card_keeps_every_bit_pattern(dev):
    """The 16-byte-element gather of wide decimal rows copies bits on the
    card too: NaN payloads of the float view included."""
    from datafusion_comet_tpu_torch.exec.batch import _take_rows

    rng = np.random.default_rng(16)
    words = rng.integers(-2**63, 2**63 - 1, (1_000_003, 2), dtype=np.int64)
    words[:3] = [[0x7FF0000000000001, -1], [-0x0008000000000000, 0x7FF8000000000001],
                 [0x7FF0000000000000, -0x0010000000000000]]
    idx = torch.from_numpy(rng.integers(0, len(words), 2_000_000))
    want = torch.from_numpy(words)[idx]
    assert torch.equal(_take_rows(torch.from_numpy(words).to(dev), idx.to(dev)).cpu(), want)


def test_q3_on_card_equals_cpu_direct_and_grace(dev):
    """Q3 (two joins, the sorted aggregate as its own stage, the top-K) on
    the card equals the CPU run, directly and with the aggregate stage run
    inside each of the grace join's K = 16 pairs (local mode)."""
    data = {t: tpch.generate_table(t, 0.01) for t in ("lineitem", "orders", "customer")}
    cpu = Session(device="cpu")
    for t, d in data.items():
        cpu.register_numpy(t, d, tpch.SCHEMAS[t])
    want = cpu.collect(tpch.q3())
    fraction, _ = chip_smoke.grace_fraction(cpu, tpch.q3(), 16)
    for grace, conf in ((False, Config()),
                        (True, Config(memory_fraction=fraction * 4 * 2**30
                                      / torch.cuda.get_device_properties(dev).total_memory))):
        gpu = Session(conf=conf)
        for t, d in data.items():
            gpu.register_numpy(t, d, tpch.SCHEMAS[t])
        K.partition_columns.launches = 0
        got = gpu.collect(tpch.q3())
        # the grace run partitions; the direct run's joins are unique
        # builds, whose output needs no compaction
        assert (K.partition_columns.launches > 0) == grace
        assert [n is None for n, _ in gpu.stages] == [False, True]
        assert bool(gpu.grace_runners) == grace
        assert list(got) == list(want)
        for k in want:
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    r = gpu.grace_runners[0]
    assert (r.K, r.downstream[0]) == (16, "local")
    chip_smoke.check_q3(got, chip_smoke.oracle_q3(data["lineitem"], data["orders"],
                                                  data["customer"], tpch._d("1995-03-15")),
                        "card grace")


def test_bucket_times_script_on_card(dev, capsys):
    """tools/bucket_times.py times every shape through the public wrappers."""
    from datafusion_comet_tpu_torch.tools import bucket_times as BT

    assert BT.main(["--sf", "0.1", "--reps", "2"]) == 0
    head, *rows = [json.loads(ln) for ln in capsys.readouterr().out.splitlines()]
    assert "nvidia_smi" in head
    assert [(r["case"], r["kernel"]) for r in rows] == [
        ("q1", "bucket_count"), ("q1", "bucket_sum"), ("q1_one_lane", "bucket_sum"),
        ("pair_16384", "bucket_count"), ("pair_16384", "bucket_sum"),
        ("pair_262144", "bucket_count"), ("pair_262144", "bucket_sum"),
        ("b500_k4", "bucket_sum")]
    assert all(r["ms"] > 0 and r["host_us"] > 0 and r["bound_ms"] > 0 for r in rows)


def test_query_times_script_on_card(dev, capsys):
    """tools/query_times.py runs every query of both trees' comparison and
    profiles every run, with the grace runs at K = 16 (Q18's per-order
    aggregate tiled)."""
    from datafusion_comet_tpu_torch.tools import query_times as QT

    assert QT.main(["--sf", "0.01", "--reps", "2", "--profile"]) == 0
    head, *rows = [json.loads(ln) for ln in capsys.readouterr().out.splitlines()]
    assert "nvidia_smi" in head
    runs = ["q12_direct", "q12_grace", "q3_direct", "q3_grace", "q4_direct", "q4_grace", "q15",
            "q5_direct", "q5_grace", "q10_direct", "q10_grace", "q18_direct", "q18_grace",
            "q2_direct", "q2_grace", "q9_direct", "q9_grace", "q19_direct", "q19_grace",
            "q13_direct", "q13_grace", "q16_direct", "q16_grace", "q20_direct", "q20_grace",
            "q21_direct", "q21_grace", "q22_direct", "q22_grace"]
    names = ["q1", "q6"] + runs
    assert [r.get("query") or r["profile"] for r in rows] == names + names
    assert rows[3]["K"] == 16 and rows[3]["mode"] == "partial"
    assert rows[5]["K"] == 16 and rows[5]["mode"] == "local"
    assert rows[7]["K"] == 16 and rows[7]["mode"] == "partial"
    assert 16 in [r["K"] for r in rows[10]["grace"]]
    assert rows[2]["retries"] == 1  # Q12 direct: the unique-build hint is wrong
    assert rows[0]["launches"]["bucket_sum"] > 0
    assert rows[names.index("q18_grace")]["tiled"]  # its per-order aggregate
    # no fact side reaches the runtime filters' 65,536 rows at SF 0.01
    assert all(r["runtime_filters"] == [] and r["plan_ms"] > 0 for r in rows[:len(names)])
    profiles = dict(zip(names, rows[len(names):]))
    with capsys.disabled():  # each profiled run's device kernels and busy ms, on every run
        print(json.dumps({"device_events": {q: [r["device_events"], r["device_busy_ms"]]
                                            for q, r in profiles.items()}}))
    assert all(r["device_busy_ms"] > 0 for r in profiles.values())
    # at SF 0.01 Q3 direct, Q4 direct, Q15 and Q5 direct call no B3: their
    # joins are unique builds or semi joins, and nothing shrinks 4x
    assert all(profiles[q]["partition_calls"] > 0 for q in runs
               if q.endswith("_grace") or q in ("q12_direct", "q10_direct", "q18_direct"))
    assert all(profiles[q]["aggregate_sort_calls"] > 0 for q in ("q3_direct", "q3_grace"))
    # the TPC-DS suite: every query directly and (but q9 and q28, of
    # nested-loop joins alone) under its grace budget; q88's are its
    # subqueries' joins
    from datafusion_comet_tpu_torch.models import tpcds

    assert QT.main(["--suite", "tpcds", "--sf", "0.02", "--reps", "1"]) == 0
    head, *rows = [json.loads(ln) for ln in capsys.readouterr().out.splitlines()]
    assert head["suite"] == "tpcds"
    s = Session(device="cpu")  # holds the subqueries the plans register
    assert [r["query"] for r in rows] == [
        f"{q}_{run}" for q in tpcds.QUERIES
        for run in (("direct", "grace") if QT.hash_joins(tpcds.plan(q, s), s)
                    else ("direct",))]
    assert all(r["warm_ms"] > 0 for r in rows)
    # chip_smoke's grace queries partition a join at K = 16 here too
    assert set(chip_smoke.TPCDS_GRACE) <= {r["query"][:-len("_grace")] for r in rows
                                           if 16 in [g["K"] for g in r.get("grace", [])]}


def _sessions(dev, tables, conf=None):
    data = {t: tpch.generate_table(t, 0.01) for t in tables}
    cpu, gpu = Session(device="cpu"), Session(conf=conf)
    for s in (cpu, gpu):
        for t, d in data.items():
            s.register_numpy(t, d, tpch.SCHEMAS[t])
    return data, cpu, gpu


def _same(got, want):
    assert list(got) == list(want)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


@pytest.mark.parametrize("path", ["bitmap", "sorted"])
def test_q4_on_card_equals_cpu_and_oracle(dev, path):
    """Q4 on the card: with statistics the bitmap, without the lineitem's
    the sorted build; equal to the CPU run and the numpy oracle; its
    COUNT(*) on B1."""
    from datafusion_comet_tpu_torch.exec.operators.join import hash_join

    data, cpu, gpu = _sessions(dev, ("lineitem", "orders"))
    if path == "sorted":
        del cpu.stats["lineitem"], gpu.stats["lineitem"]
    before = hash_join.semi_paths[path]
    K.bucket_count.launches = 0
    got = gpu.collect(tpch.q4())
    assert hash_join.semi_paths[path] == before + 1 and K.bucket_count.launches > 0
    _same(got, cpu.collect(tpch.q4()))
    chip_smoke.check_q4(got, chip_smoke.oracle_q4(data["lineitem"], data["orders"],
                                                  tpch._d("1993-07-01"), tpch._d("1993-10-01")),
                        "card")


def test_q4_grace_on_card_equals_cpu(dev):
    """Q4 under the budget that picks K = 16: PARTIAL dense aggregates in
    the pairs, one FINAL; B3 partitions both sides."""
    _, cpu, _ = _sessions(dev, ("lineitem", "orders"))
    fraction, _ = chip_smoke.grace_fraction(cpu, tpch.q4(), 16)
    conf = Config(memory_fraction=fraction * 4 * 2**30
                  / torch.cuda.get_device_properties(dev).total_memory)
    _, _, gpu = _sessions(dev, ("lineitem", "orders"), conf)
    K.partition_columns.launches = K.bucket_count.launches = 0
    got = gpu.collect(tpch.q4())
    assert K.partition_columns.launches > 0 and K.bucket_count.launches > 0
    r = gpu.grace_runners[0]
    assert (r.K, r.downstream[0]) == (16, "partial")
    _same(got, cpu.collect(tpch.q4()))


def test_q15_on_card_equals_cpu_and_oracle(dev):
    data, cpu, gpu = _sessions(dev, ("lineitem", "supplier"))
    K.bucket_count.launches = 0
    got = gpu.collect(tpch.q15())
    assert K.bucket_count.launches > 0  # the MAX's presence
    _same(got, cpu.collect(tpch.q15()))
    chip_smoke.check_q15(got, chip_smoke.oracle_q15(data["lineitem"], data["supplier"],
                                                    tpch._d("1996-01-01"),
                                                    tpch._d("1996-04-01")), "card")


def test_q5_on_card_equals_cpu_direct_and_grace(dev):
    """Q5 on the card equals the CPU run and the numpy oracle, directly (its
    revenue per nation on B1 and B2) and with its first join partitioned
    into K = 16 (B3 partitions)."""
    names = ("lineitem", "orders", "customer", "supplier", "nation", "region")
    data, cpu, _ = _sessions(dev, names)
    want = cpu.collect(tpch.q5())
    chip_smoke.check_q5(want, chip_smoke.oracle_q5(*(data[t] for t in names),
                                                   tpch._d("1994-01-01"), tpch._d("1995-01-01")),
                        "cpu")
    fraction, _ = chip_smoke.grace_fraction(cpu, tpch.q5(), 16)
    for grace, conf in ((False, Config()),
                        (True, Config(memory_fraction=fraction * 4 * 2**30
                                      / torch.cuda.get_device_properties(dev).total_memory))):
        _, _, gpu = _sessions(dev, names, conf)
        for name in ("bucket_count", "bucket_sum", "partition_columns"):
            getattr(K, name).launches = 0
        got = gpu.collect(tpch.q5())
        assert K.bucket_count.launches > 0 and K.bucket_sum.launches > 0
        assert (K.partition_columns.launches > 0) == grace
        assert bool(gpu.grace_runners) == grace
        _same(got, want)
        if not grace:
            assert [j["path"] for r in gpu.runs for j in r["joins"]] == (
                ["dense_unique"] * 4 + ["pair_list"])
    assert 16 in [r.K for r in gpu.grace_runners]


@pytest.mark.parametrize("m", [1, 64, 1 << 20])
@pytest.mark.parametrize("is_min", [True, False])
@pytest.mark.parametrize("dtype", [torch.int64, torch.int32])
def test_dense_minmax_on_card_equals_cpu(dev, m, is_min, dtype):
    """The lane-spread MIN/MAX reduction on the card equals the CPU's,
    groups with no row (the identity) and one heavy group included."""
    from datafusion_comet_tpu_torch.exec.operators.aggregate import _minmax_reduce

    rng = np.random.default_rng(m)
    n = 8_388_608
    seg = torch.from_numpy(np.where(rng.random(n) < 0.5, min(m - 1, 3),
                                    rng.integers(0, m + 1, n)).astype(np.int32))
    info = torch.iinfo(dtype)
    x = torch.from_numpy(rng.integers(info.min, info.max, n)).to(dtype)
    want = _minmax_reduce(x, seg, m, is_min)
    got = _minmax_reduce(x.to(dev), seg.to(dev), m, is_min)
    assert torch.equal(got.cpu(), want)


def _string_batch(device):
    """Padded strings of widths 6 and 25 (bytes 0x80 and up, every length),
    a dictionary column, nulls and dead rows, staged on ``device``."""
    from datafusion_comet_tpu_torch import types as PT
    from datafusion_comet_tpu_torch.exec import batch as PB

    rng = np.random.default_rng(11)
    n = 200_003

    def strings(width):
        lens = rng.integers(0, width + 1, n)
        return np.array([bytes(rng.integers(0, 256, k).astype(np.uint8)) for k in lens], object)

    data = {"a": strings(6), "b": strings(25),
            "d": np.array([b"", b"ab", b"abc", b"\x80", b"zz"], object)[rng.integers(0, 5, n)]}
    data["b"][::4] = data["a"][::4]
    schema = PT.Schema([PT.Field("a", PT.string(6)), PT.Field("b", PT.string(25)),
                        PT.Field("d", PT.string(6))])
    validity = {c: rng.random(n) > 0.05 for c in data}
    b = PB.from_numpy(data, schema, device, validity=validity, dict_max_size=16)
    keep = torch.from_numpy(rng.random(b.capacity) > 0.05).to(device)
    return b.with_mask(b.row_mask & keep)


def test_string_ops_on_card_equal_cpu(dev):
    """Padded-string limbs (widths 1 to 55), every comparison (padded of two
    widths, dictionary against padded, a literal), IN, CASE WHEN with a
    string result and murmur3 of strings on the card equal the CPU's."""
    from datafusion_comet_tpu_torch.exec import evaluator as EV
    from datafusion_comet_tpu_torch.exec import sortkeys
    from datafusion_comet_tpu_torch.ir import expr as E

    cpu, gpu = _string_batch("cpu"), _string_batch(dev)
    assert [c.is_dict for c in gpu.columns] == [False, False, True]
    for w in (1, 4, 10, 25, 55):
        n = 100_003
        mat = torch.randint(0, 256, (n, w), dtype=torch.uint8)
        cv = dataclasses.replace(cpu.columns[0], data=mat, validity=torch.ones(n, dtype=torch.bool),
                                 lengths=torch.full((n,), w, dtype=torch.int32))
        want = sortkeys.column_limbs(cv)
        got = sortkeys.column_limbs(dataclasses.replace(
            cv, data=mat.to(dev), validity=cv.validity.to(dev), lengths=cv.lengths.to(dev)))
        assert len(got) == len(want) and all(torch.equal(g.cpu(), x) for g, x in zip(got, want))
        assert torch.equal(sortkeys.lexsort(got).cpu(), sortkeys.lexsort(want))
    exprs = [E.BinaryOp(op, l, r) for op in ("eq", "ne", "lt", "le", "gt", "ge", "eqns")
             for l, r in ((E.col("a"), E.col("b")), (E.col("d"), E.col("b")),
                          (E.col("b"), E.lit("ab")))]
    exprs += [E.InList(E.col("a"), (E.lit("ab"), E.col("d"))),
              E.CaseWhen(((E.col("a") < E.col("b"), E.col("d")),), E.col("b"))]
    for e in exprs:
        want = EV.evaluate(E.bind(e, cpu.schema), cpu)
        got = EV.evaluate(E.bind(e, gpu.schema), gpu)
        for a, b in ((got.data, want.data), (got.validity, want.validity),
                     (got.lengths, want.lengths)):
            assert (a is None) == (b is None) and (a is None or torch.equal(a.cpu(), b)), e
    seed = torch.arange(cpu.capacity, dtype=torch.int32) * 7919
    for c in range(3):
        want = EV.murmur3_column(cpu.columns[c], seed)
        assert torch.equal(EV.murmur3_column(gpu.columns[c], seed.to(dev)).cpu(), want)


@pytest.mark.parametrize("staging", ["default", "padded"])
@pytest.mark.parametrize("q", ["q10", "q18"])
def test_q10_q18_on_card_equal_cpu_direct_and_grace(dev, q, staging):
    """Q10 and Q18 (as the variant with HAVING > 200, which keeps rows at SF
    0.01) on the card equal the CPU runs and the numpy oracles, directly and
    with the first join partitioned into K = 16 (B3 partitions; Q18's
    per-order aggregate tiled first), with the default staging and with
    every string padded."""
    names = ("lineitem", "orders", "customer", "nation")
    data = {t: tpch.generate_table(t, 0.01) for t in names}
    dms = 1 << 16 if staging == "default" else 0
    plan = tpch.q10 if q == "q10" else (lambda: tpch.q18(200))

    def session(device, fraction=None):
        conf = Config(scan_dictionary_max_size=dms,
                      **({"memory_fraction": fraction} if fraction else {}))
        s = Session(device=device, conf=conf)
        for t, d in data.items():
            s.register_numpy(t, d, tpch.SCHEMAS[t])
        return s

    cpu = session("cpu")
    want = cpu.collect(plan())
    if q == "q10":
        chip_smoke.check_q10(want, chip_smoke.oracle_q10(
            data["lineitem"], data["orders"], data["customer"], data["nation"],
            tpch._d("1993-10-01"), tpch._d("1994-01-01")), "cpu")
    else:
        chip_smoke.check_q18(want, chip_smoke.oracle_q18(
            data["lineitem"], data["orders"], data["customer"], 200), "cpu")
    fraction, _ = chip_smoke.grace_fraction(cpu, plan(), 16)
    card_fraction = fraction * 4 * 2**30 / torch.cuda.get_device_properties(dev).total_memory
    for grace, f in ((False, None), (True, card_fraction)):
        gpu = session(None, f)
        K.partition_columns.launches = 0
        _same(gpu.collect(plan()), want)
        assert bool(gpu.grace_runners) == grace
        assert (K.partition_columns.launches > 0) or not grace
        if grace:
            assert 16 in [r.K for r in gpu.grace_runners]
            assert bool(gpu.tiled) == (q == "q18")


def _like_batch(device, width, dms):
    from datafusion_comet_tpu_torch import types as T
    from datafusion_comet_tpu_torch.exec import batch as B

    rng = np.random.default_rng(width)
    vals = np.array(["".join(rng.choice(list("abcx"), rng.integers(0, width + 1)))
                     for _ in range(50_003)], dtype=object)
    vals[::17] = None
    days = rng.integers(-150_000, 150_000, len(vals)).astype(np.int32)
    schema = T.Schema([T.Field("s", T.string(width)), T.Field("d", T.DATE)])
    return B.from_numpy({"s": vals, "d": days}, schema, device, dict_max_size=dms)


@pytest.mark.parametrize("width,dms", [(25, 1 << 16), (1, 0), (10, 0), (25, 0), (55, 0)])
def test_like_and_date_fields_on_card_equal_cpu(dev, width, dms):
    """LIKE over a dictionary column and padded columns of widths 1 to 55
    (prefix, suffix, contains, several segments, '_', only '%', the empty
    pattern, NOT LIKE) and every field of a DATE, on the card equal the
    CPU."""
    from datafusion_comet_tpu_torch.exec import evaluator as EV
    from datafusion_comet_tpu_torch.ir import expr as E

    cpu, gpu = _like_batch("cpu", width, dms), _like_batch(dev, width, dms)
    assert gpu.columns[0].is_dict == (dms > 0)
    exprs = [E.Like(E.col("s"), p, neg) for p in ("ab%", "%ab", "%ab%", "a%b%c", "a_c", "_b%",
                                                  "%a_b%", "%", "", "abc")
             for neg in (False, True)]
    exprs += [E.TemporalFunc(f, (E.col("d"),)) for f in E.DATE_FIELDS]
    for e in exprs:
        want = EV.evaluate(E.bind(e, cpu.schema), cpu)
        got = EV.evaluate(E.bind(e, gpu.schema), gpu)
        assert torch.equal(got.data.cpu(), want.data), e
        assert torch.equal(got.validity.cpu(), want.validity), e


@pytest.mark.parametrize("staging", ["default", "padded"])
@pytest.mark.parametrize("q", ["q2", "q9", "q19"])
def test_q2_q9_q19_on_card_equal_cpu_direct_and_grace(dev, q, staging):
    """Q2 and Q9 at SF 0.01, Q19 at SF 0.05 (where it is not empty) on the
    card equal the CPU runs and the numpy oracles, directly and with the
    first stage's top join partitioned into K = 16, with the default
    staging and with every string padded."""
    names, sf = {"q2": (("part", "supplier", "partsupp", "nation", "region"), 0.01),
                 "q9": (("lineitem", "orders", "part", "partsupp", "supplier", "nation"), 0.01),
                 "q19": (("lineitem", "part"), 0.05)}[q]
    data = {t: tpch.generate_table(t, sf) for t in names}
    dms = 1 << 16 if staging == "default" else 0

    def session(device, fraction=None):
        conf = Config(scan_dictionary_max_size=dms,
                      **({"memory_fraction": fraction} if fraction else {}))
        s = Session(device=device, conf=conf)
        for t, d in data.items():
            s.register_numpy(t, d, tpch.SCHEMAS[t])
        return s

    cpu = session("cpu")
    plan = getattr(tpch, q)
    want = cpu.collect(plan())
    d = data
    if q == "q2":
        chip_smoke.check_q2(want, chip_smoke.oracle_q2(d["part"], d["supplier"], d["partsupp"],
                                                       d["nation"], d["region"]), "cpu")
    elif q == "q9":
        chip_smoke.check_q9(want, chip_smoke.oracle_q9(d["lineitem"], d["part"], d["partsupp"],
                                                       d["supplier"], d["orders"], d["nation"]),
                            "cpu")
    else:
        chip_smoke.check_q19(want, chip_smoke.oracle_q19(d["lineitem"], d["part"]), "cpu")
    fraction, _ = chip_smoke.grace_fraction(cpu, plan(), 16)
    card_fraction = fraction * 4 * 2**30 / torch.cuda.get_device_properties(dev).total_memory
    for grace, f in ((False, None), (True, card_fraction)):
        gpu = session(None, f)
        K.partition_columns.launches = 0
        _same(gpu.collect(plan()), want)
        assert bool(gpu.grace_runners) == grace
        assert (K.partition_columns.launches > 0) or not grace
        if grace:
            assert 16 in [r.K for r in gpu.grace_runners]


@pytest.mark.parametrize("q", ["q3", "q9", "q10"])
def test_runtime_filters_on_card_equal_cpu(dev, q):
    """At SF 0.02 the runtime filter fires (lineitem's 120,000 rows): the
    card injects the same filter as the CPU, compacts its semi output with
    B3, and gives the CPU's answer."""
    from datafusion_comet_tpu_torch.exec.runtime_filter import injected_filters

    names = ("lineitem", "orders", "customer", "supplier", "nation", "region", "part", "partsupp")
    data = tpch.generate_tables(names, 0.02)
    cpu, gpu = Session(device="cpu"), Session()
    for s in (cpu, gpu):
        for t, d in data.items():
            s.register_numpy(t, d, tpch.SCHEMAS[t])
    want = cpu.collect(getattr(tpch, q)())
    K.partition_columns.launches = 0
    _same(gpu.collect(getattr(tpch, q)()), want)
    assert injected_filters(gpu) == injected_filters(cpu) and injected_filters(gpu)
    assert K.partition_columns.launches > 0


# ---- floats and the nested-loop join ----------------------------------------------------

_F_SPECIAL = [0.0, -0.0, np.inf, -np.inf, np.nan, 1.0, -2.5, 1e-310, -5e-324, 1.7e308, 2.0**63,
              -(2.0**31) - 1.0, 123.455]


def _float_data(n: int, seed: int):
    """DOUBLE a, b, FLOAT c (specials, subnormals among them), INT32 i,
    DECIMAL(15,2) d, DOUBLE y (positive, of mixed magnitude), an int64
    group key g, a 5-word string key s; 10% of each null."""
    rng = np.random.default_rng(seed)

    def floats(dtype):
        x = rng.standard_normal(n) * 10.0 ** rng.integers(-3, 13, n)
        pick = rng.random(n) < 0.3
        x[pick] = np.array(_F_SPECIAL)[rng.integers(0, len(_F_SPECIAL), int(pick.sum()))]
        return x.astype(dtype)

    data = {"a": floats(np.float64), "b": floats(np.float64), "c": floats(np.float32),
            "i": rng.integers(-5, 5, n).astype(np.int32),
            "d": rng.integers(-10**12, 10**12, n).astype(np.int64),
            "y": 10.0 ** rng.integers(0, 13, n) * (1.0 + rng.random(n)),
            "g": rng.integers(0, 500, n).astype(np.int64),
            "s": np.array(["aa", "bb", "cc", "dd", "ee"], object)[rng.integers(0, 5, n)]}
    validity = {k: rng.random(n) > 0.1 for k in data}
    schema = PT.Schema([PT.Field("a", PT.FLOAT64), PT.Field("b", PT.FLOAT64),
                            PT.Field("c", PT.FLOAT32), PT.Field("i", PT.INT32),
                            PT.Field("d", PT.decimal(15, 2)), PT.Field("y", PT.FLOAT64),
                            PT.Field("g", PT.INT64), PT.Field("s", PT.string(2))])
    return data, validity, schema


def _bit_same(got, want, rtol=None):
    """Equal numpy columns: floats bit for bit (any NaN equal to any NaN),
    or within ``rtol``; everything else exactly."""
    assert list(got) == list(want)
    for k in want:
        g, w = np.asarray(got[k]), np.asarray(want[k])
        assert g.dtype == w.dtype, k
        if w.dtype.kind == "f":
            np.testing.assert_array_equal(np.isnan(g), np.isnan(w), err_msg=k)
            g, w = g[~np.isnan(w)], w[~np.isnan(w)]
            if rtol is None:
                np.testing.assert_array_equal(g.view(f"i{g.itemsize}"), w.view(f"i{w.itemsize}"),
                                              err_msg=k)
                continue
            np.testing.assert_allclose(g, w, rtol=rtol, atol=0, err_msg=k)
        else:
            np.testing.assert_array_equal(g, w, err_msg=k)


def test_float_sort_limbs_on_card_equal_cpu(dev):
    """The float order limb (-0.0 as 0.0, one NaN above +Inf, subnormals
    kept) and the stable sort by it, on the card and on the CPU."""
    from datafusion_comet_tpu_torch.exec import sortkeys

    data, _, _ = _float_data(100_003, 0)
    for col in ("a", "c"):
        x = torch.from_numpy(data[col])
        want = sortkeys._float_limb(x)
        got = sortkeys._float_limb(x.to(dev))
        assert torch.equal(got.cpu(), want)
        assert torch.equal(torch.argsort(got, stable=True).cpu(), torch.argsort(want, stable=True))


def test_float_expressions_on_card_equal_cpu(dev):
    """Float comparisons, arithmetic (x / 0.0, mod), casts in every mode and
    CASE WHEN on the card, bit for bit the CPU's (IEEE: neither flushes
    subnormals)."""
    from datafusion_comet_tpu_torch.exec import batch as PB
    from datafusion_comet_tpu_torch.exec import evaluator as EV
    from datafusion_comet_tpu_torch.ir import expr as E

    data, validity, schema = _float_data(50_001, 1)
    T = PT
    exprs = [E.col("a") < E.col("b"), E.col("c") == E.col("a"), E.col("a") + E.col("b"),
             E.col("a") * E.col("c"), E.col("a") / E.col("b"), E.col("a") / E.col("i"),
             E.BinaryOp("mod", E.col("a"), E.col("b")), E.BinaryOp("pmod", E.col("c"), E.col("c")),
             E.UnaryOp("isnan", E.col("a")), E.col("d").cast(T.FLOAT64),
             E.CaseWhen(((E.col("a") > E.lit(0.0), E.col("a")), (E.col("i") > E.lit(0),
                                                                 E.col("d"))), E.lit(-0.0))]
    exprs += [E.Cast(E.col(c), to, mode) for c in ("a", "c")
              for to in (T.INT32, T.INT64, T.decimal(15, 2), T.decimal(38, 4), T.FLOAT32)
              for mode in ("LEGACY", "TRY", "ANSI")]
    cpu = PB.from_numpy(data, schema, "cpu", validity=validity)
    gpu = PB.from_numpy(data, schema, dev, validity=validity)
    for e in exprs:
        b = E.bind(e, schema)
        errs = {"cpu": [], "gpu": []}
        want = EV.evaluate(b, cpu, EV.EvalContext(errors=errs["cpu"]))
        got = EV.evaluate(b, gpu, EV.EvalContext(errors=errs["gpu"]))
        ok = want.validity.numpy()
        assert np.array_equal(got.validity.cpu().numpy(), ok), repr(e)
        _bit_same({"x": got.data.cpu().numpy()[ok]}, {"x": want.data.numpy()[ok]})
        for (fg, mg), (fc, mc) in zip(errs["gpu"], errs["cpu"]):
            assert mg == mc and torch.equal(fg.cpu(), fc), repr(e)


@pytest.mark.parametrize("key", ["s", "g", "a", None])
def test_float_aggregates_on_card_equal_cpu(dev, key):
    """SUM, AVG, MIN and MAX of floats on the dense path (a dictionary key),
    the sorted path (an int64 key, a float key) and ungrouped, on the card
    against the CPU: keys, counts, MIN and MAX bit-equal, the per-group
    float sums within 1e-12 (a segmented sum may add in another order on
    the card)."""
    from datafusion_comet_tpu_torch.ir import expr as E
    from datafusion_comet_tpu_torch.ir import plan as P

    data, validity, schema = _float_data(200_003, 2)
    aggs = [E.AggExpr(f, E.col(c), f"{f}_{c}") for f in ("sum", "avg", "min", "max")
            for c in ("a", "c", "y")] + [E.AggExpr("count", None, "n")]
    outs = []
    for device in ("cpu", None):
        s = Session(device=device)
        s.register_numpy("t", data, schema, validity=validity)
        plan = P.Scan("t", schema).aggregate([E.col(key)] if key else [], aggs)
        if key:
            plan = plan.sort([E.SortOrder(E.col(key))])
        outs.append(s.collect(plan))
    want, got = outs
    sums = {k for k in want if k.startswith(("sum_", "avg_")) and not k.endswith("__valid")}
    _bit_same({k: v for k, v in got.items() if k not in sums},
              {k: v for k, v in want.items() if k not in sums})
    _bit_same({k: got[k] for k in sums}, {k: want[k] for k in sums}, rtol=1e-12)


@pytest.mark.parametrize("join_type", ["inner", "left", "right", "full", "left_semi",
                                       "left_anti"])
def test_nested_loop_join_on_card_equals_cpu(dev, join_type):
    """Every join type of the nested-loop join, a float and a string
    condition, on the card against the CPU, row by row."""
    from datafusion_comet_tpu_torch.exec import batch as PB
    from datafusion_comet_tpu_torch.exec.operators import join as J
    from datafusion_comet_tpu_torch.ir import expr as E
    from datafusion_comet_tpu_torch.ir import plan as P

    data, validity, schema = _float_data(300, 3)
    rdata = {f"r{k}": v[:70] for k, v in data.items()}
    rval = {f"r{k}": v[:70] for k, v in validity.items()}
    rschema = PT.Schema([PT.Field(f"r{f.name}", f.dtype) for f in schema.fields])
    node = P.bind_plan(P.BroadcastNestedLoopJoin(
        P.Scan("l", schema), P.Scan("r", rschema), join_type,
        (E.col("a") > E.col("rb")) | (E.col("s") == E.col("rs"))))
    outs = []
    for device in ("cpu", dev):
        left = PB.from_numpy(data, schema, device, validity=validity)
        right = PB.from_numpy(rdata, rschema, device, validity=rval)
        out = J.nested_loop_join(left, right, join_type, node.schema, node.condition)
        outs.append((out.row_mask.cpu(), PB.to_numpy(out)))
    assert torch.equal(outs[0][0], outs[1][0]) and outs[0][0].any()
    _bit_same(outs[1][1], outs[0][1])


@pytest.mark.parametrize("staging", ["default", "padded"])
@pytest.mark.parametrize("q", ["q7", "q8", "q11", "q14", "q17"])
def test_float_queries_on_card_equal_cpu_direct_and_grace(dev, q, staging):
    """Q7, Q11, Q14 and Q17 at SF 0.01, Q8 at SF 0.05 (where its shares are
    not 0.0) on the card equal the CPU runs (FLOAT64 within
    ``chip_smoke.FLOAT_SUM_RTOL``) and the numpy oracles, directly and with
    the first stage's top join partitioned into K = 16, with the default
    staging and with every string padded."""
    sf = 0.05 if q == "q8" else 0.01
    names = ("lineitem", "orders", "customer", "supplier", "nation", "region", "part", "partsupp")
    data = tpch.generate_tables(names, sf)
    dms = 1 << 16 if staging == "default" else 0

    def session(device, fraction=None):
        conf = Config(scan_dictionary_max_size=dms,
                      **({"memory_fraction": fraction} if fraction else {}))
        s = Session(device=device, conf=conf)
        for t, d in data.items():
            s.register_numpy(t, d, tpch.SCHEMAS[t])
        return s

    cpu = session("cpu")
    plan = getattr(tpch, q)
    want = cpu.collect(plan())
    fraction, _ = chip_smoke.grace_fraction(cpu, plan(), 16)
    card_fraction = fraction * 4 * 2**30 / torch.cuda.get_device_properties(dev).total_memory
    for grace, f in ((False, None), (True, card_fraction)):
        gpu = session(None, f)
        K.partition_columns.launches = 0
        _bit_same(gpu.collect(plan()), want, rtol=chip_smoke.FLOAT_SUM_RTOL)
        assert bool(gpu.grace_runners) == grace
        assert (K.partition_columns.launches > 0) or not grace
        if grace:
            assert 16 in [r.K for r in gpu.grace_runners]


# ---- the outer joins, COUNT(DISTINCT); TPC-H Q13, Q16 and Q20 -----------------------------


def _outer_inputs(device, dup: int, shift: int = 0):
    """A fact (probe) batch with null keys and dead rows, and a dim (build)
    batch with null and ``dup``-fold keys, from one seed, on ``device``."""
    from datafusion_comet_tpu_torch.exec import batch as PB

    rng = np.random.default_rng(17)
    nf, nd = 5000, 900
    fact = {"fk": rng.integers(0, 1200, nf).astype(np.int64),
            "fk2": rng.integers(0, 3, nf).astype(np.int32), "x": np.arange(nf, dtype=np.int64)}
    pk = np.repeat(rng.permutation(1200)[:nd // dup], dup).astype(np.int64) + shift
    dim = {"pk": pk, "pk2": rng.integers(0, 3, len(pk)).astype(np.int32),
           "w": rng.integers(-50, 50, len(pk)).astype(np.int64)}
    fs = PT.Schema([PT.Field("fk", PT.INT64), PT.Field("fk2", PT.INT32), PT.Field("x", PT.INT64)])
    ds = PT.Schema([PT.Field("pk", PT.INT64), PT.Field("pk2", PT.INT32), PT.Field("w", PT.INT64)])
    f = PB.from_numpy(fact, fs, device, validity={"fk": rng.random(nf) > 0.05})
    mask = torch.from_numpy(np.pad(rng.random(nf) > 0.1, (0, f.capacity - nf))).to(device)
    d = PB.from_numpy(dim, ds, device, validity={"pk": rng.random(len(pk)) > 0.05})
    return f.with_mask(f.row_mask & mask), d


@pytest.mark.parametrize("path", ["pair_list", "block", "dense_unique", "sorted_unique",
                                  "packed", "no_match"])
@pytest.mark.parametrize("join_type", ["left", "right", "full"])
def test_outer_joins_on_card_equal_cpu(dev, join_type, path):
    """LEFT, RIGHT (build left) and FULL hash joins on each path, with and
    without a condition, on the card equal the CPU run slot for slot."""
    from datafusion_comet_tpu_torch.exec import batch as PB
    from datafusion_comet_tpu_torch.exec.evaluator import EvalContext
    from datafusion_comet_tpu_torch.exec.operators import join as J
    from datafusion_comet_tpu_torch.ir import expr as E

    unique = path in ("dense_unique", "sorted_unique")
    keys = (("fk", "fk2"), ("pk", "pk2")) if path == "packed" else (("fk",), ("pk",))
    kw = {"pair_list": {"compact_rows": 16384}, "block": {"max_build_matches": 4},
          "dense_unique": {"unique_build": True, "build_key_range": (0, 1199)},
          "sorted_unique": {"unique_build": True},
          "packed": {"key_pack": ((0, 1199), (0, 2)), "compact_rows": 16384},
          "no_match": {"compact_rows": 16384}}[path]
    for cond in (None, E.col("w") < E.col("fk2") * E.lit(20)):
        outs = []
        for device in ("cpu", dev):
            f, d = _outer_inputs(device, 1 if unique else 3, 5000 if path == "no_match" else 0)
            (l, lk), (r, rk) = ((d, keys[1]), (f, keys[0])) if join_type == "right" else (
                (f, keys[0]), (d, keys[1]))
            schema = PT.Schema(list(l.schema.fields) + list(r.schema.fields))
            ctx = EvalContext(join_log=[])
            out, ovf = J.hash_join(l, r, [E.bind(E.col(k), l.schema) for k in lk],
                                   [E.bind(E.col(k), r.schema) for k in rk], join_type,
                                   "left" if join_type == "right" else "right", schema,
                                   None if cond is None else E.bind(cond, schema), ctx=ctx, **kw)
            assert not bool(ovf) and ctx.join_log[0]["type"] == join_type
            outs.append((out.row_mask.cpu().numpy(), PB.to_numpy(out)))
        (cpu_mask, want), (gpu_mask, got) = outs
        np.testing.assert_array_equal(gpu_mask, cpu_mask)
        for k in want:
            valid = want[k.split("__")[0] + "__valid"] if not k.endswith("__valid") else None
            np.testing.assert_array_equal(got[k] if valid is None else got[k][valid],
                                          want[k] if valid is None else want[k][valid], err_msg=k)


@pytest.mark.parametrize("staging", ["default", "padded"])
@pytest.mark.parametrize("q", ["q13", "q16", "q20", "q20_variant"])
def test_q13_q16_q20_on_card_equal_cpu_direct_and_grace(dev, q, staging):
    """Q13 (the LEFT join), Q16 (COUNT(DISTINCT)), Q20 and its variant at
    SF 0.01 on the card equal the CPU runs and the numpy oracles, directly
    and with the first stage's top join partitioned into K = 16 (Q20's
    budget corrected by a run, as chip_smoke.py corrects it), with the
    default staging and with every string padded."""
    names = ("lineitem", "orders", "customer", "supplier", "nation", "part", "partsupp")
    data = tpch.generate_tables(names, 0.01)
    dms = 1 << 16 if staging == "default" else 0
    d, day, v = data, tpch._d, chip_smoke.Q20_VARIANT
    expect, check = {
        "q13": (chip_smoke.oracle_q13(d["customer"], d["orders"]), chip_smoke.check_q13),
        "q16": (chip_smoke.oracle_q16(d["part"], d["partsupp"], d["supplier"]),
                chip_smoke.check_q16),
        "q20": (chip_smoke.oracle_q20(d["part"], d["lineitem"], d["partsupp"], d["supplier"],
                                      d["nation"], "forest%", day("1994-01-01"),
                                      day("1995-01-01")), chip_smoke.check_q20),
        "q20_variant": (chip_smoke.oracle_q20(d["part"], d["lineitem"], d["partsupp"],
                                              d["supplier"], d["nation"], v["pattern"],
                                              day(v["ship_from"]), day(v["ship_to"])),
                        chip_smoke.check_q20),
    }[q]

    def session(device, fraction=None):
        conf = Config(scan_dictionary_max_size=dms,
                      **({"memory_fraction": fraction} if fraction else {}))
        s = Session(device=device, conf=conf)
        for t, td in data.items():
            s.register_numpy(t, td, tpch.SCHEMAS[t])
        return s

    cpu = session("cpu")
    plan = (lambda: tpch.q20(**v)) if q == "q20_variant" else getattr(tpch, q)
    want = cpu.collect(plan())
    check(want, expect, f"{q} cpu")
    fraction, _ = chip_smoke.grace_fraction(cpu, plan(), 16)
    card_fraction = fraction * 4 * 2**30 / torch.cuda.get_device_properties(dev).total_memory
    for grace, f in ((False, None), (True, card_fraction)):
        gpu = session(None, f)
        K.partition_columns.launches = 0
        got = gpu.collect(plan())
        _same(got, want)
        check(got, expect, f"{q} card")
        assert bool(gpu.grace_runners) == grace
        assert (K.partition_columns.launches > 0) or not grace
        if grace:
            assert 16 in [r.K for r in gpu.grace_runners]


@pytest.mark.parametrize("path", ["minmax_dense", "minmax_sorted", "pairs"])
def test_semi_cond_joins_on_card_equal_cpu(dev, path):
    """LEFT SEMI, LEFT ANTI and EXISTENCE joins with a condition on each
    path (the dense min/max table, the sorted build's runs, the pairs) on
    the card equal the CPU run row for row, each op of the pushdown."""
    from datafusion_comet_tpu_torch.exec import batch as PB
    from datafusion_comet_tpu_torch.exec.evaluator import EvalContext
    from datafusion_comet_tpu_torch.exec.operators import join as J
    from datafusion_comet_tpu_torch.ir import expr as E
    from datafusion_comet_tpu_torch.ir import plan as PP

    rng = np.random.default_rng(21)
    n_p, n_b = 50_000, 200_000
    stride = 1 << 20 if path == "minmax_sorted" else 1
    probe = {"pk": rng.integers(0, 40_000, n_p) * stride, "pv": rng.integers(0, 100, n_p)}
    build = {"bk": rng.integers(0, 40_000, n_b) * stride, "bv": rng.integers(0, 100, n_b)}
    pv = {c: rng.random(n_p) > 0.05 for c in probe}
    bv = {c: rng.random(n_b) > 0.05 for c in build}
    ps = PT.Schema([PT.Field("pk", PT.INT64), PT.Field("pv", PT.INT64)])
    bs = PT.Schema([PT.Field("bk", PT.INT64), PT.Field("bv", PT.INT64)])
    krange = (int(build["bk"].min()), int(build["bk"].max()))
    if path == "pairs":
        conds = [(E.col("bv") != E.col("pv")) & (E.col("bv") > E.lit(50))]
    else:
        conds = [getattr(E.col("bv"), m)(E.col("pv")) for m in
                 ("__ne__", "__lt__", "__le__", "__gt__", "__ge__")]
        conds.append(E.col("pv") + E.lit(3) < E.col("bv"))
    for jt in ("left_semi", "left_anti", "existence"):
        for cond in conds:
            outs = []
            for device in ("cpu", dev):
                p = PB.from_numpy(probe, ps, device, validity=pv)
                b = PB.from_numpy(build, bs, device, validity=bv)
                plan = PP.bind_plan(PP.HashJoin(PP.Scan("p", ps), PP.Scan("b", bs),
                                                (E.col("pk"),), (E.col("bk"),), jt, "right",
                                                condition=cond))
                ctx = EvalContext(join_log=[])
                out, ovf = J.hash_join(p, b, plan.left_keys, plan.right_keys, jt, "right",
                                       plan.schema, plan.condition, max_build_matches=64,
                                       ctx=ctx, build_key_range=krange,
                                       cond_col_ranges={"bv": (0, 99)})
                assert not bool(ovf) and [j["path"] for j in ctx.join_log] == [path]
                outs.append((out.row_mask.cpu().numpy(), PB.to_numpy(out)))
            (cpu_mask, want), (gpu_mask, got) = outs
            np.testing.assert_array_equal(gpu_mask, cpu_mask)
            kept = want["exists"] if jt == "existence" else cpu_mask
            assert 0 < kept.sum() < n_p  # neither side of the split is empty
            _same(got, want)


@pytest.mark.parametrize("encoding", ["dict", "padded"])
def test_substring_on_card_equals_cpu(dev, encoding):
    """substring over a dictionary's entries and over padded bytes on the
    card equals the CPU run, every position in -16..16 and length in
    -1..16."""
    from datafusion_comet_tpu_torch.exec import batch as PB
    from datafusion_comet_tpu_torch.exec.evaluator import evaluate
    from datafusion_comet_tpu_torch.ir import expr as E

    rng = np.random.default_rng(22)
    vals = np.array([f"{i:0{rng.integers(0, 13)}d}"[-12:] if i % 7 else "" for i in
                     rng.integers(0, 10**6, 5000)], object)
    valid = rng.random(5000) > 0.1
    schema = PT.Schema([PT.Field("s", PT.string(12))])
    dms = 1 << 16 if encoding == "dict" else 0
    bs = [PB.from_numpy({"s": vals}, schema, d, validity={"s": valid}, dict_max_size=dms)
          for d in ("cpu", dev)]
    assert all(b.columns[0].is_dict == (encoding == "dict") for b in bs)
    for pos in range(-16, 17):
        for n in range(-1, 17):
            e = E.bind(E.StringFunc("substring", (E.col("s"), E.lit(pos), E.lit(n))), schema)
            want, got = (evaluate(e, b) for b in bs)
            for a, b in ((want.data, got.data), (want.lengths, got.lengths),
                         (want.validity, got.validity)):
                assert torch.equal(a, b.cpu()), (pos, n)


@pytest.mark.parametrize("staging", ["default", "padded"])
@pytest.mark.parametrize("q", ["q21", "q22"])
def test_q21_q22_on_card_equal_cpu_direct_and_grace(dev, q, staging):
    """Q21 (a LEFT SEMI and a LEFT ANTI join with a condition) and Q22
    (substring, the nested-loop join against the average) at SF 0.01 on the
    card equal the CPU runs and the numpy oracles, directly and with the
    first stage's top join partitioned into K = 16, with the default
    staging and with every string padded; Q21's joins with a condition take
    the dense min/max table on both devices, in a stage and in the pairs."""
    data = tpch.generate_tables(("lineitem", "orders", "customer", "supplier", "nation"), 0.01)
    dms = 1 << 16 if staging == "default" else 0
    d = data
    expect, check = {
        "q21": (chip_smoke.oracle_q21(d["lineitem"], d["orders"], d["supplier"], d["nation"]),
                chip_smoke.check_q21),
        "q22": (chip_smoke.oracle_q22(d["customer"], d["orders"]), chip_smoke.check_q22),
    }[q]

    def session(device, fraction=None):
        conf = Config(scan_dictionary_max_size=dms,
                      **({"memory_fraction": fraction} if fraction else {}))
        s = Session(device=device, conf=conf)
        for t, td in data.items():
            s.register_numpy(t, td, tpch.SCHEMAS[t])
        return s

    cpu = session("cpu")
    plan = getattr(tpch, q)
    want = cpu.collect(plan())
    check(want, expect, f"{q} cpu")
    fraction, _ = chip_smoke.grace_fraction(cpu, plan(), 16)
    card_fraction = fraction * 4 * 2**30 / torch.cuda.get_device_properties(dev).total_memory
    for grace, f in ((False, None), (True, card_fraction)):
        gpu = session(None, f)
        K.partition_columns.launches = 0
        got = gpu.collect(plan())
        _same(got, want)
        check(got, expect, f"{q} card")
        assert bool(gpu.grace_runners) == grace
        assert (K.partition_columns.launches > 0) or not grace
        if grace:
            assert 16 in [r.K for r in gpu.grace_runners]
        if q == "q21":
            joins = chip_smoke.semi_cond_joins(gpu)
            assert {j["path"] for j in joins} == {"minmax_dense"}
            assert {j["type"] for j in joins} == {"left_semi", "left_anti"}


# ---- TPC-DS: the 81 ported queries, Union, Expand, NOT and the null tests -------------

TPCDS_CARD_SF = 0.1


@pytest.fixture(scope="module")
def tpcds_sessions():
    """(CPU session, card session) over all 24 TPC-DS tables at SF 0.1."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from datafusion_comet_tpu_torch.models import tpcds

    cpu, gpu = Session(device="cpu"), Session()
    for t in tpcds.SCHEMAS:
        d = tpcds.generate_table(t, TPCDS_CARD_SF)
        for s in (cpu, gpu):
            s.register_numpy(t, d, tpcds.SCHEMAS[t])
    return cpu, gpu


def _tpcds_names():
    from datafusion_comet_tpu_torch.models import tpcds

    return list(tpcds.QUERIES)


@pytest.mark.parametrize("q", _tpcds_names())
def test_tpcds_on_card_equals_cpu(tpcds_sessions, q):
    """Each ported TPC-DS query at SF 0.1 on the card equals its CPU run
    (``chip_smoke.same_rows``: FLOAT64 within ``FLOAT_SUM_RTOL``, a float
    sum adding in another order on the card; q65's rows as a multiset: its
    sort keys tie), and an oracle query equals chip_smoke's numpy
    oracle."""
    from datafusion_comet_tpu_torch.models import tpcds

    cpu, gpu = tpcds_sessions
    want, got = cpu.collect(tpcds.plan(q, cpu)), gpu.collect(tpcds.plan(q, gpu))
    cols = [c for c in want if not c.endswith("__valid")]
    assert chip_smoke.same_rows(want, got, ordered=q not in chip_smoke.TPCDS_TIED_ORDER), (
        chip_smoke.out_rows(want, cols)[:3], chip_smoke.out_rows(got, cols)[:3])
    if q in chip_smoke.TPCDS_ORACLES:
        data = {t: tpcds.generate_table(t, TPCDS_CARD_SF) for t in tpcds.tables(q)}
        chip_smoke.check_tpcds(q, got, chip_smoke.TPCDS_ORACLES[q][0](data), f"{q} card")


def _union_expand_tables():
    """Two seeded tables of one schema: a dictionary string, a nullable
    int and bool, a decimal(38, 2) narrow in ``a`` and two-limb in ``b``."""
    rng = np.random.default_rng(9)
    schema = PT.Schema([PT.Field("k", PT.INT32, False), PT.Field("s", PT.string(6), False),
                        PT.Field("n", PT.INT64), PT.Field("f", PT.BOOL),
                        PT.Field("d", PT.decimal(38, 2), False)])
    out = {}
    for name, big in (("a", False), ("b", True)):
        k = rng.integers(-50, 50, 3000)
        dec = rng.integers(-10**6, 10**6, 3000).astype(object)
        if big:
            dec[::7] = [int(v) * 10**22 for v in dec[::7]]
        out[name] = ({"k": k.astype(np.int32),
                      "s": np.array([f"{name}{v % 13}" for v in k], object),
                      "n": rng.integers(0, 9, 3000).astype(np.int64),
                      "f": rng.integers(0, 2, 3000).astype(bool), "d": dec},
                     {"n": rng.random(3000) > 0.3, "f": rng.random(3000) > 0.3})
    return schema, out


@pytest.mark.parametrize("dms", [1 << 16, 0])
@pytest.mark.parametrize("case", ["union", "union_agg", "rollup", "not_null"])
def test_union_expand_not_on_card_equal_cpu(dev, case, dms):
    """Union (two dictionaries, mixed decimal storage), Expand (a ROLLUP
    with typed null literals beside dictionary and padded strings, under an
    aggregate and a sort), NOT, IS [NOT] NULL, ``if_`` and ``coalesce`` on
    the card equal the CPU, with the default staging and every string
    padded."""
    from datafusion_comet_tpu_torch.ir import expr as PE

    schema, tables = _union_expand_tables()
    sessions = [Session(device=d, conf=Config(scan_dictionary_max_size=dms))
                for d in ("cpu", None)]
    for s in sessions:
        for name, (data, valid) in tables.items():
            s.register_numpy(name, data, schema, validity=valid)

    def scan(name):
        return PP.Scan(name, schema)

    def plan():
        u = PP.Union((scan("a").filter(PE.col("k") > 0), scan("b")))
        if case == "union":
            return u
        if case == "union_agg":
            return u.aggregate([PE.col("s")], [PE.AggExpr("sum", PE.col("d"), "sd")]).sort(
                [PE.SortOrder(PE.col("sd"), ascending=False), PE.SortOrder(PE.col("s"))])
        if case == "rollup":
            projs = ((PE.col("s"), PE.col("k"), PE.lit(0), PE.col("d")),
                     (PE.col("s"), PE.lit(None, PT.INT32), PE.lit(1), PE.col("d")),
                     (PE.lit(None, PT.string(6)), PE.lit(None, PT.INT32), PE.lit(2),
                      PE.col("d")))
            r = PP.Expand(scan("b").filter(PE.col("k") > -20), projs, ("s", "k", "tag", "d"))
            agg = r.aggregate([PE.col("s"), PE.col("k"), PE.col("tag")],
                              [PE.AggExpr("avg", PE.col("d"), "ad"),
                               PE.AggExpr("count", None, "c")])
            return agg.sort([PE.SortOrder(PE.col("s")), PE.SortOrder(PE.col("k"))], fetch=50)
        n, f = PE.col("n"), PE.col("f")
        return scan("a").filter(~(f & (n > 6)) | n.is_null()).project([
            PE.col("k"), (~f).alias("not_f"), n.is_null().alias("nn"),
            f.is_not_null().alias("fnn"), PE.if_(~(n > 4), PE.lit(1), PE.lit(0)).alias("i"),
            PE.coalesce(n, PE.col("k").cast(PT.INT64), 0).alias("co"),
            PE.col("d").cast(PT.INT32).alias("di")])

    want, got = (s.collect(plan()) for s in sessions)
    _same(got, want)


def _window_table(n: int = 20_000):
    """A seeded table for the window functions: nullable partition and
    order keys (ties), int64, DOUBLE and decimal values with nulls, a
    dictionary string, and a bool the filter under the window keeps (its
    dead rows)."""
    rng = np.random.default_rng(14)
    schema = PT.Schema([PT.Field("keep", PT.BOOL), PT.Field("g", PT.INT32),
                        PT.Field("k", PT.INT32), PT.Field("x", PT.INT64),
                        PT.Field("f", PT.FLOAT64), PT.Field("d", PT.decimal(7, 2)),
                        PT.Field("s", PT.string(4))])
    data = {"keep": rng.random(n) > 0.15, "g": rng.integers(0, 40, n).astype(np.int32),
            "k": rng.integers(0, 300, n).astype(np.int32),
            "x": rng.integers(-1000, 1000, n).astype(np.int64),
            "f": rng.normal(0, 100, n), "d": rng.integers(-99999, 99999, n).astype(np.int64),
            "s": np.array(["a", "bb", "ccc", "dddd"], object)[rng.integers(0, 4, n)]}
    valid = {c: rng.random(n) > 0.1 for c in ("g", "k", "x", "f", "d")}
    return schema, data, valid


_WINDOW_CASES = {
    "ranking": [(f, None, None, 3 if f == "ntile" else 1) for f in
                ("row_number", "rank", "dense_rank", "percent_rank", "cume_dist", "ntile")],
    "lag_lead": [("lag", "x", None, 1), ("lead", "x", None, 2), ("lag", "d", None, 1),
                 ("lead", "f", None, 1), ("lag", "s", None, 1), ("nth_value", "x", None, 2)],
    "running_rows": [(f, c, ("rows", None, 0), 1) for f, c in
                     (("count", None), ("sum", "x"), ("avg", "x"), ("min", "x"), ("max", "x"),
                      ("sum", "f"), ("avg", "f"), ("min", "f"), ("max", "f"), ("sum", "d"),
                      ("first", "x"), ("last", "x"))],
    "running_range": [(f, c, ("range", None, 0), 1) for f, c in
                      (("count", "x"), ("sum", "x"), ("avg", "f"), ("max", "d"),
                       ("first", "x"), ("last", "x"))],
    "whole": [(f, c, ("rows", None, None), 1) for f, c in
              (("count", None), ("sum", "x"), ("avg", "f"), ("sum", "f"), ("min", "f"),
               ("max", "x"), ("avg", "d"), ("sum", "d"))],
    "sliding_rows": [(f, c, fr, 1) for fr in (("rows", -2, 1), ("rows", None, 3),
                                               ("rows", -1, None))
                     for f, c in (("sum", "x"), ("avg", "f"), ("count", "x"))]
    + [(f, "x", ("rows", -3, 2), 1) for f in ("min", "max")],
    "range_offsets": [(f, "x", fr, 1) for fr in (("range", 5, 5), ("range", None, 2),
                                                  ("range", 7, None))
                      for f in ("sum", "count", "avg")],
}


@pytest.mark.parametrize("case", sorted(_WINDOW_CASES))
def test_window_functions_on_card_equal_cpu(dev, case):
    """``window_op`` for every function and frame of the module on the card
    equals the CPU: exact, but a float sum or average within
    ``FLOAT_SUM_RTOL`` (the doubling scan's rows add alike; a float
    division on the card may differ in the last bit)."""
    from datafusion_comet_tpu_torch.ir import expr as PE

    schema, data, valid = _window_table()
    sessions = [Session(device=d) for d in ("cpu", None)]
    for s in sessions:
        s.register_numpy("t", data, schema, validity=valid)
    kw = dict(partition_by=(PE.col("g"),), order_by=(PE.SortOrder(PE.col("k")),))
    if case == "range_offsets":
        kw["order_by"] = (PE.SortOrder(PE.col("k"), ascending=False),)
    wexprs = tuple(PE.WindowExpr(f, None if c is None else PE.col(c), f"w{i}", offset=off,
                                 frame=PE.WindowFrame(*fr) if fr else PE.WindowFrame(), **kw)
                   for i, (f, c, fr, off) in enumerate(_WINDOW_CASES[case]))
    plan = PP.Window(PP.Scan("t", schema).filter(PE.col("keep")), wexprs)
    want, got = (s.collect(plan) for s in sessions)
    assert list(got) == list(want)
    for k in want:
        if want[k].dtype == np.float64:
            np.testing.assert_allclose(got[k], want[k], rtol=chip_smoke.FLOAT_SUM_RTOL, atol=0,
                                       err_msg=k)
        else:
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)


# ---- the other scalar aggregates, the bloom filter, scalar subqueries -----------------


def _scalar_agg_table(n: int = 50_000):
    """Keys k (dictionary, 5 words) and a (int64, 3,000 values); values i
    int32, l int64, b bool, s string, f and y DOUBLE, each with nulls."""
    rng = np.random.default_rng(15)
    schema = PT.Schema([PT.Field("k", PT.string(2)), PT.Field("a", PT.INT64),
                        PT.Field("i", PT.INT32), PT.Field("l", PT.INT64), PT.Field("b", PT.BOOL),
                        PT.Field("s", PT.string(8)), PT.Field("f", PT.FLOAT64),
                        PT.Field("y", PT.FLOAT64)])
    f = rng.normal(0.0, 10.0, n)
    data = {"k": np.array(["x", "yy", "zz", "q", "rr"], object)[rng.integers(0, 5, n)],
            "a": rng.integers(0, 3000, n).astype(np.int64),
            "i": rng.integers(-1000, 1000, n).astype(np.int32),
            "l": rng.integers(-2**62, 2**62, n).astype(np.int64), "b": rng.random(n) > 0.3,
            "s": np.array([f"w{v}" for v in range(500)], object)[rng.integers(0, 500, n)],
            "f": f, "y": 0.5 * f + rng.normal(0.0, 3.0, n)}
    valid = {c: rng.random(n) > 0.1 for c in ("i", "l", "b", "s", "f", "y")}
    return schema, data, valid


def _scalar_aggs():
    from datafusion_comet_tpu_torch.ir import expr as PE

    out = [PE.AggExpr(f, PE.col(c), f"{f}_{c}") for f in ("first", "last") for c in ("i", "s")]
    out += [PE.AggExpr("first", PE.col("l"), "first_l_nulls", ignore_nulls=False)]
    out += [PE.AggExpr(f, PE.col("l"), f"{f}_l") for f in ("bit_and", "bit_or", "bit_xor")]
    out += [PE.AggExpr(f, PE.col("b"), f"{f}_b") for f in ("bool_and", "bool_or", "min", "max")]
    out += [PE.AggExpr(f, PE.col("s"), f"{f}_s") for f in ("min", "max")]
    out += [PE.AggExpr(f, PE.col("f"), f"{f}_fy", extra=(PE.col("y"),))
            for f in ("covar_samp", "covar_pop", "corr")]
    return out


@pytest.mark.parametrize("staging", ["default", "padded"])
@pytest.mark.parametrize("key", ["k", "a", None])
def test_scalar_aggregates_on_card_equal_cpu(dev, key, staging):
    """The new aggregate functions on the dense path (k), the sorted path
    (a) and ungrouped, strings dictionary-coded or padded: the card equals
    the CPU (the covariance family within ``FLOAT_SUM_RTOL``: a float sum
    adds in another order on the card)."""
    from datafusion_comet_tpu_torch.ir import expr as PE

    schema, data, valid = _scalar_agg_table()
    dms = 1 << 16 if staging == "default" else 0
    sessions = [Session(device=d, conf=Config(scan_dictionary_max_size=dms))
                for d in ("cpu", None)]
    for s in sessions:
        s.register_numpy("t", data, schema, validity=valid)
    plan = PP.Scan("t", schema).aggregate([PE.col(key)] if key else [], _scalar_aggs())
    if key:
        plan = plan.sort([PE.SortOrder(PE.col(key))])
    want, got = (s.collect(plan) for s in sessions)
    _bit_same(got, want, rtol=chip_smoke.FLOAT_SUM_RTOL)


def test_scalar_aggregates_under_grace_on_card_equal_cpu(dev):
    """The order-free new aggregates over a grace join of K = 16 in partial
    mode (each pair's PARTIAL states, one FINAL) on the card: the CPU's
    direct answer."""
    from datafusion_comet_tpu_torch.ir import expr as PE

    schema, data, valid = _scalar_agg_table()
    dim_schema = PT.Schema([PT.Field("pk", PT.INT64), PT.Field("g", PT.string(6))])
    dim = {"pk": np.arange(3000, dtype=np.int64),
           "g": np.array(["east", "north", "south", "west"], object)[np.arange(3000) % 4]}

    def session(device, fraction=None):
        s = Session(device=device, conf=Config(memory_fraction=fraction) if fraction else None)
        s.register_numpy("t", data, schema, validity=valid)
        s.register_numpy("dim", dim, dim_schema)
        return s

    aggs = [a for a in _scalar_aggs() if a.func not in ("first", "last")]
    plan = PP.HashJoin(PP.Scan("t", schema), PP.Scan("dim", dim_schema), (PE.col("a"),),
                       (PE.col("pk"),)).aggregate([PE.col("g")], aggs).sort(
        [PE.SortOrder(PE.col("g"))])
    cpu = session("cpu")
    want = cpu.collect(plan)
    fraction, _ = chip_smoke.grace_fraction(cpu, plan, 16)
    gpu = session(None, fraction * 4 * 2**30 / torch.cuda.get_device_properties(dev).total_memory)
    got = gpu.collect(plan)
    assert [(r.K, r.downstream[0]) for r in gpu.grace_runners] == [(16, "partial")]
    _bit_same(got, want, rtol=chip_smoke.FLOAT_SUM_RTOL)


def test_bloom_filter_and_probe_on_card_equal_cpu_and_oracle(dev):
    """A BLOOM_FILTER of Spark's default size (8,388,608 bits, 1,000,000
    expected items: k = 6) over 5% of 200,000 keys, through a scalar
    subquery, probed over 2,000,000 rows: the filter's bytes equal the CPU's
    and chip_smoke's numpy oracle, no key is a false negative, and the rows
    kept are the oracle's."""
    from datafusion_comet_tpu_torch.ir import expr as PE

    rng = np.random.default_rng(16)
    keys = np.arange(1, 200_001, dtype=np.int64)
    pick = rng.random(len(keys)) < 0.05
    probe = rng.integers(1, 200_001, 2_000_000).astype(np.int64)
    bsch = PT.Schema([PT.Field("k", PT.INT64), PT.Field("pick", PT.BOOL)])
    psch = PT.Schema([PT.Field("x", PT.INT64)])
    outs = []
    for device in ("cpu", None):
        s = Session(device=device)
        s.register_numpy("build", {"k": keys, "pick": pick}, bsch)
        s.register_numpy("probe", {"x": probe}, psch)
        sub = s.scalar_subquery(PP.Scan("build", bsch).filter(PE.col("pick")).aggregate(
            [], [PE.AggExpr("bloom_filter", PE.col("k"), "f", num_bits=chip_smoke.BLOOM_BITS,
                            extra=(PE.lit(chip_smoke.BLOOM_ITEMS),))]))
        kept = s.collect(PP.Scan("probe", psch).filter(PE.BloomMightContain(sub, PE.col("x"))))
        outs.append((s.subqueries[0]["value"], kept["x"]))
    want = chip_smoke.bloom_oracle(keys[pick], 6, chip_smoke.BLOOM_BITS)
    assert outs[0][0] == outs[1][0] == want
    hit = chip_smoke.bloom_probe_oracle(want, probe)
    assert hit[np.isin(probe, keys[pick])].all()
    for _, kept in outs:
        np.testing.assert_array_equal(kept, probe[hit])


@pytest.mark.parametrize("q", ["q88", "q90_scalar"])
def test_scalar_subquery_queries_on_card_equal_cpu_direct_and_grace(tpcds_sessions, q):
    """q88 (eight subqueries) and q90_scalar (two) on the card equal the CPU
    and chip_smoke's numpy oracle, directly and, for q88, with each
    subquery's top join partitioned into K = 16 pairs; every execute runs
    each subquery once."""
    from datafusion_comet_tpu_torch.models import tpcds
    from datafusion_comet_tpu_torch.tools import query_times as QT

    cpu, gpu = tpcds_sessions
    build = (lambda s: tpcds.plan(q, s)) if q == "q88" else tpcds.q90_scalar
    want, got = cpu.collect(build(cpu)), gpu.collect(build(gpu))
    assert chip_smoke.same_rows(want, got)
    assert len(gpu.subqueries) == (8 if q == "q88" else 2)
    data = {t: tpcds.generate_table(t, TPCDS_CARD_SF)
            for t in ("time_dim", "web_sales", "store_sales", "household_demographics", "store")}
    oracle = chip_smoke.oracle_ds_q88 if q == "q88" else chip_smoke.oracle_ds_q90_scalar
    cols = [c for c in want if not c.endswith("__valid")]
    assert chip_smoke.out_rows(got, cols) == oracle(data)
    if q == "q88":
        fraction, _ = chip_smoke.grace_fraction(gpu, build(gpu), 16)
        grace = QT.grace_session(gpu, fraction)
        assert chip_smoke.same_rows(want, grace.collect(build(grace)))
        assert all(16 in [r.K for r in sq["grace_runners"]] for sq in grace.subqueries)


# ---- the special aggregates, SortMergeJoin's merge path, NOT IN, prepare -------------


def _special_table():
    rng = np.random.default_rng(61)
    n = 200_000
    g = rng.integers(0, 5, n)
    data = {"k": np.array(["v", "w", "x", "y", "z"], object)[g],
            "a": rng.integers(0, 3000, n).astype(np.int64),
            "x": rng.integers(-10**6, 10**6, n).astype(np.int64),
            "f": rng.normal(size=n) * 1e3, "d": rng.integers(-10**8, 10**8, n).astype(object)}
    schema = PT.Schema([PT.Field("k", PT.string(4)), PT.Field("a", PT.INT64),
                        PT.Field("x", PT.INT64), PT.Field("f", PT.FLOAT64),
                        PT.Field("d", PT.decimal(12, 2))])
    valid = {c: rng.random(n) > 0.1 for c in ("x", "f", "d")}
    return data, schema, valid


@pytest.mark.parametrize("key", [None, "k", "a"], ids=["ungrouped", "dense", "sorted"])
def test_special_aggregates_on_card_equal_cpu(dev, key):
    """median, percentile, approx_count_distinct and approx_percentile
    (SINGLE, and under a budget that tiles the aggregate: PARTIAL states
    merged by a FINAL) on the card equal the CPU exactly."""
    from datafusion_comet_tpu_torch.ir import expr as PE

    data, schema, valid = _special_table()
    aggs = [PE.AggExpr("median", PE.col("d"), "m"),
            PE.AggExpr("percentile", PE.col("f"), "p", extra=(PE.lit(0.25),)),
            PE.AggExpr("approx_count_distinct", PE.col("x"), "h"),
            PE.AggExpr("approx_percentile", PE.col("x"), "q", extra=(PE.lit(0.5),))]
    one = [PE.AggExpr("approx_percentile", PE.col("f"), "q", extra=(PE.lit(0.7),))]

    def plan(a):
        return PP.Scan("t", schema).aggregate([PE.col(key)] if key else [], a)

    from datafusion_comet_tpu_torch.exec.memory import device_budget_bytes, plan_peak_bytes

    outs = []
    for device, tiled in (("cpu", False), (None, False), ("cpu", True), (None, True)):
        s = Session(device=device)
        s.register_numpy("t", data, schema, validity=valid)
        if tiled:  # a budget two tiles fit: PARTIAL states merged by a FINAL
            peak = plan_peak_bytes(s._plan_stages(plan(one))[-1][1], s.tables["t"].capacity)
            s.conf = Config(memory_fraction=peak / 1.5 / device_budget_bytes(s.device, 1.0))
        outs.append(s.collect(plan(one if tiled else aggs)))
        assert bool(s.tiled) == tiled
    assert chip_smoke.same_rows(outs[0], outs[1]) and chip_smoke.same_rows(outs[2], outs[3])


def test_smj_merge_path_and_not_in_on_card_equal_cpu(dev):
    """TPC-H Q12 and Q3 in Spark's SortMergeJoin shape (orders without
    statistics: the sorted builds, which merge) and Q16 with its NOT IN a
    null-aware anti join, at SF 0.1, on the card equal the CPU and the hash
    plans; every sort-merge join merged."""
    names = ("lineitem", "orders", "customer", "part", "partsupp", "supplier")
    data = {t: tpch.generate_table(t, 0.1) for t in names}
    sessions = []
    for device in ("cpu", None):
        s = Session(device=device)
        for t in names:
            s.register_numpy(t, data[t], tpch.SCHEMAS[t])
        del s.stats["orders"], s.stats["customer"]
        sessions.append(s)
    for plan, ref in ((lambda: tpch.q12(sort_merge=True), tpch.q12),
                      (lambda: tpch.q3(sort_merge=True), tpch.q3),
                      (lambda: tpch.q16(null_aware=True), tpch.q16)):
        cpu, card = (s.collect(plan()) for s in sessions)
        assert chip_smoke.same_rows(cpu, card)
        assert chip_smoke.same_rows(card, sessions[1].collect(ref()))
    card = sessions[1]
    card.collect(tpch.q3(sort_merge=True))
    merged = [j.get("merge") for r in card.runs if not r["overflowed"] for j in r["joins"]]
    assert merged and all(merged)


def test_prepare_on_card_equals_collect(dev):
    """Q12 through Session.prepare, directly and under the budget that
    splits its join into K = 16 pairs, at SF 0.1: three calls each equal the
    CPU's collect, and none re-runs."""
    from datafusion_comet_tpu_torch.exec.batch import to_numpy
    from datafusion_comet_tpu_torch.tools.query_times import grace_session

    names = ("lineitem", "orders")
    data = {t: tpch.generate_table(t, 0.1) for t in names}
    cpu, card = Session(device="cpu"), Session()
    for s in (cpu, card):
        for t in names:
            s.register_numpy(t, data[t], tpch.SCHEMAS[t])
    want = cpu.collect(tpch.q12())
    grace = grace_session(card, chip_smoke.grace_fraction(card, tpch.q12())[0])
    for s in (card, grace):
        run = s.prepare(tpch.q12())
        for _ in range(3):
            assert chip_smoke.same_rows(want, to_numpy(run()))
            assert not any(r["overflowed"] for r in s.runs)
    assert [r.K for r in grace.grace_runners] == [chip_smoke.GRACE_K]


def _expr_batches(dev, rng, dms):
    """A CPU and a card batch of the scalar evaluator's columns: instants
    around DST changes and far dates, strings (dictionary-coded where
    ``dms``), integers, narrow and two-limb decimals, doubles, dates."""
    from datafusion_comet_tpu_torch.exec import batch as PB

    n = 3000
    words = np.array(["Hello World", "  pad me ", "", "a.b.c.d", "Robert", "Tymczak",
                      "ab,cd,,ef", "12.5", "-7", "2024-03-10 02:30:00", "1999-12-31", "t",
                      "1110.92", "0.30000000000000004", "UPPER lower"], object)
    strs = words[rng.integers(0, len(words), n)]
    data = {"t": rng.integers(-2_000_000_000, 4_000_000_000, n) * 1_000_000
            + rng.integers(0, 1_000_000, n),
            "s": strs, "i": rng.integers(-40, 40, n).astype(np.int32),
            "dec": rng.integers(-10**9, 10**9, n), "w": np.array(
                [int(x) * 10**20 + 7 for x in rng.integers(-10**6, 10**6, n)], object),
            "g": rng.standard_normal(n) * 10.0 ** rng.integers(-12, 14, n),
            "d": rng.integers(-30000, 30000, n).astype(np.int32)}
    data["g"][:4] = [0.0, -0.0, 5e-324, np.nan]
    schema = PT.Schema([PT.Field("t", PT.TIMESTAMP), PT.Field("s", PT.string(20)),
                        PT.Field("i", PT.INT32), PT.Field("dec", PT.decimal(12, 3)),
                        PT.Field("w", PT.decimal(38, 4)), PT.Field("g", PT.FLOAT64),
                        PT.Field("d", PT.DATE)])
    valid = {"s": rng.random(n) > 0.05, "t": rng.random(n) > 0.05}
    return schema, [PB.from_numpy(data, schema, d, validity=valid, dict_max_size=dms)
                    for d in ("cpu", dev)]


def _scalar_family(E, T, family):
    c = E.col
    if family == "temporal":
        out = [E.TemporalFunc(f, (c("t"),), tz) for f in ("year", "hour", "weekofyear",
                                                         "last_day", "unix_seconds")
               for tz in (None, "America/New_York", "+05:30")]
        out += [E.TemporalFunc("date_trunc", (E.lit(u), c("t")), "Europe/Berlin")
                for u in ("hour", "week", "month", "year")]
        out += [E.TemporalFunc("from_utc_timestamp", (c("t"), E.lit("America/New_York"))),
                E.TemporalFunc("to_utc_timestamp", (c("t"), E.lit("Europe/Berlin"))),
                E.TemporalFunc("add_months", (c("d"), c("i"))),
                E.TemporalFunc("months_between", (c("t"), c("d"))),
                E.TemporalFunc("timestampdiff", (c("t"), c("t")), unit="MONTH"),
                E.TemporalFunc("make_date", (c("i") + E.lit(2000), c("i"), c("i"))),
                E.TemporalFunc("from_unixtime", (c("i"),), "America/New_York")]
        return out
    if family == "casts":
        out = [E.Cast(c(x), T.string(48)) for x in ("i", "dec", "w", "g", "d")]
        out += [E.Cast(c("t"), T.string(32), E.EvalMode.LEGACY, "America/New_York"),
                E.Cast(c("t"), T.DATE, E.EvalMode.LEGACY, "Europe/Berlin")]
        out += [E.Cast(c("s"), to, mode) for to in (T.INT32, T.decimal(10, 2), T.DATE, T.BOOL,
                                                    T.FLOAT64, T.TIMESTAMP)
                for mode in ("LEGACY", "TRY")]
        out.append(E.Cast(E.Cast(c("g"), T.string(32)), T.FLOAT64))
        return out
    if family == "strings":
        fns = [("upper", ()), ("initcap", ()), ("reverse", ()), ("trim", ()),
               ("lpad", (E.lit(12), E.lit("0"))), ("rpad", (E.lit(25), E.lit("xy"))),
               ("repeat", (E.lit(2),)), ("instr", (E.lit("o"),)),
               ("replace", (E.lit("a"), E.lit("4"))), ("translate", (E.lit("lo"), E.lit("L"))),
               ("contains", (E.lit("er"),)), ("levenshtein", (E.lit("Robert"),)),
               ("left", (c("i"),)), ("length", ())]
        out = [E.StringFunc(f, (c("s"),) + a) for f, a in fns]
        out += [E.StringFunc("concat_ws", (E.lit(" "), c("s"), c("s"))),
                E.Soundex(c("s")), E.SubstringIndex(c("s"), ".", 2),
                E.SubstringIndex(c("s"), ".", -1), E.SplitPart(c("s"), ",", -1),
                E.FormatNumber(c("dec"), 2), E.FormatNumber(c("g"), 3, 40)]
        return out
    if family == "hashes":
        return [E.HashFunc(f, (c(x),)) for f in ("murmur3", "xxhash64")
                for x in ("t", "s", "i", "dec", "g", "d")]
    return [E.RandExpr("rand", 5), E.RandExpr("randn", 5), E.MonotonicallyIncreasingId()]


@pytest.mark.parametrize("dms", [1 << 16, 0])
@pytest.mark.parametrize("family", ["temporal", "casts", "strings", "hashes", "rand"])
def test_scalar_evaluator_on_card_equals_cpu(dev, family, dms):
    """Each family of the scalar evaluator on CUDA tensors equals the port's
    CPU run: exactly, but randn (torch's log and sqrt on the card against
    the CPU's) and the doubles of months_between within 1e-13."""
    from datafusion_comet_tpu_torch.exec.evaluator import EvalContext, evaluate
    from datafusion_comet_tpu_torch.ir import expr as E

    schema, (cpu, card) = _expr_batches(dev, np.random.default_rng(31), dms)
    mask = torch.from_numpy(np.random.default_rng(32).random(cpu.capacity) < 0.9)
    cpu, card = cpu.with_mask(cpu.row_mask & mask), card.with_mask(card.row_mask & mask.to(dev))
    for e in _scalar_family(E, PT, family):
        b = E.bind(e, schema)
        want, got = (evaluate(b, x, EvalContext(errors=[])) for x in (cpu, card))
        if want.dictionary is not None:
            want, got = want.decode(), got.decode()
        live = cpu.row_mask & want.validity
        assert torch.equal(want.validity, got.validity.cpu()), e
        if want.lengths is not None:
            assert torch.equal(want.lengths[live], got.lengths.cpu()[live]), e
        w, g = want.data[live], got.data.cpu()[live]
        if w.dtype == torch.float64 and not torch.equal(w, g):
            np.testing.assert_allclose(g.numpy(), w.numpy(), rtol=1e-13, atol=0,
                                       err_msg=repr(e))
        else:
            assert torch.equal(w, g), e


def _canon(v):
    """A collected value with every float as its bits (NaN equal to NaN)."""
    if isinstance(v, float):
        return ("f", np.float64(v).tobytes())
    if isinstance(v, list):
        return [_canon(x) for x in v]
    if isinstance(v, dict):
        return {k: _canon(x) for k, x in v.items()}
    return v.item() if isinstance(v, np.generic) else v


def _same_nested(got, want):
    assert list(got) == list(want)
    for k in want:
        assert [_canon(v) for v in got[k]] == [_canon(v) for v in want[k]], k


def _nested_table():
    rng = np.random.default_rng(5)
    n = 3000
    lists = [None if i % 29 == 3 else
             [None if rng.random() < 0.1 else int(x) for x in rng.integers(0, 40, i % 7)]
             for i in range(n)]
    floats = [None if i % 31 == 1 else [float(x) if x > -1.5 else float("nan")
                                        for x in rng.normal(size=i % 4)] for i in range(n)]
    maps = [None if i % 23 == 2 else {f"k{int(x)}": int(x) for x in rng.integers(0, 9, i % 4)}
            for i in range(n)]
    data = {"id": np.arange(n, dtype=np.int64), "a": lists, "f": floats, "m": maps,
            "x": rng.integers(0, 40, n).astype(np.int64),
            "t": np.array([",".join("w%d" % (j % 5) for j in range(i % 6)) for i in range(n)],
                          dtype=object)}
    schema = PT.Schema([PT.Field("id", PT.INT64), PT.Field("a", PT.list_(PT.INT64, 6)),
                        PT.Field("f", PT.list_(PT.FLOAT64, 3)),
                        PT.Field("m", PT.map_(PT.string(3), PT.INT64, 3)),
                        PT.Field("x", PT.INT64), PT.Field("t", PT.string(20))])
    return data, schema


def _nested_exprs(E):
    A = lambda f, *a: E.ArrayExpr(f, tuple(a))  # noqa: E731
    a, f, m, x = E.col("a"), E.col("f"), E.col("m"), E.col("x")
    v, acc = E.LambdaVar("v"), E.LambdaVar("acc")
    return [
        A("size", a), A("array_contains", a, x), A("array_position", a, x),
        A("element_at", a, E.lit(-1)), A("array_min", f), A("array_max", a), A("sort_array", f),
        A("sort_array", a, E.lit(False)), A("array_distinct", a), A("array_distinct", f),
        A("array_remove", a, x), A("array_append", a, x), A("slice", a, E.lit(2), E.lit(3)),
        A("array_union", a, A("array", x, E.lit(3, PT.INT64))), A("array_except", a, a),
        A("array_reverse", a), A("array_compact", a),
        E.MapExpr("map_keys", (m,)), E.MapExpr("element_at", (m, E.lit("k3"))),
        E.MapExpr("map_from_arrays", (A("array", x, E.lit(1, PT.INT64)), A("array", x, x))),
        E.GetStructField(E.StructExpr((x, a), ("p", "q")), "q"),
        E.HigherOrderFunc("transform", (a,), ("v",), v * 3),
        E.HigherOrderFunc("filter", (a,), ("v",), v > x),
        E.HigherOrderFunc("exists", (a,), ("v",), v > 30),
        E.HigherOrderFunc("aggregate", (a, E.lit(0, PT.INT64)), ("acc", "v"), acc + v),
        E.HigherOrderFunc("array_sort", (f,)),
        E.Split(E.col("t"), ",", 8)]


def test_nested_expressions_on_card_equal_cpu(dev):
    from datafusion_comet_tpu_torch.ir import expr as PE

    data, schema = _nested_table()
    plan = PP.Scan("t", schema).project(
        [PE.Alias(e, f"e{i}") for i, e in enumerate(_nested_exprs(PE))])
    outs = []
    for device in ("cpu", None):
        s = Session(device=device, conf=Config(scan_dictionary_max_size=0))
        s.register_numpy("t", data, schema)
        outs.append(s.collect(plan))
    _same_nested(outs[1], outs[0])


def test_explode_collect_and_percentile_list_on_card_equal_cpu(dev):
    """The four Explode forms over a list and a map, collect_list and
    collect_set (SINGLE, and PARTIAL states merged by a FINAL) and the
    percentile list on the card equal the CPU."""
    from datafusion_comet_tpu_torch.ir import expr as PE

    data, schema = _nested_table()
    scan = PP.Scan("t", schema)
    plans = [PP.Explode(scan.project([PE.col("id"), PE.col(c)]), PE.col(c), o, p)
             for c in ("a", "m") for o in (False, True) for p in (False, True)]
    aggs = [PE.AggExpr("collect_list", PE.col("x"), "cl", max_elems=64),
            PE.AggExpr("collect_set", PE.col("x"), "cs", max_elems=64),
            PE.AggExpr("percentile", PE.col("x"), "p",
                       extra=(PE.lit((0.1, 0.5), PT.list_(PT.FLOAT64, 2)),))]
    key = [PE.Alias(PE.BinaryOp("mod", PE.col("id"), PE.lit(37)), "g")]
    plans.append(scan.project(key + [PE.col("x")]).aggregate([PE.col("g")], aggs).sort(
        [PE.SortOrder(PE.col("g"))]))
    half = PE.col("x") < 20
    parts = [scan.filter(c).project(key + [PE.col("x")]).aggregate(
        [PE.col("g")], aggs[:2], PP.AggMode.PARTIAL) for c in (half, ~half)]
    plans.append(PP.Union(tuple(parts)).aggregate([PE.col("g")], aggs[:2],
                                                  PP.AggMode.FINAL).sort([PE.SortOrder(PE.col("g"))]))
    for plan in plans:
        outs = []
        for device in ("cpu", None):
            s = Session(device=device)
            s.register_numpy("t", data, schema)
            out = s.collect(plan)
            if isinstance(plan, PP.Explode):  # rows as a sorted multiset
                keys = sorted(range(len(out["id"])), key=lambda i: repr(
                    [_canon(out[k][i]) for k in out]))
                out = {k: v[keys] for k, v in out.items()}
            outs.append(out)
        _same_nested(outs[1], outs[0])


def test_explain_on_card_equals_cpu(dev):
    """Session.explain of TPC-H Q3 gives the same operators, live rows,
    capacities and bytes on the card and on the CPU."""
    names = ("lineitem", "orders", "customer")
    data = {t: tpch.generate_table(t, 0.01) for t in names}
    dicts = []
    for device in ("cpu", None):
        s = Session(device=device)
        for t in names:
            s.register_numpy(t, data[t], tpch.SCHEMAS[t])
        d = s.explain(tpch.q3(), with_metrics=True, as_tree=True).to_dict()
        d.pop("elapsed_ms", None)
        dicts.append(d)
    assert dicts[0] == dicts[1]


@pytest.mark.parametrize("rows", [((32,), "int64"), ((16, 40), "uint8")],
                         ids=["int64x32", "strings16x40"])
def test_partition_columns_at_nested_rows_equal_plain(dev, rows):
    """B3 moves (E,) element blocks and (E, L) string element blocks, with
    their counts and validity, exactly as its plain version does, at K = 16
    and as a compaction."""
    shape, dt = rows
    gen = torch.Generator(device=dev)
    gen.manual_seed(3)
    n = 100_003
    tensors = [chip_smoke.random_tensor("int32", (n,), gen, dev),
               chip_smoke.random_tensor("bool", (n, shape[0]), gen, dev),
               chip_smoke.random_tensor(dt, (n,) + shape, gen, dev)]
    codes = torch.randint(0, 17, (n,), dtype=torch.int32, device=dev, generator=gen)
    mask = torch.rand(n, device=dev, generator=gen) < 0.4
    for c, k, limit in ((codes, 16, None), (mask, 1, 65_536)):
        _, err = chip_smoke.check_payload(K, "nested", c, k, tensors, limit=limit)
        assert err == 0


@pytest.mark.parametrize("encoding", ["dict", "padded"])
def test_text_functions_on_card_equal_cpu(dev, encoding):
    """RLIKE (automata on both sides of the JAX package's select-tree
    thresholds), the three device regexp forms, every bytes function and
    digest, get_json_object and json_array_length, a Python UDF and the
    aggregate FILTER clause (a special aggregate's too) on the card equal
    the CPU run over the same seeded table."""
    from datafusion_comet_tpu_torch.ir import expr as E
    from datafusion_comet_tpu_torch.ir import functions as F

    rng = np.random.default_rng(31)
    n = 3000
    words = np.array(["alpha", "beta7", "gamma42", "x@y.com", "", "a1b2c3", "zz top"], object)
    s = np.array([words[i] + str(j) * (j % 5) for i, j in
                  zip(rng.integers(0, len(words), n), rng.integers(0, 10**6, n))], object)
    doc = np.array(['{"k":%d,"t":["a","b%d"],"s":"q\\"x"}' % (i, i % 7) if i % 11 else "[1,2]"
                    for i in range(n)], object)
    data = {"s": s, "doc": doc, "i": rng.integers(-2**40, 2**40, n),
            "g": rng.integers(0, 6, n).astype(np.int64)}
    schema = PT.Schema([PT.Field("s", PT.string(40)), PT.Field("doc", PT.string(48)),
                        PT.Field("i", PT.INT64), PT.Field("g", PT.INT64)])
    valid = {"s": rng.random(n) > 0.05, "doc": rng.random(n) > 0.05}
    c = E.col
    exprs = [E.RLike(c("s"), "[a-z]+\\d"), E.RLike(c("s"), "abcdefghijklmnopqrstuvwxyz", True),
             E.RegexpExtract(c("s"), "([a-z]+)(\\d+)", 2), E.RegexpExtractAll(c("s"), "\\d", 0, 40),
             E.RegexpReplace(c("s"), "\\d+", "#"), F.python_udf(lambda v: v and v[::-1],
                                                              [c("s")], PT.string(40)),
             E.StringFunc("hex", (c("s"),)), E.StringFunc("hex", (c("i"),)),
             E.StringFunc("unhex", (E.StringFunc("hex", (c("s"),)),)),
             E.StringFunc("base64", (c("s"),)), E.StringFunc("unbase64", (c("s"),)),
             E.StringFunc("bin", (c("i"),)),
             E.StringFunc("conv", (E.Cast(c("i"), PT.string(24)), E.lit(10), E.lit(-16))),
             E.StringFunc("crc32", (c("s"),)), E.StringFunc("md5", (c("s"),)),
             E.StringFunc("sha1", (c("s"),))]
    exprs += [E.StringFunc("sha2", (c("s"), E.lit(b))) for b in (224, 256, 384, 512)]
    exprs += [F.get_json_object(c("doc"), "$.t[1]"), F.get_json_object(c("doc"), "$.s"),
              F.json_array_length(c("doc"))]
    proj = PP.Scan("t", schema).project([x.alias(f"e{k}") for k, x in enumerate(exprs)])
    agg = PP.Scan("t", schema).aggregate([c("g")], [
        E.AggExpr("count", None, "n", filter=E.RLike(c("s"), "\\d{3}")),
        E.AggExpr("sum", c("i"), "si", filter=E.RLike(c("s"), "^a")),
        E.AggExpr("median", c("i"), "md", filter=c("i") > E.lit(0))]).sort(
        [E.SortOrder(c("g"))])
    dms = 1 << 16 if encoding == "dict" else 0
    outs = []
    for d in ("cpu", dev):
        sess = Session(device=d, conf=Config(scan_dictionary_max_size=dms))
        sess.register_numpy("t", data, schema, validity=valid)
        outs.append((sess.collect(proj), sess.collect(agg)))
    for want, got in zip(*outs):
        assert list(want) == list(got)
        for k in want:
            if want[k].dtype == object:
                assert [repr(v) for v in want[k]] == [repr(v) for v in got[k]], k
            else:
                np.testing.assert_array_equal(want[k], got[k], err_msg=k)

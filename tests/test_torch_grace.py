"""PyTorch port, the grace (hash-partitioned) join and the merge modes of the
dense aggregate, exactly against the JAX package:

- TPC-H Q12 at SF 0.01 from each package's generator: the port directly,
  the port under grace and the JAX ``Session`` all agree, and under the same
  ``comet.memory.fraction`` both packages pick the same K and mode;
- fact/dim joins with an aggregate above (partial and local modes, no
  aggregate, duplicate build keys past the fan-out: in
  ``test_torch_grace2.py``, a file running on a worker of its own; no
  match at all);
- FINAL and PARTIAL_MERGE of the dense aggregate against JAX
  ``hash_aggregate``."""

import contextlib
import dataclasses
import math
import warnings
from typing import List

import jax
import numpy as np
import pytest
import torch

import chip_smoke
from datafusion_comet_tpu import types as JT
from datafusion_comet_tpu.conf import CONF, MEMORY_FRACTION
from datafusion_comet_tpu.exec import batch as JB
from datafusion_comet_tpu.exec import grace as JG
from datafusion_comet_tpu.exec.engine import Session as JaxSession
from datafusion_comet_tpu.exec.evaluator import EvalContext as JEvalContext
from datafusion_comet_tpu.exec.operators import aggregate as JAGG
from datafusion_comet_tpu.ir import expr as JE
from datafusion_comet_tpu.ir import plan as JP
from datafusion_comet_tpu.models import tpch as JTPCH
from datafusion_comet_tpu_torch import types as PT
from datafusion_comet_tpu_torch.conf import Config
from datafusion_comet_tpu_torch.exec import batch as PB
from datafusion_comet_tpu_torch.exec import grace as PG
from datafusion_comet_tpu_torch.exec.engine import Session
from datafusion_comet_tpu_torch.exec.operators import aggregate as PAGG
from datafusion_comet_tpu_torch.ir import expr as PE
from datafusion_comet_tpu_torch.ir import plan as PP
from datafusion_comet_tpu_torch.models import tpch
from _torch_threads import one_torch_thread  # noqa: F401 (a fixture)

pytestmark = pytest.mark.usefixtures("one_torch_thread")

SF = 0.01


@contextlib.contextmanager
def jax_fraction(fraction: float):
    """The JAX package's comet.memory.fraction for the block, then back."""
    old = CONF.get(MEMORY_FRACTION)
    CONF.set("comet.memory.fraction", fraction)
    try:
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")  # over-budget children proceed with a warning
            yield
    finally:
        CONF.set("comet.memory.fraction", old)


class _Seen(list):
    """(K, mode) of each JAX grace join that ran; ``sizes``: the partition
    sizes of its two sides, one (left, right) pair a run; ``runners``: the
    runners themselves."""

    def __init__(self):
        super().__init__()
        self.sizes = []
        self.runners = []

    def pair_retries(self) -> List[int]:
        """Each runner's pair retries: its growth scale is 4 to their power."""
        return [round(math.log(r._scale, 4)) for r in self.runners]


@pytest.fixture
def jax_spy(monkeypatch):
    """Records (K, mode) and the partition sizes of every JAX grace join
    that runs. The sizes come from the runner's own partition functions,
    built as the runner builds them, which record the starts they return."""
    seen = _Seen()

    class Spy(JG.GraceJoinRunner):
        def __init__(self, session, join, K, temp_names, stage=None, downstream=None):
            seen.append((K, downstream[0] if downstream else None))
            seen.runners.append(self)
            super().__init__(session, join, K, temp_names, stage, downstream)
            casts = [JG.grace_key_cast(lk.dtype, rk.dtype)
                     for lk, rk in zip(join.left_keys, join.right_keys)]
            run = []

            def recording(keys):
                @jax.jit
                def part(b):
                    return JG.partition_perm(b, JG._hash_pids(b, keys, casts, K, JEvalContext()),
                                             K)

                def call(b):
                    perm, starts = part(b)
                    run.append(np.diff(np.asarray(starts)))
                    if len(run) == 2:
                        seen.sizes.append(tuple(run))
                        run.clear()
                    return perm, starts

                return call

            self._part_l, self._part_r = recording(join.left_keys), recording(join.right_keys)

    monkeypatch.setattr(JG, "GraceJoinRunner", Spy)
    return seen


def _port_session(tables, fraction=None, **conf):
    s = Session(device="cpu", conf=Config(**({"memory_fraction": fraction} if fraction else {}),
                                          **conf))
    for name, (data, schema, validity) in tables.items():
        s.register_numpy(name, data, schema, validity=validity)
    return s


def _jax_session(tables):
    s = JaxSession()
    for name, (data, schema, validity) in tables.items():
        s.register_numpy(name, data, schema, validity=validity)
    return s


def _assert_same(want, got):
    assert list(want) == list(got)
    for k in want:
        np.testing.assert_array_equal(want[k], got[k], err_msg=k)


# ---- TPC-H Q12 -----------------------------------------------------------------------


@pytest.fixture(scope="module")
def q12_data():
    return {t: tpch.generate_table(t, SF) for t in ("lineitem", "orders")}


def _tpch_tables(data, M):
    schemas = (JTPCH if M is JT else tpch).SCHEMAS
    return {t: (d, schemas[t], None) for t, d in data.items()}


def test_orders_generator_matches_jax(q12_data):
    want = JTPCH.generate_table("orders", SF)
    got = q12_data["orders"]
    assert list(want) == list(got)
    for k in want:
        assert want[k].dtype == got[k].dtype, k
        np.testing.assert_array_equal(want[k], got[k], err_msg=k)


def test_q12_bound_schema_matches_jax():
    assert repr(PP.bind_plan(tpch.q12()).schema) == repr(JP.bind_plan(JTPCH.q12()).schema)


@pytest.mark.parametrize("K", [8, 16, 64])
def test_q12_direct_and_grace_match_jax(q12_data, jax_spy, K):
    direct = _port_session(_tpch_tables(q12_data, PT))
    want = chip_smoke.oracle_q12(q12_data["lineitem"], q12_data["orders"],
                                 tpch._d("1994-01-01"), tpch._d("1995-01-01"))
    got_direct = direct.collect(tpch.q12())
    chip_smoke.check_q12(got_direct, want, "port direct")
    assert direct.grace_runners == []
    fraction, jpeak = chip_smoke.grace_fraction(direct, tpch.q12(), K)
    grace = _port_session(_tpch_tables(q12_data, PT), fraction)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        got_grace = grace.collect(tpch.q12())
    (runner,) = grace.grace_runners
    assert (runner.K, runner.downstream[0]) == (K, "partial")
    assert sum(runner.sizes[1]) == len(q12_data["orders"]["o_orderkey"])
    js = _jax_session(_tpch_tables(q12_data, JT))
    want_jax = js.collect(JTPCH.q12())
    assert jax_spy == []
    with jax_fraction(fraction):
        got_jax_grace = js.collect(JTPCH.q12())
    assert jax_spy == [(K, "partial")]
    # both packages cut both sides into the same partitions
    for got_sizes, want_sizes in zip(runner.sizes, jax_spy.sizes[0]):
        np.testing.assert_array_equal(got_sizes, want_sizes)
    for got in (got_direct, got_grace, got_jax_grace):
        _assert_same(want_jax, got)


# ---- TPC-H Q3: local mode at the aggregate stage's root -----------------------------


@pytest.fixture(scope="module")
def q3_data():
    return {t: tpch.generate_table(t, SF) for t in ("lineitem", "orders", "customer")}


def test_q3_direct_and_grace_match_jax(q3_data, jax_spy):
    """Q3's aggregate stage groups by l_orderkey, the top join's key: under
    the budget both packages run the whole stage inside each of K = 16
    pairs (local mode) with the same partition sizes, and every run equals
    the JAX Session's result and the numpy oracle."""
    direct = _port_session(_tpch_tables(q3_data, PT))
    got_direct = direct.collect(tpch.q3())
    assert direct.grace_runners == []
    fraction, _ = chip_smoke.grace_fraction(direct, tpch.q3(), 16)
    grace = _port_session(_tpch_tables(q3_data, PT), fraction)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        got_grace = grace.collect(tpch.q3())
    (runner,) = grace.grace_runners
    assert (runner.K, runner.downstream[0]) == (16, "local")
    assert [n is None for n, _ in grace.stages] == [False, True]
    js = _jax_session(_tpch_tables(q3_data, JT))
    want = js.collect(JTPCH.q3())
    with jax_fraction(fraction):
        got_jax_grace = js.collect(JTPCH.q3())
    assert jax_spy == [(16, "local")]
    for got_sizes, want_sizes in zip(runner.sizes, jax_spy.sizes[0]):
        np.testing.assert_array_equal(got_sizes, want_sizes)
    for got in (got_direct, got_grace, got_jax_grace):
        _assert_same(want, got)
    oracle = chip_smoke.oracle_q3(q3_data["lineitem"], q3_data["orders"], q3_data["customer"],
                                  tpch._d("1995-03-15"))
    chip_smoke.check_q3(got_grace, oracle, "port grace")


def _top_k(M, P, E, tables, fetch, skip):
    """tests/test_grace_join.py's Q3 shape: Sort(fetch, skip) over an
    aggregate grouped by the join key and a dim column."""
    j = P.HashJoin(P.Scan("fact", tables["fact"][1]), P.Scan("dim", tables["dim"][1]),
                   (E.col("fk"),), (E.col("pk"),), P.JoinType.INNER, "right")
    agg = j.aggregate([E.col("fk"), E.col("w")],
                      [E.AggExpr("sum", E.col("v"), "rev"), E.AggExpr("count", E.col("x"), "n")])
    s = agg.sort([E.SortOrder(E.col("rev"), ascending=False), E.SortOrder(E.col("fk"))],
                 fetch=fetch)
    s.skip = skip
    return s


@pytest.mark.parametrize("fetch,skip", [(10, 0), (7, 5)])
def test_local_mode_under_a_top_k_root_matches_jax(jax_spy, fetch, skip):
    """Local mode under a top-K Sort root: each pair keeps its own skip +
    fetch rows, the sort (order, fetch and skip) runs again over the union;
    equal to the direct runs and to the JAX package's grace run."""
    ptables, jtables = _fact_dim(PT), _fact_dim(JT)
    js = _jax_session(jtables)
    want = js.collect(_top_k(JT, JP, JE, jtables, fetch, skip))
    plan = _top_k(PT, PP, PE, ptables, fetch, skip)
    direct = _port_session(ptables)
    fraction, _ = chip_smoke.grace_fraction(direct, plan, 16)
    grace = _port_session(ptables, fraction)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        got = grace.collect(plan)
    (runner,) = grace.grace_runners
    assert (runner.K, runner.downstream[0]) == (16, "local")
    assert isinstance(runner.template, PP.Sort)
    assert (runner.template.fetch, runner.template.skip) == (fetch + skip, 0)
    with jax_fraction(fraction):
        got_jax = js.collect(_top_k(JT, JP, JE, jtables, fetch, skip))
    assert jax_spy == [(16, "local")]
    assert len(got["fk"]) == fetch
    for g in (got, direct.collect(plan), got_jax):
        _assert_same(want, g)


def test_partial_mode_refused_past_2_20_groups():
    """An aggregate not grouped by the join key whose group capacity is
    over 2^20: K pairs of such partial states would be the join's size
    again, so neither package pushes it into the pairs; at 2^20 both do."""
    for groups, want in ((1 << 21, None), (1 << 20, "partial")):
        modes = []
        for M, P, E, G in ((JT, JP, JE, JG), (PT, PP, PE, PG)):
            tables = _fact_dim(M)
            agg = _join(M, P, E, tables).child  # grouped by dim.g
            agg.max_groups = groups
            bound = P.bind_plan(agg)
            ds = G.plan_grace_downstream(bound, bound.child)
            modes.append(ds and ds[0])
        assert modes == [want, want]


def test_q12_string_predicates():
    """!= and IN on dictionary-coded strings compare codes."""
    data = {"p": np.array(["1-URGENT", "2-HIGH", "3-MEDIUM", None, "5-LOW"], object)}
    ps = Session(device="cpu")
    ps.register_numpy("t", data, PT.Schema([PT.Field("p", PT.string(15))]))
    plan = PP.Scan("t", PT.Schema([PT.Field("p", PT.string(15))])).project([
        (PE.col("p") != PE.lit("1-URGENT")).alias("ne"),
        PE.col("p").isin("2-HIGH", "5-LOW", "9-NONE").alias("isin"),
        PE.CaseWhen(((PE.col("p") == PE.lit("3-MEDIUM"), PE.lit(7)),), None).alias("cw")])
    out = ps.collect(plan)
    assert out["ne"].tolist()[:3] == [False, True, True] and out["ne__valid"].tolist() == [
        True, True, True, False, True]
    assert out["isin"][out["isin__valid"]].tolist() == [False, True, False, True]
    assert out["cw__valid"].tolist() == [False, False, True, False, False]
    assert out["cw"][2] == 7


# ---- fact / dim joins with an aggregate above ------------------------------------------


def _fact_dim(M, seed: int = 7, dup: int = 1, key_type=None):
    """The fact/dim/dup tables of tests/test_grace_join.py with integer and
    decimal values in place of floats: fact.fk in [0, 1000), dim.pk 700 of
    those keys (each ``dup`` times), a dictionary-coded dim.g to group by."""
    rng = np.random.default_rng(seed)
    kt = key_type or "INT64"
    kdt = {"INT64": np.int64, "INT8": np.int8, "TIMESTAMP": np.int64}[kt]
    hi = 120 if kt == "INT8" else 1000
    nf = 5000
    fk = rng.integers(0, hi, nf).astype(kdt)
    pk = np.repeat(rng.permutation(hi)[:int(hi * 0.7)], dup).astype(kdt)
    if kt == "TIMESTAMP":  # microseconds: whole hours either side of the epoch
        fk, pk = ((k - 500) * 3_600_000_000 for k in (fk, pk))
    fact = {"fk": fk, "x": np.arange(nf, dtype=np.int64),
            "v": rng.integers(-10**6, 10**6, nf).astype(np.int64)}
    dim = {"pk": pk, "w": rng.integers(0, 50, len(pk)).astype(np.int32),
           "g": np.array(["east", "north", "south", "west"], object)[rng.integers(0, 4, len(pk))]}
    key = getattr(M, kt)
    return {
        "fact": (fact, M.Schema([M.Field("fk", key), M.Field("x", M.INT64),
                                 M.Field("v", M.decimal(12, 2))]),
                 {"v": rng.random(nf) > 0.05}),
        "dim": (dim, M.Schema([M.Field("pk", key), M.Field("w", M.INT32),
                               M.Field("g", M.string(5))]), None),
    }


def _join(M, P, E, tables, how="agg"):
    j = P.HashJoin(P.Scan("fact", tables["fact"][1]), P.Scan("dim", tables["dim"][1]),
                   (E.col("fk"),), (E.col("pk"),), P.JoinType.INNER, "right")
    if how == "plain":
        return j.project([E.col("x"), E.col("w"), E.col("g")])
    aggs = [E.AggExpr("sum", E.col("v"), "sv"), E.AggExpr("avg", E.col("v"), "av"),
            E.AggExpr("count", E.col("x"), "cnt"), E.AggExpr("sum", E.col("w"), "sw")]
    if how == "ungrouped":
        return j.aggregate([], aggs)
    if how == "local":  # grouped by the join key: partition-local groups
        return j.aggregate([E.col("fk")], aggs)
    return j.aggregate([E.col("g")], aggs).sort([E.SortOrder(E.col("g"))])


def _rows(out):
    names = [k for k in out if not k.endswith("__valid")]
    return sorted(tuple(out[c][i] if out[c + "__valid"][i] else None for c in names)
                  for i in range(len(out[names[0]])))


def test_grace_with_a_fully_live_side_pads_its_last_pairs(jax_spy):
    """A fact side with no dead rows (4096 rows, capacity 4096): the last
    pairs' capacities run past the sorted side's end, so their slices are
    padded with dead rows; the result and the partition sizes equal JAX's."""
    ptables = _fact_dim(PT, seed=3)
    jtables = _fact_dim(JT, seed=3)
    for t in (ptables, jtables):
        data = t["fact"][0]
        for c in data:
            data[c] = data[c][:4096]
        t["fact"] = (data, t["fact"][1], {"v": t["fact"][2]["v"][:4096]})
    plan = _join(PT, PP, PE, ptables)
    fraction, _ = chip_smoke.grace_fraction(_port_session(ptables), plan, 16)
    grace = _port_session(ptables, fraction)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        got = grace.collect(plan)
    (runner,) = grace.grace_runners
    assert runner.capacities[0] == 4096 and runner.K == 16
    sizes = runner.sizes[0]
    starts = np.concatenate([[0], np.cumsum(sizes)])
    caps = [PB.pad_capacity(max(int(x), 8)) for x in sizes]
    assert any(st + cap > 4096 for st, cap in zip(starts, caps))
    js = _jax_session(jtables)
    with jax_fraction(fraction):
        got_jax = js.collect(_join(JT, JP, JE, jtables))
    assert jax_spy == [(16, "partial")]
    np.testing.assert_array_equal(sizes, jax_spy.sizes[0][0])
    _assert_same(got_jax, got)


@pytest.mark.parametrize("start,end,cap", [(0, 5, 8), (5, 12, 8), (12, 16, 8), (14, 16, 16),
                                           (16, 16, 8)])
def test_extract_is_a_slice_padded_past_the_end(start, end, cap):
    """A pair's batch is rows [start, start + cap) of the sorted side, live
    below ``end``; where the side ends first, dead zero rows fill it."""
    rng = np.random.default_rng(cap + start)
    data = {"k": rng.integers(0, 9, 16).astype(np.int64),
            "s": np.array([f"v{j}" for j in rng.integers(0, 99, 16)], object)}
    b = PB.from_numpy(data, PT.Schema([PT.Field("k", PT.INT64), PT.Field("s", PT.string(3))]),
                      "cpu", validity={"k": rng.random(16) > 0.3}, dict_max_size=0)
    sub = PG._extract(b, start, end, cap)
    assert sub.capacity == cap
    np.testing.assert_array_equal(sub.row_mask.numpy(), np.arange(cap) < end - start)
    m = min(cap, 16 - start)
    for got, src in zip(sub.columns, b.columns):
        assert (got.lengths is None) == (src.lengths is None)
        for g, t in ((got.data, src.data), (got.validity, src.validity),
                     (got.lengths, src.lengths)):
            if t is None:
                continue
            assert g.shape == (cap,) + tuple(t.shape[1:]) and g.dtype == t.dtype
            assert torch.equal(g[:m], t[start:start + m]) and not g[m:].any()


def test_grace_with_no_match_emits_one_ungrouped_row():
    """Every dim key shifted out of the fact's range: no pair matches, and
    the ungrouped aggregate still emits its one row (sum null, count 0)."""
    ptables, jtables = _fact_dim(PT), _fact_dim(JT)
    for t in (ptables, jtables):
        t["dim"][0]["pk"] = t["dim"][0]["pk"] + 5000
    want = _jax_session(jtables).collect(_join(JT, JP, JE, jtables, "ungrouped"))
    plan = _join(PT, PP, PE, ptables, "ungrouped")
    fraction, _ = chip_smoke.grace_fraction(_port_session(ptables), plan, 16)
    grace = _port_session(ptables, fraction)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        got = grace.collect(plan)
    assert grace.grace_runners[0].K == 16
    _assert_same(want, got)
    assert got["cnt"].tolist() == [0] and not got["sv__valid"][0]


def test_grace_runner_phases_appear_in_a_profile():
    """The runner's four phases show as spans in a torch.profiler trace,
    each once per run, and together take most of the run's host time."""
    from torch.profiler import ProfilerActivity, profile

    ptables = _fact_dim(PT)
    plan = _join(PT, PP, PE, ptables)
    fraction, _ = chip_smoke.grace_fraction(_port_session(ptables), plan, 16)
    grace = _port_session(ptables, fraction)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        with profile(activities=[ProfilerActivity.CPU]) as prof:
            grace.collect(plan)
    spans = {ev.key: ev for ev in prof.key_averages() if ev.key.startswith("grace.")}
    assert sorted(spans) == ["grace.finish", "grace.inputs", "grace.pairs", "grace.partition"]
    assert all(ev.count == 1 for ev in spans.values())
    assert spans["grace.pairs"].cpu_time_total > spans["grace.finish"].cpu_time_total


# ---- merge modes of the dense aggregate --------------------------------------------------


def _agg_exprs(E, input_schema):
    aggs = [E.AggExpr("sum", E.col("v"), "sv"), E.AggExpr("avg", E.col("v"), "av"),
            E.AggExpr("count", E.col("i"), "ci"), E.AggExpr("sum", E.col("i"), "si"),
            E.AggExpr("count", None, "n")]
    return [dataclasses.replace(a, child=None if a.child is None else E.bind(a.child, input_schema))
            for a in aggs]


@pytest.mark.parametrize("mode", ["final", "partial_merge"])
@pytest.mark.parametrize("wide", [False, True])
@pytest.mark.parametrize("merge_rows", [None, 50 * 3000])
def test_merge_modes_match_jax_hash_aggregate(mode, wide, merge_rows):
    """States made up directly (nulls, empty groups, dead rows) merge alike:
    a group key, sum/avg/count states of a decimal and an int column; the
    port with no bound on the rows behind a group's states (AVG's 128-step
    division) and with one (every count is under 50: the 4-step one)."""
    rng = np.random.default_rng(int(wide))
    n = 3000
    big = 10**30 if wide else 10**12
    sums = [int(x) for x in rng.integers(-10**6, 10**6, n)]
    states = {
        "g": np.array(["a", "b", "c", None], object)[rng.integers(0, 4, n)],
        "sv__sum": np.array([s * (big // 10**6) for s in sums], object),
        "av__sum": np.array([s * 7 for s in sums], object),
        "av__count": rng.integers(0, 50, n).astype(np.int64),
        "ci__count": rng.integers(0, 50, n).astype(np.int64),
        "si__sum": rng.integers(-2**40, 2**40, n).astype(np.int64),
        "n__count": rng.integers(0, 50, n).astype(np.int64),
    }
    validity = {"sv__sum": rng.random(n) > 0.2, "av__sum": rng.random(n) > 0.1,
                "si__sum": rng.random(n) > 0.3}
    mask = rng.random(n) > 0.1
    out = {}
    for M, E, AGG, from_numpy, to_numpy in (
            (JT, JE, JAGG, lambda d, s: JB.from_numpy(d, s, validity=validity), JB.to_numpy),
            (PT, PE, PAGG, lambda d, s: PB.from_numpy(d, s, "cpu", validity=validity),
             PB.to_numpy)):
        input_schema = M.Schema([M.Field("g", M.string(1)), M.Field("v", M.decimal(12, 2)),
                                 M.Field("i", M.INT32)])
        aggs = _agg_exprs(E, input_schema)
        fields = [M.Field("g", M.string(1))] + [f for a in aggs for f in AGG.state_fields(a)]
        schema = M.Schema(fields)
        batch = from_numpy({f.name: states[f.name] for f in fields}, schema)
        pad = np.zeros(batch.capacity, bool)
        pad[:n] = mask
        live = (batch.row_mask & (np.asarray(pad) if M is JT else PB._to(pad, "cpu")))
        batch = batch.with_mask(live)
        groups = [E.bind(E.col("g"), schema)]
        if mode == "final":
            out_fields = [M.Field("g", M.string(1))] + [M.Field(a.out_name, a.result_dtype())
                                                        for a in aggs]
        else:
            out_fields = fields
        out_schema = M.Schema(out_fields)
        if M is JT:
            res = AGG.hash_aggregate(batch, groups, aggs, mode, 64, out_schema)
        else:
            res = AGG.hash_aggregate(batch, groups, aggs, mode, out_schema,
                                     merge_rows=merge_rows)
        out[M] = to_numpy(res)
    _assert_same(out[JT], out[PT])
    assert len(out[PT]["g"]) == 4


def test_over_budget_streamable_aggregate_is_not_ported(q12_data):
    """Q1 over budget: the port tiles its aggregate (exec/streaming.py, which
    came with Q18) at the JAX package's tile count; the result equals the
    direct run and the oracle. With every string padded the JAX package
    tiles it too, to the same answer, storage and bounds (with dictionary
    keys its tiled concatenation raises, ROADMAP C8). The name is kept from
    when the port refused this path."""
    from datafusion_comet_tpu_torch.exec.memory import CPU_MEMORY_LIMIT, plan_peak_bytes

    tables = _tpch_tables({"lineitem": q12_data["lineitem"]}, PT)
    direct = _port_session(tables)
    (_, stage), = direct._plan_stages(tpch.q1())
    cap = direct.tables["lineitem"].capacity
    # a budget that one eighth of the lineitem fits: eight tiles
    fraction = (plan_peak_bytes(stage, cap // 8) + 1) / CPU_MEMORY_LIMIT
    ps = _port_session(tables, fraction)
    got = ps.collect(tpch.q1())
    assert ps.tiled == [("lineitem", 8)] and ps.grace_runners == []
    _assert_same(direct.collect(tpch.q1()), got)
    chip_smoke.check_q1(got, chip_smoke.oracle_q1(q12_data["lineitem"], tpch._d("1998-09-02")))
    ps = _port_session(tables, fraction, scan_dictionary_max_size=0)
    pb = ps.execute(tpch.q1())
    assert ps.tiled == [("lineitem", 8)]
    js = JaxSession()
    js.register_numpy("lineitem", q12_data["lineitem"], JTPCH.SCHEMAS["lineitem"],
                      dict_max_size=0)
    with jax_fraction(fraction):
        jb = js.execute(JTPCH.q1())
    _assert_same(JB.to_numpy(jb), PB.to_numpy(pb))
    for jc, pc in zip(jb.columns, pb.columns):
        assert (np.asarray(jc.data).ndim, jc.mag_bound) == (pc.data.dim(), pc.mag_bound)
    _assert_same(got, PB.to_numpy(pb))

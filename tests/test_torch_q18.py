"""PyTorch port, TPC-H Q18 (a HAVING filter over an aggregate, a LEFT_SEMI
join against it, a five-key aggregate with ``c_name``, padded at SF1 and
up, and a top-100) through the port's ``Session`` on the CPU, against the
JAX ``Session`` on the same generated data, with the default staging and
with every string padded (``dict_max_size=0``), and against the numpy
oracle chip_smoke.py checks the card with (the helpers serve Q10 too,
test_torch_q10.py):

- directly: values, order, the output's storage and bounds, the planner's
  hints stage by stage and the retry attempts (a spy on the JAX
  ``Session.compile``);
- under the budget that makes the engine partition the query's first
  join into K = 16: the same grace joins (K and mode), partition sizes and
  pair retries in both packages, and the same answer.

Q18 is empty at SF 0.01 (no order holds more than 300 units there), so it
also runs as a variant with HAVING
sum(l_quantity) > 200, which keeps several hundred orders and lets the
top-100 cut, and the real plan at SF 0.05 (4 rows). Both packages
consider runtime filters on fact sides of 65,536 rows or more: the SF 0.05
run goes once with them switched off in both packages and once with them
on (Q18 gets none: the dimension side of its lineitem join filters an
aggregate, not a scan), and they are asserted absent at the smaller
sizes."""

import contextlib
import warnings

import numpy as np
import pytest

import chip_smoke
from datafusion_comet_tpu import types as JT
from datafusion_comet_tpu.conf import CONF
from datafusion_comet_tpu.exec import batch as JB
from datafusion_comet_tpu.exec.runtime_filter import RUNTIME_FILTER_ENABLED
from datafusion_comet_tpu.ir import expr as JE
from datafusion_comet_tpu.ir import plan as JP
from datafusion_comet_tpu.models import tpch as JTPCH
from datafusion_comet_tpu_torch.conf import Config
from datafusion_comet_tpu_torch.exec import batch as PB
from datafusion_comet_tpu_torch.exec.engine import Session
from datafusion_comet_tpu_torch.ir import plan as PP
from datafusion_comet_tpu_torch.models import tpch
from test_torch_grace import jax_fraction, jax_spy  # noqa: F401 (a fixture)
from test_torch_hints import jax_attempts, stage_hints  # noqa: F401 (a fixture)
from test_torch_q9 import jax_session
from _torch_threads import one_torch_thread  # noqa: F401 (a fixture)

pytestmark = pytest.mark.usefixtures("one_torch_thread")

NAMES = ("lineitem", "orders", "customer", "nation")
STAGING = {"default": 1 << 16, "padded": 0}
GRACE_K = 16


def jax_q18(min_qty: int = 300) -> JP.PlanNode:
    """JAX ``tpch.q18`` with its HAVING threshold as a parameter (the port's
    ``tpch.q18(min_qty)``)."""
    if min_qty == 300:
        return JTPCH.q18()
    l = JP.Scan("lineitem", JTPCH.SCHEMAS["lineitem"])
    perorder = l.aggregate([JE.col("l_orderkey")],
                           [JE.AggExpr("sum", JE.col("l_quantity"), "qty")])
    big = JP.Filter(perorder, JE.col("qty") > JE.lit(min_qty, JT.decimal(25, 2)))
    o = JP.Scan("orders", JTPCH.SCHEMAS["orders"])
    ob = JP.HashJoin(o, big, (JE.col("o_orderkey"),), (JE.col("l_orderkey"),),
                     JP.JoinType.LEFT_SEMI, "right")
    c = JP.Scan("customer", JTPCH.SCHEMAS["customer"])
    oc = JP.HashJoin(ob, c, (JE.col("o_custkey"),), (JE.col("c_custkey"),),
                     JP.JoinType.INNER, "right")
    l2 = JP.Scan("lineitem", JTPCH.SCHEMAS["lineitem"])
    j = JP.HashJoin(l2, oc, (JE.col("l_orderkey"),), (JE.col("o_orderkey"),),
                    JP.JoinType.INNER, "right")
    agg = j.aggregate([JE.col("c_name"), JE.col("c_custkey"), JE.col("o_orderkey"),
                       JE.col("o_orderdate"), JE.col("o_totalprice")],
                      [JE.AggExpr("sum", JE.col("l_quantity"), "sum_qty")])
    return agg.sort([JE.SortOrder(JE.col("o_totalprice"), ascending=False),
                     JE.SortOrder(JE.col("o_orderdate"))], fetch=100)


# (name, port plan, JAX plan, oracle and check over the data)
QUERIES = {
    "q10": (tpch.q10, JTPCH.q10, lambda d: chip_smoke.oracle_q10(
        d["lineitem"], d["orders"], d["customer"], d["nation"], tpch._d("1993-10-01"),
        tpch._d("1994-01-01")), chip_smoke.check_q10),
    "q18": (tpch.q18, jax_q18, lambda d: chip_smoke.oracle_q18(
        d["lineitem"], d["orders"], d["customer"]), chip_smoke.check_q18),
    "q18_200": (lambda: tpch.q18(200), lambda: jax_q18(200), lambda d: chip_smoke.oracle_q18(
        d["lineitem"], d["orders"], d["customer"], 200), chip_smoke.check_q18),
}


@pytest.fixture(scope="module")
def tables():
    return {sf: tpch.generate_tables(NAMES, sf) for sf in (0.005, 0.01)}


def _sessions(data, staging, fraction=None, **conf):
    js = jax_session({t: data[t] for t in NAMES}, JTPCH.SCHEMAS, STAGING[staging])
    ps = Session(device="cpu", conf=Config(scan_dictionary_max_size=STAGING[staging],
                                           **({"memory_fraction": fraction} if fraction else {}),
                                           **conf))
    for t in NAMES:
        ps.register_numpy(t, data[t], tpch.SCHEMAS[t])
    return js, ps


def _same(want, got):
    assert list(want) == list(got)
    for k in want:
        assert want[k].dtype == got[k].dtype, k
        np.testing.assert_array_equal(want[k], got[k], err_msg=k)


def _no_runtime_filters(stages):
    stack = [p for _, p in stages]
    while stack:
        p = stack.pop()
        assert not (isinstance(p, JP.HashJoin) and getattr(p, "rf_injected", None))
        stack.extend(p.children())


def _direct(js, ps, q, jax_attempts):
    """Both packages' direct runs held to each other: (port output, its
    stages)."""
    port_plan, jax_plan, _, _ = QUERIES[q]
    want_stages = js._plan_stages(jax_plan())
    _no_runtime_filters(want_stages)
    got_stages = ps._plan_stages(port_plan())
    assert stage_hints(got_stages, PP) == stage_hints(want_stages, JP)
    jax_attempts.clear()
    jb, pb = js.execute(jax_plan()), ps.execute(port_plan())
    want, got = JB.to_numpy(jb), PB.to_numpy(pb)
    _same(want, got)
    for jc, pc, f in zip(jb.columns, pb.columns, pb.schema.fields):
        assert np.asarray(jc.data).ndim == pc.data.dim(), f.name
        assert jc.mag_bound == pc.mag_bound, f.name
        assert (jc.lengths is None) == (pc.lengths is None), f.name
    assert [(r["scale"], r["unique_join_ok"]) for r in ps.runs] == jax_attempts
    return got, ps.stages


@pytest.mark.parametrize("staging", list(STAGING))
@pytest.mark.parametrize("q", ["q18", "q18_200"])
def test_q18_direct_matches_jax_and_oracle(tables, jax_attempts, q, staging):
    js, ps = _sessions(tables[0.01], staging)
    got, stages = _direct(js, ps, q, jax_attempts)
    expect = QUERIES[q][2](tables[0.01])
    assert len(expect) == (0 if q == "q18" else 100)
    chip_smoke.check_q18(got, expect, q)
    # the aggregate and the per-order sums, then the top-100 over the groups
    assert len(stages) >= 2


@pytest.fixture
def jax_tiles(monkeypatch):
    """(table capacity, tiles) of every aggregate the JAX package tiles."""
    from datafusion_comet_tpu.exec import engine as JENG

    seen = []
    orig = JENG._slice_tiles

    def spy(batch, tile_cap):
        seen.append(batch.capacity // tile_cap)
        return orig(batch, tile_cap)

    monkeypatch.setattr(JENG, "_slice_tiles", spy)
    return seen


@pytest.mark.parametrize("staging", list(STAGING))
@pytest.mark.parametrize("q", ["q18", "q18_200"])
def test_grace_matches_jax(tables, jax_spy, jax_tiles, q, staging):
    """Q18's per-order aggregate over the whole lineitem is over the budget
    of its grace runs: both packages run it tiled first, in as many tiles;
    then its two stages' joins partition alike (``check_grace``)."""
    check_grace(tables, jax_spy, jax_tiles, q, staging)


def check_grace(tables, jax_spy, jax_tiles, q, staging):
    """The query's first join partitioned into K = 16 in both packages (and
    any join the runner's inputs hold over the budget as well): the same K,
    modes, partition sizes and pair retries, the same tiled aggregates, and
    the same answer, equal to the oracle."""
    data = tables[0.01]
    port_plan, jax_plan, oracle, check = QUERIES[q]
    _, direct = _sessions(data, staging)
    fraction, _ = chip_smoke.grace_fraction(direct, port_plan(), GRACE_K)
    js, grace = _sessions(data, staging, fraction)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        got = grace.collect(port_plan())
    with jax_fraction(fraction):
        want = js.collect(jax_plan())
    _same(want, got)
    check(got, oracle(data), f"{q} grace")
    # the JAX spy lists runners as they start (the port names them so) and
    # their partition sizes as they partition, the port as they finish: an
    # outer runner starts first, partitions after its inner ones finish
    ports = sorted(grace.grace_runners, key=lambda r: int(r.tmp[len("__grace"):]))
    assert [(r.K, r.downstream and r.downstream[0]) for r in ports] == list(jax_spy)
    assert GRACE_K in [r.K for r in ports] and len(ports) == len(jax_spy.sizes)
    for r, sizes in zip(grace.grace_runners, jax_spy.sizes):
        for got_sizes, want_sizes in zip(r.sizes, sizes):
            np.testing.assert_array_equal(got_sizes, want_sizes)
    assert jax_spy.pair_retries() == [r.retries for r in ports]
    assert [t for _, t in grace.tiled] == jax_tiles
    assert bool(jax_tiles) == q.startswith("q18")


@contextlib.contextmanager
def _jax_without_runtime_filters():
    old = CONF.get(RUNTIME_FILTER_ENABLED)
    CONF.set("comet.exec.runtimeFilter.enabled", False)
    try:
        yield
    finally:
        CONF.set("comet.exec.runtimeFilter.enabled", old)


@pytest.fixture(scope="module")
def sf005():
    return tpch.generate_tables(NAMES, 0.05)


def test_q18_real_plan_at_sf005_matches_jax_and_oracle(jax_attempts, sf005):
    """The real Q18 where it is not empty: 4 orders at SF 0.05, over the
    300,000-row lineitem, with the runtime filters switched off in both
    packages."""
    js, ps = _sessions(sf005, "default", runtime_filter_enabled=False)
    with _jax_without_runtime_filters():
        got, _ = _direct(js, ps, "q18", jax_attempts)
    expect = QUERIES["q18"][2](sf005)
    assert len(expect) == 4
    chip_smoke.check_q18(got, expect, "q18 sf0.05")


def test_q18_real_plan_at_sf005_with_runtime_filters_matches_jax_and_oracle(jax_attempts,
                                                                            sf005):
    """The same run with the runtime filters on in both packages (the
    default): the same plans, none injected, and the same answer."""
    js, ps = _sessions(sf005, "default")
    got, stages = _direct(js, ps, "q18", jax_attempts)
    assert not [j for _, sub in stages for j in _joins(sub) if j.rf_injected]
    chip_smoke.check_q18(got, QUERIES["q18"][2](sf005), "q18 sf0.05 with runtime filters")


def _joins(p):
    own = [p] if isinstance(p, PP.HashJoin) else []
    return own + [j for c in p.children() for j in _joins(c)]

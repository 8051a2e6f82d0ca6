"""PyTorch port, the aggregate FILTER clause (``AggExpr.filter``): COUNT(*),
COUNT, SUM, AVG, MIN and MAX each with its own FILTER (a null predicate
drops the row), beside an unfiltered SUM, against the JAX Session on the
dense path (two bool keys), the sorted path (an int64 key), the tiled
aggregate (a quarter of its peak estimate: as many tiles as the JAX
package) and the grace join's partial mode (K = 16: both packages
partition alike); the plan's JSON carries the filter as the JAX
package's. The special aggregates take their FILTER too, as Spark does,
where the JAX package's ignore it (ROADMAP C33): median, collect_set and
approx_count_distinct held to Python over the rows the filter keeps (the
sketch to the same sketch over a Filter node's rows)."""

import json
import warnings

import numpy as np
import pytest

import chip_smoke
from datafusion_comet_tpu.ir import serde as JS
from datafusion_comet_tpu_torch.exec.memory import CPU_MEMORY_LIMIT, plan_peak_bytes
from datafusion_comet_tpu_torch.ir import serde
from test_torch_grace import (JE, JP, JT, PE, PP, PT, _fact_dim, _jax_session, _port_session,
                              jax_fraction, jax_spy)  # noqa: F401 (jax_spy: a fixture)
from test_torch_q18 import jax_tiles  # noqa: F401 (a fixture)
from test_torch_q9 import same
from _torch_threads import one_torch_thread  # noqa: F401 (a fixture)

pytestmark = pytest.mark.usefixtures("one_torch_thread")


def _mod(E, c, m):
    return E.BinaryOp("mod", E.col(c), E.lit(m))


def _aggs(E):
    f1 = _mod(E, "x", 3) == E.lit(0)
    f2 = E.col("v") > E.lit(0)  # a null v drops the row
    f3 = E.col("fk") < E.lit(500)
    return [E.AggExpr("count", None, "n1", filter=f1),
            E.AggExpr("count", E.col("v"), "n3", filter=f3),
            E.AggExpr("sum", E.col("v"), "s2", filter=f2),
            E.AggExpr("avg", E.col("x"), "a3", filter=f3),
            E.AggExpr("min", E.col("v"), "m1", filter=f1),
            E.AggExpr("max", E.col("x"), "m2", filter=f2),
            E.AggExpr("sum", E.col("x"), "all")]


def _plan(E, P, T, tables, path):
    fact = P.Scan("fact", tables["fact"][1])
    if path == "dense":
        src = fact.project([(E.col("fk") < E.lit(300)).alias("b1"),
                            (_mod(E, "x", 2) == E.lit(0)).alias("b2"),
                            E.col("x"), E.col("v"), E.col("fk")])
        keys = [E.col("b1"), E.col("b2")]
    elif path == "grace":
        src = P.HashJoin(fact, P.Scan("dim", tables["dim"][1]), (E.col("fk"),),
                         (E.col("pk"),), P.JoinType.INNER, "right")
        keys = [E.col("g")]
    else:
        src, keys = fact, [E.col("fk")]
    return src.aggregate(keys, _aggs(E)).sort([E.SortOrder(k) for k in keys])


@pytest.mark.parametrize("path", ["dense", "sorted"])
def test_filter_equals_jax(path):
    ptables, jtables = _fact_dim(PT), _fact_dim(JT)
    want = _jax_session(jtables).collect(_plan(JE, JP, JT, jtables, path))
    got = _port_session(ptables).collect(_plan(PE, PP, PT, ptables, path))
    same(want, got)
    if path == "sorted":
        jplan = JP.bind_plan(_plan(JE, JP, JT, jtables, path))
        pplan = PP.bind_plan(_plan(PE, PP, PT, ptables, path))
        jagg = json.loads(JS.plan_to_json(jplan))["plan"]["child"]["agg_exprs"]
        pagg = json.loads(serde.plan_to_json(pplan))["plan"]["child"]["agg_exprs"]
        assert [a["filter"] for a in pagg["items"]] == [a["filter"] for a in jagg["items"]]


def test_tiled_filter_equals_jax(jax_tiles):
    ptables, jtables = _fact_dim(PT), _fact_dim(JT)
    direct = _port_session(ptables)
    plan = _plan(PE, PP, PT, ptables, "sorted").child
    want = direct.collect(plan)
    peak = plan_peak_bytes(PP.bind_plan(plan), direct.tables["fact"].capacity)
    fraction = peak / 4 / CPU_MEMORY_LIMIT
    tiled = _port_session(ptables, fraction)
    got = tiled.collect(_plan(PE, PP, PT, ptables, "sorted").child)
    assert tiled.tiled and tiled.tiled[0][1] > 1
    js = _jax_session(jtables)
    with jax_fraction(fraction):
        got_jax = js.collect(_plan(JE, JP, JT, jtables, "sorted").child)
    assert [t for _, t in tiled.tiled] == jax_tiles
    order = np.argsort(want["fk"], kind="stable")
    same({k: v[order] for k, v in want.items()}, got)
    same(got_jax, got)


def test_grace_partial_filter_equals_jax(jax_spy):
    ptables, jtables = _fact_dim(PT), _fact_dim(JT)
    direct = _port_session(ptables)
    plan = _plan(PE, PP, PT, ptables, "grace")
    want = direct.collect(plan)
    fraction, _ = chip_smoke.grace_fraction(direct, plan, 16)
    grace = _port_session(ptables, fraction)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        got = grace.collect(_plan(PE, PP, PT, ptables, "grace"))
    (runner,) = grace.grace_runners
    assert (runner.K, runner.downstream[0]) == (16, "partial")
    js = _jax_session(jtables)
    with jax_fraction(fraction):
        got_jax = js.collect(_plan(JE, JP, JT, jtables, "grace"))
    assert jax_spy == [(16, "partial")]
    same(want, got)
    same(got_jax, got)


def test_special_aggregates_take_their_filter():
    """ROADMAP C33: the port filters the special aggregates' input."""
    ptables = _fact_dim(PT)
    data, _, validity = ptables["fact"]
    s = _port_session(ptables)
    keep = (data["x"] % 3) == 0
    groups = data["fk"] % 5
    plan = PP.Scan("fact", ptables["fact"][1]).project(
        [_mod(PE, "fk", 5).alias("g"), PE.col("x"), PE.col("v")]).aggregate(
        [PE.col("g")],
        [PE.AggExpr(f, PE.col("x"), f"{f}_x", filter=_mod(PE, "x", 3) == PE.lit(0))
         for f in ("median", "collect_set", "approx_count_distinct")]
        + [PE.AggExpr("collect_set", PE.col("v"), "cs_v", max_elems=4096,
                      filter=PE.col("x") < PE.lit(40))]).sort([PE.SortOrder(PE.col("g"))])
    out = s.collect(plan)
    # the sketch of the rows a Filter node keeps
    hll = s.collect(PP.Scan("fact", ptables["fact"][1]).filter(
        _mod(PE, "x", 3) == PE.lit(0)).project(
        [_mod(PE, "fk", 5).alias("g"), PE.col("x")]).aggregate(
        [PE.col("g")], [PE.AggExpr("approx_count_distinct", PE.col("x"), "h")]).sort(
        [PE.SortOrder(PE.col("g"))]))
    np.testing.assert_array_equal(out["approx_count_distinct_x"], hll["h"])
    for r, g in enumerate(out["g"]):
        xs = data["x"][keep & (groups == g)]
        assert out["median_x"][r] == np.median(xs)
        small = (data["x"] < 40) & (groups == g) & validity["v"]
        assert sorted(out["cs_v"][r]) == sorted(set(data["v"][small] / 100))
    assert sum(len(c) for c in out["collect_set_x"]) == 16 * 5  # max_elems per group

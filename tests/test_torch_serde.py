"""PyTorch port, the plan serde (``ir/serde.py``): every TPC-H and TPC-DS
plan of the port (q88's and q90_scalar's subqueries included) survives
``plan_from_json(plan_to_json(p))`` (the same JSON again, the same bound
schema; a bound subquery's plan too), and for q88 and q90_scalar the
outer plan's and each bound subquery's JSON equal the JAX package's for
the same query, compared as parsed dicts. Fields that one package has and
the other has not are named in ``PORT_ONLY`` and ``JAX_ONLY`` and left
out of that comparison: the port keeps its planner hints as node fields
(the JAX package as attributes outside its JSON) and an Explode the child
columns pruning keeps (``keep``; XLA drops the JAX package's); the JAX
package has no field the port lacks (``JAX_ONLY`` is empty). The scalar
evaluator's nodes (a cast in a session zone, the temporal, string, bytes,
JSON, split, soundex, format_number and hash nodes, the regex nodes, rand,
randn, the row ids and Sample) and the zoned timestamp types write the JAX
package's JSON too, as do the nested nodes (arrays, maps, structs,
lambdas, split, explode, collects with their FILTER clauses and the
percentile list) and the LIST, MAP and STRUCT types."""

import json

import pytest

from datafusion_comet_tpu.exec.engine import Session as JaxSession
from datafusion_comet_tpu.ir import serde as JS
from datafusion_comet_tpu.models import tpcds as JTPCDS
from datafusion_comet_tpu_torch.exec.engine import Session
from datafusion_comet_tpu_torch.ir import plan as P
from datafusion_comet_tpu_torch.ir import serde
from datafusion_comet_tpu_torch.models import tpcds, tpch
from _torch_threads import one_torch_thread  # noqa: F401 (a fixture)

pytestmark = pytest.mark.usefixtures("one_torch_thread")

PORT_ONLY = {"Filter": {"out_rows_hint"},
             "HashAggregate": {"group_key_ranges", "merge_rows"},
             "HashJoin": {"build_key_range", "out_rows_hint", "fanout_hint", "unique_build_hint",
                          "key_pack", "rf_dense_range", "rf_injected", "cond_col_ranges"},
             "Explode": {"keep"}}
JAX_ONLY = {}


def _round_trip(plan):
    text = serde.plan_to_json(plan)
    back = serde.plan_from_json(text)
    assert serde.plan_to_json(back) == text
    return back


def _tpcds_plans(q):
    s = Session(device="cpu")
    root = tpcds.plan(q, s)
    return [root] + [s.subquery_plan(i) for i in range(len(s._subquery_plans))]


@pytest.mark.parametrize("q", sorted(tpch.QUERIES))
def test_tpch_plans_round_trip(q):
    plan = tpch.QUERIES[q]()
    back = _round_trip(plan)
    assert P.bind_plan(back).schema == P.bind_plan(tpch.QUERIES[q]()).schema


@pytest.mark.parametrize("q", list(tpcds.QUERIES) + ["q90_scalar"])
def test_tpcds_plans_round_trip(q):
    """Each plan, and each bound subquery plan with its BoundRefs."""
    plans = _tpcds_plans(q) if q != "q90_scalar" else None
    if plans is None:
        s = Session(device="cpu")
        plans = [tpcds.q90_scalar(s)] + [s.subquery_plan(i) for i in range(2)]
    for plan in plans:
        back = _round_trip(plan)
        if plan.schema is None:
            assert P.bind_plan(back).schema == P.bind_plan(plan).schema


def _drop(node, fields):
    """The parsed JSON without the named fields of each class."""
    if isinstance(node, dict):
        gone = fields.get(node.get("_k"), ())
        return {k: _drop(v, fields) for k, v in node.items() if k not in gone}
    if isinstance(node, list):
        return [_drop(v, fields) for v in node]
    return node


@pytest.mark.parametrize("q", ["q88", "q90_scalar"])
def test_json_equals_the_jax_packages(q):
    ps, js = Session(device="cpu"), JaxSession()
    if q == "q88":
        port, jax = tpcds.plan(q, ps), JTPCDS.q88(js)
    else:
        port, jax = tpcds.q90_scalar(ps), JTPCDS.q90_scalar(js)
    pairs = [(serde.plan_to_json(port), JS.plan_to_json(jax))]
    assert len(ps._subquery_plans) == len(js._subqueries) == (8 if q == "q88" else 2)
    for i, (bound, column) in enumerate(ps._subquery_plans):
        assert column == js._subqueries[i][1] == 0
        pairs.append((serde.plan_to_json(bound), JS.plan_to_json(js._subqueries[i][0])))
    for got, want in pairs:
        assert _drop(json.loads(got), PORT_ONLY) == _drop(json.loads(want), JAX_ONLY)


def _scalar_nodes_plan(E, P, T):
    """One plan holding each scalar-evaluator node and Sample."""
    sch = T.Schema([T.Field("t", T.TIMESTAMP), T.Field("n", T.TIMESTAMP_NTZ),
                    T.Field("s", T.string(12)), T.Field("x", T.INT64)])
    c = E.col
    exprs = [
        E.Alias(E.Cast(c("t"), T.string(26), E.EvalMode.ANSI, "Europe/Berlin"), "a"),
        E.Alias(E.Cast(c("s"), T.TIMESTAMP_NTZ), "b"),
        E.Alias(E.TemporalFunc("hour", (c("t"),), "America/New_York"), "h"),
        E.Alias(E.TemporalFunc("timestampdiff", (c("t"), c("t")), None, "MONTH"), "d"),
        E.Alias(E.StringFunc("lpad", (c("s"), E.lit(5), E.lit("0"))), "p"),
        E.Alias(E.HashFunc("xxhash64", (c("s"), c("x")), 7), "hx"),
        E.Alias(E.SplitPart(c("s"), ",", -1), "sp"),
        E.Alias(E.SubstringIndex(c("s"), ".", 2), "si"),
        E.Alias(E.Soundex(c("s")), "sx"),
        E.Alias(E.FormatNumber(c("x"), 2, 20), "fn"),
        E.Alias(E.RLike(c("s"), "a.c", True), "rl"),
        E.Alias(E.RegexpExtract(c("s"), "(\\d+)", 1, 8), "rx"),
        E.Alias(E.RegexpExtractAll(c("s"), "\\d+", 0, 4), "rxa"),
        E.Alias(E.RegexpReplace(c("s"), "\\d", "#"), "rr"),
        E.Alias(E.StringFunc("sha2", (c("s"), E.lit(384))), "sh"),
        E.Alias(E.StringFunc("get_json_object", (c("s"), E.lit("$.a"))), "gj"),
        E.Alias(E.RandExpr("randn", 3), "r"),
        E.Alias(E.MonotonicallyIncreasingId(), "id"),
        E.Alias(E.SparkPartitionId(), "pid")]
    return P.Sample(P.Scan("z", sch), 0.1, 0.4, False, 5).project(exprs)


def test_scalar_evaluator_nodes_json_equals_the_jax_packages():
    from datafusion_comet_tpu import types as JT
    from datafusion_comet_tpu.ir import expr as JE
    from datafusion_comet_tpu.ir import plan as JP
    from datafusion_comet_tpu_torch import types as PT
    from datafusion_comet_tpu_torch.ir import expr as PE

    port = _scalar_nodes_plan(PE, P, PT)
    got = serde.plan_to_json(port)
    assert json.loads(got) == json.loads(JS.plan_to_json(_scalar_nodes_plan(JE, JP, JT)))
    back = _round_trip(port)
    assert P.bind_plan(back).schema == P.bind_plan(_scalar_nodes_plan(PE, P, PT)).schema


def _nested_nodes_plan(E, P, T):
    """One plan holding each nested node, an Explode and the nested aggregates."""
    sch = T.Schema([T.Field("a", T.list_(T.INT64, 4)), T.Field("m", T.map_(T.string(3), T.INT32, 2)),
                    T.Field("s", T.string(12)), T.Field("x", T.INT64)])
    c, v = E.col, E.LambdaVar
    exprs = [
        E.Alias(E.ArrayExpr("array_contains", (c("a"), c("x"))), "ac"),
        E.Alias(E.MapExpr("element_at", (c("m"), E.lit("k"))), "me"),
        E.Alias(E.GetStructField(E.StructExpr((c("x"), c("s")), ("p", "q")), "q"), "gf"),
        E.Alias(E.HigherOrderFunc("transform", (c("a"),), ("y",), v("y") + 1), "tr"),
        E.Alias(E.HigherOrderFunc("aggregate", (c("a"), E.lit(0, T.INT64)), ("acc", "y"),
                                  v("acc") + v("y")), "ag"),
        E.Alias(E.Split(c("s"), ",", 6), "sp"), c("a"), c("x")]
    exploded = P.Explode(P.Scan("z", sch).project(exprs), c("a"), True, True)
    return exploded.aggregate([c("x")], [
        E.AggExpr("collect_list", c("col"), "cl", max_elems=8, filter=c("x") > E.lit(2)),
        E.AggExpr("collect_set", c("pos"), "cs", max_elems=4),
        E.AggExpr("percentile", c("col"), "pc", extra=(E.lit((0.5, 0.9),
                                                            T.list_(T.FLOAT64, 2)),))])


def test_nested_nodes_json_equals_the_jax_packages():
    from datafusion_comet_tpu import types as JT
    from datafusion_comet_tpu.ir import expr as JE
    from datafusion_comet_tpu.ir import plan as JP
    from datafusion_comet_tpu_torch import types as PT
    from datafusion_comet_tpu_torch.ir import expr as PE

    port = _nested_nodes_plan(PE, P, PT)
    got = serde.plan_to_json(port)
    want = JS.plan_to_json(_nested_nodes_plan(JE, JP, JT))
    assert _drop(json.loads(got), PORT_ONLY) == _drop(json.loads(want), JAX_ONLY)
    back = _round_trip(port)
    assert P.bind_plan(back).schema == P.bind_plan(_nested_nodes_plan(PE, P, PT)).schema

"""PyTorch port, the operator registry and the gates (exec/registry.py)
and Session.validate: the JAX package's tests/test_registry.py and
tests/test_validate.py on the port, with ``Config.gates`` in place of the
JAX package's process config, each reason string equal to the JAX
package's (its config set and restored around its call); every TPC-H and
TPC-DS plan of the port validates to [] over tables with no rows; TPC-H Q3
with its HashJoin gate off gives the JAX package's reason; an extension
registers a node of its own; a node with no executor gives the JAX
reason."""

import dataclasses

import numpy as np
import pytest
import torch

from _torch_threads import one_torch_thread  # noqa: F401 (a fixture)
from datafusion_comet_tpu import types as JT
from datafusion_comet_tpu.conf import CONF
from datafusion_comet_tpu.exec.engine import Session as JaxSession
from datafusion_comet_tpu.ir import expr as JE
from datafusion_comet_tpu.ir import plan as JP
from datafusion_comet_tpu.models import tpch as JTPCH
from datafusion_comet_tpu_torch import types as PT
from datafusion_comet_tpu_torch.conf import Config
from datafusion_comet_tpu_torch.exec import batch as PB
from datafusion_comet_tpu_torch.exec import registry as REG
from datafusion_comet_tpu_torch.exec.engine import Session, UnsupportedPlanError, run_plan
from datafusion_comet_tpu_torch.ir import expr as PE
from datafusion_comet_tpu_torch.ir import plan as PP
from datafusion_comet_tpu_torch.models import tpcds, tpch

pytestmark = pytest.mark.usefixtures("one_torch_thread")


def _sessions(conf=None):
    """(JAX session, port session) over the tables of both test files."""
    data = {"t": ({"k": np.arange(8, dtype=np.int64), "v": np.arange(8, dtype=np.int64) * 10},
                  lambda T: T.Schema([T.Field("k", T.INT64, False), T.Field("v", T.INT64, False)])),
            "u": ({"x": np.arange(4, dtype=np.int32), "s": np.array(["a", "b", "c", "d"], object)},
                  lambda T: T.Schema([T.Field("x", T.INT32), T.Field("s", T.string(8))]))}
    js, ps = JaxSession(), Session(device="cpu", conf=conf)
    for name, (d, sch) in data.items():
        js.register_numpy(name, d, sch(JT))
        ps.register_numpy(name, d, sch(PT))
    return js, ps


def _agg(E, P, T):
    sch = T.Schema([T.Field("k", T.INT64, False), T.Field("v", T.INT64, False)])
    return (P.Scan("t", sch).filter(E.col("k") > E.lit(2))
            .aggregate([], [E.AggExpr("sum", E.col("v"), "s")]))


def _sqrt(E, P, T):
    sch = T.Schema([T.Field("k", T.INT64, False), T.Field("v", T.INT64, False)])
    return P.Scan("t", sch).project(
        [E.MathFunc("sqrt", (E.col("v").cast(T.FLOAT64),)).alias("r")])


def _u(T):
    return T.Schema([T.Field("x", T.INT32), T.Field("s", T.string(8))])


def _validate_plans(E, P, T):
    """tests/test_validate.py's plans."""
    return {"supported": P.Scan("u", _u(T)).filter(E.col("x") > E.lit(1)).project([E.col("s")]),
            "unknown_column": P.Scan("u", _u(T)).project([E.col("nope")]),
            "unsupported": P.Scan("u", _u(T)).project([E.StringFunc("soundex",
                                                                    (E.col("s"),))])}


def _jax_validate(js, plan, key=None):
    if key is None:
        return js.validate(plan)
    CONF.set(key, False)
    try:
        return js.validate(plan)
    finally:
        CONF.set(key, True)


@pytest.mark.parametrize("key,build", [
    ("comet.exec.operator.HashAggregate.enabled", _agg),
    ("comet.expr.gt.enabled", _agg),
    ("comet.expr.sqrt.enabled", _sqrt)])
def test_gates_give_jax_reasons(key, build):
    js, _ = _sessions()
    _, ps = _sessions(Config(gates={key: False}))
    want = _jax_validate(js, build(JE, JP, JT), key)
    reasons = ps.validate(build(PE, PP, PT))
    assert reasons == want and len(reasons) == 1 and key in reasons[0]
    with pytest.raises(UnsupportedPlanError) as ei:
        ps.collect(build(PE, PP, PT))
    assert ei.value.reasons == reasons
    _, ok = _sessions()
    assert ok.validate(build(PE, PP, PT)) == []
    if build is _agg:
        assert int(ok.collect(build(PE, PP, PT))["s"][0]) == 250


@pytest.mark.parametrize("name", ["supported", "unknown_column", "unsupported"])
def test_validate_reasons_equal_jax(name):
    js, ps = _sessions()
    want = js.validate(_validate_plans(JE, JP, JT)[name])
    got = ps.validate(_validate_plans(PE, PP, PT)[name])
    assert got == want
    assert (got == []) == (name == "supported")


def test_cast_gate_and_udf_not_run():
    """An incompatible cast pair under allowIncompatible off (its pair and
    key as the JAX package's reason has them); validate runs no UDF."""
    key = "comet.expression.Cast.allowIncompatible"
    js, _ = _sessions()
    _, ps = _sessions(Config(gates={key: False}))

    def plan(E, P, T):
        return P.Scan("t", T.Schema([T.Field("k", T.INT64, False), T.Field("v", T.INT64, False)])
                      ).project([E.col("v").cast(T.FLOAT64).cast(T.string(30)).alias("c")])

    want = _jax_validate(js, plan(JE, JP, JT), key)
    got = ps.validate(plan(PE, PP, PT))
    assert len(got) == len(want) == 1
    assert got[0].split(" (")[0] == want[0].split(" (")[0] == "cast DOUBLE->STRING is Incompatible"
    assert got[0].endswith(f"; set {key}=true to allow") and want[0].endswith("to allow")
    calls = []
    udf = PE.PythonUdf(lambda v: calls.append(v) or v, (PE.col("x"),), PT.INT32)
    assert ps.validate(PP.Scan("u", _u(PT)).project([udf])) == []
    assert calls == []


def _empty_session(schemas, conf=None):
    s = Session(device="cpu", conf=conf)
    for name, sch in schemas.items():
        data = {f.name: np.array([], dtype=object if f.dtype.is_binary else f.dtype.np_dtype())
                for f in sch.fields}
        s.register_batch(name, PB.from_numpy(data, sch, "cpu"))
    return s


def test_every_plan_validates_and_q3_gate_reason_equals_jax():
    s = _empty_session(tpch.SCHEMAS)
    for q, build in tpch.QUERIES.items():
        assert s.validate(build()) == [], q
    d = _empty_session(tpcds.SCHEMAS)
    for q in tpcds.QUERIES:
        assert d.validate(tpcds.plan(q, d)) == [], q
    key = "comet.exec.operator.HashJoin.enabled"
    off = _empty_session(tpch.SCHEMAS, Config(gates={key: False}))
    js = JaxSession()
    assert off.validate(tpch.q3()) == _jax_validate(js, JTPCH.q3(), key) == [
        f"operator HashJoin disabled by {key}"]


@dataclasses.dataclass(eq=False)
class EveryOther(PP.PlanNode):
    child: PP.PlanNode

    def children(self):
        return (self.child,)

    def with_children(self, kids):
        return EveryOther(kids[0])


@REG.OPERATORS.register(EveryOther, name="EveryOther")
def _exec_every_other(plan, tables, ctx, conf, fanout):
    child = run_plan(plan.child, tables, ctx, conf, fanout)
    keep = (torch.arange(child.capacity) % 2) == 0
    return child.with_mask(child.row_mask & keep)


def test_custom_operator_and_unregistered_node():
    _, ps = _sessions()
    sch = PT.Schema([PT.Field("k", PT.INT64, False), PT.Field("v", PT.INT64, False)])
    node = EveryOther(PP.Scan("t", sch))
    node.schema = sch
    assert list(ps.collect(PP.bind_plan(PP.Projection(node, (PE.col("v"),))))["v"]) == \
        [0, 20, 40, 60]
    off = Session(device="cpu", conf=Config(gates={"comet.exec.operator.EveryOther.enabled":
                                                   False}))
    off.tables = ps.tables
    assert off.validate(PP.bind_plan(PP.Projection(node, (PE.col("v"),)))) == [
        "operator EveryOther disabled by comet.exec.operator.EveryOther.enabled"]

    @dataclasses.dataclass(eq=False)
    class Mystery(PP.PlanNode):
        child: PP.PlanNode

        def children(self):
            return (self.child,)

    with pytest.raises(UnsupportedPlanError) as ei:
        REG.OPERATORS.resolve(Mystery)
    assert ei.value.reasons == ["operator Mystery: no registered executor"]
    assert REG.OPERATORS.gate(PP.ShuffleExchange) is None
    assert set(REG.EXPR_GATES) >= {"RLike", "PythonUdf", "md5", "get_json_object"}

"""PyTorch port, the overflow re-runs held to the memory budget
(exec/engine.py ``_execute_retry``, ``_rebudget``, ``_oom_rebudget``;
exec/memory.py ``plan_peak_bytes`` at a growth scale) and the scalar
subquery of several rows:

- ``plan_peak_bytes`` at scale 1 is the JAX package's count, on every
  ported TPC-H query's stages;
- an aggregate whose groups overflow a wrong capacity, under a budget that
  its first attempt fits and its x4 re-run does not: the re-run is tiled
  (``Session.rebudgets``), not allocated whole; every attempt's estimate is
  within the budget, and the answer is the direct run's and the JAX
  package's;
- an aggregate whose groups outgrow every attempt's capacity takes the
  groups its attempts counted on its last attempt, where the JAX package
  raises (ROADMAP C24); where the JAX package's growth suffices, the
  attempts are its own;
- a stage attempt that runs out of the card's memory is planned again
  under a quarter of its estimate (tiled) and gives the same answer;
- a scalar subquery with more than one row raises the port's
  SCALAR_SUBQUERY_TOO_MANY_ROWS, where the JAX package takes its first row
  (ROADMAP C22)."""

import numpy as np
import pytest
import torch

from datafusion_comet_tpu import types as JT
from datafusion_comet_tpu.exec.engine import Session as JaxSession
from datafusion_comet_tpu.exec.memory import plan_peak_bytes as jax_peak
from datafusion_comet_tpu.ir import expr as JE
from datafusion_comet_tpu.ir import plan as JP
from datafusion_comet_tpu.models import tpch as JTPCH
from datafusion_comet_tpu_torch import types as PT
from datafusion_comet_tpu_torch.conf import Config
from datafusion_comet_tpu_torch.exec import engine as ENG
from datafusion_comet_tpu_torch.exec.engine import QueryExecutionError, Session
from datafusion_comet_tpu_torch.exec.memory import CPU_MEMORY_LIMIT, plan_peak_bytes
from datafusion_comet_tpu_torch.ir import expr as PE
from datafusion_comet_tpu_torch.ir import plan as PP
from datafusion_comet_tpu_torch.models import tpch
from test_torch_hints import jax_attempts  # noqa: F401 (a fixture)
from test_torch_smj import _same
from _torch_threads import one_torch_thread  # noqa: F401 (a fixture)

pytestmark = pytest.mark.usefixtures("one_torch_thread")

PKG = {"jax": (JT, JE, JP), "port": (PT, PE, PP)}
N = 20_000


@pytest.mark.parametrize("q", ["q1", "q3", "q5", "q12", "q18"])
def test_scale_one_estimate_is_jax_count(q):
    names = ("lineitem", "orders", "customer", "supplier", "nation", "region")
    data = tpch.generate_tables(names, 0.01)
    js, ps = JaxSession(), Session(device="cpu")
    for t in names:
        js.register_numpy(t, data[t], JTPCH.SCHEMAS[t])
        ps.register_numpy(t, data[t], tpch.SCHEMAS[t])
    plan_of = (lambda M: getattr(M, q)())
    got = [plan_peak_bytes(st, 1 << 16) for _, st in ps._plan_stages(plan_of(tpch))]
    want = [jax_peak(st, 1 << 16) for _, st in js._plan_stages(plan_of(JTPCH))]
    assert got == want
    assert all(plan_peak_bytes(st, 1 << 16, 4) != g
               for (_, st), g in zip(ps._plan_stages(plan_of(tpch)), got)
               if any(isinstance(n, PP.HashAggregate) for n in _walk(st)))


def _walk(p):
    yield p
    for c in p.children():
        yield from _walk(c)


def _schema(M):
    return M.Schema([M.Field("g", M.INT64), M.Field("v", M.INT64)])


def _data(groups: int):
    rng = np.random.default_rng(groups)
    return {"g": rng.integers(0, groups, N).astype(np.int64),
            "v": rng.integers(-1000, 1000, N).astype(np.int64)}


def _plan(pkg, max_groups: int):
    """SUM and COUNT per g, with a group capacity set (wrong) by hand."""
    M, E, P = PKG[pkg]
    agg = P.Scan("t", _schema(M)).aggregate(
        [E.col("g")], [E.AggExpr("sum", E.col("v"), "s"), E.AggExpr("count", None, "c")])
    agg.max_groups = max_groups
    return agg


def _sessions(groups: int, fraction=None):
    data = _data(groups)
    js = JaxSession()
    js.register_numpy("t", data, _schema(JT))
    ps = Session(device="cpu", conf=Config(memory_fraction=fraction) if fraction else None)
    ps.register_numpy("t", data, _schema(PT))
    return js, ps


def _sorted_rows(out):
    order = np.argsort(out["g"], kind="stable")
    return {k: np.asarray(v)[order] for k, v in out.items()}


def test_a_rerun_over_the_budget_runs_tiled(jax_attempts):  # noqa: F811
    js, direct = _sessions(3000)
    bound = PP.bind_plan(_plan("port", 1024))
    cap = direct.tables["t"].capacity
    one, four = plan_peak_bytes(bound, cap, 1), plan_peak_bytes(bound, cap, 4)
    assert one < four
    budget = (one + four) // 2
    _, ps = _sessions(3000, budget / CPU_MEMORY_LIMIT)
    assert ps.budget_bytes() < four and ps.budget_bytes() >= one
    want = _sorted_rows(js.collect(_plan("jax", 1024)))
    got = ps.collect(_plan("port", 1024))
    assert ps.rebudgets and ps.rebudgets[0]["scale"] == 4 and ps.rebudgets[0]["tiled"]
    stage_runs = [r for r in ps.runs if r["where"] == "stage"]
    assert stage_runs[0]["overflowed"] and "HashAggregate g" in stage_runs[0]["overflow_ops"]
    assert all(r["estimate"] <= ps.budget_bytes() for r in stage_runs)
    assert any(r["where"] == "tiled" for r in ps.runs)
    _same(want, _sorted_rows(got))
    _same(_sorted_rows(direct.collect(_plan("port", 1024))), _sorted_rows(got))
    assert not direct.rebudgets


def test_an_aggregate_takes_its_counted_groups(jax_attempts):  # noqa: F811
    """5,000 groups over a capacity of 64: x64 (4,096) is still too small.
    The JAX package's four attempts all overflow and it raises; the port's
    last attempt takes the groups its attempts counted, and answers as a
    run with room for every group does. With a capacity of 128 (x64 =
    8,192 fits), the attempts are the JAX package's."""
    js, ps = _sessions(5000)
    jax_attempts.clear()
    with pytest.raises(Exception, match="retries|overflow"):
        js.collect(_plan("jax", 64))
    got = ps.collect(_plan("port", 64))
    assert [s for s, _ in jax_attempts] == [1, 4, 16, 64]
    assert [(r["scale"], r["overflowed"]) for r in ps.runs] == [
        (1, True), (4, True), (16, True), (64, False)]
    _same(_sorted_rows(ps.collect(_plan("port", 1 << 14))), _sorted_rows(got))
    jax_attempts.clear()
    _same(js.collect(_plan("jax", 128)), ps.collect(_plan("port", 128)))
    assert [(r["scale"], r["unique_join_ok"]) for r in ps.runs] == jax_attempts


def test_an_out_of_memory_attempt_is_planned_again_tiled(monkeypatch):
    js, ps = _sessions(2000)
    want = _sorted_rows(ps.collect(_plan("port", 4096)))
    real = Session._run_once
    calls = {"n": 0}

    def oom_once(self, plan, *a, **kw):
        calls["n"] += 1
        if calls["n"] == 1:
            raise torch.OutOfMemoryError("a stage ran out of the card's memory")
        return real(self, plan, *a, **kw)

    monkeypatch.setattr(Session, "_run_once", oom_once)
    got = ps.collect(_plan("port", 4096))
    assert [r.get("oom") for r in ps.rebudgets] == [True] and ps.tiled
    _same(want, _sorted_rows(got))


def test_nothing_to_cut_lets_the_error_stand(monkeypatch):
    """A stage with no aggregate or join to cut: the error is raised."""
    _, ps = _sessions(10)

    def oom(self, plan, *a, **kw):
        raise torch.OutOfMemoryError("out of memory")

    monkeypatch.setattr(Session, "_run_once", oom)
    with pytest.raises(torch.OutOfMemoryError):
        ps.collect(PP.Scan("t", _schema(PT)).filter(PE.col("v") > PE.lit(0)))
    assert ENG._OOM_REPLANS >= 1


def test_a_scalar_subquery_of_several_rows_raises():
    js, ps = _sessions(10)
    outs = {}
    for pkg, s in (("jax", js), ("port", ps)):
        M, E, P = PKG[pkg]
        sub = s.scalar_subquery(P.Scan("t", _schema(M)).filter(E.col("v") > E.lit(990))
                                .project([E.col("v")]))
        plan = P.Scan("t", _schema(M)).filter(E.col("v") == sub).project([E.col("g")])
        if pkg == "jax":
            outs[pkg] = s.collect(plan)
        else:
            with pytest.raises(QueryExecutionError, match="SCALAR_SUBQUERY_TOO_MANY_ROWS"):
                s.collect(plan)
    first = _data(10)["v"][_data(10)["v"] > 990][0]
    assert len(outs["jax"]["g"]) == int((_data(10)["v"] == first).sum())

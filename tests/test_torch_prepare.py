"""PyTorch port, ``Session.prepare`` (exec/engine.py; JAX ``engine.py:812``):
a warm-up plans and settles each stage, then every call re-runs the
settled stages with no planning, and gives ``collect``'s answer:

- TPC-H Q1 (one stage) against the JAX package's prepared runner, and Q3
  and Q5 (staged: the JAX test_staged shape), Q12 (whose direct run
  re-runs once, its unique-build hint wrong) over two calls each: equal to
  ``collect``, no run recorded as overflowed, no planning;
- Q12 under the budget that splits its join into K = 16 pairs (the JAX
  test_grace_join shape): every call runs the grace join again, each pair
  at its settled attempt;
- TPC-DS q88 (eight scalar subqueries): each call runs every subquery
  again, itself prepared (ROADMAP divergence b);
- a table registered again with more groups than the settled capacity:
  the call raises JoinOverflowError (divergence a: the JAX package's runner
  ignores the flag), and ``collect`` still answers."""

import numpy as np
import pytest

import chip_smoke
from datafusion_comet_tpu.exec.batch import to_numpy as jax_to_numpy
from datafusion_comet_tpu.exec.engine import Session as JaxSession
from datafusion_comet_tpu.models import tpch as JTPCH
from datafusion_comet_tpu_torch import types as PT
from datafusion_comet_tpu_torch.exec.batch import to_numpy
from datafusion_comet_tpu_torch.exec.engine import JoinOverflowError, Session
from datafusion_comet_tpu_torch.ir import expr as PE
from datafusion_comet_tpu_torch.ir import plan as PP
from datafusion_comet_tpu_torch.models import tpcds, tpch
from datafusion_comet_tpu_torch.tools.query_times import grace_session
from test_torch_smj import _same
from _torch_tpcds import tables as tpcds_tables
from _torch_threads import one_torch_thread  # noqa: F401 (a fixture)

pytestmark = pytest.mark.usefixtures("one_torch_thread")

NAMES = ("lineitem", "orders", "customer", "supplier", "nation", "region")


@pytest.fixture(scope="module")
def sess():
    data = tpch.generate_tables(NAMES, 0.01)
    s = Session(device="cpu")
    for t in NAMES:
        s.register_numpy(t, data[t], tpch.SCHEMAS[t])
    return s, data


def _calls(s, plan_of, n=2):
    """``collect``'s answer, then ``n`` calls of the prepared runner, each
    with its runs."""
    want = s.collect(plan_of())
    direct_runs = list(s.runs)
    run = s.prepare(plan_of())
    calls = []
    for _ in range(n):
        calls.append((to_numpy(run()), list(s.runs), s.plan_ms))
    return want, direct_runs, run, calls


def test_q1_prepared_equals_jax_prepared(sess):
    s, data = sess
    js = JaxSession()
    js.register_numpy("lineitem", data["lineitem"], JTPCH.SCHEMAS["lineitem"])
    jrun = js.prepare(JTPCH.q1())
    want, _, run, calls = _calls(s, tpch.q1)
    for got, runs, plan_ms in calls:
        _same(jax_to_numpy(jrun()), got)
        _same(want, got)
        assert [r["overflowed"] for r in runs] == [False] and plan_ms == 0.0
    assert run.plan_ms > 0.0


@pytest.mark.parametrize("q", ["q3", "q5", "q12"])
def test_staged_plans_replay_their_settled_attempts(sess, q):
    s, _ = sess
    plan_of = getattr(tpch, q)
    want, direct_runs, _, calls = _calls(s, plan_of)
    stages = len(s.stages)
    assert stages >= (2 if q != "q12" else 1)
    if q == "q12":  # the direct run re-runs without the wrong unique hint
        assert [r["overflowed"] for r in direct_runs] == [True, False]
    settled = [r["scale"] for r in direct_runs if not r["overflowed"]]
    for got, runs, _ in calls:
        _same(want, got)
        assert not any(r["overflowed"] for r in runs)
        assert [r["scale"] for r in runs] == settled


def test_grace_prestep_runs_on_every_call(sess):
    s, _ = sess
    fraction, _ = chip_smoke.grace_fraction(s, tpch.q12(), 16)
    g = grace_session(s, fraction)
    want = g.collect(tpch.q12())
    assert [r.K for r in g.grace_runners] == [16]
    run = g.prepare(tpch.q12())
    for _ in range(2):
        got = to_numpy(run())
        _same(want, got)
        pairs = [r for r in g.runs if r["where"] == "pair"]
        assert pairs and not any(r["overflowed"] for r in g.runs)
        assert [r.K for r in g.grace_runners] == [16]


def test_q88_reruns_its_subqueries_each_call():
    data = tpcds_tables("q88", 0.02)
    s = Session(device="cpu")
    for t, d in data.items():
        s.register_numpy(t, d, tpcds.SCHEMAS[t])
    want = s.collect(tpcds.plan("q88", s))
    run = s.prepare(tpcds.plan("q88", s))
    for _ in range(2):
        got = to_numpy(run())
        _same(want, got)
        assert len(s.subqueries) == 8
        assert not any(r["overflowed"] for sq in s.subqueries for r in sq["runs"])


def _group_table(s, groups: int):
    """4096 rows over ``groups`` keys spread across [0, 3999], 0 and 3999
    among them: the statistics' key range stays the same."""
    rng = np.random.default_rng(groups)
    n = 4096
    keys = np.unique(np.concatenate([[0, 3999], rng.choice(4000, groups - 2, replace=False)]))
    schema = PT.Schema([PT.Field("g", PT.INT64), PT.Field("v", PT.INT64)])
    s.register_numpy("t", {"g": keys[rng.integers(0, len(keys), n)].astype(np.int64),
                           "v": rng.integers(0, 100, n).astype(np.int64)}, schema)
    return schema


def test_a_changed_table_raises_at_its_settled_capacity():
    """A prepared plan holds for the tables it was planned on: one that
    outgrows a settled capacity raises; one that leaves the statistics'
    key ranges is not detected (in neither package), so none does here."""
    s = Session(device="cpu")
    schema = _group_table(s, 50)

    def plan():
        return PP.Scan("t", schema).aggregate([PE.col("g")], [PE.AggExpr("sum", PE.col("v"), "s")])

    run = s.prepare(plan())
    assert len(to_numpy(run())["g"]) == 50
    _group_table(s, 4000)  # about 2,500 groups: over the settled capacity
    with pytest.raises(JoinOverflowError, match="changed since prepare"):
        run()
    assert len(s.collect(plan())["g"]) > 2000


def test_nested_grace_presteps_run_on_every_call(sess):
    """Q5 under the budget that partitions its first join at K = 16 and,
    inside it, the lineitem-orders join: each call runs both grace joins
    again (the inner one anew, its temporary table with it) and answers as
    collect does."""
    s, _ = sess
    fraction, _ = chip_smoke.grace_fraction(s, tpch.q5(), 16)
    g = grace_session(s, fraction)
    want = g.collect(tpch.q5())
    assert len(g.grace_runners) >= 2
    run = g.prepare(tpch.q5())
    for _ in range(2):
        _same(want, to_numpy(run()))
        assert not any(r["overflowed"] for r in g.runs)

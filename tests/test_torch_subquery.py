"""PyTorch port, a session's scalar subqueries (``Session.scalar_subquery``,
``E.ScalarSubquery``) against the JAX ``Session``: structurally equal
subqueries share one id and one run an ``execute`` (the port's form of the
JAX package's ``test_scalar_subquery_reuse``); a subquery over no row, or
whose value is null, is a null; TPC-DS q90 in its scalar-subquery form at
SF 0.02 (values, attempts in the JAX package's order, each subquery's
stage hints) against numpy; and ROADMAP C21: a subquery's value lives for
one ``execute`` in the port, as Spark evaluates it once per query, and for
the session's life in the JAX package, which then answers from a stale
value after its table is registered again (the port's answer held to
numpy); and a dimension filter that compares with a subquery and probes a
bloom filter: the estimates, hints and runtime filter the JAX walk gives.
q88's subqueries under the grace join are in ``test_torch_q88.py``."""

import numpy as np
import pytest

import _torch_tpcds as H
import chip_smoke
from datafusion_comet_tpu import types as JT
from datafusion_comet_tpu.exec.engine import Session as JaxSession
from datafusion_comet_tpu.ir import expr as JE
from datafusion_comet_tpu.ir import plan as JP
from datafusion_comet_tpu_torch import types as PT
from datafusion_comet_tpu_torch.exec.engine import Session
from datafusion_comet_tpu_torch.ir import expr as PE
from datafusion_comet_tpu_torch.ir import plan as PP
from datafusion_comet_tpu_torch.models import tpcds
from test_torch_hints import jax_attempts  # noqa: F401 (a fixture)
from _torch_threads import one_torch_thread  # noqa: F401 (a fixture)

pytestmark = pytest.mark.usefixtures("one_torch_thread")

PKGS = {"jax": (JT, JE, JP, JaxSession), "port": (PT, PE, PP, lambda: Session(device="cpu"))}


def _session(pkg, values):
    T, E, P, S = PKGS[pkg]
    s = S()
    s.register_numpy("t", {"v": values}, T.Schema([T.Field("v", T.INT64, False)]))
    return s


def _scan(pkg):
    T, E, P, _ = PKGS[pkg]
    return P.Scan("t", T.Schema([T.Field("v", T.INT64, False)]))


@pytest.mark.parametrize("pkg", sorted(PKGS))
def test_equal_subqueries_share_one_id_and_one_run(pkg):
    T, E, P, _ = PKGS[pkg]
    s = _session(pkg, np.arange(16, dtype=np.int64))

    def sub(func):
        return _scan(pkg).aggregate([], [E.AggExpr(func, E.col("v"), "m")])

    a, b = s.scalar_subquery(sub("max")), s.scalar_subquery(sub("max"))
    c = s.scalar_subquery(sub("min"))
    assert a.subquery_id == b.subquery_id != c.subquery_id
    out = s.collect(_scan(pkg).project([(E.col("v") + a).alias("x"), (E.col("v") + b).alias("y")]))
    assert list(out["x"]) == list(out["y"]) == [15 + i for i in range(16)]
    if pkg == "port":  # one run, and none of the subquery the plan does not hold
        assert [(r["id"], r["value"], r["valid"]) for r in s.subqueries] == [(a.subquery_id, 15,
                                                                             True)]


@pytest.mark.parametrize("pkg", sorted(PKGS))
def test_subquery_over_no_row_is_null(pkg):
    """A MAX over no row is one null row; a plan with no row at all gives
    a null too; the subquery's type is its column's."""
    T, E, P, _ = PKGS[pkg]
    s = _session(pkg, np.arange(8, dtype=np.int64))
    empty = _scan(pkg).filter(E.col("v") < E.lit(0))
    agg = s.scalar_subquery(empty.aggregate([], [E.AggExpr("max", E.col("v"), "m")]))
    rows = s.scalar_subquery(empty.project([E.col("v")]))
    assert agg.dtype == rows.dtype == T.INT64
    out = s.collect(_scan(pkg).project([(E.col("v") + agg).alias("x"), rows.alias("y"),
                                        E.col("v")]))
    assert not out["x__valid"].any() and not out["y__valid"].any()
    assert list(out["v"]) == list(range(8))


def test_q90_scalar_matches_jax_and_numpy(jax_attempts):
    data = {t: H.tables("q90", 0.02)[t] for t in ("time_dim", "web_sales")}
    js, ps = H.sessions(data)
    assert H.rf_hints(ps._plan_stages(tpcds.q90_scalar(ps)), PP) == H.rf_hints(
        js._plan_stages(H.JTPCDS.q90_scalar(js)), JP)
    got_hints, want_hints = H.subquery_hints(js, ps)
    assert got_hints == want_hints and len(got_hints) == 2
    jax_attempts.clear()
    want = js.collect(H.JTPCDS.q90_scalar(js))
    got = ps.collect(tpcds.q90_scalar(ps))
    H.same(want, got)
    assert H.attempts(ps) == jax_attempts and len(ps.subqueries) == 2
    assert chip_smoke.out_rows(got, ("am_pm_ratio",)) == chip_smoke.oracle_ds_q90_scalar(data)


def test_c21_a_value_lives_for_one_execute():
    """The same session and plan collected, the table registered again with
    new values, collected again: the port runs the subquery again (numpy's
    answer), the JAX package answers from the first run's value."""
    first, second = np.arange(16, dtype=np.int64), np.arange(100, 132, dtype=np.int64)
    outs = {}
    for pkg in PKGS:
        T, E, P, _ = PKGS[pkg]
        s = _session(pkg, first)
        sub = s.scalar_subquery(_scan(pkg).aggregate([], [E.AggExpr("max", E.col("v"), "m")]))
        plan = _scan(pkg).project([(E.col("v") + sub).alias("x")])
        before = s.collect(plan)["x"]
        s.register_numpy("t", {"v": second}, T.Schema([T.Field("v", T.INT64, False)]))
        outs[pkg] = (before, s.collect(plan)["x"], s)
    for pkg in PKGS:
        np.testing.assert_array_equal(outs[pkg][0], first + first.max())
    np.testing.assert_array_equal(outs["port"][1], second + second.max())
    np.testing.assert_array_equal(outs["jax"][1], second + first.max())  # stale
    assert len(outs["port"][2].subqueries) == 1  # run again, once


def _subquery_filtered_join(pkg, session):
    """store_sales joined to the Books items priced over the average price
    (a scalar subquery) that pass a bloom filter of the Books items (a
    BLOOM_FILTER subquery), revenue per brand."""
    E, P, M = (JE, JP, H.JTPCDS) if pkg == "jax" else (PE, PP, tpcds)
    item = P.Scan("item", M.SCHEMAS["item"])
    books = E.col("i_category") == E.lit("Books")
    avg_price = session.scalar_subquery(item.aggregate(
        [], [E.AggExpr("avg", E.col("i_current_price"), "p")]))
    bloom = session.scalar_subquery(P.Scan("item", M.SCHEMAS["item"]).filter(books).aggregate(
        [], [E.AggExpr("bloom_filter", E.col("i_item_sk"), "f", num_bits=1 << 16,
                       extra=(E.lit(2000),))]))
    it = P.Scan("item", M.SCHEMAS["item"]).filter(
        books & (E.col("i_current_price") > avg_price)
        & E.BloomMightContain(bloom, E.col("i_item_sk")))
    j = P.HashJoin(P.Scan("store_sales", M.SCHEMAS["store_sales"]), it, (E.col("ss_item_sk"),),
                   (E.col("i_item_sk"),))
    return j.aggregate([E.col("i_brand")], [E.AggExpr("sum", E.col("ss_quantity"), "q")]).sort(
        [E.SortOrder(E.col("i_brand"))])


def test_subquery_and_bloom_conjuncts_plan_as_the_jax_package(jax_attempts):
    """A dimension filter with a comparison against a subquery and a bloom
    probe, over a fact scan large enough for a runtime filter (SF 0.25:
    75,000 store_sales rows): the stats walk's estimates, the hints and the
    injected runtime filter (the host evaluator skips both conjuncts, a
    superset) equal the JAX package's, as do the answer and the attempts."""
    data = {t: tpcds.generate_table(t, 0.25) for t in ("item", "store_sales")}
    js, ps = H.sessions(data)
    want_stages = js._plan_stages(_subquery_filtered_join("jax", js))
    got_stages = ps._plan_stages(_subquery_filtered_join("port", ps))
    assert H.rf_hints(got_stages, PP) == H.rf_hints(want_stages, JP)
    assert any(getattr(j, "rf_injected", False) for _, sub in got_stages
               for j in _joins(sub))
    jax_attempts.clear()
    want = js.collect(_subquery_filtered_join("jax", js))
    got = ps.collect(_subquery_filtered_join("port", ps))
    H.same(want, got)
    assert H.attempts(ps) == jax_attempts and len(ps.subqueries) == 2


def _joins(p):
    return ([p] if isinstance(p, PP.HashJoin) else []) + [j for c in p.children()
                                                         for j in _joins(c)]

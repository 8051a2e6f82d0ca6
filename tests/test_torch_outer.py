"""PyTorch port, the outer hash joins (LEFT, RIGHT and FULL;
``exec/operators/join.py``) exactly against the JAX package:

- ``hash_join`` against the JAX ``hash_join`` on the same seeded inputs
  (null keys on both sides, dead probe rows, duplicate build keys, and a
  build side no probe key matches), on every path the port has: the
  compacted pair list, the (probe x K) block, the dense and the sorted
  unique build and two keys packed into one; with and without a condition.
  The row masks are equal slot for slot, and so are the live rows in order
  (values, and which of them are null). LEFT and FULL probe the left input,
  RIGHT the right one; the other way round raises in both packages;
- through the ``Session``: a LEFT join where an INNER one would have moved
  its build side, a RIGHT and a FULL join, with the planner's hints of the
  join against the JAX walk's, the attempts, and the results after the
  engine's compaction; and the runtime filters around outer joins (none
  planted by one, one pushed through a LEFT join's preserved side below an
  INNER join that drops the same rows, one held above a FULL join) in the
  same places as the JAX injector's;
- under the grace join (K = 16): LEFT and FULL joins with null keys on both
  sides, against the direct run and the JAX package's grace run, with the
  same K, mode, partition sizes and pair retries."""

import dataclasses
import warnings

import numpy as np
import pytest

import chip_smoke
from datafusion_comet_tpu import types as JT
from datafusion_comet_tpu.exec import batch as JB
from datafusion_comet_tpu.exec.engine import Session as JaxSession
from datafusion_comet_tpu.exec.operators import join as JJ
from datafusion_comet_tpu.ir import expr as JE
from datafusion_comet_tpu.ir import plan as JP
from datafusion_comet_tpu.models import tpch as JTPCH
from datafusion_comet_tpu_torch import types as PT
from datafusion_comet_tpu_torch.exec import batch as PB
from datafusion_comet_tpu_torch.exec.engine import Session
from datafusion_comet_tpu_torch.exec.evaluator import EvalContext
from datafusion_comet_tpu_torch.exec.operators import join as PJ
from datafusion_comet_tpu_torch.ir import expr as PE
from datafusion_comet_tpu_torch.ir import plan as PP
from datafusion_comet_tpu_torch.models import tpch
from test_torch_grace import _jax_session, _port_session, jax_fraction, jax_spy  # noqa: F401
from test_torch_hints import _ordered, jax_attempts, stage_hints  # noqa: F401 (a fixture)
from test_torch_join import _rows, _stage
from test_torch_q9 import one_torch_thread, rf_hints  # noqa: F401 (a fixture)

pytestmark = pytest.mark.usefixtures("one_torch_thread")

# per path: the build keys' duplicates, the join keys and the arguments
# that select it (the unique paths' key range is filled in per case)
PATHS = {
    "pair_list": (3, ("fk",), ("pk",), {"compact_rows": 4096}),
    "block": (3, ("fk",), ("pk",), {"max_build_matches": 4}),
    "dense_unique": (1, ("fk",), ("pk",), {"unique_build": True}),
    "sorted_unique": (1, ("fk",), ("pk",), {"unique_build": True}),
    "packed": (3, ("fk", "fk2"), ("pk", "pk2"),
               {"key_pack": ((0, 199), (0, 2)), "compact_rows": 8192}),
}
# per join type: (probe on the left, build side); the probe is the fact
# table and the build the dim table throughout
SIDES = {"left": (True, "right"), "right": (False, "left"), "full": (True, "right")}


def _shifted(b, M, delta):
    """The dim batch with every pk moved by ``delta`` (out of every fk's reach)."""
    i = [f.name for f in b.schema.fields].index("pk")
    cols = list(b.columns)
    cols[i] = dataclasses.replace(cols[i], data=cols[i].data + delta)
    return M.Batch(tuple(cols), b.row_mask, b.schema)


def _outer_both(join_type, path, cond=None, no_match=False, seed=11):
    """(JAX batch, flag), (port batch, flag, join log) of one outer join of
    the fact table (probe) and the dim table (build) on ``path``."""
    dup, fkeys, dkeys, kw = PATHS[path]
    jf, jd, pf, pd = _stage(seed, dup)
    if no_match:
        jd, pd = _shifted(jd, JB, 1000), _shifted(pd, PB, 1000)
    if path == "dense_unique":
        pk = pd.column("pk")
        live = pk.data[pk.validity & pd.row_mask]
        kw = dict(kw, build_key_range=(int(live.min()), int(live.max())))
    probe_left, build_side = SIDES[join_type]
    out = []
    for M, E, join, f, d in ((JT, JE, JJ, jf, jd), (PT, PE, PJ, pf, pd)):
        (l, lk), (r, rk) = ((f, fkeys), (d, dkeys)) if probe_left else ((d, dkeys), (f, fkeys))
        schema = M.Schema(list(l.schema.fields) + list(r.schema.fields))
        c = None if cond is None else E.bind(cond(E), schema)
        extra = {"ctx": EvalContext(join_log=[])} if M is PT else {}
        b, ovf = join.hash_join(l, r, [E.bind(E.col(k), l.schema) for k in lk],
                                [E.bind(E.col(k), r.schema) for k in rk], join_type, build_side,
                                schema, c, **kw, **extra)
        out.append((b, bool(ovf)) + ((extra["ctx"].join_log,) if M is PT else ()))
    return out


CONDS = {"none": None, "cond": lambda E: E.col("w") < E.col("fk2") * E.lit(20)}


@pytest.mark.parametrize("cond", sorted(CONDS))
@pytest.mark.parametrize("path", sorted(PATHS))
@pytest.mark.parametrize("join_type", sorted(SIDES))
def test_outer_join_matches_jax(join_type, path, cond):
    """Slot for slot the JAX join's output: the unmatched probe rows (null
    keys, keys the build lacks, rows whose every pair fails the condition)
    once each with a null build side, FULL's unmatched build rows (null
    keys among them) in the tail, dead probe rows nowhere."""
    (jb, jovf), (pb, povf, log) = _outer_both(join_type, path, CONDS[cond])
    assert [(e["type"], e["path"]) for e in log] == [(join_type, "pair_list" if path == "packed"
                                                      else path)]
    assert log[0]["out_capacity"] == pb.capacity == jb.capacity
    assert not jovf and not povf
    np.testing.assert_array_equal(pb.row_mask.numpy(), np.asarray(jb.row_mask))
    got = _ordered(PB.to_numpy(pb))
    assert got == _ordered(JB.to_numpy(jb))
    names = [f.name for f in pb.schema.fields]
    x, w = names.index("x"), names.index("w")
    assert sum(r[w] is None and r[x] is not None for r in got) > 20  # unmatched probe rows
    if join_type == "full":
        tail = [r for r in got if r[x] is None]
        assert len(tail) > 2 and all(r[w] is not None for r in tail)  # unmatched build rows


@pytest.mark.parametrize("path", ["pair_list", "block", "sorted_unique"])
@pytest.mark.parametrize("join_type", sorted(SIDES))
def test_outer_join_with_no_match_keeps_every_preserved_row(join_type, path):
    """No build key in the probe's range: every live probe row once with a
    null build side (FULL: and every live build row once), as in JAX."""
    (jb, _), (pb, _, _) = _outer_both(join_type, path, no_match=True)
    np.testing.assert_array_equal(pb.row_mask.numpy(), np.asarray(jb.row_mask))
    got = _ordered(PB.to_numpy(pb))
    assert got == _ordered(JB.to_numpy(jb))
    _, _, pf, pd = _stage(11, PATHS[path][0])
    live_build = int(pd.row_mask.sum()) if join_type == "full" else 0
    assert len(got) == int(pf.row_mask.sum()) + live_build


@pytest.mark.parametrize("join_type,build_side", [("left", "left"), ("right", "right")])
def test_outer_side_not_probed_raises_in_both(join_type, build_side):
    jf, jd, pf, pd = _stage(11, 3)
    for M, E, join, l, r in ((JT, JE, JJ, jf, jd), (PT, PE, PJ, pf, pd)):
        schema = M.Schema(list(l.schema.fields) + list(r.schema.fields))
        with pytest.raises(NotImplementedError, match="outer side must be the probe side"):
            join.hash_join(l, r, [E.bind(E.col("fk"), l.schema)],
                           [E.bind(E.col("pk"), r.schema)], join_type, build_side, schema)


# ---- through the Session: hints, attempts, compaction ---------------------------------


@pytest.fixture(scope="module")
def co_tables():
    return {t: tpch.generate_table(t, 0.01) for t in ("customer", "orders")}


def _co_plan(M, T, E, P, join_type):
    """customer and orders joined on the customer key: LEFT probes customer
    (an INNER join would build on it, the smaller side), RIGHT probes it
    from the right, FULL probes orders over a filtered customer."""
    c = P.Scan("customer", M.SCHEMAS["customer"])
    o = P.Scan("orders", M.SCHEMAS["orders"]).filter(
        E.col("o_orderdate") < E.lit(8500, T.DATE))
    ck, ok = (E.col("c_custkey"),), (E.col("o_custkey"),)
    if join_type == "left":
        j = P.HashJoin(c, o, ck, ok, P.JoinType.LEFT, "right")
    elif join_type == "right":
        j = P.HashJoin(o, c, ok, ck, P.JoinType.RIGHT, "left")
    else:
        c = c.filter(E.col("c_nationkey") < E.lit(5))
        j = P.HashJoin(o, c, ok, ck, P.JoinType.FULL, "right")
    return j.project([E.col("c_custkey"), E.col("c_nationkey"), E.col("o_orderkey"),
                      E.col("o_totalprice")])


@pytest.mark.parametrize("join_type", sorted(SIDES))
def test_outer_join_through_the_session_matches_jax(co_tables, jax_attempts, join_type):
    js, ps = JaxSession(), Session(device="cpu")
    for t, d in co_tables.items():
        js.register_numpy(t, d, JTPCH.SCHEMAS[t])
        ps.register_numpy(t, d, tpch.SCHEMAS[t])
    want_stages = js._plan_stages(_co_plan(JTPCH, JT, JE, JP, join_type))
    got_stages = ps._plan_stages(_co_plan(tpch, PT, PE, PP, join_type))
    assert stage_hints(got_stages, PP) == stage_hints(want_stages, JP)
    (join,) = [p for p in _nodes(got_stages[-1][1]) if isinstance(p, PP.HashJoin)]
    assert join.build_side == SIDES[join_type][1]
    # at least the preserved side's rows: customer's 1,500 (LEFT, RIGHT)
    assert join.out_rows_hint >= (1500 if join_type != "full" else 1)
    jax_attempts.clear()
    want = js.collect(_co_plan(JTPCH, JT, JE, JP, join_type))
    got = ps.collect(_co_plan(tpch, PT, PE, PP, join_type))
    assert [(r["scale"], r["unique_join_ok"]) for r in ps.runs] == jax_attempts
    assert _rows(got) == _rows(want)
    assert sum(1 for v in got["o_orderkey__valid"] if not v) > 100  # customers with no order


@pytest.fixture(scope="module")
def rf_tables():
    return {t: tpch.generate_table(t, 0.1) for t in ("customer", "orders")}


def _rf_plan(M, E, P, join_type):
    """orders LEFT (or FULL) JOIN customer, then an INNER join on o_custkey
    with one nation's BUILDING customers (1/125 of them): the INNER join
    plants a runtime filter on orders (150,000 rows at SF 0.1), and the JAX
    injector pushes it below the LEFT join into its preserved side, where
    a row it removes would be removed by the INNER join above anyway, and
    stops above the FULL join."""
    o = P.Scan("orders", M.SCHEMAS["orders"])
    c = P.Scan("customer", M.SCHEMAS["customer"])
    oc = P.HashJoin(o, c, (E.col("o_custkey"),), (E.col("c_custkey"),), join_type, "right")
    few = P.Scan("customer", M.SCHEMAS["customer"]).filter(
        (E.col("c_mktsegment") == E.lit("BUILDING")) & (E.col("c_nationkey") == E.lit(3))
    ).project([E.col("c_custkey").alias("k")])
    top = P.HashJoin(oc, few, (E.col("o_custkey"),), (E.col("k"),), P.JoinType.INNER, "right")
    return top.aggregate([], [E.AggExpr("count", None, "n"),
                              E.AggExpr("count", E.col("c_name"), "named")])


@pytest.mark.parametrize("join_type", ["left", "full"])
def test_runtime_filters_pass_outer_joins_as_in_jax(rf_tables, join_type):
    """The same runtime filters, in the same places, as the JAX package's:
    none planted by an outer join (Q13's LEFT join gets none), one pushed
    through a LEFT join's preserved side, one held above a FULL join; the
    same answer."""
    js, ps = JaxSession(), Session(device="cpu")
    for t, d in rf_tables.items():
        js.register_numpy(t, d, JTPCH.SCHEMAS[t])
        ps.register_numpy(t, d, tpch.SCHEMAS[t])
    jp, pp = _rf_plan(JTPCH, JE, JP, join_type), _rf_plan(tpch, PE, PP, join_type)
    want_stages, got_stages = js._plan_stages(jp), ps._plan_stages(pp)
    assert rf_hints(got_stages, PP) == rf_hints(want_stages, JP)
    (semi,) = [j for _, sub in got_stages for j in _nodes(sub)
               if isinstance(j, PP.HashJoin) and j.rf_injected]
    outer = [j for _, sub in got_stages for j in _nodes(sub)
             if isinstance(j, PP.HashJoin) and j.join_type == join_type]
    assert (semi in _nodes(outer[0])) == (join_type == "left")  # below the LEFT join
    assert _rows(ps.collect(pp)) == _rows(js.collect(jp))
    # Q13: its only join is LEFT, so nothing plants a filter
    q13_got, q13_want = ps._plan_stages(tpch.q13()), js._plan_stages(JTPCH.q13())
    assert rf_hints(q13_got, PP) == rf_hints(q13_want, JP)
    assert not any(j.rf_injected for _, sub in q13_got for j in _nodes(sub)
                   if isinstance(j, PP.HashJoin))


def _nodes(p):
    out = [p]
    for c in p.children():
        out += _nodes(c)
    return out


# ---- under the grace join ----------------------------------------------------------------


def _nullkey_tables(M, seed=5):
    """fact (5,000 rows, fk null on 5%) and dim (700 keys, two rows each, pk
    null on 10%): live rows with null keys on both sides."""
    rng = np.random.default_rng(seed)
    nf = 5000
    fact = {"fk": rng.integers(0, 1000, nf).astype(np.int64),
            "x": np.arange(nf, dtype=np.int64)}
    pk = np.repeat(rng.permutation(1000)[:700], 2).astype(np.int64)
    dim = {"pk": pk, "w": rng.integers(0, 50, len(pk)).astype(np.int32),
           "g": np.array(["east", "north", "south", "west"], object)[rng.integers(0, 4, len(pk))]}
    return {"fact": (fact, M.Schema([M.Field("fk", M.INT64), M.Field("x", M.INT64)]),
                     {"fk": rng.random(nf) > 0.05}),
            "dim": (dim, M.Schema([M.Field("pk", M.INT64), M.Field("w", M.INT32),
                                   M.Field("g", M.string(5))]), {"pk": rng.random(len(pk)) > 0.1})}


def _grace_plan(M, P, E, tables, join_type, how):
    j = P.HashJoin(P.Scan("fact", tables["fact"][1]), P.Scan("dim", tables["dim"][1]),
                   (E.col("fk"),), (E.col("pk"),), join_type, "right")
    if how == "plain":
        return j.project([E.col("x"), E.col("fk"), E.col("pk"), E.col("w"), E.col("g")])
    return j.aggregate([E.col("g")], [E.AggExpr("count", E.col("x"), "nx"),
                                      E.AggExpr("count", E.col("w"), "nw"),
                                      E.AggExpr("count", None, "n")]).sort(
        [E.SortOrder(E.col("g"))])


@pytest.mark.parametrize("join_type,how,mode", [("left", "plain", None), ("full", "plain", None),
                                                ("left", "agg", "partial")])
def test_outer_grace_with_null_keys_matches_direct_and_jax(jax_spy, join_type, how, mode):
    """The probe rows with null keys hash to one partition and come out
    once, unmatched (FULL: the build rows with null keys too), so the
    grace run equals the direct run and both packages' runs; K, mode,
    partition sizes and pair retries equal the JAX runner's."""
    ptables, jtables = _nullkey_tables(PT), _nullkey_tables(JT)
    jt = {"left": PP.JoinType.LEFT, "full": PP.JoinType.FULL}[join_type]
    plan = _grace_plan(PT, PP, PE, ptables, jt, how)
    direct = _port_session(ptables)
    want_direct = direct.collect(plan)
    fraction, _ = chip_smoke.grace_fraction(direct, plan, 16)
    grace = _port_session(ptables, fraction)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        got = grace.collect(plan)
    (runner,) = grace.grace_runners
    assert (runner.K, runner.downstream and runner.downstream[0]) == (16, mode)
    js = _jax_session(jtables)
    want = js.collect(_grace_plan(JT, JP, JE, jtables, jt, how))
    with jax_fraction(fraction):
        got_jax = js.collect(_grace_plan(JT, JP, JE, jtables, jt, how))
    assert jax_spy == [(16, mode)]
    for got_sizes, want_sizes in zip(runner.sizes, jax_spy.sizes[0]):
        np.testing.assert_array_equal(got_sizes, want_sizes)
    assert jax_spy.pair_retries() == [runner.retries]
    assert _rows(got) == _rows(want_direct) == _rows(want) == _rows(got_jax)
    if how == "plain":
        rows = _rows(got)
        null_fk = [r for r in rows if r[1] is None and r[0] is not None]
        assert len(null_fk) == int((~ptables["fact"][2]["fk"]).sum())  # each once, unmatched
        assert all(r[2] is None for r in null_fk)
        if join_type == "full":  # every build row with a null key once, unmatched
            assert sum(r[0] is None and r[2] is None for r in rows) == int(
                (~ptables["dim"][2]["pk"]).sum())

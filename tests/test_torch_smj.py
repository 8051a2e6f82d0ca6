"""PyTorch port, the SortMergeJoin, the two sinks and the single-device
exchange (ir/plan.py, ir/pruning.py, exec/engine.py) against the JAX
package:

- every join type as a SortMergeJoin in Spark's shape (each side
  Sort(ShuffleExchange(...)) on its keys) over keys with nulls and
  duplicates: the same rows in the same order as the JAX package's, the same
  ``presorted_build`` flags (JAX ``_apply_orderings``), the same planner
  hints (but a RIGHT join's, below) and the same attempts, and the port's
  HashJoin answer;
- the merge path on a build side sorted with null keys and dead rows (a
  filter under its Sort): the HashJoin answer, with the join logged as
  merged; a Filter between the Sort and the join keeps the sort;
- TPC-H Q12 and Q3 in Spark's SMJ shape (Q3's top 10 a
  TakeOrderedAndProject) at SF 0.01: the JAX package's answers for the same
  plans, and the port's HashJoin plans';
- CollectLimit and TakeOrderedAndProject (the JAX test_operators shape),
  the exchange as the identity and its pruning, and the serde round trip of
  the four nodes.

A RIGHT SortMergeJoin builds its left input in both packages, and the port
takes its hints from that input; the JAX walk reads them off the right one
(its SMJ has no build side attribute): their hints differ there (ROADMAP
C23), and the rows do not."""

import numpy as np
import pytest

from datafusion_comet_tpu import types as JT
from datafusion_comet_tpu.exec.engine import Session as JaxSession
from datafusion_comet_tpu.exec.engine import _smj_build_side
from datafusion_comet_tpu.ir import expr as JE
from datafusion_comet_tpu.ir import plan as JP
from datafusion_comet_tpu.ir import pruning as JPRUNE
from datafusion_comet_tpu.models import tpch as JTPCH
from datafusion_comet_tpu_torch import types as PT
from datafusion_comet_tpu_torch.exec.engine import Session
from datafusion_comet_tpu_torch.ir import expr as PE
from datafusion_comet_tpu_torch.ir import plan as PP
from datafusion_comet_tpu_torch.ir import pruning as PPRUNE
from datafusion_comet_tpu_torch.ir.serde import plan_from_json, plan_to_json
from datafusion_comet_tpu_torch.models import tpch
from test_torch_hints import _nodes, jax_attempts  # noqa: F401 (a fixture)
from _torch_threads import one_torch_thread  # noqa: F401 (a fixture)

pytestmark = pytest.mark.usefixtures("one_torch_thread")

PKG = {"jax": (JT, JE, JP, JaxSession), "port": (PT, PE, PP, lambda: Session(device="cpu"))}
JOIN_TYPES = ("inner", "left", "right", "full", "left_semi", "left_anti",
              "left_anti_null_aware", "existence")


def _schemas(M):
    return (M.Schema([M.Field("fk", M.INT64), M.Field("x", M.INT64, False)]),
            M.Schema([M.Field("pk", M.INT64), M.Field("w", M.INT64, False)]))


def _data(seed: int, null_build: bool):
    rng = np.random.default_rng(seed)
    nf, nd = 400, 90
    fact = {"fk": rng.integers(0, 60, nf).astype(np.int64), "x": np.arange(nf, dtype=np.int64)}
    dim = {"pk": rng.integers(0, 70, nd).astype(np.int64), "w": np.arange(nd, dtype=np.int64)}
    fvalid = {"fk": rng.random(nf) > 0.1}
    dvalid = {"pk": (rng.random(nd) > 0.1) if null_build else np.ones(nd, bool)}
    return fact, dim, fvalid, dvalid


def _sessions(seed: int, null_build: bool = True):
    fact, dim, fvalid, dvalid = _data(seed, null_build)
    out = {}
    for pkg, (M, _, _, mk) in PKG.items():
        s = mk()
        fs, ds = _schemas(M)
        s.register_numpy("fact", fact, fs, validity=fvalid)
        s.register_numpy("dim", dim, ds, validity=dvalid)
        out[pkg] = s
    return out


def spark_smj(pkg, left, right, lkeys, rkeys, join_type, condition=None, nulls_first=None):
    """SortMergeJoin(Sort(ShuffleExchange(left)), Sort(ShuffleExchange(right)))
    on the named keys, in either package; each Sort ascending, its nulls
    first as Spark's default has them unless ``nulls_first`` is False."""
    _, E, P, _ = PKG[pkg]

    def side(p, keys):
        cols = tuple(E.col(k) for k in keys)
        return P.Sort(P.ShuffleExchange(p, "hash", cols),
                      tuple(E.SortOrder(c, True, nulls_first) for c in cols))

    return P.SortMergeJoin(side(left, lkeys), side(right, rkeys),
                           tuple(E.col(k) for k in lkeys), tuple(E.col(k) for k in rkeys),
                           join_type, condition)


def _join_plan(pkg, join_type, sort_merge=True):
    M, E, P, _ = PKG[pkg]
    fs, ds = _schemas(M)
    f, d = P.Scan("fact", fs), P.Scan("dim", ds)
    if sort_merge:  # nulls last: the nullable key's merge path engages
        return spark_smj(pkg, f, d, ("fk",), ("pk",), join_type, nulls_first=False)
    build = "left" if join_type == "right" else "right"
    return P.HashJoin(f, d, (E.col("fk"),), (E.col("pk"),), join_type, build)


def smj_hints(stages, P, port):
    """Each SortMergeJoin's (build side, presorted_build, fan-out, unique
    build, key packing, build-key range, row estimate), stage by stage."""
    return [[(j.build_side if port else _smj_build_side(j),
              bool(getattr(j, "presorted_build", False)),
              getattr(j, "fanout_hint", None), getattr(j, "unique_build_hint", None),
              getattr(j, "key_pack", None), getattr(j, "build_key_range", None),
              getattr(j, "out_rows_hint", None))
             for j in _nodes(sub, P.SortMergeJoin)] for _, sub in stages]


def _values(out):
    """Each column's values, None where null (a null slot's data is
    whatever the path left there)."""
    cols = {}
    for k in out:
        if k.endswith("__valid"):
            continue
        vals = np.asarray(out[k]).tolist()
        ok = out.get(k + "__valid")
        cols[k] = [v if ok is None or ok[i] else None for i, v in enumerate(vals)]
    return cols


def _same(want, got):
    assert list(want) == list(got)
    assert _values(want) == _values(got)


@pytest.mark.parametrize("join_type", JOIN_TYPES)
def test_every_join_type_as_smj_matches_jax(join_type, jax_attempts):  # noqa: F811
    ss = _sessions(3)
    js, ps = ss["jax"], ss["port"]
    got_h = smj_hints(ps._plan_stages(_join_plan("port", join_type)), PP, True)
    want_h = smj_hints(js._plan_stages(_join_plan("jax", join_type)), JP, False)
    # the build side and the merge flag always agree; the hints but for RIGHT (C23)
    assert [[h[:2] for h in st] for st in got_h] == [[h[:2] for h in st] for st in want_h]
    assert [[h[1] for h in st] for st in got_h] == [[True]]
    if join_type != "right":
        assert got_h == want_h
    jax_attempts.clear()
    want = js.collect(_join_plan("jax", join_type))
    got = ps.collect(_join_plan("port", join_type))
    _same(want, got)
    if join_type != "right":
        assert [(r["scale"], r["unique_join_ok"]) for r in ps.runs] == jax_attempts
    _same_rows(ps.collect(_join_plan("port", join_type, sort_merge=False)), got)


def _same_rows(want, got):
    """The same rows, in any order (a HashJoin probes its unsorted input)."""
    assert list(want) == list(got)

    def rows(out):
        return sorted(map(str, zip(*_values(out).values())))

    assert rows(want) == rows(got)


KEEP = tuple(int(w) for w in range(90) if w % 3)  # the dim rows a filter keeps


def _merge_plan(pkg, filtered_before_sort: bool, join_type="inner"):
    """The dim side filtered (dead rows), then sorted on its nullable key:
    its nulls and dead rows come last. ``filtered_before_sort`` False puts
    the Filter above the Sort instead."""
    M, E, P, _ = PKG[pkg]
    fs, ds = _schemas(M)
    keep = E.col("w").isin(*KEEP)
    d = P.Scan("dim", ds)
    order = (E.SortOrder(E.col("pk"), True, False),)
    build = (P.Sort(d.filter(keep), order) if filtered_before_sort
             else P.Sort(d, order).filter(keep))
    return P.SortMergeJoin(P.Scan("fact", fs), build, (E.col("fk"),), (E.col("pk"),), join_type)


@pytest.mark.parametrize("join_type", ["inner", "left", "left_semi", "left_anti_null_aware"])
def test_merge_path_with_null_keys_and_dead_rows(join_type):
    ss = _sessions(5)
    js, ps = ss["jax"], ss["port"]
    del ps.stats["dim"]  # no key range: the sorted paths, where the merge applies
    M, E, P, _ = PKG["port"]
    fs, ds = _schemas(M)
    keep = E.col("w").isin(*KEEP)
    ref = P.HashJoin(P.Scan("fact", fs), P.Scan("dim", ds).filter(keep), (E.col("fk"),),
                     (E.col("pk"),), join_type, "right")
    want = ps.collect(ref)
    got = ps.collect(_merge_plan("port", True, join_type))
    merged = [j["merge"] for r in ps.runs for j in r["joins"]]
    assert merged and all(merged)
    _same_rows(want, got)  # the pairs come in the sorted build's order
    # a Filter between the Sort and the join: the sort runs, the answer holds
    got2 = ps.collect(_merge_plan("port", False, join_type))
    assert not any(j["merge"] for r in ps.runs for j in r["joins"])
    _same_rows(want, got2)
    stages = js._plan_stages(_merge_plan("jax", True, join_type))
    assert [getattr(j, "presorted_build", False) for _, st in stages
            for j in _nodes(st, JP.SortMergeJoin)] == [True]


@pytest.fixture(scope="module")
def tpch_sessions():
    names = ("lineitem", "orders", "customer")
    data = tpch.generate_tables(names, 0.01)
    js, ps = JaxSession(), Session(device="cpu")
    for t in names:
        js.register_numpy(t, data[t], JTPCH.SCHEMAS[t])
        ps.register_numpy(t, data[t], tpch.SCHEMAS[t])
    return js, ps


def _to_spark_shape(plan):
    """A JAX TPC-H plan with every HashJoin in Spark's SMJ shape and a
    Projection over a top-K Sort as a TakeOrderedAndProject."""
    if isinstance(plan, JP.HashJoin):
        return spark_smj("jax", _to_spark_shape(plan.left), _to_spark_shape(plan.right),
                         tuple(k.name for k in plan.left_keys),
                         tuple(k.name for k in plan.right_keys), plan.join_type)
    if isinstance(plan, JP.Projection) and isinstance(plan.child, JP.Sort) and plan.child.fetch:
        s = plan.child
        return JP.TakeOrderedAndProject(_to_spark_shape(s.child), s.orders, s.fetch, plan.exprs)
    if isinstance(plan, JP.Scan):
        return plan
    import dataclasses

    kids = {f.name: _to_spark_shape(getattr(plan, f.name)) for f in dataclasses.fields(plan)
            if isinstance(getattr(plan, f.name, None), JP.PlanNode)}
    return dataclasses.replace(plan, **kids)


@pytest.mark.parametrize("q", ["q12", "q3"])
def test_tpch_in_spark_smj_shape_matches_jax(tpch_sessions, q):
    js, ps = tpch_sessions
    port_plan = getattr(tpch, q)(sort_merge=True)
    jax_plan = _to_spark_shape(getattr(JTPCH, q)())
    want = js.collect(jax_plan)
    got = ps.collect(port_plan)
    _same(want, got)
    assert len(_nodes(ps._plan_stages(getattr(tpch, q)(sort_merge=True))[-1][1],
                      PP.HashJoin)) == 0
    _same(ps.collect(getattr(tpch, q)()), got)
    got_h = smj_hints(ps._plan_stages(port_plan), PP, True)
    want_h = smj_hints(js._plan_stages(_to_spark_shape(getattr(JTPCH, q)())), JP, False)
    assert got_h == want_h
    assert sum(len(st) for st in got_h) == (1 if q == "q12" else 2)


@pytest.mark.parametrize("pkg", ["jax", "port"])
def test_sinks_lower_to_limit_and_sorted_projection(pkg):
    """JAX ``test_operators.py:357``'s shape, in both packages."""
    M, E, P, mk = PKG[pkg]
    sch = M.Schema([M.Field("k", M.INT64, False), M.Field("v", M.INT64, False)])
    s = mk()
    s.register_numpy("t", {"k": np.array([5, 3, 9, 1, 7], np.int64),
                           "v": np.arange(5, dtype=np.int64)}, sch)
    out = s.collect(P.CollectLimit(P.Scan("t", sch), 3, 1))
    assert list(out["k"]) == [3, 9, 1]
    top = P.TakeOrderedAndProject(P.Scan("t", sch), (E.SortOrder(E.col("k")),), 2,
                                  (E.col("k"), (E.col("v") * E.lit(10)).alias("v10")))
    out = s.collect(top)
    assert list(out["k"]) == [1, 3] and list(out["v10"]) == [30, 10]
    out = s.collect(P.TakeOrderedAndProject(P.Scan("t", sch), (E.SortOrder(E.col("k"), False),),
                                            2, (), 1))
    assert list(out["k"]) == [7, 5] and list(out["v"]) == [4, 0]
    bound = P.bind_plan(top)
    assert type(bound).__name__ == "Projection" and bound.child.fetch == 2


@pytest.mark.parametrize("key", ["fk", "x"])
def test_exchange_is_the_identity_and_prunes_like_jax(key):
    """x projected over an exchange on ``key``: the exchange's key stays
    read below it (fk kept), or the scan narrows to x."""
    ss = _sessions(7)
    outs = {}
    for pkg in PKG:
        M, E, P, _ = PKG[pkg]
        fs, _ = _schemas(M)
        plan = P.ShuffleExchange(P.Scan("fact", fs), "hash", (E.col(key),), 8).project(
            [E.col("x")])
        prune = JPRUNE if pkg == "jax" else PPRUNE
        assert prune.prune_columns(plan).child.child.projection == (
            None if key == "fk" else ("x",))
        outs[pkg] = (ss[pkg].collect(plan), ss[pkg].collect(P.Scan("fact", fs)))
    _same(outs["jax"][0], outs["port"][0])
    np.testing.assert_array_equal(outs["port"][0]["x"], outs["port"][1]["x"])


@pytest.mark.parametrize("node", ["smj", "collect_limit", "take_ordered", "exchange"])
def test_serde_round_trips_the_new_nodes(node):
    fs, ds = _schemas(PT)
    f, d = PP.Scan("fact", fs), PP.Scan("dim", ds)
    plan = {"smj": lambda: spark_smj("port", f, d, ("fk",), ("pk",), "left_anti_null_aware",
                                     PE.col("x") > PE.col("w")),
            "collect_limit": lambda: PP.CollectLimit(f, 5, 2),
            "take_ordered": lambda: PP.TakeOrderedAndProject(
                f, (PE.SortOrder(PE.col("x"), False, True),), 3, (PE.col("fk"),), 1),
            "exchange": lambda: PP.ShuffleExchange(f, "range", (), 4,
                                                   (PE.SortOrder(PE.col("fk")),))}[node]()
    js = plan_to_json(plan)
    back = plan_from_json(js)
    assert plan_to_json(back) == js and type(back) is type(plan)
    bound = plan_to_json(PP.bind_plan(plan))
    assert plan_to_json(plan_from_json(bound)) == bound

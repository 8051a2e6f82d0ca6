"""The port's Explode against the JAX package on the CPU: explode,
posexplode and their ``_outer`` forms over LIST and MAP columns, through
both packages' ``Session``; nested columns carried through a join, a sort
and a compaction; and the memory walk's count of an Explode (ROADMAP C32)."""

import numpy as np
import pytest

from datafusion_comet_tpu import types as JT
from datafusion_comet_tpu.exec.engine import Session as JaxSession
from datafusion_comet_tpu.ir import expr as JE
from datafusion_comet_tpu.ir import plan as JP
from datafusion_comet_tpu_torch import types as PT
from datafusion_comet_tpu_torch.exec import kernels as K
from datafusion_comet_tpu_torch.exec.engine import Session
from datafusion_comet_tpu_torch.ir import expr as PE
from datafusion_comet_tpu_torch.ir import plan as PP
from _torch_nested import canon
from _torch_threads import one_torch_thread  # noqa: F401 (a fixture)

pytestmark = pytest.mark.usefixtures("one_torch_thread")

PKGS = {"jax": (JE, JP, JT), "port": (PE, PP, PT)}
N = 300


def _rows():
    rng = np.random.default_rng(7)
    lists, maps, sizes = [], [], rng.integers(0, 5, N)
    for i, n in enumerate(sizes):
        lists.append(None if i % 17 == 3 else
                     [None if rng.random() < 0.1 else int(v) for v in rng.integers(0, 50, n)])
        maps.append(None if i % 13 == 5 else
                    {f"k{int(v)}": int(v) * 10 for v in rng.integers(0, 9, n % 4)})
    return {"id": np.arange(N, dtype=np.int64), "l": lists, "m": maps,
            "g": rng.integers(0, 7, N).astype(np.int64),
            "s": np.array([f"s{i % 11}" for i in range(N)], dtype=object)}


def _schema(T):
    return T.Schema([T.Field("id", T.INT64), T.Field("l", T.list_(T.INT64, 4)),
                     T.Field("m", T.map_(T.string(3), T.INT64, 4)), T.Field("g", T.INT64),
                     T.Field("s", T.string(4))])


@pytest.fixture(scope="module")
def sessions():
    data = _rows()
    js, ps = JaxSession(), Session(device="cpu")
    js.register_numpy("t", data, _schema(JT))
    ps.register_numpy("t", data, _schema(PT))
    return js, ps, data


def _sorted_rows(out, names):
    """The rows as tuples of Python values (None where null), sorted."""
    cols = [[canon(v.item() if isinstance(v, np.generic) else v) if ok else None
             for v, ok in zip(out[n], out[n + "__valid"])] for n in names]
    return sorted(zip(*cols), key=repr)


FORMS = [(col, outer, pos) for col in ("l", "m") for outer in (False, True)
         for pos in (False, True)]


@pytest.mark.parametrize("col,outer,pos", FORMS,
                         ids=[f"{c}-{'outer' if o else 'inner'}-{'pos' if p else 'nopos'}"
                              for c, o, p in FORMS])
def test_explode_forms_equal_jax(sessions, col, outer, pos):
    """Each form's rows equal the JAX package's (as a multiset) and a
    Python oracle's."""
    js, ps, data = sessions
    outs = {}
    for name, sess in (("jax", js), ("port", ps)):
        E, P, T = PKGS[name]
        plan = P.Explode(P.Scan("t", _schema(T)).project([E.col("id"), E.col(col)]),
                         E.col(col), outer, pos)
        outs[name] = sess.collect(plan)
    gen = (["pos"] if pos else []) + (["key", "value"] if col == "m" else ["col"])
    names = ["id"] + gen
    assert _sorted_rows(outs["port"], names) == _sorted_rows(outs["jax"], names)
    want = []
    for i, v in enumerate(data[col]):
        items = (sorted(v.items()) if col == "m" and v else list(v or []))
        if not items and outer:
            want.append((i,) + (None,) * len(gen))
        for p, it in enumerate(items):
            vals = list(it) if col == "m" else [it]
            want.append((i,) + ((p,) if pos else ()) + tuple(vals))
    assert _sorted_rows(outs["port"], names) == sorted(want, key=repr)


def test_nested_columns_through_join_sort_and_compaction(sessions):
    """A list and a map column ride a join (its pair gathers), a sort and a
    filter's compaction in both packages and come out equal, the
    compaction on the partition kernel's nested rows."""
    js, ps, _ = sessions
    outs = {}
    for name, sess in (("jax", js), ("port", ps)):
        E, P, T = PKGS[name]
        left = P.Scan("t", _schema(T)).project([E.col("id"), E.col("l"), E.col("m"), E.col("g")])
        right = P.Scan("t", _schema(T)).project([E.Alias(E.col("id"), "rid"),
                                                 E.Alias(E.col("g"), "rg")])
        plan = P.HashJoin(left, right, (E.col("id"),), (E.col("rid"),), "inner")
        plan = plan.filter(E.col("g") == 3).sort([E.SortOrder(E.col("id"), False)])
        outs[name] = sess.collect(plan)
    for n in ("id", "l", "m"):
        assert [canon(v) for v in outs["port"][n]] == [canon(v) for v in outs["jax"][n]], n
    sch = _schema(PT)
    plan = PP.Scan("t", sch).filter(PE.col("g") == 3)
    b = ps.tables["t"]
    from datafusion_comet_tpu_torch.exec.operators import basic as B

    small, ovf = B.compact_batch(B.filter_op(b, PE.bind(plan.predicate, sch)), 128)
    assert not bool(ovf)
    from datafusion_comet_tpu_torch.exec.batch import to_numpy

    got, ref = to_numpy(small), ps.collect(plan)
    for n in ("l", "m"):
        assert [canon(v) for v in got[n]] == [canon(v) for v in ref[n]]


def test_explode_output_is_compacted_on_the_partition_kernel(sessions):
    """The sparse E-fold output is compacted to its live rows by one call of
    the partition kernel (its log's ``explode`` tag)."""
    _, ps, _ = sessions
    plan = PP.Explode(PP.Scan("t", _schema(PT)).project([PE.col("id"), PE.col("l")]),
                      PE.col("l"), False, True)
    K.partition_columns.log = []
    try:
        ps.collect(plan)
        tags = [c["tag"] for c in K.partition_columns.log]
    finally:
        K.partition_columns.log = None
    assert "explode" in tags


def test_explode_budget_undercounts_like_jax(sessions):
    """ROADMAP C32: the memory walk counts an Explode at its input's rows
    and a LIST at its int32 counts, as the JAX package's does, where the
    operator allocates E times the rows and the element buffers."""
    from datafusion_comet_tpu.exec import memory as JM
    from datafusion_comet_tpu_torch.exec import memory as PM
    from datafusion_comet_tpu_torch.exec.operators import basic as B

    js, ps, _ = sessions
    cap = ps.tables["t"].capacity
    est = {}
    for name, P, E, T, mod in (("jax", JP, JE, JT, JM), ("port", PP, PE, PT, PM)):
        plan = P.bind_plan(P.Explode(P.Scan("t", _schema(T)).project([E.col("id"), E.col("l")]),
                                     E.col("l"), False, True))
        est[name] = mod.plan_peak_bytes(plan, cap)
    assert est["port"] == est["jax"]
    bound = PP.bind_plan(PP.Explode(PP.Scan("t", _schema(PT)).project([PE.col("id"),
                                                                       PE.col("l")]),
                                    PE.col("l"), False, True))
    from datafusion_comet_tpu_torch.observability.metrics import batch_static_bytes

    out = B.explode_op(ps.tables["t"].select([0, 1], bound.child.schema), bound.expr,
                       bound.schema, False, True)
    assert batch_static_bytes(out) > est["port"]


def test_pruned_explode_under_an_aggregate_equals_jax(sessions):
    """Under an aggregate, pruning keeps only the child columns used above
    (``Explode.keep``): the counts per element equal the JAX package's."""
    js, ps, _ = sessions
    outs = {}
    for name, sess in (("jax", js), ("port", ps)):
        E, P, T = PKGS[name]
        plan = P.Explode(P.Scan("t", _schema(T)), E.col("l"), False, True).aggregate(
            [E.col("col")], [E.AggExpr("count", None, "n"), E.AggExpr("sum", E.col("pos"), "sp"),
                             E.AggExpr("sum", E.col("g"), "sg")])
        outs[name] = sess.collect(plan)
    names = ["col", "n", "sp", "sg"]
    assert _sorted_rows(outs["port"], names) == _sorted_rows(outs["jax"], names)
    bound = ps._plan_stages(PP.Explode(PP.Scan("t", _schema(PT)), PE.col("l")).aggregate(
        [PE.col("col")], [PE.AggExpr("sum", PE.col("g"), "sg")]))[-1][1]
    assert bound.child.keep == ("g",) and bound.child.schema.names == ["g", "col"]

"""PyTorch port, Python UDFs (exec/host_udf.py) and MapInBatch: a UDF in a
Projection, in a Filter and under a grouping (its value the group key),
row at a time and through a ``batch_fn``, over padded and
dictionary-coded strings with nulls, and a MapInBatch over pandas with an
aggregate above it, through the port's Session against the JAX
Session's answers (its UDFs through host callbacks); a ``raw`` batch
function reads the JAX package's field names (``data``, ``validity``,
``lengths``, ``is_dict``, ``dictionary.values`` and ``.lengths``); a
PythonUdf does not serialize."""

import numpy as np
import pytest

from _torch_threads import one_torch_thread  # noqa: F401 (a fixture)
from datafusion_comet_tpu import types as JT
from datafusion_comet_tpu.exec.engine import Session as JaxSession
from datafusion_comet_tpu.ir import expr as JE
from datafusion_comet_tpu.ir import functions as JF
from datafusion_comet_tpu.ir import plan as JP
from datafusion_comet_tpu_torch import types as PT
from datafusion_comet_tpu_torch.conf import Config
from datafusion_comet_tpu_torch.exec.engine import Session
from datafusion_comet_tpu_torch.ir import expr as PE
from datafusion_comet_tpu_torch.ir import functions as PF
from datafusion_comet_tpu_torch.ir import plan as PP
from datafusion_comet_tpu_torch.ir import serde
from test_torch_q9 import same

pytestmark = pytest.mark.usefixtures("one_torch_thread")

N = 40


def _data():
    rng = np.random.default_rng(5)
    s = np.array([f"name{i % 7}" if i % 9 else None for i in range(N)], dtype=object)
    doc = np.array(['{"a": %d, "b": "x%d"}' % (i, i % 3) if i % 5 else "bad" for i in range(N)],
                   dtype=object)
    return {"k": rng.integers(0, 5, N).astype(np.int64), "v": rng.integers(-50, 50, N),
            "s": s, "doc": doc}


def _schema(T):
    return T.Schema([T.Field("k", T.INT64), T.Field("v", T.INT64), T.Field("s", T.string(12)),
                     T.Field("doc", T.string(40))])


def _triple(v):
    return None if v is None else v * 3 + 1


def _shout(s):
    return None if s is None else s.upper()[::-1]


def _plan(E, P, T, F):
    sch = _schema(T)
    t = P.Scan("t", sch)
    proj = t.project([E.col("k"), E.PythonUdf(_triple, (E.col("v"),), T.INT64, "triple")
                      .alias("v3"),
                      F.python_udf(_shout, [E.col("s")], T.string(12)).alias("sh"),
                      F.from_json(E.col("doc"), T.struct(("a", T.INT64), ("b", T.string(4))))
                      .alias("j"),
                      F.to_json(F.from_json(E.col("doc"), T.struct(("a", T.INT64))))
                      .alias("tj")])
    flt = proj.filter(E.PythonUdf(lambda v: None if v is None else v % 2 == 0,
                                  (E.col("v3"),), T.BOOL))
    grouped = t.project([E.PythonUdf(lambda k: k * 10, (E.col("k"),), T.INT64).alias("g"),
                         E.col("v")]).aggregate(
        [E.col("g")], [E.AggExpr("sum", E.col("v"), "sv"), E.AggExpr("count", None, "n")])
    return {"proj": proj, "filter": flt, "grouped": grouped.sort([E.SortOrder(E.col("g"))])}


@pytest.mark.parametrize("dmax", [0, 1 << 16])
def test_udfs_equal_jax(dmax):
    data = _data()
    js = JaxSession()
    js.register_numpy("t", data, _schema(JT), dict_max_size=dmax)
    ps = Session(device="cpu", conf=Config(scan_dictionary_max_size=dmax))
    ps.register_numpy("t", data, _schema(PT))
    jplans, pplans = _plan(JE, JP, JT, JF), _plan(PE, PP, PT, PF)
    for name in jplans:
        same(js.collect(jplans[name]), ps.collect(pplans[name]))


def test_raw_batch_function_reads_jax_field_names():
    seen = []

    def batch_fn(mask, cv):
        seen.append(cv.is_dict)
        if cv.is_dict:
            lens = cv.dictionary.lengths[cv.data]
            first = cv.dictionary.values[cv.data][:, 0]
        else:
            lens, first = cv.lengths, cv.data[:, 0]
        return [int(n) * 1000 + int(f) if m and ok else None
                for m, ok, n, f in zip(mask, cv.validity, lens, first)]

    data = _data()
    for dmax in (0, 1 << 16):
        ps = Session(device="cpu", conf=Config(scan_dictionary_max_size=dmax))
        ps.register_numpy("t", data, _schema(PT))
        udf = PE.PythonUdf(None, (PE.col("s"),), PT.INT64, "raw", batch_fn=batch_fn,
                           batch_mode="raw")
        out = ps.collect(PP.Scan("t", _schema(PT)).project([udf.alias("r")]))
        want = [len(x) * 1000 + ord(x[0]) if x is not None else None for x in data["s"]]
        got = [int(x) if ok else None for x, ok in zip(out["r"], out["r__valid"])]
        assert got == want
    assert seen == [False, True]
    with pytest.raises(TypeError, match="does not serialize"):
        serde.plan_to_json(PP.Scan("t", _schema(PT)).project([udf]))


def _double(df):
    out = df.copy()
    out["v2"] = df["v"] * 2
    out["s2"] = [x + "!" if isinstance(x, str) else None for x in df["s"]]
    return out[["k", "v2", "s2"]]


def test_map_in_batch_equals_jax():
    pytest.importorskip("pandas")
    data = _data()
    res = []
    for E, P, T, sess in ((JE, JP, JT, JaxSession()), (PE, PP, PT, Session(device="cpu"))):
        sess.register_numpy("t", data, _schema(T))
        mib = P.MapInBatch(P.Scan("t", _schema(T)).filter(E.col("v") > E.lit(-30)), _double,
                           (T.Field("k", T.INT64), T.Field("v2", T.INT64),
                            T.Field("s2", T.string(16))))
        res.append(sess.collect(mib))
        res.append(sess.collect(mib.aggregate([E.col("k")], [E.AggExpr("sum", E.col("v2"), "t"),
                                                            E.AggExpr("max", E.col("s2"), "m")])
                                .sort([E.SortOrder(E.col("k"))])))
        if isinstance(sess, Session):
            assert not any(n.startswith("__mapinbatch") for n in sess.tables)
    same(res[0], res[2])
    same(res[1], res[3])

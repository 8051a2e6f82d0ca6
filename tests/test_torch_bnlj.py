"""PyTorch port, the broadcast nested-loop join
(exec/operators/join.py::nested_loop_join) against the JAX package's on the
same seeded inputs: every join type it runs (INNER, LEFT, RIGHT, FULL,
LEFT_SEMI, LEFT_ANTI), with no condition and with conditions over floats,
integers, decimals and strings (dictionary-coded and padded); both sides
with dead rows and nulls. Every output column, its validity and the
live-row mask equal the JAX package's, row by row, and the output's
storage too. Then the product limit (``join.BNLJ_MAX_PRODUCT_ROWS``,
JAX ``comet.exec.bnlj.maxProductRows``): over it both packages raise
MemoryError before allocating anything; and a BNLJ through the ``Session``
(its own stage split, statistics and pruning) against the JAX Session."""

import numpy as np
import pytest
import torch

from datafusion_comet_tpu import types as JT
from datafusion_comet_tpu.exec import batch as JB
from datafusion_comet_tpu.exec.engine import Session as JaxSession
from datafusion_comet_tpu.exec.operators import join as JJ
from datafusion_comet_tpu.ir import expr as JE
from datafusion_comet_tpu.ir import plan as JP
from datafusion_comet_tpu_torch import types as PT
from datafusion_comet_tpu_torch.exec import batch as PB
from datafusion_comet_tpu_torch.exec.engine import Session
from datafusion_comet_tpu_torch.exec.operators import join as PJ
from datafusion_comet_tpu_torch.ir import expr as PE
from datafusion_comet_tpu_torch.ir import plan as PP
from _torch_threads import one_torch_thread  # noqa: F401 (a fixture)

pytestmark = pytest.mark.usefixtures("one_torch_thread")

PKG = {"jax": (JT, JB, JE, JP, JJ), "port": (PT, PB, PE, PP, PJ)}
TYPES = ("inner", "left", "right", "full", "left_semi", "left_anti")
WORDS = np.array(["ab", "cd", "ef", "gh", "ij"], object)


def _side(prefix: str, n: int, seed: int):
    rng = np.random.default_rng(seed)
    data = {f"{prefix}x": np.where(rng.random(n) < 0.1, np.nan, rng.standard_normal(n) * 10),
            f"{prefix}i": rng.integers(-20, 20, n).astype(np.int32),
            f"{prefix}d": rng.integers(-10**6, 10**6, n).astype(np.int64),
            f"{prefix}s": WORDS[rng.integers(0, len(WORDS), n)]}
    validity = {c: rng.random(n) > 0.15 for c in data}
    return data, validity, rng.random(n) > 0.2


def _schema(M, prefix):
    return M.Schema([M.Field(f"{prefix}x", M.FLOAT64), M.Field(f"{prefix}i", M.INT32),
                     M.Field(f"{prefix}d", M.decimal(12, 2)), M.Field(f"{prefix}s", M.string(2))])


def _batch(pkg, prefix, n, seed, dict_max):
    M, B = PKG[pkg][:2]
    data, validity, mask = _side(prefix, n, seed)
    if pkg == "jax":
        b = B.from_numpy(data, _schema(M, prefix), validity=validity, dict_max_size=dict_max)
        return b.with_mask(b.row_mask & np.pad(mask, (0, b.capacity - n)))
    b = B.from_numpy(data, _schema(M, prefix), "cpu", validity=validity, dict_max_size=dict_max)
    return b.with_mask(b.row_mask & torch.from_numpy(np.pad(mask, (0, b.capacity - n))))


CONDITIONS = {
    "none": None,
    "float": lambda E, M: E.col("lx") > E.col("rx"),
    "mixed": lambda E, M: (E.col("li") < E.col("ri")) & (E.col("ld") >= E.col("rd")),
    "string": lambda E, M: (E.col("ls") == E.col("rs")) | (E.col("lx").cast(M.INT32)
                                                          == E.col("ri")),
}


def _join(pkg, join_type, cond, dict_max):
    M, B, E, P, J = PKG[pkg]
    left, right = _batch(pkg, "l", 40, 1, dict_max), _batch(pkg, "r", 23, 2, dict_max)
    node = P.bind_plan(P.BroadcastNestedLoopJoin(
        P.Scan("l", left.schema), P.Scan("r", right.schema), join_type,
        CONDITIONS[cond](E, M) if CONDITIONS[cond] else None))
    return J.nested_loop_join(left, right, join_type, node.schema, node.condition)


@pytest.mark.parametrize("dict_max", [1 << 16, 0], ids=["dict", "padded"])
@pytest.mark.parametrize("cond", sorted(CONDITIONS))
@pytest.mark.parametrize("join_type", TYPES)
def test_nested_loop_join_matches_jax(join_type, cond, dict_max):
    jout, pout = _join("jax", join_type, cond, dict_max), _join("port", join_type, cond, dict_max)
    assert jout.capacity == pout.capacity
    np.testing.assert_array_equal(np.asarray(jout.row_mask), pout.row_mask.numpy())
    live = pout.row_mask.numpy()
    # every left row has a pair without a condition: then the anti join is empty
    assert live.any() == ((join_type, cond) != ("left_anti", "none"))
    jn, pn = JB.to_numpy(jout), PB.to_numpy(pout)
    assert list(jn) == list(pn)
    for k in jn:
        assert jn[k].dtype == pn[k].dtype, k
        j, p = jn[k], pn[k]
        if not k.endswith("__valid"):  # values under nulls are not compared
            ok = jn[k + "__valid"]
            j, p = j[ok], p[ok]
        if j.dtype.kind == "f":
            np.testing.assert_array_equal(np.isnan(j), np.isnan(p), err_msg=k)
            j, p = j[~np.isnan(j)], p[~np.isnan(p)]
        np.testing.assert_array_equal(j, p, err_msg=k)
    for jc, pc, f in zip(jout.columns, pout.columns, pout.schema.fields):
        assert np.asarray(jc.data).ndim == pc.data.dim() and jc.is_dict == pc.is_dict, f.name


def test_product_over_the_limit_raises_memory_error():
    """2^14 x 2^13 pair rows = 2^27, over the default 2^26: MemoryError in
    both packages, with the same message; the port's limit is the JAX
    package's configured one."""
    from datafusion_comet_tpu.conf import BNLJ_MAX_PRODUCT, CONF

    assert PJ.BNLJ_MAX_PRODUCT_ROWS == CONF.get(BNLJ_MAX_PRODUCT)
    outs = {}
    for pkg, (M, B, E, P, J) in PKG.items():
        kw = {} if pkg == "jax" else {"device": "cpu"}
        left = B.from_numpy({"a": np.zeros(1 << 14, np.int32)}, M.Schema([M.Field("a", M.INT32)]),
                            **kw)
        right = B.from_numpy({"b": np.zeros(1 << 13, np.int32)},
                             M.Schema([M.Field("b", M.INT32)]), **kw)
        schema = M.Schema([M.Field("a", M.INT32), M.Field("b", M.INT32)])
        with pytest.raises(MemoryError) as err:
            J.nested_loop_join(left, right, "inner", schema)
        outs[pkg] = str(err.value)
    assert outs["jax"] == outs["port"]


def test_bnlj_through_the_session_matches_jax():
    """Each row of a table against the other's one-row ungrouped aggregate
    (Q11's shape: the stage split counts the BNLJ as a join, both sides
    keep every column), LEFT, then LEFT_ANTI against a filtered table."""
    ldata, lval, _ = _side("l", 300, 3)
    rdata, rval, _ = _side("r", 50, 4)
    js, ps = JaxSession(), Session(device="cpu")
    for s, M in ((js, JT), (ps, PT)):
        s.register_numpy("l", ldata, _schema(M, "l"), validity=lval)
        s.register_numpy("r", rdata, _schema(M, "r"), validity=rval)

    def plans(E, P, M):
        total = P.Scan("r", _schema(M, "r")).aggregate(
            [], [E.AggExpr("avg", E.col("rx"), "ax"), E.AggExpr("max", E.col("rd"), "md")])
        one = P.Sort(P.BroadcastNestedLoopJoin(
            P.Scan("l", _schema(M, "l")), total, P.JoinType.LEFT,
            condition=E.col("lx") > E.col("ax")), (E.SortOrder(E.col("lx")),
                                                    E.SortOrder(E.col("li"))))
        anti = P.BroadcastNestedLoopJoin(
            P.Scan("l", _schema(M, "l")),
            P.Scan("r", _schema(M, "r")).filter(E.col("ri") > E.lit(10)), P.JoinType.LEFT_ANTI,
            condition=E.col("ls") == E.col("rs")).aggregate(
                [E.col("ls")], [E.AggExpr("count", None, "n"), E.AggExpr("sum", E.col("lx"), "sx")])
        return one, anti

    for jp, pp in zip(plans(JE, JP, JT), plans(PE, PP, PT)):
        want, got = js.collect(jp), ps.collect(pp)
        assert list(want) == list(got)
        for k in want:
            if want[k].dtype.kind == "f":
                np.testing.assert_allclose(got[k], want[k], rtol=1e-12, equal_nan=True, err_msg=k)
            else:
                np.testing.assert_array_equal(want[k], got[k], err_msg=k)

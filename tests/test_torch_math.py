"""PyTorch port, ``MathFunc`` (``exec/evaluator.py::_math_func``) and the
``negate`` and ``abs`` unary ops against the JAX package's evaluator on the
same seeded columns, branch by branch: ROUND (decimals up and down, integers
and floats), BROUND, FLOOR and CEIL (decimals, integers, floats),
WIDTH_BUCKET, every float function (sqrt through rint) with Spark's null on
a non-positive log, FACTORIAL, BIT_COUNT, GETBIT, SHIFTRIGHTUNSIGNED,
NANVL, the two-argument LOG, POW, ATAN2, HYPOT, SIGN, GREATEST and LEAST
(nulls skipped). The expectations of ``tests/test_math_more.py`` are held
too. Validity equal; values equal on the valid rows (the transcendental
functions within 1e-14: XLA's and PyTorch's CPU implementations round
differently in the last bit); result types and storage equal. ``negate``
and ``abs`` run on narrow and two-limb decimals (exact, with the bound)."""

import math

import numpy as np
import pytest
import torch

from datafusion_comet_tpu import types as JT
from datafusion_comet_tpu.exec import batch as JB
from datafusion_comet_tpu.exec import evaluator as JEV
from datafusion_comet_tpu.ir import expr as JE
from datafusion_comet_tpu_torch import types as PT
from datafusion_comet_tpu_torch.exec import batch as PB
from datafusion_comet_tpu_torch.exec import evaluator as PEV
from datafusion_comet_tpu_torch.ir import expr as PE
from _torch_threads import one_torch_thread  # noqa: F401 (a fixture)

pytestmark = pytest.mark.usefixtures("one_torch_thread")

N = 64
_rng = np.random.default_rng(2024)
COLS = {  # name: (values, type name, validity)
    "f": (np.concatenate([[2.5, 3.5, -2.5, 1.25, -0.5, 0.0, np.nan, np.inf, -1.0, 1.0],
                          np.round(_rng.normal(0, 50, N - 10), 4)]), "FLOAT64"),
    "u": (np.concatenate([[0.5, 0.9, -0.9, 0.0], _rng.uniform(-0.99, 0.99, N - 4)]), "FLOAT64"),
    "p": (np.concatenate([[1.0, 2.0, 10.0, 1e-300], _rng.uniform(1.0, 1e6, N - 4)]), "FLOAT64"),
    "i": (np.concatenate([[0, 1, 255, -1, 5, 20, 21, -7, 10, 63],
                          _rng.integers(-10**6, 10**6, N - 10)]).astype(np.int64), "INT64"),
    "j": (_rng.integers(-70, 70, N).astype(np.int32), "INT32"),
    "d": (np.concatenate([[12345, -12345, 15, -15, 5, -5, 0, 99999],
                          _rng.integers(-10**6, 10**6, N - 8)]).astype(np.int64), "DEC"),
}
VALID = {c: np.where(np.arange(N) < 10, True, _rng.random(N) > 0.15) for c in COLS}


def _schema(T):
    return T.Schema([T.Field(c, T.decimal(9, 2) if t == "DEC" else getattr(T, t))
                     for c, (_, t) in COLS.items()])


def both(build):
    """``build(E, T)``'s expression evaluated by each package over the
    columns: (JAX (data, validity, dtype), port (data, validity, dtype))."""
    data = {c: v for c, (v, _) in COLS.items()}
    out = []
    for E, T, B, EV, to_np in ((JE, JT, JB, JEV, np.asarray),
                               (PE, PT, PB, PEV, lambda t: t.numpy())):
        s = _schema(T)
        b = (B.from_numpy(data, s, validity=VALID) if B is JB else
             B.from_numpy(data, s, "cpu", validity=VALID))
        cv = EV.evaluate(E.bind(build(E, T), s), b)
        out.append((to_np(cv.data)[:N], to_np(cv.validity)[:N], cv.dtype))
    return out


def check(build, rtol=0.0):
    (jd, jv, jt), (pd, pv, pt) = both(build)
    assert repr(jt) == repr(pt)
    np.testing.assert_array_equal(pv, jv)
    assert jd.dtype == pd.dtype and jd.ndim == pd.ndim
    if rtol:
        np.testing.assert_allclose(pd[pv], jd[jv], rtol=rtol, atol=0, equal_nan=True)
    else:
        np.testing.assert_array_equal(pd[pv], jd[jv])
    return pd, pv


def _m(E, f, *args):
    return E.MathFunc(f, tuple(args))


@pytest.mark.parametrize("col,d", [("d", 0), ("d", 1), ("d", 4), ("i", 0), ("i", -2),
                                   ("f", 1), ("f", 0), ("f", -1)])
def test_round_matches_jax(col, d):
    check(lambda E, T: _m(E, "round", E.col(col), E.lit(d, T.INT32)))


@pytest.mark.parametrize("col,d", [("i", 0), ("i", -2), ("f", 0), ("f", 1), ("f", -1)])
def test_bround_matches_jax(col, d):
    pd, _ = check(lambda E, T: _m(E, "bround", E.col(col), E.lit(d, T.INT32)))
    if (col, d) == ("f", 0):  # HALF_EVEN (test_math_more.py)
        np.testing.assert_array_equal(pd[:4], [2.0, 4.0, -2.0, 1.0])


def test_bround_of_a_decimal_raises_in_both():
    for E, T, B, EV, dev in ((JE, JT, JB, JEV, ()), (PE, PT, PB, PEV, ("cpu",))):
        s = T.Schema([T.Field("d", T.decimal(9, 2))])
        b = B.from_numpy({"d": COLS["d"][0]}, s, *dev)
        with pytest.raises(NotImplementedError):
            EV.evaluate(E.bind(_m(E, "bround", E.col("d"), E.lit(0, T.INT32)), s), b)


@pytest.mark.parametrize("f", ["floor", "ceil"])
@pytest.mark.parametrize("col", ["d", "i", "u"])
def test_floor_ceil_match_jax(f, col):
    check(lambda E, T: _m(E, f, E.col(col)))


def test_width_bucket_matches_jax():
    # ascending, descending, an empty range and a bucket count of 0
    for lo, hi, n in ((-50.0, 50.0, 10), (50.0, -50.0, 7), (3.0, 3.0, 5), (0.0, 1.0, 0)):
        check(lambda E, T: _m(E, "width_bucket", E.col("f"), E.lit(lo), E.lit(hi),
                              E.lit(n, T.INT64)))


_FLOAT_FUNCS = {"sqrt": "p", "exp": "u", "ln": "f", "log10": "f", "log2": "f", "sin": "f",
                "cos": "f", "tan": "f", "asin": "u", "acos": "u", "atan": "f", "cbrt": "f",
                "expm1": "u", "log1p": "f", "sinh": "u", "cosh": "u", "tanh": "f",
                "degrees": "f", "radians": "f", "signum": "f", "acosh": "p", "asinh": "f",
                "atanh": "u", "cot": "u", "csc": "u", "sec": "u", "rint": "f"}


@pytest.mark.parametrize("f", sorted(_FLOAT_FUNCS))
def test_float_functions_match_jax(f):
    pd, pv = check(lambda E, T: _m(E, f, E.col(_FLOAT_FUNCS[f])), rtol=1e-14)
    x = COLS[_FLOAT_FUNCS[f]][0]
    if f in ("ln", "log10", "log2"):  # null on a value <= 0, as Spark
        assert not pv[(x <= 0) | np.isnan(x)].any()
    if f == "rint":
        np.testing.assert_array_equal(pd[[0, 1, 4]], [2.0, 4.0, -0.0])


def test_math_functions_of_integers_and_decimals_match_jax():
    check(lambda E, T: _m(E, "sqrt", E.col("d")), rtol=1e-14)
    check(lambda E, T: _m(E, "exp", E.col("j")), rtol=1e-14)
    check(lambda E, T: _m(E, "sign", E.col("d")))


def test_factorial_bit_functions_match_jax():
    pd, pv = check(lambda E, T: _m(E, "factorial", E.col("j")))
    pd, pv = check(lambda E, T: _m(E, "factorial", E.col("i")))
    assert list(pd[[0, 1, 4, 5]]) == [1, 1, 120, 2432902008176640000]
    assert list(pv[[5, 6, 7]]) == [True, False, False]
    pd, _ = check(lambda E, T: _m(E, "bit_count", E.col("i")))
    assert list(pd[:4]) == [0, 1, 8, 64]
    check(lambda E, T: _m(E, "bit_count", E.col("j")))
    for pos in (0, 1, 3, 63, 64, -1):
        check(lambda E, T: _m(E, "getbit", E.col("i"), E.lit(pos, T.INT32)))
    check(lambda E, T: _m(E, "getbit", E.col("i"), E.col("j")))
    for col in ("i", "j"):
        for k in (0, 1, 5, 31, 33):
            check(lambda E, T: _m(E, "shiftrightunsigned", E.col(col), E.lit(k, T.INT32)))
    pd, _ = check(lambda E, T: _m(E, "shiftrightunsigned", E.col("i"), E.lit(1, T.INT32)))
    assert int(pd[3]) == (2**64 - 1) >> 1


def test_two_argument_functions_match_jax():
    check(lambda E, T: _m(E, "nanvl", E.col("f"), E.col("u")))
    check(lambda E, T: _m(E, "log", E.col("u"), E.col("p")), rtol=1e-14)
    check(lambda E, T: _m(E, "log", E.lit(2.0), E.col("f")), rtol=1e-14)
    for f in ("pow", "atan2", "hypot"):
        check(lambda E, T: _m(E, f, E.col("u"), E.col("f")), rtol=1e-14)
    check(lambda E, T: _m(E, "pow", E.col("j"), E.lit(2, T.INT32)))
    check(lambda E, T: _m(E, "sign", E.col("f")))


@pytest.mark.parametrize("f", ["greatest", "least"])
def test_greatest_least_skip_nulls_match_jax(f):
    check(lambda E, T: _m(E, f, E.col("i"), E.col("j")))
    check(lambda E, T: _m(E, f, E.col("f"), E.col("u"), E.col("p")))
    check(lambda E, T: _m(E, f, E.col("d"), E.col("j")))


def test_decimal_round_floor_ceil_values():
    """Spark's HALF_UP and floor/ceil on decimals, against Python."""
    pd, _ = check(lambda E, T: _m(E, "round", E.col("d"), E.lit(1, T.INT32)))
    want = [int(math.copysign(math.floor(abs(v) / 10 + 0.5), v)) for v in COLS["d"][0][:8]]
    assert list(pd[:8]) == want
    pd, _ = check(lambda E, T: _m(E, "floor", E.col("d")))
    assert list(pd[:8]) == [v // 100 for v in COLS["d"][0][:8]]
    pd, _ = check(lambda E, T: _m(E, "ceil", E.col("d")))
    assert list(pd[:8]) == [-(-v // 100) for v in COLS["d"][0][:8]]


# ---- negate and abs ------------------------------------------------------------------


@pytest.mark.parametrize("op", ["negate", "abs"])
@pytest.mark.parametrize("col", ["i", "j", "f", "d"])
def test_negate_abs_match_jax(op, col):
    check(lambda E, T: E.UnaryOp(op, E.col(col)))


@pytest.mark.parametrize("op", ["negate", "abs"])
def test_negate_abs_of_decimals_keep_storage_and_bound(op):
    """A narrow decimal keeps its storage and magnitude bound, a two-limb
    one its two limbs (i128 negate/abs), in both packages; the values are
    Python's."""
    vals = [5, -7, 10**25, -(10**30), 0, 10**37 - 1]
    for prec, data in ((9, np.array([5, -7, 0, 123456789], np.int64)),
                       (38, np.array(vals, object))):
        got = []
        for E, T, B, EV, dev in ((JE, JT, JB, JEV, ()), (PE, PT, PB, PEV, ("cpu",))):
            s = T.Schema([T.Field("d", T.decimal(prec, 0))])
            b = B.from_numpy({"d": data}, s, *dev)
            cv = EV.evaluate(E.bind(E.UnaryOp(op, E.col("d")), s), b)
            assert repr(cv.dtype) == repr(T.decimal(prec, 0))
            out = B.to_numpy(B.Batch((cv,), b.row_mask, T.Schema([T.Field("r", cv.dtype)])))
            got.append((np.asarray(cv.data).ndim if B is JB else cv.data.dim(), cv.mag_bound,
                        [int(v) for v in out["r"]]))
        assert got[0] == got[1]
        assert got[1][0] == (1 if prec == 9 else 2)
        assert got[1][2] == [-int(v) if op == "negate" else abs(int(v)) for v in data]


def test_abs_in_a_tpcds_filter_matches_torch():
    """``abs`` of a DOUBLE difference as q47/q53/q57/q63/q89 filter on it."""
    s = PT.Schema([PT.Field("a", PT.FLOAT64), PT.Field("b", PT.FLOAT64)])
    a, b = _rng.normal(0, 10, N), _rng.normal(0, 10, N)
    batch = PB.from_numpy({"a": a, "b": b}, s, "cpu")
    e = PE.bind((PE.UnaryOp("abs", PE.col("a") - PE.col("b")) / PE.col("b")) > PE.lit(0.1), s)
    got = PEV.evaluate_predicate(e, batch)[:N].numpy()
    np.testing.assert_array_equal(got, (torch.from_numpy(a - b).abs() / torch.from_numpy(b)
                                        > 0.1).numpy())

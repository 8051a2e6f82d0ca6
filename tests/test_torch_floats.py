"""PyTorch port, floating point with Spark's semantics, against the JAX
package on the same seeded inputs: ±0.0, ±Inf, NaN (of several bit
patterns), subnormals, ±max, values of mixed magnitude, and nulls.

- The evaluator (exec/evaluator.py): comparisons (NaN equals NaN and ranks
  above +Inf, -0.0 equals 0.0), arithmetic (x / 0.0 is ±Inf or NaN, never
  null; mod through ``_c_fmod``), the NaN test, every float cast
  in LEGACY, TRY and ANSI (ANSI's error flags too), CASE WHEN with float
  branches, and Spark's murmur3 of FLOAT and DOUBLE (-0.0 hashed as 0.0).
  Each result equals the JAX package's bit for bit, NaN equal to NaN, and
  each comparison and arithmetic result equals numpy's IEEE result.
- Float sort order (ascending, descending, nulls first and last),
  grouping on a float key (-0.0 and 0.0 one group, every NaN one group),
  a join on a float key, and MIN/MAX of floats (NaN the greatest; the
  group's -0.0 or 0.0 as its first row holds it) equal the JAX package's
  exactly, through both ``Session``s.
- SUM and AVG of floats equal the JAX package's within a relative 1e-12
  where its sums are right: on its dense path, and on its sorted path
  over finite values of one magnitude. Its sorted path takes a prefix-sum
  difference (ROADMAP C12): with a NaN or an Inf, or values of mixed
  magnitude, the port's per-group sums equal a numpy oracle that sums
  each group on its own, where the JAX package's are NaN or imprecise.

ROADMAP C13: XLA on the CPU flushes subnormals to zero (in arithmetic,
comparisons and the JAX sort limbs), and the JAX package divides by +0.0
where the divisor is -0.0; the port keeps IEEE (Java) semantics there. On
those rows the port is held to numpy, and a test shows the difference.
"""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from datafusion_comet_tpu import types as JT
from datafusion_comet_tpu.exec import batch as JB
from datafusion_comet_tpu.exec import evaluator as JEV
from datafusion_comet_tpu.exec.engine import Session as JaxSession
from datafusion_comet_tpu.ir import expr as JE
from datafusion_comet_tpu.ir import plan as JP
from datafusion_comet_tpu_torch import types as PT
from datafusion_comet_tpu_torch.exec import batch as PB
from datafusion_comet_tpu_torch.exec import evaluator as PEV
from datafusion_comet_tpu_torch.exec.engine import Session
from datafusion_comet_tpu_torch.ir import expr as PE
from datafusion_comet_tpu_torch.ir import plan as PP
from _torch_threads import one_torch_thread  # noqa: F401 (a fixture)

pytestmark = pytest.mark.usefixtures("one_torch_thread")

PKG = {"jax": (JT, JB, JE, JP, JEV), "port": (PT, PB, PE, PP, PEV)}
N = 1536
F64, F32 = np.finfo(np.float64), np.finfo(np.float32)
NEG_NAN = np.array([0xFFF8000000000001], np.uint64).view(np.float64)[0]  # another NaN's bits
SPECIAL64 = [0.0, -0.0, np.inf, -np.inf, np.nan, NEG_NAN, 1.0, -1.0, 0.5, -0.5, 2.5, -2.5,
             F64.max, -F64.max, F64.tiny, -F64.tiny, 5e-324, -5e-324, 1e-310, 2.0**63,
             -(2.0**63), 2.0**31, -(2.0**31) - 1.0, 127.5, -128.5, 1e300, -1e300, 1e18, 123.455]
SPECIAL32 = [0.0, -0.0, np.inf, -np.inf, np.nan, 1.0, -1.5, F32.max, -F32.max, F32.tiny,
             1e-40, -1e-45, 2.0**31, 3.5]


def _floats(rng, special, dtype):
    x = rng.standard_normal(N) * 10.0 ** rng.integers(-3, 13, N)
    pick = rng.random(N) < 0.35
    x[pick] = np.array(special)[rng.integers(0, len(special), int(pick.sum()))]
    return x.astype(dtype)


def _data(seed: int = 0):
    """Columns a, b (DOUBLE), c (FLOAT), i (INT32, zeros included), d
    (DECIMAL(15,2)), w (DECIMAL(38,2), two-limb) and t (BOOL); about 10%
    of each column null."""
    rng = np.random.default_rng(seed)
    data = {"a": _floats(rng, SPECIAL64, np.float64), "b": _floats(rng, SPECIAL64, np.float64),
            "c": _floats(rng, SPECIAL32, np.float32),
            "i": rng.integers(-3, 4, N).astype(np.int32) * rng.integers(1, 10**6, N).astype(
                np.int32),
            "d": rng.integers(-10**13, 10**13, N).astype(np.int64),
            "w": np.array([int(h) * 2**64 + int(lo) for h, lo in
                           zip(rng.integers(-2**40, 2**40, N), rng.integers(0, 2**63, N))],
                          object),
            "t": rng.random(N) < 0.5}
    validity = {k: rng.random(N) > 0.1 for k in data}
    return data, validity


def _schema(M):
    return M.Schema([M.Field("a", M.FLOAT64), M.Field("b", M.FLOAT64), M.Field("c", M.FLOAT32),
                     M.Field("i", M.INT32), M.Field("d", M.decimal(15, 2)),
                     M.Field("w", M.decimal(38, 2)), M.Field("t", M.BOOL)])


@pytest.fixture(scope="module")
def batches():
    data, validity = _data()
    out = {"jax": JB.from_numpy(data, _schema(JT), validity=validity),
           "port": PB.from_numpy(data, _schema(PT), "cpu", validity=validity)}
    assert out["port"].column("w").data.dim() == 2  # the wide decimal really is two-limb
    return data, validity, out


def _eval(pkg, batch, build):
    """(data, validity, {message: per-row flags}) of ``build(E, T)`` bound
    over the batch."""
    M, _, E, _, EV = PKG[pkg]
    e = E.bind(build(E, M), batch.schema)
    errs = []
    cv = EV.evaluate(e, batch, EV.EvalContext(errors=errs))
    flags = {}
    for f, msg in errs:
        flags[msg] = flags.get(msg, np.zeros(batch.capacity, bool)) | np.asarray(f)
    return np.asarray(cv.data)[:N], np.asarray(cv.validity)[:N], flags, cv


def _subnormal(x):
    x = np.asarray(x)
    if x.dtype.kind != "f":
        return np.zeros(x.shape, bool)
    return (x != 0) & (np.abs(x) < np.finfo(x.dtype).tiny)


def _bits_equal(want, got, rows):
    """Equal bit patterns on ``rows``, any NaN equal to any NaN."""
    want, got = np.asarray(want)[rows], np.asarray(got)[rows]
    assert want.dtype == got.dtype
    if want.dtype.kind != "f":
        np.testing.assert_array_equal(want, got)
        return
    nan_w, nan_g = np.isnan(want), np.isnan(got)
    np.testing.assert_array_equal(nan_w, nan_g)
    iw = want[~nan_w].view(np.int32 if want.dtype == np.float32 else np.int64)
    ig = got[~nan_g].view(np.int32 if got.dtype == np.float32 else np.int64)
    np.testing.assert_array_equal(iw, ig)


def _check(batches, build, cols, oracle=None, c13=None):
    """The port equals the JAX package bit for bit where neither input nor
    numpy's result is subnormal (and ``c13`` does not mark the row), on
    valid rows; validity and ANSI flags equal everywhere but there; and,
    given an ``oracle`` over the inputs, the port equals it on every valid
    row."""
    data, validity, b = batches
    jd, jv, jerr, _ = _eval("jax", b["jax"], build)
    pd, pv, perr, _ = _eval("port", b["port"], build)
    skip = np.zeros(N, bool)
    for c in cols:
        skip |= _subnormal(data[c])
    expect = None
    if oracle is not None:
        with np.errstate(all="ignore"):
            expect = oracle(*(data[c] for c in cols))
        skip |= _subnormal(expect)
    if c13 is not None:
        skip |= c13
    clean = ~skip
    np.testing.assert_array_equal(jv[clean], pv[clean])
    _bits_equal(jd, pd, clean & pv)
    assert sorted(jerr) == sorted(perr)
    for msg in jerr:
        np.testing.assert_array_equal(jerr[msg][:N][clean], perr[msg][:N][clean], err_msg=msg)
    if expect is not None:
        valid = np.ones(N, bool)
        for c in cols:
            valid &= validity[c]
        np.testing.assert_array_equal(pv, valid)
        _bits_equal(np.asarray(expect, pd.dtype), pd, valid)
    return pd, pv


def _np_eq(x, y):
    return (x == y) | (np.isnan(x) & np.isnan(y))


def _np_lt(x, y):
    return np.where(np.isnan(x), False, np.where(np.isnan(y), True, x < y))


NP_CMP = {"eq": _np_eq, "ne": lambda x, y: ~_np_eq(x, y), "lt": _np_lt,
          "le": lambda x, y: _np_lt(x, y) | _np_eq(x, y),
          "gt": lambda x, y: ~(_np_lt(x, y) | _np_eq(x, y)), "ge": lambda x, y: ~_np_lt(x, y)}


@pytest.mark.parametrize("op", ["eq", "ne", "lt", "le", "gt", "ge", "eqns"])
@pytest.mark.parametrize("pair", ["a_b", "a_a", "c_a", "a_i", "a_lit"])
def test_comparisons_match_jax_and_numpy(batches, op, pair):
    """DOUBLE against DOUBLE (and itself: NaN = NaN), FLOAT and an integer
    promoted to DOUBLE, a float literal. (A decimal against a float raises
    in both packages: a plan casts one side.)"""
    data = batches[0]
    x, y = pair.split("_")

    def build(E, M):
        rhs = E.lit(2.5) if y == "lit" else E.col(y)
        return E.BinaryOp(op, E.col(x), rhs)

    cols = [x] if y == "lit" else [x, y]

    def oracle(*vals):
        lhs = vals[0].astype(np.float64)
        rhs = np.float64(2.5) if y == "lit" else vals[1].astype(np.float64)
        return NP_CMP[op](lhs, rhs)

    pd, pv = _check(batches, build, cols, None if op == "eqns" else oracle)
    if op == "eqns":  # never null: both null is true, one null false
        assert pv.all()


@pytest.mark.parametrize("op", ["add", "sub", "mul", "div", "mod", "pmod"])
@pytest.mark.parametrize("pair", ["a_b", "c_c", "a_i", "c_a"])
def test_arithmetic_matches_jax_and_numpy(batches, op, pair):
    """Java float semantics: x / 0.0 is ±Inf or NaN and stays valid; x % 0.0
    is NaN; mod and pmod are a - b x trunc(a / b). Division runs in
    DOUBLE. The JAX package divides by +0.0 where the divisor is -0.0
    (C13): those rows are held to numpy only. FLOAT / FLOAT binds DOUBLE
    in the port, FLOAT (over float64 data) in the JAX package (C14)."""
    data = batches[0]
    x, y = pair.split("_")
    if pair == "c_c":
        y = "c"

    def oracle(u, v=None):
        v = u if v is None else v
        wide = np.float64 if (op == "div" or u.dtype != v.dtype) else u.dtype
        u, v = u.astype(wide), v.astype(wide)
        if op in ("mod", "pmod"):
            safe = np.where(v == 0, 1, v).astype(wide)
            return np.where(v == 0, np.nan, u - safe * np.trunc(u / safe)).astype(wide)
        return {"add": np.add, "sub": np.subtract, "mul": np.multiply, "div": np.divide}[op](u, v)

    cols = [x] if x == y else [x, y]
    neg_zero_div = (np.asarray(data[y]) == 0) & np.signbit(np.asarray(data[y], np.float64))
    pd, pv = _check(batches, lambda E, M: E.BinaryOp(op, E.col(x), E.col(y)), cols, oracle,
                    c13=neg_zero_div if op == "div" else None)
    if op == "div":  # a zero divisor gives ±Inf or NaN, never null
        valid = batches[1][x] & batches[1][y]
        zero = valid & (np.asarray(data[y]) == 0)
        assert zero.any() and pv[zero].all() and not np.isfinite(pd[zero]).any()
    if op == "div" and pair == "c_c":  # C14: FLOAT / FLOAT binds DOUBLE in the port only
        bound = {pkg: PKG[pkg][2].bind(PKG[pkg][2].BinaryOp("div", PKG[pkg][2].col("c"),
                                                             PKG[pkg][2].col("c")),
                                       batches[2][pkg].schema).dtype for pkg in PKG}
        assert bound == {"jax": JT.FLOAT32, "port": PT.FLOAT64}


def test_isnan_matches_jax(batches):
    """isnan of DOUBLE, FLOAT and an integer: false on null rows, never
    null."""
    data, validity, _ = batches
    for col in ("c", "i"):
        _check(batches, lambda E, M: E.UnaryOp("isnan", E.col(col)), [col])
    pd, pv = _check(batches, lambda E, M: E.UnaryOp("isnan", E.col("a")), ["a"])
    np.testing.assert_array_equal(pd, np.isnan(data["a"]) & validity["a"])
    assert pv.all()


CASTS = [("a", "INT8"), ("a", "INT16"), ("a", "INT32"), ("a", "INT64"), ("c", "INT32"),
         ("c", "INT64"), ("a", "FLOAT"), ("c", "DOUBLE"), ("i", "DOUBLE"), ("i", "FLOAT"),
         ("d", "DOUBLE"), ("w", "DOUBLE"), ("t", "DOUBLE"), ("a", "BOOL"), ("a", "dec15_2"),
         ("a", "dec38_4"), ("c", "dec10_3"), ("a", "dec18_0")]


def _to(M, name):
    if name.startswith("dec"):
        p, s = name[3:].split("_")
        return M.decimal(int(p), int(s))
    return {"INT8": M.INT8, "INT16": M.INT16, "INT32": M.INT32, "INT64": M.INT64,
            "FLOAT": M.FLOAT32, "DOUBLE": M.FLOAT64, "BOOL": M.BOOL}[name]


@pytest.mark.parametrize("mode", ["LEGACY", "TRY", "ANSI"])
@pytest.mark.parametrize("col,to", CASTS)
def test_casts_match_jax(batches, col, to, mode):
    """Every float row of the cast matrix: to an integer (LEGACY wraps
    through int64, TRY is null out of range, ANSI flags CAST_OVERFLOW),
    to and from floats, from decimals (a two-limb one through i128 ->
    float64), from a bool, to a bool, and to narrow and two-limb decimals
    (rounded half to even; not finite or over the precision: null, or the
    ANSI flag). Values, validity, storage, bound and flags."""
    _, _, b = batches
    build = lambda E, M: E.Cast(E.col(col), _to(M, to), getattr(E.EvalMode, mode))  # noqa: E731
    _check(batches, build, [col])
    jcv = _eval("jax", b["jax"], build)[3]
    pcv = _eval("port", b["port"], build)[3]
    assert np.asarray(jcv.data).ndim == pcv.data.dim() and jcv.mag_bound == pcv.mag_bound


def test_float_to_int_edges():
    """Truncation toward zero and saturation, by hand: LEGACY casts NaN to
    0 and wraps a value past int64 through it (1e300 -> INT64 max -> -1 as
    INT32); TRY is null outside the target's range."""
    x = np.array([2.9, -2.9, np.nan, 1e300, -1e300, 2147483647.9, 2147483648.0, -0.5])
    b = PB.from_numpy({"x": x}, PT.Schema([PT.Field("x", PT.FLOAT64)]), "cpu")
    out = {}
    for mode in ("LEGACY", "TRY"):
        e = PE.bind(PE.Cast(PE.col("x"), PT.INT32, mode), b.schema)
        cv = PEV.evaluate(e, b)
        out[mode] = [int(v) if ok else None for v, ok in zip(cv.data[:8], cv.validity[:8])]
    assert out["LEGACY"] == [2, -2, 0, -1, 0, 2147483647, -2147483648, 0]
    assert out["TRY"] == [2, -2, None, None, None, 2147483647, None, 0]


def test_case_when_with_float_branches_matches_jax(batches):
    """CASE WHEN with DOUBLE, INT32 and DECIMAL branches (coerced to DOUBLE)
    and a float ELSE, then with no ELSE (null)."""
    def with_else(E, M):
        return E.CaseWhen(((E.col("a") > E.lit(0.0), E.col("a")),
                           (E.col("i") > E.lit(0), E.col("i")),
                           (E.col("t"), E.col("d"))), E.lit(-0.0))

    def no_else(E, M):
        return E.CaseWhen(((E.UnaryOp("isnan", E.col("b")), E.col("c")),
                           (E.col("b") < E.col("a"), E.col("b"))), None)

    for build in (with_else, no_else):
        _check(batches, build, ["a", "b", "c", "i", "d", "t"])


@pytest.mark.parametrize("col", ["a", "c"])
def test_murmur3_of_floats_matches_jax(batches, col):
    """Spark's murmur3 (seed 42) of DOUBLE and FLOAT: -0.0 hashes as 0.0, a
    DOUBLE NaN as the canonical NaN; null rows keep the seed."""
    data, validity, b = batches
    seed = 42
    j = np.asarray(JEV._murmur3_column(b["jax"].column(col),
                                       jnp.full(b["jax"].capacity, seed, jnp.int32)))[:N]
    p = PEV.murmur3_column(b["port"].column(col),
                           torch.full((b["port"].capacity,), seed, dtype=torch.int32)).numpy()[:N]
    clean = ~_subnormal(data[col])
    np.testing.assert_array_equal(j[clean], p[clean])
    x = np.array([0.0, -0.0, np.nan, NEG_NAN], np.float64 if col == "a" else np.float32)
    M = PT.FLOAT64 if col == "a" else PT.FLOAT32
    h = PEV.murmur3_column(PB.from_numpy({"x": x}, PT.Schema([PT.Field("x", M)]), "cpu").columns[0],
                           torch.full((8,), seed, dtype=torch.int32))
    assert h[0] == h[1] and (col == "c" or h[2] == h[3])


def test_c13_subnormals_and_negative_zero_divisor():
    """The port keeps IEEE semantics where XLA on the CPU flushes
    subnormals and the JAX package divides by +0.0 for a -0.0 divisor:
    5e-324 x 1.0, 1e-310 > 5e-324 and 1.0 / -0.0."""
    cases = {"mul": ([5e-324, 1e-310], [1.0, 1.0]), "gt": ([1e-310, 1.0], [5e-324, 0.5]),
             "div": ([1.0, -2.0], [-0.0, -0.0])}
    for op, (x, y) in cases.items():
        x, y = np.array(x), np.array(y)
        out = {}
        for pkg, (M, B, E, _, EV) in PKG.items():
            schema = M.Schema([M.Field("x", M.FLOAT64), M.Field("y", M.FLOAT64)])
            b = B.from_numpy({"x": x, "y": y}, schema, **({} if pkg == "jax" else
                                                          {"device": "cpu"}))
            e = E.bind(E.BinaryOp(op, E.col("x"), E.col("y")), schema)
            out[pkg] = np.asarray(EV.evaluate(e, b).data)[:2]
        with np.errstate(all="ignore"):
            want = {"mul": x * y, "div": x / y, "gt": x > y}[op]
        _bits_equal(want, out["port"], np.ones(2, bool))
        assert not np.array_equal(out["jax"][:1], want[:1])  # the JAX package's first row differs


# ---- sorts, groups, joins, MIN/MAX, SUM and AVG through both Sessions -------------------

KEYS = [0.0, -0.0, np.nan, NEG_NAN, np.inf, -np.inf, 1.5, -1.5, 2.0, -7.25, 1e300, F64.tiny]


def _agg_table(n: int, seed: int):
    """k: a float key from a small pool (no subnormals: C13), x: a float
    value from the same pool, y: finite values in [1, 2) (one magnitude),
    f: FLOAT values, g: an int64 key of 300 groups, s: a dictionary-coded
    key of 5 values, z: positive values of mixed magnitude (1 to 1e12) with
    a NaN and +-Inf in a few groups, v: an INT32; 10% of each null."""
    rng = np.random.default_rng(seed)
    pool = np.array(KEYS)
    data = {"k": pool[rng.integers(0, len(pool), n)], "x": pool[rng.integers(0, len(pool), n)],
            "y": 1.0 + rng.random(n), "f": rng.standard_normal(n).astype(np.float32),
            "g": rng.integers(0, 300, n).astype(np.int64),
            "s": np.array(["aa", "bb", "cc", "dd", "ee"], object)[rng.integers(0, 5, n)],
            "z": 10.0 ** rng.integers(0, 13, n) * (1.0 + rng.random(n)),
            "v": rng.integers(-1000, 1000, n).astype(np.int32)}
    data["z"][rng.choice(n, 3, replace=False)] = [np.nan, np.inf, -np.inf]
    validity = {c: rng.random(n) > 0.1 for c in data}
    return data, validity


def _agg_schema(M):
    return M.Schema([M.Field("k", M.FLOAT64), M.Field("x", M.FLOAT64), M.Field("y", M.FLOAT64),
                     M.Field("f", M.FLOAT32), M.Field("g", M.INT64), M.Field("s", M.string(2)),
                     M.Field("z", M.FLOAT64), M.Field("v", M.INT32)])


@pytest.fixture(scope="module")
def agg_sessions():
    data, validity = _agg_table(6000, 0)
    js, ps = JaxSession(), Session(device="cpu")
    js.register_numpy("t", data, _agg_schema(JT), validity=validity)
    ps.register_numpy("t", data, _agg_schema(PT), validity=validity)
    js.register_numpy("u", {c: v[:700] for c, v in data.items()}, _agg_schema(JT),
                      validity={c: v[:700] for c, v in validity.items()})
    ps.register_numpy("u", {c: v[:700] for c, v in data.items()}, _agg_schema(PT),
                      validity={c: v[:700] for c, v in validity.items()})
    return data, validity, js, ps


def _both(agg_sessions, build):
    """Each package's collect of ``build(E, P)``."""
    _, _, js, ps = agg_sessions
    return (js.collect(build(JE, JP, JT)), ps.collect(build(PE, PP, PT)))


def _same(want, got, float_rtol=None, cols=None):
    """Equal columns: bit-equal (NaN any NaN), or within ``float_rtol`` for
    the FLOAT64 columns named in ``cols``."""
    assert list(want) == list(got)
    for c in want:
        w, g = want[c], got[c]
        assert w.dtype == g.dtype, c
        if float_rtol is not None and c in (cols or ()):
            np.testing.assert_allclose(g, w, rtol=float_rtol, atol=0, equal_nan=True, err_msg=c)
        else:
            _bits_equal(w, g, np.ones(len(w), bool))


@pytest.mark.parametrize("asc,nulls_first", [(True, None), (False, None), (True, False),
                                             (False, True)])
def test_float_sort_order_matches_jax(agg_sessions, asc, nulls_first):
    """ORDER BY a float key, then an int key: NaN last ascending (first
    descending), -0.0 and 0.0 tied (their input order kept), nulls per the
    SortOrder; every column bit-equal."""
    def build(E, P, T):
        return P.Scan("t", _agg_schema(T)).sort(
            [E.SortOrder(E.col("k"), asc, nulls_first), E.SortOrder(E.col("g"))])

    want, got = _both(agg_sessions, build)
    _same(want, got)
    k, ok = got["k"], got["k__valid"]
    live = k[ok]
    nan_at = np.flatnonzero(np.isnan(live))
    assert (nan_at == (np.arange(len(nan_at)) + (len(live) - len(nan_at) if asc else 0))).all()


def _group_plan(key: str, aggs):
    def build(E, P, T):
        return P.Scan("t", _agg_schema(T)).aggregate(
            [E.col(key)], [E.AggExpr(f, E.col(c) if c else None, f"{f}_{c}") for f, c in aggs]
        ).sort([E.SortOrder(E.col(key))])
    return build


def test_group_by_float_key_min_max_match_jax(agg_sessions):
    """GROUP BY a float key (sorted path): one group for -0.0 and 0.0 and
    one for every NaN, its key the first row's (bit-equal, as the JAX
    package gives it); COUNT, MIN and MAX of floats bit-equal (NaN the
    greatest, the first row's zero); SUM and AVG of one-magnitude values
    within 1e-12."""
    aggs = [("count", None), ("min", "x"), ("max", "x"), ("min", "f"), ("max", "f"),
            ("sum", "y"), ("avg", "y"), ("sum", "f"), ("avg", "v")]
    want, got = _both(agg_sessions, _group_plan("k", aggs))
    _same(want, got, 1e-12, ["sum_y", "avg_y", "sum_f", "avg_v"])
    keys = got["k"][got["k__valid"]]
    assert len(keys) == len(KEYS) - 2  # -0.0 with 0.0, the two NaNs together
    assert np.isnan(got["max_x"][got["max_x__valid"]]).all()  # every group saw a NaN


def test_dense_path_float_aggregates_match_jax(agg_sessions):
    """GROUP BY a dictionary-coded string (the dense path, where the JAX
    package sums each group on its own): SUM and AVG of values of mixed
    magnitude with NaN and Inf within 1e-12, MIN/MAX bit-equal."""
    aggs = [("sum", "z"), ("avg", "z"), ("min", "z"), ("max", "z"), ("sum", "f"),
            ("max", "x"), ("min", "x")]
    want, got = _both(agg_sessions, _group_plan("s", aggs))
    _same(want, got, 1e-12, ["sum_z", "avg_z", "sum_f"])


def test_ungrouped_float_aggregates_match_jax(agg_sessions):
    def build(E, P, T):
        return P.Scan("t", _agg_schema(T)).filter(E.col("k") > E.lit(0.0)).aggregate(
            [], [E.AggExpr("sum", E.col("y"), "sy"), E.AggExpr("avg", E.col("f"), "af"),
                 E.AggExpr("min", E.col("x"), "mn"), E.AggExpr("max", E.col("x"), "mx")])

    want, got = _both(agg_sessions, build)
    _same(want, got, 1e-12, ["sy", "af"])


def test_join_on_float_keys_matches_jax(agg_sessions):
    """An INNER join on a float key: -0.0 meets 0.0 and NaN meets every
    NaN, nulls meet nothing."""
    def build(E, P, T):
        u = P.Scan("u", _agg_schema(T)).project([E.col("k").alias("uk"), E.col("v").alias("uv")])
        return P.HashJoin(P.Scan("t", _agg_schema(T)), u, (E.col("k"),), (E.col("uk"),),
                          P.JoinType.INNER, "right").aggregate(
            [E.col("uk")], [E.AggExpr("count", None, "n"), E.AggExpr("sum", E.col("uv"), "suv")]
        ).sort([E.SortOrder(E.col("uk"))])

    want, got = _both(agg_sessions, build)
    _same(want, got)
    assert len(got["uk"]) == len(KEYS) - 2


def _per_group_oracle(g, z, valid, groups):
    """Each group's exact float sum (math.fsum: NaN or Inf where one is in
    the group) and count."""
    sums = np.zeros(groups)
    cnt = np.zeros(groups, np.int64)
    for k in range(groups):
        sel = (g == k) & valid
        sums[k] = math.fsum(z[sel]) if sel.any() else np.nan
        cnt[k] = sel.sum()
    return sums, cnt


def test_c12_sorted_path_sums_are_per_group(agg_sessions):
    """GROUP BY an int64 key (the sorted path) over values of mixed
    magnitude with one NaN, +Inf and -Inf: the port's SUM and AVG equal
    the per-group oracle within 1e-12 (NaN exactly where a group holds one,
    or both infinities); the JAX package's prefix-sum difference turns the
    groups after the first non-finite value NaN and loses precision in the
    rest (C12)."""
    data, validity, _, _ = agg_sessions
    want, got = _both(agg_sessions, _group_plan("g", [("sum", "z"), ("avg", "z")]))
    ok = validity["g"]
    sums, cnt = _per_group_oracle(data["g"][ok], data["z"][ok], validity["z"][ok], 300)
    assert got["g"][got["g__valid"]].tolist() == list(range(300))
    live = got["g__valid"]
    ps, pa = got["sum_z"][live], got["avg_z"][live]
    np.testing.assert_allclose(ps, sums, rtol=1e-12, atol=0, equal_nan=True)
    np.testing.assert_allclose(pa, sums / np.maximum(cnt, 1), rtol=1e-12, atol=0, equal_nan=True)
    bad = np.isnan(sums)
    assert 1 <= bad.sum() <= 3 and np.isnan(ps).sum() == bad.sum()
    js = want["sum_z"][want["g__valid"]]
    assert np.isnan(js).sum() > 10 * bad.sum()  # JAX: the NaN spreads to later groups
    fine = ~np.isnan(js)
    rel = np.abs(js[fine] - sums[fine]) / np.abs(sums[fine])
    assert rel.max() > 1e-9  # and the finite ones before it lose precision


def test_collect_stats_accepts_float_columns(agg_sessions):
    """Statistics of float columns: rows and distinct estimates as the JAX
    package's, no range (ranges are for integers and dates)."""
    from datafusion_comet_tpu.exec.stats import collect_stats as jstats
    from datafusion_comet_tpu_torch.exec.stats import collect_stats as pstats

    data, _, _, _ = agg_sessions
    j, p = jstats(data, _agg_schema(JT)), pstats(data, _agg_schema(PT))
    assert (j.rows, j.ndv) == (p.rows, p.ndv) and "k" not in p.ranges
    assert p.ndv["k"] == len(KEYS) - 2  # -0.0 == 0.0 in np.unique, the NaNs one value

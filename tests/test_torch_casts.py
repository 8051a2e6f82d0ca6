"""PyTorch port, the cast matrix (exec/casts.py, exec/ryu.py,
exec/cast_matrix.py and the evaluator's ``_cast``) against the JAX package
on seeded columns, padded and dictionary-coded, in the three eval modes:
every pair of ``MATRIX_TYPES`` supported alike, numbers, decimals (narrow
and two-limb), dates and booleans to strings and back, exactly.

Where the JAX package is wrong the port is held to a Python oracle:
doubles print as Java's ``Double.toString`` (the shortest round-trip
digits of ``repr`` laid out as Java does) on subnormals, where XLA on the
CPU flushes them (ROADMAP C13), and a string parses to the correctly
rounded double where the JAX package's float64 digit accumulation misses
it by an ulp (ROADMAP C27)."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from chip_smoke import java_double
from _torch_expr import assert_same, assert_same_errors, run_both, stage, values
from _torch_threads import one_torch_thread  # noqa: F401 (a fixture)
from datafusion_comet_tpu.exec import cast_matrix as JCM
from datafusion_comet_tpu.exec import ryu as JRYU
from datafusion_comet_tpu_torch import types as PT
from datafusion_comet_tpu_torch.exec import cast_matrix as PCM
from datafusion_comet_tpu_torch.exec import ryu as PRYU
from datafusion_comet_tpu_torch.exec.batch import ColumnVector
from datafusion_comet_tpu_torch.exec.casts import cast_string_to

pytestmark = pytest.mark.usefixtures("one_torch_thread")

MODES = ("LEGACY", "ANSI", "TRY")


def test_cast_support_equals_jax_on_every_pair():
    names = [n for n, _ in JCM.MATRIX_TYPES]
    assert names == [n for n, _ in PCM.MATRIX_TYPES]
    for a in names:
        for b in names:
            assert PCM.cast_support(a, b)[0] == JCM.cast_support(a, b)[0], (a, b)


def _doubles():
    rng = np.random.default_rng(5)
    x = rng.standard_normal(300) * 10.0 ** rng.integers(-12, 14, 300)
    edges = [0.1, 0.2, 0.3, 1e7, 9999999.0, 1e-3, 9.99e-4, 100.0, 1.0, 123456.789, -0.0, 0.0,
             float("nan"), float("inf"), -float("inf"), 1.7976931348623157e308,
             2.2250738585072014e-308, 4.35, 2.0 / 3.0, 1e21, 1e22, 1e23, 5e-324,
             1e-320, -2.5e-310]
    return np.concatenate([x, edges])


def test_double_to_string_equals_jax_and_java():
    """Normal doubles: the port's bytes equal the JAX package's and
    Java's; subnormals (JAX: "0.0", XLA flushes them) equal Java's."""
    x = _doubles()
    pc, pl = PRYU.double_to_string(torch.from_numpy(x), 32)
    jc, jl = jax.jit(JRYU.double_to_string, static_argnums=1)(jnp.asarray(x), 32)
    jc, jl = np.asarray(jc), np.asarray(jl)
    for i, v in enumerate(x):
        got = bytes(pc[i, : pl[i]].numpy()).decode()
        assert got == java_double(float(v)), (v, got)
        if not (v != 0 and abs(v) < 2.2250738585072014e-308):
            assert got == bytes(jc[i, : jl[i]]).decode(), (v, got)


def test_float_to_string_equals_shortest_digits():
    """A FLOAT's shortest round-trip digits (numpy's for float32, which the
    JAX package's Ryu gives too), laid out as Java's toString."""
    rng = np.random.default_rng(6)
    x = (rng.standard_normal(200) * 10.0 ** rng.integers(-8, 9, 200)).astype(np.float32)
    x = np.concatenate([x, np.array([0.1, 1e7, 3.4028235e38, 1.17549435e-38, -0.0, np.nan,
                                     np.inf, 16777216.0, 0.001, 1e-45], np.float32)])
    pc, pl = PRYU.float_to_string(torch.from_numpy(x), 24)
    for i, v in enumerate(x):
        want = java_double(float(np.format_float_scientific(v, unique=True)))
        assert bytes(pc[i, : pl[i]].numpy()).decode() == want, v


def test_string_to_double_rounds_correctly():
    """Java's Double.toString output parses back to the same double (the
    JAX package's accumulation misses some of these, ROADMAP C27), and
    other digit strings to Python's ``float``."""
    x = _doubles()
    x = x[np.isfinite(x) & ((np.abs(x) >= 1e-3) & (np.abs(x) < 1e7) | (x == 0))]
    strs = [java_double(float(v)).encode() for v in x]
    strs += [b"9007199254740993", b"0.30000000000000004", b"12345678901234567890123",
             b"  -42.5 ", b"0.000000000000000000000000000001", b"1.2.3", b"", b"1a"]
    w = 40
    mat = np.zeros((len(strs), w), np.uint8)
    for i, s in enumerate(strs):
        mat[i, : len(s)] = np.frombuffer(s, np.uint8)
    cv = ColumnVector(torch.from_numpy(mat), torch.ones(len(strs), dtype=torch.bool),
                      torch.tensor([len(s) for s in strs], dtype=torch.int32), PT.string(w))
    out = cast_string_to(cv, PT.FLOAT64, "LEGACY", None)
    for i, s in enumerate(strs):
        if s in (b"", b"1a"):
            assert not out.validity[i]
        elif s == b"1.2.3":  # digits and dots, as the JAX package reads them: 123e-3
            assert out.data[i].item() == 0.123
        else:
            assert out.validity[i] and out.data[i].item() == float(s), s
    for i, v in enumerate(x):
        assert out.data[i].item() == v


def _mixed_batches(dict_strings):
    """Integers, narrow and two-limb decimals, dates, booleans, doubles and
    strings (numbers, dates, junk, spaces, signs), nulls and a dead row."""
    ints = np.array([0, 1, -1, 127, -128, 40000, -2**31, 2**31 - 1, 12345678901, -9, 7, 0],
                    np.int64)
    n = len(ints)
    strs = np.array(["12", " -7 ", "+3", "1.5", "abc", "", None, "99999999999", "2024-02-29",
                     "t", "0", "-0.125"], dtype=object)
    wide = np.array([0, 10**30, -(10**25) - 3, 5, None, 1, -1, 2**64, 10**37, 3, 4, 6],
                    dtype=object)
    data = {"i": ints, "i32": ints.astype(np.int32), "b": ints % 2 == 1,
            "dec": ints * 7, "w": wide, "d": (ints % 40000).astype(np.int32),
            "f": ints.astype(np.float64) / 7.0, "s": strs}
    fields = [("i", lambda T: T.INT64), ("i32", lambda T: T.INT32), ("b", lambda T: T.BOOL),
              ("dec", lambda T: T.decimal(12, 3)), ("w", lambda T: T.decimal(38, 4)),
              ("d", lambda T: T.DATE), ("f", lambda T: T.FLOAT64),
              ("s", lambda T: T.string(16))]
    valid = {"i": np.arange(n) != 3, "s": np.array([x is not None for x in strs])}
    return stage(fields, data, validity=valid, dict_strings=dict_strings,
                 mask=np.arange(n) != 9), n


_TO_STRING = ("i", "i32", "b", "dec", "w", "d")  # doubles: test_double_to_string_*
_FROM_STRING = ("INT8", "INT32", "INT64", "DEC", "DEC38", "DATE", "BOOL", "FLOAT64", "FLOAT32")


def _to(T, name):
    return {"DEC": T.decimal(10, 2), "DEC38": T.decimal(38, 10), "FLOAT64": T.FLOAT64,
            "FLOAT32": T.FLOAT32}.get(name) or getattr(T, name)


@pytest.mark.parametrize("dict_strings", [False, True])
def test_string_casts_equal_jax(dict_strings):
    """To string from every type the JAX package prints (the dictionary
    column's entries cast once and gathered back), and back from a string
    to every scalar type in each mode, errors on live rows only."""
    (jb, pb), n = _mixed_batches(dict_strings)
    for c in () if dict_strings else _TO_STRING:  # a string column only is coded
        j, p = run_both(lambda E, T: E.Cast(E.col(c), T.string(48)), jb, pb)
        assert_same(j, p, n)
    for to in _FROM_STRING:
        # the modes differ where a parse fails: integers, decimals and dates
        for mode in MODES if to in ("INT32", "DEC", "DATE") else ("LEGACY",):
            if to.startswith("FLOAT"):
                continue
            j, p, je, pe = run_both(lambda E, T: E.Cast(E.col("s"), _to(T, to), mode), jb, pb,
                                    mode_ctx=True)
            assert_same(j, p, n)
            assert_same_errors(je, pe)
    # the strings here have at most 15 significant digits, where both parse alike
    for to in ("FLOAT64", "FLOAT32"):
        j, p = run_both(lambda E, T: E.Cast(E.col("s"), _to(T, to)), jb, pb)
        assert_same(j, p, n)


@pytest.mark.parametrize("mode", MODES)
def test_numeric_and_date_casts_equal_jax(mode):
    """The non-string rows the port adds: integer narrowing (Java's wrap,
    TRY's null, ANSI's error), integer and date to boolean, dates to
    numbers."""
    (jb, pb), n = _mixed_batches(False)
    for c, to in (("i", "INT8"), ("i", "INT16"), ("i", "INT32"), ("b", "INT32"), ("i", "BOOL"),
                  ("d", "INT64"), ("d", "FLOAT64"), ("d", "BOOL"), ("i32", "INT8")):
        j, p, je, pe = run_both(lambda E, T: E.Cast(E.col(c), getattr(T, to), mode), jb, pb,
                                mode_ctx=True)
        assert_same(j, p, n)
        assert_same_errors(je, pe)


def test_to_string_values():
    """Spark's texts, independent of the JAX package."""
    (jb, pb), n = _mixed_batches(False)
    from datafusion_comet_tpu_torch.exec import evaluator as PEV
    from datafusion_comet_tpu_torch.ir import expr as PE

    def text(c):
        e = PE.bind(PE.Cast(PE.col(c), PT.string(48)), pb.schema)
        return values(PEV.evaluate(e, pb), n)[0]

    assert text("dec")[:4] == [b"0.000", b"0.007", b"-0.007", b"0.889"]
    assert text("i")[3] is None
    assert text("w")[1] == b"1" + b"0" * 26 + b".0000"
    assert text("b")[:2] == [b"false", b"true"]
    assert text("d")[0] == b"1970-01-01"

"""PyTorch port, the string functions (exec/string_funcs.py): every
StringFunc but the bytes and JSON family, SplitPart, SubstringIndex,
Soundex and FormatNumber, against the JAX package on the same seeded
strings, exactly: padded and dictionary-coded (each function of one
dictionary column with literal arguments runs over its entries), nulls
and a dead row; the static output widths equal the JAX package's; the
error flags (split_part's part 0, format_number's overflow) too. Spark's
own answers on the JAX package's edge values are checked apart."""

import numpy as np
import pytest

from _torch_expr import assert_same, assert_same_errors, run_all, run_both, stage, values
from _torch_threads import one_torch_thread  # noqa: F401 (a fixture)
from datafusion_comet_tpu_torch.ir import expr as _PE

_LIT = _PE.Literal

pytestmark = pytest.mark.usefixtures("one_torch_thread")

STRS = np.array(["Hello World", "  pad me  ", "", None, "a.b.c.d", "x", "UPPER lower",
                 "ab,cd,,ef", "Robert", "Tymczak", "aaaa", "Pfister", "Ashcraft", "123abc",
                 "a..b...c", " Tab\tx "], dtype=object)
N = len(STRS)
MASK = np.arange(N) != 5


def _batches(dict_strings):
    rng = np.random.default_rng(11)
    data = {"s": STRS, "t": STRS[::-1].copy(), "i": rng.integers(-4, 9, N).astype(np.int32)}
    return stage([("s", lambda T: T.string(12)), ("t", lambda T: T.string(12)),
                  ("i", lambda T: T.INT32)], data, dict_strings=dict_strings, mask=MASK)


def _c(E, n):
    return E.col(n)


FUNCS = [
    ("upper", lambda E: (_c(E, "s"),)), ("lower", lambda E: (_c(E, "s"),)),
    ("length", lambda E: (_c(E, "s"),)), ("char_length", lambda E: (_c(E, "s"),)),
    ("bit_length", lambda E: (_c(E, "s"),)), ("octet_length", lambda E: (_c(E, "s"),)),
    ("reverse", lambda E: (_c(E, "s"),)), ("ascii", lambda E: (_c(E, "s"),)),
    ("trim", lambda E: (_c(E, "s"),)), ("ltrim", lambda E: (_c(E, "s"),)),
    ("rtrim", lambda E: (_c(E, "s"),)), ("initcap", lambda E: (_c(E, "s"),)),
    ("btrim", lambda E: (_c(E, "s"),)), ("btrim", lambda E: (_c(E, "s"), E.lit(" pa"))),
    ("lpad", lambda E: (_c(E, "s"), E.lit(14), E.lit("0"))),
    ("rpad", lambda E: (_c(E, "s"), E.lit(20), E.lit("xy"))),
    ("rpad", lambda E: (_c(E, "s"), E.lit(3))),
    ("repeat", lambda E: (_c(E, "s"), _c(E, "i"))),
    ("concat", lambda E: (_c(E, "s"), E.lit("-"), _c(E, "t"))),
    ("concat_ws", lambda E: (E.lit(", "), _c(E, "s"), _c(E, "t"))),
    ("instr", lambda E: (_c(E, "s"), E.lit("o"))), ("instr", lambda E: (_c(E, "s"), _c(E, "t"))),
    ("locate", lambda E: (E.lit("a"), _c(E, "s"))),
    ("replace", lambda E: (_c(E, "s"), E.lit("a"), E.lit("X"))),
    ("replace", lambda E: (_c(E, "s"), E.lit("aa"), E.lit("bc"))),
    ("translate", lambda E: (_c(E, "s"), E.lit("lo"), E.lit("L"))),
    ("contains", lambda E: (_c(E, "s"), E.lit("er"))),
    ("contains", lambda E: (_c(E, "s"), _c(E, "t"))),
    ("startswith", lambda E: (_c(E, "s"), E.lit("Ro"))),
    ("endswith", lambda E: (_c(E, "s"), _c(E, "t"))),
    ("left", lambda E: (_c(E, "s"), E.lit(3))), ("right", lambda E: (_c(E, "s"), _c(E, "i"))),
    ("substring", lambda E: (_c(E, "s"), _c(E, "i"), E.lit(3))),
    ("levenshtein", lambda E: (_c(E, "s"), _c(E, "t"))),
    ("chr", lambda E: (_c(E, "i"),)), ("space", lambda E: (E.lit(3),)),
]

# bytes of the input's width, of a wider one, a number, a bool (a dictionary's entries)
_DICT_CASES = ("upper", "lpad", "replace", "length", "contains")

NODES = [
    lambda E: E.Soundex(_c(E, "s")),
    lambda E: E.SubstringIndex(_c(E, "s"), ".", 2),
    lambda E: E.SubstringIndex(_c(E, "s"), ".", -2),
    lambda E: E.SubstringIndex(_c(E, "s"), "..", 1),
    lambda E: E.SubstringIndex(_c(E, "s"), ".", 0),
    lambda E: E.SplitPart(_c(E, "s"), ",", -1),
    lambda E: E.SplitPart(_c(E, "s"), ",", 3),
    lambda E: E.SplitPart(_c(E, "s"), ".", 9),
    lambda E: E.SplitPart(_c(E, "s"), ",", 0),
]


@pytest.mark.parametrize("dict_strings", [False, True])
def test_string_funcs_equal_jax(dict_strings):
    """Padded: every case. Dictionary-coded: one case of each shape of
    result whose other arguments are literals, which runs over the
    entries (the rest decode and take the padded path)."""
    jb, pb = _batches(dict_strings)
    builds = [lambda E, T, f=f, args=args: E.StringFunc(f, args(E)) for f, args in FUNCS
              if not dict_strings or (f in _DICT_CASES and all(
                  isinstance(a, _LIT) for a in args(_PE)[1:]))]
    builds += [lambda E, T, b=b: b(E) for b in (NODES[:3] + NODES[5:6] if dict_strings
                                                else NODES)]
    for j, p, je, pe in run_all(builds, jb, pb, mode_ctx=True):
        assert_same(j, p, N)
        assert_same_errors(je, pe)


def test_format_number_equals_jax():
    """Integers, doubles (NaN and infinities), narrow decimals half to even,
    and a value too wide for its bytes (the error flag)."""
    ints = np.array([0, 1, -1, 999, 1000, -1234567, 2**62, 10**15, 5, -5], np.int64)
    n = len(ints)
    dbl = np.array([0.0, 1.005, -2.5, 3.5, float("nan"), float("inf"), -float("inf"),
                    1234567.891, -0.004, 1e18], np.float64)
    jb, pb = stage([("i", lambda T: T.INT64), ("f", lambda T: T.FLOAT64),
                    ("d", lambda T: T.decimal(12, 3))],
                   {"i": ints, "f": dbl, "d": ints % 10**11}, mask=np.arange(n) != 2)
    for c in ("i", "f", "d"):
        for d, w in ((0, 32), (2, 32), (4, 12)):
            j, p, je, pe = run_both(lambda E, T: E.FormatNumber(E.col(c), d, w), jb, pb,
                                    mode_ctx=True)
            assert_same(j, p, n)
            assert_same_errors(je, pe)


def test_spark_answers():
    """The JAX package's edge values (test_split_device.py,
    test_format_number_device.py), as Spark has them."""
    _, pb = _batches(False)
    from datafusion_comet_tpu_torch.exec import evaluator as PEV
    from datafusion_comet_tpu_torch.ir import expr as PE

    def run(e):
        return values(PEV.evaluate(PE.bind(e, pb.schema), pb), N)[0]

    sx = run(PE.Soundex(PE.col("s")))
    assert [sx[i] for i in (8, 9, 11, 12, 13)] == [b"R163", b"T522", b"P236", b"A261",
                                                   b"123abc"]
    assert run(PE.SubstringIndex(PE.col("s"), ".", 2))[4] == b"a.b"
    assert run(PE.SubstringIndex(PE.col("s"), ".", -2))[4] == b"c.d"
    assert run(PE.SplitPart(PE.col("s"), ",", 3))[7] == b""
    assert run(PE.SplitPart(PE.col("s"), ",", -1))[7] == b"ef"
    assert run(PE.StringFunc("initcap", (PE.col("s"),)))[6] == b"Upper Lower"
    assert run(PE.StringFunc("lpad", (PE.col("s"), PE.lit(3), PE.lit("0"))))[0] == b"Hel"

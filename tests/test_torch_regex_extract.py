"""PyTorch port, the device regexp forms (exec/regex_extract.py):
regexp_extract (groups 0, 1 and 2), regexp_extract_all and
regexp_replace equal the JAX package over padded strings with nulls and a
dead row, every expression in one JAX computation, the overflow errors of
extract_all (more than max_parts matches) and replace (the output past its
width) with the same messages and rows; a dictionary column's results
equal the padded column's; the rows run in tiles (a tile of one row
equals the whole); ``linearize`` refuses what needs the host bridge
(alternation, nested and repeated groups, a class that could backtrack,
a group past the pattern's) as the JAX module does, and ``min_match_len``
is 0 where a match can be empty."""

import numpy as np
import pytest

from _torch_expr import assert_same, assert_same_errors, run_all, stage
from _torch_threads import one_torch_thread  # noqa: F401 (a fixture)
from datafusion_comet_tpu.exec import regex_extract as JX
from datafusion_comet_tpu_torch import types as PT
from datafusion_comet_tpu_torch.exec import batch as PB
from datafusion_comet_tpu_torch.exec import evaluator as PEV
from datafusion_comet_tpu_torch.exec import regex_extract as PX
from datafusion_comet_tpu_torch.ir import expr as PE

pytestmark = pytest.mark.usefixtures("one_torch_thread")

STRINGS = ["john@example.com", "a1b2c3d4e5", "no digits here", "x12-345-6789y", "",
           None, "zzz@q", "aaaaaaaaaaaaaaaaaaaaaaaaaaaa", "42", "abab ab", "xyz xyyyz xz",
           "2024-01-31 / 1999-12-01", "t9t9t9t9t9t9t9", "@@@", "ab"]
N = len(STRINGS)
W = 32

EXTRACT = [(r"([a-z]+)@(\w+)", 1), (r"([a-z]+)@(\w+)", 2), (r"([a-z]+)@(\w+)", 0),
           (r"^(\d+)", 1), (r"(\d{2,4})$", 1), ("x(y*)z", 1), (r"(\d{4})-(\d\d)", 2),
           ("q", 0)]
EXTRACT_ALL = [(r"\d+", 0, 8), (r"([a-z])(\d)", 2, 4), (r"(\d{4})-\d\d", 1, 4),
               ("ab", 0, 2)]
REPLACE = [(r"\d+", "#", 0), ("[aeiou]", "", 0), ("ab", "XYZW", 0), ("a", "bbbb", 40),
           (r"t\d", "T", 0), ("@", "[at]", 0)]


def _builds():
    out = [lambda E, T, p=p, i=i: E.RegexpExtract(E.col("s"), p, i) for p, i in EXTRACT]
    out += [lambda E, T, p=p, i=i, k=k: E.RegexpExtractAll(E.col("s"), p, i, k)
            for p, i, k in EXTRACT_ALL]
    out += [lambda E, T, p=p, r=r, w=w: E.RegexpReplace(E.col("s"), p, r, w)
            for p, r, w in REPLACE]
    return out


def test_regexp_forms_equal_jax():
    jb, pb = stage([("s", lambda T: T.string(W))], {"s": np.array(STRINGS, dtype=object)},
                   mask=np.arange(N) != 1)
    fired = []
    for j, p, jerrs, perrs in run_all(_builds(), jb, pb, mode_ctx=True):
        if p.dtype.is_list:
            jv = np.asarray(j.validity)[:N]
            assert (p.validity.numpy()[:N] == jv).all()
            np.testing.assert_array_equal(p.data.numpy()[:N][jv], np.asarray(j.data)[:N][jv])
        else:
            assert_same(j, p, N)
        assert_same_errors(jerrs, perrs)
        fired += [m for f, m in perrs if bool(f.any())]
    assert fired == ["regexp_extract_all produced more than max_parts=4 matches",
                     "regexp_extract_all produced more than max_parts=2 matches",
                     "regexp_replace output exceeded the declared string width 40 "
                     "(pass out_len)"]


def _values(cv, n):
    cv = cv.decode() if cv.is_dict else cv
    if cv.dtype.is_list:
        return PB.nested_to_py(cv)[:n]
    lens = cv.lengths.numpy()
    return [bytes(cv.data[i, :lens[i]].numpy()) if cv.validity[i] else None for i in range(n)]


def test_lists_and_dictionary_and_tiles():
    """extract_all's lists element by element against the JAX package's;
    a dictionary column's results and one-row tiles equal the padded
    column's."""
    from datafusion_comet_tpu import types as JT
    from datafusion_comet_tpu.exec import batch as JB

    schema = PT.Schema([PT.Field("s", PT.string(W))])
    data = {"s": np.array(STRINGS, dtype=object)}
    for p, i, k in EXTRACT_ALL:
        lp = PX.linearize(p, i)
        pb = PB.from_numpy(data, schema, "cpu", dict_max_size=0)
        cv = pb.columns[0]
        got = PX.extract_all_device(cv.data, cv.lengths, cv.validity, lp, i, k, W)
        jb = JB.from_numpy(data, JT.Schema([JT.Field("s", JT.string(W))]), dictionary=False)
        jc = jb.columns[0]
        want = JX.extract_all_device(jc.data, jc.lengths, jc.validity, JX.linearize(p, i),
                                     i, k, W)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    builds = ([PE.RegexpExtract(PE.col("s"), p, i) for p, i in EXTRACT]
              + [PE.RegexpExtractAll(PE.col("s"), p, i, 16) for p, i, _ in EXTRACT_ALL]
              + [PE.RegexpReplace(PE.col("s"), p, r, 64) for p, r, _ in REPLACE])
    padded = PB.from_numpy(data, schema, "cpu", dict_max_size=0)
    coded = PB.from_numpy(data, schema, "cpu")
    assert coded.columns[0].is_dict
    for e in builds:
        be = PE.bind(e, schema)
        assert _values(PEV.evaluate(be, padded), N) == _values(PEV.evaluate(be, coded), N)
    cv = padded.columns[0]
    lp = PX.linearize(r"(\d+)", 1)
    whole = PX.extract_device(cv.data, cv.lengths, cv.validity, lp, 1, W)
    old = PX._tiles
    PX._tiles = lambda n, w, budget: [slice(i, i + 1) for i in range(n)]
    try:
        tiled = PX.extract_device(cv.data, cv.lengths, cv.validity, lp, 1, W)
    finally:
        PX._tiles = old
    for a, b in zip(whole, tiled):
        assert torch_equal(a, b)


def torch_equal(a, b):
    return bool((a == b).all())


@pytest.mark.parametrize("pat,idx", [("a|b", 0), ("(a(b))", 1), ("(ab)+", 1), ("a*ab", 0),
                                     (r"(\w+)(\d)", 1), ("(a)", 2), ("x+", 0), ("a*", 0),
                                     (r"^\d+$", 0), ("(?:ab)", 0), ("[a-c]{2,}d", 0)])
def test_linearize_and_min_match_len_as_jax(pat, idx):
    jl, pl = JX.linearize(pat, idx), PX.linearize(pat, idx)
    assert (jl is None) == (pl is None)
    if jl is not None:
        assert repr(jl) == repr(pl)
        assert JX.min_match_len(jl) == PX.min_match_len(pl)

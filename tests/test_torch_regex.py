"""PyTorch port, RLIKE (exec/regex_dfa.py): the compiled DFA run by one
table gather per byte column equals the JAX package's matcher on patterns
on both sides of its select-tree thresholds (at most 64 states and 24 byte
classes: the select tree; above: its gather), negated on either side, over padded
strings with nulls and a dead row, every pattern in one JAX computation;
a dictionary column's matches equal the padded column's and Python's
``re.search``; the host compiler is the JAX module's, table for table."""

import re

import numpy as np
import pytest

from _torch_expr import assert_same, run_all, stage
from _torch_threads import one_torch_thread  # noqa: F401 (a fixture)
from datafusion_comet_tpu.exec import regex_dfa as JR
from datafusion_comet_tpu_torch import types as PT
from datafusion_comet_tpu_torch.exec import batch as PB
from datafusion_comet_tpu_torch.exec import evaluator as PEV
from datafusion_comet_tpu_torch.exec import regex_dfa as PR
from datafusion_comet_tpu_torch.ir import expr as PE

pytestmark = pytest.mark.usefixtures("one_torch_thread")

# (pattern, JAX's select tree?)
PATTERNS = [("abc", True), ("^a.*z$", True), ("[0-9]+", True), ("a|b", True),
            ("(foo|bar)baz", True), (r"\d{3}-\d{4}", True), ("^$", True), ("x?y+$", True),
            (r"\s\w+\.", True), ("[^a-m]{2}", True),
            ("abcdefghijklmnopqrstuvwxyz", False), ("q.{2}x{60}y{10}", False),
            ("(ab|cd|ef|gh|ij|kl|mn|op|qr|st|uv|wx|yz)+[0-9]", False)]
STRINGS = ["abc", "xxabcxx", "a-to-z", "az", "", "123-4567", "foobaz", "barbaz", "fobaz",
           "y", "xyyy", "yyx", " word.", "nope", "abcdefghijklmnopqrstuvwxyz!",
           "q12" + "x" * 60 + "y" * 10, "q12" + "x" * 59 + "y" * 10, "abcdqr7", "NOPQ", "héllo", None, "ba"]
N = len(STRINGS)
W = 80


def test_patterns_on_both_sides_of_the_thresholds():
    for pat, select in PATTERNS:
        trans, _ = JR.compile_dfa(pat)
        _, _, c = JR._byte_classes(trans)
        assert (trans.shape[0] <= JR._SELECT_MAX_STATES and c <= JR._SELECT_MAX_CLASSES) \
            == select, pat
        pt, pa = PR.compile_dfa(pat)
        np.testing.assert_array_equal(pt, trans)
        np.testing.assert_array_equal(pa, JR.compile_dfa(pat)[1])


def test_rlike_equals_jax():
    jb, pb = stage([("s", lambda T: T.string(W))], {"s": np.array(STRINGS, dtype=object)},
                   mask=np.arange(N) != 3)
    # every pattern, and negated the first on each side of the thresholds
    negated = [p for k, (p, sel) in enumerate(PATTERNS) if sel != PATTERNS[k - 1][1] or k == 0]
    builds = [lambda E, T, p=p, neg=neg: E.RLike(E.col("s"), p, neg)
              for p, _ in PATTERNS for neg in ((False, True) if p in negated else (False,))]
    for j, p in run_all(builds, jb, pb):
        assert_same(j, p, N)


@pytest.mark.parametrize("pat", [p for p, _ in PATTERNS])
def test_rlike_dictionary_equals_padded_and_python(pat):
    schema = PT.Schema([PT.Field("s", PT.string(W))])
    e = PE.bind(PE.RLike(PE.col("s"), pat), schema)
    got = []
    for dmax in (0, 1 << 16):
        b = PB.from_numpy({"s": np.array(STRINGS, dtype=object)}, schema, "cpu",
                          dict_max_size=dmax)
        cv = PEV.evaluate(e, b)
        got.append([bool(v) if ok else None
                    for v, ok in zip(cv.data[:N].tolist(), cv.validity[:N].tolist())])
    assert got[0] == got[1]
    for s, m in zip(STRINGS, got[0]):
        if s is None:
            assert m is None
        elif s.isascii():
            assert m == (re.search(pat, s) is not None), (pat, s)

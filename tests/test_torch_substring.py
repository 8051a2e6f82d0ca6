"""PyTorch port, ``substring(str, pos[, len])`` exactly against the JAX
package's evaluator on the same seeded strings (lengths 0-12 in a 12-byte
column, 10% null rows), over every position in -20..20 and every length in
-1..20, and without a length: over a dictionary column's entries
(``_eval_on_dict``) and over padded bytes. Both give the bytes, the
lengths and the validity of Spark's semantics: 1-based, position 0 as 1, a
negative position from the end, a negative length as 0, a slice past the
end cut, the bytes past the new length zero. The binding's errors and
result type are checked too."""

import numpy as np
import pytest

from datafusion_comet_tpu import types as JT
from datafusion_comet_tpu.exec import batch as JB
from datafusion_comet_tpu.exec import evaluator as JV
from datafusion_comet_tpu.ir import expr as JE
from datafusion_comet_tpu_torch import types as PT
from datafusion_comet_tpu_torch.exec import batch as PB
from datafusion_comet_tpu_torch.exec import evaluator as PV
from datafusion_comet_tpu_torch.ir import expr as PE
from test_torch_q9 import one_torch_thread  # noqa: F401 (a fixture)

pytestmark = pytest.mark.usefixtures("one_torch_thread")

POSITIONS = list(range(-20, 21))
LENGTHS = list(range(-1, 21))
PKG = {"jax": (JT, JB, JV, JE), "port": (PT, PB, PV, PE)}


def _strings(seed=3, n=300):
    rng = np.random.default_rng(seed)
    alphabet = np.frombuffer(b"abcdefghij-0123", np.uint8)
    vals = np.array([bytes(rng.choice(alphabet, rng.integers(0, 13))).decode()
                     for _ in range(n)], object)
    return vals, rng.random(n) > 0.1


def _batch(pkg, encoding):
    M, B, _, _ = PKG[pkg]
    vals, valid = _strings()
    schema = M.Schema([M.Field("s", M.string(12))])
    dm = {"dict": 1 << 16, "padded": 0}[encoding]
    if pkg == "jax":
        return B.from_numpy({"s": vals}, schema, validity={"s": valid}, dict_max_size=dm)
    return B.from_numpy({"s": vals}, schema, "cpu", validity={"s": valid}, dict_max_size=dm)


def _substrings(pkg, encoding, pos, lengths):
    """to_numpy of substring(s, pos, n) for each n (None: no length)."""
    M, B, V, E = PKG[pkg]
    b = _batch(pkg, encoding)
    assert b.columns[0].is_dict == (encoding == "dict")
    out = []
    for n in lengths:
        args = (E.col("s"), E.lit(pos)) + (() if n is None else (E.lit(n),))
        e = E.bind(E.StringFunc("substring", args).alias("r"), b.schema)
        cv = V.evaluate(e, b)
        assert cv.dtype == M.string(12) and not cv.is_dict
        res = B.Batch((cv,), b.row_mask, M.Schema([M.Field("r", M.string(12))]))
        out.append(B.to_numpy(res))
        out.append({"data": np.asarray(cv.data), "lengths": np.asarray(cv.lengths)})
    return out


@pytest.mark.parametrize("encoding", ["dict", "padded"])
@pytest.mark.parametrize("pos", POSITIONS)
def test_substring_matches_jax(encoding, pos):
    lengths = LENGTHS + [None]
    want = _substrings("jax", encoding, pos, lengths)
    got = _substrings("port", encoding, pos, lengths)
    for w, g in zip(want, got):
        assert list(w) == list(g)
        for k in w:
            np.testing.assert_array_equal(w[k], g[k], err_msg=f"pos {pos} {k}")
    # against Python's slicing, Spark's rules spelled out
    vals, valid = _strings()
    for n, res in zip(lengths, got[::2]):
        start = pos - 1 if pos > 0 else (0 if pos == 0 else None)
        for v, ok, r, rv in zip(vals, valid, res["r"], res["r__valid"]):
            s0 = start if start is not None else max(len(v) + pos, 0)
            stop = len(v) if n is None else s0 + max(n, 0)
            assert rv == ok and (not ok or r == v[s0:stop]), (v, pos, n, r)


def test_only_substring_binds():
    """Every string function binds, the bytes and JSON family too: upper
    keeps its input's type, and md5 binds to the JAX package's STRING(32)
    and gives its digests (the lengths 0-12 of this file's strings)."""
    schema = PT.Schema([PT.Field("s", PT.string(12))])
    assert PE.bind(PE.StringFunc("upper", (PE.col("s"),)), schema).dtype == PT.string(12)
    from _torch_expr import assert_same, run_both, stage

    vals = np.array(["x" * n for n in range(13)] + [None], dtype=object)
    jb, pb = stage([("s", lambda T: T.string(12))], {"s": vals})
    j, p = run_both(lambda E, T: E.StringFunc("md5", (E.col("s"),)), jb, pb)
    assert p.dtype == PT.string(32)
    assert_same(j, p, len(vals))

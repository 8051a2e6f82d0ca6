"""PyTorch port, the bytes functions (exec/bytes_funcs.py): hex of strings
and of integers, unhex, base64 (chunked and not), unbase64, bin, conv
(signed and unsigned targets, bad bases), encode, decode, crc32, md5, sha1
and sha2 at every bit length (and an invalid one): equal to the JAX
package on one batch of padded strings with nulls and a dead row, every
function in one JAX computation; the digests and crc32 equal to
``hashlib`` and ``zlib`` over the lengths around each block boundary
(0, 55, 56, 63, 64, 111, 112, 119, 120, 128 and the column's width); and a
dictionary column's results equal to the padded column's; and a string
function over more rows than one block of ``STRING_BLOCK_BYTES`` (concat,
lpad, the digests) equal to its run in one piece."""

import base64
import hashlib
import zlib

import numpy as np
import pytest

from _torch_expr import assert_same, run_all, stage
from _torch_threads import one_torch_thread  # noqa: F401 (a fixture)
from datafusion_comet_tpu_torch import types as PT
from datafusion_comet_tpu_torch.exec import batch as PB
from datafusion_comet_tpu_torch.exec import evaluator as PEV
from datafusion_comet_tpu_torch.ir import expr as PE

pytestmark = pytest.mark.usefixtures("one_torch_thread")

W = 130  # the string column's width
LENGTHS = [0, 1, 3, 55, 56, 63, 64, 111, 112, 119, 120, 128, W]
N = len(LENGTHS) + 3


def _strings():
    rng = np.random.default_rng(19)
    out = ["".join(chr(c) for c in rng.integers(32, 127, n)) for n in LENGTHS]
    return out + [None, "héllo wörld", "x"]


def _data():
    rng = np.random.default_rng(7)
    s = np.array(_strings(), dtype=object)
    i = rng.integers(-2**62, 2**62, N)
    i[:4] = [0, -1, 255, -(2**63)]
    nums = np.array(["12345", "-77", "ff", "0", "zz9", "", None, "18446744073709551615",
                     "99999999999999999999", "7fffffffffffffff", "-1", "101", "Z", "42x", "+5",
                     "1e3"], dtype=object)
    hexes = np.array(["4142", "abc", "zz", "", None, "0", "fF", "123456789", "Ff00", "1",
                      "00", "abcdef0123", "a", "g1", "41", "7e"], dtype=object)
    b64 = np.array(["QUJD", "QUI=", "QQ==", "", None, "SGVs\r\nbG8=", "!!QUJD", "YWJjZA",
                    "YQ", "Y", "////", "++++", "AAAA", "QUJDRA==", "SGk", "=="], dtype=object)
    fields = [("s", lambda T: T.string(W)), ("i", lambda T: T.INT64),
              ("n", lambda T: T.string(24)), ("h", lambda T: T.string(12)),
              ("b", lambda T: T.string(12))]
    data = {"s": s, "i": i, "n": nums, "h": hexes, "b": b64}
    valid = {"i": np.arange(N) % 5 != 3}
    return fields, data, valid


def _builds():
    out = [lambda E, T: E.StringFunc("hex", (E.col("s"),)),
           lambda E, T: E.StringFunc("hex", (E.col("i"),)),
           lambda E, T: E.StringFunc("unhex", (E.col("h"),)),
           lambda E, T: E.StringFunc("base64", (E.col("s"),)),
           lambda E, T: E.StringFunc("base64", (E.col("s"), E.lit(False))),
           lambda E, T: E.StringFunc("unbase64", (E.col("b"),)),
           lambda E, T: E.StringFunc("bin", (E.col("i"),)),
           lambda E, T: E.StringFunc("encode", (E.col("s"), E.lit("utf-8"))),
           lambda E, T: E.StringFunc("decode", (E.col("s"), E.lit("UTF-8"))),
           lambda E, T: E.StringFunc("crc32", (E.col("s"),)),
           lambda E, T: E.StringFunc("md5", (E.col("s"),)),
           lambda E, T: E.StringFunc("sha1", (E.col("s"),))]
    for bits in (0, 224, 256, 384, 512, 100):
        out.append(lambda E, T, bits=bits: E.StringFunc("sha2", (E.col("s"), E.lit(bits))))
    for fb, tb in ((10, 16), (16, -10), (36, 2), (10, -36), (1, 10)):
        out.append(lambda E, T, fb=fb, tb=tb: E.StringFunc(
            "conv", (E.col("n"), E.lit(fb), E.lit(tb))))
    return out


def test_bytes_funcs_equal_jax():
    fields, data, valid = _data()
    jb, pb = stage(fields, data, validity=valid, mask=np.arange(N) != 2)
    for j, p in run_all(_builds(), jb, pb):
        assert_same(j, p, N)


def _port_values(cv, n):
    cv = cv.decode() if cv.is_dict else cv
    valid = cv.validity.numpy()[:n]
    if cv.lengths is None:
        return [cv.data[i].item() if valid[i] else None for i in range(n)]
    lens = cv.lengths.numpy()
    return [bytes(cv.data[i, :lens[i]].numpy()) if valid[i] else None for i in range(n)]


@pytest.mark.parametrize("func,ref", [
    ("md5", hashlib.md5), ("sha1", hashlib.sha1), ("sha2:224", hashlib.sha224),
    ("sha2:256", hashlib.sha256), ("sha2:384", hashlib.sha384), ("sha2:512", hashlib.sha512),
    ("crc32", None), ("base64", None)])
def test_digests_equal_hashlib_and_dictionary(func, ref):
    """The port alone over every length around a block boundary, padded and
    dictionary-coded."""
    strs = _strings()
    schema = PT.Schema([PT.Field("s", PT.string(W))])
    name, _, bits = func.partition(":")
    args = (PE.col("s"),) + ((PE.lit(int(bits)),) if bits else ())
    if name == "base64":
        args += (PE.lit(False),)
    e = PE.bind(PE.StringFunc(name, args), schema)
    results = []
    for dmax in (0, 1 << 16):
        b = PB.from_numpy({"s": np.array(strs, dtype=object)}, schema, "cpu",
                          dict_max_size=dmax)
        assert b.columns[0].is_dict == bool(dmax)
        results.append(_port_values(PEV.evaluate(e, b), len(strs)))
    assert results[0] == results[1]
    for s, got in zip(strs, results[0]):
        if s is None:
            assert got is None
            continue
        raw = s.encode()
        if name == "crc32":
            assert got == zlib.crc32(raw)
        elif name == "base64":
            assert got == base64.b64encode(raw)
        else:
            assert got == ref(raw).hexdigest().encode(), (len(raw), func)


def test_row_blocks_equal_one_piece(monkeypatch):
    strs = _strings()
    schema = PT.Schema([PT.Field("s", PT.string(W)), PT.Field("i", PT.INT64)])
    b = PB.from_numpy({"s": np.array(strs, dtype=object), "i": np.arange(len(strs))}, schema,
                      "cpu", dict_max_size=0)
    c = PE.col
    exprs = [PE.StringFunc("concat", (PE.lit("<"), c("s"), PE.Cast(c("i"), PT.string(20)))),
             PE.StringFunc("lpad", (c("s"), PE.lit(140), PE.lit("-"))),
             PE.StringFunc("md5", (c("s"),)), PE.StringFunc("crc32", (c("s"),))]
    bound = [PE.bind(e, schema) for e in exprs]
    whole = [_port_values(PEV.evaluate(e, b), len(strs)) for e in bound]
    monkeypatch.setattr(PEV, "STRING_BLOCK_BYTES", 8 * 600 * 3)  # about three rows a block
    assert whole == [_port_values(PEV.evaluate(e, b), len(strs)) for e in bound]

"""PyTorch port, Spark's runtime bloom filter (``exec/operators/
agg_special.py``): the BLOOM_FILTER aggregate's serialized bytes equal the
JAX package's byte for byte, over INT64 keys with nulls, over strings
dictionary-coded and padded, ungrouped and grouped (the sorted path in
both packages); its layout (Spark's ``BloomFilterImpl.writeTo``) and bit
indices equal chip_smoke.py's numpy oracle and the JAX tests' scalar
Murmur3 oracle; ``BloomMightContain`` has no false negative, its false
positives are the oracle's, and it probes through a scalar subquery (a
filter null where the subquery's input has no row). A BLOOM_FILTER in a
partial or merging mode raises in both packages."""

import numpy as np
import pytest

import chip_smoke
from datafusion_comet_tpu.exec.engine import Session as JaxSession
from datafusion_comet_tpu_torch.exec.engine import Session
from datafusion_comet_tpu_torch.exec.operators.agg_special import parse_bloom_bytes
from test_agg_special import _bloom_indices_oracle
from test_torch_minmax import PKG
from _torch_threads import one_torch_thread  # noqa: F401 (a fixture)

pytestmark = pytest.mark.usefixtures("one_torch_thread")

NUM_BITS = 4096


def _sessions(data, schema, validity=None, dict_max_size=1 << 16):
    out = {}
    for pkg in PKG:
        M = PKG[pkg][0]
        s = JaxSession() if pkg == "jax" else Session(device="cpu")
        s.register_numpy("t", data, schema(M), validity=validity, dict_max_size=dict_max_size)
        out[pkg] = s
    return out


def _bloom(pkg, column, keys=(), items=None, num_bits=NUM_BITS, schema=None):
    M, _, E, P = PKG[pkg][:4]
    return P.Scan("t", schema(M)).aggregate(
        [E.col(k) for k in keys],
        [E.AggExpr("bloom_filter", E.col(column), "f", num_bits=num_bits,
                   extra=(E.lit(items),) if items else ())])


def _collect(sessions, plan_of):
    return {pkg: s.collect(plan_of(pkg)) for pkg, s in sessions.items()}


def _int_schema(M):
    return M.Schema([M.Field("g", M.INT64), M.Field("x", M.INT64)])


def test_int64_bytes_match_jax_and_the_oracle():
    rng = np.random.default_rng(0)
    n = 2000
    x = rng.integers(-2**62, 2**62, n).astype(np.int64)
    valid = rng.random(n) > 0.1
    data = {"g": rng.integers(0, 5, n).astype(np.int64), "x": x}
    ss = _sessions(data, _int_schema, {"x": valid})
    for keys in ((), ("g",)):
        outs = _collect(ss, lambda pkg: _bloom(pkg, "x", keys, 300, schema=_int_schema))
        assert list(outs["jax"]["f"]) == list(outs["port"]["f"])
        assert outs["port"]["f__valid"].all()
    (buf,) = _collect(ss, lambda pkg: _bloom(pkg, "x", (), 300, schema=_int_schema))["port"]["f"]
    k = int.from_bytes(buf[4:8], "big")
    assert (int.from_bytes(buf[0:4], "big"), k, int.from_bytes(buf[8:12], "big"), len(buf)) == (
        1, 9, NUM_BITS // 64, 12 + NUM_BITS // 8)
    assert buf == chip_smoke.bloom_oracle(x[valid], k, NUM_BITS)


def _str_schema(M):
    return M.Schema([M.Field("g", M.INT64), M.Field("s", M.string(24))])


@pytest.mark.parametrize("layout", ["dictionary", "padded"])
def test_string_bytes_match_jax(layout):
    rng = np.random.default_rng(1)
    n = 1500
    words = np.array([f"word-{i}" * (1 + i % 3) for i in range(300)] + [""], object)
    data = {"g": rng.integers(0, 3, n).astype(np.int64), "s": words[rng.integers(0, 301, n)]}
    ss = _sessions(data, _str_schema, {"s": rng.random(n) > 0.1},
                   dict_max_size=1 << 16 if layout == "dictionary" else 0)
    assert ss["port"].tables["t"].columns[1].is_dict == (layout == "dictionary")
    for keys in ((), ("g",)):
        outs = _collect(ss, lambda pkg: _bloom(pkg, "s", keys, 500, schema=_str_schema))
        assert list(outs["jax"]["f"]) == list(outs["port"]["f"])


def test_bit_indices_match_spark_oracle():
    values = [0, 1, -1, 12345, 2**40 + 7]
    ss = _sessions({"g": np.zeros(5, np.int64), "x": np.array(values, np.int64)}, _int_schema)
    (buf,) = ss["port"].collect(_bloom("port", "x", schema=_int_schema))["f"]
    # Spark's default of 1,000,000 expected items: round(4096 / 10^6 ln 2) is 0, so one
    assert parse_bloom_bytes(buf)[0] == 1
    k, words = parse_bloom_bytes(ss["port"].collect(_bloom("port", "x", (), 5,
                                                           schema=_int_schema))["f"][0])
    bits = (words[np.arange(NUM_BITS) >> 6] >> (np.arange(NUM_BITS) & 63)) & 1
    for v in values:
        for idx in _bloom_indices_oracle(v, k, NUM_BITS):
            assert bits[idx], (v, idx)


def test_probe_has_no_false_negative_and_the_oracles_positives():
    """The filter of 400 keys probed with them and 2,000 absent ones, as a
    literal and through a scalar subquery."""
    rng = np.random.default_rng(2)
    keys = rng.integers(0, 10**9, 400).astype(np.int64)
    probe = np.concatenate([keys, -rng.integers(1, 10**9, 2000)]).astype(np.int64)
    s = Session(device="cpu")
    M, _, E, P = PKG["port"][:4]
    sch = M.Schema([M.Field("x", M.INT64)])
    s.register_numpy("build", {"x": keys}, sch)
    s.register_numpy("probe", {"x": probe}, sch)
    sub = s.scalar_subquery(P.Scan("build", sch).aggregate(
        [], [E.AggExpr("bloom_filter", E.col("x"), "f", num_bits=8192, extra=(E.lit(400),))]))
    hits = s.collect(P.Scan("probe", sch).project([E.BloomMightContain(sub, E.col("x"))
                                                    .alias("hit")]))["hit"]
    buf = s.subqueries[0]["value"]
    assert parse_bloom_bytes(buf)[0] == 14  # round(8192 / 400 ln 2)
    assert buf == chip_smoke.bloom_oracle(keys, 14, 8192)
    assert hits[:400].all()
    np.testing.assert_array_equal(hits, chip_smoke.bloom_probe_oracle(buf, probe))
    lit = E.lit(buf, M.binary(len(buf)))
    kept = s.collect(P.Scan("probe", sch).filter(E.BloomMightContain(lit, E.col("x"))))["x"]
    np.testing.assert_array_equal(kept, probe[hits])


def test_might_contain_through_a_subquery_and_a_null_filter():
    """The JAX package's ``test_might_contain_via_subquery`` on the port, and
    a filter over no row: null, as JAX ``agg_special.py:372-376`` makes it,
    which keeps no row and probes to null."""
    M, _, E, P = PKG["port"][:4]
    sch = M.Schema([M.Field("x", M.INT64)])
    s = Session(device="cpu")
    s.register_numpy("build", {"x": np.array([5, 10, 15], np.int64)}, sch)
    s.register_numpy("probe", {"x": np.arange(20, dtype=np.int64)}, sch)

    def bloom(build):
        return s.scalar_subquery(build.aggregate([], [E.AggExpr(
            "bloom_filter", E.col("x"), "f", num_bits=1024, extra=(E.lit(3),))]))

    sub = bloom(P.Scan("build", sch))
    got = set(int(v) for v in s.collect(P.Scan("probe", sch).filter(
        E.BloomMightContain(sub, E.col("x"))))["x"])
    assert {5, 10, 15} <= got and len(got) <= 8
    none = bloom(P.Scan("build", sch).filter(E.col("x") < E.lit(0)))
    probe = E.BloomMightContain(none, E.col("x"))
    assert len(s.collect(P.Scan("probe", sch).filter(probe))["x"]) == 0
    assert not s.collect(P.Scan("probe", sch).project([probe.alias("h")]))["h__valid"].any()
    assert s.subqueries[0]["valid"] is False


@pytest.mark.parametrize("pkg", sorted(PKG))
@pytest.mark.parametrize("mode", ["partial", "final", "partial_merge"])
def test_other_modes_raise(pkg, mode):
    M, B, E, P, AGG, Ctx = PKG[pkg]
    sch = _int_schema(M)
    a = E.AggExpr("bloom_filter", E.col("x"), "f")
    with pytest.raises(NotImplementedError):
        node = P.bind_plan(P.HashAggregate(P.Scan("t", sch), (), (a,), mode))
        batch = (B.from_numpy({"g": np.zeros(4, np.int64), "x": np.arange(4, dtype=np.int64)},
                              sch) if pkg == "jax" else
                 B.from_numpy({"g": np.zeros(4, np.int64), "x": np.arange(4, dtype=np.int64)},
                              sch, "cpu"))
        if pkg == "jax":
            AGG.hash_aggregate(batch, (), node.agg_exprs, mode, 8, node.schema, Ctx())
        else:
            AGG.hash_aggregate(batch, (), node.agg_exprs, mode, node.schema, Ctx())

"""PyTorch port, Spark's xxhash64 (exec/evaluator.py) and the special
aggregates PERCENTILE, MEDIAN, APPROX_COUNT_DISTINCT (HyperLogLog, p = 9)
and APPROX_PERCENTILE (exec/operators/agg_special.py) against the JAX
package:

- xxhash64 bit for bit over every type the JAX package hashes (ints, dates,
  bools, INT64, FLOAT and DOUBLE with -0.0, NaN and infinities, narrow
  decimals, strings dictionary-coded and padded), nulls leaving the seed;
  a wide decimal raises in both;
- each aggregate ungrouped, grouped by an INT64 key (the sorted path in
  both packages) and by a dictionary-coded string key (the port's dense
  path; the JAX package sorts), over values with nulls and an all-null
  group: integers, hashes and selected elements exactly; a percentile of
  integers and doubles exactly (the port computes JAX's interpolation op for
  op); a percentile of a decimal within 1e-12 relative, the port reading the
  decimal's value where the JAX package reads its unscaled integer (C20);
- APPROX_PERCENTILE's PARTIAL states (sketch bytes and counts) equal to the
  JAX package's, its FINAL over them within the sketch's rank error of the
  exact answer and equal to JAX's, and its PARTIAL_MERGE states equal;
- PERCENTILE, MEDIAN and APPROX_COUNT_DISTINCT in a partial or merging
  mode raise in both packages, and a list of percentages raises in the
  port (it waits for the list type)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from datafusion_comet_tpu import types as JT
from datafusion_comet_tpu.conf import APPROX_PCT_SKETCH, CONF
from datafusion_comet_tpu.exec import batch as JB
from datafusion_comet_tpu.exec.evaluator import _xxhash64_column
from datafusion_comet_tpu.exec.evaluator import EvalContext as JCtx
from datafusion_comet_tpu.exec.operators import aggregate as JAGG
from datafusion_comet_tpu.ir import expr as JE
from datafusion_comet_tpu.ir import plan as JP
from datafusion_comet_tpu_torch import types as PT
from datafusion_comet_tpu_torch.exec import batch as PB
from datafusion_comet_tpu_torch.exec.evaluator import EvalContext as PCtx
from datafusion_comet_tpu_torch.exec.evaluator import xxhash64_column
from datafusion_comet_tpu_torch.exec.operators import aggregate as PAGG
from datafusion_comet_tpu_torch.exec.operators.agg_special import sketch_scope
from datafusion_comet_tpu_torch.ir import expr as PE
from datafusion_comet_tpu_torch.ir import plan as PP
from _torch_threads import one_torch_thread  # noqa: F401 (a fixture)

pytestmark = pytest.mark.usefixtures("one_torch_thread")

PKG = {"jax": (JT, JB, JE, JP, JAGG, JCtx), "port": (PT, PB, PE, PP, PAGG, PCtx)}
N = 1500
SKETCH = 64  # a small sketch keeps the merges' (groups x K) tensors small


def _batch(pkg, data, schema_of, validity=None, dict_max_size=1 << 16):
    M, B = PKG[pkg][:2]
    if pkg == "jax":
        return B.from_numpy(data, schema_of(M), validity=validity, dict_max_size=dict_max_size)
    return B.from_numpy(data, schema_of(M), "cpu", validity=validity,
                        dict_max_size=dict_max_size)


# ---- xxhash64 ------------------------------------------------------------------------

def _hash_cases():
    rng = np.random.default_rng(11)
    n = 300
    floats = rng.normal(size=n) * 1e3
    floats[:6] = [0.0, -0.0, np.nan, np.inf, -np.inf, 1e-310]
    words = np.array([f"w{i}" * (i % 9) for i in range(40)], object)
    return {
        "int8": (lambda M: M.INT8, rng.integers(-128, 128, n).astype(np.int8)),
        "int16": (lambda M: M.INT16, rng.integers(-2**15, 2**15, n).astype(np.int16)),
        "int32": (lambda M: M.INT32, rng.integers(-2**31, 2**31, n).astype(np.int32)),
        "int64": (lambda M: M.INT64, rng.integers(-2**63, 2**63 - 1, n, dtype=np.int64)),
        "date": (lambda M: M.DATE, rng.integers(-3000, 30000, n).astype(np.int32)),
        "bool": (lambda M: M.BOOL, rng.random(n) > 0.5),
        "float": (lambda M: M.FLOAT32, floats.astype(np.float32)),
        "double": (lambda M: M.FLOAT64, floats),
        "decimal7": (lambda M: M.decimal(7, 2), rng.integers(-10**6, 10**6, n).astype(object)),
        "decimal18": (lambda M: M.decimal(18, 4), rng.integers(-10**17, 10**17, n).astype(object)),
        "string_dict": (lambda M: M.string(24), words[rng.integers(0, 40, n)]),
        "string_padded": (lambda M: M.string(80), np.array(
            ["x" * int(k) + str(i) for i, k in enumerate(rng.integers(0, 70, n))], object)),
    }


@pytest.mark.parametrize("case", list(_hash_cases()))
def test_xxhash64_bit_equal_to_jax(case):
    dt, vals = _hash_cases()[case]
    valid = np.random.default_rng(3).random(len(vals)) > 0.15
    data = {"v": vals}

    def schema(M):
        return M.Schema([M.Field("v", dt(M))])

    dsize = 0 if case == "string_padded" else 1 << 16
    jcv = _batch("jax", data, schema, {"v": valid}, dsize).columns[0]
    pcv = _batch("port", data, schema, {"v": valid}, dsize).columns[0]
    assert pcv.is_dict == (case == "string_dict")
    want = np.array(_xxhash64_column(jcv, jnp.int64(42)))[:len(vals)]
    got = xxhash64_column(pcv, torch.tensor(42)).numpy()[:len(vals)].copy()
    if case == "double":
        # the JAX package on the CPU reads a subnormal as 0.0 (ROADMAP C13):
        # the port hashes its bits, as Spark's hashLong of doubleToLongBits
        assert valid[5] and got[5] == _hash_long(int(np.float64(1e-310).view(np.int64)), 42)
        valid[5] = False
        got[5] = want[5] = 42
    np.testing.assert_array_equal(got, want)
    assert (got[~valid] == 42).all()


def _hash_long(v: int, seed: int) -> int:
    """Spark's XXH64.hashLong in Python integers, mod 2^64."""
    m = (1 << 64) - 1
    p1, p2, p3, p4, p5 = (0x9E3779B185EBCA87, 0xC2B2AE3D27D4EB4F, 0x165667B19E3779F9,
                          0x85EBCA77C2B2AE63, 0x27D4EB2F165667C5)

    def rotl(x, r):
        return ((x << r) | (x >> (64 - r))) & m

    h = (seed + p5 + 8) & m
    h ^= rotl((v & m) * p2 & m, 31) * p1 & m
    h = (rotl(h, 27) * p1 + p4) & m
    h ^= h >> 33
    h = h * p2 & m
    h ^= h >> 29
    h = h * p3 & m
    h ^= h >> 32
    return h - (1 << 64) if h >= 1 << 63 else h


def test_xxhash64_of_a_wide_decimal_raises_in_both():
    def schema(M):
        return M.Schema([M.Field("v", M.decimal(30, 2))])

    data = {"v": np.array([10**25, -3], object)}
    with pytest.raises(NotImplementedError):
        _xxhash64_column(_batch("jax", data, schema).columns[0], jnp.int64(42))
    with pytest.raises(NotImplementedError):
        xxhash64_column(_batch("port", data, schema).columns[0], torch.tensor(42))


# ---- the aggregates -------------------------------------------------------------------

def _agg_schema(M):
    return M.Schema([M.Field("g", M.INT64), M.Field("s", M.string(8)), M.Field("i", M.INT64),
                     M.Field("f", M.FLOAT64), M.Field("d", M.decimal(9, 2))])


def _agg_data(seed: int):
    rng = np.random.default_rng(seed)
    g = rng.integers(0, 9, N).astype(np.int64)
    data = {"g": g, "s": np.array([f"k{v}" for v in g], object),
            "i": rng.integers(-40, 40, N).astype(np.int64),
            "f": rng.normal(size=N) * 100, "d": rng.integers(-10**6, 10**6, N).astype(object)}
    data["f"][:4] = [-0.0, 0.0, -0.0, 5.5]
    valid = {c: (rng.random(N) > 0.2) & (g != 7) for c in ("i", "f", "d")}  # group 7 all null
    return data, valid


def _run(pkg, batch, keys, aggs, mode=None, max_groups=64):
    M, B, E, P, AGG, Ctx = PKG[pkg]
    mode = mode or P.AggMode.SINGLE
    node = P.bind_plan(P.HashAggregate(P.Scan("t", batch.schema), tuple(E.col(k) for k in keys),
                                       tuple(aggs(E)), mode))
    ctx = Ctx(overflow_flags=[])
    if pkg == "jax":
        out = AGG.hash_aggregate(batch, node.group_exprs, node.agg_exprs, mode, max_groups,
                                 node.schema, ctx)
    else:
        out = AGG.hash_aggregate(batch, node.group_exprs, node.agg_exprs, mode, node.schema, ctx,
                                 max_groups=max_groups)
    return B.to_numpy(out), node


def _by_key(out, keys, cols):
    """{group key tuple: {column: value or None}}: the groups in any order
    (the port's dense path and the JAX package's sorted path order a null
    group differently)."""
    rows = {}
    n = len(out[cols[0]])
    for r in range(n):
        k = tuple(out[key][r] if out[key + "__valid"][r] else None for key in keys)
        rows[k] = {c: (out[c][r] if out[c + "__valid"][r] else None) for c in cols}
    return rows


AGGS = {
    "median_i": lambda E: [E.AggExpr("median", E.col("i"), "r")],
    "pct_i": lambda E: [E.AggExpr("percentile", E.col("i"), "r", extra=(E.lit(0.9),))],
    "pct_f": lambda E: [E.AggExpr("percentile", E.col("f"), "r", extra=(E.lit(0.37),))],
    "median_f": lambda E: [E.AggExpr("median", E.col("f"), "r")],
    "hll_i": lambda E: [E.AggExpr("approx_count_distinct", E.col("i"), "r")],
    "hll_f": lambda E: [E.AggExpr("approx_count_distinct", E.col("f"), "r")],
    "hll_s": lambda E: [E.AggExpr("approx_count_distinct", E.col("s"), "r")],
    "hll_d": lambda E: [E.AggExpr("approx_count_distinct", E.col("d"), "r")],
    "apct_i": lambda E: [E.AggExpr("approx_percentile", E.col("i"), "r",
                                   extra=(E.lit(0.5), E.lit(10000)))],
    "apct_f": lambda E: [E.AggExpr("approx_percentile", E.col("f"), "r", extra=(E.lit(0.1),))],
    "apct_d": lambda E: [E.AggExpr("approx_percentile", E.col("d"), "r", extra=(E.lit(0.75),))],
}


@pytest.mark.parametrize("keys", [(), ("g",), ("s",)], ids=["ungrouped", "sorted", "dense"])
@pytest.mark.parametrize("agg", list(AGGS))
def test_single_mode_matches_jax(agg, keys):
    data, valid = _agg_data(5)
    outs = {pkg: _run(pkg, _batch(pkg, data, _agg_schema, valid), keys, AGGS[agg])[0]
            for pkg in PKG}
    want, got = (_by_key(outs[p], keys, ["r"]) for p in ("jax", "port"))
    assert want.keys() == got.keys()
    if keys and agg != "hll_s":  # group 7's values are null but its key column's
        assert {k: v["r"] for k, v in got.items()}[("k7",) if keys == ("s",) else (7,)] is None
    for k in want:
        w, g = want[k]["r"], got[k]["r"]
        assert (w is None) == (g is None), k
        if w is not None:
            assert g == w or (np.isnan(g) and np.isnan(w)), (k, g, w)


@pytest.mark.parametrize("keys", [(), ("g",)])
def test_decimal_percentile_reads_the_value(keys):
    """The port's median of decimal(9,2) is the JAX package's (of the
    unscaled integers) over 100, within 1e-12 relative: the same
    interpolation, on values a hundred times smaller (C20)."""
    data, valid = _agg_data(6)

    def aggs(E):
        return [E.AggExpr("median", E.col("d"), "r"),
                E.AggExpr("percentile", E.col("d"), "p", extra=(E.lit(0.33),))]

    outs = {pkg: _run(pkg, _batch(pkg, data, _agg_schema, valid), keys, aggs)[0] for pkg in PKG}
    for c in ("r", "p"):
        want, got = (_by_key(outs[p], keys, [c]) for p in ("jax", "port"))
        assert want.keys() == got.keys()
        for k in want:
            w, g = want[k][c], got[k][c]
            assert (w is None) == (g is None)
            if w is not None:
                assert abs(g - w / 100) <= 1e-12 * max(abs(w / 100), 1e-300), (k, g, w)


@pytest.fixture
def small_sketch():
    prev = CONF.get(APPROX_PCT_SKETCH)
    CONF.set(APPROX_PCT_SKETCH.key, SKETCH)
    try:
        with sketch_scope(SKETCH):
            yield
    finally:
        CONF.set(APPROX_PCT_SKETCH.key, prev)


def _apct(E, col="f", p=0.3):
    return [E.AggExpr("approx_percentile", E.col(col), "r", extra=(E.lit(p),))]


@pytest.mark.parametrize("keys,col", [((), "i"), (("g",), "f"), (("s",), "i")],
                         ids=["ungrouped-int", "sorted-double", "dense-int"])
def test_approx_percentile_partial_final_and_merge_match_jax(small_sketch, keys, col):
    data, valid = _agg_data(7)
    parts, finals, merged = {}, {}, {}
    for pkg in PKG:
        M, B, E, P = PKG[pkg][:4]
        b = _batch(pkg, data, _agg_schema, valid)
        # two halves' partial states, merged by FINAL and by PARTIAL_MERGE
        halves = []
        for lo, hi in ((0, N // 2), (N // 2, N)):
            mask = np.zeros(b.capacity, bool)
            mask[lo:hi] = True
            hb = b.with_mask(b.row_mask & (jnp.asarray(mask) if pkg == "jax"
                                           else torch.from_numpy(mask)))
            out, node = _run(pkg, hb, keys, lambda E: _apct(E, col), P.AggMode.PARTIAL)
            halves.append(out)
        parts[pkg] = halves
        union = {k: np.concatenate([h[k] for h in halves]) for k in halves[0]}
        schema = node.schema
        cols = {f.name: union[f.name] for f in schema.fields}
        vals = {f.name: union[f.name + "__valid"] for f in schema.fields}
        # the sketches stay padded bytes (no dictionary)
        ub = (B.from_numpy(cols, schema, validity=vals, dict_max_size=0) if pkg == "jax" else
              B.from_numpy(cols, schema, "cpu", validity=vals, dict_max_size=0))
        # the merges take the aggregates as the partial run bound them
        finals[pkg] = _run(pkg, ub, keys, lambda E: node.agg_exprs, P.AggMode.FINAL)[0]
        merged[pkg] = _run(pkg, ub, keys, lambda E: node.agg_exprs, P.AggMode.PARTIAL_MERGE)[0]
    for j, p in zip(parts["jax"], parts["port"]):
        for c in ("r__sketch", "r__count"):
            assert _by_key(j, keys, [c]) == _by_key(p, keys, [c]), c
    for c in ("r__sketch", "r__count"):
        assert _by_key(merged["jax"], keys, [c]) == _by_key(merged["port"], keys, [c]), c
    want, got = (_by_key(finals[p], keys, ["r"]) for p in ("jax", "port"))
    assert want == got
    # within the rank error of the exact answer: two sketches of K samples
    exact = {}
    g = data["g"] if keys == ("g",) else (data["s"] if keys else np.zeros(N, int))
    for k, row in got.items():
        sel = (g == (k[0] if keys else 0)) & valid[col]
        xs = np.sort(np.asarray(data[col], float)[sel])
        if not len(xs):
            assert row["r"] is None
            continue
        rank = np.searchsorted(xs, float(row["r"]), side="right")
        exact[k] = abs(rank / len(xs) - 0.3)
    assert max(exact.values()) <= 2.0 / SKETCH + 2.0 / N


def _state_table():
    """A table shaped like a merge's input: the group and a state column."""
    def schema(M):
        return M.Schema([M.Field("g", M.INT64), M.Field("r", M.FLOAT64)])

    return {"g": np.arange(4, dtype=np.int64), "r": np.ones(4)}, schema


@pytest.mark.parametrize("func", ["percentile", "median", "approx_count_distinct"])
@pytest.mark.parametrize("mode", ["partial", "final", "partial_merge"])
def test_single_mode_only_aggregates_raise_in_other_modes(func, mode):
    for pkg in PKG:
        M, B, E, P = PKG[pkg][:4]
        extra = (E.lit(0.5),) if func == "percentile" else ()
        agg = E.AggExpr(func, E.col("i"), "r", extra=extra)
        with pytest.raises(NotImplementedError):
            node = P.bind_plan(P.HashAggregate(P.Scan("t", _agg_schema(M)), (E.col("g"),),
                                               (agg,), mode))
            if pkg == "port":  # a FINAL binds from the result type: it raises running
                PAGG.hash_aggregate(_batch(pkg, *_state_table()), node.group_exprs,
                                    node.agg_exprs, mode, node.schema, PCtx())
            else:
                JAGG.hash_aggregate(_batch(pkg, *_state_table()), node.group_exprs,
                                    node.agg_exprs, mode, 64, node.schema, JCtx())


def test_a_list_of_percentages_raises():
    """A list of percentages no longer raises (it waited for the list type,
    ported since): each group's ARRAY<DOUBLE> of the percentiles equals the
    JAX package's."""
    data, valid = _agg_data(2)
    outs = {}
    for pkg in ("port", "jax"):
        M = PKG[pkg][0]
        out, node = _run(pkg, _batch(pkg, data, _agg_schema, valid), ("g",),
                         lambda E: [E.AggExpr("percentile", E.col("i"), "r",
                                              extra=(E.Literal([0.1, 0.5],
                                                               M.list_(M.FLOAT64, 2)),))])
        assert repr(node.schema.field("r").dtype) == "array<double>[2]"
        outs[pkg] = _by_key(out, ("g",), ["r"])
    assert outs["port"] == outs["jax"] and all(len(v["r"]) == 2 for v in outs["port"].values()
                                               if v["r"] is not None)


def test_a_group_overflow_re_runs_the_special_aggregates():
    """Nine groups over a capacity of 4: the rows of the groups past it go
    with the dead rows (each aggregate's scatters stay in bounds), the run
    overflows and re-runs, and the answer is a roomy run's."""
    from datafusion_comet_tpu_torch.exec.engine import Session

    data, valid = _agg_data(8)
    outs = []
    for cap in (4, 64):
        s = Session(device="cpu")
        s.register_numpy("t", data, _agg_schema(PT), validity=valid)
        agg = PP.Scan("t", _agg_schema(PT)).aggregate([PE.col("g")], [
            PE.AggExpr("median", PE.col("i"), "m"),
            PE.AggExpr("approx_count_distinct", PE.col("i"), "h"),
            PE.AggExpr("percentile", PE.col("f"), "p", extra=(PE.lit(0.3),)),
            PE.AggExpr("approx_percentile", PE.col("d"), "q", extra=(PE.lit(0.6),))])
        agg.max_groups = cap
        outs.append(s.collect(agg))
        assert [r["overflowed"] for r in s.runs] == ([True, False] if cap == 4 else [False])
    for k in outs[1]:
        np.testing.assert_array_equal(outs[0][k], outs[1][k], err_msg=k)

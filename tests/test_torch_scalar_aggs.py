"""PyTorch port, the rest of the scalar aggregates (``exec/operators/
aggregate.py``): FIRST and LAST (nulls ignored and respected), BIT_AND,
BIT_OR, BIT_XOR, BOOL_AND, BOOL_OR, COVAR_SAMP, COVAR_POP, CORR, and MIN and
MAX of strings (dictionary-coded and padded) and of bools, against the JAX
package's ``hash_aggregate`` on the same inputs: the dense path (a
dictionary key), the sorted path (an int64 key) and ungrouped; SINGLE,
PARTIAL then FINAL, PARTIAL then PARTIAL_MERGE over states a fifth of them
dead; and through the engine, under the grace join's partial mode (K = 16)
and in the tiled aggregate (its PARTIAL_MERGE folds), against the port's
direct run. Inputs hold nulls, all-null groups and dead rows. Exact but the covariance family's DOUBLEs, within 1e-9
relative (the JAX package's sorted path sums through a prefix difference,
the port each group on its own, ROADMAP C12); those are also held to
``math.fsum`` and numpy, where the JAX package's prefix difference loses
a small group after a large one (C20)."""

import math
import warnings

import numpy as np
import pytest
import torch

import chip_smoke
from datafusion_comet_tpu.exec import batch as JB
from datafusion_comet_tpu_torch.exec import batch as PB
from datafusion_comet_tpu_torch.exec.memory import CPU_MEMORY_LIMIT, plan_peak_bytes
from test_torch_grace import PE, PP, PT, _fact_dim, _port_session
from test_torch_minmax import PKG
from _torch_threads import one_torch_thread  # noqa: F401 (a fixture)

pytestmark = pytest.mark.usefixtures("one_torch_thread")

RTOL = 1e-9
PATHS = {"dense": ("k",), "sorted": ("a",), "ungrouped": ()}
WORDS = ["pear", "apple", "fig", "q", "kiwi", "banana", ""]


def _table(n: int, seed: int):
    """Keys k (dictionary, 5 words) and a (int64, 200 values); values i
    int32, l int64 (full range), b bool, s string, f and y DOUBLE. Every
    value is null where k == "q" or a == 3, and 10% elsewhere; 10% of the
    rows are dead."""
    rng = np.random.default_rng(seed)
    k = np.array(["x", "yy", "zz", "q", "rr"], object)[rng.integers(0, 5, n)]
    a = rng.integers(0, 200, n).astype(np.int64)
    f = rng.normal(0.0, 10.0, n)
    data = {"k": k, "a": a, "i": rng.integers(-1000, 1000, n).astype(np.int32),
            "l": rng.integers(-2**62, 2**62, n).astype(np.int64), "b": rng.random(n) > 0.3,
            "s": np.array(WORDS, object)[rng.integers(0, len(WORDS), n)],
            "f": f, "y": 0.5 * f + rng.normal(0.0, 3.0, n)}
    null_group = (k == "q") | (a == 3)
    validity = {c: (rng.random(n) > 0.1) & ~null_group for c in ("i", "l", "b", "s", "f", "y")}
    return data, validity, rng.random(n) > 0.1


def _schema(M):
    return M.Schema([M.Field("k", M.string(2)), M.Field("a", M.INT64), M.Field("i", M.INT32),
                     M.Field("l", M.INT64), M.Field("b", M.BOOL), M.Field("s", M.string(6)),
                     M.Field("f", M.FLOAT64), M.Field("y", M.FLOAT64)])


def _aggs(E):
    out = [E.AggExpr(f, E.col(c), f"{f}_{c}") for f in ("first", "last") for c in ("i", "s")]
    out += [E.AggExpr(f, E.col(c), f"{f}_{c}_nulls", ignore_nulls=False)
            for f in ("first", "last") for c in ("l", "s")]
    out += [E.AggExpr(f, E.col(c), f"{f}_{c}")
            for f, c in (("bit_and", "i"), ("bit_or", "l"), ("bit_xor", "l"))]
    out += [E.AggExpr(f, E.col("b"), f"{f}_b") for f in ("bool_and", "bool_or", "min", "max")]
    out += [E.AggExpr(f, E.col("s"), f"{f}_s") for f in ("min", "max")]
    out += [E.AggExpr(f, E.col(x), f"{f}_{x}{y}", extra=(E.col(y),))
            for f, x, y in (("covar_samp", "f", "y"), ("covar_pop", "f", "y"),
                            ("corr", "f", "y"), ("covar_pop", "i", "l"))]
    return tuple(out)


def _batches(seed=0, n=3000, padded=False):
    data, validity, mask = _table(n, seed)
    kw = {"dict_max_size": 0} if padded else {}
    out = {}
    for pkg in PKG:
        M, B = PKG[pkg][:2]
        b = (B.from_numpy(data, _schema(M), validity=validity, **kw) if pkg == "jax"
             else B.from_numpy(data, _schema(M), "cpu", validity=validity, **kw))
        m = np.pad(mask, (0, b.capacity - len(mask)))
        out[pkg] = b.with_mask(b.row_mask & (m if pkg == "jax" else torch.from_numpy(m)))
    return out, (data, validity, mask)


def _aggregate(pkg, batch, keys, mode, aggs=None):
    M, B, E, P, AGG, Ctx = PKG[pkg]
    node = P.bind_plan(P.HashAggregate(P.Scan("t", batch.schema), tuple(E.col(k) for k in keys),
                                       aggs or _aggs(E), mode))
    if pkg == "jax":
        out = AGG.hash_aggregate(batch, node.group_exprs, node.agg_exprs, mode, 1 << 10,
                                 node.schema, Ctx(overflow_flags=[]))
    else:
        out = AGG.hash_aggregate(batch, node.group_exprs, node.agg_exprs, mode, node.schema,
                                 Ctx(overflow_flags=[]), max_groups=1 << 10)
    return out, node.agg_exprs


def _same(want, got):
    """Equal names, types, validity and values on the valid rows (DOUBLEs
    within RTOL, NaN equal to NaN)."""
    assert list(want) == list(got)
    for c in want:
        w, g = want[c], got[c]
        assert w.dtype == g.dtype, c
        ok = want[c + "__valid"] if not c.endswith("__valid") else np.ones(len(w), bool)
        if w.dtype == np.float64:
            np.testing.assert_allclose(g[ok], w[ok], rtol=RTOL, atol=1e-9, equal_nan=True,
                                       err_msg=c)
        else:
            np.testing.assert_array_equal(w[ok], g[ok], err_msg=c)


@pytest.mark.parametrize("path,padded", [(p, False) for p in sorted(PATHS)]
                         + [("sorted", True)])
def test_single_mode_matches_jax(path, padded):
    """Each path over dictionary-coded strings, and the sorted one over
    padded strings (every string column and key stored padded)."""
    batches, _ = _batches(seed=1, padded=padded)
    outs = {pkg: _aggregate(pkg, batches[pkg], PATHS[path], "single")[0] for pkg in PKG}
    _same(JB.to_numpy(outs["jax"]), PB.to_numpy(outs["port"]))
    for jc, pc in zip(outs["jax"].columns, outs["port"].columns):
        assert (np.asarray(jc.data).ndim, jc.mag_bound, jc.lengths is None) == (
            pc.data.dim(), pc.mag_bound, pc.lengths is None)


def test_single_mode_matches_python():
    """The dense path against Python over the live rows of each group."""
    batches, (data, validity, mask) = _batches(seed=2)
    got = PB.to_numpy(_aggregate("port", batches["port"], ("k",), "single")[0])
    for r, key in enumerate(got["k"]):
        rows = np.flatnonzero(mask & (data["k"] == key))

        def vals(c):
            return [data[c][i] for i in rows if validity[c][i]]

        def check(name, want):
            assert got[name + "__valid"][r] == (want is not None), (name, key)
            if want is not None:
                assert got[name][r] == want, (name, key)

        i, s = vals("i"), vals("s")
        check("first_i", i[0] if i else None)
        check("last_s", s[-1] if s else None)
        check("first_s_nulls", data["s"][rows[0]] if validity["s"][rows[0]] else None)
        check("last_l_nulls", data["l"][rows[-1]] if validity["l"][rows[-1]] else None)
        check("bit_and_i", int(np.bitwise_and.reduce(i)) if i else None)
        check("bit_xor_l", int(np.bitwise_xor.reduce(vals("l"))) if vals("l") else None)
        check("bool_and_b", bool(all(vals("b"))) if vals("b") else None)
        check("max_b", bool(any(vals("b"))) if vals("b") else None)
        check("min_s", min(s, key=lambda v: v.encode()) if s else None)
        check("max_s", max(s, key=lambda v: v.encode()) if s else None)


@pytest.mark.parametrize("path", sorted(PATHS))
def test_partial_then_final_and_partial_merge_match_jax(path):
    keys = PATHS[path]
    batches, _ = _batches(seed=3, n=4000)
    partial, aggs = {}, {}
    for pkg in PKG:
        partial[pkg], aggs[pkg] = _aggregate(pkg, batches[pkg], keys, "partial")
    _same(JB.to_numpy(partial["jax"]), PB.to_numpy(partial["port"]))
    cap = min(partial["jax"].capacity, partial["port"].capacity)
    keep = np.random.default_rng(4).random(cap) > 0.2
    states = {}
    for pkg, b in partial.items():
        m = np.pad(keep, (0, b.capacity - cap))
        states[pkg] = b.with_mask(b.row_mask & (m if pkg == "jax" else torch.from_numpy(m)))
    for mode in ("final", "partial_merge"):
        outs = {pkg: _aggregate(pkg, states[pkg], keys, mode, aggs[pkg])[0] for pkg in PKG}
        _same(JB.to_numpy(outs["jax"]), PB.to_numpy(outs["port"]))


def test_covariance_is_summed_per_group():
    """Groups of values near 1 after a group near 1e9, on the sorted path:
    the port sums each group on its own, so their covariance and
    correlation equal numpy's and ``math.fsum``'s within 1e-9; the JAX
    package differences one prefix sum over every group and loses their
    digits (ROADMAP C12, C20). (Within the group near 1e9 both packages'
    sum-of-products form cancels alike.)"""
    n = 400
    a = np.repeat(np.arange(4, dtype=np.int64), n // 4)
    rng = np.random.default_rng(5)
    x = rng.normal(0.0, 1.0, n) + np.where(a == 0, 1e9, 0.0)
    y = 2.0 * x + rng.normal(0.0, 1.0, n)
    outs = {}
    for pkg in PKG:
        M, B = PKG[pkg][:2]
        sch = M.Schema([M.Field("a", M.INT64), M.Field("x", M.FLOAT64), M.Field("y", M.FLOAT64)])
        b = (B.from_numpy({"a": a, "x": x, "y": y}, sch) if pkg == "jax"
             else B.from_numpy({"a": a, "x": x, "y": y}, sch, "cpu"))
        E = PKG[pkg][2]
        aggs = tuple(E.AggExpr(f, E.col("x"), f, extra=(E.col("y"),))
                     for f in ("covar_samp", "covar_pop", "corr"))
        out = _aggregate(pkg, b, ("a",), "single", aggs)[0]
        outs[pkg] = (JB if pkg == "jax" else PB).to_numpy(out)
    got, jax_err = outs["port"], []
    for g in (1, 2, 3):
        xs, ys = x[a == g], y[a == g]
        pop = math.fsum((xs - math.fsum(xs) / len(xs)) * (ys - math.fsum(ys) / len(ys))) / len(xs)
        np.testing.assert_allclose(
            [got["covar_pop"][g], got["covar_samp"][g], got["corr"][g]],
            [pop, np.cov(xs, ys)[0, 1], np.corrcoef(xs, ys)[0, 1]], rtol=1e-9)
        jax_err.append(abs(outs["jax"]["covar_pop"][g] / pop - 1))
    assert max(jax_err) > 1e-3, jax_err


def _join_plan(M, P, E, tables):
    j = P.HashJoin(P.Scan("fact", tables["fact"][1]), P.Scan("dim", tables["dim"][1]),
                   (E.col("fk"),), (E.col("pk"),), P.JoinType.INNER, "right")
    return j.aggregate([E.col("g")], [
        E.AggExpr("bit_or", E.col("w"), "or_w"), E.AggExpr("bit_xor", E.col("x"), "xor_x"),
        E.AggExpr("bool_or", E.col("w") > E.lit(45), "any_w"),
        E.AggExpr("bool_and", E.col("w") > E.lit(0), "all_w"),
        E.AggExpr("max", E.col("g"), "max_g"),
        E.AggExpr("covar_pop", E.col("x"), "cov_xw", extra=(E.col("w"),)),
        E.AggExpr("corr", E.col("x"), "corr_xw", extra=(E.col("w"),))]).sort(
        [E.SortOrder(E.col("g"))])


def test_grace_partial_mode_matches_direct():
    """The aggregate over a grace join at K = 16 in partial mode (each
    pair's PARTIAL states, one FINAL; its K and mode are the JAX package's,
    as ``test_torch_grace.py`` holds for this join) equals the direct run:
    these functions do not depend on the row order, which the pairs change."""
    ptables = _fact_dim(PT)
    direct = _port_session(ptables)
    plan = _join_plan(PT, PP, PE, ptables)
    fraction, _ = chip_smoke.grace_fraction(direct, plan, 16)
    grace = _port_session(ptables, fraction)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        got = grace.collect(plan)
    (runner,) = grace.grace_runners
    assert (runner.K, runner.downstream[0]) == (16, "partial")
    _same(direct.collect(plan), got)


def test_tiled_aggregate_matches_direct():
    """A SINGLE aggregate over one table under a sixteenth of its peak
    estimate runs tiled, its PARTIAL_MERGE folds included, and equals the
    direct run: tiles are slices in row order, so FIRST and LAST too."""
    ptables = _fact_dim(PT)
    plan = PP.Scan("fact", ptables["fact"][1]).aggregate([PE.col("fk")], [
        PE.AggExpr("first", PE.col("x"), "first_x"), PE.AggExpr("last", PE.col("v"), "last_v"),
        PE.AggExpr("bit_and", PE.col("x"), "and_x"),
        PE.AggExpr("bool_or", PE.col("x") > PE.lit(4990), "any_x"),
        PE.AggExpr("min", PE.col("v") > PE.lit(0), "min_pos"),
        PE.AggExpr("covar_samp", PE.col("x"), "cov_xv", extra=(PE.col("v"),))])
    direct = _port_session(ptables)
    want = direct.collect(plan)
    peak = plan_peak_bytes(PP.bind_plan(plan), direct.tables["fact"].capacity)
    tiled = _port_session(ptables, peak / 16 / CPU_MEMORY_LIMIT)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        got = tiled.collect(plan)
    assert tiled.tiled and tiled.tiled[0][1] > 8  # more tiles than one fold takes
    _same(want, got)

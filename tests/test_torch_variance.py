"""PyTorch port, the variance aggregates VAR_SAMP, VAR_POP, STDDEV_SAMP and
STDDEV_POP (``exec/operators/aggregate.py``, (n, avg, m2) states) against
the JAX package's ``hash_aggregate`` and numpy's ``var(ddof=1/0)``: the
dense path (a dictionary key), the sorted path (an int64 key) and
ungrouped; SINGLE, PARTIAL then FINAL, PARTIAL then PARTIAL_MERGE; under
the grace join (partial and local modes, K = 16) and in the tiled
aggregate. Inputs: int32 and int64 columns and a DOUBLE, with nulls,
all-null groups, one-row groups (the sample forms NaN there, not null) and
dead rows. Result and state values within 1e-9 relative (the JAX package's
sorted path sums through a prefix difference, the port each group on its
own); validity, storage and types equal; a variance of one row is held
to Spark's 0 (NaN for the sample), where the JAX package's prefix
difference leaves a rounding error (ROADMAP C12). A decimal input is read
by its value (the JAX package reads its unscaled integer: ROADMAP C20),
held to numpy."""

import warnings

import numpy as np
import pytest
import torch

import chip_smoke
from datafusion_comet_tpu.exec import batch as JB
from datafusion_comet_tpu_torch.exec import batch as PB
from datafusion_comet_tpu_torch.exec.memory import CPU_MEMORY_LIMIT, plan_peak_bytes
from test_torch_grace import (JE, JP, JT, PE, PP, PT, _fact_dim, _jax_session, _port_session,
                              jax_fraction, jax_spy)  # noqa: F401 (jax_spy: a fixture)
from test_torch_minmax import PKG, _batch
from test_torch_q18 import jax_tiles  # noqa: F401 (a fixture)
from _torch_threads import one_torch_thread  # noqa: F401 (a fixture)

pytestmark = pytest.mark.usefixtures("one_torch_thread")

FUNCS = ("var_samp", "var_pop", "stddev_samp", "stddev_pop")
RTOL = 1e-9


def _table(n: int, groups: int, seed: int):
    """Keys k (dictionary, 5 words) and a (int64, ``groups`` values, a few
    of them one-row groups); values i int32, l int64 (large), f DOUBLE.
    Every value is null where k == "q" or a == 3; 10% of the rows dead."""
    rng = np.random.default_rng(seed)
    k = np.array(["x", "yy", "zz", "q", "rr"], object)[rng.integers(0, 5, n)]
    a = rng.integers(0, groups, n).astype(np.int64)
    a[:4] = ONE_ROW + np.arange(4)  # one-row groups
    data = {"k": k, "a": a, "i": rng.integers(-50, 50, n).astype(np.int32),
            "l": rng.integers(-10**12, 10**12, n).astype(np.int64),
            "f": rng.normal(0.0, 10.0, n), "v": rng.integers(-10**6, 10**6, n).astype(np.int64)}
    null_group = (k == "q") | (a == 3)
    validity = {c: (rng.random(n) > 0.1) & ~null_group for c in ("i", "l", "f", "v")}
    validity["i"][:4] = True
    return data, validity, np.where(np.arange(n) < 4, True, rng.random(n) > 0.1)


def _schema(M):
    return M.Schema([M.Field("k", M.string(2)), M.Field("a", M.INT64), M.Field("i", M.INT32),
                     M.Field("l", M.INT64), M.Field("f", M.FLOAT64),
                     M.Field("v", M.decimal(12, 2))])


def _aggs(E, cols=("i", "l", "f")):
    return tuple(E.AggExpr(f, E.col(c), f"{f}_{c}") for c in cols for f in FUNCS) + tuple(
        E.AggExpr("count", E.col(c), f"n_{c}") for c in cols)


def _aggregate(pkg, batch, keys, mode, aggs=None, cols=("i", "l", "f")):
    M, B, E, P, AGG, Ctx = PKG[pkg]
    node = P.bind_plan(P.HashAggregate(P.Scan("t", batch.schema), tuple(E.col(k) for k in keys),
                                       aggs or _aggs(E, cols), mode))
    ctx = Ctx(overflow_flags=[])
    if pkg == "jax":
        out = AGG.hash_aggregate(batch, node.group_exprs, node.agg_exprs, mode, 1 << 10,
                                 node.schema, ctx)
    else:
        out = AGG.hash_aggregate(batch, node.group_exprs, node.agg_exprs, mode, node.schema, ctx,
                                 max_groups=1 << 10)
    return out, node.agg_exprs


ONE_ROW = 300  # _table's one-row groups: a >= 300


def _n_of(got, c):
    """The rows behind each value of column ``c``: its state's n, or the
    COUNT of its input (``{func}_{col}`` beside ``n_{col}``)."""
    if "__" in c:
        return got[c.rsplit("__", 1)[0] + "__n"]
    return got["n_" + c.split("_", 2)[-1]] if c.split("_")[0] in ("var", "stddev") else None


def _close(want, got):
    """Equal keys and validity, values within RTOL (NaN equal to NaN) on
    the valid rows, equal storage. A variance of one row is held to Spark
    (pop 0, samp NaN) instead: there the JAX package's m2 is x^2 - x^2
    after its sorted path's prefix difference, a rounding error (1e-11 for
    f) that a STDDEV's square root lifts to about 4e-6; the port's m2 is
    exactly 0."""
    assert list(want) == list(got)
    for c in want:
        w, g = want[c], got[c]
        assert w.dtype == g.dtype, c
        if c.endswith("__valid") or w.dtype != np.float64:
            np.testing.assert_array_equal(w, g, err_msg=c)
            continue
        ok = want[c + "__valid"].copy()
        n = _n_of(got, c)
        if n is not None:
            one = ok & (n == 1)
            ok &= n > 1
            if not c.endswith(("__n", "__avg")):
                want_one = np.nan if "_samp_" in c and "__" not in c else 0.0
                np.testing.assert_array_equal(g[one], want_one, err_msg=c)
        np.testing.assert_allclose(g[ok], w[ok], rtol=RTOL, atol=1e-9, equal_nan=True,
                                   err_msg=c)


def _batches(seed=0, n=3000, groups=300):
    data, validity, mask = _table(n, groups, seed)
    sch = {"jax": _schema(PKG["jax"][0]), "port": _schema(PKG["port"][0])}
    out = {}
    for pkg in PKG:
        M, B = PKG[pkg][:2]
        b = (B.from_numpy(data, sch[pkg], validity=validity) if pkg == "jax"
             else B.from_numpy(data, sch[pkg], "cpu", validity=validity))
        m = np.pad(mask, (0, b.capacity - len(mask)))
        out[pkg] = b.with_mask(b.row_mask & (m if pkg == "jax" else torch.from_numpy(m)))
    return out, (data, validity, mask)


PATHS = {"dense": ("k",), "sorted": ("a",), "ungrouped": ()}


def _numpy_oracle(data, validity, mask, key, col, scale=1):
    """{key: (n, var_samp, var_pop)} of the live valid rows, numpy's var."""
    out = {}
    keys = data[key] if key else np.zeros(len(mask), np.int64)
    for kv in np.unique(keys[mask]):
        rows = mask & (keys == kv)
        x = data[col][rows & validity[col]].astype(np.float64) / scale
        out[kv] = (len(x), np.var(x, ddof=1) if len(x) > 1 else np.nan,
                   np.var(x) if len(x) else None)
    return out


@pytest.mark.parametrize("path", sorted(PATHS))
def test_single_mode_matches_jax_and_numpy(path):
    keys = PATHS[path]
    batches, (data, validity, mask) = _batches()
    outs = {pkg: _aggregate(pkg, batches[pkg], keys, "single")[0] for pkg in PKG}
    want, got = JB.to_numpy(outs["jax"]), PB.to_numpy(outs["port"])
    _close(want, got)
    for jc, pc in zip(outs["jax"].columns, outs["port"].columns):
        assert np.asarray(jc.data).ndim == pc.data.dim() and jc.mag_bound == pc.mag_bound
    for col in ("i", "l", "f"):
        ora = _numpy_oracle(data, validity, mask, keys[0] if keys else None, col)
        gk = got[keys[0]] if keys else [0]
        for r, kv in enumerate(gk):
            n, vs, vp = ora[kv]
            valid = {f: got[f"{f}_{col}__valid"][r] for f in FUNCS}
            assert all(valid[f] == (n >= 1) for f in FUNCS), (kv, col)
            if n == 0:
                continue
            vals = {f: got[f"{f}_{col}"][r] for f in FUNCS}
            np.testing.assert_allclose([vals["var_pop"], vals["stddev_pop"]],
                                       [vp, np.sqrt(vp)], rtol=1e-7, atol=1e-9)
            if n == 1:  # Spark: NaN, not null
                assert np.isnan(vals["var_samp"]) and np.isnan(vals["stddev_samp"])
            else:
                np.testing.assert_allclose([vals["var_samp"], vals["stddev_samp"]],
                                           [vs, np.sqrt(vs)], rtol=1e-7, atol=1e-9)


@pytest.mark.parametrize("path", sorted(PATHS))
def test_partial_then_final_and_partial_merge_match_jax(path):
    """PARTIAL's (n, avg, m2) states, then FINAL and PARTIAL_MERGE over each
    package's own states, a fifth of them dead."""
    keys = PATHS[path]
    batches, _ = _batches(seed=2, n=4000)
    partial, aggs = {}, {}
    for pkg in PKG:
        partial[pkg], aggs[pkg] = _aggregate(pkg, batches[pkg], keys, "partial")
    _close(JB.to_numpy(partial["jax"]), PB.to_numpy(partial["port"]))
    cap = min(partial["jax"].capacity, partial["port"].capacity)
    keep = np.random.default_rng(3).random(cap) > 0.2
    states = {}
    for pkg, b in partial.items():
        m = np.pad(keep, (0, b.capacity - cap))
        states[pkg] = b.with_mask(b.row_mask & (m if pkg == "jax" else torch.from_numpy(m)))
    for mode in ("final", "partial_merge"):
        outs = {pkg: _aggregate(pkg, states[pkg], keys, mode, aggs[pkg])[0] for pkg in PKG}
        _close(JB.to_numpy(outs["jax"]), PB.to_numpy(outs["port"]))


def test_decimal_input_is_read_by_its_value():
    """VAR/STDDEV of a decimal(12,2): numpy's over the values; the JAX
    package's is over the unscaled integers, 10^4 (var) and 10^2 (stddev)
    times as large (C20)."""
    batches, (data, validity, mask) = _batches(seed=4)
    outs = {pkg: PB.to_numpy(_aggregate(pkg, batches[pkg], ("k",), "single", cols=("v",))[0])
            if pkg == "port" else JB.to_numpy(_aggregate(pkg, batches[pkg], ("k",), "single",
                                                          cols=("v",))[0]) for pkg in PKG}
    got, want = outs["port"], outs["jax"]
    ora = _numpy_oracle(data, validity, mask, "k", "v", scale=100)
    for r, kv in enumerate(got["k"]):
        n, vs, vp = ora[kv]
        if n >= 2:
            np.testing.assert_allclose([got["var_samp_v"][r], got["var_pop_v"][r]], [vs, vp],
                                       rtol=1e-7)
    ok = got["var_samp_v__valid"] & ~np.isnan(got["var_samp_v"])
    np.testing.assert_allclose(want["var_samp_v"][ok] / 1e4, got["var_samp_v"][ok], rtol=1e-9)
    np.testing.assert_allclose(want["stddev_pop_v"][ok] / 1e2, got["stddev_pop_v"][ok],
                               rtol=1e-9)


def _var_join(M, P, E, tables, how):
    j = P.HashJoin(P.Scan("fact", tables["fact"][1]), P.Scan("dim", tables["dim"][1]),
                   (E.col("fk"),), (E.col("pk"),), P.JoinType.INNER, "right")
    aggs = [E.AggExpr(f, E.col(c), f"{f}_{c}") for f in FUNCS for c in ("x", "w")] + [
        E.AggExpr("count", E.col(c), f"n_{c}") for c in ("x", "w")]
    if how == "local":  # grouped by the join key: the groups of one pair each
        return j.aggregate([E.col("fk")], aggs)
    return j.aggregate([E.col("g")], aggs).sort([E.SortOrder(E.col("g"))])


def _by(out, key):
    """A collected answer's rows ordered by ``key`` (a union of pairs keeps
    the partition order)."""
    order = np.argsort(out[key], kind="stable")
    return {c: v[order] for c, v in out.items()}


@pytest.mark.parametrize("how,mode", [("agg", "partial"), ("local", "local")])
def test_grace_matches_jax_and_direct(jax_spy, how, mode):
    ptables, jtables = _fact_dim(PT), _fact_dim(JT)
    js = _jax_session(jtables)
    want = js.collect(_var_join(JT, JP, JE, jtables, how))
    direct = _port_session(ptables)
    plan = _var_join(PT, PP, PE, ptables, how)
    fraction, _ = chip_smoke.grace_fraction(direct, plan, 16)
    grace = _port_session(ptables, fraction)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        got = grace.collect(plan)
    (runner,) = grace.grace_runners
    assert (runner.K, runner.downstream and runner.downstream[0]) == (16, mode)
    with jax_fraction(fraction):
        got_jax = js.collect(_var_join(JT, JP, JE, jtables, how))
    assert jax_spy == [(16, mode)]
    key = "fk" if how == "local" else "g"
    for g in (got, direct.collect(plan), got_jax):
        _close(_by(want, key), _by(g, key))


def test_tiled_aggregate_matches_jax(jax_tiles):
    """A SINGLE aggregate over one table under a budget of a quarter of its
    peak estimate: both packages run it tiled, in as many tiles, and agree
    with the direct run."""
    ptables, jtables = _fact_dim(PT), _fact_dim(JT)

    def plan(M, P, E, tables):
        return P.Scan("fact", tables["fact"][1]).aggregate(
            [E.col("fk")], [E.AggExpr(f, E.col("x"), f"{f}_x") for f in FUNCS]
            + [E.AggExpr("count", E.col("x"), "n_x")])

    direct = _port_session(ptables)
    want = direct.collect(plan(PT, PP, PE, ptables))
    bound = PP.bind_plan(plan(PT, PP, PE, ptables))
    peak = plan_peak_bytes(bound, direct.tables["fact"].capacity)
    fraction = peak / 4 / CPU_MEMORY_LIMIT
    tiled = _port_session(ptables, fraction)
    got = tiled.collect(plan(PT, PP, PE, ptables))
    assert tiled.tiled and tiled.tiled[0][1] > 1
    js = _jax_session(jtables)
    with jax_fraction(fraction):
        got_jax = js.collect(plan(JT, JP, JE, jtables))
    assert [t for _, t in tiled.tiled] == jax_tiles
    _close(want, got)
    _close(got_jax, got)

"""PyTorch port, the sorted aggregate (exec/operators/aggregate.py's sorted
path) exactly against JAX ``hash_aggregate`` on the same seeded input: one to
three int, date and dictionary keys, with and without key ranges (the packed
sort limbs and the generic grouping limbs), null keys and dead rows, narrow
and wide decimal sums, COUNT(*), COUNT(x) and AVG, every mode (SINGLE,
PARTIAL then FINAL, PARTIAL_MERGE), group capacities on both sides of
_seg_bounds' 2^16 switch, and a group-capacity overflow. Values, order,
storage (narrow int64 or two-limb) and magnitude bounds must be equal; the
port's grouping limbs order rows as the JAX package's, and its lexsort is
theirs."""

import numpy as np
import pytest
import torch

from datafusion_comet_tpu import types as JT
from datafusion_comet_tpu.exec import batch as JB
from datafusion_comet_tpu.exec import sortkeys as JS
from datafusion_comet_tpu.exec.evaluator import EvalContext as JCtx
from datafusion_comet_tpu.exec.operators import aggregate as JAGG
from datafusion_comet_tpu.ir import expr as JE
from datafusion_comet_tpu.ir import plan as JP
from datafusion_comet_tpu_torch import types as PT
from datafusion_comet_tpu_torch.exec import batch as PB
from datafusion_comet_tpu_torch.exec import sortkeys as PS
from datafusion_comet_tpu_torch.exec.evaluator import EvalContext as PCtx
from datafusion_comet_tpu_torch.exec.operators import aggregate as PAGG
from datafusion_comet_tpu_torch.ir import expr as PE
from datafusion_comet_tpu_torch.ir import plan as PP
from _torch_threads import one_torch_thread  # noqa: F401 (a fixture)

pytestmark = pytest.mark.usefixtures("one_torch_thread")

PKG = {"jax": (JT, JB, JE, JP, JAGG, JCtx), "port": (PT, PB, PE, PP, PAGG, PCtx)}
WORDS = [f"w{i:03d}" for i in range(100)]  # a 100-value dictionary: past the dense domain


def _table(n: int, groups: int, seed: int):
    """Keys: a (int64, ~groups distinct, 5% null), d (date), s (int32, 3
    values), g (string, dictionary-coded, 100 values); values: v
    decimal(12,2), w decimal(30,2) stored wide (|w| up to 10^24), i int32,
    each with nulls; the row mask drops about 10%."""
    rng = np.random.default_rng(seed)
    data = {
        "a": rng.integers(-groups // 2, groups // 2, n).astype(np.int64) * 7 + 3,
        "d": (9000 + rng.integers(0, 40, n)).astype(np.int32),
        "s": rng.integers(0, 3, n).astype(np.int32),
        "g": np.array(WORDS, object)[rng.integers(0, len(WORDS), n)],
        "v": rng.integers(-10**9, 10**9, n).astype(np.int64),
        "w": np.array([int(x) * 10**15 for x in rng.integers(-10**9, 10**9, n)], object),
        "i": rng.integers(-2**31, 2**31 - 1, n).astype(np.int32),
    }
    validity = {c: rng.random(n) > p for c, p in
                (("a", 0.05), ("d", 0.02), ("v", 0.1), ("w", 0.1), ("i", 0.2))}
    mask = rng.random(n) > 0.1
    ranges = {c: (int(data[c].min()), int(data[c].max())) for c in ("a", "d", "s")}
    return data, validity, mask, ranges


def _schema(M):
    return M.Schema([M.Field("a", M.INT64), M.Field("d", M.DATE), M.Field("s", M.INT32),
                     M.Field("g", M.string(4)), M.Field("v", M.decimal(12, 2)),
                     M.Field("w", M.decimal(30, 2)), M.Field("i", M.INT32)])


def _aggs(E, M):
    return (E.AggExpr("sum", E.col("v"), "sv"), E.AggExpr("sum", E.col("w"), "sw"),
            E.AggExpr("sum", E.col("i"), "si"), E.AggExpr("avg", E.col("v"), "av"),
            E.AggExpr("avg", E.col("w"), "aw"), E.AggExpr("count", E.col("v"), "cv"),
            E.AggExpr("count", None, "n"),
            E.AggExpr("sum", E.col("v") * (E.lit(1).cast(M.decimal(10, 0)) - E.col("v")), "sx"))


def _batch(pkg, data, validity, mask):
    M, B = PKG[pkg][:2]
    if pkg == "jax":
        b = B.from_numpy(data, _schema(M), validity=validity)
        pad = np.zeros(b.capacity, bool)
        pad[:len(mask)] = mask
        return b.with_mask(b.row_mask & pad)
    b = B.from_numpy(data, _schema(M), "cpu", validity=validity)
    pad = torch.zeros(b.capacity, dtype=torch.bool)
    pad[:len(mask)] = torch.from_numpy(mask)
    return b.with_mask(b.row_mask & pad)


def _aggregate(pkg, batch, keys, mode, max_groups, ranges, aggs=None, flags=None):
    """One package's hash_aggregate of ``batch`` grouped by the named keys:
    (output batch, the bound aggregates). Input modes bind the aggregates
    against ``batch``; merge modes take those of the partial run."""
    M, B, E, P, AGG, Ctx = PKG[pkg]
    node = P.bind_plan(P.HashAggregate(P.Scan("t", batch.schema), tuple(E.col(k) for k in keys),
                                       aggs or _aggs(E, M), mode))
    key_ranges = tuple(ranges.get(k) for k in keys) if ranges else None
    ctx = Ctx(overflow_flags=flags if flags is not None else [])
    if pkg == "jax":
        out = AGG.hash_aggregate(batch, node.group_exprs, node.agg_exprs, mode, max_groups,
                                 node.schema, ctx, key_ranges=key_ranges)
    else:
        out = AGG.hash_aggregate(batch, node.group_exprs, node.agg_exprs, mode, node.schema, ctx,
                                 max_groups=max_groups, key_ranges=key_ranges)
    return out, node.agg_exprs


def _assert_same(jout, pout, layout=True):
    """Equal live rows (values, validity, dtypes), equal storage and bounds
    per column and, where both ran the sorted path, equal capacity and
    group mask."""
    jn, pn = JB.to_numpy(jout), PB.to_numpy(pout)
    assert list(jn) == list(pn)
    for k in jn:
        assert jn[k].dtype == pn[k].dtype, k
        np.testing.assert_array_equal(jn[k], pn[k], err_msg=k)
    for jc, pc, f in zip(jout.columns, pout.columns, pout.schema.fields):
        assert np.asarray(jc.data).ndim == pc.data.dim(), f.name
        assert jc.mag_bound == pc.mag_bound, f.name
    if layout:
        assert jout.capacity == pout.capacity
        np.testing.assert_array_equal(np.asarray(jout.row_mask), pout.row_mask.numpy())


# keys, with stats ranges: one packed limb with ranges, the generic limbs
# without (and for the dictionary key, which packs either way)
KEYS = [("a",), ("a", "d"), ("a", "d", "s"), ("g", "a"), ("d", "g", "s")]


@pytest.mark.parametrize("ranged", [True, False], ids=["ranges", "no_ranges"])
@pytest.mark.parametrize("keys", KEYS, ids=lambda k: "_".join(k))
def test_single_mode_matches_jax(keys, ranged):
    data, validity, mask, ranges = _table(3000, 400, seed=len(keys) + 10 * ranged)
    outs = {pkg: _aggregate(pkg, _batch(pkg, data, validity, mask), keys, "single", 1 << 12,
                            ranges if ranged else None)[0] for pkg in PKG}
    _assert_same(outs["jax"], outs["port"])
    assert 0 < int(outs["port"].num_rows()) < 1 << 12


@pytest.mark.parametrize("max_groups", [(1 << 16) - 1, 1 << 17], ids=["search", "scatter"])
def test_seg_bounds_both_sides_of_the_switch(max_groups):
    """About 40,000 groups over 90,000 rows: group bounds by binary search
    below 2^16 groups of capacity, by the first-row scatter at and above."""
    data, validity, mask, ranges = _table(90_000, 40_000, seed=5)
    outs = {pkg: _aggregate(pkg, _batch(pkg, data, validity, mask), ("a", "s"), "single",
                            max_groups, ranges)[0] for pkg in PKG}
    _assert_same(outs["jax"], outs["port"])
    assert int(outs["port"].num_rows()) > 1 << 15


@pytest.mark.parametrize("keys", [("a", "d"), ("g", "a")], ids=lambda k: "_".join(k))
def test_seg_bounds_search_branch_matches_jax(keys):
    """The binary-search branch with many groups in a capacity below 2^16."""
    data, validity, mask, ranges = _table(20_000, 6_000, seed=6)
    outs = {pkg: _aggregate(pkg, _batch(pkg, data, validity, mask), keys, "single",
                            (1 << 16) - 1, ranges)[0] for pkg in PKG}
    _assert_same(outs["jax"], outs["port"])


@pytest.mark.parametrize("keys", [("a",), ("g", "d")], ids=lambda k: "_".join(k))
@pytest.mark.parametrize("ranged", [True, False], ids=["ranges", "no_ranges"])
def test_partial_then_final_and_partial_merge_match_jax(keys, ranged):
    """PARTIAL states equal, then FINAL and PARTIAL_MERGE over each
    package's own states (with some state rows dead) equal."""
    data, validity, mask, ranges = _table(4000, 500, seed=7)
    rng = ranges if ranged else None
    partial, aggs = {}, {}
    for pkg in PKG:
        partial[pkg], aggs[pkg] = _aggregate(pkg, _batch(pkg, data, validity, mask), keys,
                                             "partial", 1 << 12, rng)
    _assert_same(partial["jax"], partial["port"])
    keep = np.random.default_rng(8).random(partial["port"].capacity) > 0.2
    states = {"jax": partial["jax"].with_mask(partial["jax"].row_mask & keep),
              "port": partial["port"].with_mask(partial["port"].row_mask
                                                & torch.from_numpy(keep))}
    for mode in ("final", "partial_merge"):
        outs = {pkg: _aggregate(pkg, states[pkg], keys, mode, 1 << 12, rng, aggs[pkg])[0]
                for pkg in PKG}
        _assert_same(outs["jax"], outs["port"])


def test_dictionary_key_past_the_dense_domain():
    """A 100-value dictionary key alone: the JAX package takes its bucket
    path (which keeps the inputs' bounds), the port its sorted path keeping
    them too: equal values and storage, in the port's key-ordered layout."""
    data, validity, mask, _ = _table(3000, 400, seed=9)
    outs = {pkg: _aggregate(pkg, _batch(pkg, data, validity, mask), ("g",), "single", 1 << 12,
                            None)[0] for pkg in PKG}
    _assert_same(outs["jax"], outs["port"], layout=False)
    assert outs["port"].capacity == 1 << 12


@pytest.mark.parametrize("keys", [("a",), ("a", "d", "s")], ids=lambda k: "_".join(k))
def test_group_overflow_sets_the_flag(keys):
    """More groups than the capacity: both packages flag the run."""
    data, validity, mask, ranges = _table(3000, 400, seed=11)
    for max_groups, want in ((64, True), ((1 << 12) - 1, False)):
        for pkg in PKG:
            flags = []
            _aggregate(pkg, _batch(pkg, data, validity, mask), keys, "single", max_groups,
                       ranges, flags=flags)
            assert [bool(np.asarray(f)) for f in flags] == [want], (pkg, max_groups)


def test_group_capacity_grows_with_the_retry_scale():
    """The session's growth scale multiplies max_groups, as in the JAX
    package; the output capacity never exceeds the input's."""
    data, validity, mask, ranges = _table(3000, 400, seed=12)
    b = _batch("port", data, validity, mask)
    for scale, cap in ((1, 64), (4, 256), (1024, b.capacity)):
        node = PP.bind_plan(PP.HashAggregate(PP.Scan("t", b.schema), (PE.col("a"),),
                                             (PE.AggExpr("count", None, "n"),)))
        out = PAGG.hash_aggregate(b, node.group_exprs, node.agg_exprs, "single", node.schema,
                                  PCtx(overflow_flags=[], agg_scale=scale), max_groups=64)
        assert out.capacity == cap


@pytest.mark.parametrize("keys", KEYS, ids=lambda k: "_".join(k))
def test_grouping_limbs_and_lexsort_match_jax(keys):
    data, validity, mask, _ = _table(2000, 300, seed=13)
    jb, pb = _batch("jax", data, validity, mask), _batch("port", data, validity, mask)
    jl = JS.grouping_limbs([jb.column(k) for k in keys])
    pl = PS.grouping_limbs([pb.column(k) for k in keys])
    assert len(jl) == len(pl)
    for j, p in zip(jl, pl):
        np.testing.assert_array_equal(np.asarray(j).astype(np.int64), p.long().numpy())
    np.testing.assert_array_equal(np.asarray(JS.lexsort(jl)), PS.lexsort(pl).numpy())


@pytest.mark.parametrize("keys", [("a", "d", "s"), ("g", "a")], ids=lambda k: "_".join(k))
def test_packed_sort_limbs_order_rows_as_grouping_limbs(keys):
    """With ranges the keys pack into one int64 limb per 62 bits whose
    order is the generic limbs' order; the JAX package packs the same."""
    data, validity, mask, ranges = _table(2000, 300, seed=14)
    jb, pb = _batch("jax", data, validity, mask), _batch("port", data, validity, mask)
    kr = tuple(ranges.get(k) for k in keys)
    jp = JAGG._pack_sort_limbs([jb.column(k) for k in keys], kr)
    pp = PAGG._pack_sort_limbs([pb.column(k) for k in keys], kr)
    assert len(pp) == len(jp) == 1
    np.testing.assert_array_equal(np.asarray(jp[0]), pp[0].numpy())
    generic = PS.lexsort(PS.grouping_limbs([pb.column(k) for k in keys]))
    np.testing.assert_array_equal(torch.sort(pp[0], stable=True).indices.numpy(),
                                  generic.numpy())


def test_two_limb_take_keeps_every_bit_pattern():
    """Wide decimals' (n, 2) int64 rows are gathered as one 16-byte element
    each: every bit pattern survives, NaN payloads of the float view
    included, and the result is ``data[indices]``."""
    rng = np.random.default_rng(15)
    words = rng.integers(-2**63, 2**63 - 1, (1000, 2), dtype=np.int64)
    words[:4] = [[0x7FF0000000000001, -1], [-0x0008000000000000, 0x7FF8000000000001],
                 [0x7FF0000000000000, -0x0010000000000000], [1, 0x7FFFFFFFFFFFFFFF]]
    data = torch.from_numpy(words)
    idx = torch.from_numpy(rng.integers(0, 1000, 3000))
    got = PB._take_rows(data, idx)
    assert got.shape == (3000, 2) and got.dtype == torch.int64
    assert torch.equal(got, data[idx])

"""PyTorch port, MIN and MAX (exec/operators/aggregate.py) exactly against the
JAX package's ``hash_aggregate`` on the same seeded input: the dense path
(a dictionary key), the sorted path (an int64 key, with and without its
statistics range) and ungrouped; every mode (SINGLE, PARTIAL then FINAL,
PARTIAL then PARTIAL_MERGE); int32, int64, date, narrow decimal, a wide
decimal type in narrow storage and a two-limb decimal whose high limbs tie
often (the limb tournament); null values, all-null groups and dead rows.
Values, validity, storage and magnitude bounds must be equal.

Then TPC-H Q15 (a per-supplier revenue sum, its ungrouped MAX, a LEFT_SEMI
join on the decimal revenue and an INNER join with ``supplier``) through
the ``Session`` against the JAX Session and the numpy oracle chip_smoke.py
checks the card with, at SF 0.01 and on a hand-made ``lineitem`` where two
suppliers tie for the maximum; and the semi join's two decimal key sides
in the same storage as in the JAX package, two-limb (Q15) and narrow."""

import numpy as np
import pytest
import torch

import chip_smoke
from datafusion_comet_tpu import types as JT
from datafusion_comet_tpu.exec import batch as JB
from datafusion_comet_tpu.exec.engine import Session as JaxSession
from datafusion_comet_tpu.exec.evaluator import EvalContext as JCtx
from datafusion_comet_tpu.exec.operators import aggregate as JAGG
from datafusion_comet_tpu.ir import expr as JE
from datafusion_comet_tpu.ir import plan as JP
from datafusion_comet_tpu.models import tpch as JTPCH
from datafusion_comet_tpu_torch import types as PT
from datafusion_comet_tpu_torch.exec import batch as PB
from datafusion_comet_tpu_torch.exec.engine import Session
from datafusion_comet_tpu_torch.exec.evaluator import EvalContext as PCtx
from datafusion_comet_tpu_torch.exec.operators import aggregate as PAGG
from datafusion_comet_tpu_torch.exec.operators import join as PJ
from datafusion_comet_tpu_torch.ir import expr as PE
from datafusion_comet_tpu_torch.ir import plan as PP
from datafusion_comet_tpu_torch.models import tpch
from _torch_threads import one_torch_thread  # noqa: F401 (a fixture)

pytestmark = pytest.mark.usefixtures("one_torch_thread")

PKG = {"jax": (JT, JB, JE, JP, JAGG, JCtx), "port": (PT, PB, PE, PP, PAGG, PCtx)}
VALUES = ("i", "l", "d", "v", "ws", "w")
WORDS = ["x", "yy", "zz", "q", "rr"]


def _table(n: int, groups: int, seed: int):
    """Keys: k (dictionary-coded, 5 values), a (int64, about ``groups``
    values). Values: i int32, l int64 (full range), d date, v decimal(12,2),
    ws decimal(30,2) with small values (narrow storage), w decimal(30,2)
    with high limbs in {-3..2} (two-limb storage, many high-limb ties).
    Every value is null where k == "q" (an all-null group of the dense
    path) or a == 3 (one of the sorted path), and 10% elsewhere; 10% of
    the rows are dead."""
    rng = np.random.default_rng(seed)
    k = np.array(WORDS, object)[rng.integers(0, len(WORDS), n)]
    a = rng.integers(0, groups, n).astype(np.int64)
    data = {
        "k": k, "a": a,
        "i": rng.integers(-50, 50, n).astype(np.int32),  # ties within groups
        "l": rng.integers(-2**63, 2**63 - 1, n, dtype=np.int64),
        "d": (9000 + rng.integers(0, 30, n)).astype(np.int32),
        "v": rng.integers(-10**9, 10**9, n).astype(np.int64),
        "ws": np.array([int(x) for x in rng.integers(-10**6, 10**6, n)], object),
        "w": np.array([int(h) * 2**64 + int(lo) for h, lo in
                       zip(rng.integers(-3, 3, n), rng.integers(-2**63, 2**63 - 1, n))], object),
    }
    null_group = (k == "q") | (a == 3)
    validity = {c: (rng.random(n) > 0.1) & ~null_group for c in VALUES}
    return data, validity, rng.random(n) > 0.1


def _schema(M):
    return M.Schema([M.Field("k", M.string(2)), M.Field("a", M.INT64), M.Field("i", M.INT32),
                     M.Field("l", M.INT64), M.Field("d", M.DATE), M.Field("v", M.decimal(12, 2)),
                     M.Field("ws", M.decimal(30, 2)), M.Field("w", M.decimal(30, 2))])


def _aggs(E):
    return tuple(E.AggExpr(f, E.col(c), f"{f}_{c}") for c in VALUES for f in ("min", "max")) + (
        E.AggExpr("count", None, "n"),)


def _batch(pkg, data, validity, mask):
    M, B = PKG[pkg][:2]
    if pkg == "jax":
        b = B.from_numpy(data, _schema(M), validity=validity)
        return b.with_mask(b.row_mask & np.pad(mask, (0, b.capacity - len(mask))))
    b = B.from_numpy(data, _schema(M), "cpu", validity=validity)
    return b.with_mask(b.row_mask & torch.from_numpy(np.pad(mask, (0, b.capacity - len(mask)))))


def _aggregate(pkg, batch, keys, mode, max_groups, key_ranges=None, aggs=None):
    M, B, E, P, AGG, Ctx = PKG[pkg]
    node = P.bind_plan(P.HashAggregate(P.Scan("t", batch.schema), tuple(E.col(k) for k in keys),
                                       aggs or _aggs(E), mode))
    ctx = Ctx(overflow_flags=[])
    if pkg == "jax":
        out = AGG.hash_aggregate(batch, node.group_exprs, node.agg_exprs, mode, max_groups,
                                 node.schema, ctx, key_ranges=key_ranges)
    else:
        out = AGG.hash_aggregate(batch, node.group_exprs, node.agg_exprs, mode, node.schema, ctx,
                                 max_groups=max_groups, key_ranges=key_ranges)
    return out, node.agg_exprs


def _assert_same(jout, pout, null_values=True):
    """Equal live rows (values, validity, dtypes), and per column equal
    storage (narrow 1-D or two-limb) and magnitude bound. ``null_values``:
    compare the values under nulls too (an ungrouped aggregate's have none
    to agree on: its output holds 1 row in the port, 8 in the JAX package,
    and a null result takes the last row's value)."""
    jn, pn = JB.to_numpy(jout), PB.to_numpy(pout)
    assert list(jn) == list(pn)
    for k in jn:
        assert jn[k].dtype == pn[k].dtype, k
        j, p = jn[k], pn[k]
        if not null_values and not k.endswith("__valid"):
            j, p = j[jn[k + "__valid"]], p[jn[k + "__valid"]]
        np.testing.assert_array_equal(j, p, err_msg=k)
    for jc, pc, f in zip(jout.columns, pout.columns, pout.schema.fields):
        assert np.asarray(jc.data).ndim == pc.data.dim(), f.name
        assert jc.mag_bound == pc.mag_bound, f.name


# (keys, statistics range of a): the dense path, the sorted path packed by
# the range and on the generic limbs, ungrouped
PATHS = {"dense": (("k",), None), "sorted_ranged": (("a",), ((0, 299),)),
         "sorted": (("a",), None), "ungrouped": ((), None)}


@pytest.mark.parametrize("path", sorted(PATHS))
@pytest.mark.parametrize("seed", [0, 1])
def test_single_mode_matches_jax(path, seed):
    keys, ranges = PATHS[path]
    data, validity, mask = _table(3000, 300, seed)
    outs = {pkg: _aggregate(pkg, _batch(pkg, data, validity, mask), keys, "single", 1 << 10,
                            ranges)[0] for pkg in PKG}
    _assert_same(outs["jax"], outs["port"])
    pn = PB.to_numpy(outs["port"])
    if keys:  # the all-null group: every MIN/MAX null, its rows counted
        g = np.flatnonzero(pn[keys[0]] == ("q" if keys == ("k",) else 3))
        assert len(g) == 1 and pn["n"][g[0]] > 0
        assert not any(pn[f"{f}_{c}__valid"][g[0]] for c in VALUES for f in ("min", "max"))
    # the two-limb column really is two-limb, the wide-typed small one narrow
    port = outs["port"]
    assert port.column("max_w").data.dim() == 2 and port.column("max_ws").data.dim() == 1


@pytest.mark.parametrize("path", sorted(PATHS))
def test_partial_then_final_and_partial_merge_match_jax(path):
    """PARTIAL states equal, then FINAL and PARTIAL_MERGE over each
    package's own states, a fifth of them dead, equal."""
    keys, ranges = PATHS[path]
    data, validity, mask = _table(4000, 300, seed=2)
    partial, aggs = {}, {}
    for pkg in PKG:
        partial[pkg], aggs[pkg] = _aggregate(pkg, _batch(pkg, data, validity, mask), keys,
                                             "partial", 1 << 10, ranges)
    _assert_same(partial["jax"], partial["port"])
    cap = min(partial["jax"].capacity, partial["port"].capacity)
    keep = np.random.default_rng(3).random(cap) > 0.2
    states = {}
    for pkg, b in partial.items():
        m = np.pad(keep, (0, b.capacity - cap))  # the ungrouped port state has capacity 1
        states[pkg] = b.with_mask(b.row_mask & (m if pkg == "jax" else torch.from_numpy(m)))
    for mode in ("final", "partial_merge"):
        outs = {pkg: _aggregate(pkg, states[pkg], keys, mode, 1 << 10, ranges, aggs[pkg])[0]
                for pkg in PKG}
        _assert_same(outs["jax"], outs["port"], null_values=bool(keys))


@pytest.mark.parametrize("path", ["dense", "sorted", "ungrouped"])
def test_ties_and_two_limb_order(path):
    """Exact per-group MIN/MAX against Python ints: the high limb decides
    first, the low limb (unsigned) among the rows that tie on it, and
    equal values tie (any of them is the answer); int64 extremes too."""
    keys, ranges = PATHS[path]
    data, validity, mask = _table(2000, 40, seed=4)
    data["l"][:3] = [-2**63, 2**63 - 1, 0]
    out = PB.to_numpy(_aggregate("port", _batch("port", data, validity, mask), keys, "single",
                                 1 << 10, ranges)[0])
    live = mask.copy()
    gkey = data[keys[0]] if keys else np.zeros(len(mask), np.int64)
    for gi in range(len(out["n"])):
        rows = live & (gkey == (out[keys[0]][gi] if keys else 0))
        for c in VALUES:
            vals = [int(x) for x in data[c][rows & validity[c]]]
            for f, fn in (("min", min), ("max", max)):
                if vals:
                    assert int(out[f"{f}_{c}"][gi]) == fn(vals), (f, c, gi)
                else:
                    assert not out[f"{f}_{c}__valid"][gi]


def test_ungrouped_over_no_rows_is_one_null_row():
    data, validity, mask = _table(100, 10, seed=5)
    pout, _ = _aggregate("port", _batch("port", data, validity, np.zeros(100, bool)), (),
                         "single", 8)
    pn = PB.to_numpy(pout)
    assert pn["n"].tolist() == [0]
    assert not any(pn[f"{f}_{c}__valid"][0] for c in VALUES for f in ("min", "max"))


def test_floats_strings_and_bools_still_raise():
    """(Named when MIN/MAX of strings and bools raised.) MIN and MAX of
    floats, strings and bools give the value, each held to the JAX package
    in test_torch_floats.py and test_torch_scalar_aggs.py; here to Python."""
    schema = PT.Schema([PT.Field("f", PT.FLOAT64), PT.Field("s", PT.string(2)),
                        PT.Field("b", PT.BOOL)])
    b = PB.from_numpy({"f": np.arange(4.0), "s": np.array(["a", "b", "a", "c"], object),
                       "b": np.array([True, False] * 2)}, schema, "cpu")
    for c, func, want in (("f", "max", 3.0), ("s", "max", "c"), ("s", "min", "a"),
                          ("b", "max", True), ("b", "min", False)):
        node = PP.bind_plan(PP.HashAggregate(PP.Scan("t", schema), (),
                                             (PE.AggExpr(func, PE.col(c), "m"),)))
        out = PAGG.hash_aggregate(b, node.group_exprs, node.agg_exprs, "single", node.schema)
        assert PB.to_numpy(out)["m"].tolist() == [want], (c, func)


def test_lane_reduction_with_many_groups_and_one_heavy_group():
    """_minmax_reduce at a group count that leaves one lane a group, and
    with one group holding most rows, against a per-group Python min."""
    rng = np.random.default_rng(6)
    n = 50_000
    for m in (8, 1 << 20):
        seg = np.where(rng.random(n) < 0.7, 1, rng.integers(0, m + 1, n))
        x = rng.integers(-2**63, 2**63 - 1, n, dtype=np.int64)
        got = PAGG._minmax_reduce(torch.from_numpy(x), torch.from_numpy(seg), m, True).numpy()
        want = np.full(m + 1, np.iinfo(np.int64).max)
        np.minimum.at(want, seg, x)
        np.testing.assert_array_equal(got, want[:m])


# ---- TPC-H Q15 through the Session ----------------------------------------------------

Q15_TABLES = ("lineitem", "supplier")


def _sessions(data):
    js, ps = JaxSession(), Session(device="cpu")
    for t, d in data.items():
        js.register_numpy(t, d, JTPCH.SCHEMAS[t])
        ps.register_numpy(t, d, tpch.SCHEMAS[t])
    return js, ps


def _assert_rows(want, got):
    assert list(want) == list(got)
    for k in want:
        assert want[k].dtype == got[k].dtype, k
        np.testing.assert_array_equal(want[k], got[k], err_msg=k)


def _oracle(data):
    return chip_smoke.oracle_q15(data["lineitem"], data["supplier"], tpch._d("1996-01-01"),
                                 tpch._d("1996-04-01"))


def _key_storage(sess, q):
    """(revenue's storage, the MAX's storage): ndim of the semi join's two
    key columns, each side run as a query of its own."""
    top = q.child.child.right
    return tuple(sess.execute(side).columns[-1].data.ndim for side in (top.left, top.right))


@pytest.fixture(scope="module")
def q15_data():
    return {t: tpch.generate_table(t, 0.01) for t in Q15_TABLES}


def test_q15_matches_jax_and_oracle(q15_data):
    js, ps = _sessions(q15_data)
    got = ps.collect(tpch.q15())
    _assert_rows(js.collect(JTPCH.q15()), got)
    chip_smoke.check_q15(got, _oracle(q15_data), "port")
    # the stages: the join tree (the revenue subtree twice), then the sort
    assert [(n is None, type(p).__name__) for n, p in ps.stages] == [
        (False, "HashJoin"), (True, "Projection")]
    assert [(n is None, type(p).__name__) for n, p in js._plan_stages(JTPCH.q15())] == [
        (False, "HashJoin"), (True, "Projection")]
    assert PJ.hash_join.semi_paths["sorted"] > 0  # decimal keys: no bitmap


def test_q15_semi_join_keys_share_their_storage(q15_data):
    """Revenue and its MAX are two-limb in both packages (the sorted path's
    sum has no bound): the semi join compares like with like."""
    js, ps = _sessions(q15_data)
    assert _key_storage(ps, tpch.q15()) == _key_storage(js, JTPCH.q15()) == (2, 2)


def test_q15_two_suppliers_tie_for_the_maximum():
    """A hand-made lineitem: suppliers 3 and 6 reach the same largest
    revenue (supplier 2's larger lines ship outside the quarter): both
    rows come back, by key, as in the JAX package."""
    li = tpch.generate_table("lineitem", 0.0001)
    n = 40
    li = {k: v[:n].copy() for k, v in li.items()}
    li["l_suppkey"] = np.arange(n, dtype=np.int64) % 8 + 1
    li["l_shipdate"] = np.full(n, tpch._d("1996-02-01"), np.int32)
    li["l_extendedprice"] = np.full(n, 100_000, np.int64)
    li["l_discount"] = np.where(np.arange(n) % 8 == 0, 5, 0).astype(np.int64)
    li["l_extendedprice"][[2, 5]] = 900_000  # suppliers 3 and 6, one line each
    li["l_extendedprice"][1] = 5_000_000  # supplier 2, shipped outside the quarter
    li["l_shipdate"][1] = tpch._d("1995-12-31")
    data = {"lineitem": li, "supplier": tpch.generate_table("supplier", 0.001)}
    js, ps = _sessions(data)
    got = ps.collect(tpch.q15())
    _assert_rows(js.collect(JTPCH.q15()), got)
    want = _oracle(data)
    assert [r[0] for r in want] == [3, 6]
    chip_smoke.check_q15(got, want, "port")


def _narrow_top(M, P, E):
    """Q15's shape over a dictionary key: the sum on the dense path keeps
    its bound, so revenue and its MAX are narrow decimal(22,2) columns."""
    t = P.Scan("t", _schema(M))
    rev = t.aggregate([E.col("k")], [E.AggExpr("sum", E.col("v"), "rev")])
    top = rev.aggregate([], [E.AggExpr("max", E.col("rev"), "top")])
    return P.HashJoin(rev, top, (E.col("rev"),), (E.col("top"),), "left_semi", "right")


def test_semi_join_on_a_narrow_max_matches_jax():
    data, validity, mask = _table(500, 10, seed=7)
    validity = {c: np.ones(500, bool) for c in VALUES}
    js, ps = JaxSession(), Session(device="cpu")
    js.register_numpy("t", data, _schema(JT), validity=validity)
    ps.register_numpy("t", data, _schema(PT), validity=validity)
    q = {"jax": _narrow_top(JT, JP, JE), "port": _narrow_top(PT, PP, PE)}
    storage = {pkg: tuple(s.execute(side).columns[-1].data.ndim for side in (q[pkg].left,
                                                                             q[pkg].right))
               for pkg, s in (("jax", js), ("port", ps))}
    assert storage["port"] == storage["jax"] == (1, 1)
    got = ps.collect(q["port"])
    _assert_rows(js.collect(q["jax"]), got)
    assert len(got["k"]) == 1

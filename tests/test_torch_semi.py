"""PyTorch port, the semi-like joins (LEFT_SEMI, LEFT_ANTI, EXISTENCE) exactly
against the JAX package, on the same seeded input:

- ``hash_join`` on both membership paths (the bitmap over an exact build-key
  range, and the sorted build), with null keys, dead rows on both sides,
  build keys repeated past the fan-out K, two-key joins and dictionary keys
  from different dictionaries: the probe's row mask, columns and the
  ``exists`` column equal the JAX package's;
- TPC-H Q4 through the ``Session`` at SF 0.01, with statistics (the bitmap)
  and without the build side's (the sorted path): values, order, the
  planner's ``build_key_range``, ``out_rows_hint`` and ``max_groups`` equal
  the JAX Session's, and the numpy oracle chip_smoke.py checks the card
  with; under the grace join both packages pick K = 16, partial mode and
  the same partition sizes;
- a LEFT_ANTI query (customers with no order, by market segment), an
  EXISTENCE query, and a LEFT_SEMI whose output the engine compacts (the
  >= 8x rule) against the JAX Session and numpy."""

import warnings

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from datafusion_comet_tpu import types as JT
from datafusion_comet_tpu.exec import batch as JB
from datafusion_comet_tpu.exec.engine import Session as JaxSession
from datafusion_comet_tpu.exec.operators import join as JJ
from datafusion_comet_tpu.ir import expr as JE
from datafusion_comet_tpu.ir import plan as JP
from datafusion_comet_tpu.models import tpch as JTPCH
from datafusion_comet_tpu_torch import types as PT
from datafusion_comet_tpu_torch.conf import Config
from datafusion_comet_tpu_torch.exec import batch as PB
from datafusion_comet_tpu_torch.exec import kernels as K
from datafusion_comet_tpu_torch.exec.engine import Session
from datafusion_comet_tpu_torch.exec.operators import join as PJ
from datafusion_comet_tpu_torch.ir import expr as PE
from datafusion_comet_tpu_torch.ir import plan as PP
from datafusion_comet_tpu_torch.models import tpch
from test_torch_grace import jax_fraction, jax_spy  # noqa: F401 (jax_spy: a fixture)
from _torch_threads import one_torch_thread  # noqa: F401 (a fixture)

pytestmark = pytest.mark.usefixtures("one_torch_thread")

SF = 0.01
PKG = {"jax": (JT, JB, JE, JP, JJ), "port": (PT, PB, PE, PP, PJ)}
SEMI = ["left_semi", "left_anti", "existence"]


# ---- hash_join -----------------------------------------------------------------------


def _tables(seed: int, dup: int):
    """A probe table (fact: 700 rows) and a build table (dim: 50 distinct
    keys, each ``dup`` times) with int64, int32, date and dictionary-string
    keys; 5% null keys and 10% dead rows on each side. Probe keys run past
    the build keys' range on both ends."""
    rng = np.random.default_rng(seed)
    nf = 700
    fact = {"fk": rng.integers(-20, 220, nf).astype(np.int64),
            "fk2": rng.integers(0, 3, nf).astype(np.int32),
            "fd": (9000 + rng.integers(-5, 45, nf)).astype(np.int32),
            "x": np.arange(nf, dtype=np.int64),
            "s": np.array(["a", "bb", "c", "dd", "e"], object)[rng.integers(0, 5, nf)]}
    keys = rng.permutation(200)[:50]
    pk = np.repeat(keys, dup).astype(np.int64)
    n = len(pk)
    dim = {"pk": pk, "pk2": rng.integers(0, 3, n).astype(np.int32),
           "dd": (9000 + pk % 40).astype(np.int32),
           "t": np.array(["bb", "dd", "zz"], object)[rng.integers(0, 3, n)]}
    fvalid = {c: rng.random(nf) > 0.05 for c in ("fk", "fd", "s")}
    dvalid = {c: rng.random(n) > 0.05 for c in ("pk", "dd", "t")}
    masks = (rng.random(nf) > 0.1, rng.random(n) > 0.1)
    return fact, dim, fvalid, dvalid, masks


def _schemas(M):
    return (M.Schema([M.Field("fk", M.INT64), M.Field("fk2", M.INT32), M.Field("fd", M.DATE),
                      M.Field("x", M.INT64), M.Field("s", M.string(2))]),
            M.Schema([M.Field("pk", M.INT64), M.Field("pk2", M.INT32), M.Field("dd", M.DATE),
                      M.Field("t", M.string(2))]))


def _batch(pkg, data, schema, validity, mask):
    B = PKG[pkg][1]
    if pkg == "jax":
        b = B.from_numpy(data, schema, validity=validity)
        return b.with_mask(b.row_mask & jnp.asarray(np.pad(mask, (0, b.capacity - len(mask)))))
    b = B.from_numpy(data, schema, "cpu", validity=validity)
    return b.with_mask(b.row_mask & torch.from_numpy(np.pad(mask, (0, b.capacity - len(mask)))))


# (probe keys, build keys): the membership paths each key set can take
_KEYS = {
    "int64": (("fk",), ("pk",)),
    "date": (("fd",), ("dd",)),
    "two_keys": (("fk", "fk2"), ("pk", "pk2")),
    "dict_strings": (("s",), ("t",)),  # two tables' dictionaries: ranks of their union
}
_CASES = [("int64", "bitmap"), ("int64", "sorted"), ("date", "bitmap"), ("date", "sorted"),
          ("two_keys", "sorted"), ("dict_strings", "sorted")]


def _join(pkg, join_type, keys, rng, seed=7, dup=3):
    fact, dim, fvalid, dvalid, (fmask, dmask) = _tables(seed, dup)
    M, B, E, P, J = PKG[pkg]
    fs, ds = _schemas(M)
    left, right = _batch(pkg, fact, fs, fvalid, fmask), _batch(pkg, dim, ds, dvalid, dmask)
    lk, rk = _KEYS[keys]
    plan = P.bind_plan(P.HashJoin(P.Scan("fact", fs), P.Scan("dim", ds),
                                  tuple(E.col(c) for c in lk), tuple(E.col(c) for c in rk),
                                  join_type, "right"))
    out, ovf = J.hash_join(left, right, plan.left_keys, plan.right_keys, join_type, "right",
                           plan.schema, max_build_matches=4, build_key_range=rng)
    return out, bool(ovf)


@pytest.mark.parametrize("keys,path", _CASES, ids=[f"{k}-{p}" for k, p in _CASES])
@pytest.mark.parametrize("join_type", SEMI)
@pytest.mark.parametrize("dup", [1, 6])
def test_semi_like_join_matches_jax(join_type, keys, path, dup):
    """The probe's mask and columns (and ``exists``) exactly as the JAX
    package's; a build key repeated 6 times (past K = 4) is one match."""
    rng = None
    if path == "bitmap":
        col = _tables(7, dup)[1][_KEYS[keys][1][0]]
        rng = (int(col.min()), int(col.max()))
    before = dict(PJ.hash_join.semi_paths)
    jout, _ = _join("jax", join_type, keys, rng, dup=dup)
    pout, povf = _join("port", join_type, keys, rng, dup=dup)
    assert PJ.hash_join.semi_paths[path] == before[path] + 1
    assert not povf  # a semi-like join never overflows in the port
    assert jout.capacity == pout.capacity
    np.testing.assert_array_equal(np.asarray(jout.row_mask), pout.row_mask.numpy())
    jn, pn = JB.to_numpy(jout), PB.to_numpy(pout)
    assert list(jn) == list(pn)
    for k in jn:
        np.testing.assert_array_equal(jn[k], pn[k], err_msg=k)
    # neither side of the split is empty
    probe_live = int(_tables(7, dup)[4][0].sum())
    if join_type == "existence":
        exists = pout.column("exists")
        assert exists.validity.all() and 0 < int(exists.data[pout.row_mask].sum()) < probe_live
    else:
        assert 0 < int(pout.num_rows()) < probe_live


def test_bitmap_range_wider_than_the_keys_and_null_probe_keys():
    """A build-key range wider than the build's values (as statistics over
    rows later filtered away give) leaves every answer as it was, and a
    probe row with a null key passes LEFT_ANTI and fails LEFT_SEMI."""
    outs = {}
    for rng in ((-1000, 5000), None):
        for jt in ("left_semi", "left_anti"):
            outs[rng, jt] = _join("port", jt, "int64", rng)[0]
    for jt in ("left_semi", "left_anti"):
        np.testing.assert_array_equal(outs[(-1000, 5000), jt].row_mask.numpy(),
                                      outs[None, jt].row_mask.numpy())
    semi, anti = outs[None, "left_semi"], outs[None, "left_anti"]
    fk = semi.column("fk")
    null_live = (~fk.validity) & (semi.row_mask | anti.row_mask)
    assert int(null_live.sum()) > 0
    assert not (semi.row_mask & ~fk.validity).any()
    assert bool(anti.row_mask[null_live].all())


def test_semi_like_refusals():
    """A left build side raises, for the null-aware anti join too; a
    condition no longer does (test_torch_semi_cond.py holds those joins to
    JAX), nor does the null-aware anti join itself
    (test_torch_null_aware.py)."""
    fact, dim, fvalid, dvalid, (fmask, dmask) = _tables(3, 2)
    fs, ds = _schemas(PT)
    left, right = _batch("port", fact, fs, fvalid, fmask), _batch("port", dim, ds, dvalid, dmask)
    lk, rk = [PE.bind(PE.col("fk"), fs)], [PE.bind(PE.col("pk"), ds)]
    cond = PE.bind(PE.col("fk2") < PE.col("pk2"),
                   PT.Schema(list(fs.fields) + list(ds.fields)))
    before = PJ.hash_join.semi_paths["minmax_sorted"]
    out, ovf = PJ.hash_join(left, right, lk, rk, "left_semi", "right", fs, cond)
    assert out.capacity == left.capacity and not bool(ovf)
    assert PJ.hash_join.semi_paths["minmax_sorted"] == before + 1
    with pytest.raises(AssertionError):
        PJ.hash_join(left, right, lk, rk, "left_anti", "left", fs)
    with pytest.raises(AssertionError):
        PJ.hash_join(left, right, lk, rk, "left_anti_null_aware", "left", fs)


@pytest.mark.parametrize("join_type", ["left_semi", "inner", "left"])
def test_decimal_keys_of_different_storage_match(join_type):
    """A narrow-stored decimal(30,2) key against a two-limb one: the port
    lifts the narrow side to two limbs and finds the numpy oracle's rows.
    The JAX package compares the storages as they are and finds no match
    (ROADMAP C5, a reference-side fault): its answer stays empty (no key
    matched)."""
    sa = PT.Schema([PT.Field("a", PT.decimal(30, 2)), PT.Field("x", PT.INT64)])
    sb = PT.Schema([PT.Field("b", PT.decimal(30, 2))])
    a, x, b = [1, 5, 7], [0, 1, 2], [5, 10**25, 7]
    ps = Session(device="cpu")
    ps.register_numpy("ta", {"a": np.array(a, object), "x": np.array(x, np.int64)}, sa)
    ps.register_numpy("tb", {"b": np.array(b, object)}, sb)
    assert ps.tables["ta"].column("a").data.dim() == 1
    assert ps.tables["tb"].column("b").data.dim() == 2
    q = PP.HashJoin(PP.Scan("ta", sa), PP.Scan("tb", sb), (PE.col("a"),), (PE.col("b"),),
                    join_type, "right")
    got = ps.collect(q)
    # the numpy oracle: (a, x, b) per matching pair, each unmatched row of a
    # LEFT join with b null; a semi join's (a, x)
    want = []
    for av, xv in zip(a, x):
        hits = [bv for bv in b if bv == av] or ([None] if join_type == "left" else [])
        want += [(av, xv, bv) for bv in hits]
    if join_type == "left_semi":
        assert sorted(zip(got["a"], got["x"])) == sorted({(w[0], w[1]) for w in want})
    else:
        bs = [v if ok else None for v, ok in zip(got["b"], got["b__valid"])]
        assert sorted(zip(got["a"], got["x"], bs), key=str) == sorted(want, key=str)
    js = JaxSession()
    ja = JT.Schema([JT.Field("a", JT.decimal(30, 2)), JT.Field("x", JT.INT64)])
    jb = JT.Schema([JT.Field("b", JT.decimal(30, 2))])
    js.register_numpy("ta", {"a": np.array(a, object), "x": np.array(x, np.int64)}, ja)
    js.register_numpy("tb", {"b": np.array(b, object)}, jb)
    jq = JP.HashJoin(JP.Scan("ta", ja), JP.Scan("tb", jb), (JE.col("a"),), (JE.col("b"),),
                     join_type, "right")
    jout = js.collect(jq)
    matched = jout["b__valid"] if "b__valid" in jout else np.ones(len(jout["a"]), bool)
    assert not matched.any() if join_type == "left" else len(jout["a"]) == 0


# ---- TPC-H Q4 through the Session -----------------------------------------------------


@pytest.fixture(scope="module")
def q4_data():
    return {t: tpch.generate_table(t, SF) for t in ("lineitem", "orders", "customer")}


def _sessions(data, tables, drop_stats=()):
    js, ps = JaxSession(), Session(device="cpu")
    for t in tables:
        js.register_numpy(t, data[t], JTPCH.SCHEMAS[t])
        ps.register_numpy(t, data[t], tpch.SCHEMAS[t])
    for t in drop_stats:
        del js.stats[t], ps.stats[t]
    return js, ps


def _assert_same(want, got):
    assert list(want) == list(got)
    for k in want:
        assert want[k].dtype == got[k].dtype, k
        np.testing.assert_array_equal(want[k], got[k], err_msg=k)


def _nodes(plan, cls):
    out = [plan] if isinstance(plan, cls) else []
    for c in plan.children():
        out += _nodes(c, cls)
    return out


def _hints(stages, P):
    """(join type, build_key_range, out_rows_hint) of every join and the
    max_groups of every aggregate, over a stage list."""
    joins, aggs = [], []
    for _, sub in stages:
        joins += [(j.join_type, getattr(j, "build_key_range", None),
                   getattr(j, "out_rows_hint", None)) for j in _nodes(sub, P.HashJoin)]
        aggs += [a.max_groups for a in _nodes(sub, P.HashAggregate)]
    return joins, aggs


@pytest.mark.parametrize("path", ["bitmap", "sorted"])
def test_q4_matches_jax_and_oracle(q4_data, path):
    """With statistics the build key's exact range (1 .. 4 x orders) takes
    the bitmap; without the lineitem's statistics the sorted path. Values,
    order, hints and group capacity as the JAX Session's, and the numpy
    oracle."""
    js, ps = _sessions(q4_data, ("lineitem", "orders"),
                       drop_stats=("lineitem",) if path == "sorted" else ())
    before = dict(PJ.hash_join.semi_paths)
    got = ps.collect(tpch.q4())
    assert PJ.hash_join.semi_paths[path] == before[path] + 1
    want = js.collect(JTPCH.q4())
    _assert_same(want, got)
    oracle = chip_smoke.oracle_q4(q4_data["lineitem"], q4_data["orders"],
                                  tpch._d("1993-07-01"), tpch._d("1993-10-01"))
    chip_smoke.check_q4(got, oracle, "port")
    assert len(oracle) == 5
    jh = _hints(js._plan_stages(JTPCH.q4()), JP)
    ph = _hints(ps.stages, PP)
    assert ph == jh
    ((jt, rng, est),) = ph[0]
    assert jt == "left_semi" and (rng is None) == (path == "sorted") and est > 0


def test_q4_semi_join_output_is_not_compacted_below_8x(q4_data):
    """Q4's estimate (orders' filtered rows) is within 8x of the orders
    capacity: the semi output keeps its capacity, and no B3 call runs."""
    _, ps = _sessions(q4_data, ("lineitem", "orders"))
    K.partition_columns.log = []
    try:
        ps.collect(tpch.q4())
        assert K.partition_columns.log == []
    finally:
        K.partition_columns.log = None


def test_q4_grace_matches_jax(q4_data, jax_spy):
    """Under the budget that picks K = 16 both packages partition both
    sides alike and run Q4's COUNT(*) as PARTIAL aggregates in the pairs and
    one FINAL (partial mode: o_orderpriority is not the join key)."""
    js, direct = _sessions(q4_data, ("lineitem", "orders"))
    fraction, _ = chip_smoke.grace_fraction(direct, tpch.q4(), 16)
    grace = Session(device="cpu", conf=Config(memory_fraction=fraction))
    for t in ("lineitem", "orders"):
        grace.register_numpy(t, q4_data[t], tpch.SCHEMAS[t])
    before = dict(PJ.hash_join.semi_paths)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        got = grace.collect(tpch.q4())
    (runner,) = grace.grace_runners
    assert (runner.K, runner.downstream[0]) == (16, "partial")
    # every pair ran the bitmap (the join's build-key range, carried over)
    assert PJ.hash_join.semi_paths["sorted"] == before["sorted"]
    assert PJ.hash_join.semi_paths["bitmap"] - before["bitmap"] >= 16
    mini = _nodes(runner.template, PP.HashJoin)[0]
    assert mini.build_key_range is not None and mini.out_rows_hint >= 2048
    want = js.collect(JTPCH.q4())
    with jax_fraction(fraction):
        got_jax = js.collect(JTPCH.q4())
    assert jax_spy == [(16, "partial")]
    for got_sizes, want_sizes in zip(runner.sizes, jax_spy.sizes[0]):
        np.testing.assert_array_equal(got_sizes, want_sizes)
    for g in (got, got_jax, direct.collect(tpch.q4())):
        _assert_same(want, g)


# ---- anti, existence and the semi-output compaction through the Session ------------


def _customer_orders(M, P, E, join_type):
    c = P.Scan("customer", (JTPCH if M is JT else tpch).SCHEMAS["customer"])
    o = P.Scan("orders", (JTPCH if M is JT else tpch).SCHEMAS["orders"])
    j = P.HashJoin(c, o, (E.col("c_custkey"),), (E.col("o_custkey"),), join_type, "right")
    keys = [E.col("c_mktsegment")] + ([E.col("exists")] if join_type == "existence" else [])
    return j.aggregate(keys, [E.AggExpr("count", None, "n")]).sort(
        [E.SortOrder(k) for k in keys])


@pytest.mark.parametrize("path", ["bitmap", "sorted"])
@pytest.mark.parametrize("join_type", ["left_anti", "existence", "left_semi"])
def test_customers_against_orders_match_jax(q4_data, join_type, path):
    """Customers with no order (a third of them: the generator never gives
    orders to keys divisible by 3), with one, or each flagged, per market
    segment: port and JAX Session equal, and equal to numpy."""
    js, ps = _sessions(q4_data, ("customer", "orders"),
                       drop_stats=("orders",) if path == "sorted" else ())
    before = dict(PJ.hash_join.semi_paths)
    got = ps.collect(_customer_orders(PT, PP, PE, join_type))
    assert PJ.hash_join.semi_paths[path] == before[path] + 1
    _assert_same(js.collect(_customer_orders(JT, JP, JE, join_type)), got)
    cu = q4_data["customer"]
    has = np.isin(cu["c_custkey"], q4_data["orders"]["o_custkey"])
    assert 0.2 < 1 - has.mean() < 0.45
    seg = cu["c_mktsegment"]
    if join_type == "existence":
        want = sorted((s, e, int(((seg == s) & (has == e)).sum()))
                      for s in set(seg) for e in (False, True) if ((seg == s) & (has == e)).any())
        assert [(s, bool(e), int(n)) for s, e, n in zip(got["c_mktsegment"], got["exists"],
                                                        got["n"])] == want
    else:
        keep = ~has if join_type == "left_anti" else has
        want = [(s, int((keep & (seg == s)).sum())) for s in sorted(set(seg[keep]))]
        assert list(zip(got["c_mktsegment"], got["n"].tolist())) == want


def _compacted_semi(M, P, E, day):
    """lineitem LEFT_SEMI the orders of one day, by return flag: the
    estimate (lineitem x the day's orders over the orders' keys) is far
    below the lineitem's capacity, so the engine compacts the output."""
    schemas = (JTPCH if M is JT else tpch).SCHEMAS
    o = P.Scan("orders", schemas["orders"]).filter(
        E.col("o_orderdate") == E.lit(day, M.DATE))
    j = P.HashJoin(P.Scan("lineitem", schemas["lineitem"]), o, (E.col("l_orderkey"),),
                   (E.col("o_orderkey"),), "left_semi", "right")
    return j.aggregate([E.col("l_returnflag")], [E.AggExpr("count", None, "n")]).sort(
        [E.SortOrder(E.col("l_returnflag"))])


def test_semi_output_compaction_matches_jax(q4_data):
    """The 8x rule fires twice: one B3 call compacts the one day's orders
    (the filter's estimate) to 1024 rows, one the semi output (4 x the
    estimate, at least 1024); the answer equals the JAX Session's and
    numpy's, and the join's hints equal the JAX package's."""
    day = int(np.bincount(q4_data["orders"]["o_orderdate"]).argmax())
    js, ps = _sessions(q4_data, ("lineitem", "orders"))
    K.partition_columns.log = []
    try:
        got = ps.collect(_compacted_semi(PT, PP, PE, day))
        log = K.partition_columns.log
    finally:
        K.partition_columns.log = None
    assert [(c["K"], c["limit"]) for c in log] == [(1, 1024), (1, 1024)]
    assert [c["n"] for c in log] == [ps.tables["orders"].capacity,
                                     ps.tables["lineitem"].capacity]
    _assert_same(js.collect(_compacted_semi(JT, JP, JE, day)), got)
    assert _hints(ps.stages, PP) == _hints(js._plan_stages(_compacted_semi(JT, JP, JE, day)), JP)
    li, od = q4_data["lineitem"], q4_data["orders"]
    keep = np.isin(li["l_orderkey"], od["o_orderkey"][od["o_orderdate"] == day])
    rf = li["l_returnflag"][keep]
    assert list(zip(got["l_returnflag"], got["n"].tolist())) == [
        (f, int((rf == f).sum())) for f in sorted(set(rf))]

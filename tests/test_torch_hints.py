"""PyTorch port, the planner's join and filter hints (exec/stats.py) and the
INNER join paths they select (exec/operators/join.py), exactly against the
JAX package on the same seeded inputs:

- the hints of every join and filter, and every aggregate's capacity,
  stage by stage, for TPC-H Q1, Q3, Q4, Q5, Q6, Q12 and Q15 at SF 0.01 (no
  runtime filter is injected at that size: the JAX injector skips fact
  sides under 65,536 rows), and the retry attempts of each query's run
  with their growth scale and ``unique_join_ok`` (Q12 runs twice: its
  filtered lineitem is hinted unique and is not);
- ``hash_join`` on each INNER path against the JAX ``hash_join`` with the
  same hints: the unique build (dense, and sorted over a key span past
  2^24 or two keys), the duplicate-key flag, key packing and its
  out-of-range flag, the compacted pair list (equal in values and order to
  the pair block, with no (probe x K) block allocated) and its overflow;
- each path through the ``Session``, with a wrong hint set on the bound
  plan where one is needed to reach it (a hint set already wins over the
  statistics), and a filter whose estimate is too small for its shrink:
  results and retry attempts equal the JAX Session's."""

import dataclasses

import numpy as np
import pytest

from datafusion_comet_tpu import types as JT
from datafusion_comet_tpu.exec import batch as JB
from datafusion_comet_tpu.exec.engine import Session as JaxSession
from datafusion_comet_tpu.exec.operators import join as JJ
from datafusion_comet_tpu.ir import expr as JE
from datafusion_comet_tpu.ir import plan as JP
from datafusion_comet_tpu.ir import pruning as JPRUNE
from datafusion_comet_tpu.models import tpch as JTPCH
from datafusion_comet_tpu_torch import types as PT
from datafusion_comet_tpu_torch.exec import batch as PB
from datafusion_comet_tpu_torch.exec.engine import Session
from datafusion_comet_tpu_torch.exec.evaluator import EvalContext
from datafusion_comet_tpu_torch.exec.operators import join as PJ
from datafusion_comet_tpu_torch.ir import expr as PE
from datafusion_comet_tpu_torch.ir import plan as PP
from datafusion_comet_tpu_torch.ir import pruning as PPRUNE
from datafusion_comet_tpu_torch.models import tpch
from test_torch_join import _stage
from _torch_threads import one_torch_thread  # noqa: F401 (a fixture)

pytestmark = pytest.mark.usefixtures("one_torch_thread")

SF = 0.01
NAMES = ("lineitem", "orders", "customer", "supplier", "nation", "region")
QUERIES = ("q1", "q3", "q4", "q5", "q6", "q12", "q15")


# ---- the planner's hints and the retry attempts, per TPC-H query ----------------------


@pytest.fixture(scope="module")
def sessions():
    data = tpch.generate_tables(NAMES, SF)
    js, ps = JaxSession(), Session(device="cpu")
    for t in NAMES:
        js.register_numpy(t, data[t], JTPCH.SCHEMAS[t])
        ps.register_numpy(t, data[t], tpch.SCHEMAS[t])
    return js, ps


@pytest.fixture
def jax_attempts(monkeypatch):
    """(growth scale, unique_join_ok) of every plan the JAX Session
    compiles: one a run attempt of a stage."""
    seen = []
    orig = JaxSession.compile

    def spy(self, plan, join_fanout=None, agg_scale=1, unique_join_ok=True):
        seen.append((agg_scale, unique_join_ok))
        return orig(self, plan, join_fanout=join_fanout, agg_scale=agg_scale,
                    unique_join_ok=unique_join_ok)

    monkeypatch.setattr(JaxSession, "compile", spy)
    return seen


def _nodes(plan, cls):
    out = [plan] if isinstance(plan, cls) else []
    for c in plan.children():
        out += _nodes(c, cls)
    return out


def stage_hints(stages, P):
    """Per stage (the last one or not; each join's type, build side,
    fan-out, unique build, key packing, build-key range and row estimate;
    each filter's row estimate; each aggregate's capacity)."""
    return [(name is None,
             [(j.join_type, j.build_side, getattr(j, "fanout_hint", None),
               getattr(j, "unique_build_hint", None), getattr(j, "key_pack", None),
               getattr(j, "build_key_range", None), getattr(j, "out_rows_hint", None))
              for j in _nodes(sub, P.HashJoin)],
             [getattr(f, "out_rows_hint", None) for f in _nodes(sub, P.Filter)],
             [a.max_groups for a in _nodes(sub, P.HashAggregate)])
            for name, sub in stages]


def _no_runtime_filters(stages):
    for _, sub in stages:
        for j in _nodes(sub, JP.HashJoin):
            assert not getattr(j, "rf_injected", None)


@pytest.mark.parametrize("q", QUERIES)
def test_hints_match_jax_stage_by_stage(sessions, q):
    js, ps = sessions
    want = js._plan_stages(getattr(JTPCH, q)())
    _no_runtime_filters(want)
    got = ps._plan_stages(getattr(tpch, q)())
    assert stage_hints(got, PP) == stage_hints(want, JP)
    joins = [j for st in stage_hints(got, PP) for j in st[1]]
    if q == "q5":  # five INNER joins; the two-key one packs its keys
        assert len(joins) == 5 and [j[4] is not None for j in joins].count(True) == 1
    if q == "q12":  # the build moves to the filtered lineitem, hinted unique
        assert [(j[1], j[3]) for j in joins] == [("left", True)]


def _same(want, got):
    assert list(want) == list(got)
    for k in want:
        assert want[k].dtype == got[k].dtype, k
        np.testing.assert_array_equal(want[k], got[k], err_msg=k)


@pytest.mark.parametrize("q", QUERIES)
def test_retry_attempts_match_jax(sessions, jax_attempts, q):
    js, ps = sessions
    want = js.collect(getattr(JTPCH, q)())
    _no_runtime_filters(js._plan_stages(getattr(JTPCH, q)()))
    got = ps.collect(getattr(tpch, q)())
    _same(want, got)
    attempts = [(r["scale"], r["unique_join_ok"]) for r in ps.runs if r["where"] == "stage"]
    assert attempts == jax_attempts
    if q == "q12":  # the duplicate-key flag fires once
        assert attempts == [(1, True), (4, False)]
        assert [r["overflowed"] for r in ps.runs] == [True, False]
        assert [r["joins"][0]["path"] for r in ps.runs] == ["sorted_unique", "pair_list"] or [
            r["joins"][0]["path"] for r in ps.runs] == ["dense_unique", "pair_list"]


# ---- hash_join on each INNER path --------------------------------------------------------


def _ordered(out):
    """Live rows in output order, (value or None) per column."""
    names = [k for k in out if not k.endswith("__valid")]
    return [tuple(out[c][i] if out[c + "__valid"][i] else None for c in names)
            for i in range(len(out[names[0]]))]


def _scaled(b, M, key_scale):
    """The batch with its int64 key column (fk or pk) times ``key_scale``."""
    if key_scale == 1:
        return b
    names = [f.name for f in b.schema.fields]
    i = names.index("fk" if "fk" in names else "pk")
    cols = list(b.columns)
    cols[i] = dataclasses.replace(cols[i], data=cols[i].data * key_scale, mag_bound=None)
    return M.Batch(tuple(cols), b.row_mask, b.schema)


def _join_both(seed, dup, keys=("fk",), dkeys=("pk",), key_scale=1, cond=None, **kw):
    """(JAX batch, flag), (port batch, flag, join_log) of one INNER join of
    the fact table (probe) and the dim table (build), both built from the
    same seeded numpy columns, with the same hints ``kw``."""
    jl, jr, pl, pr = _stage(seed, dup)
    jl, jr = _scaled(jl, JB, key_scale), _scaled(jr, JB, key_scale)
    pl, pr = _scaled(pl, PB, key_scale), _scaled(pr, PB, key_scale)
    out = []
    for M, E, join, l, r in ((JT, JE, JJ, jl, jr), (PT, PE, PJ, pl, pr)):
        schema = M.Schema(list(l.schema.fields) + list(r.schema.fields))
        c = None if cond is None else E.bind(cond(E), schema)
        extra = {"ctx": EvalContext(join_log=[])} if M is PT else {}
        b, ovf = join.hash_join(l, r, [E.bind(E.col(k), l.schema) for k in keys],
                                [E.bind(E.col(k), r.schema) for k in dkeys], "inner", "right",
                                schema, c, **kw, **extra)
        out.append((b, bool(ovf)) + ((extra["ctx"].join_log,) if M is PT else ()))
    return out


def _key_range(seed, dup, key_scale=1):
    _, _, _, pr = _stage(seed, dup)
    pk = pr.column("pk")
    live = pk.data[pk.validity & pr.row_mask] * key_scale
    return int(live.min()), int(live.max())


@pytest.mark.parametrize("path,key_scale,keys", [
    ("dense_unique", 1, ("fk",)),
    ("sorted_unique", 1 << 25, ("fk",)),  # the key span is past 2^24
    ("sorted_unique", 1, ("fk", "fk2")),  # two keys
])
def test_unique_build_matches_jax(path, key_scale, keys):
    """One pair slot per probe row, at the probe's capacity, in probe order:
    the row mask and every live row equal the JAX join's."""
    rng = _key_range(3, 1, key_scale)
    dkeys = ("pk", "pk2")[:len(keys)]
    (jb, jovf), (pb, povf, log) = _join_both(3, 1, keys, dkeys, key_scale,
                                             unique_build=True, build_key_range=rng,
                                             max_build_matches=4, compact_rows=4096)
    assert [e["path"] for e in log] == [path]
    assert not jovf and not povf
    assert pb.capacity == jb.capacity == _stage(3, 1)[2].capacity
    np.testing.assert_array_equal(pb.row_mask.numpy(), np.asarray(jb.row_mask))
    got = _ordered(PB.to_numpy(pb))
    assert len(got) > 50 and got == _ordered(JB.to_numpy(jb))


@pytest.mark.parametrize("key_scale", [1, 1 << 25])
def test_duplicate_build_keys_raise_the_flag(key_scale):
    rng = _key_range(5, 3, key_scale)
    (_, jovf), (_, povf, log) = _join_both(5, 3, key_scale=key_scale, unique_build=True,
                                           build_key_range=rng)
    assert jovf and povf
    assert log[0]["path"] == ("dense_unique" if key_scale == 1 else "sorted_unique")


@pytest.mark.parametrize("pack,flag", [(((0, 199), (0, 2)), False),
                                       (((0, 120), (0, 2)), True),  # fk runs to 199
                                       (((0, 199), (1, 2)), True)])  # pk2 has zeros
def test_key_packing_matches_jax(pack, flag):
    """Two keys packed into one int64 over their ranges: the pairs equal the
    JAX join's and the unpacked join's; a valid key outside its range
    raises the flag in both packages."""
    (jb, jovf), (pb, povf, log) = _join_both(7, 3, ("fk", "fk2"), ("pk", "pk2"),
                                             key_pack=pack, compact_rows=8192)
    assert jovf == povf == flag and log[0]["pack"]
    if not flag:
        (_, _), (plain, _, plog) = _join_both(7, 3, ("fk", "fk2"), ("pk", "pk2"),
                                              compact_rows=8192)
        assert not plog[0]["pack"]
        got = _ordered(PB.to_numpy(pb))
        assert len(got) > 20 and got == _ordered(JB.to_numpy(jb)) == _ordered(
            PB.to_numpy(plain))


@pytest.mark.parametrize("cond", [None, lambda E: E.col("w") < E.col("fk2") * E.lit(20)])
def test_pair_list_equals_pair_block_and_jax(monkeypatch, cond):
    """The compacted pair list holds the pair block's live pairs in the
    block's order (probe row, then build row within a key), slot for slot
    as the JAX package's list, with a condition evaluated at the list's
    capacity; with the block's helpers broken and K = 2^20 it still runs,
    so no (probe x K) block is allocated."""
    (_, _), (block, bovf, _) = _join_both(9, 3, cond=cond, max_build_matches=8)
    (jl, jovf), _ = _join_both(9, 3, cond=cond, compact_rows=4096)

    def no_block(*a, **k):
        raise AssertionError("the (probe x K) pair block was built")

    monkeypatch.setattr(PJ, "_pair_block", no_block)
    monkeypatch.setattr(PJ, "_repeat", no_block)
    (_, _), (pl, povf, log) = _join_both(9, 3, cond=cond, compact_rows=4096,
                                         max_build_matches=1 << 20)
    assert [e["path"] for e in log] == ["pair_list"] and not (bovf or jovf or povf)
    assert pl.capacity == 4096 == jl.capacity
    np.testing.assert_array_equal(pl.row_mask.numpy(), np.asarray(jl.row_mask))
    got = _ordered(PB.to_numpy(pl))
    assert len(got) > 50 and got == _ordered(PB.to_numpy(block)) == _ordered(JB.to_numpy(jl))


def test_pair_list_overflow_raises_the_flag():
    (_, jovf), (pb, povf, _) = _join_both(9, 3, compact_rows=64)
    assert jovf and povf and pb.capacity == 64
    (_, _), (full, _, _) = _join_both(9, 3, compact_rows=4096)
    n = int(full.num_rows())
    (_, jovf), (_, povf, _) = _join_both(9, 3, compact_rows=PB.pad_capacity(n))
    assert not jovf and not povf


# ---- each path through the Session -----------------------------------------------------


def _fact_dim(M, seed, dup, nf=700, hot=False, key_scale=1):
    """fact (nf rows; fk in [-5, 205), or for ``hot`` in [0, 50)) and dim
    (each of 100 keys ``dup`` times, two key columns); 5% null keys on
    each side; the first keys times ``key_scale``."""
    rng = np.random.default_rng(seed)
    fk = (rng.integers(0, 50, nf) if hot else rng.integers(-5, 205, nf)) * key_scale
    keys = (np.arange(50) if hot else rng.permutation(200)[:100]) * key_scale
    pk = np.repeat(keys, dup).astype(np.int64)
    fact = {"fk": fk.astype(np.int64), "fk2": rng.integers(0, 3, nf).astype(np.int64),
            "x": np.arange(nf, dtype=np.int64)}
    dim = {"pk": pk, "pk2": rng.integers(0, 3, len(pk)).astype(np.int64),
           "w": rng.integers(-50, 50, len(pk)).astype(np.int64)}
    fs = M.Schema([M.Field("fk", M.INT64), M.Field("fk2", M.INT64), M.Field("x", M.INT64)])
    ds = M.Schema([M.Field("pk", M.INT64), M.Field("pk2", M.INT64), M.Field("w", M.INT64)])
    return {"fact": (fact, fs, {"fk": rng.random(nf) > 0.05}),
            "dim": (dim, ds, {"pk": rng.random(len(pk)) > 0.05})}


def _plan(M, P, E, tables, case):
    """The join of the fact and dim tables for a case, pruned and bound, with
    the hints the case needs set on the bound nodes (the JAX package's
    pruning does not carry hints set on an unbound plan)."""
    fact = P.Scan("fact", tables["fact"][1])
    if case == "filter_shrink":
        fact = fact.filter(E.col("x") >= E.lit(0, M.INT64))
    two = case in ("pack", "pack_oor")
    j = P.HashJoin(fact, P.Scan("dim", tables["dim"][1]),
                   (E.col("fk"), E.col("fk2"))[:1 + two], (E.col("pk"), E.col("pk2"))[:1 + two],
                   P.JoinType.INNER, "right")
    prune = JPRUNE if M is JT else PPRUNE
    bound = P.bind_plan(prune.prune_columns(j.project([E.col("x"), E.col("w"), E.col("fk")])))
    (join,) = _nodes(bound, P.HashJoin)
    if case == "filter_shrink":
        join.left.out_rows_hint = 1
    if case == "duplicate":
        join.unique_build_hint = True
    if case == "pack_oor":
        join.key_pack = ((0, 120), (0, 2))
    if case == "small_compact":
        join.out_rows_hint = 1
    return bound


# case: (dup, fact rows, hot keys, first-attempt path, attempts)
SESSION_CASES = {
    "dense": (1, 700, False, "dense_unique", [(1, True)]),
    "sorted": (1, 700, False, "sorted_unique", [(1, True)]),  # keys span past 2^24
    "duplicate": (3, 700, False, "dense_unique", [(1, True), (4, False)]),
    "pack": (3, 700, False, "pair_list", [(1, True)]),
    "pack_oor": (3, 700, False, "pair_list", [(1, True), (4, False)]),
    "small_compact": (2, 5000, True, "pair_list", [(1, True), (4, False)]),
    "filter_shrink": (1, 5000, True, "dense_unique", [(1, True), (4, False)]),
}


@pytest.mark.parametrize("case", sorted(SESSION_CASES))
def test_join_paths_through_the_session_match_jax(jax_attempts, case):
    dup, nf, hot, path, attempts = SESSION_CASES[case]
    got = {}
    for M, P, E, S in ((JT, JP, JE, JaxSession), (PT, PP, PE, Session)):
        tables = _fact_dim(M, 11, dup, nf, hot, 1 << 25 if case == "sorted" else 1)
        s = S() if S is JaxSession else S(device="cpu")
        for name, (data, schema, validity) in tables.items():
            s.register_numpy(name, data, schema, validity=validity)
        got[M] = (s, s.collect(_plan(M, P, E, tables, case)))
    ps, pout = got[PT]
    _same(got[JT][1], pout)
    assert len(pout["x"]) > 100
    runs = [r for r in ps.runs if r["where"] == "stage"]
    assert [(r["scale"], r["unique_join_ok"]) for r in runs] == attempts == jax_attempts
    assert runs[0]["joins"][0]["path"] == path
    assert runs[0]["joins"][0]["pack"] == case.startswith("pack")
    if case == "duplicate":
        assert runs[1]["joins"][0]["path"] == "pair_list"

"""PyTorch port, the INNER hash join (``exec/operators/join.py``) exactly
against the JAX package's ``hash_join``, and the session's join-overflow
retry against the JAX ``Session``. Output capacities differ between the two
(the JAX package's default probe is another algorithm), so live rows are
compared sorted, not raw buffers."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from datafusion_comet_tpu import types as JT
from datafusion_comet_tpu.exec import batch as JB
from datafusion_comet_tpu.exec.engine import Session as JaxSession
from datafusion_comet_tpu.exec.engine import _shrink_apply
from datafusion_comet_tpu.exec.operators import basic as JBASIC
from datafusion_comet_tpu.exec.operators import join as JJ
from datafusion_comet_tpu.ir import expr as JE
from datafusion_comet_tpu.ir import plan as JP
from datafusion_comet_tpu.ir import pruning as JPRUNE
from datafusion_comet_tpu_torch import types as PT
from datafusion_comet_tpu_torch.exec import batch as PB
from datafusion_comet_tpu_torch.exec.engine import JoinOverflowError, Session
from datafusion_comet_tpu_torch.exec.operators import basic as PBASIC
from datafusion_comet_tpu_torch.exec.operators import join as PJ
from datafusion_comet_tpu_torch.ir import expr as PE
from datafusion_comet_tpu_torch.ir import plan as PP
from datafusion_comet_tpu_torch.ir import pruning as PPRUNE
from _torch_threads import one_torch_thread  # noqa: F401 (a fixture)

pytestmark = pytest.mark.usefixtures("one_torch_thread")


def _tables(seed: int, dup: int = 3):
    rng = np.random.default_rng(seed)
    nf, nd = 900, 150
    fact = {"fk": rng.integers(0, 200, nf).astype(np.int64),
            "fk2": rng.integers(0, 3, nf).astype(np.int32),
            "x": np.arange(nf, dtype=np.int64),
            "s": np.array(["a", "bb", "c", "dd", "e"], object)[rng.integers(0, 5, nf)]}
    pk = np.repeat(rng.permutation(200)[:nd // dup], dup).astype(np.int64)
    dim = {"pk": pk, "pk2": rng.integers(0, 3, len(pk)).astype(np.int32),
           "w": rng.integers(-50, 50, len(pk)).astype(np.int64),
           "t": np.array(["bb", "dd", "zz"], object)[rng.integers(0, 3, len(pk))]}
    fvalid = {"fk": rng.random(nf) > 0.05}
    dvalid = {"pk": rng.random(len(pk)) > 0.05}
    fmask = rng.random(nf) > 0.1
    return fact, dim, fvalid, dvalid, fmask


def _schemas(M):
    fact = M.Schema([M.Field("fk", M.INT64), M.Field("fk2", M.INT32), M.Field("x", M.INT64),
                     M.Field("s", M.string(2))])
    dim = M.Schema([M.Field("pk", M.INT64), M.Field("pk2", M.INT32), M.Field("w", M.INT64),
                    M.Field("t", M.string(2))])
    return fact, dim


def _stage(seed: int, dup: int = 3):
    fact, dim, fvalid, dvalid, fmask = _tables(seed, dup)
    jf, jd = _schemas(JT)
    pf, pd = _schemas(PT)
    jfb = JB.from_numpy(fact, jf, validity=fvalid)
    jfb = jfb.with_mask(jfb.row_mask & jnp.asarray(np.pad(fmask, (0, jfb.capacity - len(fmask)))))
    pfb = PB.from_numpy(fact, pf, "cpu", validity=fvalid)
    pfb = pfb.with_mask(pfb.row_mask & torch.from_numpy(np.pad(fmask, (0, pfb.capacity
                                                                      - len(fmask)))))
    return (jfb, JB.from_numpy(dim, jd, validity=dvalid),
            pfb, PB.from_numpy(dim, pd, "cpu", validity=dvalid))


def _rows(out):
    """Live rows as sorted tuples of (value or None) per column."""
    names = [k for k in out if not k.endswith("__valid")]
    n = len(out[names[0]])
    rows = [tuple(out[c][i] if out[c + "__valid"][i] else None for c in names) for i in range(n)]
    return sorted(rows, key=repr)


_KEYS = {
    "int64": (("fk",), ("pk",)),
    "two_keys": (("fk", "fk2"), ("pk", "pk2")),
    "dict_strings": (("s",), ("t",)),  # two tables' dictionaries: ranks of their union
}


@pytest.mark.parametrize("keys", sorted(_KEYS))
@pytest.mark.parametrize("build_side", ["right", "left"])
def test_inner_join_matches_jax(keys, build_side):
    jl, jr, pl, pr = _stage(7, dup=1 if keys == "dict_strings" else 3)
    lk, rk = _KEYS[keys]
    K = 512 if keys == "dict_strings" else (4 if build_side == "right" else 32)
    out = {}
    for M, E, join, l, r in ((JT, JE, JJ, jl, jr), (PT, PE, PJ, pl, pr)):
        schema = M.Schema(list(l.schema.fields) + list(r.schema.fields))
        b, ovf = join.hash_join(l, r, [E.bind(E.col(c), l.schema) for c in lk],
                                [E.bind(E.col(c), r.schema) for c in rk], "inner", build_side,
                                schema, max_build_matches=K)
        assert not bool(ovf)
        out[M] = _rows((JB.to_numpy if M is JT else PB.to_numpy)(b))
    assert len(out[PT]) > 50
    assert out[PT] == out[JT]


def test_inner_join_condition_matches_jax():
    jl, jr, pl, pr = _stage(11)
    out = {}
    for M, E, join, l, r in ((JT, JE, JJ, jl, jr), (PT, PE, PJ, pl, pr)):
        schema = M.Schema(list(l.schema.fields) + list(r.schema.fields))
        cond = E.bind(E.col("w") < E.col("fk2"), schema)
        b, _ = join.hash_join(l, r, [E.bind(E.col("fk"), l.schema)],
                              [E.bind(E.col("pk"), r.schema)], "inner", "right", schema, cond)
        out[M] = _rows((JB.to_numpy if M is JT else PB.to_numpy)(b))
    assert 0 < len(out[PT]) and out[PT] == out[JT]


def test_overflow_flag_when_matches_exceed_k():
    _, _, pl, pr = _stage(3, dup=6)
    schema = PT.Schema(list(pl.schema.fields) + list(pr.schema.fields))
    args = (pl, pr, [PE.bind(PE.col("fk"), pl.schema)], [PE.bind(PE.col("pk"), pr.schema)],
            "inner", "right", schema)
    assert bool(PJ.hash_join(*args, max_build_matches=4)[1])
    assert not bool(PJ.hash_join(*args, max_build_matches=8)[1])


@pytest.mark.parametrize("new_cap", [128, 512, 1024])
def test_pair_block_compaction_matches_jax(new_cap):
    """The join's (probe x K) pair block compacted as the session compacts
    it (one pass of the partition kernel with one part and a limit): live
    rows first in their order, the overflow flag when they do not fit, and
    the same rows as JAX compact_batch over the JAX join's block."""
    jl, jr, pl, pr = _stage(7)
    out = {}
    for M, E, join, basic, l, r in ((JT, JE, JJ, JBASIC, jl, jr), (PT, PE, PJ, PBASIC, pl, pr)):
        schema = M.Schema(list(l.schema.fields) + list(r.schema.fields))
        b, _ = join.hash_join(l, r, [E.bind(E.col("fk"), l.schema)],
                              [E.bind(E.col("pk"), r.schema)], "inner", "right", schema,
                              max_build_matches=4)
        c, ovf = basic.compact_batch(b, new_cap)
        out[M] = (b, c, bool(ovf))
    b, c, ovf = out[PT]
    live = int(b.num_rows())
    assert b.capacity > new_cap and ovf == (live > new_cap) == out[JT][2]
    assert c.capacity == new_cap and int(c.num_rows()) == min(live, new_cap)
    mask = b.row_mask.numpy()
    for src, got in zip(b.columns, c.columns):
        np.testing.assert_array_equal(got.data.numpy()[:min(live, new_cap)],
                                      src.data.numpy()[mask][:new_cap])
    if not ovf:
        assert _rows(PB.to_numpy(c)) == _rows(JB.to_numpy(out[JT][1]))


def test_aqe_shrink_matches_jax_shrink():
    """The session's stage-boundary shrink (twice the live rows, when that
    cuts the capacity four times) equals the JAX package's _shrink_apply,
    every buffer, dictionaries and magnitude bounds included."""
    fact, _, fvalid, _, _ = _tables(13)
    jf, _ = _schemas(JT)
    pf, _ = _schemas(PT)
    keep = np.random.default_rng(13).random(8192) < 0.05
    # the fact table's 900 rows repeated out to 8192, about 5% of them live
    data = {k: np.concatenate([v, v[:1].repeat(8192 - len(v))]) for k, v in fact.items()}
    valid = {k: np.concatenate([v, np.zeros(8192 - len(v), bool)]) for k, v in fvalid.items()}
    jb = JB.from_numpy(data, jf, validity=valid)
    jb = jb.with_mask(jnp.asarray(keep))
    pb = PB.from_numpy(data, pf, "cpu", validity=valid)
    pb = pb.with_mask(torch.from_numpy(keep))
    target = PB.pad_capacity(max(2 * int(keep.sum()), 1024))
    assert target * 4 <= pb.capacity
    got = Session(device="cpu")._aqe_shrink(pb)
    want = _shrink_apply(jb, target)
    assert got.capacity == want.capacity == target
    np.testing.assert_array_equal(got.row_mask.numpy(), np.asarray(want.row_mask))
    for g, w in zip(got.columns, want.columns):
        np.testing.assert_array_equal(g.data.numpy(), np.asarray(w.data))
        np.testing.assert_array_equal(g.validity.numpy(), np.asarray(w.validity))
        assert g.mag_bound == w.mag_bound and (g.dictionary is None) == (w.dictionary is None)


def test_other_join_types_raise():
    """Every hash join type runs now (LEFT, RIGHT and FULL:
    tests/test_torch_outer.py; the null-aware anti join:
    tests/test_torch_null_aware.py); an outer join that builds its
    preserved side still raises, as in the JAX package."""
    _, _, pl, pr = _stage(3)
    with pytest.raises(NotImplementedError):
        PJ.hash_join(pl, pr, [PE.bind(PE.col("fk"), pl.schema)],
                     [PE.bind(PE.col("pk"), pr.schema)], "right", "right",
                     PP._join_out_schema(pl.schema, pr.schema, "right"))


def _session_plan(M, P, E, fact_schema, dim_schema):
    j = P.HashJoin(P.Scan("fact", fact_schema), P.Scan("dim", dim_schema), (E.col("fk"),),
                   (E.col("pk"),), P.JoinType.INNER, "right")
    prune = JPRUNE if M is JT else PPRUNE
    bound = P.bind_plan(prune.prune_columns(j.project([E.col("x"), E.col("w")])))
    # a wrong hint set on the bound plan wins over the statistics
    bound.child.unique_build_hint = True
    return bound


@pytest.mark.parametrize("dup", [6, 20])
def test_session_retry_gives_full_answer_beyond_fanout(dup, monkeypatch):
    """Duplicate build keys under a unique-build hint: the first run (one
    match a probe row) raises the duplicate flag, the retry runs the
    compacted pair list without the hint and returns every pair, as the
    JAX session does; with one run allowed the query fails."""
    fact, dim, fvalid, dvalid, _ = _tables(5, dup)
    jf, jd = _schemas(JT)
    pf, pd = _schemas(PT)
    js = JaxSession()
    js.register_numpy("fact", fact, jf, validity=fvalid)
    js.register_numpy("dim", dim, jd, validity=dvalid)
    ps = Session(device="cpu")
    ps.register_numpy("fact", fact, pf, validity=fvalid)
    ps.register_numpy("dim", dim, pd, validity=dvalid)
    want = _rows(js.collect(_session_plan(JT, JP, JE, jf, jd)))
    got = _rows(ps.collect(_session_plan(PT, PP, PE, pf, pd)))
    assert len(got) > 100 and got == want
    assert max(np.unique(dim["pk"], return_counts=True)[1]) == dup
    assert [(r["scale"], r["unique_join_ok"], r["overflowed"], r["joins"][0]["path"])
            for r in ps.runs] == [(1, True, True, "dense_unique"),
                                  (4, False, False, "pair_list")]
    monkeypatch.setattr(PJ, "MAX_JOIN_RETRIES", 1)
    one_try = Session(device="cpu")
    one_try.register_numpy("fact", fact, pf, validity=fvalid)
    one_try.register_numpy("dim", dim, pd, validity=dvalid)
    with pytest.raises(JoinOverflowError):
        one_try.collect(_session_plan(PT, PP, PE, pf, pd))

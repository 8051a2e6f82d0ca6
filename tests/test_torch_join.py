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
from datafusion_comet_tpu.exec.operators import join as JJ
from datafusion_comet_tpu.ir import expr as JE
from datafusion_comet_tpu.ir import plan as JP
from datafusion_comet_tpu_torch import types as PT
from datafusion_comet_tpu_torch.exec import batch as PB
from datafusion_comet_tpu_torch.exec.engine import JoinOverflowError, Session
from datafusion_comet_tpu_torch.exec.operators import join as PJ
from datafusion_comet_tpu_torch.ir import expr as PE
from datafusion_comet_tpu_torch.ir import plan as PP


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


def test_other_join_types_raise():
    _, _, pl, pr = _stage(3)
    with pytest.raises(NotImplementedError):
        PJ.hash_join(pl, pr, [PE.bind(PE.col("fk"), pl.schema)],
                     [PE.bind(PE.col("pk"), pr.schema)], "left", "right", pl.schema)


def _session_plan(M, P, E, fact_schema, dim_schema):
    j = P.HashJoin(P.Scan("fact", fact_schema), P.Scan("dim", dim_schema), (E.col("fk"),),
                   (E.col("pk"),), P.JoinType.INNER, "right")
    return j.project([E.col("x"), E.col("w")])


@pytest.mark.parametrize("dup", [6, 20])
def test_session_retry_gives_full_answer_beyond_fanout(dup, monkeypatch):
    """Duplicate build keys beyond K = 4: the run overflows, re-runs with K
    = 16 (and 64), and returns every pair, as the JAX session does."""
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
    monkeypatch.setattr(PJ, "MAX_JOIN_RETRIES", 1)
    one_try = Session(device="cpu")
    one_try.register_numpy("fact", fact, pf, validity=fvalid)
    one_try.register_numpy("dim", dim, pd, validity=dvalid)
    with pytest.raises(JoinOverflowError):
        one_try.collect(_session_plan(PT, PP, PE, pf, pd))

"""PyTorch port, semi-like joins (LEFT_SEMI, LEFT_ANTI, EXISTENCE) with a
condition, exactly against the JAX package on the same seeded input, with
null keys and null condition values on both sides and dead rows (JAX
``tests/test_semi_minmax.py``, ``tests/test_dense_join.py:128-165``):

- ``hash_join`` on the min/max pushdown, each of ne, lt, le, gt, ge in both
  orientations, over int64 and date columns and against a probe
  expression: the dense variant (the build key's span at most 2^24 and the
  condition column's range known), and the sorted build's runs (a key span
  over 2^24, or no condition-column range);
- the pairs path for any other condition: a compound one, a float column,
  dictionary strings, two build columns; at a K the build's repeated keys
  pass, with the JAX package's overflow flag;
- through both ``Session``s: a compound condition whose first run overflows
  K re-runs in both packages alike (attempts), and gives the same answer.

Each port run asserts the path it took (``hash_join.semi_paths`` and the
join's ``ctx.join_log`` entry)."""

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
from datafusion_comet_tpu_torch.exec.engine import Session
from datafusion_comet_tpu_torch.exec.evaluator import EvalContext
from datafusion_comet_tpu_torch.exec.operators import join as PJ
from datafusion_comet_tpu_torch.ir import expr as PE
from datafusion_comet_tpu_torch.ir import plan as PP
from test_torch_hints import jax_attempts  # noqa: F401 (a fixture)
from test_torch_q9 import one_torch_thread  # noqa: F401 (a fixture)

pytestmark = pytest.mark.usefixtures("one_torch_thread")

PKG = {"jax": (JT, JB, JE, JP, JJ), "port": (PT, PB, PE, PP, PJ)}
SEMI = ["left_semi", "left_anti", "existence"]
OPS = ["ne", "lt", "le", "gt", "ge"]
_SYM = {"ne": "__ne__", "lt": "__lt__", "le": "__le__", "gt": "__gt__", "ge": "__ge__"}
WIDE = 1 << 20  # key stride of the tables whose build-key span passes 2^24


def _tables(seed: int, stride: int):
    """A probe table (700 rows) and a build table (1,200 rows over 150 of
    200 keys, so keys repeat) with int64, date, float and dictionary-string
    condition columns; 5% null keys and condition values, 10% dead rows on
    each side. Keys are multiplied by ``stride``."""
    rng = np.random.default_rng(seed)
    npr, nb = 700, 1200
    probe = {"pk": rng.integers(-10, 210, npr).astype(np.int64) * stride,
             "pv": rng.integers(-40, 40, npr).astype(np.int64),
             "pd": (9000 + rng.integers(0, 60, npr)).astype(np.int32),
             "pf": rng.normal(size=npr), "ps": np.array(["a", "bb", "c"], object)[
                 rng.integers(0, 3, npr)], "x": np.arange(npr, dtype=np.int64)}
    keys = rng.permutation(200)[:150]
    build = {"bk": keys[rng.integers(0, 150, nb)].astype(np.int64) * stride,
             "bv": rng.integers(-40, 40, nb).astype(np.int64),
             "bv2": rng.integers(-40, 40, nb).astype(np.int64),
             "bd": (9000 + rng.integers(0, 60, nb)).astype(np.int32),
             "bf": rng.normal(size=nb),
             "bt": np.array(["bb", "c", "zz"], object)[rng.integers(0, 3, nb)]}
    pvalid = {c: rng.random(npr) > 0.05 for c in ("pk", "pv", "pd", "pf", "ps")}
    bvalid = {c: rng.random(nb) > 0.05 for c in ("bk", "bv", "bd", "bf", "bt")}
    masks = (rng.random(npr) > 0.1, rng.random(nb) > 0.1)
    return probe, build, pvalid, bvalid, masks


def _schemas(M):
    return (M.Schema([M.Field("pk", M.INT64), M.Field("pv", M.INT64), M.Field("pd", M.DATE),
                      M.Field("pf", M.FLOAT64), M.Field("ps", M.string(2)),
                      M.Field("x", M.INT64)]),
            M.Schema([M.Field("bk", M.INT64), M.Field("bv", M.INT64), M.Field("bv2", M.INT64),
                      M.Field("bd", M.DATE), M.Field("bf", M.FLOAT64),
                      M.Field("bt", M.string(2))]))


def _batch(pkg, data, schema, validity, mask):
    B = PKG[pkg][1]
    if pkg == "jax":
        b = B.from_numpy(data, schema, validity=validity)
        return b.with_mask(b.row_mask & jnp.asarray(np.pad(mask, (0, b.capacity - len(mask)))))
    b = B.from_numpy(data, schema, "cpu", validity=validity)
    return b.with_mask(b.row_mask & torch.from_numpy(np.pad(mask, (0, b.capacity - len(mask)))))


def _cmp(E, op, a, b):
    return getattr(E.col(a), _SYM[op])(E.col(b))


# the min/max pushdown's conditions (E -> expr) by case, each with the
# build column it compares
CONDITIONS = {
    **{f"{op}_build_left": (lambda E, op=op: _cmp(E, op, "bv", "pv"), "bv") for op in OPS},
    **{f"{op}_build_right": (lambda E, op=op: _cmp(E, op, "pv", "bv"), "bv") for op in OPS},
    "date_gt": (lambda E: E.col("bd") > E.col("pd"), "bd"),
    "date_le_flipped": (lambda E: E.col("pd") <= E.col("bd"), "bd"),
    "probe_expr_lt": (lambda E: E.col("bv") < E.col("pv") + E.lit(3), "bv"),
    "probe_expr_ne": (lambda E: E.col("pv") * E.lit(2) != E.col("bv"), "bv"),
}
GENERIC = {
    "compound": lambda E: (E.col("bv") != E.col("pv")) & (E.col("bv") > E.lit(0)),
    "float": lambda E: E.col("bf") > E.col("pf"),
    "dict_strings": lambda E: E.col("bt") != E.col("ps"),
    "two_build_columns": lambda E: E.col("bv") < E.col("bv2"),
}


def _join(pkg, join_type, cond, stride, ranges, K=64, seed=11):
    probe, build, pvalid, bvalid, (pmask, bmask) = _tables(seed, stride)
    M, B, E, P, J = PKG[pkg]
    ps, bs = _schemas(M)
    left, right = _batch(pkg, probe, ps, pvalid, pmask), _batch(pkg, build, bs, bvalid, bmask)
    plan = P.bind_plan(P.HashJoin(P.Scan("p", ps), P.Scan("b", bs), (E.col("pk"),),
                                  (E.col("bk"),), join_type, "right", condition=cond(E)))
    key_range, cond_ranges = ranges
    extra = {"ctx": EvalContext(join_log=[])} if pkg == "port" else {}
    out, ovf = J.hash_join(left, right, plan.left_keys, plan.right_keys, join_type, "right",
                           plan.schema, plan.condition, max_build_matches=K,
                           build_key_range=key_range, cond_col_ranges=cond_ranges, **extra)
    return out, bool(ovf), extra.get("ctx")


def _ranges(stride, col, with_cond_range=True, seed=11):
    """(the build key's range, {col: its range} or None), over every build
    row, as the statistics give them."""
    build = _tables(seed, stride)[1]
    cr = {col: (int(build[col].min()), int(build[col].max()))} if with_cond_range else None
    return (int(build["bk"].min()), int(build["bk"].max())), cr


def _same(jout, pout):
    assert jout.capacity == pout.capacity
    np.testing.assert_array_equal(np.asarray(jout.row_mask), pout.row_mask.numpy())
    jn, pn = JB.to_numpy(jout), PB.to_numpy(pout)
    assert list(jn) == list(pn)
    for k in jn:
        np.testing.assert_array_equal(jn[k], pn[k], err_msg=k)


def _check(join_type, cond, stride, ranges, path, K=64):
    before = dict(PJ.hash_join.semi_paths)
    jout, jovf, _ = _join("jax", join_type, cond, stride, ranges, K)
    pout, povf, ctx = _join("port", join_type, cond, stride, ranges, K)
    assert {p: n - before[p] for p, n in PJ.hash_join.semi_paths.items() if n != before[p]} == {
        path: 1}
    assert [(j["type"], j["path"]) for j in ctx.join_log] == [(join_type, path)]
    assert jovf == povf
    _same(jout, pout)
    return pout, povf


@pytest.mark.parametrize("join_type", SEMI)
@pytest.mark.parametrize("case", list(CONDITIONS))
@pytest.mark.parametrize("variant", ["dense", "sorted_wide_span", "sorted_no_cond_range"])
def test_minmax_pushdown_matches_jax(join_type, case, variant):
    """One comparison against a bare build column: the dense table where
    the key span is at most 2^24 and the condition column's range is known,
    else the sorted build's runs; the same rows as the JAX package's."""
    cond, col = CONDITIONS[case]
    stride = WIDE if variant == "sorted_wide_span" else 1
    ranges = _ranges(stride, col, with_cond_range=variant != "sorted_no_cond_range")
    pout, povf = _check(join_type, cond, stride, ranges,
                        "minmax_dense" if variant == "dense" else "minmax_sorted")
    assert not povf
    if join_type == "existence":
        return
    kept = int(pout.row_mask.sum())  # neither side of the split is empty
    assert 0 < kept < int(_tables(11, stride)[4][0].sum())


@pytest.mark.parametrize("join_type", SEMI)
@pytest.mark.parametrize("case", list(GENERIC))
@pytest.mark.parametrize("K", [64, 4])
def test_other_conditions_take_the_pairs(join_type, case, K):
    """Any other condition runs on the pairs (the block at K) and is folded
    back per probe row; at K = 4 the repeated build keys overflow, in both
    packages alike."""
    _, povf = _check(join_type, GENERIC[case], 1, _ranges(1, "bv"), "pairs", K)
    assert povf == (K == 4)


@pytest.mark.parametrize("join_type", ["left_semi", "left_anti"])
def test_pairs_path_retries_as_jax(jax_attempts, join_type):
    """Through the Sessions: a compound condition's first run overflows K =
    4 (keys repeat up to 17 times) and re-runs with K = 16 and then 64 in
    both packages; the answers are equal."""
    probe, build, pvalid, bvalid, _ = _tables(5, 1)
    build = {k: np.concatenate([v] * 2) for k, v in build.items()}
    bvalid = {k: np.concatenate([v] * 2) for k, v in bvalid.items()}
    out = {}
    for pkg, sess in (("jax", JaxSession()), ("port", Session(device="cpu"))):
        M, B, E, P, J = PKG[pkg]
        ps, bs = _schemas(M)
        sess.register_numpy("p", probe, ps, validity=pvalid)
        sess.register_numpy("b", build, bs, validity=bvalid)
        plan = P.HashJoin(P.Scan("p", ps), P.Scan("b", bs), (E.col("pk"),), (E.col("bk"),),
                          join_type, "right", condition=GENERIC["compound"](E))
        out[pkg] = sess.collect(plan.sort([E.SortOrder(E.col("x"))]))
        if pkg == "port":
            attempts = [(r["scale"], r["unique_join_ok"]) for r in sess.runs]
            paths = [j["path"] for r in sess.runs for j in r["joins"]]
    assert attempts == jax_attempts and len(attempts) > 1
    assert set(paths) == {"pairs"}
    assert list(out["jax"]) == list(out["port"])
    for k in out["jax"]:
        np.testing.assert_array_equal(out["jax"][k], out["port"][k], err_msg=k)

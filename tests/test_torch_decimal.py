"""PyTorch port, utils/int128.py and exec/decimal_wide.py (plus the decimal
arithmetic of the evaluator) against the JAX package on edge values. Every
comparison is exact, storage included."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from datafusion_comet_tpu import types as JT
from datafusion_comet_tpu.exec import batch as JB
from datafusion_comet_tpu.exec import decimal_wide as JDW
from datafusion_comet_tpu.exec import evaluator as JEV
from datafusion_comet_tpu.ir import expr as JE
from datafusion_comet_tpu.utils import int128 as J128
from datafusion_comet_tpu_torch import types as PT
from datafusion_comet_tpu_torch.exec import batch as PB
from datafusion_comet_tpu_torch.exec import decimal_wide as PDW
from datafusion_comet_tpu_torch.exec import evaluator as PEV
from datafusion_comet_tpu_torch.ir import expr as PE
from datafusion_comet_tpu_torch.utils import int128 as P128
from _torch_threads import one_torch_thread  # noqa: F401 (a fixture)

pytestmark = pytest.mark.usefixtures("one_torch_thread")

_M64 = (1 << 64) - 1
I64_EDGES = [0, 1, -1, 2**31, -(2**31), 2**32 - 1, -(2**32 - 1), 2**62, -(2**62),
             2**63 - 1, -(2**63 - 1), 10**18, -(10**18), 123456789012345]
I128_EDGES = [0, 1, -1, 2**64, -(2**64), 2**64 - 1, 2**100 + 12345, -(2**100) - 7,
              10**38 - 1, -(10**38 - 1), 2**127 - 1, -(2**127), 10**20 + 5, -(10**19)]


def _rand_i64(seed, n=64, bits=63):
    rng = np.random.default_rng(seed)
    return rng.integers(-(2**bits), 2**bits - 1, n, dtype=np.int64)


def _limbs(ints):
    hi = np.array([np.uint64(((x & ((1 << 128) - 1)) >> 64) & _M64).astype(np.int64) for x in ints])
    lo = np.array([np.uint64(x & _M64).astype(np.int64) for x in ints])
    return hi, lo


def _both(a):
    """numpy int64 array -> (jax array, torch tensor)."""
    return jnp.asarray(a), torch.from_numpy(np.asarray(a, np.int64))


def _pairs(ints):
    hi, lo = _limbs(ints)
    return (jnp.asarray(hi), jnp.asarray(lo)), (torch.from_numpy(hi), torch.from_numpy(lo))


def _eq(j, p):
    """Compare a JAX result (array or tuple) with the port's, exactly."""
    if isinstance(j, tuple):
        assert isinstance(p, tuple) and len(j) == len(p)
        for a, b in zip(j, p):
            _eq(a, b)
        return
    np.testing.assert_array_equal(np.asarray(j), p.numpy())


def test_mul_i64_and_from_i64():
    vals = np.array(I64_EDGES + list(_rand_i64(1)), np.int64)
    x = _both(vals)
    y = _both(vals[::-1].copy())
    _eq(J128.mul_i64(x[0], y[0]), P128.mul_i64(x[1], y[1]))
    _eq(J128.from_i64(x[0]), P128.from_i64(x[1]))


@pytest.mark.parametrize("op", ["add", "sub"])
def test_add_sub_neg_cmp(op):
    a = I128_EDGES + [int(v) << 40 for v in _rand_i64(2, 32, 60)]
    b = a[::-1]
    ja, pa = _pairs(a)
    jb, pb = _pairs(b)
    _eq(getattr(J128, op)(ja, jb), getattr(P128, op)(pa, pb))
    _eq(J128.neg(ja), P128.neg(pa))
    _eq(J128.abs_(ja), P128.abs_(pa))
    _eq(J128.cmp(ja, jb), P128.cmp(pa, pb))
    _eq(J128.cmp_ge_u(ja, jb), P128.cmp_ge_u(pa, pb))


@pytest.mark.parametrize("k", [0, 1, 4, 18, 20, 37])
def test_pow10_scaling(k):
    small = [x for x in I128_EDGES if abs(x) < 10 ** max(38 - k, 1)]
    ja, pa = _pairs(small)
    _eq(J128.mul_pow10_i128(ja, k), P128.mul_pow10_i128(pa, k))
    _eq(J128.div_pow10_i128_half_up(ja, k), P128.div_pow10_i128_half_up(pa, k))
    x = _both(np.array([v for v in I64_EDGES if abs(v) < 10**18], np.int64))
    _eq(J128.mul_pow10_i64(x[0], k), P128.mul_pow10_i64(x[1], k))


def test_mul_i128_i64():
    a = [x for x in I128_EDGES if abs(x) < 2**70]
    ys = np.array([3, -7, 2**40, -(2**33), 1, 0, 10**9][: len(a)] + [5] * (len(a) - 7), np.int64)
    ja, pa = _pairs(a)
    y = _both(ys)
    _eq(J128.mul_i128_i64(ja, y[0]), P128.mul_i128_i64(pa, y[1]))


@pytest.mark.parametrize("den_bound", [None, 2**31 - 1])
def test_divmod_u128_u64(den_bound):
    """The 128-step restoring division and the 4-digit long division (used
    when the divisor is known below 2^31) agree with JAX bit for bit."""
    nums = [abs(x) for x in I128_EDGES if x != -(2**127)] + [2**128 - 1 - 5]
    dens = np.array([3, 7, 10**9, 2**31 - 1, 1, 65536, 999, 12345, 2, 11, 13, 17, 19, 23, 29],
                    np.int64)[: len(nums)]
    ja, pa = _pairs(nums)
    d = _both(dens)
    (jq, jr), (pq, pr) = (J128.divmod_u128_u64(ja[0], ja[1], d[0]),
                          P128.divmod_u128_u64(pa[0], pa[1], d[1], den_bound))
    _eq(jq, pq)
    _eq(jr, pr)
    if den_bound is None:
        big = _both(np.full(len(nums), 2**62 + 11, np.int64))
        _eq(J128.divmod_u128_u64(ja[0], ja[1], big[0]),
            P128.divmod_u128_u64(pa[0], pa[1], big[1]))


def test_div_half_up_family():
    a = [x for x in I128_EDGES if abs(x) < 2**100]
    dens = np.array([3, -7, 10**4, -(10**6), 2, 9, 10**12, -3, 5][: len(a)] + [7] * max(0, len(a) - 9),
                    np.int64)
    ja, pa = _pairs(a)
    d = _both(dens)
    _eq(J128.div_i128_i64_half_up(ja, d[0]), P128.div_i128_i64_half_up(pa, d[1]))
    _eq(JDW._div_i128_i64_full(ja, d[0]), PDW._div_i128_i64_full(pa, d[1]))
    pos = _both(np.abs(dens))
    _eq(JDW._div_i128_i64_full(ja, pos[0]), PDW._div_i128_i64_full(pa, pos[1], den_bound=10**12))


@pytest.mark.parametrize("k", [0, 4, 6, 12, 20])
def test_mul_i128_i128_scaled(k):
    a = I128_EDGES + [10**19 + 3, -(10**25)]
    b = [7, -3, 10**10, 2**40, -(10**17), 1, -1, 10**18, 99, -99, 1, 2, 3, 10**6, 10**19, 5]
    ja, pa = _pairs(a)
    jb, pb = _pairs(b[: len(a)])
    _eq(J128.mul_i128_i128_scaled(ja, jb, k), P128.mul_i128_i128_scaled(pa, pb, k))


def test_shl_to_f64_decompose_recombine():
    ja, pa = _pairs(I128_EDGES)
    for k in (0, 1, 32, 63, 64, 96, 127):
        _eq(J128.shl_bits(ja, k), P128.shl_bits(pa, k))
    _eq(J128.to_f64(ja), P128.to_f64(pa))
    lanes_j, lanes_p = JDW.decompose4(ja), PDW.decompose4(pa)
    _eq(lanes_j, lanes_p)
    _eq(JDW.recombine4(*lanes_j), PDW.recombine4(*lanes_p))
    _eq(JDW.overflow_check(ja, 38), PDW.overflow_check(pa, 38))
    _eq(JDW.overflow_check(ja, 20), PDW.overflow_check(pa, 20))
    _eq(JDW.fits_i64(ja), PDW.fits_i64(pa))
    _eq(JDW.pack(ja), PDW.pack(pa))
    _eq(JDW.pair(JDW.pack(ja)), PDW.pair(PDW.pack(pa)))
    for k in (-20, -3, 0, 5):
        small = [x for x in I128_EDGES if abs(x) < 10**30]
        js, ps = _pairs(small)
        _eq(JDW.rescale(js, k), PDW.rescale(ps, k))


# ---- column arithmetic through both evaluators -------------------------------------------


def _batches(cols):
    """cols: {name: (dtype ctor name args, python ints or None)} -> (jax batch, port batch)."""
    jf, pf, data = [], [], {}
    for name, ((p, s), vals) in cols.items():
        jf.append(JT.Field(name, JT.decimal(p, s)))
        pf.append(PT.Field(name, PT.decimal(p, s)))
        data[name] = np.array(vals, dtype=object) if p > 18 else np.array(
            [0 if v is None else v for v in vals], np.int64)
    validity = {n: np.array([v is not None for v in vals]) for n, (_, vals) in cols.items()}
    jb = JB.from_numpy(data, JT.Schema(jf), validity=validity)
    pb = PB.from_numpy(data, PT.Schema(pf), "cpu", validity=validity)
    return jb, pb


def _same_cv(jcv, pcv):
    assert jcv.dtype.__repr__() == pcv.dtype.__repr__()
    assert np.asarray(jcv.data).ndim == pcv.data.dim(), "storage differs"
    assert jcv.mag_bound == pcv.mag_bound
    valid = np.asarray(jcv.validity)
    np.testing.assert_array_equal(valid, pcv.validity.numpy())
    jd, pd = np.asarray(jcv.data), pcv.data.numpy()
    np.testing.assert_array_equal(jd[valid], pd[valid])


_COLS = {
    "a": ((15, 2), [100, -250, 10500000, None, 0, 99999, -1, 7]),
    "b": ((15, 2), [3, 10, -10, 5, None, 0, 9, 10]),
    "w": ((38, 4), [10**30, -(10**31), 12345, None, 2**70, 0, -(2**65), 1]),
    "s": ((25, 2), [10**17, -(10**16), 5, 6, None, 0, 1, -1]),
}


def _expr(E, T, shape):
    d = E.col
    one = E.lit(1).cast(T.decimal(10, 0))
    return {
        "disc_price": d("a") * (one - d("b")),
        "charge": (d("a") * (one - d("b"))) * (one + d("b")),
        "wide_add": d("w") + d("a"),
        "wide_mul": d("w") * d("b"),
        "narrow_sum_typed": d("s") + d("s"),
        "div": d("a") / d("b"),
        "wide_div": d("w") / d("b"),
        "cmp_wide": (d("w") < d("a")) & (d("b") >= E.lit(0.05, T.decimal(15, 2))),
        "cast_down": d("w").cast(T.decimal(20, 1)),
        "cast_int": E.lit(7).cast(T.decimal(20, 3)),
        "mod": E.BinaryOp("mod", d("a"), d("b")),
        "pmod": E.BinaryOp("pmod", d("a"), d("b")),
        "wide_mod": E.BinaryOp("mod", d("w"), d("s")),
        "wide_pmod": E.BinaryOp("pmod", d("w"), d("a")),
        "div_by_wide": d("a") / d("w"),
        "wide_div_wide": d("w") / d("s"),
    }[shape]


@pytest.mark.parametrize("shape", ["disc_price", "charge", "wide_add", "wide_mul",
                                   "narrow_sum_typed", "div", "wide_div", "cmp_wide",
                                   "cast_down", "cast_int", "mod", "pmod", "wide_mod",
                                   "wide_pmod", "div_by_wide", "wide_div_wide"])
def test_decimal_expressions_match_jax(shape):
    jb, pb = _batches(_COLS)
    je = JE.bind(_expr(JE, JT, shape), jb.schema)
    pe = PE.bind(_expr(PE, PT, shape), pb.schema)
    assert repr(je.dtype) == repr(pe.dtype)
    _same_cv(JEV.evaluate(je, jb), PEV.evaluate(pe, pb))


def test_div_i128_i128_half_up():
    a = I128_EDGES + [int(v) << 50 for v in _rand_i64(5, 18, 60)]
    b = [x if x else 3 for x in a[::-1]]
    b = [7, -7, 2**64 + 1, 10**19] + b[4:]
    ja, pa = _pairs(a)
    jb, pb = _pairs(b)
    _eq(J128.div_i128_i128_half_up(ja, jb), P128.div_i128_i128_half_up(pa, pb))


@pytest.mark.parametrize("mode", ["ANSI", "TRY"])
def test_decimal_mod_by_zero_modes(mode):
    """A zero divisor: null in every mode, an error only on the two-limb
    path under ANSI (the narrow path records none, as in the JAX package)."""
    jb, pb = _batches(_COLS)
    for l, r in (("a", "b"), ("w", "b")):
        je = JE.bind(JE.BinaryOp("mod", JE.col(l), JE.col(r), mode), jb.schema)
        pe = PE.bind(PE.BinaryOp("mod", PE.col(l), PE.col(r), mode), pb.schema)
        jctx, pctx = JEV.EvalContext(errors=[]), PEV.EvalContext(errors=[])
        _same_cv(JEV.evaluate(je, jb, jctx), PEV.evaluate(pe, pb, pctx))
        assert [m for _, m in jctx.errors] == [m for _, m in pctx.errors]
        for (jf, _), (pf, _) in zip(jctx.errors, pctx.errors):
            np.testing.assert_array_equal(np.asarray(jf), pf.numpy())


def test_q1_expression_storage_is_two_limb():
    """Q1's disc_price is decimal(32,4) on two-limb storage in both packages
    (the bound 99999999 x 999999999999 passes 2^62)."""
    rng = np.random.default_rng(0)
    n = 1000
    cols = {"a": ((15, 2), list(rng.integers(90000, 10500001, n))),
            "b": ((15, 2), list(rng.integers(0, 11, n))),
            "w": ((38, 4), [0] * n), "s": ((25, 2), [0] * n)}
    jb, pb = _batches(cols)
    je = JE.bind(_expr(JE, JT, "disc_price"), jb.schema)
    pe = PE.bind(_expr(PE, PT, "disc_price"), pb.schema)
    pcv = PEV.evaluate(pe, pb)
    assert repr(pcv.dtype) == "decimal(32,4)" and pcv.is_wide_storage
    _same_cv(JEV.evaluate(je, jb), pcv)

"""PyTorch port, exec/kernels.py: bucket_count / bucket_sum against the JAX
package's Pallas kernels (run under the Pallas interpreter, as
test_pallas_kernels.py runs them) and against exact numpy oracles.

On the CPU the wrappers take their plain PyTorch versions; the CUDA kernels
themselves are held against those on the card by tests marked ``cuda``
(tests/test_torch_cuda.py) and by chip_smoke.py. Every comparison is exact:
the values are integers.
"""

import contextlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from datafusion_comet_tpu.exec import pallas_kernels as PK
from datafusion_comet_tpu_torch.exec import kernels as K
from _torch_threads import one_torch_thread  # noqa: F401 (a fixture)

pytestmark = pytest.mark.usefixtures("one_torch_thread")


@contextlib.contextmanager
def _pallas_interpret():
    import jax.experimental.pallas as pl

    orig = pl.pallas_call

    def interp(*a, **kw):
        kw["interpret"] = True
        return orig(*a, **kw)

    pl.pallas_call = interp
    try:
        yield
    finally:
        pl.pallas_call = orig


def _numpy_sum(codes, vals, B):
    want = np.zeros((vals.shape[0], B) if vals.ndim == 2 else B, np.int64)
    live = codes < B
    if vals.ndim == 2:
        for j in range(vals.shape[0]):
            np.add.at(want[j], codes[live], vals[j][live])
    else:
        np.add.at(want, codes[live], vals[live])
    return want


@pytest.mark.parametrize("seed,B", [(1, 128), (2, 32), (3, 1)])
def test_count_matches_pallas_interpreter(seed, B):
    rng = np.random.default_rng(seed)
    codes = rng.integers(0, B + 1, 4096).astype(np.int32)  # incl. dead rows (code == B)
    with _pallas_interpret():
        want = np.asarray(PK._bucket_count_pallas(jnp.asarray(codes), B))
    got = K.bucket_count(torch.from_numpy(codes), B)
    assert got.dtype == torch.int64
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("seed,B", [(5, 32), (6, 64), (7, 3)])
def test_sum_matches_pallas_interpreter(seed, B):
    rng = np.random.default_rng(seed)
    n = 4096
    codes = rng.integers(0, B + 1, n).astype(np.int32)
    vals = rng.integers(-(2**30), 2**30, n).astype(np.int64)
    with _pallas_interpret():
        want = np.asarray(PK._bucket_sum_pallas(jnp.asarray(codes), jnp.asarray(vals), B))
    got = K.bucket_sum(torch.from_numpy(codes), torch.from_numpy(vals), B)
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("n,B,lanes", [(300_001, 64, 0), (300_001, 64, 4), (65_536, 4096, 2),
                                       (100_003, 1, 0)])
def test_sum_full_range_int64_matches_numpy(n, B, lanes):
    """Full-range int64 at sizes where the Pallas kernel's f32 accumulator
    is no reference: numpy add.at wraps mod 2^64 exactly as the kernel does."""
    rng = np.random.default_rng(n + B)
    codes = rng.integers(0, B + 1, n).astype(np.int32)
    shape = (lanes, n) if lanes else (n,)
    vals = rng.integers(-(2**63), 2**63 - 1, shape, dtype=np.int64)
    got = K.bucket_sum(torch.from_numpy(codes), torch.from_numpy(vals), B)
    np.testing.assert_array_equal(got.numpy(), _numpy_sum(codes, vals, B))


@pytest.mark.parametrize("n,B", [(1_000_003, 64), (4097, 4096), (17, 1)])
def test_count_matches_numpy(n, B):
    rng = np.random.default_rng(n)
    codes = rng.integers(0, B + 1, n).astype(np.int32)
    got = K.bucket_count(torch.from_numpy(codes), B)
    np.testing.assert_array_equal(got.numpy(), np.bincount(codes, minlength=B + 1)[:B])


def test_dead_and_empty_inputs():
    dead = torch.full((1000,), 8, dtype=torch.int32)
    assert K.bucket_count(dead, 8).tolist() == [0] * 8
    assert K.bucket_sum(dead, torch.ones(1000, dtype=torch.int64), 8).tolist() == [0] * 8
    empty = torch.zeros(0, dtype=torch.int32)
    assert K.bucket_count(empty, 3).tolist() == [0, 0, 0]
    assert K.bucket_sum(empty, torch.zeros((2, 0), dtype=torch.int64), 3).shape == (2, 3)
    codes = torch.tensor([0, 1, 1, 5, 5, 5], dtype=torch.int32)
    assert K.bucket_count(codes, 5).tolist() == [1, 2, 0, 0, 0]


@pytest.mark.parametrize("bad_code", [-1, 9])
def test_codes_outside_range_raise(bad_code):
    codes = torch.tensor([0, bad_code, 3], dtype=torch.int32)
    with pytest.raises(ValueError):
        K.bucket_count(codes, 8)
    with pytest.raises(ValueError):
        K.bucket_sum(codes, torch.ones(3, dtype=torch.int64), 8)


def test_argument_checks():
    codes = torch.zeros(4, dtype=torch.int32)
    with pytest.raises(ValueError):
        K.bucket_count(codes, K.MAX_BUCKETS + 1)
    with pytest.raises(ValueError):
        K.bucket_count(codes, 0)
    with pytest.raises(TypeError):
        K.bucket_count(codes.long(), 4)
    with pytest.raises(TypeError):
        K.bucket_sum(codes, torch.zeros(4, dtype=torch.int32), 4)
    with pytest.raises(TypeError):
        K.bucket_sum(codes, torch.zeros(5, dtype=torch.int64), 4)


def test_non_cpu_tensor_never_takes_the_plain_version():
    """Only a CPU tensor reaches the plain version; any other device must
    launch the CUDA kernel or raise (here: a meta tensor raises)."""
    codes = torch.zeros(4, dtype=torch.int32, device="meta")
    before = (K.bucket_count.launches, K.bucket_sum.launches)
    with pytest.raises(ValueError, match="meta"):
        K.bucket_count(codes, 4)
    with pytest.raises(ValueError, match="meta"):
        K.bucket_sum(codes, torch.zeros(4, dtype=torch.int64, device="meta"), 4)
    assert (K.bucket_count.launches, K.bucket_sum.launches) == before


def test_plain_path_counts_no_launches():
    before = (K.bucket_count.launches, K.bucket_sum.launches)
    codes = torch.tensor([0, 1, 2], dtype=torch.int32)
    K.bucket_count(codes, 3)
    K.bucket_sum(codes, torch.ones(3, dtype=torch.int64), 3)
    assert (K.bucket_count.launches, K.bucket_sum.launches) == before


# The kernel variant each shape takes, chosen in Python from (k, B) alone:
# (k value lanes, 0 for a count; B) -> (variant, threads, shared bytes, lanes
# a launch). 227 and 908 are the largest B of the per-thread count layout and
# of the lane-replicated sum layout; 228 and 909 the first past them.
@pytest.mark.parametrize("k,B,want", [
    (0, 1, ("count_private", 256, 1024, 0)),
    (0, 16, ("count_private", 256, 16384, 0)),
    (0, 64, ("count_private", 256, 65536, 0)),
    (0, 227, ("count_private", 256, 232_448, 0)),
    (0, 228, ("count_shared", 256, 912, 0)),
    (0, 4096, ("count_shared", 256, 16384, 0)),
    (1, 1, ("sum_replicated", 256, 256, 1)),
    (1, 16, ("sum_replicated", 256, 4096, 1)),
    (1, 64, ("sum_replicated", 256, 16384, 1)),
    (4, 64, ("sum_replicated", 256, 65536, 4)),
    (4, 227, ("sum_replicated", 256, 232_448, 4)),
    (4, 228, ("sum_replicated", 256, 175_104, 3)),
    (1, 908, ("sum_replicated", 256, 232_448, 1)),
    (2, 908, ("sum_replicated", 256, 232_448, 1)),
    (1, 909, ("sum_shared", 256, 7280, 1)),
    (2, 4096, ("sum_shared", 256, 65536, 2)),
    (16, 4096, ("sum_shared", 256, 229_376, 7)),
])
def test_bucket_layout_choice(k, B, want):
    assert tuple(K.bucket_layout(k, B)) == want


@pytest.mark.parametrize("k", [0, 1, 2, 4])
@pytest.mark.parametrize("B", [1, 16, 64, 227, 228, 908, 909, 4096])
def test_bucket_layout_fits_one_block(k, B):
    """Every choice fits the H100's 232,448 shared bytes a block, holds what
    its variant needs for its lanes, and takes every lane in launches of
    ``lanes`` each."""
    lay = K.bucket_layout(k, B)
    assert lay.name in K.LAYOUTS and lay.threads == 256
    assert 0 < lay.smem_bytes <= K.SMEM_MAX == 232_448 and lay.smem_bytes % 16 == 0
    need = {"count_private": 4 * B * 256, "count_shared": 4 * B,
            "sum_replicated": 8 * lay.lanes * B * 32, "sum_shared": 8 * lay.lanes * B}
    assert lay.smem_bytes >= need[lay.name]
    if k == 0:
        assert lay.lanes == 0 and lay.name.startswith("count_")
        assert (lay.name == "count_private") == (B <= 227)
    else:
        assert 1 <= lay.lanes <= k and lay.name.startswith("sum_")
        assert (lay.name == "sum_replicated") == (B <= 908)
        # the last, partial launch takes the same variant at fewer lanes
        rest = k % lay.lanes or lay.lanes
        assert K.bucket_layout(rest, B)[:2] == lay[:2]


@pytest.mark.parametrize("n,B,k,most,want", [
    (16_384, 16, 0, 1056, 4),       # the grace join's pairs at SF1: one tile a warp
    (262_144, 16, 1, 1056, 64),
    (8_388_608, 64, 0, 396, 396),   # Q1 at SF1: as many as fit the card
    (8_388_608, 64, 4, 396, 396),
    (100, 4096, 2, 400, 1),
    (1, 1, 0, 1056, 1),
])
def test_bucket_grid(n, B, k, most, want):
    assert K.grid_for(K.bucket_layout(k, B), n, most) == want


def test_bucket_grid_refuses_u32_overflow():
    with pytest.raises(ValueError, match="u32"):
        K.grid_for(K.bucket_layout(0, 64), 1 << 42, 2)


@pytest.mark.parametrize("shape", [(1,), (64,), (4, 64), (0, 3)])
def test_zeroed_outputs_share_one_buffer(shape):
    """The wrappers zero a kernel's output and its bad-code flag with one
    memset: both are views of one int64 buffer, the flag last."""
    out, bad = K.zeroed_outputs(shape, "cpu")
    assert out.shape == shape and bad.shape == (1,) and out.is_contiguous()
    assert out._base is bad._base and out._base.numel() == out.numel() + 1
    assert not out.any() and not bad.any()
    assert bad.data_ptr() == out._base.data_ptr() + 8 * out.numel()


def test_bucket_times_inputs():
    """The timing script's inputs (tools/bucket_times.py): Q1's codes put the
    padding and ~1.5% of the rows on the dead code and the rest on six
    buckets; a grace pair's block has one live row every JOIN_FANOUT slots,
    in Q12's two ship modes."""
    from datafusion_comet_tpu_torch.tools import bucket_times as BT

    rng = np.random.default_rng(0)
    codes, lanes = BT.q1_inputs(4096, 3000, rng)
    assert codes.dtype == np.int32 and lanes.dtype == np.int64 and lanes.shape == (4, 4096)
    assert (codes[3000:] == 64).all() and 0 < (codes[:3000] == 64).sum() < 150
    assert set(np.unique(codes[:3000])) <= {9, 10, 17, 18, 25, 26, 64}
    codes, vals = BT.pair_inputs(16_384, 3_653, rng)
    live = np.flatnonzero(codes < BT.PAIR_BUCKETS)
    assert len(live) == 3_653 and (live % 4 == 0).all() and vals.shape == (1, 16_384)
    assert set(codes[live].tolist()) <= set(BT.Q12_MODES)
    assert int(K.bucket_count(torch.from_numpy(codes), BT.PAIR_BUCKETS).sum()) == 3_653

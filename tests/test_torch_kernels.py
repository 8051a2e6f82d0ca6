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

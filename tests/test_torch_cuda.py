"""PyTorch port on the card: the CUDA kernels against their plain versions,
and Q1/Q6 on the card against the same queries on the CPU. Marked ``cuda``;
without a card every test here skips. This file imports no JAX, so it runs
on a machine without it (tests/conftest.py imports JAX, hence --noconftest):

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py
"""

import numpy as np
import pytest
import torch

from datafusion_comet_tpu_torch.exec import kernels as K
from datafusion_comet_tpu_torch.exec.engine import Session
from datafusion_comet_tpu_torch.models import tpch

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", 0)


@pytest.mark.parametrize("n,B,lanes", [(8_388_608, 64, 4), (1_000_003, 1, 1),
                                       (1_000_003, 4096, 3), (4097, 64, 0)])
def test_kernels_equal_plain_versions(dev, n, B, lanes):
    rng = np.random.default_rng(n + B)
    codes = torch.from_numpy(rng.integers(0, B + 1, n).astype(np.int32)).to(dev)
    shape = (lanes, n) if lanes else (n,)
    vals = torch.from_numpy(rng.integers(-(2**63), 2**63 - 1, shape, dtype=np.int64)).to(dev)
    assert torch.equal(K.bucket_count(codes, B), K.bucket_count_plain(codes, B))
    assert torch.equal(K.bucket_sum(codes, vals, B), K.bucket_sum_plain(codes, vals, B))
    torch.cuda.synchronize()


def test_kernels_raise_on_bad_codes(dev):
    codes = torch.tensor([0, 70, 2], dtype=torch.int32, device=dev)
    with pytest.raises(ValueError):
        K.bucket_count(codes, 64)
    with pytest.raises(ValueError):
        K.bucket_sum(codes, torch.ones(3, dtype=torch.int64, device=dev), 64)


def test_kernels_defer_bad_codes_to_error_list(dev):
    codes = torch.tensor([0, 70, 2], dtype=torch.int32, device=dev)
    errs = []
    K.bucket_count(codes, 64, errs)
    K.bucket_sum(codes, torch.ones(3, dtype=torch.int64, device=dev), 64, errs)
    assert [bool(f.any()) for f, _ in errs] == [True, True]
    assert all("outside [0, 64]" in m for _, m in errs)


@pytest.mark.parametrize("q", ["q1", "q6"])
def test_queries_on_card_equal_cpu(dev, q):
    data = tpch.generate_table("lineitem", 0.01)
    gpu, cpu = Session(), Session(device="cpu")
    for s in (gpu, cpu):
        s.register_numpy("lineitem", data, tpch.SCHEMAS["lineitem"])
    K.bucket_count.launches = K.bucket_sum.launches = 0
    got = gpu.collect(getattr(tpch, q)())
    assert K.bucket_sum.launches > 0 and K.bucket_count.launches > 0
    want = cpu.collect(getattr(tpch, q)())
    assert list(got) == list(want)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)

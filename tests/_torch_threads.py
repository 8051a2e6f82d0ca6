"""The PyTorch port's CPU tests run torch on one intra-op thread: their ops
gain nothing from more at these sizes, and test workers that each start a
thread per core oversubscribe the CPU (the Q20 variant's file: 122 s with
the default threads and 39 s with one, under a six-worker run). A module
takes it with ``pytestmark = pytest.mark.usefixtures("one_torch_thread")``
and the fixture imported. Importing this module also turns on the JAX
compilation cache the parity tests share (``_torch_jax_cache``)."""

import pytest
import torch

import _torch_jax_cache

_torch_jax_cache.enable()


@pytest.fixture(scope="module")
def one_torch_thread():
    """One intra-op thread for the module, restored after it."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)

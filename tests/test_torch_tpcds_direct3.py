"""PyTorch port, TPC-DS: the first half of share 3 of 5 of the 99 queries but q88 (its own
file; the other half is in ``test_torch_tpcds_direct3b.py``: a file runs
on one worker), each run
directly through the port's ``Session`` on the CPU and the JAX ``Session``
at the smallest scale where its answer has rows, and held equal: hints
stage by stage with the runtime filters' fields, values, order, storage,
bounds and attempts; the answers of chip_smoke.py's oracle queries also
equal their numpy oracle. The helpers are ``_torch_tpcds.py``'s."""

import pytest

import _torch_tpcds as H
from test_torch_hints import jax_attempts  # noqa: F401 (a fixture)
from _torch_threads import one_torch_thread  # noqa: F401 (a fixture)

pytestmark = pytest.mark.usefixtures("one_torch_thread")


@pytest.mark.parametrize("q", H.share(2)[0::2])
def test_direct_matches_jax(jax_attempts, q):
    H.check_direct(q, jax_attempts)

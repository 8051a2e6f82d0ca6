"""PyTorch port, TPC-DS windows under the grace join: q98 (a window SUM over
a grace-joined aggregate) and q47 (lag, lead and a partition AVG over a
four-way star join), each under the budget that partitions its first
stage's top join into K = 16 in both packages: the same K and modes,
partition sizes, pair retries and answer, which is the direct one. The
helpers are ``_torch_tpcds.py``'s."""

import pytest

import _torch_tpcds as H
from test_torch_grace import jax_spy  # noqa: F401 (a fixture)
from _torch_threads import one_torch_thread  # noqa: F401 (a fixture)

pytestmark = pytest.mark.usefixtures("one_torch_thread")


@pytest.mark.parametrize("q", ["q98", "q47"])
def test_grace_matches_jax(jax_spy, q):
    H.check_grace(q, jax_spy)

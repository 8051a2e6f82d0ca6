"""PyTorch port, TPC-DS q88 (eight half-hour counts of store sales, each a
scalar subquery over a four-way star join), at SF 0.02 through the port's
``Session`` on the CPU and the JAX ``Session``: directly (values, order,
storage, bounds, every subquery's stage hints, attempts in the JAX
package's compile order) and under the budget that partitions each
subquery's top join into K = 16 (K, mode, partition sizes and pair retries
of every subquery's grace join). Both equal the counts numpy gives from the
generated tables."""

import pytest

import _torch_tpcds as H
import chip_smoke
from test_torch_grace import jax_spy  # noqa: F401 (a fixture)
from test_torch_hints import jax_attempts  # noqa: F401 (a fixture)
from _torch_threads import one_torch_thread  # noqa: F401 (a fixture)

pytestmark = pytest.mark.usefixtures("one_torch_thread")

# q88's counts at SF 0.02: 93 store_sales rows pass the household and store
# filters, and the last half hour has none
COUNTS = [5, 5, 4, 2, 3, 2, 1, 0]


def test_q88_direct_matches_jax_and_numpy(jax_attempts):
    got = H.check_direct("q88", jax_attempts)
    assert [int(got[f"h{i}"][0]) for i in range(8)] == COUNTS
    assert chip_smoke.oracle_ds_q88(H.tables("q88")) == [tuple(COUNTS)]


def test_q88_under_grace_matches_jax(jax_spy):
    grace = H.check_grace("q88", jax_spy)
    # each subquery partitions its top join at K = 16 (the ungrouped count
    # runs over the union of the pairs, as in the JAX package) and the join
    # below it at K = 8
    assert len(grace.subqueries) == 8 and not grace.grace_runners
    assert all([(r.K, r.downstream) for r in s["grace_runners"]] == [(8, None), (16, None)]
               for s in grace.subqueries)

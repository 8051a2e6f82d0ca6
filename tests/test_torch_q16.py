"""PyTorch port, TPC-H Q16 (partsupp joined to the parts that pass a brand,
a NOT LIKE type and an IN-list of sizes, a LEFT ANTI join against the
suppliers with complaints, COUNT(DISTINCT ps_suppkey) per brand, type and
size, rewritten into a group-only aggregate and a COUNT) at SF 0.01 (306
rows) through the port's ``Session`` on the CPU, against the JAX
``Session`` with the default staging and with every string padded, and
against the numpy oracle chip_smoke.py checks the card with: directly
(values, storage, bounds, hints stage by stage, attempts) and under the
budget that partitions the first stage's top join into K = 16 (K, mode,
partition sizes, pair retries; the JAX package's tiled aggregate fails on
this query under tighter budgets, ROADMAP C8). The helpers are
test_torch_q9.py's."""

import pytest

from test_torch_grace import jax_spy  # noqa: F401 (a fixture)
from test_torch_hints import jax_attempts  # noqa: F401 (a fixture)
from test_torch_q9 import STAGING, check_direct, check_grace
from test_torch_q9 import one_torch_thread, tables  # noqa: F401 (fixtures)

pytestmark = pytest.mark.usefixtures("one_torch_thread")


@pytest.mark.parametrize("staging", list(STAGING))
def test_q16_direct_matches_jax_and_oracle(tables, jax_attempts, staging):
    check_direct(tables, jax_attempts, "q16", staging)


@pytest.mark.parametrize("staging", list(STAGING))
def test_q16_grace_matches_jax(tables, jax_spy, staging):
    check_grace(tables, jax_spy, "q16", staging)

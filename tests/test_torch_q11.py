"""PyTorch port, TPC-H Q11 (GERMANY's partsupp value per part and in all, the total
cast to DOUBLE times 0.0001, and the broadcast nested-loop join of the
per-part values against that one-row threshold under a DOUBLE
comparison) at SF 0.01 (152 rows)
through the port's ``Session`` on the CPU, against the JAX ``Session`` with
the default staging and with every string padded, and against the numpy
oracle chip_smoke.py checks the card with: directly (values, storage,
bounds, hints stage by stage, attempts) and under the budget that
partitions the first stage's top join into K = 16 (K, mode, partition
sizes, pair retries). The helpers are test_torch_q9.py's."""

import pytest

from test_torch_grace import jax_spy  # noqa: F401 (a fixture)
from test_torch_hints import jax_attempts  # noqa: F401 (a fixture)
from test_torch_q9 import STAGING, check_direct, check_grace, tables  # noqa: F401
from _torch_threads import one_torch_thread  # noqa: F401 (a fixture)

pytestmark = pytest.mark.usefixtures("one_torch_thread")


@pytest.mark.parametrize("staging", list(STAGING))
def test_q11_direct_matches_jax_and_oracle(tables, jax_attempts, staging):
    check_direct(tables, jax_attempts, "q11", staging)


@pytest.mark.parametrize("staging", list(STAGING))
def test_q11_grace_matches_jax(tables, jax_spy, staging):
    check_grace(tables, jax_spy, "q11", staging)

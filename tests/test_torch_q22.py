"""PyTorch port, TPC-H Q22 (``substring(c_phone, 1, 2)`` as the country
code, IN on it, the positive balances' decimal AVG, an INNER nested-loop
join on a DOUBLE condition, a LEFT ANTI join against the orders, COUNT and
SUM per code) at SF 0.01 (7 rows) through the port's ``Session`` on the
CPU, against the JAX ``Session`` and against the numpy oracle chip_smoke.py
checks the card with: directly (values, storage, bounds, hints stage by
stage, attempts) and under the budget that partitions the first stage's top
join into K = 16 (K, modes, partition sizes, pair retries). With the
default staging ``c_phone`` (1,500 values here) is dictionary-coded and
``substring`` runs over its entries; with every string padded it runs over
the bytes, as at SF1 and SF10. The helpers are test_torch_q9.py's."""

import pytest

from test_torch_grace import jax_spy  # noqa: F401 (a fixture)
from test_torch_hints import jax_attempts  # noqa: F401 (a fixture)
from test_torch_q9 import STAGING, check_direct, check_grace, sessions
from test_torch_q9 import one_torch_thread, tables  # noqa: F401 (fixtures)

pytestmark = pytest.mark.usefixtures("one_torch_thread")


@pytest.mark.parametrize("staging", list(STAGING))
def test_q22_direct_matches_jax_and_oracle(tables, jax_attempts, staging):
    check_direct(tables, jax_attempts, "q22", staging)
    _, ps = sessions(tables("q22"), staging)
    assert ps.tables["customer"].column("c_phone").is_dict == (staging == "default")


@pytest.mark.parametrize("staging", list(STAGING))
def test_q22_grace_matches_jax(tables, jax_spy, staging):
    check_grace(tables, jax_spy, "q22", staging)

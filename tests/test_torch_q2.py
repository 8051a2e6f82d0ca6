"""PyTorch port, TPC-H Q2 (the EUROPE suppliers' least supply cost per
part, ``pss`` feeding both the MIN aggregate and the join back, LIKE
'%BRASS' over ``p_type``'s dictionary or its padded bytes, a two-key
LEFT_SEMI join on (``ps_partkey``, ``ps_supplycost``) against (``ps_partkey``,
``min_cost``), narrow decimals on both sides, a top-100) at SF 0.01 (3
rows) through the port's ``Session`` on the CPU, against the JAX
``Session`` with the default staging and with every string padded, and
against the numpy oracle chip_smoke.py checks the card with: directly
(values, order, storage, bounds, hints stage by stage, attempts) and under
the budget that partitions the first stage's top join into K = 16 (K,
modes, partition sizes, pair retries); and directly at SF 0.05 (25 rows).
The helpers are test_torch_q9.py's."""

import pytest

import chip_smoke
from test_torch_grace import jax_spy  # noqa: F401 (a fixture)
from test_torch_hints import jax_attempts  # noqa: F401 (a fixture)
from test_torch_q9 import (QUERIES, STAGING, check_direct, check_grace, direct,  # noqa: F401
                               sessions, tables)
from _torch_threads import one_torch_thread  # noqa: F401 (a fixture)

pytestmark = pytest.mark.usefixtures("one_torch_thread")


@pytest.mark.parametrize("staging", list(STAGING))
def test_q2_direct_matches_jax_and_oracle(tables, jax_attempts, staging):
    check_direct(tables, jax_attempts, "q2", staging)


def test_q2_at_sf005_matches_jax_and_oracle(tables, jax_attempts):
    """Q2 where its top-100 holds 25 rows."""
    data = tables("q2", 0.05)
    js, ps = sessions(data, "default")
    got = direct(js, ps, "q2", jax_attempts)
    expect = QUERIES["q2"][2](data)
    assert len(expect) == 25
    chip_smoke.check_q2(got, expect, "q2 sf0.05")


@pytest.mark.parametrize("staging", list(STAGING))
def test_q2_grace_matches_jax(tables, jax_spy, staging):
    check_grace(tables, jax_spy, "q2", staging)

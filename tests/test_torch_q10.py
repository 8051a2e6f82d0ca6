"""PyTorch port, TPC-H Q10 (three INNER joins, grouped by ``c_custkey``,
``c_name``, ``c_acctbal`` and ``n_name``, a top-20 by revenue) at SF 0.005
and 0.01 through the port's ``Session`` on the CPU, against the JAX
``Session`` with the default staging and with every string padded, and
against the numpy oracle chip_smoke.py checks the card with: directly
(values, order, storage, bounds, hints stage by stage, attempts) and under
the budget that partitions its first join into K = 16 (K, modes, partition
sizes, pair retries). The helpers are test_torch_q18.py's."""

import pytest

import chip_smoke
from test_torch_grace import jax_spy  # noqa: F401 (a fixture)
from test_torch_hints import jax_attempts  # noqa: F401 (a fixture)
from test_torch_q18 import (QUERIES, STAGING, _direct, _sessions, check_grace,  # noqa: F401
                            jax_tiles, tables)
from _torch_threads import one_torch_thread  # noqa: F401 (a fixture)

pytestmark = pytest.mark.usefixtures("one_torch_thread")


@pytest.mark.parametrize("staging", list(STAGING))
@pytest.mark.parametrize("sf", [0.005, 0.01])
def test_q10_direct_matches_jax_and_oracle(tables, jax_attempts, sf, staging):
    js, ps = _sessions(tables[sf], staging)
    got, stages = _direct(js, ps, "q10", jax_attempts)
    expect = QUERIES["q10"][2](tables[sf])
    assert len(expect) == 20
    chip_smoke.check_q10(got, expect, "q10")
    c_name = ps.tables["customer"].column("c_name")
    assert c_name.is_dict == (staging == "default")  # 750 / 1,500 names at these sizes


@pytest.mark.parametrize("staging", list(STAGING))
def test_q10_grace_matches_jax(tables, jax_spy, jax_tiles, staging):
    check_grace(tables, jax_spy, jax_tiles, "q10", staging)

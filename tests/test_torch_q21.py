"""PyTorch port, TPC-H Q21 (an EXISTS and a NOT EXISTS on the same order
with ``l_suppkey <>``: a LEFT SEMI and a LEFT ANTI join with a condition,
both on the min/max pushdown) at SF 0.01 (3 rows) through the port's
``Session`` on the CPU, against the JAX ``Session`` with the default
staging and with every string padded, and against the numpy oracle
chip_smoke.py checks the card with (distinct suppliers per order, not the
min/max): directly (values, storage, bounds, hints stage by stage with the
condition-column ranges, attempts) and under the budget that partitions the
first stage's top join into K = 16 (K, modes, partition sizes, pair
retries). Each join with a condition takes the dense min/max table, in
the direct run and in every grace pair; without lineitem's statistics both
take the sorted build's runs. The helpers are test_torch_q9.py's."""

import pytest

import chip_smoke
from datafusion_comet_tpu_torch.exec.operators.join import hash_join
from datafusion_comet_tpu_torch.models import tpch
from test_torch_grace import jax_spy  # noqa: F401 (a fixture)
from test_torch_hints import jax_attempts  # noqa: F401 (a fixture)
from test_torch_q9 import STAGING, check_direct, check_grace, sessions
from test_torch_q9 import one_torch_thread, tables  # noqa: F401 (fixtures)

pytestmark = pytest.mark.usefixtures("one_torch_thread")


def _cond_paths(runs):
    """(where, type, path) of every semi-like join with a condition run."""
    return [(r["where"], j["type"], j["path"]) for r in runs if not r["overflowed"]
            for j in r["joins"] if j["path"].startswith(("minmax", "pairs"))]


@pytest.mark.parametrize("staging", list(STAGING))
def test_q21_direct_matches_jax_and_oracle(tables, jax_attempts, staging):
    before = dict(hash_join.semi_paths)
    check_direct(tables, jax_attempts, "q21", staging)
    assert hash_join.semi_paths["minmax_dense"] - before["minmax_dense"] == 2


@pytest.mark.parametrize("staging", list(STAGING))
def test_q21_grace_matches_jax(tables, jax_spy, staging):
    check_grace(tables, jax_spy, "q21", staging)


def test_q21_paths_direct_and_in_grace_pairs(tables):
    """The direct run's two joins with a condition take minmax_dense, and
    so does every grace pair that runs one (the pair plan keeps the
    table's build-key and condition-column ranges)."""
    data = tables("q21")
    _, ps = sessions(data, "default")
    ps.collect(tpch.q21())
    assert _cond_paths(ps.runs) == [("stage", "left_semi", "minmax_dense"),
                                    ("stage", "left_anti", "minmax_dense")]
    fraction, _ = chip_smoke.grace_fraction(ps, tpch.q21(), 16)
    _, grace = sessions(data, "default", fraction)
    grace.collect(tpch.q21())
    assert {p for _, _, p in _cond_paths(grace.runs)} == {"minmax_dense"}
    assert {w for w, _, _ in _cond_paths(grace.runs)} >= {"pair"}


def test_q21_sorted_minmax_without_statistics(tables):
    """Without lineitem's statistics no build-key range exists: both joins
    with a condition take the sorted build's runs, and the answer is the
    oracle's."""
    data = tables("q21")
    _, ps = sessions(data, "default")
    del ps.stats["lineitem"]
    got = ps.collect(tpch.q21())
    chip_smoke.check_q21(got, chip_smoke.oracle_q21(data["lineitem"], data["orders"],
                                                    data["supplier"], data["nation"]),
                         "q21 sorted")
    assert [p for _, _, p in _cond_paths(ps.runs)] == ["minmax_sorted", "minmax_sorted"]

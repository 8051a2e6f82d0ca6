"""PyTorch port, TPC-H Q20's variant ``chip_smoke.Q20_VARIANT`` (every part
name, ship dates 1992-1998: the plan of TPC-H Q20 with the literals that
give rows, 4 at SF 0.01; at TPC-H's the answer is empty, ROADMAP C16)
through the port's ``Session`` on the CPU, against the JAX ``Session`` on
the JAX plan with the same literals (test_torch_q20.py builds it) with the
default staging and with every string padded, and against the numpy oracle
chip_smoke.py checks the card with: directly (values, storage, bounds,
hints stage by stage, attempts) and under the budget that partitions the
first stage's top join into K = 16.

Under that budget the per-(part, supplier) aggregate over all of lineitem
runs tiled first, and its groups pass their estimate. The JAX package's
tiled aggregate drops the groups past its capacity (ROADMAP C17); the
port's re-runs four times larger (its two attempts are in
``Session.runs``). So the two packages partition different inputs there:
the grace test holds the port to the oracle and to the JAX answer (which
the dropped groups do not change at this size), and
``test_c17_tiled_aggregate_keeps_every_group`` shows the dropped groups."""

import warnings

import numpy as np
import pytest

import chip_smoke
from datafusion_comet_tpu.ir import expr as JE
from datafusion_comet_tpu.ir import plan as JP
from datafusion_comet_tpu.models import tpch as JTPCH
from datafusion_comet_tpu_torch.exec.memory import device_budget_bytes, plan_peak_bytes
from datafusion_comet_tpu_torch.ir import expr as PE
from datafusion_comet_tpu_torch.ir import plan as PP
from datafusion_comet_tpu_torch.models import tpch
from test_torch_grace import jax_fraction
from test_torch_hints import jax_attempts  # noqa: F401 (a fixture)
from test_torch_q9 import QUERIES, STAGING, check_direct, plans, same, sessions
from test_torch_q9 import one_torch_thread, tables  # noqa: F401 (fixtures)
from test_torch_q20 import jax_q20  # noqa: F401 (registers the variant)

pytestmark = pytest.mark.usefixtures("one_torch_thread")

Q = "q20_variant"


@pytest.mark.parametrize("staging", list(STAGING))
def test_q20_variant_direct_matches_jax_and_oracle(tables, jax_attempts, staging):
    check_direct(tables, jax_attempts, Q, staging)


@pytest.mark.parametrize("staging", list(STAGING))
def test_q20_variant_grace_matches_oracle_and_jax(tables, staging):
    data = tables(Q)
    port_plan, jax_plan = plans(Q)
    _, direct = sessions(data, staging)
    fraction, _ = chip_smoke.grace_fraction(direct, port_plan(), 16)
    js, grace = sessions(data, staging, fraction)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        got = grace.collect(port_plan())
    with jax_fraction(fraction):
        want = js.collect(jax_plan())
    same(want, got)
    QUERIES[Q][3](got, QUERIES[Q][2](data), f"{Q} grace")
    assert len(got["s_suppkey"]) == 4
    assert 16 in [r.K for r in grace.grace_runners] and grace.tiled[0][0] == "lineitem"
    assert all(r.retries == 0 for r in grace.grace_runners)
    # its tiled aggregate's groups passed their capacity: one re-run (C17)
    assert [(r["scale"], r["overflowed"]) for r in grace.runs if r["where"] == "tiled"] == [
        (1, True), (4, False)]


def _shipped(E, P, S):
    """The variant's per-(part, supplier) shipped quantity."""
    v = chip_smoke.Q20_VARIANT
    d = JTPCH._date_lit if P is JP else tpch._date_lit
    lines = P.Scan("lineitem", S["lineitem"]).filter(
        (E.col("l_shipdate") >= d(v["ship_from"])) & (E.col("l_shipdate") < d(v["ship_to"])))
    return lines.aggregate([E.col("l_partkey"), E.col("l_suppkey")],
                           [E.AggExpr("sum", E.col("l_quantity"), "qty")])


def test_c17_tiled_aggregate_keeps_every_group(tables):
    """ROADMAP C17: the variant's aggregate run tiled (groups past its
    statistics estimate): the port's result holds every (part, supplier)
    group with its exact sum, the JAX package's only as many as its
    capacity."""
    data = tables(Q)
    _, direct = sessions(data, "default")
    ((_, stage),) = direct._plan_stages(_shipped(PE, PP, tpch.SCHEMAS))
    peak = plan_peak_bytes(stage, direct.tables["lineitem"].capacity)
    # three quarters of the aggregate's peak estimate: the engine tiles it
    fraction = 0.75 * peak / device_budget_bytes("cpu", 1.0)
    js, ps = sessions(data, "default", fraction)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        got = ps.collect(_shipped(PE, PP, tpch.SCHEMAS))
    with jax_fraction(fraction):
        want = js.collect(_shipped(JE, JP, JTPCH.SCHEMAS))
    assert ps.tiled and ps.tiled[0][0] == "lineitem"
    # the first attempt overflowed and is recorded; the second, four times larger, held
    assert [(r["scale"], r["overflowed"]) for r in ps.runs if r["where"] == "tiled"] == [
        (1, True), (4, False)]
    li = data["lineitem"]
    pairs, inv = np.unique(np.stack([li["l_partkey"], li["l_suppkey"]]), axis=1,
                           return_inverse=True)
    qty = np.zeros(pairs.shape[1], np.int64)
    np.add.at(qty, inv.ravel(), li["l_quantity"])
    exact = sorted(zip(pairs[0].tolist(), pairs[1].tolist(), qty.tolist()))
    assert sorted(zip(got["l_partkey"].tolist(), got["l_suppkey"].tolist(),
                      got["qty"].tolist())) == exact
    assert len(want["qty"]) < len(exact)  # the JAX package's dropped groups

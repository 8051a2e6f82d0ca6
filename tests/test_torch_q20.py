"""PyTorch port, TPC-H Q20 (LIKE over the padded p_name, a per-(part,
supplier) SUM of the year's shipped quantity, LEFT_SEMI joins, a packed
two-key INNER join under a DOUBLE condition, nation, a sort on the padded
s_name) at SF 0.01 through the port's ``Session`` on the CPU, against the
JAX ``Session`` with the default staging and with every string padded, and
against the numpy oracle chip_smoke.py checks the card with: directly
(values, storage, bounds, hints stage by stage, attempts) and under the
budget that partitions the first stage's top join into K = 16 (K, mode,
partition sizes, pair retries).

At TPC-H's literals the answer is empty at every scale: the generators draw
l_suppkey and ps_suppkey independently, so few lines find their partsupp
row (ROADMAP C16). The variant ``chip_smoke.Q20_VARIANT`` (every part name,
ship dates 1992-1998) keeps the plan's shape and gives 4 rows: its JAX plan
is built here with the JAX IR, and test_torch_q20_variant.py runs it. The
helpers are test_torch_q9.py's."""

import pytest

import chip_smoke
from datafusion_comet_tpu import types as JT
from datafusion_comet_tpu.ir import expr as JE
from datafusion_comet_tpu.ir import plan as JP
from datafusion_comet_tpu.models import tpch as JTPCH
from datafusion_comet_tpu_torch.models import tpch
from test_torch_grace import jax_spy  # noqa: F401 (a fixture)
from test_torch_hints import jax_attempts  # noqa: F401 (a fixture)
from test_torch_q9 import QUERIES, ROWS, STAGING, VARIANTS, check_direct, check_grace
from test_torch_q9 import one_torch_thread, tables  # noqa: F401 (fixtures)

pytestmark = pytest.mark.usefixtures("one_torch_thread")


def jax_q20(pattern: str = "forest%", ship_from: str = "1994-01-01",
            ship_to: str = "1995-01-01") -> JP.PlanNode:
    """JAX ``tpch.q20`` with its literals as parameters (the port's
    ``tpch.q20(pattern, ship_from, ship_to)``)."""
    S, date = JTPCH.SCHEMAS, JTPCH._date_lit
    p = JP.Scan("part", S["part"]).filter(JE.col("p_name").like(pattern)).project(
        [JE.col("p_partkey")])
    l = JP.Scan("lineitem", S["lineitem"]).filter(
        (JE.col("l_shipdate") >= date(ship_from)) & (JE.col("l_shipdate") < date(ship_to)))
    shipped = l.aggregate([JE.col("l_partkey"), JE.col("l_suppkey")],
                          [JE.AggExpr("sum", JE.col("l_quantity"), "qty")])
    ps = JP.Scan("partsupp", S["partsupp"])
    ps_part = JP.HashJoin(ps, p, (JE.col("ps_partkey"),), (JE.col("p_partkey"),),
                          JP.JoinType.LEFT_SEMI, "right")
    psq = JP.HashJoin(
        ps_part, shipped, (JE.col("ps_partkey"), JE.col("ps_suppkey")),
        (JE.col("l_partkey"), JE.col("l_suppkey")), JP.JoinType.INNER, "right",
        condition=JE.col("ps_availqty").cast(JT.INT64).cast(JT.FLOAT64)
        > JE.lit(0.005) * JE.col("qty").cast(JT.FLOAT64))
    supp_keys = JP.Projection(psq, (JE.col("ps_suppkey"),))
    n = JP.Scan("nation", S["nation"]).filter(JE.col("n_name") == JE.lit("CANADA"))
    s = JP.Scan("supplier", S["supplier"])
    sn = JP.HashJoin(s, n, (JE.col("s_nationkey"),), (JE.col("n_nationkey"),),
                     JP.JoinType.INNER, "right")
    out = JP.HashJoin(sn, supp_keys, (JE.col("s_suppkey"),), (JE.col("ps_suppkey"),),
                      JP.JoinType.LEFT_SEMI, "right")
    return JP.Sort(JP.Projection(out, (JE.col("s_name"), JE.col("s_suppkey"))),
                   (JE.SortOrder(JE.col("s_name")),))


_TABLES = ("part", "lineitem", "partsupp", "supplier", "nation")


def _entry(**kw):
    args = {"pattern": "forest%", "ship_from": "1994-01-01", "ship_to": "1995-01-01", **kw}
    return (_TABLES, 0.01, lambda d: chip_smoke.oracle_q20(
        *(d[t] for t in _TABLES), args["pattern"], tpch._d(args["ship_from"]),
        tpch._d(args["ship_to"])), chip_smoke.check_q20)


QUERIES.update({"q20": _entry(), "q20_variant": _entry(**chip_smoke.Q20_VARIANT)})
ROWS.update({"q20": 0, "q20_variant": 4})
VARIANTS["q20_variant"] = (lambda: tpch.q20(**chip_smoke.Q20_VARIANT),
                           lambda: jax_q20(**chip_smoke.Q20_VARIANT))


def test_jax_q20_is_the_jax_plan():
    """The parameterised JAX plan at TPC-H's literals is the JAX package's."""
    assert repr(jax_q20()) == repr(JTPCH.q20())


@pytest.mark.parametrize("staging", list(STAGING))
def test_q20_direct_matches_jax_and_oracle(tables, jax_attempts, staging):
    check_direct(tables, jax_attempts, "q20", staging)


@pytest.mark.parametrize("staging", list(STAGING))
def test_q20_grace_matches_jax(tables, jax_spy, staging):
    check_grace(tables, jax_spy, "q20", staging)

"""PyTorch port, the planning around TPC-H Q3 against the JAX package:

- table statistics and the capacities derived from them (``max_groups``,
  ``group_key_ranges``) on Q1, Q6, Q12 and Q3;
- the stage split: the same stages, with the same root operators, as JAX
  ``Session._plan_stages`` (Q3 two, Q1, Q6 and Q12 one; the sorts of Q1
  and Q12 dropped in both);
- the top-K sort (``sort_op`` with fetch and skip, ties included) and
  ``limit_op``."""

import numpy as np
import pytest
import torch

from datafusion_comet_tpu import types as JT
from datafusion_comet_tpu.exec import batch as JB
from datafusion_comet_tpu.exec.engine import Session as JaxSession
from datafusion_comet_tpu.exec.operators import basic as JBASIC
from datafusion_comet_tpu.exec.stats import collect_stats as jax_collect_stats
from datafusion_comet_tpu.ir import expr as JE
from datafusion_comet_tpu.ir import plan as JP
from datafusion_comet_tpu.models import tpch as JTPCH
from datafusion_comet_tpu_torch import types as PT
from datafusion_comet_tpu_torch.conf import Config
from datafusion_comet_tpu_torch.exec import batch as PB
from datafusion_comet_tpu_torch.exec.engine import Session
from datafusion_comet_tpu_torch.exec.operators import basic as PBASIC
from datafusion_comet_tpu_torch.exec.stats import collect_stats
from datafusion_comet_tpu_torch.ir import expr as PE
from datafusion_comet_tpu_torch.ir import plan as PP
from datafusion_comet_tpu_torch.models import tpch
from _torch_threads import one_torch_thread  # noqa: F401 (a fixture)

pytestmark = pytest.mark.usefixtures("one_torch_thread")

SF = 0.01
TABLES = ("lineitem", "orders", "customer")
QUERIES = ("q1", "q6", "q12", "q3")


@pytest.fixture(scope="module")
def data():
    return {t: tpch.generate_table(t, SF) for t in TABLES}


@pytest.fixture(scope="module")
def sessions(data):
    js, ps = JaxSession(), Session(device="cpu")
    for t, d in data.items():
        js.register_numpy(t, d, JTPCH.SCHEMAS[t])
        ps.register_numpy(t, d, tpch.SCHEMAS[t])
    return js, ps


@pytest.mark.parametrize("table", TABLES)
def test_table_stats_match_jax(data, table):
    want = jax_collect_stats(data[table], JTPCH.SCHEMAS[table])
    got = collect_stats(data[table], tpch.SCHEMAS[table])
    assert (got.rows, got.ndv, got.ranges) == (want.rows, want.ndv, want.ranges)


def test_sampled_stats_match_jax():
    """Past 65,536 rows the distinct counts come from a seeded sample."""
    rng = np.random.default_rng(3)
    n = 200_000
    cols = {"k": rng.integers(0, 150_000, n).astype(np.int64),
            "u": np.arange(n, dtype=np.int64), "d": rng.integers(8000, 9000, n).astype(np.int32)}
    want = jax_collect_stats(cols, JT.Schema([JT.Field("k", JT.INT64), JT.Field("u", JT.INT64),
                                              JT.Field("d", JT.DATE)]))
    got = collect_stats(cols, PT.Schema([PT.Field("k", PT.INT64), PT.Field("u", PT.INT64),
                                         PT.Field("d", PT.DATE)]))
    assert (got.ndv, got.ranges) == (want.ndv, want.ranges)
    assert got.ndv["u"] == n and 100_000 < got.ndv["k"] < n


def _aggregates(plan):
    out = [plan] if isinstance(plan, (JP.HashAggregate, PP.HashAggregate)) else []
    for c in plan.children():
        out += _aggregates(c)
    return out


def _shape(stages):
    """Per stage: whether it is the root, and the operator types top-down
    to the first leaf or join."""
    out = []
    for name, sub in stages:
        chain, node = [], sub
        while True:
            chain.append(type(node).__name__)
            kids = node.children()
            if len(kids) != 1:
                break
            node = kids[0]
        out.append((name is None, tuple(chain)))
    return out


@pytest.mark.parametrize("q", QUERIES)
def test_capacities_and_stages_match_jax(sessions, q):
    """Both packages drop Q1's and Q12's sorts (their aggregates already
    emit key order, ir/ordering.py) and keep Q3's top-K; Q6 has none."""
    js, ps = sessions
    want = js._plan_stages(getattr(JTPCH, q)())
    got = ps._plan_stages(getattr(tpch, q)())
    assert _shape(got) == _shape(want)
    assert ("Sort" in _shape(got)[-1][1]) == (q == "q3")
    assert len(got) == (2 if q == "q3" else 1)
    for (_, gsub), (_, wsub) in zip(got, want):
        ga, wa = _aggregates(gsub), _aggregates(wsub)
        assert len(ga) == len(wa)
        for g, w in zip(ga, wa):
            assert g.max_groups == w.max_groups
            assert g.group_key_ranges == getattr(w, "group_key_ranges", None)
    if q in ("q1", "q12"):  # the dense path is unchanged: capacity above the buckets
        assert _aggregates(got[0][1])[0].max_groups == 1024


def test_q3_stage_split_settings():
    """No heavy-operator split: one stage; no split at all with 0 for both."""
    for conf, n in ((Config(), 2), (Config(stage_max_heavy_ops=0), 1),
                    (Config(stage_max_joins=1, stage_max_heavy_ops=0), 2),
                    (Config(stage_max_joins=0, stage_max_heavy_ops=0), 1)):
        assert len(Session(device="cpu", conf=conf)._plan_stages(tpch.q3())) == n


# ---- top-K and limit ------------------------------------------------------------------


def _sort_inputs(M, B, device=None):
    rng = np.random.default_rng(21)
    n = 300
    data = {"k": rng.integers(0, 5, n).astype(np.int64),  # ties
            "x": np.arange(n, dtype=np.int64),
            "v": rng.integers(-50, 50, n).astype(np.int64)}
    schema = M.Schema([M.Field("k", M.INT64), M.Field("x", M.INT64), M.Field("v", M.decimal(9, 2))])
    validity = {"k": rng.random(n) > 0.1, "v": rng.random(n) > 0.2}
    args = (data, schema) if device is None else (data, schema, device)
    b = B.from_numpy(*args, validity=validity)
    keep = np.zeros(b.capacity, bool)
    keep[:n] = rng.random(n) > 0.15
    return b.with_mask(b.row_mask & (keep if device is None else torch.from_numpy(keep)))


@pytest.mark.parametrize("fetch,skip", [(None, 0), (10, 0), (7, 5), (None, 20), (0, 0),
                                        (400, 0), (5, 300)])
@pytest.mark.parametrize("desc", [False, True])
def test_sort_fetch_skip_matches_jax(fetch, skip, desc):
    jb, pb = _sort_inputs(JT, JB), _sort_inputs(PT, PB, "cpu")
    outs = []
    for M, E, BASIC, b, to_numpy in ((JT, JE, JBASIC, jb, JB.to_numpy),
                                     (PT, PE, PBASIC, pb, PB.to_numpy)):
        orders = [E.SortOrder(E.bind(E.col("k"), b.schema), ascending=not desc),
                  E.SortOrder(E.bind(E.col("v"), b.schema), ascending=desc)]
        outs.append(to_numpy(BASIC.sort_op(b, orders, fetch, skip)))
    want, got = outs
    assert list(want) == list(got)
    for c in want:
        np.testing.assert_array_equal(want[c], got[c], err_msg=c)
    live = int(pb.num_rows())
    assert len(got["x"]) == max(0, min(live - skip, live if fetch is None else fetch))


@pytest.mark.parametrize("limit,offset", [(10, 0), (10, 30), (1000, 5), (0, 0)])
def test_limit_matches_jax(limit, offset):
    jb, pb = _sort_inputs(JT, JB), _sort_inputs(PT, PB, "cpu")
    want = JB.to_numpy(JBASIC.limit_op(jb, limit, offset))
    got = PB.to_numpy(PBASIC.limit_op(pb, limit, offset))
    for c in want:
        np.testing.assert_array_equal(want[c], got[c], err_msg=c)


def test_limit_through_the_session(sessions):
    _, ps = sessions
    plan = PP.Scan("orders", tpch.SCHEMAS["orders"]).project([PE.col("o_orderkey")]).limit(5, 2)
    assert ps.collect(plan)["o_orderkey"].tolist() == [9, 13, 17, 21, 25]

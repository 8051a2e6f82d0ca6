"""PyTorch port, the runtime semi-join filters (exec/runtime_filter.py,
exec/host_filter.py), exactly against the JAX package where it injects
them: TPC-H Q3, Q5, Q9, Q10, Q8 and Q17 at SF 0.02 (120,000 lineitem
rows, over the injector's 65,536-row fact-side minimum) and Q2 at SF 0.1
(80,000 partsupp rows).

- The plan: per stage the hints of every join, filter and aggregate, each
  join's ``rf_dense_range`` and injected flag, the key tables' names and
  contents, and the retry attempts; and the result. Each case asserts
  that the JAX package injected a filter, so none passes on an empty case.
- With the filters off, and Q3 and Q10 with their filters under the grace
  join: ``test_torch_runtime_filter2.py`` (a file runs on one worker).
- The host evaluator of the dimension filters against the JAX one, and
  the host copies the session keeps per registered table."""

import contextlib

import numpy as np
import pytest

from datafusion_comet_tpu import types as JT
from datafusion_comet_tpu.conf import CONF
from datafusion_comet_tpu.exec import host_filter as JHF
from datafusion_comet_tpu.exec.engine import Session as JaxSession
from datafusion_comet_tpu.exec.runtime_filter import RUNTIME_FILTER_ENABLED
from datafusion_comet_tpu.ir import expr as JE
from datafusion_comet_tpu.ir import plan as JP
from datafusion_comet_tpu.models import tpch as JTPCH
from datafusion_comet_tpu_torch import types as PT
from datafusion_comet_tpu_torch.conf import Config
from datafusion_comet_tpu_torch.exec import host_filter as PHF
from datafusion_comet_tpu_torch.exec.engine import Session
from datafusion_comet_tpu_torch.exec.runtime_filter import injected_filters
from datafusion_comet_tpu_torch.ir import expr as PE
from datafusion_comet_tpu_torch.ir import plan as PP
from datafusion_comet_tpu_torch.models import tpch
from test_torch_hints import jax_attempts  # noqa: F401 (a fixture)
from test_torch_q9 import jax_session, rf_hints, same
from _torch_threads import one_torch_thread  # noqa: F401 (a fixture)

pytestmark = pytest.mark.usefixtures("one_torch_thread")

GRACE_K = 16
BIG = ("lineitem", "orders", "customer", "supplier", "nation", "region", "part", "partsupp")
Q2_TABLES = ("part", "supplier", "partsupp", "nation", "region")
CASES = [("q3", 0.02), ("q5", 0.02), ("q9", 0.02), ("q10", 0.02), ("q2", 0.1), ("q8", 0.02),
         ("q17", 0.02)]


@pytest.fixture(scope="module")
def data():
    return {0.02: tpch.generate_tables(BIG, 0.02), 0.1: tpch.generate_tables(Q2_TABLES, 0.1)}


def _sessions(tables, fraction=None, enabled=True):
    js = jax_session(tables, JTPCH.SCHEMAS, None)
    conf = {"memory_fraction": fraction} if fraction else {}
    ps = Session(device="cpu", conf=Config(runtime_filter_enabled=enabled, **conf))
    for t, d in tables.items():
        ps.register_numpy(t, d, tpch.SCHEMAS[t])
    return js, ps


@contextlib.contextmanager
def jax_runtime_filters(enabled: bool):
    old = CONF.get(RUNTIME_FILTER_ENABLED)
    CONF.set("comet.exec.runtimeFilter.enabled", enabled)
    try:
        yield
    finally:
        CONF.set("comet.exec.runtimeFilter.enabled", old)


def _injected(stages, P):
    out, stack = [], [p for _, p in stages]
    while stack:
        p = stack.pop()
        if isinstance(p, P.HashJoin) and getattr(p, "rf_injected", False):
            out.append(p)
        stack.extend(p.children())
    return out


def _key_table(session, name):
    b = session.tables[name]
    mask = np.asarray(b.row_mask.cpu() if hasattr(b.row_mask, "cpu") else b.row_mask)
    col = b.columns[0].data
    return np.asarray(col.cpu() if hasattr(col, "cpu") else col)[mask]


@pytest.mark.parametrize("q,sf", CASES)
def test_plan_and_result_match_jax(data, jax_attempts, q, sf):
    js, ps = _sessions(data[sf])
    want_stages = js._plan_stages(getattr(JTPCH, q)())
    got_stages = ps._plan_stages(getattr(tpch, q)())
    jinj, pinj = _injected(want_stages, JP), _injected(got_stages, PP)
    assert len(jinj) >= 1  # the JAX package injected: the case is not empty
    assert rf_hints(got_stages, PP) == rf_hints(want_stages, JP)
    assert sorted(j.right.table for j in pinj) == sorted(j.right.table for j in jinj)
    fields = lambda j: (j.rf_dense_range, j.out_rows_hint, j.build_key_range)  # noqa: E731
    for name in {j.right.table for j in jinj}:  # Q17 filters two scans by one key table
        pjs = [p for p in pinj if p.right.table == name]
        assert sorted(map(fields, pjs)) == sorted(fields(j) for j in jinj if j.right.table == name)
        keys = _key_table(ps, name)
        np.testing.assert_array_equal(keys, _key_table(js, name))
        assert all((int(keys.min()), int(keys.max())) == tuple(p.rf_dense_range) for p in pjs)
    jax_attempts.clear()
    want = js.collect(getattr(JTPCH, q)())
    got = ps.collect(getattr(tpch, q)())
    same(want, got)
    assert [(r["scale"], r["unique_join_ok"]) for r in ps.runs] == jax_attempts
    rep = injected_filters(ps)
    assert [(f["table"], f["keys"]) for f in rep] == [
        (j.right.table, len(_key_table(ps, j.right.table))) for j in _injected(ps.stages, PP)]


@pytest.mark.parametrize("q,compacts", [("q3", False), ("q5", True), ("q10", True)])
def test_engine_tags_the_compaction_of_a_filters_output(data, q, compacts):
    """The B3 calls the engine tags ``rf`` compact an injected semi join's
    output to twice its row estimate (times the run's growth scale); Q3's
    filter at SF 0.02 only thins the row mask, so it has none."""
    from datafusion_comet_tpu_torch.exec import kernels as K
    from datafusion_comet_tpu_torch.exec.batch import pad_capacity

    _, ps = _sessions(data[0.02])
    K.partition_columns.log = []
    try:
        same(ps.collect(getattr(tpch, q)()), ps.collect(getattr(tpch, q)()))
        log = K.partition_columns.log
    finally:
        K.partition_columns.log = None
    ests = [j.out_rows_hint for j in _injected(ps.stages, PP)]
    assert ests  # the filter was injected: the case is not empty
    limits = {pad_capacity(max(2 * e, 1024) * r["scale"]) for e in ests for r in ps.runs}
    tagged = [c for c in log if c["tag"] == "rf"]
    assert bool(tagged) == compacts
    assert all(c["codes"] == "bool" and c["K"] == 1 and c["limit"] in limits for c in tagged)


# the dimension filters of the cases, and one each of the other conjuncts
DIM_FILTERS = [
    ("orders", lambda E, T: (E.col("o_orderdate") >= E.lit(8766, T.DATE))
     & (E.col("o_orderdate") < E.lit(9204, T.DATE))),
    ("customer", lambda E, T: E.col("c_mktsegment") == E.lit("BUILDING")),
    ("part", lambda E, T: E.col("p_name").like("%green%")),
    ("part", lambda E, T: (E.col("p_size") == E.lit(15)) & E.col("p_type").like("%BRASS")),
    ("part", lambda E, T: E.col("p_name").like("forest%")
     | E.col("p_brand").isin("Brand#12", "Brand#34")),
    ("part", lambda E, T: E.col("p_type").like("%ANODIZED_%")),
    ("part", lambda E, T: E.col("p_container").isin("SM CASE", "LG BOX")
     & (E.col("p_retailprice") > E.lit(1500, T.decimal(15, 2))) & (E.col("p_size") > E.lit(40))),
    ("orders", lambda E, T: E.Like(E.col("o_orderpriority"), "%URGENT", negated=True)),
    ("supplier", lambda E, T: E.col("s_name") != E.lit("Supplier#000000007")),
]


@pytest.mark.parametrize("i", range(len(DIM_FILTERS)))
@pytest.mark.parametrize("dms", [1 << 16, 0])
def test_host_filter_matches_jax(data, i, dms):
    table, pred = DIM_FILTERS[i]
    d = data[0.02][table]
    js, ps = JaxSession(), Session(device="cpu", conf=Config(scan_dictionary_max_size=dms))
    js.register_numpy(table, d, JTPCH.SCHEMAS[table], dict_max_size=dms)
    ps.register_numpy(table, d, tpch.SCHEMAS[table])
    want = JHF.eval_dim_filter(js.tables[table], [pred(JE, JT)])
    got = PHF.eval_dim_filter(ps.tables[table], [pred(PE, PT)], ps.host_columns(table))
    assert got[1] == want[1] is True
    np.testing.assert_array_equal(got[0], np.asarray(want[0]))


def test_host_columns_are_kept_per_registered_batch(data):
    ps = Session(device="cpu")
    ps.register_numpy("part", data[0.02]["part"], tpch.SCHEMAS["part"])
    cols = ps.host_columns("part")
    assert ps.host_columns("part") is cols
    assert cols.get("p_name") is cols.get("p_name")
    ps.register_numpy("part", data[0.02]["part"], tpch.SCHEMAS["part"])
    assert ps.host_columns("part") is not cols

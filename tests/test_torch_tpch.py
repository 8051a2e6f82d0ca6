"""PyTorch port, the slices end to end: TPC-H Q1, Q6 and Q3 through the
port's ``Session`` on the CPU against the JAX ``Session`` on the same
generated data (Q1/Q6 at SF 0.01, Q3 at SF 0.001 and 0.01), and against the
exact integer oracles chip_smoke.py checks the card with (Q4 and Q15 in
test_torch_semi.py and test_torch_minmax.py; here Q15 with padded supplier
names). The ``customer`` and ``supplier`` tables stage as the JAX package
stages them. Also: the port imports no JAX and
nothing of the JAX package, and its Session refuses to start without a card
unless asked for the CPU."""

import ast
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import chip_smoke
from datafusion_comet_tpu.exec import batch as JB
from datafusion_comet_tpu.exec.engine import Session as JaxSession
from datafusion_comet_tpu.models import tpch as JTPCH
from datafusion_comet_tpu_torch.exec import batch as PB
from datafusion_comet_tpu_torch.exec import kernels as K
from datafusion_comet_tpu_torch.exec.engine import QueryExecutionError, Session
from datafusion_comet_tpu_torch.ir import expr as PE
from datafusion_comet_tpu_torch.ir import plan as PP
from datafusion_comet_tpu_torch.models import tpch
from _torch_threads import one_torch_thread  # noqa: F401 (a fixture)

pytestmark = pytest.mark.usefixtures("one_torch_thread")

SF = 0.01
ROOT = Path(__file__).resolve().parent.parent


@pytest.fixture(scope="module")
def data():
    return tpch.generate_table("lineitem", SF)


@pytest.fixture(scope="module")
def sessions(data):
    js = JaxSession()
    js.register_numpy("lineitem", data, JTPCH.SCHEMAS["lineitem"])
    ps = Session(device="cpu")
    ps.register_numpy("lineitem", data, tpch.SCHEMAS["lineitem"])
    return js, ps


@pytest.mark.parametrize("q", ["q1", "q6"])
def test_matches_jax_session(sessions, q):
    """Values; for Q6 also the output's storage (narrow or two-limb) and
    magnitude bound: its ungrouped revenue is two-limb with no bound in both
    packages."""
    js, ps = sessions
    jb = js.execute(getattr(JTPCH, q)())
    pb = ps.execute(getattr(tpch, q)())
    jout, pout = JB.to_numpy(jb), PB.to_numpy(pb)
    assert list(jout) == list(pout)
    for k in jout:
        assert jout[k].dtype == pout[k].dtype, k
        np.testing.assert_array_equal(jout[k], pout[k], err_msg=k)
    if q == "q6":
        for jc, pc, f in zip(jb.columns, pb.columns, pb.schema.fields):
            assert np.asarray(jc.data).ndim == pc.data.dim(), f.name
            assert jc.mag_bound == pc.mag_bound, f.name
        assert pb.columns[0].data.dim() == 2 and pb.columns[0].mag_bound is None


def test_q1_matches_integer_oracle(sessions, data):
    _, ps = sessions
    out = ps.collect(tpch.q1())
    expect = chip_smoke.oracle_q1(data, tpch._d("1998-09-02"))
    assert len(expect) == 6
    chip_smoke.check_q1(out, expect)


def test_q6_matches_integer_oracle(sessions, data):
    _, ps = sessions
    out = ps.collect(tpch.q6())
    want = chip_smoke.oracle_q6(data, tpch._d("1994-01-01"), tpch._d("1995-01-01"))
    assert want > 0 and int(out["revenue"][0]) == want


def test_bound_schemas_match_jax():
    """Spark's decimal result typing comes out identical."""
    for q in ("q1", "q6"):
        assert repr(PP.bind_plan(getattr(tpch, q)()).schema) == repr(
            __import__("datafusion_comet_tpu.ir.plan", fromlist=["bind_plan"]).bind_plan(
                getattr(JTPCH, q)()).schema)
    q1 = repr(PP.bind_plan(tpch.q1()).schema)
    for part in ("sum_qty: decimal(25,2)", "sum_disc_price: decimal(38,4)",
                 "sum_charge: decimal(38,6)", "avg_qty: decimal(19,6)", "count_order: int64"):
        assert part in q1
    assert "revenue: decimal(38,4)" in repr(PP.bind_plan(tpch.q6()).schema)


Q3_TABLES = ("lineitem", "orders", "customer")


@pytest.fixture(scope="module", params=[0.001, 0.01], ids=["sf0.001", "sf0.01"])
def q3_sessions(request):
    """(JAX session, port session, data) over lineitem, orders and customer."""
    d = {t: tpch.generate_table(t, request.param) for t in Q3_TABLES}
    js, ps = JaxSession(), Session(device="cpu")
    for t in Q3_TABLES:
        js.register_numpy(t, d[t], JTPCH.SCHEMAS[t])
        ps.register_numpy(t, d[t], tpch.SCHEMAS[t])
    return js, ps, d


def test_q3_matches_jax_session(q3_sessions):
    js, ps, _ = q3_sessions
    jout = js.collect(JTPCH.q3())
    pout = ps.collect(tpch.q3())
    assert list(jout) == list(pout)
    for k in jout:
        assert jout[k].dtype == pout[k].dtype, k
        np.testing.assert_array_equal(jout[k], pout[k], err_msg=k)
    assert len(pout["revenue"]) == 10
    # the aggregate ran as its own stage, the top-K over its result
    assert [n is None for n, _ in ps.stages] == [False, True]


def test_q3_matches_integer_oracle(q3_sessions):
    _, ps, d = q3_sessions
    want = chip_smoke.oracle_q3(d["lineitem"], d["orders"], d["customer"],
                                tpch._d("1995-03-15"))
    chip_smoke.check_q3(ps.collect(tpch.q3()), want, "port")


def test_q3_bound_schema_matches_jax():
    from datafusion_comet_tpu.ir import plan as JP

    assert repr(PP.bind_plan(tpch.q3()).schema) == repr(JP.bind_plan(JTPCH.q3()).schema)


@pytest.mark.parametrize("dict_max_size", [None, 1000])
def test_customer_stages_as_jax(dict_max_size):
    """Same generated columns, same staging: c_mktsegment dictionary-coded,
    c_name and c_phone padded strings once their distinct values pass the
    dictionary limit (as at SF 1 and up), else coded too."""
    d = tpch.generate_table("customer", 0.01)
    want_d = JTPCH.generate_table("customer", 0.01)
    for k in want_d:
        assert want_d[k].dtype == d[k].dtype, k
        np.testing.assert_array_equal(want_d[k], d[k], err_msg=k)
    kw = {} if dict_max_size is None else {"dict_max_size": dict_max_size}
    jb = JB.from_numpy(want_d, JTPCH.SCHEMAS["customer"], **kw)
    pb = PB.from_numpy(d, tpch.SCHEMAS["customer"], "cpu", **kw)
    assert jb.capacity == pb.capacity == 2048
    coded = {f.name: c.is_dict for f, c in zip(pb.schema.fields, pb.columns)}
    assert coded["c_mktsegment"] and coded["c_name"] == coded["c_phone"] == (
        dict_max_size is None)
    for f, jc, pc in zip(pb.schema.fields, jb.columns, pb.columns):
        assert jc.is_dict == pc.is_dict, f.name
        assert jc.mag_bound == pc.mag_bound, f.name
        for a, b in ((jc.data, pc.data), (jc.validity, pc.validity), (jc.lengths, pc.lengths)):
            assert (a is None) == (b is None), f.name
            if a is not None:
                np.testing.assert_array_equal(np.asarray(a), b.numpy(), err_msg=f.name)
        if pc.is_dict:
            np.testing.assert_array_equal(jc.dictionary.values, pc.dictionary.values)


@pytest.mark.parametrize("dict_max_size", [None, 50])
def test_supplier_stages_as_jax(dict_max_size):
    """Same generated columns, same staging: s_name and s_comment padded
    strings once their distinct values pass the dictionary limit (s_name at
    SF 10, or here past a limit of 50), else dictionary-coded."""
    d = tpch.generate_table("supplier", 0.01)
    want_d = JTPCH.generate_table("supplier", 0.01)
    assert list(want_d) == list(d)
    for k in want_d:
        assert want_d[k].dtype == d[k].dtype, k
        np.testing.assert_array_equal(want_d[k], d[k], err_msg=k)
    kw = {} if dict_max_size is None else {"dict_max_size": dict_max_size}
    jb = JB.from_numpy(want_d, JTPCH.SCHEMAS["supplier"], **kw)
    pb = PB.from_numpy(d, tpch.SCHEMAS["supplier"], "cpu", **kw)
    assert jb.capacity == pb.capacity == 128
    coded = {f.name: c.is_dict for f, c in zip(pb.schema.fields, pb.columns)}
    assert coded["s_comment"] and coded["s_name"] == (dict_max_size is None)
    for f, jc, pc in zip(pb.schema.fields, jb.columns, pb.columns):
        assert jc.is_dict == pc.is_dict, f.name
        assert jc.mag_bound == pc.mag_bound, f.name
        for a, b in ((jc.data, pc.data), (jc.validity, pc.validity), (jc.lengths, pc.lengths)):
            assert (a is None) == (b is None), f.name
            if a is not None:
                np.testing.assert_array_equal(np.asarray(a), b.numpy(), err_msg=f.name)
        if pc.is_dict:
            np.testing.assert_array_equal(jc.dictionary.values, pc.dictionary.values)


@pytest.mark.parametrize("q", ["q4", "q15"])
def test_q4_q15_bound_schemas_match_jax(q):
    from datafusion_comet_tpu.ir import plan as JP

    assert repr(PP.bind_plan(getattr(tpch, q)()).schema) == repr(
        JP.bind_plan(getattr(JTPCH, q)()).schema)


def test_q15_with_padded_supplier_names():
    """s_name as a padded string column (past the dictionary limit, as at
    SF 10): the INNER join repeats and the sort gathers its byte rows."""
    d = {t: tpch.generate_table(t, 0.01) for t in ("lineitem", "supplier")}
    js, ps = JaxSession(), Session(device="cpu")
    for t in d:
        js.register_numpy(t, d[t], JTPCH.SCHEMAS[t], dict_max_size=50)
        ps.register_numpy(t, d[t], tpch.SCHEMAS[t], dict_max_size=50)
    assert not ps.tables["supplier"].column("s_name").is_dict
    want, got = js.collect(JTPCH.q15()), ps.collect(tpch.q15())
    assert list(want) == list(got)
    for k in want:
        np.testing.assert_array_equal(want[k], got[k], err_msg=k)
    chip_smoke.check_q15(got, chip_smoke.oracle_q15(d["lineitem"], d["supplier"],
                                                    tpch._d("1996-01-01"),
                                                    tpch._d("1996-04-01")), "port")


def test_q6_over_no_rows_gives_one_null_row():
    empty = {k: v[:0] for k, v in tpch.generate_table("lineitem", 0.0001).items()}
    ps = Session(device="cpu")
    ps.register_numpy("lineitem", empty, tpch.SCHEMAS["lineitem"])
    out = ps.collect(tpch.q6())
    assert len(out["revenue"]) == 1 and not out["revenue__valid"][0]


@pytest.mark.parametrize("mode", [PE.EvalMode.LEGACY, PE.EvalMode.ANSI])
def test_divide_by_zero_through_session(sessions, data, mode):
    """The session reads the error side channel once, at the end of the
    query: LEGACY nulls the rows that divide by zero, ANSI raises."""
    _, ps = sessions
    ratio = PE.BinaryOp("div", PE.col("l_quantity"), PE.col("l_discount"), mode)
    plan = PP.Scan("lineitem", tpch.SCHEMAS["lineitem"]).aggregate(
        [], [PE.AggExpr("count", ratio, "n")])
    zeros = int((data["l_discount"] == 0).sum())
    assert zeros > 0
    if mode == PE.EvalMode.ANSI:
        with pytest.raises(QueryExecutionError, match="DIVIDE_BY_ZERO"):
            ps.collect(plan)
    else:
        assert ps.collect(plan)["n"].tolist() == [len(data["l_discount"]) - zeros]


def test_session_without_card_raises():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: Session() is expected to start")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        Session()


def test_cpu_path_launches_no_kernel(sessions):
    _, ps = sessions
    before = (K.bucket_count.launches, K.bucket_sum.launches)
    ps.collect(tpch.q1())
    assert (K.bucket_count.launches, K.bucket_sum.launches) == before


def _port_files():
    return sorted((ROOT / "datafusion_comet_tpu_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"]


@pytest.mark.parametrize("path", _port_files(), ids=lambda p: str(p.relative_to(ROOT)))
def test_port_source_imports_no_jax(path):
    for node in ast.walk(ast.parse(path.read_text())):
        names = []
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.module:
            names = [node.module]
        for n in names:
            root = n.split(".")[0]
            assert root not in ("jax", "jaxlib", "datafusion_comet_tpu"), f"{path}: imports {n}"


def test_running_q1_loads_no_jax_module():
    code = (
        "import sys\n"
        "from datafusion_comet_tpu_torch.exec.engine import Session\n"
        "from datafusion_comet_tpu_torch.models import tpch\n"
        "s = Session(device='cpu')\n"
        "s.register_numpy('lineitem', tpch.generate_table('lineitem', 0.001), "
        "tpch.SCHEMAS['lineitem'])\n"
        "assert len(s.collect(tpch.q1())['count_order']) > 0\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'datafusion_comet_tpu')]\n"
        "assert not bad, bad\n"
        "print('clean')\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env, capture_output=True,
                         text=True, timeout=300)
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip() == "clean"

"""PyTorch port, the slice end to end: TPC-H Q1 and Q6 through the port's
``Session`` on the CPU against the JAX ``Session`` on the same generated data
(SF 0.01), and against the exact integer oracle chip_smoke.py checks the
card with. Also: the port imports no JAX and nothing of the JAX package, and
its Session refuses to start without a card unless asked for the CPU."""

import ast
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import chip_smoke
from datafusion_comet_tpu.exec.engine import Session as JaxSession
from datafusion_comet_tpu.models import tpch as JTPCH
from datafusion_comet_tpu_torch.exec import kernels as K
from datafusion_comet_tpu_torch.exec.engine import QueryExecutionError, Session
from datafusion_comet_tpu_torch.ir import expr as PE
from datafusion_comet_tpu_torch.ir import plan as PP
from datafusion_comet_tpu_torch.models import tpch

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
    js, ps = sessions
    jout = js.collect(getattr(JTPCH, q)())
    pout = ps.collect(getattr(tpch, q)())
    assert list(jout) == list(pout)
    for k in jout:
        assert jout[k].dtype == pout[k].dtype, k
        np.testing.assert_array_equal(jout[k], pout[k], err_msg=k)


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

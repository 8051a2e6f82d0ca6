"""PyTorch port, chip_smoke.py's expression query set (``expr_plans``:
expr_time, expr_strings, expr_casts, expr_sample) at TPC-DS SF 0.01
through the port's ``Session`` on the CPU against the JAX ``Session`` on
the same tables, each plan built from its package's IR: equal answers
(expr_sample row for row: the sample keeps the scan's order, and its rand
values equal the JAX scan's bit for bit, randn within
``chip_smoke.EXPR_RANDN_RTOL``; expr_casts on its counts and its
``bad_dec`` only: the JAX session's jitted ``ss_net_paid / 100 / 3``
multiplies by the reciprocals on XLA's CPU, so its doubles, their strings
and hashes differ from Spark's on many rows, ROADMAP C30, and its
string-to-double parse misses the nearest double on about one row in six,
ROADMAP C27; the port's ``bad_double`` is 0 and its hashes numpy's over its
own strings), with the JAX package's resident-bytes estimate of each bound
plan, and against chip_smoke's oracles;
expr_time, which joins, also under the budget that partitions its top
join into K = 16 (its rows compared by key with the JAX package's direct
answer)."""

import warnings

import numpy as np
import pytest

import chip_smoke
from datafusion_comet_tpu import types as JT
from datafusion_comet_tpu.exec import memory as JM
from datafusion_comet_tpu.ir import expr as JE
from datafusion_comet_tpu.ir import plan as JP
from datafusion_comet_tpu.models import tpcds as JTPCDS
from datafusion_comet_tpu_torch import types as PT
from datafusion_comet_tpu_torch.exec import memory as PM
from datafusion_comet_tpu_torch.ir import expr as PE
from datafusion_comet_tpu_torch.ir import plan as PP
from datafusion_comet_tpu_torch.models import tpcds
from _torch_threads import one_torch_thread  # noqa: F401 (a fixture)
from _torch_tpcds import sessions
from test_torch_q9 import same

pytestmark = pytest.mark.usefixtures("one_torch_thread")

SF = 0.01
TABLES = ("store_sales", "date_dim", "time_dim", "customer")
_DATA = {}


def _data():
    if not _DATA:
        _DATA.update({t: tpcds.generate_table(t, SF) for t in TABLES})
    return _DATA


def _plans(name):
    zone = chip_smoke.expr_zone()
    return (chip_smoke.expr_plans(PE, PP, PT, tpcds.SCHEMAS, zone)[name],
            chip_smoke.expr_plans(JE, JP, JT, JTPCDS.SCHEMAS, zone)[name])


_JAX_ANSWERS = {}


@pytest.mark.parametrize("name", ["expr_time", "expr_strings", "expr_casts", "expr_sample"])
def test_expr_plan_equals_jax_and_oracle(name):
    js, ps = sessions(_data())
    pplan, jplan = _plans(name)
    got, want = ps.collect(pplan), js.collect(jplan)
    _JAX_ANSWERS[name] = want
    oracle = chip_smoke.expr_oracles(_data())[name]()
    apart = {"expr_sample": ("g",), "expr_casts": ("bad_double", "mm3", "xx")}.get(name, ())
    if name == "expr_sample":
        np.testing.assert_allclose(got["g"], want["g"], rtol=chip_smoke.EXPR_RANDN_RTOL, atol=0)
    drop = set(apart) | {a + "__valid" for a in apart}
    same({k: v for k, v in want.items() if k not in drop},
         {k: v for k, v in got.items() if k not in drop})
    chip_smoke.check_expr(name, got, oracle, name, ps, _data())
    # the bound plans' resident-bytes estimates (concat's and lpad's static
    # widths among them) are the JAX package's
    assert PM.plan_peak_bytes(PP.bind_plan(pplan), 1 << 20) == \
        JM.plan_peak_bytes(JP.bind_plan(jplan), 1 << 20)


def test_expr_time_under_grace_equals_direct():
    """The port's run under the budget that splits its top join into K = 16
    equals its direct run and the JAX package's answer (rows by key)."""
    data = _data()
    _, direct_s = sessions(data)
    pplan, jplan = _plans("expr_time")
    direct = direct_s.collect(pplan)
    fraction, _ = chip_smoke.grace_fraction(direct_s, _plans("expr_time")[0], chip_smoke.GRACE_K)
    js, grace = sessions(data, fraction=fraction)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")  # an over-budget stage without a join proceeds
        got = grace.collect(_plans("expr_time")[0])
    assert chip_smoke.GRACE_K in [r.K for r in grace.grace_runners]
    want = _JAX_ANSWERS.get("expr_time") or js.collect(jplan)
    assert chip_smoke.same_rows(direct, got, ordered=False)
    assert chip_smoke.same_rows(want, got, ordered=False)

"""PyTorch port, TPC-H Q5 (five INNER joins over six tables, one of them on
two keys, grouped by the dictionary-coded ``n_name``) through the port's
``Session`` on the CPU, against the JAX ``Session`` on the same generated
data (SF 0.005 and 0.01, where the JAX package injects no runtime filter)
and the numpy oracle chip_smoke.py checks the card with:

- directly: values, order, the output's storage (narrow or two-limb and
  the magnitude bound of each column), the stages, each join's path (four
  dense unique builds, the packed two-key join on the compacted pair list)
  and one run of each stage;
- under the budget that makes the JAX package partition Q5's first join
  into K = 16: the same grace joins (K and mode) and partition sizes in
  both packages, and the same answer;
- the ``nation`` and ``region`` tables generate and stage as the JAX
  package's."""

import warnings

import numpy as np
import pytest

import chip_smoke
from datafusion_comet_tpu.exec import batch as JB
from datafusion_comet_tpu.ir import plan as JP
from datafusion_comet_tpu.models import tpch as JTPCH
from datafusion_comet_tpu_torch.conf import Config
from datafusion_comet_tpu_torch.exec import batch as PB
from datafusion_comet_tpu_torch.exec.engine import Session
from datafusion_comet_tpu_torch.models import tpch
from test_torch_grace import jax_fraction, jax_spy  # noqa: F401 (jax_spy: a fixture)
from test_torch_q9 import jax_session
from _torch_threads import one_torch_thread  # noqa: F401 (a fixture)

pytestmark = pytest.mark.usefixtures("one_torch_thread")

NAMES = ("lineitem", "orders", "customer", "supplier", "nation", "region")


@pytest.fixture(scope="module", params=[0.005, 0.01])
def q5_data(request):
    return request.param, tpch.generate_tables(NAMES, request.param)


def _sessions(data, conf=None):
    js = jax_session({t: data[t] for t in NAMES}, JTPCH.SCHEMAS, None)
    ps = Session(device="cpu", conf=conf)
    for t in NAMES:
        ps.register_numpy(t, data[t], tpch.SCHEMAS[t])
    return js, ps


def _oracle(data):
    return chip_smoke.oracle_q5(*(data[t] for t in NAMES), tpch._d("1994-01-01"),
                                tpch._d("1995-01-01"))


def _same(want, got):
    assert list(want) == list(got)
    for k in want:
        assert want[k].dtype == got[k].dtype, k
        np.testing.assert_array_equal(want[k], got[k], err_msg=k)


def _no_runtime_filters(stages):
    stack = [p for _, p in stages]
    while stack:
        p = stack.pop()
        assert not (isinstance(p, JP.HashJoin) and getattr(p, "rf_injected", None))
        stack.extend(p.children())


def test_q5_direct_matches_jax_and_oracle(q5_data):
    _, data = q5_data
    js, ps = _sessions(data)
    _no_runtime_filters(js._plan_stages(JTPCH.q5()))
    jb, pb = js.execute(JTPCH.q5()), ps.execute(tpch.q5())
    want, got = JB.to_numpy(jb), PB.to_numpy(pb)
    _same(want, got)
    for jc, pc, f in zip(jb.columns, pb.columns, pb.schema.fields):
        assert np.asarray(jc.data).ndim == pc.data.dim(), f.name
        assert jc.mag_bound == pc.mag_bound, f.name
    expect = _oracle(data)
    chip_smoke.check_q5(got, expect, "port")
    assert len(expect) == 5
    assert [n is None for n, _ in ps.stages] == [n is None for n, _ in
                                                 js._plan_stages(JTPCH.q5())] == [False, False,
                                                                                  True]
    assert [(r["scale"], r["overflowed"], [j["path"] for j in r["joins"]])
            for r in ps.runs] == [(1, False, ["dense_unique", "dense_unique"]),
                                  (1, False, ["dense_unique", "dense_unique"]),
                                  (1, False, ["pair_list"])]
    assert [j["pack"] for r in ps.runs for j in r["joins"]] == [False] * 4 + [True]


def test_q5_grace_matches_jax(q5_data, jax_spy):
    """Q5's first join (lineitem and orders, then customer) partitioned into
    K = 16 in both packages; its left input, the lineitem-orders join, over
    the budget as well, partitioned alike in both."""
    _, data = q5_data
    js, direct = _sessions(data)
    fraction, _ = chip_smoke.grace_fraction(direct, tpch.q5(), 16)
    _, grace = _sessions(data, Config(memory_fraction=fraction))
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        got = grace.collect(tpch.q5())
    with jax_fraction(fraction):
        want = js.collect(JTPCH.q5())
    _same(want, got)
    chip_smoke.check_q5(got, _oracle(data), "port grace")
    # the JAX spy lists runners as they start, the port as they finish: the
    # outer join's runner starts first and finishes last
    ports = grace.grace_runners[::-1]
    assert [(r.K, r.downstream and r.downstream[0]) for r in ports] == list(jax_spy)
    assert ports[0].K == 16 and len(ports) == len(jax_spy.sizes)
    for r, sizes in zip(grace.grace_runners, jax_spy.sizes):
        for got_sizes, want_sizes in zip(r.sizes, sizes):
            np.testing.assert_array_equal(got_sizes, want_sizes)
    assert jax_spy.pair_retries() == [r.retries for r in ports]


@pytest.mark.parametrize("name", ["nation", "region"])
def test_nation_region_generate_and_stage_as_jax(name):
    j, p = JTPCH.generate_table(name, 1), tpch.generate_table(name, 1)
    _same(j, p)
    jb = JB.from_numpy(j, JTPCH.SCHEMAS[name])
    pb = PB.from_numpy(p, tpch.SCHEMAS[name], "cpu")
    for jc, pc, f in zip(jb.columns, pb.columns, pb.schema.fields):
        assert (jc.dictionary is None) == (pc.dictionary is None), f.name
        np.testing.assert_array_equal(np.asarray(jc.data), pc.data.numpy(), err_msg=f.name)
    assert pb.column({"nation": "n_name", "region": "r_name"}[name]).dictionary is not None

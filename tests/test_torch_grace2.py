"""PyTorch port, the grace join of fact/dim joins with an aggregate above
(partial and local modes, an ungrouped one, none, duplicate build keys past
the fan-out, a TIMESTAMP key), exactly against the JAX package: the same K
and mode, no pair re-runs, the same rows. Continued from
``test_torch_grace.py`` (its helpers; a file runs on one worker)."""

import warnings

import pytest

import chip_smoke
from datafusion_comet_tpu import types as JT
from datafusion_comet_tpu.ir import expr as JE
from datafusion_comet_tpu.ir import plan as JP
from datafusion_comet_tpu_torch import types as PT
from datafusion_comet_tpu_torch.ir import expr as PE
from datafusion_comet_tpu_torch.ir import plan as PP
from test_torch_grace import (_assert_same, _fact_dim, _jax_session, _join, _port_session,
                              _rows, jax_fraction, jax_spy)  # noqa: F401 (a fixture)
from _torch_threads import one_torch_thread  # noqa: F401 (a fixture)

pytestmark = pytest.mark.usefixtures("one_torch_thread")


@pytest.mark.parametrize("how,dup,key_type,mode", [
    ("agg", 1, "INT64", "partial"),
    ("agg", 6, "INT64", "partial"),  # K = 16 from the statistics: no pair re-runs
    ("ungrouped", 1, "INT64", "partial"),
    ("local", 1, "INT8", "local"),
    ("agg", 1, "TIMESTAMP", "partial"),
    ("plain", 3, "INT64", None),
])
def test_fact_dim_grace_matches_jax(jax_spy, how, dup, key_type, mode):
    ptables = _fact_dim(PT, dup=dup, key_type=key_type)
    jtables = _fact_dim(JT, dup=dup, key_type=key_type)
    js = _jax_session(jtables)
    want = js.collect(_join(JT, JP, JE, jtables, how))
    # the port's dense aggregate takes the INT8 key's 512 buckets
    conf = {"agg_dense_max_domain": 1024} if key_type == "INT8" else {}
    direct = _port_session(ptables, **conf)
    plan = _join(PT, PP, PE, ptables, how)
    fraction, _ = chip_smoke.grace_fraction(direct, plan, 16)
    grace = _port_session(ptables, fraction, **conf)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        got = grace.collect(plan)
    (runner,) = grace.grace_runners
    assert (runner.K, runner.downstream and runner.downstream[0]) == (16, mode)
    with jax_fraction(fraction):
        got_jax = js.collect(_join(JT, JP, JE, jtables, how))
    assert jax_spy == [(16, mode)]
    assert jax_spy.pair_retries() == [runner.retries] == [0]
    if how in ("plain", "local"):  # no sort: the union keeps partition order
        assert _rows(got) == _rows(want) == _rows(got_jax)
        assert _rows(direct.collect(plan)) == _rows(want)
        if how == "local":
            _assert_same(got_jax, got)
    else:
        _assert_same(want, got)
        _assert_same(want, got_jax)
        _assert_same(want, direct.collect(plan))

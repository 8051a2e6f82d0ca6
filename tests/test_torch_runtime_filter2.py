"""PyTorch port, the runtime semi-join filters against the JAX package,
continued from ``test_torch_runtime_filter.py`` (its fixtures and helpers;
a file runs on one worker):

- With ``runtime_filter_enabled=False`` in the port and
  ``comet.exec.runtimeFilter.enabled`` off in the JAX package, both plan
  without any, alike, and the port's answer is the same.
- Q3 and Q10 with their filters under the budget that partitions the top
  join into K = 16: the same K, modes, partition sizes and pair retries,
  the same answer."""

import warnings

import numpy as np
import pytest

import chip_smoke
from datafusion_comet_tpu.ir import plan as JP
from datafusion_comet_tpu.models import tpch as JTPCH
from datafusion_comet_tpu_torch.ir import plan as PP
from datafusion_comet_tpu_torch.models import tpch
from test_torch_grace import jax_fraction, jax_spy  # noqa: F401 (a fixture)
from test_torch_q9 import rf_hints, same
from test_torch_runtime_filter import (CASES, GRACE_K, _injected, _sessions,  # noqa: F401
                                       data, jax_runtime_filters)
from _torch_threads import one_torch_thread  # noqa: F401 (a fixture)

pytestmark = pytest.mark.usefixtures("one_torch_thread")


@pytest.mark.parametrize("q,sf", CASES)
def test_disabled_gives_the_old_plans(data, q, sf):
    """Both packages with the filters off: no injected join, the same hints
    stage by stage; the port's answer equals its answer with the filter."""
    js, ps = _sessions(data[sf], enabled=False)
    with jax_runtime_filters(False):
        want_stages = js._plan_stages(getattr(JTPCH, q)())
    got_stages = ps._plan_stages(getattr(tpch, q)())
    assert not _injected(want_stages, JP) and not _injected(got_stages, PP)
    assert rf_hints(got_stages, PP) == rf_hints(want_stages, JP)
    _, on = _sessions({}, enabled=True)
    for t, b in ps.tables.items():
        on.register_batch(t, b)
    on.stats.update(ps.stats)
    same(on.collect(getattr(tpch, q)()), ps.collect(getattr(tpch, q)()))
    assert _injected(on.stages, PP) and not _injected(ps.stages, PP)



@pytest.mark.parametrize("q", ["q3", "q10"])
def test_grace_with_its_filter_matches_jax(data, jax_spy, q):
    """The query's top join partitioned into K = 16 over the lineitem side
    the runtime filter thinned: K, modes, partition sizes, pair retries and
    the answer equal the JAX package's, and the oracle. Q10's filter
    estimate is 4x low (ROADMAP C11): in both packages its input stage and
    each of the 16 pairs run again once."""
    tables = data[0.02]
    _, direct = _sessions(tables)
    fraction, _ = chip_smoke.grace_fraction(direct, getattr(tpch, q)(), GRACE_K)
    assert _injected(direct._plan_stages(getattr(tpch, q)()), PP)
    js, grace = _sessions(tables, fraction)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        got = grace.collect(getattr(tpch, q)())
    with jax_fraction(fraction):
        want = js.collect(getattr(JTPCH, q)())
    same(want, got)
    li, od, cu = tables["lineitem"], tables["orders"], tables["customer"]
    if q == "q3":
        chip_smoke.check_q3(got, chip_smoke.oracle_q3(li, od, cu, tpch._d("1995-03-15")), q)
    else:
        chip_smoke.check_q10(got, chip_smoke.oracle_q10(li, od, cu, tables["nation"],
                                                        tpch._d("1993-10-01"),
                                                        tpch._d("1994-01-01")), q)
    assert _injected(grace.stages, PP)
    ports = sorted(grace.grace_runners, key=lambda r: int(r.tmp[len("__grace"):]))
    assert [(r.K, r.downstream and r.downstream[0]) for r in ports] == list(jax_spy)
    assert GRACE_K in [r.K for r in ports]
    for r, sizes in zip(grace.grace_runners, jax_spy.sizes):
        for got_sizes, want_sizes in zip(r.sizes, sizes):
            np.testing.assert_array_equal(got_sizes, want_sizes)
    assert jax_spy.pair_retries() == [r.retries for r in ports]
    if q == "q10":
        assert [r.retries for r in ports] == [1, 0]
        assert sum(r["overflowed"] for r in grace.runs if r["where"] == "pair") == GRACE_K

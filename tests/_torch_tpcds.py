"""Helpers of the TPC-DS parity tests (``tests/test_torch_tpcds_*.py``): the
port's ``Session`` on the CPU against the JAX ``Session`` on the same
generated tables, query by query.

``SCALES`` gives each ported query the smallest of SF 0.02, 0.1 and 1 at
which its answer has rows (q34 is empty at every scale, ROADMAP C18: it
runs at SF 0.02 and its answer is held empty). Tables come from the port's
generator, which the generator test holds bit-equal to the JAX one's, and
are made once per (table, scale) in a process, and staged for the JAX
package once per string layout (`test_torch_q9.jax_session`). A query of
``tpcds.NEEDS_SESSION`` (q88) builds its plan for the session that runs it
(``plans``), and its scalar subqueries' runs count among its attempts in
the JAX package's order (``attempts``)."""

import copy
import warnings

import numpy as np

import chip_smoke
from datafusion_comet_tpu.exec import batch as JB
from datafusion_comet_tpu.ir import plan as JP
from datafusion_comet_tpu.models import tpcds as JTPCDS
from datafusion_comet_tpu_torch.conf import Config
from datafusion_comet_tpu_torch.exec import batch as PB
from datafusion_comet_tpu_torch.exec.engine import Session
from datafusion_comet_tpu_torch.ir import plan as PP
from datafusion_comet_tpu_torch.models import tpcds
from test_torch_grace import jax_fraction
from test_torch_q9 import STAGING, jax_session, rf_hints, same

# the queries whose answer is empty at SF 0.02 and has rows at SF 0.1
_AT_01 = ("q8", "q31", "q50", "q64", "q91")
# the queries whose answer is empty at SF 0.02 and SF 0.1 and has rows at SF 1
_AT_1 = ("q3", "q19", "q25")
SCALES = {q: 1.0 if q in _AT_1 else 0.1 if q in _AT_01 else 0.02 for q in tpcds.QUERIES}
EMPTY = ("q34",)

_TABLES = {}


def tables(q, sf=None):
    """The generated tables ``q`` reads, at its scale or at ``sf``."""
    sf = sf or SCALES[q]
    out = {}
    for t in tpcds.tables(q):
        if (t, sf) not in _TABLES:
            _TABLES[(t, sf)] = tpcds.generate_table(t, sf)
        out[t] = _TABLES[(t, sf)]
    return out


def sessions(data, staging="default", fraction=None):
    """(JAX Session, port Session on the CPU) with ``data`` registered in
    the staging's string layout, under ``fraction`` of the memory where
    given (the port's; the JAX one's is set by ``jax_fraction``)."""
    js = jax_session(data, JTPCDS.SCHEMAS, STAGING[staging])
    ps = Session(device="cpu", conf=Config(scan_dictionary_max_size=STAGING[staging],
                                           **({"memory_fraction": fraction} if fraction else {})))
    for t, d in data.items():
        ps.register_numpy(t, d, tpcds.SCHEMAS[t])
    return js, ps


def plans(q, js, ps):
    """(port plan, JAX plan) functions of ``q``, each built for its
    package's session where the query registers scalar subqueries."""
    jax_q = getattr(JTPCDS, q)
    if q in tpcds.NEEDS_SESSION:
        return (lambda: tpcds.plan(q, ps)), (lambda: jax_q(js))
    return tpcds.QUERIES[q], jax_q


def attempts(ps):
    """(growth scale, unique_join_ok) of the port's last run, in the order
    the JAX package compiles them: it runs the scalar subqueries inside the
    compile of the plan's first attempt."""
    runs = [(r["scale"], r["unique_join_ok"]) for r in ps.runs]
    subs = [(r["scale"], r["unique_join_ok"]) for s in ps.subqueries for r in s["runs"]]
    return runs[:1] + subs + runs[1:]


def subquery_hints(js, ps):
    """Each registered subquery's stage hints in both packages (the port's
    on a fresh copy of its plan, as its runs take)."""
    assert len(js._subqueries) == len(ps._subquery_plans)
    return ([rf_hints(ps._plan_stages(copy.deepcopy(ps.subquery_plan(i))), PP)
             for i in range(len(ps._subquery_plans))],
            [rf_hints(js._plan_stages(js._subqueries[i][0]), JP)
             for i in range(len(js._subqueries))])


def check_direct(q, jax_attempts, staging="default", sf=None):
    """``q`` run directly in both packages: hints stage by stage with the
    runtime filters' fields (its subqueries' too), values, order, storage,
    bounds and attempts. Returns the port's answer."""
    js, ps = sessions(tables(q, sf), staging)
    port_plan, jax_plan = plans(q, js, ps)
    assert rf_hints(ps._plan_stages(port_plan()), PP) == rf_hints(js._plan_stages(jax_plan()), JP)
    got_hints, want_hints = subquery_hints(js, ps)
    assert got_hints == want_hints
    jax_attempts.clear()
    jb, pb = js.execute(jax_plan()), ps.execute(port_plan())
    want, got = JB.to_numpy(jb), PB.to_numpy(pb)
    same(want, got)
    for jc, pc, f in zip(jb.columns, pb.columns, pb.schema.fields):
        assert np.asarray(jc.data).ndim == pc.data.dim(), f.name
        assert jc.mag_bound == pc.mag_bound, f.name
        assert (jc.lengths is None) == (pc.lengths is None), f.name
    assert attempts(ps) == jax_attempts
    rows = len(next(iter(got.values())))
    assert (rows == 0) == (q in EMPTY), (q, rows)
    if q in chip_smoke.TPCDS_ORACLES:  # the port, and so JAX, equal chip_smoke's oracle
        chip_smoke.check_tpcds(q, got, chip_smoke.TPCDS_ORACLES[q][0](tables(q, sf)), q)
    return got


def share(i: int, n: int = 5):
    """The ``i``-th of ``n`` shares of the queries but q88, which has a test
    file of its own, for a test file each (the tests run a file to a
    worker)."""
    return [q for q in tpcds.QUERIES if q not in tpcds.NEEDS_SESSION][i::n]


def check_grace(q, jax_spy, staging="default"):
    """``q`` under the budget that partitions its first stage's top join
    into K = 16, in both packages: the same K and modes, partition sizes
    and pair retries, and the same answer, which is the port's direct one
    (as multisets of rows where ``chip_smoke.TPCDS_TIED_ORDER`` names the
    query: its sort keys tie)."""
    data = tables(q)
    _, direct_s = sessions(data, staging)
    direct_plan = plans(q, None, direct_s)[0]
    direct = direct_s.collect(direct_plan())
    fraction, _ = chip_smoke.grace_fraction(direct_s, direct_plan(), chip_smoke.GRACE_K)
    js, grace = sessions(data, staging, fraction)
    port_plan, jax_plan = plans(q, js, grace)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        got = grace.collect(port_plan())
    with jax_fraction(fraction):
        want = js.collect(jax_plan())
    same(want, got)
    assert chip_smoke.same_rows(direct, got, ordered=q not in chip_smoke.TPCDS_TIED_ORDER), q
    runners = [r for s in grace.subqueries for r in s["grace_runners"]] + grace.grace_runners
    # a re-run over the budget is held to it in the port (ROADMAP R1): the
    # grace joins made for it have no counterpart in the JAX run, which
    # re-runs the stage whole; every other one is the JAX package's
    rebudgets = [b for s in grace.subqueries for b in s["rebudgets"]] + grace.rebudgets
    assert sorted((r.K, r.downstream and r.downstream[0]) for r in runners if r.rebudget) == \
        sorted(g for b in rebudgets for g in b["grace"])
    runners = [r for r in runners if not r.rebudget]
    ports = sorted(runners, key=lambda r: int(r.tmp[len("__grace"):]))
    assert [(r.K, r.downstream and r.downstream[0]) for r in ports] == list(jax_spy)
    assert chip_smoke.GRACE_K in [r.K for r in ports] and len(ports) == len(jax_spy.sizes)
    for r, sizes in zip(runners, jax_spy.sizes):
        for got_sizes, want_sizes in zip(r.sizes, sizes):
            np.testing.assert_array_equal(got_sizes, want_sizes)
    assert jax_spy.pair_retries() == [r.retries for r in ports]
    return grace

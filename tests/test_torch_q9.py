"""PyTorch port, TPC-H Q9 (the ``part`` and ``partsupp`` tables, LIKE
'%green%' over ``p_name``'s dictionary or its padded bytes, a packed two-key
join on partsupp, ``year`` of a date)
through the port's ``Session`` on the CPU, against the JAX ``Session`` on
the same generated data, with the default staging and with every string
padded (``dict_max_size=0``), and against the numpy oracles chip_smoke.py
checks the card with:

- directly: values, order, the output's storage and bounds, the planner's
  hints stage by stage (the runtime filters' fields included) and the
  retry attempts (a spy on the JAX ``Session.compile``);
- under the budget that makes the engine partition the first stage's top
  join into K = 16: the same grace joins (K and mode), partition sizes and
  pair retries in both packages, and the same answer.

Q9 (78 rows) runs at SF 0.01, where no runtime filter fires
(test_torch_runtime_filter.py runs it where one does). The helpers serve
Q2, Q19, Q7, Q8, Q11, Q14, Q17, Q13, Q16, Q20, Q21 and Q22 too (test_torch_q2.py and
the others; a plan variant registers its two builders in ``VARIANTS``);
every comparison is exact but that of a FLOAT64 column, held to the other
package's and to the oracle's within ``chip_smoke.FLOAT_SUM_RTOL``."""

import warnings

import numpy as np
import pytest

import chip_smoke
from datafusion_comet_tpu.exec import batch as JB
from datafusion_comet_tpu.exec.engine import Session as JaxSession
from datafusion_comet_tpu.ir import plan as JP
from datafusion_comet_tpu.models import tpch as JTPCH
from datafusion_comet_tpu_torch.conf import Config
from datafusion_comet_tpu_torch.exec import batch as PB
from datafusion_comet_tpu_torch.exec.engine import Session
from datafusion_comet_tpu_torch.ir import plan as PP
from datafusion_comet_tpu_torch.models import tpch
from test_torch_grace import jax_fraction, jax_spy  # noqa: F401 (a fixture)
from test_torch_hints import jax_attempts, stage_hints  # noqa: F401 (a fixture)
from _torch_threads import one_torch_thread  # noqa: F401 (a fixture, for the other files)

STAGING = {"default": 1 << 16, "padded": 0}
GRACE_K = 16

# per query: its tables, its scale, its oracle and check
QUERIES = {
    "q2": (("part", "supplier", "partsupp", "nation", "region"), 0.01,
           lambda d: chip_smoke.oracle_q2(d["part"], d["supplier"], d["partsupp"], d["nation"],
                                          d["region"]), chip_smoke.check_q2),
    "q9": (("lineitem", "orders", "part", "partsupp", "supplier", "nation"), 0.01,
           lambda d: chip_smoke.oracle_q9(d["lineitem"], d["part"], d["partsupp"],
                                          d["supplier"], d["orders"], d["nation"]),
           chip_smoke.check_q9),
    "q19": (("lineitem", "part"), 0.05,
            lambda d: chip_smoke.oracle_q19(d["lineitem"], d["part"]), chip_smoke.check_q19),
    "q7": (("lineitem", "supplier", "orders", "customer", "nation"), 0.01,
           lambda d: chip_smoke.oracle_q7(d["lineitem"], d["supplier"], d["orders"],
                                          d["customer"], d["nation"], tpch._d("1995-01-01"),
                                          tpch._d("1996-12-31")), chip_smoke.check_q7),
    # at SF 0.01 both shares are 0.0
    "q8": (("lineitem", "part", "orders", "customer", "supplier", "nation", "region"), 0.05,
           lambda d: chip_smoke.oracle_q8(d["lineitem"], d["part"], d["orders"], d["customer"],
                                          d["supplier"], d["nation"], d["region"],
                                          tpch._d("1995-01-01"), tpch._d("1996-12-31")),
           chip_smoke.check_q8),
    "q11": (("partsupp", "supplier", "nation"), 0.01,
            lambda d: chip_smoke.oracle_q11(d["partsupp"], d["supplier"], d["nation"],
                                            chip_smoke.Q11_FRACTION),
            chip_smoke.check_q11),
    "q14": (("lineitem", "part"), 0.01,
            lambda d: chip_smoke.oracle_q14(d["lineitem"], d["part"], tpch._d("1995-09-01"),
                                            tpch._d("1995-10-01")),
            lambda out, e, what: chip_smoke.check_scalar_f64(out, "promo_revenue", e, what)),
    "q17": (("lineitem", "part"), 0.01,
            lambda d: chip_smoke.oracle_q17(d["lineitem"], d["part"]),
            lambda out, e, what: chip_smoke.check_scalar_f64(out, "avg_yearly", e, what)),
    "q13": (("customer", "orders"), 0.01,
            lambda d: chip_smoke.oracle_q13(d["customer"], d["orders"]), chip_smoke.check_q13),
    "q16": (("part", "partsupp", "supplier"), 0.01,
            lambda d: chip_smoke.oracle_q16(d["part"], d["partsupp"], d["supplier"]),
            chip_smoke.check_q16),
    "q21": (("lineitem", "orders", "supplier", "nation"), 0.01,
            lambda d: chip_smoke.oracle_q21(d["lineitem"], d["orders"], d["supplier"],
                                            d["nation"]), chip_smoke.check_q21),
    "q22": (("customer", "orders"), 0.01,
            lambda d: chip_smoke.oracle_q22(d["customer"], d["orders"]), chip_smoke.check_q22),
}
# the rows of each query's answer at its scale
ROWS = {"q2": 3, "q9": 78, "q19": 1, "q7": 4, "q8": 2, "q11": 152, "q14": 1, "q17": 1,
        "q13": 25, "q16": 306, "q21": 3, "q22": 7}
# a query that is a variant of one of the packages' plans: its (port plan,
# JAX plan) builders (the others are the packages' ``tpch.<name>``)
VARIANTS = {}


def plans(q):
    """(port plan builder, JAX plan builder) of ``q``."""
    return VARIANTS[q] if q in VARIANTS else (getattr(tpch, q), getattr(JTPCH, q))


@pytest.fixture(scope="module")
def tables():
    """Generated tables by (name, scale), each made once."""
    cache = {}

    def get(q, sf=None):
        names, qsf = QUERIES[q][:2]
        sf = sf or qsf
        for t in names:
            if (t, sf) not in cache:
                cache[(t, sf)] = tpch.generate_table(t, sf)
        return {t: cache[(t, sf)] for t in names}

    return get


def rf_hints(stages, P):
    """``stage_hints`` plus each join's runtime-filter fields and
    condition-column ranges."""
    def joins(p):
        out = [p] if isinstance(p, P.HashJoin) else []
        for c in p.children():
            out += joins(c)
        return out

    return [(stage_hints([(name, sub)], P),
             [(getattr(j, "rf_dense_range", None), bool(getattr(j, "rf_injected", False)),
               getattr(j, "cond_col_ranges", None)) for j in joins(sub)])
            for name, sub in stages]


# a table's JAX statistics and staged batch by (name, string layout), with
# the numpy table they were made from: a new table of the name is staged anew
_JAX_STAGED = {}


def jax_session(data, schemas, dict_max_size):
    """A JAX Session with ``data`` registered. Each numpy table is staged
    (statistics and batch) once per string layout, and the sessions that
    register it again share the result: JAX arrays are immutable, and the
    staging is most of a session's set-up (6.4 s of Q8's at SF 0.05)."""
    js = JaxSession()
    for t, d in data.items():
        hit = _JAX_STAGED.get((t, dict_max_size))
        if hit is not None and hit[0] is d:
            js.stats[t], js.tables[t] = hit[1:]
        else:
            js.register_numpy(t, d, schemas[t], dict_max_size=dict_max_size)
            _JAX_STAGED[(t, dict_max_size)] = (d, js.stats[t], js.tables[t])
    return js


def sessions(data, staging, fraction=None):
    js = jax_session(data, JTPCH.SCHEMAS, STAGING[staging])
    ps = Session(device="cpu", conf=Config(scan_dictionary_max_size=STAGING[staging],
                                           **({"memory_fraction": fraction} if fraction else {})))
    for t, d in data.items():
        ps.register_numpy(t, d, tpch.SCHEMAS[t])
    return js, ps


def same(want, got):
    assert list(want) == list(got)
    for k in want:
        assert want[k].dtype == got[k].dtype, k
        if want[k].dtype == np.float64:
            np.testing.assert_allclose(got[k], want[k], rtol=chip_smoke.FLOAT_SUM_RTOL, atol=0,
                                       err_msg=k)
        else:
            np.testing.assert_array_equal(want[k], got[k], err_msg=k)


def direct(js, ps, q, jax_attempts):
    """Both packages' direct runs held to each other: the port's output."""
    port_plan, jax_plan = plans(q)
    want_stages = js._plan_stages(jax_plan())
    got_stages = ps._plan_stages(port_plan())
    assert rf_hints(got_stages, PP) == rf_hints(want_stages, JP)
    jax_attempts.clear()
    jb, pb = js.execute(jax_plan()), ps.execute(port_plan())
    want, got = JB.to_numpy(jb), PB.to_numpy(pb)
    same(want, got)
    for jc, pc, f in zip(jb.columns, pb.columns, pb.schema.fields):
        assert np.asarray(jc.data).ndim == pc.data.dim(), f.name
        assert jc.mag_bound == pc.mag_bound, f.name
        assert (jc.lengths is None) == (pc.lengths is None), f.name
    assert [(r["scale"], r["unique_join_ok"]) for r in ps.runs] == jax_attempts
    return got


@pytest.mark.parametrize("staging", list(STAGING))
def test_q9_direct_matches_jax_and_oracle(tables, jax_attempts, staging):
    check_direct(tables, jax_attempts, "q9", staging)


def check_direct(tables, jax_attempts, q, staging):
    data = tables(q)
    js, ps = sessions(data, staging)
    got = direct(js, ps, q, jax_attempts)
    expect = QUERIES[q][2](data)
    QUERIES[q][3](got, expect, q)
    rows = expect[1] if q == "q11" else expect
    assert ROWS[q] == (len(rows) if isinstance(rows, list) else 1)
    if q == "q19":
        assert expect == 1_451_737_474
    if q in ("q2", "q9"):  # LIKE over codes, or over padded bytes (p_name from SF1 up)
        col = "p_type" if q == "q2" else "p_name"
        assert ps.tables["part"].column(col).is_dict == (staging == "default")


@pytest.mark.parametrize("staging", list(STAGING))
def test_q9_grace_matches_jax(tables, jax_spy, staging):
    check_grace(tables, jax_spy, "q9", staging)


def check_grace(tables, jax_spy, q, staging):
    """The first stage's top join partitioned into K = 16 in both packages
    (and any join the runner's inputs hold over the budget as well): the
    same K, modes, partition sizes and pair retries, and the same answer,
    equal to the oracle."""
    data = tables(q)
    port_plan, jax_plan = plans(q)
    _, direct_s = sessions(data, staging)
    fraction, _ = chip_smoke.grace_fraction(direct_s, port_plan(), GRACE_K)
    js, grace = sessions(data, staging, fraction)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        got = grace.collect(port_plan())
    with jax_fraction(fraction):
        want = js.collect(jax_plan())
    same(want, got)
    QUERIES[q][3](got, QUERIES[q][2](data), f"{q} grace")
    ports = sorted(grace.grace_runners, key=lambda r: int(r.tmp[len("__grace"):]))
    assert [(r.K, r.downstream and r.downstream[0]) for r in ports] == list(jax_spy)
    assert GRACE_K in [r.K for r in ports] and len(ports) == len(jax_spy.sizes)
    for r, sizes in zip(grace.grace_runners, jax_spy.sizes):
        for got_sizes, want_sizes in zip(r.sizes, sizes):
            np.testing.assert_array_equal(got_sizes, want_sizes)
    assert jax_spy.pair_retries() == [r.retries for r in ports]

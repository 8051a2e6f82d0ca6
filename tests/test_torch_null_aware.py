"""PyTorch port, the null-aware anti join (LEFT_ANTI_NULL_AWARE, Spark's
plan of ``NOT IN (subquery)``; exec/operators/join.py) against the JAX
package and against NOT IN's semantics:

- build keys with no null: the rows of LEFT_ANTI but the probe rows whose
  key is null, which NOT IN never passes;
- a live null build key: no probe row passes (a dead row's null key does
  not count);
- on the membership bitmap (the build key's statistics range), the sorted
  build (no statistics), a condition the min/max pushdown takes (dense and
  sorted) and one it does not (the pairs): the JAX package's rows, which it
  finds on its sorted path;
- TPC-H Q16 with its NOT IN as the null-aware join: JAX's Q16 (a plain
  LEFT_ANTI there, as s_suppkey is never null) at SF 0.01;
- the grace join refuses it, as the JAX package's does."""

import numpy as np
import pytest

from datafusion_comet_tpu import types as JT
from datafusion_comet_tpu.exec.engine import Session as JaxSession
from datafusion_comet_tpu.ir import expr as JE
from datafusion_comet_tpu.ir import plan as JP
from datafusion_comet_tpu.models import tpch as JTPCH
from datafusion_comet_tpu_torch import types as PT
from datafusion_comet_tpu_torch.exec import grace as G
from datafusion_comet_tpu_torch.exec.engine import Session
from datafusion_comet_tpu_torch.exec.operators import join as PJ
from datafusion_comet_tpu_torch.ir import expr as PE
from datafusion_comet_tpu_torch.ir import plan as PP
from datafusion_comet_tpu_torch.models import tpch
from test_torch_smj import _same
from _torch_threads import one_torch_thread  # noqa: F401 (a fixture)

pytestmark = pytest.mark.usefixtures("one_torch_thread")

PKG = {"jax": (JT, JE, JP, JaxSession), "port": (PT, PE, PP, lambda: Session(device="cpu"))}
NAA = "left_anti_null_aware"


def _schemas(M):
    return (M.Schema([M.Field("fk", M.INT64), M.Field("x", M.INT64, False)]),
            M.Schema([M.Field("pk", M.INT64), M.Field("w", M.INT64, False)]))


def _sessions(build_null: str, stats: bool = True):
    """``build_null``: "none", "live" (a live dim row with a null key) or
    "dead" (the null key's row filtered out by the plan, ``w`` < 0)."""
    rng = np.random.default_rng(9)
    nf, nd = 500, 60
    fact = {"fk": rng.integers(0, 80, nf).astype(np.int64), "x": np.arange(nf, dtype=np.int64)}
    dim = {"pk": rng.choice(80, nd, replace=False).astype(np.int64),
           "w": np.arange(nd, dtype=np.int64)}
    dvalid = np.ones(nd, bool)
    if build_null != "none":
        dvalid[7] = False
        if build_null == "dead":
            dim["w"][7] = -1
    out = {}
    for pkg, (M, _, _, mk) in PKG.items():
        s = mk()
        fs, ds = _schemas(M)
        s.register_numpy("fact", fact, fs, validity={"fk": np.arange(nf) % 9 != 0})
        s.register_numpy("dim", dim, ds, validity={"pk": dvalid})
        if not stats and pkg == "port":
            del s.stats["dim"]
        out[pkg] = s
    return out


def _plan(pkg, join_type=NAA, cond=None):
    M, E, P, _ = PKG[pkg]
    fs, ds = _schemas(M)
    dim = P.Scan("dim", ds).filter(E.col("w") >= E.lit(0))
    c = {None: None,
         "pushdown": E.col("x") > E.col("w"),          # one comparison with a build column
         "pairs": (E.col("x") + E.col("w")) > E.lit(300)}[cond]
    return P.HashJoin(P.Scan("fact", fs), dim, (E.col("fk"),), (E.col("pk"),), join_type,
                      "right", c)


@pytest.mark.parametrize("stats", [True, False], ids=["bitmap", "sorted"])
@pytest.mark.parametrize("build_null", ["none", "live", "dead"])
def test_not_in_semantics_and_jax(build_null, stats):
    ss = _sessions(build_null, stats)
    before = dict(PJ.hash_join.semi_paths)
    got = ss["port"].collect(_plan("port"))
    path = [k for k, v in PJ.hash_join.semi_paths.items() if v != before[k]]
    assert path == ["bitmap" if stats else "sorted"]
    _same(ss["jax"].collect(_plan("jax")), got)
    anti = ss["port"].collect(_plan("port", "left_anti"))
    if build_null == "live":
        assert len(got["x"]) == 0
    else:  # LEFT_ANTI's rows but the null probe keys
        keep = anti["fk__valid"]
        assert list(got["x"]) == list(anti["x"][keep]) and len(got["x"]) < len(anti["x"])


@pytest.mark.parametrize("cond", ["pushdown", "pairs"])
@pytest.mark.parametrize("build_null", ["none", "live"])
@pytest.mark.parametrize("stats", [True, False], ids=["dense", "sorted"])
def test_with_a_condition_matches_jax(cond, build_null, stats):
    ss = _sessions(build_null, stats)
    before = dict(PJ.hash_join.semi_paths)
    got = ss["port"].collect(_plan("port", cond=cond))
    path = [k for k, v in PJ.hash_join.semi_paths.items() if v != before[k]]
    assert path == [("minmax_dense" if stats else "minmax_sorted") if cond == "pushdown"
                    else "pairs"]
    _same(ss["jax"].collect(_plan("jax", cond=cond)), got)


def test_q16_not_in_matches_jax():
    names = ("part", "partsupp", "supplier")
    data = tpch.generate_tables(names, 0.01)
    js, ps = JaxSession(), Session(device="cpu")
    for t in names:
        js.register_numpy(t, data[t], JTPCH.SCHEMAS[t])
        ps.register_numpy(t, data[t], tpch.SCHEMAS[t])
    got = ps.collect(tpch.q16(null_aware=True))
    assert len(got["supplier_cnt"]) > 0
    _same(js.collect(JTPCH.q16()), got)
    _same(ps.collect(tpch.q16()), got)


def test_grace_refuses_the_null_aware_join():
    ss = _sessions("none")
    ps = ss["port"]
    bound = PP.bind_plan(_plan("port"))
    assert G.find_grace_join(bound, ps.tables, 1) is None
    plain = PP.bind_plan(_plan("port", "left_anti"))
    assert G.find_grace_join(plain, ps.tables, 1) is not None

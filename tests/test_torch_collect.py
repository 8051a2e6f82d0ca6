"""The port's collect_list / collect_set and the percentile list against
the JAX package on the CPU: SINGLE mode equals the JAX ``Session`` (lists
in input order, sets in value order; null values skipped), the C31
truncation at ``max_elems`` 4 drops the same values in both; PARTIAL and
FINAL (which the JAX package cannot run: it has no collect state and
raises) equal a Python oracle, as do collects under the grace join (K =
16) and the tiled aggregate; ``percentile(x, array(p...))`` equals the JAX
package's ARRAY<DOUBLE>."""

import numpy as np
import pytest

from datafusion_comet_tpu import types as JT
from datafusion_comet_tpu.exec.engine import Session as JaxSession
from datafusion_comet_tpu.ir import expr as JE
from datafusion_comet_tpu.ir import plan as JP
from datafusion_comet_tpu_torch import types as PT
from datafusion_comet_tpu_torch.conf import Config
from datafusion_comet_tpu_torch.exec.engine import Session
from datafusion_comet_tpu_torch.ir import expr as PE
from datafusion_comet_tpu_torch.ir import plan as PP
from _torch_nested import canon
from _torch_threads import one_torch_thread  # noqa: F401 (a fixture)

pytestmark = pytest.mark.usefixtures("one_torch_thread")

PKGS = {"jax": (JE, JP, JT), "port": (PE, PP, PT)}
N = 400


def _data():
    rng = np.random.default_rng(11)
    v = rng.integers(0, 12, N).astype(np.int64)
    valid = rng.random(N) > 0.1
    return ({"g": rng.integers(0, 9, N).astype(np.int64), "v": v,
             "f": np.where(rng.random(N) < 0.05, np.nan, rng.normal(size=N)),
             "s": np.array([f"w{int(x) % 5}" for x in v], dtype=object)},
            {"v": valid})


def _schema(T):
    return T.Schema([T.Field("g", T.INT64), T.Field("v", T.INT64), T.Field("f", T.FLOAT64),
                     T.Field("s", T.string(4))])


@pytest.fixture(scope="module")
def sessions():
    data, validity = _data()
    js, ps = JaxSession(), Session(device="cpu")
    js.register_numpy("t", data, _schema(JT), validity=validity, dict_max_size=0)
    ps.register_numpy("t", data, _schema(PT), validity=validity)
    return js, ps, data, validity


def _aggs(E, cap, funcs=("collect_list", "collect_set")):
    out = []
    for f in funcs:
        for c in ("v", "s"):
            out.append(E.AggExpr(f, E.col(c), f"{f}_{c}", max_elems=cap))
    return out


def _by_group(out, names):
    order = np.argsort(out["g"], kind="stable")
    return {n: [canon(out[n][i]) for i in order] for n in ["g"] + names}


def _oracle(data, validity, cap, funcs):
    """{group: {name: list}} in Python: input order, the set in value order."""
    want = {}
    for g in sorted(set(data["g"].tolist())):
        rows = [i for i in range(N) if data["g"][i] == g]
        d = {}
        for f in funcs:
            for c in ("v", "s"):
                vals = [data[c][i].item() if c == "v" else data[c][i] for i in rows
                        if (validity["v"][i] if c == "v" else True)]
                if f == "collect_set":
                    vals = sorted(set(vals))
                d[f"{f}_{c}"] = vals[:cap]
        want[g] = d
    return want


@pytest.mark.parametrize("cap", [16, 4], ids=["unbounded", "c31_truncated"])
def test_single_mode_equals_jax(sessions, cap):
    """At 16 no group is cut; at 4 both packages drop the same values past
    the cap (ROADMAP C31), which the oracle cuts too."""
    js, ps, data, validity = sessions
    outs = {}
    for name, sess in (("jax", js), ("port", ps)):
        E, P, T = PKGS[name]
        plan = P.Scan("t", _schema(T)).aggregate([E.col("g")], _aggs(E, cap))
        outs[name] = sess.collect(plan)
    names = [a.out_name for a in _aggs(PE, cap)]
    assert _by_group(outs["port"], names) == _by_group(outs["jax"], names)
    want = _oracle(data, validity, cap, ("collect_list", "collect_set"))
    got = _by_group(outs["port"], names)
    for i, g in enumerate(got["g"]):
        for n in names:
            assert got[n][i] == want[g][n], (g, n)
    if cap == 4:
        assert any(len(v) > 4 for d in _oracle(data, validity, 99, ("collect_list",)).values()
                   for v in d.values())


def test_partial_and_final_modes_equal_python(sessions):
    """PARTIAL emits each group's list as its state; FINAL over the states
    of two halves merges them in order. The JAX package raises in those
    modes."""
    js, ps, data, validity = sessions
    E, P, T = PE, PP, PT
    aggs = _aggs(E, 16)
    half = (E.col("v") < 6) | E.col("v").is_null()
    parts = [P.Scan("t", _schema(T)).filter(c).aggregate([E.col("g")], aggs, P.AggMode.PARTIAL)
             for c in (half, ~half)]
    final = P.Union(tuple(parts)).aggregate([E.col("g")], aggs, P.AggMode.FINAL)
    out = ps.collect(final)
    names = [a.out_name for a in aggs]
    got = _by_group(out, names)
    lo = [i for i in range(N) if not validity["v"][i] or data["v"][i] < 6]
    order = lo + [i for i in range(N) if i not in set(lo)]
    d2 = {k: v[order] for k, v in data.items()}
    want = _oracle(d2, {"v": validity["v"][order]}, 16, ("collect_list", "collect_set"))
    for i, g in enumerate(got["g"]):
        for n in names:
            assert got[n][i] == want[g][n], (g, n)
    with pytest.raises(NotImplementedError):
        js.collect(JP.Scan("t", _schema(JT)).aggregate([JE.col("g")], _aggs(JE, 16),
                                                       JP.AggMode.PARTIAL))


def test_collect_under_grace_and_tiled_equals_direct(sessions):
    """A collect over a join partitioned by the grace join (K = 16, partial
    mode: its states merge in FINAL) and a collect aggregate run tiled give
    the direct run's lists (as multisets: the pairs' order is theirs)."""
    _, ps, data, validity = sessions
    E, P, T = PE, PP, PT
    dim = {"k": np.arange(12, dtype=np.int64), "w": np.arange(12, dtype=np.int64) * 3}
    dsch = T.Schema([T.Field("k", T.INT64), T.Field("w", T.INT64)])
    ps.register_numpy("d", dim, dsch)
    join = P.HashJoin(P.Scan("t", _schema(T)), P.Scan("d", dsch), (E.col("v"),), (E.col("k"),),
                      "inner")
    plan = join.aggregate([E.col("g")], [E.AggExpr("collect_list", E.col("w"), "lw",
                                                   max_elems=64)])
    direct = ps.collect(plan)
    from datafusion_comet_tpu_torch.tools.query_times import grace_fraction

    gs = Session(device="cpu", conf=Config(memory_fraction=grace_fraction(ps, plan, 16)[0]))
    gs.tables, gs.stats = ps.tables, ps.stats
    graced = gs.collect(plan)
    assert gs.grace_runners and gs.grace_runners[0].K == 16

    def sets(out):
        return {g: sorted(v) for g, v in zip(out["g"].tolist(), out["lw"])}

    assert sets(graced) == sets(direct)
    agg = P.Scan("t", _schema(T)).aggregate([E.col("g")], _aggs(E, 64, ("collect_list",)))
    direct = ps.collect(agg)
    ts = Session(device="cpu", conf=Config(memory_fraction=1e-6))
    ts.tables, ts.stats = ps.tables, ps.stats
    tiled = ts.collect(agg)
    assert ts.tiled and ts.tiled[0][1] > 1
    for n in ("collect_list_v", "collect_list_s"):
        a = {g: canon(v) for g, v in zip(direct["g"].tolist(), direct[n])}
        b = {g: canon(v) for g, v in zip(tiled["g"].tolist(), tiled[n])}
        assert a == b, n


def test_percentile_list_equals_jax(sessions):
    """percentile(x, array(p1..pk)) is an ARRAY<DOUBLE> of k in both."""
    js, ps, _, _ = sessions
    outs = {}
    for name, sess in (("jax", js), ("port", ps)):
        E, P, T = PKGS[name]
        pct = E.lit([0.25, 0.5, 0.9], T.list_(T.FLOAT64, 3))
        aggs = [E.AggExpr("percentile", E.col(c), f"p_{c}", extra=(pct,)) for c in ("v", "f")]
        outs[name] = sess.collect(P.Scan("t", _schema(T)).aggregate([E.col("g")], aggs))
    assert _by_group(outs["port"], ["p_v", "p_f"]) == _by_group(outs["jax"], ["p_v", "p_f"])
    assert all(len(v) == 3 for v in outs["port"]["p_v"])

"""PyTorch port, the Window operator (``exec/operators/window.py``) against
the JAX package's ``window_op``, through both packages' ``Session`` on the
CPU, on one seeded batch: every ranking function, lag and lead with and
without a default, nth_value, and count, sum, avg, min, max, first and last
over every frame shape (ROWS running, RANGE running over peers, the whole
partition, bounded ROWS, RANGE with value offsets, ascending and
descending). The batch has nulls in the partition key, the order key and
every value column, tied order keys and dead rows (a filter under the
window); partitions are keyed by an integer, a dictionary string, a padded
string, an expression (an ``if_`` with a null padded else branch, as
TPC-DS q36/q70/q86) or nothing. Values, storage and bounds are held equal
(FLOAT64 within ``chip_smoke.FLOAT_SUM_RTOL``).

Where the port follows Spark and the JAX package does not (ROADMAP C20),
the port is held to a Python oracle instead: ROWS frames with one unbounded
end, AVG over a decimal, a running FIRST over a RANGE frame. A float sum
over a partition after one of huge magnitude is held to ``math.fsum``
(the JAX package's prefix difference loses it, as C12 for aggregates). The
engine's treatment of a Window is pinned too: pruning, statistics, the
memory estimate, the sort elision above it and the runtime filters of
TPC-DS q70 (a window inside a semi join's build side)."""

import math

import numpy as np
import pytest

from datafusion_comet_tpu import types as JT
from datafusion_comet_tpu.exec import batch as JB
from datafusion_comet_tpu.exec import memory as JM
from datafusion_comet_tpu.exec.engine import Session as JaxSession
from datafusion_comet_tpu.ir import expr as JE
from datafusion_comet_tpu.ir import plan as JP
from datafusion_comet_tpu.ir import pruning as JPR
from datafusion_comet_tpu.models import tpcds as JTPCDS
from datafusion_comet_tpu_torch import types as PT
from datafusion_comet_tpu_torch.conf import Config
from datafusion_comet_tpu_torch.exec import batch as PB
from datafusion_comet_tpu_torch.exec import memory as PM
from datafusion_comet_tpu_torch.exec.engine import Session
from datafusion_comet_tpu_torch.ir import expr as PE
from datafusion_comet_tpu_torch.ir import plan as PP
from datafusion_comet_tpu_torch.ir import pruning as PPR
from datafusion_comet_tpu_torch.models import tpcds
from test_torch_q9 import rf_hints, same
from _torch_threads import one_torch_thread  # noqa: F401 (a fixture)

pytestmark = pytest.mark.usefixtures("one_torch_thread")

N = 160
_rng = np.random.default_rng(1414)
STRINGS = np.array(["a", "bb", "ccc", "dd", "e", "ffffffff"], object)
DATA = {
    "i": np.arange(N, dtype=np.int64),
    "keep": _rng.random(N) > 0.15,  # the filter's dead rows
    "g": _rng.integers(0, 4, N).astype(np.int32),
    "k": _rng.integers(0, 20, N).astype(np.int32),
    "x": _rng.integers(-50, 50, N).astype(np.int64),
    "f": np.round(_rng.normal(0, 100, N), 3),
    "d": _rng.integers(-99999, 99999, N).astype(np.int64),
    "s": STRINGS[_rng.integers(0, len(STRINGS), N)],
}
VALID = {c: _rng.random(N) > 0.1 for c in ("g", "k", "x", "f", "d")}


def schema(T):
    return T.Schema([T.Field("i", T.INT64), T.Field("keep", T.BOOL), T.Field("g", T.INT32),
                     T.Field("k", T.INT32), T.Field("x", T.INT64), T.Field("f", T.FLOAT64),
                     T.Field("d", T.decimal(7, 2)), T.Field("s", T.string(8))])


def _run(pkg, make_wexprs, staging, data, valid, sch):
    """One package's Window(Filter(Scan)) over ``data`` with the window
    expressions ``make_wexprs(E, T)`` builds: (batch, collected answer)."""
    dmax = 0 if staging == "padded" else 1 << 16
    if pkg == "jax":
        E, P, T, B, sess = JE, JP, JT, JB, JaxSession()
        sess.register_numpy("t", data, sch(T), validity=valid, dict_max_size=dmax)
    else:
        E, P, T, B = PE, PP, PT, PB
        sess = Session(device="cpu", conf=Config(scan_dictionary_max_size=dmax))
        sess.register_numpy("t", data, sch(T), validity=valid)
    b = sess.execute(P.Window(P.Scan("t", sch(T)).filter(E.col("keep")),
                              tuple(make_wexprs(E, T))))
    return b, B.to_numpy(b)


def run_both(make_wexprs, staging="dict", data=DATA, valid=VALID, sch=schema):
    """Both packages' answers (JAX's, the port's), their storage and bounds
    held equal."""
    (jb, want), (pb, got) = (_run(pkg, make_wexprs, staging, data, valid, sch)
                             for pkg in ("jax", "port"))
    for jc, pc, f in zip(jb.columns, pb.columns, pb.schema.fields):
        assert np.asarray(jc.data).ndim == pc.data.dim(), f.name
        assert jc.mag_bound == pc.mag_bound, f.name
    return want, got


def _order(E, spec):
    k = E.col("k")
    return {"asc": (E.SortOrder(k),),
            "desc_nulls_last": (E.SortOrder(k, ascending=False, nulls_first=False),),
            "two_keys": (E.SortOrder(k), E.SortOrder(E.col("x"), ascending=False))}[spec]


@pytest.mark.parametrize("order", ["asc", "desc_nulls_last", "two_keys"])
def test_ranking_functions_match_jax(order):
    def wexprs(E, T):
        kw = dict(partition_by=(E.col("g"),), order_by=_order(E, order))
        return [E.WindowExpr(f, None, f, offset=3 if f == "ntile" else 1, **kw)
                for f in ("row_number", "rank", "dense_rank", "percent_rank", "cume_dist",
                          "ntile")]

    same(*run_both(wexprs))


def _partition_key(E, T, key):
    return {"none": (),
            "int": (E.col("g"),),
            "string": (E.col("s"),),
            "expression": (E.if_(E.col("g") > E.lit(1), E.col("s"),
                                 E.lit(None, T.string(8))), E.col("g"))}[key]


@pytest.mark.parametrize("key,staging", [("none", "dict"), ("int", "dict"),
                                         ("string", "dict"), ("string", "padded"),
                                         ("expression", "dict"), ("expression", "padded")])
def test_partition_keys_match_jax(key, staging):
    def wexprs(E, T):
        kw = dict(partition_by=_partition_key(E, T, key), order_by=(E.SortOrder(E.col("k")),))
        return [E.WindowExpr("rank", None, "rk", **kw),
                E.WindowExpr("row_number", None, "rn", **kw),
                E.WindowExpr("sum", E.col("x"), "total", frame=E.WindowFrame("rows", None, None),
                             **kw),
                E.WindowExpr("avg", E.col("f"), "avg_f", frame=E.WindowFrame("rows", None, None),
                             **kw)]

    same(*run_both(wexprs, staging))


def test_lag_lead_nth_value_match_jax():
    def wexprs(E, T):
        kw = dict(partition_by=(E.col("g"),), order_by=(E.SortOrder(E.col("k")),))
        return [E.WindowExpr("lag", E.col("x"), "lag1", offset=1, **kw),
                E.WindowExpr("lead", E.col("x"), "lead2", offset=2, **kw),
                E.WindowExpr("lag", E.col("x"), "lag_dflt", offset=2,
                             default=E.lit(7, T.INT64), **kw),
                E.WindowExpr("lead", E.col("x"), "lead_col_dflt", offset=1,
                             default=E.col("i"), **kw),
                E.WindowExpr("lag", E.col("d"), "lag_dec", offset=1, **kw),
                E.WindowExpr("lead", E.col("f"), "lead_f", offset=1, **kw),
                E.WindowExpr("nth_value", E.col("x"), "nth2", offset=2, **kw)]

    same(*run_both(wexprs))


def test_lag_lead_of_padded_strings_match_jax():
    def wexprs(E, T):
        kw = dict(partition_by=(E.col("g"),), order_by=(E.SortOrder(E.col("k")),))
        return [E.WindowExpr("lag", E.col("s"), "lag_s", offset=1, **kw),
                E.WindowExpr("lead", E.col("s"), "lead_s", offset=3, **kw),
                E.WindowExpr("nth_value", E.col("s"), "nth_s", offset=1, **kw)]

    same(*run_both(wexprs, "padded"))


_AGGS = (("count", None), ("count", "x"), ("sum", "x"), ("avg", "x"), ("min", "x"),
         ("max", "x"), ("sum", "f"), ("avg", "f"), ("min", "f"), ("max", "f"), ("sum", "d"),
         ("min", "d"), ("max", "d"))


@pytest.mark.parametrize("frame", [("rows", None, 0), ("range", None, 0), ("rows", None, None),
                                   ("range", None, None), ("rows", -2, 1), ("rows", 0, 2),
                                   ("rows", -3, -1)])
def test_aggregate_frames_match_jax(frame):
    def wexprs(E, T):
        kw = dict(partition_by=(E.col("g"),), order_by=(E.SortOrder(E.col("k")),),
                  frame=E.WindowFrame(*frame))
        out = [E.WindowExpr(f, None if c is None else E.col(c), f"{f}_{c}", **kw)
               for f, c in _AGGS]
        if frame == ("rows", None, 0):
            out += [E.WindowExpr(f, E.col("x"), f"{f}_x", **kw) for f in ("first", "last")]
        if frame == ("range", None, 0):
            out.append(E.WindowExpr("last", E.col("x"), "last_x", **kw))
        return out

    same(*run_both(wexprs))


@pytest.mark.parametrize("lo,hi,ascending", [(5, 5, True), (0, 10, True), (3, 0, True),
                                             (None, 2, True), (7, None, True), (5, 5, False),
                                             (None, 2, False)])
def test_range_value_offsets_match_jax(lo, hi, ascending):
    def wexprs(E, T):
        kw = dict(partition_by=(E.col("g"),),
                  order_by=(E.SortOrder(E.col("k"), ascending=ascending),),
                  frame=E.WindowFrame("range", lo, hi))
        return [E.WindowExpr(f, E.col("x"), f, **kw) for f in ("sum", "count", "avg")]

    same(*run_both(wexprs))


# ---- where the port follows Spark: a Python oracle ------------------------------------


def _live_rows():
    """The rows the filter keeps, as dicts (None for a null)."""
    rows = []
    for r in range(N):
        if DATA["keep"][r]:
            rows.append({c: (None if c in VALID and not VALID[c][r] else DATA[c][r].item()
                             if hasattr(DATA[c][r], "item") else DATA[c][r]) for c in DATA})
            rows[-1]["k_raw"] = int(DATA["k"][r])
    return rows


def _oracle(func, col, frame, ordered=True):
    """Per live row (in row order): ``func`` of ``col`` over ``frame``
    within its partition g, ordered by k ascending, nulls first, ties in
    row order. Rows whose k is null are ordered among themselves by the
    value their null slot holds, as both packages' sorts order them (any
    order of tied rows is Spark's). ``frame``: (type, lower, upper) as
    ``WindowFrame``."""
    rows = _live_rows()
    out = {}
    parts = {}
    for r in rows:
        parts.setdefault(r["g"], []).append(r)
    for prows in parts.values():
        prows = sorted(prows, key=lambda r: (r["k"] is not None, r["k_raw"])) if ordered \
            else prows
        ftype, lo, hi = frame
        for idx, r in enumerate(prows):
            if ftype == "rows":
                a = 0 if lo is None else max(idx + lo, 0)
                b = len(prows) - 1 if hi is None else min(idx + hi, len(prows) - 1)
                win = prows[a:b + 1] if a <= b else []
            else:  # RANGE UNBOUNDED PRECEDING .. the current peer group's end
                win = [q for q in prows if (q["k"] is None) == (r["k"] is None)
                       and (r["k"] is None or q["k"] <= r["k"]) or
                       (q["k"] is None and r["k"] is not None)]
            vals = [q[col] for q in win if q[col] is not None]
            if func == "count":
                v = len(vals)
            elif not vals:
                v = None
            elif func == "sum":
                v = sum(vals)
            elif func == "avg":
                v = math.fsum(vals) / len(vals)
            elif func == "first":
                v = vals[0]
            out[r["i"]] = v
    return [out[r["i"]] for r in rows]


def _got(got, name):
    return [v.item() if ok else None for v, ok in zip(got[name], got[name + "__valid"])]


@pytest.mark.parametrize("frame", [("rows", None, 2), ("rows", -1, None)])
def test_rows_frame_with_one_unbounded_end_equals_oracle(frame):
    """The JAX package reads the unbounded end as CURRENT ROW (C20)."""
    def wexprs(E, T):
        kw = dict(partition_by=(E.col("g"),), order_by=(E.SortOrder(E.col("k")),),
                  frame=E.WindowFrame(*frame))
        return [E.WindowExpr(f, E.col("x"), f, **kw) for f in ("sum", "count")]

    _, got = _run("port", wexprs, "dict", DATA, VALID, schema)
    for f in ("sum", "count"):
        assert _got(got, f) == _oracle(f, "x", frame), f


def test_avg_of_decimal_and_running_first_over_range_equal_oracle():
    """A decimal's AVG is of its value (the JAX package divides the
    unscaled integer); a running FIRST over a RANGE frame sees its peer
    group's rows (the JAX package stops at the current row) (C20)."""
    def wexprs(E, T):
        kw = dict(partition_by=(E.col("g"),), order_by=(E.SortOrder(E.col("k")),))
        return [E.WindowExpr("avg", E.col("d"), "avg_d",
                             frame=E.WindowFrame("rows", None, None), **kw),
                E.WindowExpr("first", E.col("x"), "first_x",
                             frame=E.WindowFrame("range", None, 0), **kw)]

    want, got = run_both(wexprs)
    exp = [None if v is None else v / 100 for v in
           _oracle("avg", "d", ("rows", None, None))]
    for g_, e in zip(_got(got, "avg_d"), exp):
        assert (g_ is None) == (e is None) and (e is None or math.isclose(g_, e, rel_tol=1e-12))
    # the JAX package's value is the unscaled one
    np.testing.assert_allclose(np.asarray(want["avg_d"], float) / 100,
                               np.asarray(got["avg_d"], float), rtol=1e-12)
    assert _got(got, "first_x") == _oracle("first", "x", ("range", None, 0))


def test_float_sum_of_a_partition_after_huge_ones_equals_fsum():
    """Partition 0 holds values of 1e17, partition 1 values of about 1: the
    port sums each partition on its own and holds math.fsum within 1e-12;
    the JAX package's difference of one prefix over the capacity loses
    partition 1's digits (ROADMAP C12, here in a window)."""
    n = 64
    rng = np.random.default_rng(7)
    f = np.where(np.arange(n) < 32, rng.choice([1e17, -1e17 + 4096.0], n),
                 np.round(rng.random(n) + 1.0, 6))
    data = {"g": (np.arange(n) >= 32).astype(np.int32), "f": f, "keep": np.ones(n, bool)}

    def sch(T):
        return T.Schema([T.Field("g", T.INT32), T.Field("f", T.FLOAT64), T.Field("keep", T.BOOL)])

    def wexprs(E, T):
        return [E.WindowExpr(fn, E.col("f"), fn, partition_by=(E.col("g"),),
                             frame=E.WindowFrame("rows", None, None)) for fn in ("sum", "avg")]

    want, got = run_both(wexprs, data=data, valid={}, sch=sch)
    small = f[32:]
    exp = math.fsum(small)
    rows = got["g"] == 1
    assert np.all(np.abs(got["sum"][rows] - exp) <= 1e-12 * abs(exp))
    assert np.all(np.abs(got["avg"][rows] - exp / 32) <= 1e-12 * abs(exp / 32))
    assert np.abs(want["sum"][want["g"] == 1] - exp).max() > 1e-6 * abs(exp)


def test_aggregate_over_two_limb_decimal_raises():
    """A window SUM over a decimal in two-limb storage raises, as the JAX
    package cannot run it either (``jnp.where`` of a (cap, 2) array)."""
    s = PT.Schema([PT.Field("g", PT.INT32), PT.Field("w", PT.decimal(30, 2))])
    ps = Session(device="cpu")
    ps.register_numpy("t", {"g": np.zeros(3, np.int32),
                            "w": np.array([1, 10**25, 3], object)}, s)
    assert ps.tables["t"].column("w").data.dim() == 2
    plan = PP.Window(PP.Scan("t", s), (PE.WindowExpr(
        "sum", PE.col("w"), "sw", partition_by=(PE.col("g"),),
        frame=PE.WindowFrame("rows", None, None)),))
    with pytest.raises(NotImplementedError, match="two-limb"):
        ps.collect(plan)
    # lag moves two-limb rows as they are
    plan = PP.Window(PP.Scan("t", s), (PE.WindowExpr(
        "lag", PE.col("w"), "lw", partition_by=(PE.col("g"),),
        order_by=(PE.SortOrder(PE.col("w")),)),))
    out = ps.collect(plan)
    assert [v if ok else None for v, ok in zip(out["lw"], out["lw__valid"])] == [None, 3, 1]


# ---- the engine around a Window --------------------------------------------------------


def _window_plan(E, P, T):
    s = schema(T)
    agg = P.Scan("t", s).aggregate([E.col("g"), E.col("k")],
                                   [E.AggExpr("sum", E.col("x"), "sx")])
    win = P.Window(agg, (E.WindowExpr("rank", None, "rk", partition_by=(E.col("g"),),
                                      order_by=(E.SortOrder(E.col("k")),)),))
    return win.project([E.col("g"), E.col("k"), E.col("rk")]).sort(
        [E.SortOrder(E.col("g")), E.SortOrder(E.col("k"))])


def test_pruning_statistics_memory_and_sort_above_a_window_match_jax():
    """Pruning keeps what the window reads (not its output) below it; the
    statistics walk passes the child's estimates up; the peak estimate
    counts the window's output; a Sort above a Window stays, as the window
    leaves its rows in input order, in both packages."""
    jp, pp = _window_plan(JE, JP, JT), _window_plan(PE, PP, PT)

    def scan_cols(p):
        while p.children():
            p = p.children()[0]
        return p.projection

    assert scan_cols(PPR.prune_columns(pp)) == scan_cols(JPR.prune_columns(jp))
    js, ps = JaxSession(), Session(device="cpu")
    js.register_numpy("t", DATA, schema(JT), validity=VALID)
    ps.register_numpy("t", DATA, schema(PT), validity=VALID)
    want, got = js._plan_stages(jp), ps._plan_stages(pp)
    assert [type(s).__name__ for _, s in got] == [type(s).__name__ for _, s in want] == ["Sort"]
    assert rf_hints(got, PP) == rf_hints(want, JP)
    assert PM.plan_peak_bytes(got[-1][1], 1 << 10) == JM.plan_peak_bytes(want[-1][1], 1 << 10)
    same(JB.to_numpy(js.execute(jp)), PB.to_numpy(ps.execute(pp)))


def _ranked_states(E, P, lo, hi):
    """TPC-DS q70's ranked-state semi join over months [lo, hi]: store
    LEFT_SEMI the five most profitable states, ranked by a Window over
    store_sales joined to date_dim and store."""
    def sc(t):
        return P.Scan(t, (JTPCDS if E is JE else tpcds).SCHEMAS[t])

    dt = sc("date_dim").filter(E.col("d_month_seq").between(lo, hi))
    inner = P.HashJoin(sc("store_sales"), dt, (E.col("ss_sold_date_sk"),),
                       (E.col("d_date_sk"),), P.JoinType.INNER, "right")
    inner = P.HashJoin(inner, sc("store"), (E.col("ss_store_sk"),), (E.col("s_store_sk"),),
                       P.JoinType.INNER, "right")
    agg = inner.aggregate([E.col("s_state")],
                          [E.AggExpr("sum", E.col("ss_net_profit"), "state_profit")])
    agg.max_groups = 64
    ranked = P.Window(agg, (E.WindowExpr(
        "rank", None, "ranking",
        order_by=(E.SortOrder(E.col("state_profit"), ascending=False),)),)).filter(
        E.col("ranking") <= E.lit(5)).project([E.col("s_state").alias("top_state")])
    return P.HashJoin(sc("store"), ranked, (E.col("s_state"),), (E.col("top_state"),),
                      P.JoinType.LEFT_SEMI, "right")


@pytest.mark.parametrize("months", [(12, 23), (12, 12)])
def test_runtime_filters_inside_a_ranked_semi_join_build_match_jax(months):
    """TPC-DS q70's window inside a LEFT_SEMI join's build side, at SF 0.3
    (store_sales over the runtime filters' 65,536 rows): q70's twelve
    months give no filter, one month gives one inside the build side,
    below the window; both packages inject the same filters, stage by
    stage, plan the same hints and give the same answer."""
    data = {t: tpcds.generate_table(t, 0.3) for t in ("store_sales", "date_dim", "store")}
    js, ps = JaxSession(), Session(device="cpu")
    for t, d in data.items():
        js.register_numpy(t, d, JTPCDS.SCHEMAS[t])
        ps.register_numpy(t, d, tpcds.SCHEMAS[t])
    jp, pp = _ranked_states(JE, JP, *months), _ranked_states(PE, PP, *months)
    want, got = js._plan_stages(jp), ps._plan_stages(pp)
    hints = rf_hints(got, PP)
    assert hints == rf_hints(want, JP)
    assert any(inj for _, joins in hints for _, inj, _ in joins) == (months == (12, 12))
    if months == (12, 23):  # q70 itself
        assert rf_hints(ps._plan_stages(tpcds.q70()), PP) == \
            rf_hints(js._plan_stages(JTPCDS.q70()), JP)
    same(JB.to_numpy(js.execute(jp)), PB.to_numpy(ps.execute(pp)))

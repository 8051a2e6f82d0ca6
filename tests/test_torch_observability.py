"""The port's observability against the JAX package on the CPU:
``Session.explain`` of TPC-H Q3 (the metrics tree's operators, details,
live output rows and capacities equal the JAX package's), the Chrome-trace
recorder's events, ``device_profile`` on the CPU, and ``check_batch``'s
errors, nested columns included."""

import json

import pytest

from datafusion_comet_tpu.exec.engine import Session as JaxSession
from datafusion_comet_tpu.models import tpch as JTPCH
from datafusion_comet_tpu_torch import types as T
from datafusion_comet_tpu_torch.conf import Config
from datafusion_comet_tpu_torch.exec import batch as PB
from datafusion_comet_tpu_torch.exec.debug import BatchInvariantError, check_batch
from datafusion_comet_tpu_torch.exec.engine import Session
from datafusion_comet_tpu_torch.models import tpch
from datafusion_comet_tpu_torch.observability import trace as TR
from datafusion_comet_tpu_torch.observability.metrics import ROOFLINE_GBPS, MetricsNode
from datafusion_comet_tpu_torch.observability.profile import device_profile
from _torch_threads import one_torch_thread  # noqa: F401 (a fixture)

pytestmark = pytest.mark.usefixtures("one_torch_thread")

SF = 0.002
TABLES = ("lineitem", "orders", "customer")


@pytest.fixture(scope="module")
def sessions():
    data = tpch.generate_tables(TABLES, SF)
    js, ps = JaxSession(), Session(device="cpu")
    for t in TABLES:
        js.register_numpy(t, data[t], JTPCH.SCHEMAS[t])
        ps.register_numpy(t, data[t], tpch.SCHEMAS[t])
    return js, ps


def _flat(d, out=None):
    out = [] if out is None else out
    out.append({k: d.get(k) for k in ("op", "detail", "output_rows", "capacity")})
    for c in d.get("children", []):
        _flat(c, out)
    return out


def test_explain_q3_equals_jax(sessions):
    """Every operator's name, detail, live rows and capacity equal the JAX
    package's, but for the top-K's: the port's Sort with a fetch keeps
    pad_capacity(fetch) rows (``basic.sort_op``), the JAX package's its
    input's capacity, and the Projection above it follows."""
    js, ps = sessions
    jt = js.explain(JTPCH.q3(), with_metrics=True, as_tree=True)
    pt = ps.explain(tpch.q3(), with_metrics=True, as_tree=True)
    jf, pf = _flat(jt.to_dict()), _flat(pt.to_dict())
    assert [n["op"] for n in pf[:2]] == ["Projection", "Sort"]
    for j, p in zip(jf[:2], pf[:2]):
        assert p["capacity"] == 16 and j["capacity"] == jf[2]["capacity"]
        j["capacity"] = p["capacity"]
    assert pf == jf
    assert all(n["output_rows"] is not None for n in _flat(pt.to_dict()))
    assert pt.output_bytes > 0 and pt.elapsed_ms > 0
    assert ps.explain(tpch.q3()).splitlines()[0].startswith(pt.op)
    # the live rows are those collect returns
    assert pt.output_rows == len(ps.collect(tpch.q3())["l_orderkey"])


def test_explain_profile_ops_gives_marginal_times(sessions):
    _, ps = sessions
    tree = ps.explain(tpch.q3(), with_metrics=True, profile_ops=True, as_tree=True)
    d = tree.to_dict()
    assert all(n.elapsed_ms is not None and n.elapsed_ms >= 0 for n in tree.top_sinks(100))
    assert len(tree.top_sinks(2)) <= 2 and "time=" in tree.render()
    assert d["op"] == tree.op
    node = MetricsNode("Scan", "t", [], output_bytes=10 ** 9, elapsed_ms=1000.0,
                       device_type="cuda")
    assert node.roofline() == (1.0, round(100.0 / ROOFLINE_GBPS["cuda"], 2))


def test_chrome_trace_events(tmp_path):
    """A span writes a B and an E event, a counter a C event, in the JAX
    package's format; a Session with tracing on turns the recorder on."""
    tr = TR.Tracer(str(tmp_path / "comet-event-trace.json"), enabled=True)
    with TR.with_trace("grace.pairs", tr, k=16):
        TR.trace_counter("rows", tr, live=5)
    text = (tmp_path / "comet-event-trace.json").read_text()
    events = json.loads(text.rstrip(",\n") + "]")
    assert [(e["name"], e["ph"]) for e in events] == [("grace.pairs", "B"), ("rows", "C"),
                                                      ("grace.pairs", "E")]
    assert events[0]["args"] == {"k": 16} and events[1]["args"] == {"live": 5}
    assert all({"ts", "pid", "tid"} <= set(e) for e in events)
    off = TR.Tracer(str(tmp_path / "off.json"))
    with TR.with_trace("x", off):
        pass
    assert not (tmp_path / "off.json").exists()
    before = TR.tracer.enabled
    try:
        Session(device="cpu", conf=Config(tracing_enabled=True))
        assert TR.tracer.enabled
    finally:
        TR.tracer.enabled = before


def test_device_profile_on_the_cpu(sessions):
    """With no card the profile holds CPU activity: the engine's spans and
    ops in the host lane, no device event."""
    _, ps = sessions
    rep = device_profile(lambda: ps.collect(tpch.q3()))
    assert set(rep) >= {"lanes", "top_device_ops", "device_events", "host_events"}
    assert rep["host_events"] > 0 and rep["device_events"] == 0
    assert rep["top_device_ops"] == [] and "aggregate.sort" in rep["lanes"]["host"]


def _batch():
    sch = T.Schema([T.Field("a", T.list_(T.INT64, 3)), T.Field("s", T.string(4)),
                    T.Field("st", T.struct(("p", T.INT32), ("q", T.string(2))))])
    return PB.from_numpy({"a": [[1, 2], None, []], "s": ["ab", "c", None],
                          "st": [(1, "x"), None, (2, "yz")]}, sch, "cpu", dict_max_size=0)


def test_check_batch_errors():
    b = _batch()
    check_batch(b, "Scan")
    a = b.columns[0]
    cases = [
        (PB.Batch(b.columns, b.row_mask.int(), b.schema), "row_mask dtype"),
        (PB.Batch(b.columns[:2], b.row_mask, b.schema), "schema arity"),
        (PB.Batch((a.with_validity(a.validity[:4]),) + b.columns[1:], b.row_mask, b.schema),
         "validity shape"),
        (PB.Batch((PB.ColumnVector(a.data.clone().fill_(4), a.validity, None, a.dtype,
                                   children=a.children),) + b.columns[1:], b.row_mask, b.schema),
         "element counts outside"),
        (PB.Batch((PB.ColumnVector(a.data, a.validity, None, a.dtype, children=(
            a.children[0].with_validity(a.children[0].validity[:, :2]),)),) + b.columns[1:],
            b.row_mask, b.schema), "element capacity"),
        (PB.Batch(b.columns[:1] + (PB.ColumnVector(b.columns[1].data, b.columns[1].validity,
                                                   b.columns[1].lengths + 9, b.columns[1].dtype),)
                  + b.columns[2:], b.row_mask, b.schema), "lengths outside"),
        (PB.Batch(b.columns[:2] + (PB.ColumnVector(b.columns[2].data, b.columns[2].validity,
                                                   None, b.columns[2].dtype,
                                                   children=b.columns[2].children[:1]),),
                  b.row_mask, b.schema), "fields"),
    ]
    for bad, msg in cases:
        with pytest.raises(BatchInvariantError, match=msg):
            check_batch(bad, "Projection")


def test_validate_batches_runs_on_every_operator(sessions):
    """Under ``Config(debug_validate_batches=True)`` Q3 runs with every
    operator's output checked and gives the same rows."""
    _, ps = sessions
    s = Session(device="cpu", conf=Config(debug_validate_batches=True))
    s.tables, s.stats = ps.tables, ps.stats
    a, b = s.collect(tpch.q3()), ps.collect(tpch.q3())
    assert all((a[k] == b[k]).all() for k in b)

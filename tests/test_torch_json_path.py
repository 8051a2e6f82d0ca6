"""PyTorch port, JSON paths (exec/json_path.py): get_json_object's device
path scan (key, quoted-key and index steps, nested; strings unquoted and
unescaped, null a SQL NULL, objects and arrays as their source span,
missing keys and malformed rows) and json_array_length equal the JAX
package over padded documents with nulls and a dead row, every path in one
JAX computation; a dictionary column's results, and the padded column's
run in blocks of rows, equal the padded column's in one piece;
``parse_path`` is the JAX module's; and a session with
comet.expr.json.deviceEnabled off runs the host bridge, whose values are
the JAX package's host bridge's row function's."""

import numpy as np
import pytest

from _torch_expr import assert_same, run_all, stage
from _torch_threads import one_torch_thread  # noqa: F401 (a fixture)
from datafusion_comet_tpu.conf import CONF
from datafusion_comet_tpu.exec import json_path as JJ
from datafusion_comet_tpu.ir import functions as JF
from datafusion_comet_tpu_torch import types as PT
from datafusion_comet_tpu_torch.conf import JSON_DEVICE_ENABLED, Config
from datafusion_comet_tpu_torch.exec import batch as PB
from datafusion_comet_tpu_torch.exec import evaluator as PEV
from datafusion_comet_tpu_torch.exec import json_path as PJ
from datafusion_comet_tpu_torch.exec.engine import Session
from datafusion_comet_tpu_torch.ir import expr as PE
from datafusion_comet_tpu_torch.ir import functions as PF
from datafusion_comet_tpu_torch.ir import plan as PP

pytestmark = pytest.mark.usefixtures("one_torch_thread")

DOCS = ['{"a":1,"b":{"c":"x"},"arr":[10,20,{"x":true}]}',
        '{"a": "s", "a2": 3, "s":"q\\"uo\\\\te", "n":null}',
        '{"b":{"c":[1,2]},"k":"v"}',
        '[1,2,3]', '[]', '[ {"a":1} , [2,3], "x,y" ]', '{"arr":[]}', 'not json',
        '{"a":{"a":{"a":7}}}', None, '  {"a" : [ 1 , 2 ] }  ', '{"k": "a,b", "a": -1.5e3}',
        '{"arr":[[1],[2,[3]]]}', '{"x": {"a": 1}, "a": 2}']
N = len(DOCS)
W = 48
PATHS = ["$.a", "$.b.c", "$.arr[1]", "$.arr[2].x", "$['k']", "$.s", "$.n", "$.missing",
         "$", "$.b.c[1]", "$.a.a.a", "$[1]", "$.arr[1][1][0]", "$.a2"]


def _builds():
    out = [lambda E, T, p=p: E.StringFunc("get_json_object", (E.col("d"), E.lit(p)))
           for p in PATHS]
    out.append(lambda E, T: E.StringFunc("json_array_length", (E.col("d"),)))
    return out


def test_paths_equal_jax():
    for p in PATHS + ["$..a", "$.a[*]", "a.b", "$['x"]:
        assert JJ.parse_path(p) == PJ.parse_path(p)
    jb, pb = stage([("d", lambda T: T.string(W))], {"d": np.array(DOCS, dtype=object)},
                   mask=np.arange(N) != 4)
    for j, p in run_all(_builds(), jb, pb):
        assert_same(j, p, N)


def _values(cv):
    cv = cv.decode() if cv.is_dict else cv
    if cv.lengths is None:
        return [cv.data[i].item() if cv.validity[i] else None for i in range(N)]
    lens = cv.lengths.numpy()
    return [bytes(cv.data[i, :lens[i]].numpy()) if cv.validity[i] else None
            for i in range(N)]


def test_dictionary_and_row_blocks_equal_padded(monkeypatch):
    """A dictionary column's results, and the padded column's in blocks of
    three rows, equal the padded column's in one piece."""
    schema = PT.Schema([PT.Field("d", PT.string(W))])
    data = {"d": np.array(DOCS, dtype=object)}
    padded = PB.from_numpy(data, schema, "cpu", dict_max_size=0)
    coded = PB.from_numpy(data, schema, "cpu")
    assert coded.columns[0].is_dict
    exprs = [PE.bind(build(PE, PT), schema) for build in _builds()]
    whole = [_values(PEV.evaluate(e, padded)) for e in exprs]
    assert whole == [_values(PEV.evaluate(e, coded)) for e in exprs]
    monkeypatch.setattr(PEV, "STRING_BLOCK_BYTES", 8 * W * 3)  # three rows a block
    assert whole == [_values(PEV.evaluate(e, padded)) for e in exprs]


def test_host_bridge_when_device_gate_off():
    """The same node runs the host bridge under the session's gate off, and
    equals the JAX package's host bridge (built with its gate off)."""
    schema = PT.Schema([PT.Field("d", PT.string(W))])
    data = {"d": np.array(DOCS, dtype=object)}
    key = "comet.expr.json.deviceEnabled"
    assert key == JSON_DEVICE_ENABLED
    paths = [p for p in PATHS if "'" not in p]  # the host bridge reads no quoted key
    for dmax in (0, 1 << 16):
        sess = Session(device="cpu", conf=Config(gates={key: False},
                                                 scan_dictionary_max_size=dmax))
        sess.register_numpy("t", data, schema)
        nodes = [PF.get_json_object(PE.col("d"), p) for p in paths]
        assert all(isinstance(n, PE.StringFunc) for n in nodes)
        out = sess.collect(PP.Scan("t", schema).project(
            [n.alias(f"p{i}") for i, n in enumerate(nodes)]))
        CONF.set(key, False)
        try:
            fns = [JF.get_json_object(None, p).fn for p in paths]
        finally:
            CONF.set(key, True)
        for i, fn in enumerate(fns):
            assert list(out[f"p{i}"]) == [fn(d) for d in DOCS], paths[i]

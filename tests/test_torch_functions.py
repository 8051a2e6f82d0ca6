"""PyTorch port, the SQL function builders (ir/functions.py): the JAX
package's ``__all__``; every builder makes the JAX package's node (its
class, and for a device node its JSON; for a host bridge its name and
result type), the regexp, split and JSON builders choosing the device
node or the host bridge as the JAX package does (``linearize``,
``min_match_len``, a literal replacement, a simple path); and every
builder's values through the port's Session equal the JAX Session's on one
table (one projection of them all, the host bridges through its
callbacks). from_json's row path gives the JAX package's answers (its
pyarrow reader is not ported)."""

import json

import numpy as np
import pytest

from _torch_threads import one_torch_thread  # noqa: F401 (a fixture)
from datafusion_comet_tpu import types as JT
from datafusion_comet_tpu.exec.engine import Session as JaxSession
from datafusion_comet_tpu.ir import expr as JE
from datafusion_comet_tpu.ir import functions as JF
from datafusion_comet_tpu.ir import plan as JP
from datafusion_comet_tpu.ir import serde as JS
from datafusion_comet_tpu_torch import types as PT
from datafusion_comet_tpu_torch.exec.engine import Session
from datafusion_comet_tpu_torch.ir import expr as PE
from datafusion_comet_tpu_torch.ir import functions as PF
from datafusion_comet_tpu_torch.ir import plan as PP
from datafusion_comet_tpu_torch.ir import serde
from test_torch_q9 import same

pytestmark = pytest.mark.usefixtures("one_torch_thread")

N = 8
DATA = {
    "s": np.array(["abc123,x;y", "a,b,,c", "", None, "Robert", "hello42 world7", "ac bc",
                   "x1y22z333"], dtype=object),
    "doc": np.array(['{"a":1,"arr":[1,2],"b":"x"}', '{"a":"s","k":{"z":2}}', "[1,2,3]", None,
                     "bad", '{"arr":[]}', '{"a":null}', '{"b":[{"c":1}]}'], dtype=object),
    "i": np.array([0, 12345, -7, 42, 3, 999999, -1, 65536], dtype=np.int64),
    "url": np.array(["http://u:p@h.com:80/p/a?k=v&q=2#frag", "https://x.org/", "ftp://f/",
                     None, "bad url", "http://h/p?k=1", "http://h?k", "http://a.b/c"],
                    dtype=object),
    "csv": np.array(["1,a,2.5", "x,,3", "", None, '"q,u",7,1', "9", "1,2,3,4", "t,f,0"],
                    dtype=object),
    "xml": np.array(["<a><b>1</b><b>2</b></a>", "<a><b x='7'>3.5</b></a>", "<a/>", None,
                     "<bad", "<a><c>x</c></a>", "<a><b>-4</b></a>", "<a><b>9</b><b>y</b></a>"],
                    dtype=object),
    "num": np.array(["123.45", "1,234.5", "-12.3", None, "7", "0.99", "999.99", "12"],
                    dtype=object),
    "d": np.array([0, 19000, -365, 1, 20000, 365, 11000, 18000], dtype=np.int32),
}
VALID = {"i": np.arange(N) != 2, "d": np.arange(N) != 5}


def _schema(T):
    return T.Schema([T.Field("s", T.string(16)), T.Field("doc", T.string(32)),
                     T.Field("i", T.INT64), T.Field("url", T.string(40)),
                     T.Field("csv", T.string(12)), T.Field("xml", T.string(32)),
                     T.Field("num", T.string(8)), T.Field("d", T.DATE)])


def _double(v):
    return None if v is None else v * 2


def _exprs(F, E, T):
    c = E.col
    st = T.struct(("a", T.INT64), ("b", T.string(24)))
    return {
        "rlike": F.rlike(c("s"), "[a-z]+\\d"),
        "rx_dev": F.regexp_extract(c("s"), "([a-z]+)(\\d+)", 2),
        "rx_host": F.regexp_extract(c("s"), "(a|b)c", 1),
        "rr_dev": F.regexp_replace(c("s"), "\\d+", "#"),
        "rr_host": F.regexp_replace(c("s"), "(\\d)", "<$1>", 40),
        "sp_dev": F.split(c("s"), ","),
        "sp_host": F.split(c("s"), "[,;]"),
        "gj_dev": F.get_json_object(c("doc"), "$.a"),
        "gj_host": F.get_json_object(c("doc"), "$.k.z", 8),
        "jal": F.json_array_length(c("doc")),
        "split_part": F.split_part(c("s"), ",", 2),
        "sub_index": F.substring_index(c("s"), ",", 1),
        "soundex": F.soundex(c("s")),
        "fmt_num": F.format_number(c("i"), 2),
        "str_to_map": F.str_to_map(c("csv")),
        "from_json": F.from_json(c("doc"), st),
        "to_json": F.to_json(F.from_json(c("doc"), st)),
        "url_host": F.parse_url(c("url"), "HOST"),
        "url_q": F.parse_url(c("url"), "QUERY", "k"),
        "url_user": F.parse_url(c("url"), "USERINFO"),
        "from_csv": F.from_csv(c("csv"), T.struct(("x", T.INT64), ("y", T.string(12)))),
        "to_csv": F.to_csv(F.from_csv(c("csv"), T.struct(("x", T.INT64),
                                                          ("y", T.string(12))))),
        "xpath": F.xpath(c("xml"), "b"),
        "xpath_string": F.xpath_string(c("xml"), "b"),
        "xpath_boolean": F.xpath_boolean(c("xml"), "b"),
        "xpath_int": F.xpath_int(c("xml"), "b"),
        "xpath_long": F.xpath_long(c("xml"), "b"),
        "xpath_short": F.xpath_short(c("xml"), "b"),
        "xpath_float": F.xpath_float(c("xml"), "b"),
        "xpath_double": F.xpath_double(c("xml"), "b"),
        "date_format": F.date_format(c("d"), "yyyy-MM-dd"),
        "rxa_dev": F.regexp_extract_all(c("s"), "\\d+", 0),
        "rxa_host": F.regexp_extract_all(c("s"), "(a|b)", 1),
        "rx_instr": F.regexp_instr(c("s"), "\\d"),
        "schema_json": F.schema_of_json(c("doc")),
        "schema_csv": F.schema_of_csv(c("csv")),
        "to_char": F.to_char(c("i"), "999,999D99"),
        "empty2null": F.empty2null(c("s")),
        "json_keys": F.json_object_keys(c("doc")),
        "overlay": F.overlay(c("s"), "XX", 2, 1),
        "find_in_set": F.find_in_set(c("csv"), c("s")),
        "format_string": F.format_string("%s-%d", c("s"), c("i")),
        "to_number": F.try_to_number(c("num"), "999.99"),
        "make_ts": F.make_timestamp(c("i"), E.lit(3), E.lit(4), E.lit(5), E.lit(6), E.lit(7)),
        "udf": F.python_udf(_double, [c("i")], T.INT64),
    }


def _udf_names(e, out):
    if type(e).__name__ == "PythonUdf":
        out.append((e.udf_name, repr(e.out_dtype)))
    for k in e.children():
        _udf_names(k, out)
    return out


def test_builders_make_jax_nodes():
    assert PF.__all__ == JF.__all__
    jx, px = _exprs(JF, JE, JT), _exprs(PF, PE, PT)
    kinds = {}
    for name in jx:
        assert type(jx[name]).__name__ == type(px[name]).__name__, name
        kinds[name] = type(px[name]).__name__
        ju, pu = _udf_names(jx[name], []), _udf_names(px[name], [])
        assert ju == pu, name
        if not ju:
            assert serde.expr_to_dict(px[name]) == json.loads(json.dumps(
                JS.expr_to_dict(jx[name]))), name
    assert kinds["rx_dev"] == "RegexpExtract" and kinds["rx_host"] == "PythonUdf"
    assert kinds["rr_dev"] == "RegexpReplace" and kinds["rr_host"] == "PythonUdf"
    assert kinds["rxa_dev"] == "RegexpExtractAll" and kinds["rxa_host"] == "PythonUdf"
    assert kinds["gj_dev"] == "StringFunc" and kinds["gj_host"] == "PythonUdf"
    assert kinds["sp_dev"] == "Split" and kinds["sp_host"] == "PythonUdf"


def test_builders_values_equal_jax():
    js, ps = JaxSession(), Session(device="cpu")
    js.register_numpy("t", DATA, _schema(JT), validity=VALID)
    ps.register_numpy("t", DATA, _schema(PT), validity=VALID)
    jx, px = _exprs(JF, JE, JT), _exprs(PF, PE, PT)
    want = js.collect(JP.Scan("t", _schema(JT)).project([e.alias(n) for n, e in jx.items()]))
    got = ps.collect(PP.Scan("t", _schema(PT)).project([e.alias(n) for n, e in px.items()]))
    same(want, got)

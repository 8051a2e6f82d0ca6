"""SQL function builders with Spark semantics (port of
``datafusion_comet_tpu/ir/functions.py``: every builder of its
``__all__``).

Functions with a device path build its node: RLIKE (exec/regex_dfa.py),
regexp_extract, regexp_extract_all and regexp_replace where the pattern
linearizes (exec/regex_extract.py), split, split_part, substring_index,
soundex, format_number, json_array_length and get_json_object's simple
paths. The rest wrap exact Python implementations as ``PythonUdf``
expressions, evaluated on the host (exec/host_udf.py): Python ``re`` and
``json`` stand in for the reference's per-row Rust ``regex`` and JSON
kernels. Python ``re`` differs from Java's regex dialect in corner cases
(possessive quantifiers, ``\\p`` classes), the reference's own
"Incompatible" tier for regexp.

Two builders differ from the JAX package's: get_json_object reads the
comet.expr.json.deviceEnabled gate from the session at evaluation
(``EvalContext.json_device``), not from the process config when it is
built, so it builds the device node for any simple path (the node the
JAX package builds under its default); and from_json parses each live row
with Python's ``json`` (the JAX package's exact fallback), without the
pyarrow reader the JAX package tries first: the results are equal.
"""

from __future__ import annotations

import json
import re

from datafusion_comet_tpu_torch import types as T
from datafusion_comet_tpu_torch.ir import expr as E

__all__ = [
    "rlike",
    "regexp_extract",
    "regexp_replace",
    "split",
    "get_json_object",
    "json_array_length",
    "split_part",
    "substring_index",
    "soundex",
    "format_number",
    "str_to_map",
    "from_json",
    "to_json",
    "parse_url",
    "from_csv",
    "to_csv",
    "xpath",
    "xpath_string",
    "xpath_boolean",
    "xpath_int",
    "xpath_long",
    "xpath_short",
    "xpath_float",
    "xpath_double",
    "date_format",
    "regexp_extract_all",
    "regexp_instr",
    "schema_of_json",
    "schema_of_csv",
    "to_char",
    "empty2null",
    "json_object_keys",
    "overlay",
    "find_in_set",
    "format_string",
    "to_number",
    "try_to_number",
    "make_timestamp",
    "python_udf",
]


def rlike(child: E.Expr, pattern: str, negated: bool = False) -> E.RLike:
    return E.RLike(child, pattern, negated)


def _java_replacement(repl: str) -> str:
    """Java $1 group references → Python \\1."""
    return re.sub(r"\$(\d+)", r"\\\1", repl)


def regexp_extract(child: E.Expr, pattern: str, idx: int = 1, out_len: int = 0):
    """Spark regexp_extract: empty string when no match / unmatched group.
    Linear backtracking-free patterns run fully on device
    (exec/regex_extract.py); everything else keeps the host bridge."""
    from datafusion_comet_tpu_torch.exec.regex_extract import linearize

    if linearize(pattern, idx) is not None:
        return E.RegexpExtract(child, pattern, idx, out_len)
    rx = re.compile(pattern)

    def fn(s):
        if s is None:
            return None
        m = rx.search(s)
        if m is None:
            return ""
        g = m.group(idx)
        return g if g is not None else ""

    return E.PythonUdf(fn, (child,), T.string(out_len or T.DEFAULT_STRING_LEN), "regexp_extract")


def regexp_extract_all(child: E.Expr, pattern: str, idx: int = 1,
                       max_elems: int = 16, elem_len: int = 0):
    """Spark regexp_extract_all: every match's group ``idx`` as an array.
    Linear non-empty-matching patterns run on device
    (exec/regex_extract.py extract_all_device)."""
    from datafusion_comet_tpu_torch.exec.regex_extract import (linearize,
                                                         min_match_len)

    lp = linearize(pattern, idx)
    if lp is not None and min_match_len(lp) > 0:
        return E.RegexpExtractAll(child, pattern, idx, max_elems, elem_len)
    rx = re.compile(pattern)

    def fn(s):
        if s is None:
            return None
        out = []
        for m in rx.finditer(s):
            g = m.group(idx) if idx <= (m.lastindex or 0) else (m.group(0) if idx == 0 else None)
            out.append(g if g is not None else "")
        return out[:max_elems]

    return E.PythonUdf(
        fn, (child,), T.list_(T.string(elem_len or T.DEFAULT_STRING_LEN), max_elems),
        "regexp_extract_all")


def regexp_instr(child: E.Expr, pattern: str, idx: int = 0) -> E.PythonUdf:
    """Spark regexp_instr: 1-based position of the first match (0 = none)."""
    rx = re.compile(pattern)

    def fn(s):
        if s is None:
            return None
        m = rx.search(s)
        return (m.start() + 1) if m else 0

    return E.PythonUdf(fn, (child,), T.INT32, "regexp_instr")


def _schema_of_value(v) -> str:
    if isinstance(v, bool):
        return "BOOLEAN"
    if isinstance(v, int):
        return "BIGINT"
    if isinstance(v, float):
        return "DOUBLE"
    if isinstance(v, list):
        inner = _schema_of_value(v[0]) if v else "STRING"
        return f"ARRAY<{inner}>"
    if isinstance(v, dict):
        fields = ", ".join(f"{k}: {_schema_of_value(x)}" for k, x in v.items())
        return f"STRUCT<{fields}>"
    return "STRING"


def schema_of_json(child: E.Expr, out_len: int = 128) -> E.PythonUdf:
    """Spark schema_of_json: DDL-ish schema string of a JSON value."""

    def fn(s):
        if s is None:
            return None
        try:
            return _schema_of_value(json.loads(s))
        except ValueError:
            return None

    return E.PythonUdf(fn, (child,), T.string(out_len), "schema_of_json")


def schema_of_csv(child: E.Expr, sep: str = ",", out_len: int = 128) -> E.PythonUdf:
    """Spark schema_of_csv: STRUCT<_c0: ..., ...> inferred from one line."""

    def fn(s):
        if s is None:
            return None
        import csv as _csv
        import io as _io

        try:
            row = next(_csv.reader(_io.StringIO(s), delimiter=sep))
        except (StopIteration, _csv.Error):
            return None

        def t(x):
            try:
                int(x)
                return "BIGINT"
            except ValueError:
                pass
            try:
                float(x)
                return "DOUBLE"
            except ValueError:
                return "STRING"

        fields = ", ".join(f"_c{i}: {t(x)}" for i, x in enumerate(row))
        return f"STRUCT<{fields}>"

    return E.PythonUdf(fn, (child,), T.string(out_len), "schema_of_csv")


def to_char(child: E.Expr, fmt: str, out_len: int = 0) -> E.PythonUdf:
    """Spark to_char(numeric, fmt): the '9/0/D/,/$/S/MI' subset inverted —
    format a number per the template."""
    int_fmt, _, frac_fmt = fmt.partition("D")
    scale = frac_fmt.count("9") + frac_fmt.count("0")
    grouping = "," in int_fmt or "G" in int_fmt

    def fn(v):
        if v is None:
            return None
        x = float(v)
        body = f"{abs(x):,.{scale}f}" if grouping else f"{abs(x):.{scale}f}"
        sign = ""
        if fmt.endswith("MI"):
            return body + ("-" if x < 0 else "")
        if fmt.startswith("S"):
            sign = "-" if x < 0 else "+"
        elif x < 0:
            sign = "-"
        dollar = "$" if "$" in fmt else ""
        return sign + dollar + body

    return E.PythonUdf(fn, (child,), T.string(out_len or max(len(fmt) * 2, 24)), "to_char")


def empty2null(child: E.Expr, out_len: int = 0) -> E.PythonUdf:
    """Spark Empty2Null (write-path partition normalization): '' -> NULL."""

    def fn(s):
        return None if s is None or s == "" else s

    return E.PythonUdf(fn, (child,), T.string(out_len or T.DEFAULT_STRING_LEN), "empty2null")


def json_object_keys(child: E.Expr, max_elems: int = 16, elem_len: int = 0) -> E.PythonUdf:
    """Spark json_object_keys: top-level keys of a JSON object, null
    otherwise."""

    def fn(s):
        if s is None:
            return None
        try:
            doc = json.loads(s)
        except ValueError:
            return None
        if not isinstance(doc, dict):
            return None
        return list(doc.keys())[:max_elems]

    return E.PythonUdf(
        fn, (child,), T.list_(T.string(elem_len or T.DEFAULT_STRING_LEN), max_elems),
        "json_object_keys")


def regexp_replace(child: E.Expr, pattern: str, replacement: str, out_len: int = 0):
    """Device path (exec/regex_extract.py replace_device) when the pattern
    linearizes, cannot match empty, and the replacement is a plain literal
    (no $n group refs / backslashes); host bridge otherwise."""
    from datafusion_comet_tpu_torch.exec.regex_extract import (linearize,
                                                         min_match_len)

    lp = linearize(pattern, 0)
    if (lp is not None and min_match_len(lp) > 0
            and "$" not in replacement and "\\" not in replacement):
        return E.RegexpReplace(child, pattern, replacement, out_len)
    rx = re.compile(pattern)
    py_repl = _java_replacement(replacement)

    def fn(s):
        return None if s is None else rx.sub(py_repl, s)

    return E.PythonUdf(fn, (child,), T.string(out_len or T.DEFAULT_STRING_LEN), "regexp_replace")


_RX_META = set(".^$*+?{}[]\\|()")


def _literal_pattern(pattern: str):
    """The pattern as a plain literal string, or None if it uses any regex
    metacharacter (those keep the host bridge)."""
    if not pattern or any(c in _RX_META for c in pattern):
        return None
    return pattern


def split(child: E.Expr, pattern: str, limit: int = -1, max_elems: int = 16, elem_len: int = 0):
    """Spark split(str, regex, limit): limit>0 caps the parts; limit<=0 keeps
    all parts including trailing empty strings (Java split(regex, -1)).
    Literal patterns with the default limit run fully on device
    (exec/string_funcs.py); regex patterns / positive limits keep the host
    bridge."""
    lit = _literal_pattern(pattern)
    if lit is not None and limit <= 0:
        return E.Split(child, lit, max_elems)
    rx = re.compile(pattern)

    def fn(s):
        if s is None:
            return None
        parts = rx.split(s, maxsplit=limit - 1 if limit > 0 else 0)
        return parts

    return E.PythonUdf(
        fn, (child,),
        T.list_(T.string(elem_len or T.DEFAULT_STRING_LEN), max_elems),
        "split",
    )


def _json_path_get(doc, path: str):
    """Tiny $.a.b[0] JSON-path evaluator (reference: json_funcs
    get_json_object JSON-path subset)."""
    if not path.startswith("$"):
        return None
    cur = doc
    i = 1
    n = len(path)
    while i < n:
        c = path[i]
        if c == ".":
            j = i + 1
            while j < n and path[j] not in ".[":
                j += 1
            key = path[i + 1 : j]
            if not isinstance(cur, dict) or key not in cur:
                return None
            cur = cur[key]
            i = j
        elif c == "[":
            j = path.index("]", i)
            idx_s = path[i + 1 : j]
            if idx_s == "*":
                return None  # wildcard unsupported
            if not isinstance(cur, list):
                return None
            k = int(idx_s)
            if k >= len(cur) or k < -len(cur):
                return None
            cur = cur[k]
            i = j + 1
        else:
            return None
    return cur


def json_path_host(path: str):
    """The host bridge's row function of get_json_object: the matched
    value as a string (objects and arrays re-serialized compactly, scalars
    unquoted), None on bad JSON or a missing path."""

    def fn(s):
        if s is None:
            return None
        try:
            doc = json.loads(s)
        except (ValueError, TypeError):
            return None
        v = _json_path_get(doc, path)
        if v is None:
            return None
        if isinstance(v, (dict, list)):
            return json.dumps(v, separators=(",", ":"))
        if isinstance(v, bool):
            return "true" if v else "false"
        return str(v)

    return fn


def get_json_object(child: E.Expr, path: str, out_len: int = 0) -> E.Expr:
    """Spark get_json_object: the matched value as a string (objects and
    arrays re-serialized as JSON, scalars unquoted), null on bad JSON or a
    missing path. A simple ``.key``/``[i]`` path builds the device node
    (exec/json_path.py), which the session's comet.expr.json.deviceEnabled
    (``Config.gates``) sends to the host bridge at evaluation when off;
    anything else is the host bridge."""
    from datafusion_comet_tpu_torch.exec.json_path import parse_path

    if parse_path(path) is not None and not out_len:
        return E.StringFunc("get_json_object", (E._e(child), E.lit(path)))
    return E.PythonUdf(json_path_host(path), (child,),
                       T.string(out_len or T.DEFAULT_STRING_LEN), "get_json_object")


def json_array_length(child: E.Expr):
    """Device path (exec/json_path.py device_json_array_length); the full
    host parser remains as json_array_length_host (oracle + the strict
    malformed-input NULL behavior, docs/compatibility.md)."""
    return E.StringFunc("json_array_length", (child,))


def json_array_length_host(child: E.Expr) -> E.PythonUdf:
    def fn(s):
        if s is None:
            return None
        try:
            doc = json.loads(s)
        except (ValueError, TypeError):
            return None
        return len(doc) if isinstance(doc, list) else None

    return E.PythonUdf(fn, (child,), T.INT32, "json_array_length")


def split_part(child: E.Expr, delim: str, part: int, out_len: int = 0):
    """Spark split_part: 1-based field index, negative counts from the end,
    '' when out of range. Non-empty delimiters run on device
    (exec/string_funcs.py)."""
    if delim:
        return E.SplitPart(child, delim, part)

    def fn(s):
        if s is None:
            return None
        parts = s.split(delim) if delim else [s]
        i = part - 1 if part > 0 else len(parts) + part
        return parts[i] if 0 <= i < len(parts) else ""

    return E.PythonUdf(fn, (child,), T.string(out_len or T.DEFAULT_STRING_LEN), "split_part")


def substring_index(child: E.Expr, delim: str, count: int, out_len: int = 0):
    """Device path (exec/string_funcs.py) for non-empty delimiters; negative
    counts additionally need a 1-byte delimiter (right-scan non-overlap of
    longer literals differs from the left scan — host bridge instead)."""
    if delim and (count >= 0 or len(delim.encode("utf-8")) == 1):
        return E.SubstringIndex(child, delim, count)

    def fn(s):
        if s is None:
            return None
        if count == 0 or not delim:
            return ""
        parts = s.split(delim)
        if count > 0:
            return delim.join(parts[:count])
        return delim.join(parts[count:])

    return E.PythonUdf(fn, (child,), T.string(out_len or T.DEFAULT_STRING_LEN), "substring_index")


def soundex(child: E.Expr, out_len: int = 0):
    """Device path (exec/string_funcs.py) — byte-exact with the host
    algorithm below for ASCII; the host variant stays for reference/oracle
    use via soundex_host."""
    return E.Soundex(child)


def soundex_host(child: E.Expr, out_len: int = 0) -> E.PythonUdf:
    codes = {**{c: "1" for c in "BFPV"}, **{c: "2" for c in "CGJKQSXZ"},
             **{c: "3" for c in "DT"}, "L": "4", **{c: "5" for c in "MN"}, "R": "6"}

    def fn(s):
        if s is None:
            return None
        if not s or not s[0].isalpha():
            return s
        up = s.upper()
        out = up[0]
        prev = codes.get(up[0], "")
        for ch in up[1:]:
            code = codes.get(ch, "")
            if code and code != prev:
                out += code
                if len(out) == 4:
                    break
            if ch not in "HW":
                prev = code
        return out.ljust(4, "0")

    # non-alphabetic-leading inputs pass through unchanged (Spark), so the
    # output width follows the input width
    return E.PythonUdf(fn, (child,), T.string(out_len or T.DEFAULT_STRING_LEN), "soundex")


def format_number(child: E.Expr, decimals: int, out_len: int = 32):
    """Device path (exec/string_funcs.py); format_number_host retains the
    Python-format bridge (oracle; wide-decimal inputs)."""
    return E.FormatNumber(child, decimals, out_len)


def format_number_host(child: E.Expr, decimals: int, out_len: int = 32) -> E.PythonUdf:
    def fn(v):
        if v is None:
            return None
        return format(round(float(v), decimals), f",.{decimals}f")

    return E.PythonUdf(fn, (child,), T.string(out_len), "format_number")


def str_to_map(child: E.Expr, pair_delim: str = ",", kv_delim: str = ":",
               max_elems: int = 16, key_len: int = 0, val_len: int = 0) -> E.PythonUdf:
    def fn(s):
        if s is None:
            return None
        out = {}
        for pair in s.split(pair_delim):
            if kv_delim in pair:
                k, v = pair.split(kv_delim, 1)
            else:
                k, v = pair, None
            out[k] = v
        return out

    return E.PythonUdf(
        fn, (child,),
        T.map_(T.string(key_len or 32), T.string(val_len or 64), max_elems),
        "str_to_map",
    )


def from_json(child: E.Expr, schema: T.DataType) -> E.PythonUdf:
    """Spark from_json(col, schema): parse JSON into a STRUCT/LIST/MAP value;
    null on malformed input (reference: json_funcs from_json)."""
    assert schema.is_nested, "from_json needs a STRUCT/LIST/MAP schema"

    def conv(doc, dt: T.DataType):
        if doc is None:
            return None
        try:
            if dt.is_struct:
                if not isinstance(doc, dict):
                    return None
                return {f.name: conv(doc.get(f.name), f.dtype) for f in dt.struct_fields}
            if dt.is_list:
                if not isinstance(doc, list):
                    return None
                return [conv(v, dt.element) for v in doc]
            if dt.is_map:
                if not isinstance(doc, dict):
                    return None
                return {k: conv(v, dt.value_type) for k, v in doc.items()}
            if dt.is_binary:
                return str(doc)
            if dt.is_boolean:
                return bool(doc)
            if dt.is_integer:
                return int(doc)
            return float(doc)
        except (TypeError, ValueError):
            return None

    def fn(s):
        if s is None:
            return None
        try:
            return conv(json.loads(s), schema)
        except (ValueError, TypeError):
            return None

    def batch_fn(mask, cv):
        """RAW batch mode: the input's host byte planes (a dictionary
        column's entries by code), each live row decoded and parsed."""
        import numpy as _np

        mask = _np.asarray(mask)
        n = mask.shape[0]
        if cv.is_dict:
            codes = _np.asarray(cv.data)
            mat = cv.dictionary.values[codes]
            lens = cv.dictionary.lengths[codes]
        else:
            mat = _np.asarray(cv.data)
            lens = _np.asarray(cv.lengths)
        valid = _np.asarray(cv.validity)
        out = [None] * n
        for i in _np.nonzero(mask & valid)[0]:
            out[i] = fn(bytes(mat[i, :lens[i]]).decode("utf-8", "replace"))
        return out

    return E.PythonUdf(fn, (child,), schema, "from_json",
                       batch_fn=batch_fn, batch_mode="raw")


def to_json(child: E.Expr, out_len: int = 0) -> E.PythonUdf:
    """Spark to_json(struct/map/array) → compact JSON string."""

    def fn(v):
        if v is None:
            return None
        return json.dumps(v, separators=(",", ":"), default=str)

    def batch_fn(mask, col):
        dumps = json.dumps
        return [dumps(v, separators=(",", ":"), default=str)
                if (m and v is not None) else None
                for m, v in zip(mask, col)]

    return E.PythonUdf(fn, (child,), T.string(out_len or T.DEFAULT_STRING_LEN),
                       "to_json", batch_fn=batch_fn)


def parse_url(child: E.Expr, part: str, key: str = "", out_len: int = 0) -> E.PythonUdf:
    """Spark parse_url(url, part[, key]) — HOST/PATH/QUERY/REF/PROTOCOL/
    AUTHORITY/FILE/USERINFO, or a named QUERY parameter."""
    from urllib.parse import parse_qs, urlparse

    def fn(s):
        if s is None:
            return None
        try:
            u = urlparse(s)
        except ValueError:
            return None
        if part == "QUERY" and key:
            vals = parse_qs(u.query).get(key)
            return vals[0] if vals else None
        return {
            "HOST": u.hostname,
            "PATH": u.path,
            "QUERY": u.query or None,
            "REF": u.fragment or None,
            "PROTOCOL": u.scheme or None,
            "AUTHORITY": u.netloc or None,
            "FILE": u.path + (("?" + u.query) if u.query else ""),
            "USERINFO": (u.username if u.password is None or u.username is None
                         else f"{u.username}:{u.password}") or None,
        }.get(part)

    return E.PythonUdf(fn, (child,), T.string(out_len or T.DEFAULT_STRING_LEN), "parse_url")


def from_csv(child: E.Expr, schema: T.DataType, sep: str = ",") -> E.PythonUdf:
    """Spark from_csv(col, schema[, options]): parse one CSV line into a
    STRUCT by position; null FIELDS on malformed cells, null row on None
    (reference: csv_funcs from_csv; QueryPlanSerde.scala:345)."""
    assert schema.is_struct, "from_csv needs a STRUCT schema"

    def cell(raw, dt: T.DataType):
        if raw is None or raw == "":
            return None
        try:
            if dt.is_binary:
                return raw
            if dt.is_boolean:
                return raw.strip().lower() == "true"
            if dt.is_integer:
                return int(raw.strip())
            return float(raw.strip())
        except (TypeError, ValueError):
            return None

    import csv as _csv
    import io as _io

    def fn(s):
        if s is None:
            return None
        try:
            row = next(_csv.reader(_io.StringIO(s), delimiter=sep))
        except (StopIteration, _csv.Error):
            row = []
        fields = schema.struct_fields
        row = list(row) + [None] * (len(fields) - len(row))
        return {f.name: cell(row[i], f.dtype) for i, f in enumerate(fields)}

    return E.PythonUdf(fn, (child,), schema, "from_csv")


def to_csv(child: E.Expr, sep: str = ",", out_len: int = 0) -> E.PythonUdf:
    """Spark to_csv(struct): one CSV line, fields in struct order; quoting
    per RFC4180 when a cell contains the separator/quote/newline."""
    import csv as _csv
    import io as _io

    def fn(v):
        if v is None:
            return None
        vals = list(v.values()) if isinstance(v, dict) else list(v)
        buf = _io.StringIO()
        w = _csv.writer(buf, delimiter=sep, lineterminator="")
        w.writerow(["" if x is None else
                    ("true" if x is True else "false" if x is False else x)
                    for x in vals])
        return buf.getvalue()

    return E.PythonUdf(fn, (child,), T.string(out_len or T.DEFAULT_STRING_LEN), "to_csv")


def _xpath_nodes(s: str, path: str):
    """ElementTree XPath-subset evaluation (documented deviation: full XPath
    1.0 — as in the reference's xpath kernels — is reduced to the
    ElementTree subset: tags, /, //, [@attr], [n], *)."""
    import xml.etree.ElementTree as ET

    try:
        root = ET.fromstring(s)
    except ET.ParseError:
        return None
    p = path.strip()
    attr = None
    if "/@" in p:
        p, attr = p.rsplit("/@", 1)
    if p.startswith("//"):
        p = ".//" + p[2:]
    elif p.startswith("/"):
        # absolute path: first segment must match the root tag
        segs = p[1:].split("/", 1)
        if segs[0] not in ("*", root.tag):
            return []
        p = "." if len(segs) == 1 else "./" + segs[1]
    nodes = root.findall(p) if p not in (".",) else [root]
    if attr is not None:
        return [n.get(attr) for n in nodes if n.get(attr) is not None]
    return nodes


def xpath(child: E.Expr, path: str, max_elems: int = 16, elem_len: int = 0) -> E.PythonUdf:
    """Spark xpath(xml, path) → array of node text values."""

    def fn(s):
        if s is None:
            return None
        nodes = _xpath_nodes(s, path)
        if nodes is None:
            return None
        return [(n if isinstance(n, str) else (n.text or "")) for n in nodes][:max_elems]

    return E.PythonUdf(
        fn, (child,), T.list_(T.string(elem_len or T.DEFAULT_STRING_LEN), max_elems), "xpath")


def xpath_string(child: E.Expr, path: str, out_len: int = 0) -> E.PythonUdf:
    def fn(s):
        if s is None:
            return None
        nodes = _xpath_nodes(s, path)
        if not nodes:
            return None
        n = nodes[0]
        return n if isinstance(n, str) else "".join(n.itertext())

    return E.PythonUdf(fn, (child,), T.string(out_len or T.DEFAULT_STRING_LEN), "xpath_string")


def xpath_boolean(child: E.Expr, path: str) -> E.PythonUdf:
    def fn(s):
        if s is None:
            return None
        nodes = _xpath_nodes(s, path)
        return bool(nodes)

    return E.PythonUdf(fn, (child,), T.BOOL, "xpath_boolean")


def _xpath_numeric(child: E.Expr, path: str, dt: T.DataType, conv, name: str) -> E.PythonUdf:
    def fn(s):
        if s is None:
            return None
        nodes = _xpath_nodes(s, path)
        if not nodes:
            return None
        n = nodes[0]
        txt = n if isinstance(n, str) else "".join(n.itertext())
        try:
            return conv(float(txt.strip()))
        except (TypeError, ValueError):
            return None

    return E.PythonUdf(fn, (child,), dt, name)


def xpath_int(child: E.Expr, path: str) -> E.PythonUdf:
    return _xpath_numeric(child, path, T.INT32, int, "xpath_int")


def xpath_long(child: E.Expr, path: str) -> E.PythonUdf:
    return _xpath_numeric(child, path, T.INT64, int, "xpath_long")


def xpath_short(child: E.Expr, path: str) -> E.PythonUdf:
    return _xpath_numeric(child, path, T.INT16, int, "xpath_short")


def xpath_float(child: E.Expr, path: str) -> E.PythonUdf:
    return _xpath_numeric(child, path, T.FLOAT32, float, "xpath_float")


def xpath_double(child: E.Expr, path: str) -> E.PythonUdf:
    return _xpath_numeric(child, path, T.FLOAT64, float, "xpath_double")


_JAVA_FMT = [  # Java DateTimeFormatter tokens -> strftime (common subset)
    ("yyyy", "%Y"), ("yy", "%y"), ("MMMM", "%B"), ("MMM", "%b"), ("MM", "%m"),
    ("dd", "%d"), ("HH", "%H"), ("hh", "%I"), ("mm", "%M"), ("ss", "%S"),
    ("EEEE", "%A"), ("EEE", "%a"), ("DDD", "%j"), ("a", "%p"),
]


def date_format(child: E.Expr, pattern: str, out_len: int = 0,
                tz: str = "UTC") -> E.PythonUdf:
    """Spark date_format(ts, javaPattern) — host bridge translating the
    common Java DateTimeFormatter tokens to strftime (documented deviation:
    exotic tokens — 'G', 'Q', zone names — are unsupported and raise at
    plan time). Reference: datetime_funcs date_format."""
    import re as _re

    fmt = pattern
    for j, s_ in _JAVA_FMT:
        fmt = fmt.replace(j, s_)
    leftover = _re.sub(r"%[A-Za-z]", "", fmt)
    if _re.search(r"[A-Za-z]", leftover.replace("T", "")):
        raise NotImplementedError(f"date_format pattern token in {pattern!r}")

    from datetime import datetime, timedelta, timezone

    def fn(v):
        if v is None:
            return None
        if isinstance(v, (int,)):  # DATE days or TIMESTAMP micros
            if abs(v) < 10_000_000:  # days since epoch
                dt = datetime(1970, 1, 1, tzinfo=timezone.utc) + timedelta(days=int(v))
            else:
                dt = datetime(1970, 1, 1, tzinfo=timezone.utc) + timedelta(
                    microseconds=int(v))
        else:
            return None
        return dt.strftime(fmt)

    return E.PythonUdf(fn, (child,), T.string(out_len or max(len(pattern) * 2, 24)),
                       "date_format")


def overlay(child: E.Expr, repl: str, pos: int, length: int = -1,
            out_len: int = 0) -> E.PythonUdf:
    """Spark overlay(input, replace, pos[, len]): 1-based splice."""

    def fn(s):
        if s is None:
            return None
        p = max(pos, 1) - 1
        ln = len(repl) if length < 0 else length
        return s[:p] + repl + s[p + ln:]

    return E.PythonUdf(fn, (child,), T.string(out_len or T.DEFAULT_STRING_LEN), "overlay")


def find_in_set(child: E.Expr, str_list: E.Expr) -> E.PythonUdf:
    """Spark find_in_set(s, csv): 1-based index, 0 when absent or s has a
    comma."""

    def fn(s, lst):
        if s is None or lst is None:
            return None
        if "," in s:
            return 0
        parts = lst.split(",")
        return parts.index(s) + 1 if s in parts else 0

    return E.PythonUdf(fn, (child, str_list), T.INT32, "find_in_set")


def format_string(fmt: str, *args: E.Expr, out_len: int = 0) -> E.PythonUdf:
    """Spark format_string(javaFormat, args...) — %s/%d/%f family."""

    def fn(*vals):
        if any(v is None for v in vals):
            return None
        return fmt % tuple(vals)

    return E.PythonUdf(fn, tuple(args), T.string(out_len or max(len(fmt) * 2, 32)),
                       "format_string")


def _parse_number(s, fmt: str):
    neg = False
    t = s.strip()
    if fmt.endswith("MI"):
        if t.endswith("-"):
            neg, t = True, t[:-1]
    elif fmt.startswith("S") or "S" in fmt:
        if t.startswith("-"):
            neg, t = True, t[1:]
        elif t.startswith("+"):
            t = t[1:]
    t = t.replace(",", "").lstrip("$")
    if not t or any(c not in "0123456789." for c in t):
        raise ValueError(f"'{s}' does not match format '{fmt}'")
    from decimal import Decimal

    v = Decimal(t)
    return -v if neg else v


def _number_fmt_type(fmt: str) -> T.DataType:
    digits = fmt.count("9") + fmt.count("0")
    scale = len(fmt.rsplit("D", 1)[-1].replace("9", "x")) if "D" in fmt else 0
    scale = fmt.rsplit("D", 1)[-1].count("9") if "D" in fmt else (
        fmt.rsplit(".", 1)[-1].count("9") if "." in fmt else 0)
    return T.decimal(max(digits, 1), scale)


def to_number(child: E.Expr, fmt: str) -> E.PythonUdf:
    """Spark to_number(str, fmt) — '9/0/D/./,/G/$/S/MI' subset; malformed
    input raises (use try_to_number for null-on-error)."""
    dt = _number_fmt_type(fmt)

    def fn(s):
        if s is None:
            return None
        v = _parse_number(s, fmt)
        return int(v.scaleb(dt.scale))

    return E.PythonUdf(fn, (child,), dt, "to_number")


def try_to_number(child: E.Expr, fmt: str) -> E.PythonUdf:
    dt = _number_fmt_type(fmt)

    def fn(s):
        if s is None:
            return None
        try:
            return int(_parse_number(s, fmt).scaleb(dt.scale))
        except (ValueError, ArithmeticError):
            return None

    return E.PythonUdf(fn, (child,), dt, "try_to_number")


def make_timestamp(y: E.Expr, mo: E.Expr, d: E.Expr, h: E.Expr, mi: E.Expr,
                   s: E.Expr) -> E.PythonUdf:
    """Spark make_timestamp(y,m,d,h,min,sec) → timestamp (NULL on invalid
    components; sec may carry a fraction)."""
    from datetime import datetime, timezone

    def fn(yy, mm, dd, hh, mn, ss):
        if any(v is None for v in (yy, mm, dd, hh, mn, ss)):
            return None
        try:
            whole = int(ss)
            frac = float(ss) - whole
            dt = datetime(int(yy), int(mm), int(dd), int(hh), int(mn), whole,
                          tzinfo=timezone.utc)
            return int(dt.timestamp() * 1_000_000 + round(frac * 1e6))
        except (ValueError, OverflowError):
            return None

    return E.PythonUdf(fn, (y, mo, d, h, mi, s), T.TIMESTAMP_NTZ, "make_timestamp")


def python_udf(fn, args, out_dtype: T.DataType, name: str = "python_udf") -> E.PythonUdf:
    """Register-free scalar Python UDF (the ScalaUDF analog: reference
    QueryPlanSerde.scala:358 ScalaUDF serde + CometScalaUDFCodegen)."""
    return E.PythonUdf(fn, tuple(args), out_dtype, name)

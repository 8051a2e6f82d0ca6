"""Host-side evaluation of a dimension table's filters for the runtime
filters (exec/runtime_filter.py): the port's own copy of
``datafusion_comet_tpu/exec/host_filter.py``, reading the port's ``Batch``.

The dimension side of a runtime filter is a Scan -> Filter (-> Projection)
chain over a small registered table. It is evaluated with numpy at plan
time, and its surviving join keys become a constant build table.

Soundness: a runtime filter may only keep a SUPERSET of the true key set.
A conjunct this evaluator does not understand is skipped: the key set is
then less selective but still correct. ``applied`` says whether at least
one conjunct ran (the injector skips the filter otherwise).

Conjuncts understood (vectorized numpy): comparisons of integers, dates and
narrow decimals with literals, string equality, LIKE (prefix, suffix,
contains, exact, and any other pattern by a regex per row), IN lists,
IS [NOT] NULL of a column, NOT where every column under it is free of
nulls, and AND / OR, looking through aliases and integer, date and decimal
casts. A comparison with a scalar subquery (its value is known only when
the plan runs) and a bloom-filter probe are not understood: skipped, as in
the JAX package.
"""

from __future__ import annotations

import dataclasses
import re
from typing import Dict, List, Optional, Tuple

import numpy as np

from datafusion_comet_tpu_torch import types as T
from datafusion_comet_tpu_torch.exec.batch import Batch
from datafusion_comet_tpu_torch.ir import expr as E

__all__ = ["HostColumns", "eval_dim_filter"]


@dataclasses.dataclass
class _Col:
    """Host view of one column: numeric (``vals``) or string (``mat`` and
    ``lens``, or dictionary ``codes`` and ``dict_values``); ``valid``
    always."""

    valid: np.ndarray
    vals: Optional[np.ndarray] = None
    mat: Optional[np.ndarray] = None  # (n, w) uint8
    lens: Optional[np.ndarray] = None
    codes: Optional[np.ndarray] = None
    dict_values: Optional[List[bytes]] = None

    @property
    def is_string(self) -> bool:
        return self.mat is not None or self.codes is not None


def _host(t) -> np.ndarray:
    return t.cpu().numpy()


class HostColumns:
    """Host copies of a registered Batch's columns, made on first use and
    kept: one object per registered batch serves every plan that reads it
    (the batch is immutable, so the copies stay exact)."""

    def __init__(self, batch: Batch):
        self._batch = batch
        self._cols: Dict[str, _Col] = {}
        self.row_mask = _host(batch.row_mask)

    @property
    def batch(self) -> Batch:
        return self._batch

    def dtype(self, name: str) -> T.DataType:
        return self._batch.schema.field(name).dtype

    def get(self, name: str) -> Optional[_Col]:
        if name in self._cols:
            return self._cols[name]
        try:
            i = self._batch.schema.index_of(name)
        except (KeyError, ValueError):
            return None
        cv = self._batch.columns[i]
        dt = cv.dtype
        valid = _host(cv.validity)
        col: Optional[_Col] = None
        if cv.is_dict:
            d = cv.dictionary
            col = _Col(valid, codes=_host(cv.data),
                       dict_values=[d.value_of(c) for c in range(d.size)])
        elif dt.is_binary:
            col = _Col(valid, mat=_host(cv.data), lens=_host(cv.lengths))
        elif cv.data.dim() == 1 and (dt.is_integer or dt.type_id == "DATE" or dt.is_decimal
                                     or dt.is_boolean):
            col = _Col(valid, vals=_host(cv.data))
        if col is not None:
            self._cols[name] = col
        return col


def _conjuncts(e: E.Expr) -> List[E.Expr]:
    if isinstance(e, E.BinaryOp) and e.op == "and":
        return _conjuncts(e.left) + _conjuncts(e.right)
    return [e]


def _strip(e: E.Expr) -> E.Expr:
    while isinstance(e, E.Alias):
        e = e.child
    return e


def _col_name(e: E.Expr, cols: Optional["HostColumns"] = None) -> Optional[str]:
    e = _strip(e)
    # integer-width, date and decimal casts of an integer, date or decimal
    # column keep the values the comparisons read; a string cast does not,
    # nor does a cast of a string, float or timestamp column (a parse, a
    # rounding, a day of an instant), which the device evaluates
    cast = False
    while isinstance(e, E.Cast) and (e.to.is_integer or e.to.type_id == "DATE"
                                     or e.to.is_decimal):
        e, cast = _strip(e.child), True
    if not isinstance(e, (E.ColumnRef, E.BoundRef)):
        return None
    if cast:
        dt = cols.dtype(e.col_name) if cols is not None and cols.get(e.col_name) else None
        if dt is None or not (dt.is_integer or dt.is_decimal or dt.type_id == "DATE"):
            return None
    return e.col_name


def _lit_value(e: E.Expr):
    e = _strip(e)
    if isinstance(e, E.Literal):
        return e.value, e.lit_dtype
    return None


def _scale_lit(value, lit_dtype: T.DataType, col_dtype: T.DataType):
    """A numeric literal in the column's storage (a decimal's unscaled int)."""
    if value is None:
        return None
    if col_dtype.is_decimal:
        ls = lit_dtype.scale if lit_dtype.is_decimal else 0
        if isinstance(value, float):
            return int(round(value * (10 ** col_dtype.scale)))
        return int(value) * (10 ** (col_dtype.scale - ls)) if col_dtype.scale >= ls else None
    if isinstance(value, (int, np.integer)):
        return int(value)
    if isinstance(value, float) and float(value).is_integer():
        return int(value)
    return None


def _str_bytes(v) -> Optional[bytes]:
    if isinstance(v, bytes):
        return v
    if isinstance(v, str):
        return v.encode("utf-8")
    return None


def _string_eq(col: _Col, pat: bytes) -> np.ndarray:
    if col.codes is not None:
        hits = np.array([dv == pat for dv in col.dict_values], bool)
        if not hits.any():
            return np.zeros(len(col.codes), bool)
        return hits[np.clip(col.codes, 0, len(hits) - 1)]
    w = col.mat.shape[1]
    if len(pat) > w:
        return np.zeros(len(col.mat), bool)
    pad = pat + b"\x00" * (w - len(pat))
    return (col.lens == len(pat)) & (col.mat == np.frombuffer(pad, np.uint8)).all(axis=1)


def _decoded(col: _Col) -> List[bytes]:
    if col.codes is not None:
        dv = col.dict_values
        return [dv[c] if 0 <= c < len(dv) else b"" for c in col.codes]
    return [bytes(col.mat[i, : col.lens[i]]) for i in range(len(col.mat))]


def _like_mask(col: _Col, pattern: str) -> np.ndarray:
    """LIKE over a host column: a dictionary's entries through the regex, a
    padded matrix by window compares for the prefix, suffix, contains and
    exact shapes, by the regex per row otherwise. '_' is one byte."""
    pat = pattern.encode("utf-8")
    n = len(col.codes) if col.codes is not None else len(col.mat)
    if col.codes is not None:
        rx = _like_regex(pat)
        hits = np.array([rx.fullmatch(dv) is not None for dv in col.dict_values], bool)
        if not len(hits):
            return np.zeros(n, bool)
        return hits[np.clip(col.codes, 0, len(hits) - 1)]
    mat, lens = col.mat, col.lens
    w = mat.shape[1]
    has_us = b"_" in pat
    segs = pat.split(b"%")
    if not has_us and len(segs) == 1:  # exact
        return _string_eq(col, pat)
    if not has_us and len(segs) == 2 and segs[0] and not segs[1]:  # 'abc%'
        p = segs[0]
        if len(p) > w:
            return np.zeros(n, bool)
        return (lens >= len(p)) & (mat[:, : len(p)] == np.frombuffer(p, np.uint8)).all(axis=1)
    if not has_us and len(segs) == 2 and segs[1] and not segs[0]:  # '%abc'
        p = np.frombuffer(segs[1], np.uint8)
        k = len(p)
        if k > w:
            return np.zeros(n, bool)
        hit = (np.lib.stride_tricks.sliding_window_view(mat, k, axis=1) == p).all(axis=2)
        pos = lens - k
        return (pos >= 0) & hit[np.arange(n), np.clip(pos, 0, w - k)]
    if not has_us and len(segs) == 3 and not segs[0] and not segs[2] and segs[1]:  # '%abc%'
        p = np.frombuffer(segs[1], np.uint8)
        k = len(p)
        if k > w:
            return np.zeros(n, bool)
        hit = (np.lib.stride_tricks.sliding_window_view(mat, k, axis=1) == p).all(axis=2)
        end_ok = np.arange(w - k + 1)[None, :] + k <= lens[:, None]
        return (hit & end_ok).any(axis=1)
    rx = _like_regex(pat)  # any other pattern: a regex per row
    return np.array([rx.fullmatch(s) is not None for s in _decoded(col)], bool)


def _like_regex(pat: bytes) -> "re.Pattern":
    out = b""
    for ch in pat:
        b = bytes([ch])
        if b == b"%":
            out += b".*"
        elif b == b"_":
            out += b"."
        else:
            out += re.escape(b)
    return re.compile(out, re.DOTALL)


_CMP = {"eq": np.equal, "ne": np.not_equal, "lt": np.less, "le": np.less_equal,
        "gt": np.greater, "ge": np.greater_equal}


def _eval_conjunct(c: E.Expr, cols: HostColumns) -> Optional[np.ndarray]:
    """A conjunct's rows under SQL semantics with a null comparison false
    (sound for a filter); None where it is not understood."""
    if isinstance(c, E.UnaryOp) and c.op == "not":
        # the child reads a null as false, so its negation is sound only
        # where no column under it holds a null
        inner = _eval_conjunct(c.child, cols)
        if inner is None:
            return None
        for nm in _expr_columns(c.child):
            hc = cols.get(nm)
            if hc is None or not hc.valid.all():
                return None
        return ~inner
    if isinstance(c, E.UnaryOp) and c.op in ("isnull", "isnotnull"):
        nm = _col_name(c.child, cols)
        hc = cols.get(nm) if nm else None
        if hc is None:
            return None
        return ~hc.valid if c.op == "isnull" else hc.valid.copy()
    if isinstance(c, E.BinaryOp) and c.op in ("or", "and"):
        a = _eval_conjunct(c.left, cols)
        b = _eval_conjunct(c.right, cols)
        if a is None or b is None:
            return None
        return a | b if c.op == "or" else a & b
    if isinstance(c, E.Like):
        nm = _col_name(c.child, cols)
        hc = cols.get(nm) if nm else None
        if hc is None or not hc.is_string:
            return None
        m = _like_mask(hc, c.pattern) & hc.valid
        return (~m & hc.valid) if c.negated else m
    if isinstance(c, E.InList):
        nm = _col_name(c.child, cols)
        hc = cols.get(nm) if nm else None
        if hc is None:
            return None
        vals = [_lit_value(v) for v in c.values]
        if any(v is None for v in vals):
            return None
        if hc.is_string:
            pats = [_str_bytes(v) for v, _ in vals]
            if any(p is None for p in pats):
                return None
            m = np.zeros(len(hc.valid), bool)
            for p in pats:
                m |= _string_eq(hc, p)
        elif hc.vals is not None:
            lits = [_scale_lit(v, dt, cols.dtype(nm)) for v, dt in vals]
            if any(v is None for v in lits):
                return None
            m = np.isin(hc.vals, np.array(lits, dtype=np.int64))
        else:
            return None
        m = m & hc.valid
        return (~m & hc.valid) if c.negated else m
    if isinstance(c, E.BinaryOp) and c.op in _CMP:
        for a, b, flip in ((c.left, c.right, False), (c.right, c.left, True)):
            nm = _col_name(a, cols)
            lit = _lit_value(b)
            if nm is None or lit is None:
                continue
            hc = cols.get(nm)
            if hc is None:
                continue
            op = c.op
            if flip:
                op = {"lt": "gt", "le": "ge", "gt": "lt", "ge": "le"}.get(op, op)
            value, ldt = lit
            if hc.is_string:
                if op not in ("eq", "ne"):
                    return None
                p = _str_bytes(value)
                if p is None:
                    return None
                m = _string_eq(hc, p)
                return (~m & hc.valid) if op == "ne" else (m & hc.valid)
            if hc.vals is not None:
                v = _scale_lit(value, ldt, cols.dtype(nm))
                if v is None:
                    return None
                return _CMP[op](hc.vals, v) & hc.valid
        return None
    return None


def _expr_columns(e: E.Expr) -> List[str]:
    """Every column an expression reads."""
    if isinstance(e, (E.ColumnRef, E.BoundRef)):
        return [e.col_name]
    return [nm for k in e.children() for nm in _expr_columns(k)]


def eval_dim_filter(batch: Batch, predicates: List[E.Expr],
                    cols: Optional[HostColumns] = None) -> Tuple[np.ndarray, bool]:
    """The conjunction of ``predicates`` over a registered batch, on the
    host: (mask over its capacity, the live-row mask included; applied).
    Conjuncts not understood are skipped (the mask stays a superset);
    ``applied`` is whether at least one ran. ``cols``: the batch's host
    copies where the caller keeps them."""
    cols = cols if cols is not None else HostColumns(batch)
    mask = cols.row_mask.copy()
    applied = False
    for p in predicates:
        for c in _conjuncts(p):
            m = _eval_conjunct(c, cols)
            if m is not None:
                mask &= m
                applied = True
    return mask, applied

"""Nested-type expressions: LIST, STRUCT and MAP (port of
``datafusion_comet_tpu/exec/nested.py``).

A LIST column carries a fixed per-row element capacity E (types.py
``list_``), so every array function is a dense op over the (cap, E)
element buffers ((cap, E, L) for string elements): no loop over rows, no
data-dependent shape. Compaction (distinct, remove, except, filter) is a
stable argsort of the drop flags along the element axis; membership is a
broadcast pairwise equality.

Null semantics follow Spark, as the JAX module's docstring states them:
- a null array or map input gives null;
- ``array_contains`` (and ``arrays_overlap``) give null, not false, when
  nothing matched and the array holds a null element;
- membership compares by ordering equality: NaN equals NaN.

A MAP is a list of STRUCT(key, value) entries whose keys are de-duplicated
keeping the last (Spark's LAST_WIN policy); a null key is an error on the
ANSI side channel.

Higher-order functions evaluate their lambda body once over the flattened
(cap * E,) element plane, the batch's columns repeated E times beside it;
``aggregate`` folds over the E element slots in order.

A dictionary-coded string is decoded before it becomes an element, so
element buffers always hold bytes.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Tuple

import torch

from datafusion_comet_tpu_torch import types as T
from datafusion_comet_tpu_torch.exec.batch import Batch, ColumnVector, map_buffers
from datafusion_comet_tpu_torch.ir import expr as E

__all__ = ["ev_nested", "ev_hof", "ev_split", "present", "list_cv"]


# -------------------------------------------------------------------------------------
# helpers
# -------------------------------------------------------------------------------------


def present(arr: ColumnVector) -> torch.Tensor:
    """(cap, E) bool: the slot holds an element (position < length)."""
    e_cap = arr.children[0].validity.shape[1]
    return torch.arange(e_cap, device=arr.data.device)[None, :] < arr.data[:, None].long()


def list_cv(lens: torch.Tensor, validity: torch.Tensor, elem: ColumnVector,
            dtype: T.DataType) -> ColumnVector:
    return ColumnVector(lens.int(), validity, None, dtype, children=(elem,))


def _pad_last(mat: torch.Tensor, w: int) -> torch.Tensor:
    return mat if mat.shape[-1] == w else torch.nn.functional.pad(mat, (0, w - mat.shape[-1]))


def _take1(a: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``a`` (cap, E, ...) gathered along the element axis by ``idx`` (cap, E')."""
    i = idx.long().reshape(idx.shape + (1,) * (a.dim() - 2))
    return a.gather(1, i.expand(idx.shape + a.shape[2:]))


def _eq_data(a_data, a_len, b_data, b_len, dtype: T.DataType) -> torch.Tensor:
    """Ordering equality of two broadcastable element buffers (strings:
    lengths, then bytes)."""
    if dtype.is_binary:
        w = max(a_data.shape[-1], b_data.shape[-1])
        byte_eq = (_pad_last(a_data, w) == _pad_last(b_data, w)).all(-1)
        return byte_eq & (a_len == b_len)
    if dtype.is_floating:
        return (a_data == b_data) | (torch.isnan(a_data) & torch.isnan(b_data))
    return a_data == b_data


def _elem_vs_scalar_eq(elem: ColumnVector, scalar: ColumnVector, dtype: T.DataType):
    """(cap, E): each element equals the row's scalar."""
    if dtype.is_binary:
        return _eq_data(elem.data, elem.lengths, scalar.data[:, None, :],
                        scalar.lengths[:, None], dtype)
    return _eq_data(elem.data, None, scalar.data[:, None], None, dtype)


def _pairwise_eq(a: ColumnVector, b: ColumnVector, dtype: T.DataType) -> torch.Tensor:
    """(cap, Ea, Eb) equality of the elements of two element columns."""
    if dtype.is_binary:
        return _eq_data(a.data[:, :, None, :], a.lengths[:, :, None],
                        b.data[:, None, :, :], b.lengths[:, None, :], dtype)
    return _eq_data(a.data[:, :, None], None, b.data[:, None, :], None, dtype)


def _compact(keep: torch.Tensor, elem: ColumnVector) -> Tuple[torch.Tensor, ColumnVector]:
    """Stable left-compaction of the kept elements: (new lengths, elements)."""
    order = torch.argsort((~keep).to(torch.int8), dim=1, stable=True)
    out = map_buffers(elem, lambda a: _take1(a, order))
    return keep.sum(1).int(), out.with_validity(out.validity & keep.gather(1, order))


def _scalar_to_elem(cv: ColumnVector, e_cap: int) -> ColumnVector:
    """A per-row column broadcast to a (cap, E) element column."""
    return map_buffers(cv, lambda a: a[:, None].expand((a.shape[0], e_cap) + a.shape[1:]))


def _set_item(elem: ColumnVector, at: torch.Tensor, value: ColumnVector) -> ColumnVector:
    """``value`` (per row) written into element slot ``at`` (cap,)."""
    e_cap = elem.validity.shape[1]
    hit = torch.arange(e_cap, device=at.device)[None, :] == at.long()[:, None]

    def put(ed, vd):
        if ed is None:
            return None
        if ed.dim() == 3 and vd.shape[-1] != ed.shape[-1]:
            w = max(ed.shape[-1], vd.shape[-1])
            ed, vd = _pad_last(ed, w), _pad_last(vd, w)
        h = hit.reshape(hit.shape + (1,) * (ed.dim() - 2))
        return torch.where(h, vd[:, None], ed)

    return ColumnVector(put(elem.data, value.data), torch.where(hit, value.validity[:, None],
                                                                elem.validity),
                        put(elem.lengths, value.lengths), elem.dtype,
                        children=tuple(_set_item(c, at, vc)
                                       for c, vc in zip(elem.children, value.children)))


def _gather_item(elem: ColumnVector, idx: torch.Tensor) -> ColumnVector:
    """One element a row, at element index ``idx`` (cap,)."""
    return map_buffers(elem, lambda a: _take1(a, idx[:, None])[:, 0])


def _stack_scalars(cvs, dtype: T.DataType) -> ColumnVector:
    """N per-row columns stacked into a (cap, N) element column."""

    def pick(field):
        parts = [getattr(c, field) for c in cvs]
        if any(p is None for p in parts):
            return None
        if dtype.is_binary and field == "data":
            w = max(p.shape[-1] for p in parts)
            parts = [_pad_last(p, w) for p in parts]
        return torch.stack(parts, dim=1)

    kids = tuple(_stack_scalars([c.children[i] for c in cvs], cvs[0].children[i].dtype)
                 for i in range(len(cvs[0].children)))
    return ColumnVector(pick("data"), pick("validity"), pick("lengths"), dtype, children=kids)


def _orderable_key(elem: ColumnVector) -> torch.Tensor:
    """An exact int64 total-order key per element, Spark's order: NaN
    greatest (every NaN one value), -0.0 equal to 0.0; a float's bits with
    the sign trick."""
    dt, d = elem.dtype, elem.data
    if dt.is_floating:
        d = torch.where(d == 0, torch.zeros_like(d), d)
        wide = dt.type_id == "DOUBLE"
        bits = d.contiguous().view(torch.int64 if wide else torch.int32).long()
        if not wide:
            bits = torch.where(bits < 0, (~bits) ^ (-(1 << 31)), bits)
        else:
            bits = torch.where(bits < 0, (~bits) ^ torch.iinfo(torch.int64).min, bits)
        return torch.where(torch.isnan(d), torch.iinfo(torch.int64).max, bits)
    return d.long()


def _coerced(ev, a: E.Expr, b: Batch, ctx, to: T.DataType) -> ColumnVector:
    from datafusion_comet_tpu_torch.exec import evaluator as EV

    return EV._coerce(ev(a, b, ctx).decode(), to)


def _widen(elem: ColumnVector, extra: int) -> ColumnVector:
    """``extra`` more element slots (zeros, invalid)."""
    return map_buffers(elem, lambda a: torch.cat(
        [a, torch.zeros((a.shape[0], extra) + a.shape[2:], dtype=a.dtype, device=a.device)], 1))


# -------------------------------------------------------------------------------------
# dispatch
# -------------------------------------------------------------------------------------


def ev_nested(e: E.Expr, b: Batch, ctx, ev: Callable) -> ColumnVector:
    if isinstance(e, E.StructExpr):
        kids = tuple(ev(a, b, ctx) for a in e.args)
        return ColumnVector(torch.zeros(b.capacity, dtype=torch.int8, device=b.device),
                            torch.ones(b.capacity, dtype=torch.bool, device=b.device), None,
                            e.dtype, children=kids)
    if isinstance(e, E.GetStructField):
        c = ev(e.child, b, ctx)
        out = c.children[e.field]
        return out.with_validity(out.validity & c.validity)
    if isinstance(e, E.ArrayExpr):
        return _ev_array(e, b, ctx, ev)
    if isinstance(e, E.MapExpr):
        return _ev_map(e, b, ctx, ev)
    raise NotImplementedError(type(e).__name__)


def _ev_array(e: E.ArrayExpr, b: Batch, ctx, ev: Callable) -> ColumnVector:
    f = e.func
    cap, dev = b.capacity, b.device
    if f == "array":
        et = e.dtype.element
        vals = [_coerced(ev, a, b, ctx, et) for a in e.args]
        return list_cv(torch.full((cap,), len(vals), dtype=torch.int32, device=dev),
                       torch.ones(cap, dtype=torch.bool, device=dev),
                       _stack_scalars(vals, et), e.dtype)

    arr = ev(e.args[0], b, ctx)
    if f == "array_repeat":  # (value, count): the first argument is the value
        val = arr.decode()
        cnt = _coerced(ev, e.args[1], b, ctx, T.INT32)
        e_cap = e.dtype.max_elems
        return list_cv(cnt.data.clamp(0, e_cap), cnt.validity, _scalar_to_elem(val, e_cap),
                       e.dtype)
    if f == "size":
        return ColumnVector(arr.data.int(), arr.validity, None, T.INT32)
    elem = arr.children[0]
    e_cap = elem.validity.shape[1]
    pos = torch.arange(e_cap, device=dev)[None, :]

    if f in ("array_contains", "array_position"):
        et = arr.dtype.element
        val = _coerced(ev, e.args[1], b, ctx, et)
        pres = present(arr)
        hit = pres & elem.validity & _elem_vs_scalar_eq(elem, val, et)
        any_hit = hit.any(1)
        valid = arr.validity & val.validity
        if f == "array_position":
            first = hit.to(torch.uint8).argmax(1).long() + 1
            return ColumnVector(torch.where(any_hit, first, 0), valid, None, T.INT64)
        has_null_item = (pres & ~elem.validity).any(1)
        return ColumnVector(any_hit, valid & (any_hit | ~has_null_item), None, T.BOOL)

    if f in ("element_at", "get_array_item"):
        idx_cv = _coerced(ev, e.args[1], b, ctx, T.INT32)
        lens, i = arr.data.long(), idx_cv.data.long()
        if f == "element_at":  # 1-based, negative from the end
            ctx.record_error(idx_cv.validity & (i == 0) & b.row_mask,
                             "SQL array indices start at 1")
            idx0 = torch.where(i > 0, i - 1, lens + i)
        else:
            idx0 = i
        in_range = (idx0 >= 0) & (idx0 < lens)
        item = _gather_item(elem, idx0.clamp(0, e_cap - 1))
        return item.with_validity(arr.validity & idx_cv.validity & in_range & item.validity)

    if f in ("array_min", "array_max"):
        ok = present(arr) & elem.validity
        key = _orderable_key(elem)
        lo, hi = torch.iinfo(torch.int64).min, torch.iinfo(torch.int64).max
        if f == "array_min":
            sel = torch.where(ok, key, hi).argmin(1)
        else:
            sel = torch.where(ok, key, lo).argmax(1)
        item = _gather_item(elem, sel)
        return item.with_validity(arr.validity & ok.any(1))

    if f == "sort_array":
        a1 = e.args[1] if len(e.args) > 1 else None
        asc = bool(a1.value) if isinstance(a1, E.Literal) else True
        pres = present(arr)
        # nulls first ascending, last descending; absent slots at the end;
        # a descending key is its bitwise not (no overflow)
        rank = torch.where(~pres, 3, torch.where(elem.validity, 1, 0 if asc else 2))
        key = _orderable_key(elem)
        k = key if asc else ~key
        order = torch.argsort(k, dim=1, stable=True)
        order = order.gather(1, torch.argsort(rank.gather(1, order), dim=1, stable=True))
        return list_cv(arr.data, arr.validity, map_buffers(elem, lambda a: _take1(a, order)),
                       e.dtype)

    if f in ("array_distinct", "array_compact", "array_remove"):
        pres = present(arr)
        if f == "array_compact":
            keep = pres & elem.validity
        elif f == "array_remove":
            et = arr.dtype.element
            val = _coerced(ev, e.args[1], b, ctx, et)
            eq = _elem_vs_scalar_eq(elem, val, et)
            keep = pres & ~(eq & elem.validity & val.validity[:, None])
        else:
            return _ev_distinct(arr, e.dtype)
        lens, out = _compact(keep, elem)
        return list_cv(lens, arr.validity, out, e.dtype)

    if f == "array_reverse":
        lens = arr.data.long()[:, None]
        src = torch.where(pos < lens, lens - 1 - pos, pos)
        return list_cv(arr.data, arr.validity, map_buffers(elem, lambda a: _take1(a, src)),
                       e.dtype)

    if f in ("array_append", "array_prepend"):
        val = _coerced(ev, e.args[1], b, ctx, arr.dtype.element)
        wid = _widen(elem, 1)
        if f == "array_append":
            out = _set_item(wid, arr.data, val)
        else:
            out = _set_item(map_buffers(wid, lambda a: torch.roll(a, 1, dims=1)),
                            torch.zeros(cap, dtype=torch.int64, device=dev), val)
        return list_cv(arr.data + 1, arr.validity, out, e.dtype)

    if f == "arrays_overlap":
        other = ev(e.args[1], b, ctx)
        eb = other.children[0]
        pa, pb = present(arr), present(other)
        pe = _pairwise_eq(elem, eb, arr.dtype.element)
        ok = pe & (pa & elem.validity)[:, :, None] & (pb & eb.validity)[:, None, :]
        any_hit = ok.any(2).any(1)
        has_null = (pa & ~elem.validity).any(1) | (pb & ~eb.validity).any(1)
        non_empty = (arr.data > 0) & (other.data > 0)
        valid = arr.validity & other.validity & (any_hit | ~(has_null & non_empty))
        return ColumnVector(any_hit, valid, None, T.BOOL)

    if f == "array_insert":  # 1-based; past the end pads with nulls; negative from the end
        val = _coerced(ev, e.args[2], b, ctx, e.dtype.element)
        pos_cv = ev(e.args[1], b, ctx)
        p = pos_cv.data.long()
        lens = arr.data.long()
        at = torch.where(p > 0, p - 1, lens + p + 1).clamp(0, e_cap)
        slot = torch.arange(e_cap + 1, device=dev)[None, :]
        src = torch.where(slot > at[:, None], slot - 1, slot)
        shifted = map_buffers(_widen(elem, 1), lambda a: _take1(a, src))
        out = _set_item(shifted, at, val)
        ctx.record_error(pos_cv.validity & (p == 0) & b.row_mask,
                         "array_insert position 0 is invalid")
        ok = arr.validity & pos_cv.validity & (p != 0)
        return list_cv(torch.maximum(lens + 1, at + 1).clamp(max=e_cap + 1), ok, out, e.dtype)

    if f == "arrays_zip":
        arrs = [arr] + [ev(a, b, ctx) for a in e.args[1:]]
        w = max(a.children[0].validity.shape[1] for a in arrs)
        valid, lens, kids = arrs[0].validity, arrs[0].data, []
        for a in arrs:
            el = a.children[0]
            n_ = el.validity.shape[1]
            el = _widen(el, w - n_) if w > n_ else el
            within = torch.nn.functional.pad(present(a), (0, w - n_))
            kids.append(el.with_validity(el.validity & within))
            valid = valid & a.validity
            lens = torch.maximum(lens, a.data)
        struct_elem = ColumnVector(torch.zeros((cap, w), dtype=torch.int8, device=dev),
                                   torch.ones((cap, w), dtype=torch.bool, device=dev), None,
                                   e.dtype.element, children=tuple(kids))
        return list_cv(lens, valid, struct_elem, e.dtype)

    if f == "get_array_struct_field":
        field = elem.children[int(e.args[1].value)]
        return list_cv(arr.data, arr.validity, field.with_validity(field.validity
                                                                   & elem.validity), e.dtype)

    if f == "slice":
        start = _coerced(ev, e.args[1], b, ctx, T.INT32)
        length = _coerced(ev, e.args[2], b, ctx, T.INT32)
        ctx.record_error(start.validity & (start.data == 0) & b.row_mask,
                         "Unexpected value for start in function slice: SQL array indices "
                         "start at 1")
        ctx.record_error(length.validity & (length.data < 0) & b.row_mask,
                         "Unexpected value for length in function slice: length must be "
                         "greater than or equal to 0")
        lens, st, ln = arr.data.long(), start.data.long(), length.data.long()
        st0 = torch.where(st > 0, st - 1, lens + st)
        src = st0[:, None] + pos
        new_pres = (pos < ln[:, None]) & (src >= 0) & (src < lens[:, None])
        srcc = src.clamp(0, e_cap - 1)
        out = map_buffers(elem, lambda a: _take1(a, srcc))
        out = out.with_validity(out.validity & new_pres)
        valid = (arr.validity & start.validity & length.validity
                 & (((st0 >= 0) & (st0 <= lens)) | (lens == 0)))
        return list_cv(new_pres.sum(1), valid, out, e.dtype)

    if f in ("array_union", "array_intersect", "array_except"):
        other = ev(e.args[1], b, ctx)
        et = e.dtype.element
        ea = _coerce_elem(elem, et)
        eb = _coerce_elem(other.children[0], et)
        pa, pb = present(arr), present(other)
        pe = _pairwise_eq(ea, eb, et)
        bv = ea.validity[:, :, None] & eb.validity[:, None, :]
        bn = ~ea.validity[:, :, None] & ~eb.validity[:, None, :]
        in_b = (((pe & bv) | bn) & pb[:, None, :]).any(2)
        if f == "array_union":
            cat_elem = _concat_elems(ea, eb, et)
            cat_pres = torch.cat([pa, pb], 1)
            lens1, elem1 = _compact(cat_pres, cat_elem.with_validity(cat_elem.validity
                                                                     & cat_pres))
            return _ev_distinct(list_cv(lens1, arr.validity & other.validity, elem1, e.dtype),
                                e.dtype)
        keep = pa & in_b if f == "array_intersect" else pa & ~in_b
        lens1, elem1 = _compact(keep, ea)
        return _ev_distinct(list_cv(lens1, arr.validity & other.validity, elem1, e.dtype),
                            e.dtype)

    if f == "array_join":
        sep = ev(e.args[1], b, ctx).decode()
        null_repl = ev(e.args[2], b, ctx).decode() if len(e.args) > 2 else None
        return _array_join(arr, sep, null_repl, e.dtype, cap)

    if f == "flatten":
        sub = elem.children[0]  # (cap, Ea, Eb, ...)
        ea_cap, eb_cap = elem.validity.shape[1], sub.validity.shape[2]
        pa = present(arr)
        pos_b = torch.arange(eb_cap, device=dev)[None, None, :]
        pres2 = pa[:, :, None] & elem.validity[:, :, None] & (pos_b < elem.data[:, :, None])
        flat_pres = pres2.reshape(cap, ea_cap * eb_cap)
        flat_elem = map_buffers(sub, lambda a: a.reshape((cap, ea_cap * eb_cap) + a.shape[3:]))
        lens, out = _compact(flat_pres, flat_elem.with_validity(flat_elem.validity & flat_pres))
        # a null inner list makes the whole result null (Spark)
        has_null_inner = (pa & ~elem.validity).any(1)
        return list_cv(lens, arr.validity & ~has_null_inner, out, e.dtype)

    raise NotImplementedError(f"array func {f}")


def _coerce_elem(elem: ColumnVector, to: T.DataType) -> ColumnVector:
    """An element column cast to ``to``, through its flattened rows."""
    if elem.dtype == to:
        return elem
    from datafusion_comet_tpu_torch.exec import evaluator as EV

    shape = elem.validity.shape
    flat = map_buffers(elem, lambda a: a.reshape((shape[0] * shape[1],) + a.shape[2:]))
    return map_buffers(EV._coerce(flat, to), lambda a: a.reshape(shape + a.shape[1:]))


def _concat_elems(a: ColumnVector, b: ColumnVector, dtype: T.DataType) -> ColumnVector:
    """Two element columns side by side along the element axis."""

    def cat(field):
        x, y = getattr(a, field), getattr(b, field)
        if x is None or y is None:
            return None
        if dtype.is_binary and field == "data":
            w = max(x.shape[-1], y.shape[-1])
            x, y = _pad_last(x, w), _pad_last(y, w)
        return torch.cat([x, y], 1)

    kids = tuple(_concat_elems(ca, cb, ca.dtype) for ca, cb in zip(a.children, b.children))
    return ColumnVector(cat("data"), cat("validity"), cat("lengths"), dtype, children=kids)


def _ev_distinct(arr: ColumnVector, out_dtype: T.DataType) -> ColumnVector:
    """Each row's first occurrence of every value (one null kept). Strings
    compare pairwise, (cap, E, E), as the JAX package does; any other type
    by one stable sort of each row's (slot kind, value key), which needs
    (cap, E) memory: an element is a repeat where it equals its sorted
    predecessor, and the stable sort puts a value's first occurrence first."""
    elem = arr.children[0]
    pres = present(arr)
    if out_dtype.element.is_binary:
        pe = _pairwise_eq(elem, elem, out_dtype.element)
        both_valid = elem.validity[:, :, None] & elem.validity[:, None, :]
        both_null = ~elem.validity[:, :, None] & ~elem.validity[:, None, :]
        same = (pe & both_valid) | both_null
        earlier = torch.ones(same.shape[1:], dtype=torch.bool, device=pres.device).tril(-1)[None]
        dup = (same & earlier & pres[:, None, :]).any(2)
    else:
        kind = torch.where(pres, torch.where(elem.validity, 0, 1), 2)
        key = torch.where(elem.validity, _orderable_key(elem), 0)
        order = torch.argsort(key, dim=1, stable=True)
        order = order.gather(1, torch.argsort(kind.gather(1, order), dim=1, stable=True))
        k_s, key_s = kind.gather(1, order), key.gather(1, order)
        rep = torch.zeros_like(pres)
        rep[:, 1:] = (k_s[:, 1:] == k_s[:, :-1]) & (key_s[:, 1:] == key_s[:, :-1])
        dup = torch.zeros_like(pres).scatter_(1, order, rep)
    lens, out = _compact(pres & ~dup, elem)
    return list_cv(lens, arr.validity, out, out_dtype)


def _array_join(arr: ColumnVector, sep: ColumnVector, null_repl, out_dtype: T.DataType,
                cap: int) -> ColumnVector:
    """The string elements joined by a separator; null elements skipped, or
    replaced where a replacement is given (Spark array_join)."""
    elem = arr.children[0]
    pres = present(arr)
    e_cap, item_w = elem.validity.shape[1], elem.data.shape[2]
    w = out_dtype.byte_width
    dev = pres.device
    use = pres & (elem.validity if null_repl is None else torch.ones_like(pres))
    repl_len = (null_repl.lengths[:, None] if null_repl is not None
                else torch.zeros((cap, 1), dtype=torch.int32, device=dev))
    item_len = torch.where(use, torch.where(elem.validity, elem.lengths, repl_len), 0).long()
    sep_before = use & (use.long().cumsum(1) > 1)
    sep_len = torch.where(sep_before, sep.lengths.long()[:, None], 0)
    piece_len = item_len + sep_len
    starts = piece_len.cumsum(1) - piece_len
    total = piece_len.sum(1)
    out_pos = torch.arange(w, device=dev)[None, :]
    ends = starts + piece_len
    piece_idx = (out_pos[:, :, None] >= ends[:, None, :]).sum(2).clamp(0, e_cap - 1)
    off_in_piece = out_pos - starts.gather(1, piece_idx)
    sep_len_b = sep_len.gather(1, piece_idx)
    in_sep = off_in_piece < sep_len_b
    item_off = (off_in_piece - sep_len_b).clamp(0, item_w - 1)
    rows = _take1(elem.data, piece_idx)  # (cap, W, L)
    item_byte = rows.gather(2, item_off[:, :, None])[:, :, 0]
    if null_repl is not None:
        item_valid = elem.validity.gather(1, piece_idx)
        rl = null_repl.data.shape[1]
        repl_byte = null_repl.data.expand(cap, -1).gather(1, item_off.clamp(0, rl - 1))
        item_byte = torch.where(item_valid, item_byte, repl_byte)
    sl = sep.data.shape[1]
    sep_byte = sep.data.expand(cap, -1).gather(1, off_in_piece.clamp(0, sl - 1))
    byte = torch.where(in_sep, sep_byte, item_byte)
    byte = torch.where(out_pos < total[:, None], byte, torch.zeros_like(byte)).to(torch.uint8)
    return ColumnVector(byte, arr.validity & sep.validity, total.int(), out_dtype)


# -------------------------------------------------------------------------------------
# maps
# -------------------------------------------------------------------------------------


def _dedup_keys_keep_last(entries: ColumnVector, pres: torch.Tensor, key_t: T.DataType):
    key_cv = entries.children[0]
    pe = _pairwise_eq(key_cv, key_cv, key_t)
    later = torch.ones(pe.shape[1:], dtype=torch.bool, device=pres.device).triu(1)[None]
    dup = (pe & later & pres[:, None, :]).any(2)  # an equal key comes later
    return _compact(pres & ~dup, entries)


def _entries(key_elem, val_elem, validity, dtype) -> ColumnVector:
    return ColumnVector(torch.zeros(validity.shape, dtype=torch.int8, device=validity.device),
                        validity, None, dtype, children=(key_elem, val_elem))


def _ev_map(e: E.MapExpr, b: Batch, ctx, ev: Callable) -> ColumnVector:
    f = e.func
    cap, dev = b.capacity, b.device
    if f == "map":
        kt, vt = e.dtype.key_type, e.dtype.value_type
        ks = [_coerced(ev, a, b, ctx, kt) for a in e.args[0::2]]
        vs = [_coerced(ev, a, b, ctx, vt) for a in e.args[1::2]]
        for k in ks:
            ctx.record_error(~k.validity & b.row_mask, "Cannot use null as map key")
        key_elem = _stack_scalars(ks, kt)
        pres = torch.ones((cap, len(ks)), dtype=torch.bool, device=dev)
        lens, ded = _dedup_keys_keep_last(
            _entries(key_elem, _stack_scalars(vs, vt), key_elem.validity.clone(),
                     e.dtype.element), pres, kt)
        return list_cv(lens, torch.ones(cap, dtype=torch.bool, device=dev), ded, e.dtype)

    if f == "map_from_arrays":
        karr, varr = ev(e.args[0], b, ctx), ev(e.args[1], b, ctx)
        key_elem, val_elem = karr.children[0], varr.children[0]
        pres = present(karr)
        ctx.record_error((pres & ~key_elem.validity).any(1) & b.row_mask,
                         "Cannot use null as map key")
        lens, ded = _dedup_keys_keep_last(_entries(key_elem, val_elem, pres, e.dtype.element),
                                          pres, e.dtype.key_type)
        return list_cv(lens, karr.validity & varr.validity, ded, e.dtype)

    if f == "map_concat":  # later maps override earlier ones (LAST_WIN)
        ms = [ev(a, b, ctx) for a in e.args]
        entries, pres, valid = ms[0].children[0], present(ms[0]), ms[0].validity
        for mm in ms[1:]:
            entries = _concat_elems(entries, mm.children[0], e.dtype.element)
            pres = torch.cat([pres, present(mm)], 1)
            valid = valid & mm.validity
        lens, ded = _dedup_keys_keep_last(entries, pres, e.dtype.key_type)
        return list_cv(lens, valid, ded, e.dtype)

    if f == "map_from_entries":
        arr = ev(e.args[0], b, ctx)
        entries, pres = arr.children[0], present(arr)
        ctx.record_error((pres & ~entries.children[0].validity).any(1) & b.row_mask,
                         "Cannot use null as map key")
        lens, ded = _dedup_keys_keep_last(entries, pres, e.dtype.key_type)
        return list_cv(lens, arr.validity, ded, e.dtype)

    m = ev(e.args[0], b, ctx)
    if f == "size":
        return ColumnVector(m.data.int(), m.validity, None, T.INT32)
    if f in ("map_keys", "map_values"):
        return list_cv(m.data, m.validity, m.children[0].children[0 if f == "map_keys" else 1],
                       e.dtype)
    if f == "map_entries":
        return list_cv(m.data, m.validity, m.children[0], e.dtype)
    if f in ("element_at", "map_contains_key"):
        kt = m.dtype.key_type
        key = _coerced(ev, e.args[1], b, ctx, kt)
        keys = m.children[0].children[0]
        hit = present(m) & _elem_vs_scalar_eq(keys, key, kt) & keys.validity
        any_hit = hit.any(1)
        if f == "map_contains_key":
            return ColumnVector(any_hit, m.validity & key.validity, None, T.BOOL)
        val = _gather_item(m.children[0].children[1], hit.to(torch.uint8).argmax(1))
        return val.with_validity(m.validity & key.validity & any_hit & val.validity)
    raise NotImplementedError(f"map func {f}")


# -------------------------------------------------------------------------------------
# higher-order functions
# -------------------------------------------------------------------------------------


def _flatten_elem(elem: ColumnVector, pres: torch.Tensor) -> ColumnVector:
    out = map_buffers(elem, lambda a: a.reshape((-1,) + a.shape[2:]))
    return out.with_validity(out.validity & pres.reshape(-1))


def _unflatten(cv: ColumnVector, cap: int, ne: int) -> ColumnVector:
    return map_buffers(cv, lambda a: a.reshape((cap, ne) + a.shape[1:]))


def _refs(e, out: set) -> set:
    if isinstance(e, E.BoundRef):
        out.add(e.index)
    for c in e.children():
        _refs(c, out)
    return out


def _expand_batch(b: Batch, ne: int, body: E.Expr) -> Batch:
    """The batch with every row repeated ``ne`` times (row r's copies at r *
    ne ...) in the columns ``body`` reads; the others stay as they are,
    unread (the JAX package leaves their pruning to XLA)."""
    src = torch.arange(b.capacity, device=b.device).repeat_interleave(ne)
    used = _refs(body, set())
    return Batch(tuple(c.take(src) if i in used else c for i, c in enumerate(b.columns)),
                 b.row_mask[src], b.schema)


def _body_ctx(ctx, env):
    return dataclasses.replace(ctx, lambda_env=env)


def ev_hof(e: E.HigherOrderFunc, b: Batch, ctx, ev: Callable) -> ColumnVector:
    f = e.func
    cap, dev = b.capacity, b.device
    arr = ev(e.args[0], b, ctx)
    pres = present(arr)
    elem = arr.children[0]
    ne = elem.validity.shape[1]

    if f in ("transform_keys", "transform_values", "map_filter"):
        keys, vals = elem.children
        env = {e.params[0]: _flatten_elem(keys, pres), e.params[1]: _flatten_elem(vals, pres)}
        body = ev(e.body, _expand_batch(b, ne, e.body), _body_ctx(ctx, env))
        if f == "map_filter":
            keep = (body.data.bool() & body.validity).reshape(cap, ne) & pres
            lens, ded = _compact(keep, elem)
            return list_cv(lens, arr.validity, ded, e.dtype)
        plane = _unflatten(body, cap, ne)
        if f == "transform_values":
            return list_cv(arr.data, arr.validity,
                           _entries(keys, plane, elem.validity, e.dtype.element), e.dtype)
        lens, ded = _dedup_keys_keep_last(_entries(plane, vals, elem.validity, e.dtype.element),
                                          pres, e.dtype.key_type)
        return list_cv(lens, arr.validity, ded, e.dtype)

    if f == "array_sort":  # the default comparator: ascending, nulls last
        cls = torch.where(~pres, 2, torch.where(~elem.validity, 1, 0))
        order = torch.argsort(_orderable_key(elem), dim=1, stable=True)
        order = order.gather(1, torch.argsort(cls.gather(1, order), dim=1, stable=True))
        return list_cv(arr.data, arr.validity, map_buffers(elem, lambda a: _take1(a, order)),
                       e.dtype)

    if f == "aggregate":  # a fold over the element slots, from the initial value
        acc = ev(e.args[1], b, ctx).decode()
        for i in range(ne):
            xi = map_buffers(elem, lambda a, _i=i: a[:, _i])
            stepped = ev(e.body, b, _body_ctx(ctx, {e.params[0]: acc, e.params[1]: xi}))
            take = pres[:, i]
            data = (torch.where(take.reshape((-1,) + (1,) * (stepped.data.dim() - 1)),
                                stepped.data, acc.data.to(stepped.data.dtype))
                    if stepped.data.shape == acc.data.shape else stepped.data)
            acc = ColumnVector(data, torch.where(take, stepped.validity, acc.validity),
                               acc.lengths, acc.dtype, children=acc.children)
        return acc.with_validity(acc.validity & arr.validity)

    if f == "zip_with":
        arr2 = ev(e.args[1], b, ctx)
        pres2, elem2 = present(arr2), arr2.children[0]
        ne2 = elem2.validity.shape[1]
        w = max(ne, ne2)
        if w > ne:
            elem = _widen(elem, w - ne)
        if w > ne2:
            elem2 = _widen(elem2, w - ne2)
        presw = torch.nn.functional.pad(pres, (0, w - ne))
        pres2w = torch.nn.functional.pad(pres2, (0, w - ne2))
        env = {e.params[0]: _flatten_elem(elem, presw), e.params[1]: _flatten_elem(elem2, pres2w)}
        body = ev(e.body, _expand_batch(b, w, e.body), _body_ctx(ctx, env))
        lens = torch.maximum(torch.where(arr.validity, arr.data, 0),
                             torch.where(arr2.validity, arr2.data, 0))
        return list_cv(lens, arr.validity & arr2.validity, _unflatten(body, cap, w), e.dtype)

    # transform, filter, exists, forall: the body over the flattened elements
    env = {e.params[0]: _flatten_elem(elem, pres)}
    if len(e.params) > 1:  # the (x, index) form
        idx = torch.arange(ne, dtype=torch.int32, device=dev).repeat(cap)
        env[e.params[1]] = ColumnVector(idx, torch.ones(cap * ne, dtype=torch.bool, device=dev),
                                        None, T.INT32)
    body = ev(e.body, _expand_batch(b, ne, e.body), _body_ctx(ctx, env))
    if f == "transform":
        return list_cv(arr.data, arr.validity, _unflatten(body.decode(), cap, ne), e.dtype)
    if f == "filter":
        keep = (body.data.bool() & body.validity).reshape(cap, ne) & pres
        lens, out = _compact(keep, elem)
        return list_cv(lens, arr.validity, out, e.dtype)
    # exists and forall in three-valued logic: a null result neither
    # satisfies nor refutes
    val = body.data.bool().reshape(cap, ne)
    ok = body.validity.reshape(cap, ne)
    any_null = (~ok & pres).any(1)
    if f == "exists":
        any_true = (val & ok & pres).any(1)
        return ColumnVector(any_true, arr.validity & (any_true | ~any_null), None, T.BOOL)
    if f == "forall":
        any_false = (~val & ok & pres).any(1)
        return ColumnVector(~any_false, arr.validity & (any_false | ~any_null), None, T.BOOL)
    raise NotImplementedError(f"higher-order func {f}")


# -------------------------------------------------------------------------------------
# split
# -------------------------------------------------------------------------------------


def ev_split(e: E.Split, cv: ColumnVector, ctx) -> ColumnVector:
    """split(str, literal delim), limit -1 (JAX ``evaluator.py:294``); a
    dictionary column is split over its entries. More fields than the list
    capacity raise, naming it."""
    from datafusion_comet_tpu_torch.exec import evaluator as EV
    from datafusion_comet_tpu_torch.exec import string_funcs as SF

    e_cap = e.dtype.max_elems

    def small(s: ColumnVector) -> ColumnVector:
        counts, eb, el, evalid, ovf = SF.split(s, e.delim.encode("utf-8"), e_cap,
                                                e.dtype.element.byte_width)
        ctx.record_error(ovf, f"split produced more than max_parts={e_cap} fields "
                              "(raise Split.max_parts)")
        return list_cv(counts, s.validity, ColumnVector(eb, evalid, el, e.dtype.element),
                       e.dtype)

    return EV._eval_on_dict(cv, small, ctx) if cv.is_dict else small(cv)

"""Columnar batches: struct-of-arrays tensors on one device (port of
``datafusion_comet_tpu/exec/batch.py``).

The layout is the JAX package's, so the two can be compared field by field:

- every batch has a static capacity (a power of two); live rows are a
  boolean ``row_mask``, and a filter flips mask bits instead of moving rows;
- nullability is a per-column boolean ``validity`` (True = non-null);
- strings are int32 codes into a sorted host ``StringDict``, or padded uint8
  matrices plus int32 ``lengths`` when the dictionary would be too large;
- a DECIMAL(p>18) column is a 1-D int64 while a recorded ``mag_bound``
  proves its values fit, and a (cap, 2) int64 [hi, lo] i128 otherwise;
- a LIST or MAP column's ``data`` holds each row's element count and its
  one child the elements, whose buffers carry the element axis after the
  row axis ((cap, E), (cap, E, L) for strings); a STRUCT's ``data`` is an
  int8 placeholder and each field is a row-shaped child.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from datafusion_comet_tpu_torch import types as T
from datafusion_comet_tpu_torch.exec.dictionary import StringDict, encode_objects, encode_padded

__all__ = ["ColumnVector", "Batch", "pad_capacity", "quantize_bound", "from_numpy",
           "to_numpy", "from_arrays", "to_arrays", "concat_batches", "nested_from_py",
           "nested_to_py", "map_buffers"]

_M64 = (1 << 64) - 1


def quantize_bound(mx: int) -> int:
    """Round a magnitude bound up to all-nines (10^k - 1), as the JAX package
    does, so both pick the same storage from the same data."""
    b = 9
    while b < mx:
        b = b * 10 + 9
    return b


def pad_capacity(n: int, minimum: int = 8) -> int:
    """Round a row count up to the next power of two."""
    cap = max(minimum, 1)
    while cap < n:
        cap *= 2
    return cap


@dataclasses.dataclass
class ColumnVector:
    """One column. ``data``: (cap,) fixed-width values, (cap,) int32 codes
    when ``dictionary`` is set, (cap, w) uint8 for padded strings, or
    (cap, 2) int64 for two-limb decimals, (cap,) int32 element counts for a
    LIST or MAP, (cap,) int8 for a STRUCT. ``validity``: (cap,) bool.
    ``lengths``: (cap,) int32 for padded strings, else None. ``mag_bound``:
    for decimals, a sound host-side bound on max |unscaled value|.
    ``children``: a LIST's or MAP's element column (its buffers (cap, E,
    ...)), a STRUCT's field columns (row-shaped)."""

    data: torch.Tensor
    validity: torch.Tensor
    lengths: Optional[torch.Tensor]
    dtype: T.DataType
    dictionary: Optional[StringDict] = None
    mag_bound: Optional[int] = None
    children: Tuple["ColumnVector", ...] = ()

    @property
    def capacity(self) -> int:
        return self.data.shape[0]

    @property
    def is_wide_storage(self) -> bool:
        """True when this decimal column is physically two-limb (cap, 2)."""
        return self.dtype.is_decimal and self.data.dim() == 2

    @property
    def is_dict(self) -> bool:
        return self.dictionary is not None

    def with_validity(self, validity: torch.Tensor) -> "ColumnVector":
        return dataclasses.replace(self, validity=validity)

    def decode(self) -> "ColumnVector":
        """A dictionary column in the padded layout ((cap, w) bytes at the
        type's width plus lengths), by one gather from the dictionary's
        device copy; any other column as it is."""
        if self.dictionary is None:
            return self
        mat, lens = self.dictionary.decode_arrays(self.data, self.dtype.byte_width)
        return ColumnVector(mat, self.validity, lens, self.dtype)

    def unify_encoding(self, *others: "ColumnVector") -> list:
        """For operations that merge rows of several columns: codes stay
        codes only where every column carries the same dictionary; else
        the dictionary columns are decoded."""
        cvs = (self,) + others
        dicts = {cv.dictionary for cv in cvs if cv.dictionary is not None}
        if len(dicts) == 1 and all(cv.is_dict for cv in cvs):
            return list(cvs)
        return [cv.decode() for cv in cvs]

    def take(self, indices: torch.Tensor) -> "ColumnVector":
        """Gather rows by in-range index (the bound does not carry over;
        the children come along)."""
        lengths = None if self.lengths is None else self.lengths[indices]
        return ColumnVector(_take_rows(self.data, indices), self.validity[indices], lengths,
                            self.dtype, self.dictionary,
                            children=tuple(c.take(indices) for c in self.children))


def map_buffers(cv: ColumnVector, g) -> ColumnVector:
    """``g`` over every buffer of ``cv`` and of its children, recursively
    (None stays None); the dictionary is kept, the bound dropped."""
    return ColumnVector(g(cv.data), g(cv.validity), None if cv.lengths is None else g(cv.lengths),
                        cv.dtype, cv.dictionary,
                        children=tuple(map_buffers(c, g) for c in cv.children))


def _take_rows(data: torch.Tensor, indices: torch.Tensor) -> torch.Tensor:
    """``data[indices]``. Two-limb rows (a wide decimal's (n, 2) int64) are
    gathered as one 16-byte element each: PyTorch's row gather for 16-byte
    rows runs far below the memory rate on a GPU."""
    if data.dim() == 2 and data.shape[1] == 2 and data.dtype == torch.int64 \
            and data.is_contiguous():
        return data.view(torch.complex128)[:, 0][indices].view(torch.int64).view(-1, 2)
    return data[indices]


@dataclasses.dataclass
class Batch:
    """A struct-of-arrays batch: columns plus the live-row mask."""

    columns: Tuple[ColumnVector, ...]
    row_mask: torch.Tensor  # (cap,) bool
    schema: T.Schema

    @property
    def capacity(self) -> int:
        return self.row_mask.shape[0]

    @property
    def device(self) -> torch.device:
        return self.row_mask.device

    def num_rows(self) -> torch.Tensor:
        return self.row_mask.sum()

    def column(self, name: str) -> ColumnVector:
        return self.columns[self.schema.index_of(name)]

    def with_mask(self, mask: torch.Tensor) -> "Batch":
        return Batch(self.columns, mask, self.schema)

    def select(self, indices: Sequence[int], schema: T.Schema) -> "Batch":
        return Batch(tuple(self.columns[i] for i in indices), self.row_mask, schema)

    def take(self, indices: torch.Tensor, mask: torch.Tensor,
             schema: Optional[T.Schema] = None) -> "Batch":
        """Gather rows by in-range index under a new live-row mask."""
        return Batch(tuple(c.take(indices) for c in self.columns), mask, schema or self.schema)

    def decode_dicts(self) -> "Batch":
        """Every dictionary column in the padded layout."""
        if not any(c.is_dict for c in self.columns):
            return self
        return Batch(tuple(c.decode() for c in self.columns), self.row_mask, self.schema)


def _concat_column(cvs: Sequence[ColumnVector], dtype: T.DataType) -> ColumnVector:
    """Row-concatenate one column across batches. Dictionary codes stay codes
    when every piece carries the same dictionary, else they are decoded
    (``unify_encoding``); decimals of mixed storage widen to two limbs;
    padded strings pad to the widest. Bounds are dropped, as in the JAX
    package's union."""
    if dtype.is_nested:
        return _concat_nested(cvs, dtype)
    cvs = cvs[0].unify_encoding(*cvs[1:])
    if cvs[0].is_dict:
        return ColumnVector(torch.cat([c.data for c in cvs]), torch.cat([c.validity for c in cvs]),
                            None, dtype, cvs[0].dictionary)
    datas = [c.data for c in cvs]
    if dtype.is_decimal and len({d.dim() for d in datas}) > 1:
        from datafusion_comet_tpu_torch.exec import decimal_wide as DW

        datas = [d if d.dim() == 2 else DW.pack(DW.lift(c)) for d, c in zip(datas, cvs)]
    if dtype.is_binary:  # (rows, w), or (rows, E, w) for a list's elements
        w = max(d.shape[-1] for d in datas)
        datas = [torch.nn.functional.pad(d, (0, w - d.shape[-1])) for d in datas]
    lengths = None if cvs[0].lengths is None else torch.cat([c.lengths for c in cvs])
    return ColumnVector(torch.cat(datas), torch.cat([c.validity for c in cvs]), lengths, dtype)


def _concat_nested(cvs: Sequence[ColumnVector], dtype: T.DataType) -> ColumnVector:
    """Row-concatenate a nested column: its own buffers, then each child's
    (element buffers of one type share their element axis)."""
    kids = tuple(_concat_column([c.children[i] for c in cvs], cvs[0].children[i].dtype)
                 for i in range(len(cvs[0].children)))
    return ColumnVector(torch.cat([c.data for c in cvs]), torch.cat([c.validity for c in cvs]),
                        None, dtype, children=kids)


def concat_batches(batches: Sequence[Batch], schema: T.Schema) -> Batch:
    """Row-concatenate batches of one schema (the union of grace pieces)."""
    cols = tuple(_concat_column([b.columns[i] for b in batches], f.dtype)
                 for i, f in enumerate(schema.fields))
    return Batch(cols, torch.cat([b.row_mask for b in batches]), schema)


# -------------------------------------------------------------------------------------
# host <-> device
# -------------------------------------------------------------------------------------


def _pad_strings_np(values: np.ndarray, max_len: int) -> Tuple[np.ndarray, np.ndarray]:
    """Ragged str/bytes/None object array -> padded (n, max_len) uint8 + lengths."""
    n = len(values)
    if n == 0:
        return np.zeros((0, max_len), np.uint8), np.zeros((0,), np.int32)
    encoded = [
        (v.encode("utf-8") if isinstance(v, str) else (bytes(v) if v is not None else b""))
        for v in values
    ]
    lens = np.fromiter((len(e) for e in encoded), dtype=np.int32, count=n)
    if lens.max(initial=0) > max_len:
        raise ValueError(f"string longer than max_len={max_len}")
    flat = np.frombuffer(b"".join(encoded), dtype=np.uint8)
    offsets = np.zeros(n, np.int64)
    np.cumsum(lens[:-1], out=offsets[1:])
    pos = np.arange(max_len, dtype=np.int64)
    idx = np.minimum(offsets[:, None] + pos[None, :], max(len(flat) - 1, 0))
    mat = np.zeros((n, max_len), np.uint8)
    if len(flat):
        mat = np.where(pos[None, :] < lens[:, None], flat[idx], 0).astype(np.uint8)
    return mat, lens


def nested_from_py(values, dtype: T.DataType, cap: int,
                   device: Union[str, torch.device]) -> ColumnVector:
    """A (possibly nested) column from a sequence of Python values, padded
    to ``cap`` rows (JAX ``batch.py:212``): None is a null, a list a LIST,
    a dict a MAP (its entries sorted by key) or a STRUCT by field name, a
    tuple a STRUCT by position. More items than ``max_elems`` raise."""
    n = len(values)
    valid = np.zeros(cap, bool)
    valid[:n] = [v is not None for v in values]
    if dtype.is_list or dtype.is_map:
        e_cap = dtype.max_elems
        lens = np.zeros(cap, np.int32)
        flat = []
        for i, v in enumerate(values):
            if dtype.is_map and isinstance(v, dict):
                v = sorted(v.items())
            items = list(v) if v is not None else []
            if len(items) > e_cap:
                raise ValueError(f"list of {len(items)} items exceeds max_elems={e_cap}")
            lens[i] = len(items)
            flat.extend(items + [None] * (e_cap - len(items)))
        flat.extend([None] * ((cap - n) * e_cap))
        elem = map_buffers(nested_from_py(flat, dtype.element, cap * e_cap, device),
                           lambda a: a.reshape((cap, e_cap) + a.shape[1:]))
        return ColumnVector(_to(lens, device), _to(valid, device), None, dtype, children=(elem,))
    if dtype.is_struct:
        kids = tuple(
            nested_from_py([None if v is None else (v.get(f.name) if isinstance(v, dict)
                                                    else v[j]) for v in values],
                           f.dtype, cap, device)
            for j, f in enumerate(dtype.struct_fields))
        return ColumnVector(_to(np.zeros(cap, np.int8), device), _to(valid, device), None,
                            dtype, children=kids)
    if dtype.is_binary:
        mat, lens = _pad_strings_np(np.array(values, dtype=object), dtype.byte_width)
        mat_pad = np.zeros((cap, dtype.byte_width), np.uint8)
        mat_pad[:n] = mat
        return ColumnVector(_to(mat_pad, device), _to(valid, device), _to(_padded(lens, cap),
                                                                          device), dtype)
    buf = np.zeros(cap, dtype.np_dtype())
    scale = 10 ** dtype.scale if dtype.is_decimal else 1
    for i, v in enumerate(values):
        if v is not None:
            buf[i] = round(v * scale) if dtype.is_decimal and isinstance(v, float) else v
    return ColumnVector(_to(buf, device), _to(valid, device), None, dtype)


def nested_to_py(cv: ColumnVector, idx=None) -> list:
    """A (possibly nested) column's rows ``idx`` (all by default) as
    Python values (JAX ``batch.py:263``): a LIST a list, a MAP a dict, a
    STRUCT a dict by field name, a null None."""
    return _to_py(_host(cv), cv, idx)


def _host(cv: ColumnVector):
    """Host numpy copies of a column's buffers, recursively."""
    return (cv.data.cpu().numpy(), cv.validity.cpu().numpy(),
            None if cv.lengths is None else cv.lengths.cpu().numpy(),
            [_host(c) for c in cv.children])


def _to_py(h, cv: ColumnVector, idx, dt: Optional[T.DataType] = None) -> list:
    """``dt``: the type to read the column as (a list's element type)."""
    data, valid, lens, kids = h
    if idx is None:
        idx = np.arange(valid.shape[0])
    dt = dt or cv.dtype
    if dt.is_list or dt.is_map:
        ecv = cv.children[0]
        out = []
        for i in idx:
            if not valid[i]:
                out.append(None)
                continue
            items = _to_py(_index_host(kids[0], i), ecv, np.arange(int(data[i])), dt.element)
            out.append({it["key"]: it["value"] for it in items} if dt.is_map else items)
        return out
    if dt.is_struct:
        cols = [_to_py(k, c, idx, f.dtype)
                for k, c, f in zip(kids, cv.children, dt.struct_fields)]
        names = [f.name for f in dt.struct_fields]
        return [({nm: col[j] for nm, col in zip(names, cols)} if valid[i] else None)
                for j, i in enumerate(idx)]
    if dt.is_binary:
        raw = dt.type_id == "BYTES"
        if cv.is_dict:
            d = cv.dictionary
            codes = np.clip(data, 0, max(d.size - 1, 0))
            return [((d.value_of(int(codes[i])) if raw
                      else d.value_of(int(codes[i])).decode("utf-8", "replace"))
                     if valid[i] and d.size else None) for i in idx]
        return [((bytes(data[i, : lens[i]]) if raw
                  else bytes(data[i, : lens[i]]).decode("utf-8", "replace"))
                 if valid[i] else None) for i in idx]
    if dt.is_decimal and dt.scale:
        return [int(data[i]) / 10 ** dt.scale if valid[i] else None for i in idx]
    return [data[i].item() if valid[i] else None for i in idx]


def _index_host(h, i):
    data, valid, lens, kids = h
    return (data[i], valid[i], None if lens is None else lens[i],
            [_index_host(k, i) for k in kids])


def _padded(a: np.ndarray, cap: int) -> np.ndarray:
    out = np.zeros((cap,) + a.shape[1:], a.dtype)
    out[: len(a)] = a
    return out


def _i128_limbs(ints, cap: int) -> np.ndarray:
    """Python ints -> (cap, 2) int64 [hi, lo] two's-complement limbs."""
    buf = np.zeros((cap, 2), np.int64)
    for i, x in enumerate(ints):
        u = x & ((1 << 128) - 1)
        buf[i, 0] = np.uint64((u >> 64) & _M64).astype(np.int64)
        buf[i, 1] = np.uint64(u & _M64).astype(np.int64)
    return buf


def from_numpy(
    data: Dict[str, np.ndarray],
    schema: T.Schema,
    device: Union[str, torch.device],
    validity: Optional[Dict[str, np.ndarray]] = None,
    dict_max_size: int = 1 << 16,
) -> Batch:
    """Stage host numpy columns as a Batch on ``device``, padded to the
    next power of two. Decimals come pre-scaled as int64. Strings may be
    object arrays of str/bytes/None; those with at most ``dict_max_size``
    distinct values are dictionary-encoded (0 disables)."""
    names = schema.names
    n = len(data[names[0]]) if names else 0
    cap = pad_capacity(n)
    validity = validity or {}
    host = []  # (data, validity, lengths, dtype, dictionary, mag_bound) per column
    nested = {}
    for f in schema.fields:
        if f.dtype.is_nested:
            nested[f.name] = nested_from_py(list(data[f.name]), f.dtype, cap, device)
            host.append(None)
            continue
        v = np.asarray(data[f.name])
        valid_np = validity.get(f.name)
        if valid_np is None:
            valid_np = (np.array([x is not None for x in v], dtype=bool)
                        if v.dtype == object else np.ones(n, dtype=bool))
        valid_pad = _padded(np.asarray(valid_np, bool), cap)
        if f.dtype.is_binary:
            max_len = f.dtype.byte_width
            enc = encode_objects(v, max_len, dict_max_size) if v.dtype == object else None
            if enc is None:
                mat, lens = _pad_strings_np(v, max_len)
                if v.dtype != object:
                    enc = encode_padded(mat, lens, dict_max_size)
            if enc is not None:
                host.append((_padded(enc[0], cap), valid_pad, None, f.dtype, enc[1], None))
            else:
                host.append((_padded(mat, cap), valid_pad, _padded(lens, cap), f.dtype,
                             None, None))
        elif f.dtype.is_wide_decimal:
            ints = [0 if v[i] is None else int(v[i]) for i in range(n)]
            mx = max((abs(x) for x in ints), default=0)
            if mx < (1 << 62):  # values fit int64: narrow storage + recorded bound
                host.append((_padded(np.array(ints, np.int64), cap), valid_pad, None,
                             f.dtype, None, quantize_bound(mx)))
            else:
                host.append((_i128_limbs(ints, cap), valid_pad, None, f.dtype, None, None))
        else:
            phys = f.dtype.np_dtype()
            if v.dtype == object:
                v = np.array([x if x is not None else 0 for x in v])
            buf = _padded(v.astype(phys), cap)
            bound = None
            if f.dtype.is_decimal:
                # the actual magnitude lets downstream arithmetic keep
                # provably-int64 intermediates on the narrow path
                bound = quantize_bound(int(np.abs(buf[:n]).max()) if n else 0)
            host.append((buf, valid_pad, None, f.dtype, None, bound))
    cols = tuple(
        nested[f.name] if h is None else
        ColumnVector(_to(h[0], device), _to(h[1], device),
                     None if h[2] is None else _to(h[2], device), *h[3:])
        for f, h in zip(schema.fields, host))
    mask = np.zeros(cap, bool)
    mask[:n] = True
    return Batch(cols, _to(mask, device), schema)


def _to(a: np.ndarray, device) -> torch.Tensor:
    a = np.ascontiguousarray(a)
    if not a.flags.writeable:  # e.g. a view of another framework's buffer
        a = a.copy()
    return torch.from_numpy(a).to(device)


def to_numpy(batch: Batch) -> Dict[str, np.ndarray]:
    """Pull a batch back to host as compacted numpy columns plus a
    ``<name>__valid`` array each: strings as objects (None for nulls),
    wide-typed decimals as Python ints, everything else in its dtype. The
    live rows are gathered on the batch's device first, so only they are
    copied (a nested-loop join's output holds its inputs' capacities'
    product)."""
    live = batch.row_mask.nonzero().squeeze(1)
    out: Dict[str, np.ndarray] = {}
    for f, col in zip(batch.schema.fields, batch.columns):
        valid = col.validity[live].cpu().numpy()
        if f.dtype.is_nested:
            vals = np.empty(len(valid), dtype=object)
            for j, v in enumerate(nested_to_py(col.take(live))):
                vals[j] = v
            out[f.name] = vals
            out[f.name + "__valid"] = valid
            continue
        data = col.data[live].cpu().numpy()
        if f.dtype.is_binary:
            raw = f.dtype.type_id == "BYTES"
            if col.is_dict:
                d = col.dictionary
                dvals = np.empty(max(d.size, 1), dtype=object)
                dvals[0] = b"" if raw else ""
                for c in range(d.size):
                    bs = d.value_of(c)
                    dvals[c] = bs if raw else bs.decode("utf-8", "replace")
                vals = dvals[np.clip(data, 0, max(d.size - 1, 0))]
            else:
                lens = col.lengths[live].cpu().numpy()
                vals = np.empty(len(data), dtype=object)
                for i in range(len(data)):
                    bs = bytes(data[i, : lens[i]])
                    vals[i] = bs if raw else bs.decode("utf-8", "replace")
            vals[~valid] = None
            out[f.name] = vals
        elif f.dtype.is_wide_decimal:
            vals = np.empty(len(data), dtype=object)
            for i in range(len(data)):
                if data.ndim == 2:
                    u = ((int(data[i, 0]) & _M64) << 64) | (int(data[i, 1]) & _M64)
                    vals[i] = u - (1 << 128) if u >= (1 << 127) else u
                else:
                    vals[i] = int(data[i])
            out[f.name] = vals
        else:
            out[f.name] = data
        out[f.name + "__valid"] = valid
    return out


# -------------------------------------------------------------------------------------
# per-column arrays: the state a batch is made of
# -------------------------------------------------------------------------------------

ArrayDict = Dict[str, Union[np.ndarray, int, None]]


def from_arrays(schema: T.Schema, arrays: ArrayDict,
                device: Union[str, torch.device]) -> Batch:
    """Build a Batch from exactly the arrays a batch is made of, as
    ``to_arrays`` lays them out: ``row_mask``, and per column ``<name>.data``,
    ``<name>.validity``, ``<name>.lengths``, ``<name>.dict_values``,
    ``<name>.dict_lengths`` and ``<name>.mag_bound`` (absent or None where
    the column has none). This is how a batch staged elsewhere, such as by
    the JAX package, is carried over unchanged."""
    cols = []
    for f in schema.fields:
        def get(key):
            return arrays.get(f"{f.name}.{key}")

        dv = get("dict_values")
        sd = None if dv is None else StringDict(np.asarray(dv, np.uint8),
                                                np.asarray(get("dict_lengths")))
        lengths = get("lengths")
        mb = get("mag_bound")
        cols.append(ColumnVector(
            _to(np.asarray(get("data")), device), _to(np.asarray(get("validity"), bool), device),
            None if lengths is None else _to(np.asarray(lengths), device),
            f.dtype, sd, None if mb is None else int(mb)))
    return Batch(tuple(cols), _to(np.asarray(arrays["row_mask"], bool), device), schema)


def to_arrays(batch: Batch) -> ArrayDict:
    """The inverse of ``from_arrays``: host copies of every buffer."""
    out: ArrayDict = {"row_mask": batch.row_mask.cpu().numpy()}
    for f, c in zip(batch.schema.fields, batch.columns):
        out[f"{f.name}.data"] = c.data.cpu().numpy()
        out[f"{f.name}.validity"] = c.validity.cpu().numpy()
        out[f"{f.name}.lengths"] = None if c.lengths is None else c.lengths.cpu().numpy()
        out[f"{f.name}.dict_values"] = None if c.dictionary is None else c.dictionary.values
        out[f"{f.name}.dict_lengths"] = None if c.dictionary is None else c.dictionary.lengths
        out[f"{f.name}.mag_bound"] = c.mag_bound
    return out

"""Batch invariant checks (port of ``datafusion_comet_tpu/exec/debug.py``).

With ``Config(debug_validate_batches=True)`` the engine calls
``check_batch`` on every operator's output and raises
``BatchInvariantError`` naming the operator and the invariant: shapes and
dtypes of every buffer, string widths and lengths, dictionary codes in
range, and for nested columns the element buffers' (cap, E) shapes and
element counts no larger than E. Value checks copy to the host, so this is
a debugging switch.
"""

from __future__ import annotations

import torch

__all__ = ["check_batch", "BatchInvariantError"]


class BatchInvariantError(AssertionError):
    pass


def _fail(op: str, msg: str):
    raise BatchInvariantError(f"[{op}] {msg}")


def check_batch(batch, op: str = "?") -> None:
    cap = batch.row_mask.shape[0]
    if batch.row_mask.dtype != torch.bool:
        _fail(op, f"row_mask dtype {batch.row_mask.dtype} != bool")
    if batch.schema is not None and len(batch.schema.fields) != len(batch.columns):
        _fail(op, f"schema arity {len(batch.schema.fields)} != {len(batch.columns)} columns")
    for f, cv in zip(batch.schema.fields, batch.columns):
        _check_column(op, f.name, f.dtype, cv, (cap,))


def _check_column(op: str, name: str, dtype, cv, lead: tuple) -> None:
    """``lead``: the row axes every buffer starts with ((cap,), or (cap, E)
    for a list's elements)."""
    if tuple(cv.validity.shape) != lead:
        _fail(op, f"{name}: validity shape {tuple(cv.validity.shape)} != {lead}")
    if cv.validity.dtype != torch.bool:
        _fail(op, f"{name}: validity dtype {cv.validity.dtype}")
    if tuple(cv.data.shape[:len(lead)]) != lead:
        _fail(op, f"{name}: data rows {tuple(cv.data.shape)} != {lead}")
    if cv.is_dict:
        if cv.data.dtype != torch.int32:
            _fail(op, f"{name}: dict codes dtype {cv.data.dtype} != int32")
        codes = cv.data
        if codes.numel() and (int(codes.min()) < 0
                              or int(codes.max()) >= max(cv.dictionary.size, 1)):
            _fail(op, f"{name}: dict code out of range [0, {cv.dictionary.size})")
        return
    if dtype.is_list or dtype.is_map:
        if len(cv.children) != 1:
            _fail(op, f"{name}: a list carries {len(cv.children)} element columns, not 1")
        elem = cv.children[0]
        e_cap = elem.validity.shape[len(lead)] if elem.validity.dim() > len(lead) else -1
        if dtype.max_elems and e_cap != dtype.max_elems:
            _fail(op, f"{name}: element capacity {e_cap} != max_elems {dtype.max_elems}")
        if cv.data.dtype != torch.int32:
            _fail(op, f"{name}: element counts dtype {cv.data.dtype} != int32")
        n = cv.data[cv.validity]
        if n.numel() and (int(n.min()) < 0 or int(n.max()) > e_cap):
            _fail(op, f"{name}: element counts outside [0, {e_cap}] "
                      f"(min {int(n.min())}, max {int(n.max())})")
        _check_column(op, f"{name}.element", dtype.element, elem, lead + (e_cap,))
        return
    if dtype.is_struct:
        if len(cv.children) != len(dtype.struct_fields):
            _fail(op, f"{name}: {len(cv.children)} fields, the type has "
                      f"{len(dtype.struct_fields)}")
        for sf, c in zip(dtype.struct_fields, cv.children):
            _check_column(op, f"{name}.{sf.name}", sf.dtype, c, lead)
        return
    if dtype.is_binary:
        if cv.data.dim() != len(lead) + 1 or cv.data.dtype != torch.uint8:
            _fail(op, f"{name}: binary column must be (rows, w) uint8, got "
                      f"{tuple(cv.data.shape)} {cv.data.dtype}")
        if cv.lengths is None:
            _fail(op, f"{name}: binary column missing lengths")
        if cv.data.shape[-1] > dtype.byte_width:
            _fail(op, f"{name}: byte plane wider than dtype "
                      f"({cv.data.shape[-1]} > {dtype.byte_width})")
        ln = cv.lengths
        if ln.numel() and (int(ln.min()) < 0 or int(ln.max()) > cv.data.shape[-1]):
            _fail(op, f"{name}: lengths outside [0, {cv.data.shape[-1]}] "
                      f"(min {int(ln.min())}, max {int(ln.max())})")
    elif cv.lengths is not None:
        _fail(op, f"{name}: non-binary column carries lengths")

"""JSON-path extraction (get_json_object) and json_array_length over padded
byte matrices (port of ``datafusion_comet_tpu/exec/json_path.py``).

Vectorized over the padded uint8 matrix, no per-row host work; the
tables are held transposed, (width, rows), so that the scans and
reductions along a document run along the outer dimension, one thread a
row (PyTorch's along a short inner dimension run far below the memory
rate):
- a quote-parity cumsum marks the bytes inside strings (a quote after a
  backslash does not count),
- a brace/bracket cumsum gives every byte its container depth,
- each path step (``.key`` / ``[index]``) narrows a per-row [start, end)
  value span: a key step finds ``"key"`` at the container's depth whose
  next non-space byte is ':'; an index step hops the commas at the
  container's depth,
- the final span renders as Spark's: a string unquoted (``\\"`` and
  ``\\\\`` unescaped), ``null`` a SQL NULL, numbers, booleans, objects and
  arrays as their source bytes.

The supported subset, as in the JAX package: paths of ``.key``,
``['key']`` and ``[i]`` steps (``parse_path``; other paths take the host
bridge of ir/functions.py), valid JSON (a malformed row gives some span,
not NULL), and objects or arrays returned as their source span (Spark
re-serializes them compactly: equal for compact documents).
"""

from __future__ import annotations

import re
from typing import List, Optional, Sequence, Union

import numpy as np
import torch

from datafusion_comet_tpu_torch import types as T
from datafusion_comet_tpu_torch.exec.batch import ColumnVector

__all__ = ["parse_path", "device_get_json_object", "device_json_array_length"]

_STEP = re.compile(r"\.([A-Za-z_][A-Za-z0-9_\-]*)|\[(\d+)\]|\['([^']*)'\]")


def parse_path(path: str) -> Optional[List[Union[str, int]]]:
    """A Spark JSON path as key and index steps; None where it uses
    anything outside the device subset (wildcards, '..', escapes)."""
    if not path.startswith("$"):
        return None
    steps: List[Union[str, int]] = []
    pos = 1
    while pos < len(path):
        m = _STEP.match(path, pos)
        if m is None:
            return None
        if m.group(1) is not None:
            steps.append(m.group(1))
        elif m.group(2) is not None:
            steps.append(int(m.group(2)))
        else:
            steps.append(m.group(3))
        pos = m.end()
    return steps


def _take(a: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """a[idx[r], r] of a (width, rows) table, the index clamped into the
    width."""
    return a.gather(0, idx.long().clamp(0, a.shape[0] - 1)[None, :])[0]


def _shift_down(x: torch.Tensor, value=0) -> torch.Tensor:
    """x[i - 1] at position i, ``value`` at 0 (a (width, rows) table)."""
    return torch.nn.functional.pad(x[:-1], (0, 0, 1, 0), value=value)


def _scan(cv: ColumnVector):
    """The shared tables, each (width, rows): the scans then run along the
    outer dimension, one thread a row, where PyTorch's scans along a short
    inner one are slow. (bytes zeroed past each row's length, lengths,
    positions (width, 1), quote counts, unescaped quotes, inside-a-string
    (before the byte), depth, non-space bytes)."""
    n, w = cv.data.shape
    dev = cv.data.device
    lens = cv.lengths.int()
    pos = torch.arange(w, device=dev, dtype=torch.int32)[:, None]
    d = torch.where(pos < lens[None, :], cv.data.t(), 0).contiguous()
    q = (d == ord('"')) & ~_shift_down(d == ord("\\"), False)
    qi = q.int()
    cs = torch.cumsum(qi, 0, dtype=torch.int32)
    inside = ((cs - qi) % 2) == 1
    opens = ((d == ord("{")) | (d == ord("["))) & ~inside
    closes = ((d == ord("}")) | (d == ord("]"))) & ~inside
    depth = torch.cumsum(opens.int() - closes.int(), 0, dtype=torch.int32)
    ws = (d == 32) | (d == 9) | (d == 10) | (d == 13)
    nonws = ~ws & (pos < lens[None, :])
    return d, lens, pos, cs, q, inside, depth, nonws


def device_json_array_length(cv: ColumnVector) -> ColumnVector:
    """json_array_length: the top-level element count of a JSON array, by
    the path scan's quote and depth tables. Checked: the first and last
    non-space bytes are '[' and ']', the depth stays >= 1 between them and
    ends at 0, the quotes balance. As in the JAX package, token garbage a
    parser would refuse (``[1,,2]``) still counts its commas."""
    d, lens, pos, cs, q, inside, depth, nonws = _scan(cv)
    w = d.shape[0]
    big = torch.tensor(w + 8, dtype=torch.int32, device=d.device)
    first_nw = torch.where(nonws, pos, big).min(0).values
    last_nw = torch.where(nonws, pos, -1).max(0).values
    is_arr = (_take(d, first_nw) == ord("[")) & (first_nw < big)
    closes_ok = _take(d, last_nw) == ord("]")
    depth_end = _take(depth, last_nw)
    span = (pos >= first_nw[None, :]) & (pos < last_nw[None, :])
    min_depth = torch.where(span, depth, big).min(0).values
    balanced = (cs[-1] % 2 == 0) & (depth_end == 0) & (min_depth >= 1)
    # an empty array: the next non-space byte after '[' is the closing ']'
    after_open = torch.where(nonws & (pos > first_nw[None, :]), pos, big).min(0).values
    commas = ((d == ord(",")) & ~inside & (depth == 1) & span).sum(0)
    count = torch.where(after_open == last_nw, 0, commas + 1).int()
    valid = cv.validity & is_arr & closes_ok & balanced & (lens > 0)
    return ColumnVector(torch.where(valid, count, 0), valid, None, T.INT32)


def device_get_json_object(cv: ColumnVector, steps: Sequence[Union[str, int]],
                           out_t: T.DataType) -> ColumnVector:
    d, lens, pos, cs, q, inside, depth, nonws = _scan(cv)
    w, n = d.shape
    dev = d.device
    big = torch.tensor(w + 8, dtype=torch.int32, device=dev)
    # the next non-space byte at or after i (a suffix cummin), strictly after i
    at_or_after = torch.cummin(torch.where(nonws, pos, big).flip(0), 0).values.flip(0)
    after = torch.nn.functional.pad(at_or_after[1:], (0, 0, 0, 1), value=w + 8)
    # the last non-space byte at or before i (a prefix cummax)
    before = torch.cummax(torch.where(nonws, pos, -1), 0).values

    def first_in(mask, lo, hi):
        m = mask & (pos >= lo[None, :]) & (pos < hi[None, :])
        return m.to(torch.uint8).argmax(0), m.any(0)

    # the current value's span [v0, ve): first the whole trimmed document
    v0 = at_or_after[0].long()
    ve = _take(before, lens - 1).long() + 1
    ok = cv.validity & nonws.any(0)
    for step in steps:
        dsel = _take(depth, v0)  # the depth inside the container
        # a value ends at a ',' at dsel or at its container's close
        end_mask = ~inside & (
            ((d == ord(",")) & (depth == dsel[None, :]))
            | (((d == ord("}")) | (d == ord("]"))) & (depth == (dsel - 1)[None, :])))
        if isinstance(step, str):
            kb = np.frombuffer(step.encode("utf-8"), np.uint8)
            k = len(kb)
            dk = torch.nn.functional.pad(d, (0, 0, 0, k + 2))
            match = q & ~inside & (depth == dsel[None, :])
            for j, byte in enumerate(kb):
                match &= dk[1 + j: 1 + j + w] == int(byte)
            is_key = match & (dk[1 + k: 1 + k + w] == ord('"'))  # the closing quote
            is_obj = _take(d, v0) == ord("{")
            mpos, found = first_in(is_key, v0 + 1, ve)
            # where the first candidate is a string value (no ':' after it),
            # take the next one, twice, as the JAX package does (skipped
            # where no row has such a value)
            for _ in range(2):
                colon_ok = _take(d, _take(after, mpos + k + 1)) == ord(":")
                if not bool((found & ~colon_ok).any()):
                    break
                mpos2, found2 = first_in(is_key, mpos + 1, ve)
                retry = found & ~colon_ok & found2
                mpos = torch.where(retry, mpos2, mpos)
                found = found & (colon_ok | retry)
            cpos = _take(after, mpos + k + 1).long()
            colon_ok = _take(d, cpos) == ord(":")
            vs = _take(after, cpos).long()
            enew, has_end = first_in(end_mask, vs, ve + 1)
            ok = ok & is_obj & found & colon_ok & has_end
            v0 = vs
        else:
            is_arr = _take(d, v0) == ord("[")
            cur = _take(after, v0).long()
            found = is_arr & (_take(d, cur) != ord("]"))  # a non-empty array
            comma_mask = ~inside & (d == ord(",")) & (depth == dsel[None, :])
            for _ in range(int(step)):
                cpos, has = first_in(comma_mask, cur, ve)
                found = found & has
                cur = _take(after, cpos).long()
            enew, has_end = first_in(end_mask, cur, ve + 1)
            ok = ok & found & has_end
            v0 = cur
        # trailing space inside the span trimmed
        ve = torch.maximum(_take(before, (enew - 1).clamp(min=0)).long() + 1, v0)
    # render: a string unquoted, null a SQL NULL, anything else its bytes
    is_str = _take(d, v0) == ord('"')
    span = ve - v0
    nul = (span == 4) & (_take(d, v0) == ord("n")) & (_take(d, v0 + 1) == ord("u")) \
        & (_take(d, v0 + 2) == ord("l")) & (_take(d, v0 + 3) == ord("l"))
    start = torch.where(is_str, v0 + 1, v0)
    out_len = torch.where(is_str, (span - 2).clamp(min=0), span).clamp(max=out_t.byte_width)
    ow = out_t.byte_width
    opos = torch.arange(ow, device=dev)[:, None]
    out = d.gather(0, (start[None, :] + opos).clamp(0, w - 1))
    out = torch.where(opos < out_len[None, :], out, 0)
    # a string's \" and \\ pairs lose their backslash: the kept bytes moved
    # up in order (rows without one, most of them, skip the sort)
    bs = out == ord("\\")
    drop = is_str[None, :] & bs & ~_shift_down(bs, False) & (opos < out_len[None, :])
    if bool(drop.any()):
        order = torch.argsort(torch.where(drop, ow + 1, opos), dim=0, stable=True)
        out = torch.where(is_str[None, :], out.gather(0, order), out)
        out_len = out_len - torch.where(is_str, drop.sum(0), 0)
        out = torch.where(opos < out_len[None, :], out, 0)
    validity = ok & ~nul
    return ColumnVector(out.t().contiguous(), validity,
                        torch.where(validity, out_len, 0).int(), out_t)

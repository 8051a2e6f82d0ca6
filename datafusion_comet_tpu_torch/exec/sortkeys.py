"""Orderable sort-key limbs (port of ``datafusion_comet_tpu/exec/sortkeys.py``,
the limbs a sort on strings, integers, decimals and floats needs).

A column maps to integer limbs whose lexicographic signed order equals the
column's SQL order; a stable lexsort over the limbs orders the rows. Strings
compare as unsigned bytes, a shorter prefix first: dictionary codes are one
int32 limb (the dictionary is sorted), padded bytes pack big-endian into
sign-flipped limbs (``_string_limbs``), the zero padding giving the prefix
rule. A float is one limb of its own width (``_float_limb``).
"""

from __future__ import annotations

from typing import List, Sequence

import torch

from datafusion_comet_tpu_torch.exec.batch import ColumnVector

__all__ = ["column_limbs", "order_limbs", "grouping_limbs", "lexsort"]


def _string_limbs(cv: ColumnVector) -> List[torch.Tensor]:
    """Padded (cap, w) bytes as limbs, as the JAX package packs them: a
    width of at most 4 bytes gives one big-endian int32 limb, a wider one
    ceil(w / 8) big-endian int64 limbs of 8 bytes (zero-padded), each with
    its sign bit flipped so that signed order is unsigned byte order. Each
    limb's bytes are reversed and read as one little-endian word (a view,
    no arithmetic), so nothing is shifted past the sign bit."""
    mat = cv.data
    cap, w = mat.shape
    word, dt = (4, torch.int32) if w <= 4 else (8, torch.int64)
    n_limbs = -(-w // word)
    if n_limbs * word != w:
        mat = torch.nn.functional.pad(mat, (0, n_limbs * word - w))
    words = mat.reshape(cap, n_limbs, word).flip(2).contiguous().view(dt).view(cap, n_limbs)
    sign = -(1 << (8 * word - 1))
    return [words[:, i] ^ sign for i in range(n_limbs)]


def _float_limb(data: torch.Tensor) -> torch.Tensor:
    """Floats in Spark's order as one signed integer limb of their width:
    -0.0 becomes 0.0 and every NaN one NaN above +Inf, so equal values
    (and all NaNs) share a limb; the bits are read as an integer and a
    negative value's magnitude bits are flipped, so signed integer order is
    float order. The JAX package splits a float64 into four int32 limbs by
    arithmetic (``_float_orderable``, ``sortkeys.py:73-99``), as the TPU has
    no float64 bitcast; the order is the same."""
    d = torch.where(data == 0.0, torch.zeros_like(data), data)
    f32 = d.dtype == torch.float32
    bits = torch.where(torch.isnan(d), 0x7FC00000 if f32 else 0x7FF8000000000000,
                       d.view(torch.int32 if f32 else torch.int64))
    width = 8 * bits.element_size()
    # x ^ (x >> (w-1) & 0x7f..f): a negative value's magnitude bits flip
    return bits ^ ((bits >> (width - 1)) & ((1 << (width - 1)) - 1))


def column_limbs(cv: ColumnVector) -> List[torch.Tensor]:
    """Value limbs (no null handling), most significant first."""
    dt = cv.dtype
    if dt.is_binary:
        if not cv.is_dict:
            return _string_limbs(cv)
        # sorted dictionary: codes are order-isomorphic to string order
        return [cv.data.int()]
    if dt.is_floating:
        return [_float_limb(cv.data)]
    if dt.is_boolean or dt.type_id in ("INT8", "INT16", "INT32", "DATE"):
        return [cv.data.int()]
    if dt.is_decimal and cv.data.dim() == 2:
        # (hi signed, lo with the sign bit flipped): signed limb order == i128 order
        return [cv.data[:, 0].long(), cv.data[:, 1].long() ^ -(1 << 63)]
    return [cv.data.long()]  # int64 and narrow decimals


def order_limbs(cv: ColumnVector, ascending: bool, nulls_first: bool) -> List[torch.Tensor]:
    """ORDER BY limbs: a null rank, then the (possibly reversed) value limbs."""
    vals = column_limbs(cv)
    if not ascending:
        vals = [~v for v in vals]  # bitwise not reverses signed order limb-wise
    null_rank = torch.where(cv.validity, 1, 0 if nulls_first else 2).int()
    return [null_rank] + vals


def grouping_limbs(cols: Sequence[ColumnVector]) -> List[torch.Tensor]:
    """GROUP BY limbs: per key a null flag (nulls last, all in one group)
    then its value limbs, zero on null rows."""
    out: List[torch.Tensor] = []
    for cv in cols:
        out.append((~cv.validity).int())
        out.extend(torch.where(cv.validity, v, 0) for v in column_limbs(cv))
    return out


def lexsort(limbs: Sequence[torch.Tensor]) -> torch.Tensor:
    """Stable lexicographic argsort, most significant limb first: stable
    argsorts from the least significant limb up."""
    perm = torch.arange(limbs[0].shape[0], device=limbs[0].device)
    for limb in reversed(limbs):
        perm = perm[torch.argsort(limb[perm], stable=True)]
    return perm

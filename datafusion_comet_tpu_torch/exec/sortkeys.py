"""Orderable sort-key limbs (port of ``datafusion_comet_tpu/exec/sortkeys.py``,
the limbs a sort on strings, integers and decimals needs).

A column maps to integer limbs whose lexicographic signed order equals the
column's SQL order; a stable lexsort over the limbs orders the rows. Strings
compare as unsigned bytes, a shorter prefix first: dictionary codes are one
int32 limb (the dictionary is sorted), padded bytes pack big-endian into
sign-flipped limbs (``_string_limbs``), the zero padding giving the prefix
rule.
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


def column_limbs(cv: ColumnVector) -> List[torch.Tensor]:
    """Value limbs (no null handling), most significant first."""
    dt = cv.dtype
    if dt.is_binary:
        if not cv.is_dict:
            return _string_limbs(cv)
        # sorted dictionary: codes are order-isomorphic to string order
        return [cv.data.int()]
    if dt.is_floating:
        raise NotImplementedError("sorting floats is not ported yet")
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

"""Orderable sort-key limbs (port of ``datafusion_comet_tpu/exec/sortkeys.py``,
the limbs a sort on dictionary codes, integers and decimals needs).

A column maps to integer limbs whose lexicographic signed order equals the
column's SQL order; a stable lexsort over the limbs orders the rows.
"""

from __future__ import annotations

from typing import List, Sequence

import torch

from datafusion_comet_tpu_torch.exec.batch import ColumnVector

__all__ = ["column_limbs", "order_limbs", "grouping_limbs", "lexsort"]


def column_limbs(cv: ColumnVector) -> List[torch.Tensor]:
    """Value limbs (no null handling), most significant first."""
    dt = cv.dtype
    if dt.is_binary:
        if not cv.is_dict:
            raise NotImplementedError("sorting padded strings is not ported yet")
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

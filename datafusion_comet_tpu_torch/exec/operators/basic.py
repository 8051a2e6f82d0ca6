"""Row-preserving operators: filter, project, sort, and the compaction that
packs live rows into a smaller capacity (port of
``datafusion_comet_tpu/exec/operators/basic.py:37-137``).

A filter flips mask bits (no dynamic shapes); a sort is one stable
multi-limb lexsort with dead rows last, after which live rows are
front-packed and the mask is a prefix.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch

from datafusion_comet_tpu_torch import types as T
from datafusion_comet_tpu_torch.exec import kernels as KN
from datafusion_comet_tpu_torch.exec import sortkeys
from datafusion_comet_tpu_torch.exec.batch import Batch, ColumnVector
from datafusion_comet_tpu_torch.exec.evaluator import EvalContext, evaluate, evaluate_predicate
from datafusion_comet_tpu_torch.ir import expr as E

__all__ = ["filter_op", "project_op", "sort_op", "live_first_perm", "compact_batch"]


def filter_op(batch: Batch, predicate: E.Expr, ctx: Optional[EvalContext] = None) -> Batch:
    return batch.with_mask(evaluate_predicate(predicate, batch, ctx))


def project_op(batch: Batch, exprs: Sequence[E.Expr], out_schema: T.Schema,
               ctx: Optional[EvalContext] = None) -> Batch:
    return Batch(tuple(evaluate(x, batch, ctx) for x in exprs), batch.row_mask, out_schema)


def sort_op(batch: Batch, orders: Sequence[E.SortOrder],
            ctx: Optional[EvalContext] = None) -> Batch:
    """Total sort, live rows first. Sorted columns drop their magnitude
    bounds, as in the JAX package."""
    limbs = [(~batch.row_mask).int()]
    for o in orders:
        cv = evaluate(o.child, batch, ctx)
        limbs += sortkeys.order_limbs(cv, o.ascending, o.resolved_nulls_first())
    perm = sortkeys.lexsort(limbs)
    cols = tuple(
        ColumnVector(c.data[perm], c.validity[perm],
                     None if c.lengths is None else c.lengths[perm], c.dtype, c.dictionary)
        for c in batch.columns)
    mask = torch.arange(batch.capacity, device=batch.device) < batch.num_rows()
    return Batch(cols, mask, batch.schema)


def live_first_perm(mask: torch.Tensor) -> torch.Tensor:
    """The stable permutation that puts live rows first, both halves in row
    order: the partition sort with one partition and dead rows as its dead
    code. Codes 0 and 1 are in range by construction, so the kernel's range
    flag is left unread (no host sync)."""
    perm, _ = KN.partition_sort(torch.where(mask, 0, 1).int(), 1, errors=[])
    return perm.long()


def compact_batch(batch: Batch, new_cap: int) -> Tuple[Batch, torch.Tensor]:
    """Pack live rows to the front and cut the capacity to ``new_cap``.
    Returns (compacted batch, overflow flag: the live rows did not fit).
    Bounds do not carry over, as in the JAX package."""
    if new_cap >= batch.capacity:
        return batch, torch.zeros((), dtype=torch.bool, device=batch.device)
    perm = live_first_perm(batch.row_mask)[:new_cap]
    return batch.take(perm, batch.row_mask[perm]), batch.row_mask.sum() > new_cap

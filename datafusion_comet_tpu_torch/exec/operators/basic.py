"""Row-preserving operators: filter, project, sort (with top-K), limit,
expand, explode, and the compaction that packs live rows into a smaller
capacity (port of ``datafusion_comet_tpu/exec/operators/basic.py:37-232``).

A filter flips mask bits (no dynamic shapes); a sort is one stable
multi-limb lexsort with dead rows last, after which live rows are
front-packed and the mask is a prefix; its fetch and skip, and a limit,
narrow the mask.
"""

from __future__ import annotations

import dataclasses
import math
from typing import List, Optional, Sequence, Tuple

import torch

from datafusion_comet_tpu_torch import types as T
from datafusion_comet_tpu_torch.exec import kernels as KN
from datafusion_comet_tpu_torch.exec import sortkeys
from datafusion_comet_tpu_torch.exec.batch import Batch, ColumnVector, pad_capacity
from datafusion_comet_tpu_torch.exec.evaluator import EvalContext, evaluate, evaluate_predicate
from datafusion_comet_tpu_torch.ir import expr as E

__all__ = ["filter_op", "project_op", "sort_op", "limit_op", "expand_op", "explode_op",
           "sample_op", "partition_batch", "compact_batch"]


def filter_op(batch: Batch, predicate: E.Expr, ctx: Optional[EvalContext] = None) -> Batch:
    return batch.with_mask(evaluate_predicate(predicate, batch, ctx))


def project_op(batch: Batch, exprs: Sequence[E.Expr], out_schema: T.Schema,
               ctx: Optional[EvalContext] = None) -> Batch:
    return Batch(tuple(evaluate(x, batch, ctx) for x in exprs), batch.row_mask, out_schema)


def sort_op(batch: Batch, orders: Sequence[E.SortOrder], fetch: Optional[int] = None,
            skip: int = 0, ctx: Optional[EvalContext] = None) -> Batch:
    """Total sort, live rows first; then only the sorted rows [skip, skip +
    fetch) stay live (a top-K: the whole sort, then the mask, as in the JAX
    package, so ties keep the stable sort's order). Sorted columns drop
    their magnitude bounds, as in the JAX package; a Sort whose input is
    already in its order (an aggregate's keys) never gets here, as the
    planner drops it (engine.apply_orderings), so that input's bounds
    reach the output, as in the JAX package."""
    limbs = [(~batch.row_mask).int()]
    for o in orders:
        cv = evaluate(o.child, batch, ctx)
        limbs += sortkeys.order_limbs(cv, o.ascending, o.resolved_nulls_first())
    perm = sortkeys.lexsort(limbs)
    if fetch is not None:
        # live rows are front-packed: none past skip + fetch stays live, so
        # the output keeps only those rows (padded)
        perm = perm[:min(batch.capacity, pad_capacity(skip + fetch))]
    cols = tuple(c.take(perm) for c in batch.columns)
    pos = torch.arange(perm.shape[0], device=batch.device)
    mask = (pos < batch.num_rows()) & (pos >= skip)
    if fetch is not None:
        mask &= pos < skip + fetch
    return Batch(cols, mask, batch.schema)


def limit_op(batch: Batch, limit: int, offset: int = 0) -> Batch:
    """The live rows [offset, offset + limit), in their order."""
    rank = torch.cumsum(batch.row_mask, 0) - 1
    return batch.with_mask(batch.row_mask & (rank >= offset) & (rank < offset + limit))


def expand_op(batch: Batch, projections: Sequence[Sequence[E.Expr]], out_schema: T.Schema,
              ctx: Optional[EvalContext] = None) -> Batch:
    """Each input row gives one row per projection (ROLLUP, CUBE; JAX
    ``basic.py:147``): output row ``i * n_proj + j`` is projection ``j`` of
    input row ``i``, so the capacity is ``n_proj`` times the input's and
    the row mask is each input row's repeated. A column's branches keep
    dictionary codes only where all share one dictionary
    (``unify_encoding``: a typed null literal beside a dictionary column
    decodes it), padded strings pad to the widest branch, and no bound
    carries over, as in the JAX package."""
    n_proj = len(projections)
    pieces = [[evaluate(x, batch, ctx) for x in proj] for proj in projections]
    cols = []
    for ci, f in enumerate(out_schema.fields):
        branch = pieces[0][ci].unify_encoding(*[p[ci] for p in pieces[1:]])
        datas = [c.data for c in branch]
        if datas[0].dim() == 2 and f.dtype.is_binary:
            w = max(d.shape[1] for d in datas)
            datas = [torch.nn.functional.pad(d, (0, w - d.shape[1])) for d in datas]
        lengths = None if branch[0].lengths is None else \
            torch.stack([c.lengths for c in branch], 1).reshape(-1)
        cols.append(ColumnVector(torch.stack(datas, 1).reshape((-1,) + datas[0].shape[1:]),
                                 torch.stack([c.validity for c in branch], 1).reshape(-1),
                                 lengths, f.dtype, branch[0].dictionary))
    return Batch(tuple(cols), batch.row_mask.repeat_interleave(n_proj), out_schema)


def explode_op(batch: Batch, expr: E.Expr, out_schema: T.Schema, outer: bool = False,
               pos: bool = False, ctx: Optional[EvalContext] = None) -> Batch:
    """explode / posexplode (``_outer``) of a LIST or MAP (JAX
    ``basic.py:183``): output row r * E + e is element e of input row r,
    live where e is below the row's length; ``outer`` keeps slot 0, with a
    null element, of a null or empty input; ``pos`` adds the element's
    0-based position. The input's columns that ``out_schema`` names are
    gathered E times."""
    from datafusion_comet_tpu_torch.exec.batch import map_buffers

    arr = evaluate(expr, batch, ctx)
    cap, dev = batch.capacity, batch.device
    elem = arr.children[0]
    e_cap = elem.validity.shape[1]
    pos_mat = torch.arange(e_cap, dtype=torch.int32, device=dev)[None, :].expand(cap, e_cap)
    lens = torch.where(arr.validity, arr.data, 0)
    live = pos_mat < lens[:, None]
    gen_valid = torch.ones((cap, e_cap), dtype=torch.bool, device=dev)
    if outer:
        empty = lens == 0
        live = live | (empty[:, None] & (pos_mat == 0))
        gen_valid = gen_valid & ~empty[:, None]
    row_live = (live & batch.row_mask[:, None]).reshape(-1)
    src = torch.arange(cap, device=dev).repeat_interleave(e_cap)
    names = set(out_schema.names)
    cols = [c.take(src) for f, c in zip(batch.schema.fields, batch.columns) if f.name in names]
    gv = gen_valid.reshape(-1)

    def flat(cv: ColumnVector) -> ColumnVector:
        out = map_buffers(cv, lambda a: a.reshape((cap * e_cap,) + a.shape[2:]))
        return out.with_validity(out.validity & gv)

    if pos:
        cols.append(ColumnVector(pos_mat.reshape(-1), gv, None, T.INT32))
    cols += [flat(c) for c in elem.children] if expr.dtype.is_map else [flat(elem)]
    return Batch(tuple(cols), row_live, out_schema)


def sample_op(batch: Batch, lower_bound: float, upper_bound: float, with_replacement: bool,
              seed: int, partition_id: int = 0) -> Batch:
    """Spark's Sample (JAX ``operators/basic.py:235``). Without replacement
    Spark-exact: one XORShiftRandom nextDouble per live row, seeded
    hashSeed(seed + partition), kept where lower <= x < upper (the
    BernoulliCellSampler: complementary ranges split the rows); an empty
    range keeps nothing and draws nothing. With replacement each live row
    is copied Poisson(upper - lower) times, at most K = ceil(fraction) + 3
    (a static expansion, as in the JAX package); the counts come from a
    ``torch.Generator`` seeded from seed and partition, so they follow the
    same distribution as Spark's and the JAX package's but not their draws
    (ROADMAP C28)."""
    from datafusion_comet_tpu_torch.exec import random_xorshift as RX

    if not with_replacement:
        if upper_bound - lower_bound <= 0.0:
            return batch.with_mask(torch.zeros_like(batch.row_mask))
        u = RX.rand_column(RX.init_seed_host(seed, partition_id), batch.row_mask).data
        return batch.with_mask(batch.row_mask & (u >= lower_bound) & (u < upper_bound))
    fraction = upper_bound - lower_bound
    cap = batch.capacity
    K = max(1, math.ceil(fraction) + 3)
    gen = torch.Generator(device="cpu").manual_seed((seed + partition_id) & ((1 << 63) - 1))
    counts = torch.poisson(torch.full((cap,), fraction, dtype=torch.float64), generator=gen)
    counts = counts.to(batch.device).long().clamp(max=K)
    copy = torch.arange(K, device=batch.device)[None, :]
    live = (copy < counts[:, None]) & batch.row_mask[:, None]
    src = torch.arange(cap, device=batch.device).repeat_interleave(K)
    return batch.take(src, live.reshape(cap * K))


def partition_batch(batch: Batch, codes: torch.Tensor, num_parts: int,
                    limit: Optional[int] = None, keep_bounds: bool = False,
                    errors: Optional[List[Tuple[torch.Tensor, str]]] = None,
                    tag: Optional[str] = None) -> Tuple[Batch, torch.Tensor]:
    """The row mask and every column buffer of ``batch`` moved into the
    stable partition order of ``codes`` by a call of the partition kernel
    (``kernels.partition_columns``, global mode, its log's ``tag``; a batch
    of more than ``kernels.MAX_COLUMNS`` buffers takes one call for each
    group of that many): (batch, the int64 rows of each code). Bounds do not
    carry over, as in the JAX package, unless ``keep_bounds``."""
    tensors = [batch.row_mask]
    for c in batch.columns:
        tensors += _buffers(c)
    outs = []
    for lo in range(0, len(tensors), KN.MAX_COLUMNS):
        part, sizes = KN.partition_columns(codes, num_parts, tensors[lo:lo + KN.MAX_COLUMNS],
                                           limit=limit, errors=errors, tag=tag)
        outs += part
    moved = iter(outs[1:])
    cols = [_rebuilt(c, moved, keep_bounds) for c in batch.columns]
    return Batch(tuple(cols), outs[0], batch.schema), sizes


def _buffers(c: ColumnVector) -> List[torch.Tensor]:
    """A column's buffers, then its children's, recursively (an element
    buffer's row is its (E,) or (E, L) block)."""
    out = [c.data, c.validity] + ([] if c.lengths is None else [c.lengths])
    for k in c.children:
        out += _buffers(k)
    return out


def _rebuilt(c: ColumnVector, moved, keep_bounds: bool) -> ColumnVector:
    data, validity = next(moved), next(moved)
    lengths = None if c.lengths is None else next(moved)
    kids = tuple(_rebuilt(k, moved, keep_bounds) for k in c.children)
    return dataclasses.replace(c, data=data, validity=validity, lengths=lengths,
                               mag_bound=c.mag_bound if keep_bounds else None, children=kids)


def compact_batch(batch: Batch, new_cap: int, keep_bounds: bool = False,
                  tag: Optional[str] = None) -> Tuple[Batch, torch.Tensor]:
    """Pack live rows to the front and cut the capacity to ``new_cap``: one
    partition by the row mask (live rows first, both halves in row order)
    that writes only the first ``new_cap`` rows (its log's ``tag``).
    Returns (compacted batch, overflow flag: the live rows did not fit)."""
    if new_cap >= batch.capacity:
        return batch, torch.zeros((), dtype=torch.bool, device=batch.device)
    out, sizes = partition_batch(batch, batch.row_mask, 1, new_cap, keep_bounds, tag=tag)
    return out, sizes[0] > new_cap

"""The tiled aggregate and helpers of the partitioned paths (port of
``datafusion_comet_tpu/exec/streaming.py``: ``TiledAggregator`` :140,
``_pseudo_scan`` :219, ``_partial_schema`` :225, ``_concat`` :232,
``_dead_batch`` :386; and ``_slice_tiles`` of its ``engine.py``).

A SINGLE aggregate over filters and projections of one resident table whose
stage is over the memory budget runs tiled (``engine._tiled_rewrite``): the
table is cut into row slices of one capacity, each slice runs the
aggregate's PARTIAL, the partial states are concatenated and folded by a
PARTIAL_MERGE every ``MERGE_EVERY`` tiles, and a FINAL finishes. The whole
tiled run is one attempt of the session's overflow retry
(``Session._execute_retry``): where a tile, a fold or a filter shrink
overflowed its capacity (more groups than the aggregate's ``max_groups``),
it goes again with the capacities four times larger. The JAX package reads
none of these flags and drops the groups past the capacity (ROADMAP C17:
TPC-H Q20's 591,102 (part, supplier) groups at SF 0.1 against an estimate
of 262,144).
"""

from __future__ import annotations

import dataclasses
from typing import Iterator, Optional, Sequence, Union

import torch

from datafusion_comet_tpu_torch import types as T
from datafusion_comet_tpu_torch.exec import decimal_wide as DW
from datafusion_comet_tpu_torch.exec.batch import (Batch, ColumnVector, _concat_column, map_buffers,
                                                  nested_from_py)
from datafusion_comet_tpu_torch.exec.evaluator import EvalContext, _torch_dtype
from datafusion_comet_tpu_torch.exec.operators import aggregate as AGG
from datafusion_comet_tpu_torch.ir import expr as E
from datafusion_comet_tpu_torch.ir import plan as P

__all__ = ["pseudo_scan", "partial_schema", "dead_batch", "TiledAggregator", "slice_tiles"]

MERGE_EVERY = 8  # partial states of this many tiles are folded into one (JAX's default)


class TiledAggregator:
    """The bound SINGLE aggregate ``agg`` over the table ``table``, run over
    row tiles of it: PARTIAL each tile, PARTIAL_MERGE every ``MERGE_EVERY``
    tiles of states, FINAL at the end. ``conf``: the session's Config (its
    dense-domain limit)."""

    def __init__(self, agg: P.HashAggregate, table: str, conf):
        if not isinstance(agg, P.HashAggregate) or agg.mode != P.AggMode.SINGLE:
            raise NotImplementedError("tiled execution needs a HashAggregate(SINGLE) root")
        self.agg, self.table, self.conf = agg, table, conf
        self.partial = P.HashAggregate(agg.child, agg.group_exprs, agg.agg_exprs,
                                       P.AggMode.PARTIAL, agg.max_groups)
        self.partial.schema = partial_schema(agg)
        self.groups = tuple(E.bind(E.col(g.name), self.partial.schema) for g in agg.group_exprs)

    def _run(self, plan: P.PlanNode, tables, ctx: EvalContext) -> Batch:
        from datafusion_comet_tpu_torch.exec.engine import run_plan
        from datafusion_comet_tpu_torch.exec.operators.join import JOIN_FANOUT

        return run_plan(plan, tables, ctx, self.conf, JOIN_FANOUT)

    def _fold(self, acc: Batch, mode: str, schema: T.Schema, ctx: EvalContext,
              rows: int) -> Batch:
        node = P.HashAggregate(pseudo_scan("__acc", acc.schema), self.groups,
                               self.agg.agg_exprs, mode, self.agg.max_groups, merge_rows=rows)
        node.schema = schema
        return self._run(node, {"__acc": acc}, ctx)

    def run(self, tiles: Sequence[Batch], ctx: EvalContext) -> Batch:
        """The FINAL result over ``tiles``, every flag in ``ctx``. A group's
        merged count is at most the tiles' rows."""
        rows = sum(t.capacity for t in tiles)
        acc: Optional[Batch] = None
        pending = 0
        for tile in tiles:
            part = self._run(self.partial, {self.table: tile}, ctx)
            acc = part if acc is None else concat_states(acc, part)
            pending += 1
            if pending >= MERGE_EVERY:
                acc = self._fold(acc, P.AggMode.PARTIAL_MERGE, self.partial.schema, ctx, rows)
                pending = 1
        if acc is None:
            raise ValueError("no input tiles")
        return self._fold(acc, P.AggMode.FINAL, self.agg.schema, ctx, rows)


def slice_tiles(batch: Batch, tile_cap: int) -> Iterator[Batch]:
    """Row slices of ``tile_cap`` rows of a resident batch, views of its
    buffers: dictionaries and bounds carry over, so every tile's states
    compare and concatenate alike."""
    for lo in range(0, batch.capacity, tile_cap):
        cols = tuple(dataclasses.replace(map_buffers(c, lambda a: a[lo:lo + tile_cap]),
                                         mag_bound=c.mag_bound) for c in batch.columns)
        yield Batch(cols, batch.row_mask[lo:lo + tile_cap], batch.schema)


def concat_states(a: Batch, b: Batch) -> Batch:
    """Row-concatenate two batches of partial states as the JAX package's
    ``_concat`` does: mixed decimal storage widens to two limbs, padded
    strings pad to the wider, a bound survives where both pieces have one
    (the larger). Dictionary codes stay codes where both pieces share the
    dictionary, else they are decoded."""
    cols = []
    for ca, cb, f in zip(a.columns, b.columns, a.schema.fields):
        if f.dtype.is_nested:  # a collect's list state
            cols.append(_concat_column([ca, cb], f.dtype))
            continue
        if f.dtype.is_decimal and (ca.is_wide_storage or cb.is_wide_storage):
            ca, cb = (c if c.is_wide_storage else ColumnVector(DW.pack(DW.lift(c)), c.validity,
                                                               None, c.dtype) for c in (ca, cb))
        ca, cb = ca.unify_encoding(cb)
        da, db = ca.data, cb.data
        if da.dim() == 2 and f.dtype.is_binary and da.shape[1] != db.shape[1]:
            w = max(da.shape[1], db.shape[1])
            da = torch.nn.functional.pad(da, (0, w - da.shape[1]))
            db = torch.nn.functional.pad(db, (0, w - db.shape[1]))
        bound = (max(ca.mag_bound, cb.mag_bound)
                 if ca.mag_bound is not None and cb.mag_bound is not None else None)
        cols.append(ColumnVector(
            torch.cat([da, db]), torch.cat([ca.validity, cb.validity]),
            None if ca.lengths is None else torch.cat([ca.lengths, cb.lengths]), f.dtype,
            ca.dictionary, bound))
    return Batch(tuple(cols), torch.cat([a.row_mask, b.row_mask]), a.schema)


def pseudo_scan(name: str, schema: T.Schema) -> P.Scan:
    """A bound Scan of a temporary table."""
    sc = P.Scan(name, schema)
    sc.schema = schema
    return sc


def partial_schema(agg: P.HashAggregate) -> T.Schema:
    """The schema a PARTIAL run of a bound aggregate emits: its group
    columns, then each aggregate's state columns."""
    fields = [T.Field(g.name, g.dtype) for g in agg.group_exprs]
    for a in agg.agg_exprs:
        fields += AGG.state_fields(a)
    return T.Schema(fields)


def dead_batch(schema: T.Schema, capacity: int, device: Union[str, torch.device]) -> Batch:
    """A batch with no live row."""
    cols = []
    for f in schema.fields:
        none = torch.zeros(capacity, dtype=torch.bool, device=device)
        if f.dtype.is_nested:
            cols.append(nested_from_py([], f.dtype, capacity, device))
        elif f.dtype.is_binary:
            cols.append(ColumnVector(
                torch.zeros((capacity, f.dtype.byte_width), dtype=torch.uint8, device=device),
                none, torch.zeros(capacity, dtype=torch.int32, device=device), f.dtype))
        else:
            cols.append(ColumnVector(
                torch.zeros(capacity, dtype=_torch_dtype(f.dtype), device=device), none,
                None, f.dtype))
    return Batch(tuple(cols), torch.zeros(capacity, dtype=torch.bool, device=device), schema)

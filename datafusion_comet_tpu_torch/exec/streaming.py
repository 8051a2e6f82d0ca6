"""Helpers of the partitioned paths (port of the subset of
``datafusion_comet_tpu/exec/streaming.py`` that the grace join uses:
``_pseudo_scan`` :219, ``_partial_schema`` :225, ``_dead_batch`` :386). The
tiled streaming aggregate itself is not ported."""

from __future__ import annotations

from typing import Union

import torch

from datafusion_comet_tpu_torch import types as T
from datafusion_comet_tpu_torch.exec.batch import Batch, ColumnVector
from datafusion_comet_tpu_torch.exec.evaluator import _torch_dtype
from datafusion_comet_tpu_torch.exec.operators import aggregate as AGG
from datafusion_comet_tpu_torch.ir import plan as P

__all__ = ["pseudo_scan", "partial_schema", "dead_batch"]


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
        if f.dtype.is_binary:
            cols.append(ColumnVector(
                torch.zeros((capacity, f.dtype.byte_width), dtype=torch.uint8, device=device),
                none, torch.zeros(capacity, dtype=torch.int32, device=device), f.dtype))
        else:
            cols.append(ColumnVector(
                torch.zeros(capacity, dtype=_torch_dtype(f.dtype), device=device), none,
                None, f.dtype))
    return Batch(tuple(cols), torch.zeros(capacity, dtype=torch.bool, device=device), schema)

"""Device memory budget accounting (port of
``datafusion_comet_tpu/exec/memory.py:25-87``).

A batch's bytes follow from its schema and capacity alone, so the planner
bounds a plan's resident footprint before running it and compares it with
the budget: the card's memory times ``Config.memory_fraction``. Over budget,
the engine tiles an aggregate over one table (exec/streaming.py) or
hash-partitions the join (exec/grace.py).
"""

from __future__ import annotations

from typing import Union

import torch

from datafusion_comet_tpu_torch import types as T
from datafusion_comet_tpu_torch.exec.operators.join import JOIN_FANOUT
from datafusion_comet_tpu_torch.exec.stats import DEFAULT_MAX_GROUPS
from datafusion_comet_tpu_torch.ir import plan as P

__all__ = ["batch_bytes", "plan_peak_bytes", "device_budget_bytes", "plan_tiles"]

CPU_MEMORY_LIMIT = 4 * 1024**3  # the JAX package's limit off the TPU


def batch_bytes(schema: T.Schema, capacity: int) -> int:
    """Device bytes of one batch at a capacity, as the JAX package counts
    them: strings at their padded width plus int32 lengths, whatever their
    encoding."""
    total = capacity  # row mask
    for f in schema.fields:
        if f.dtype.is_binary:
            total += capacity * (f.dtype.byte_width + 4)
        else:
            total += capacity * f.dtype.np_dtype().itemsize
        total += capacity  # validity
    return total


def plan_peak_bytes(plan: P.PlanNode, capacity: int, scale: int = 1) -> int:
    """Upper bound on resident bytes while running ``plan`` over inputs of
    ``capacity`` rows: the sum of every operator's output batch. At the
    first attempt's growth ``scale`` of 1, the JAX package's count: an
    aggregate its ``max_groups`` (2^16 where statistics gave none), an
    expand its projections' rows per input row and a join its first
    fan-out's rows per input row. Above 1, what the engine then allocates
    (``engine._exec_hash_join``): an aggregate ``max_groups`` times the
    scale, and an INNER or outer join with a row estimate its compacted
    pair list, else its (probe x K) block at that attempt's K."""
    total = 0
    stack = [plan]
    while stack:
        node = stack.pop()
        stack.extend(node.children())
        cap = capacity
        if isinstance(node, P.HashAggregate):
            cap = min((node.max_groups or DEFAULT_MAX_GROUPS) * scale, capacity)
        elif isinstance(node, P.Expand):
            cap = capacity * len(node.projections)
        elif isinstance(node, P.EQUI_JOINS):
            cap = capacity * JOIN_FANOUT if scale == 1 else _join_rows(node, capacity, scale)
        if node.schema is not None:
            total += batch_bytes(node.schema, cap)
    return total


def _join_rows(node, capacity: int, scale: int) -> int:
    """A join's output rows at growth ``scale`` above 1, as the engine
    sizes them: a semi-like join keeps its probe's rows; an INNER or outer
    join with a row estimate its compacted pair list (twice the estimate,
    at least 4096, times the scale, at most 64x the input), else its block
    of K = ``fanout_hint`` x scale (at most 256) or the session's fan-out x
    scale rows per probe row."""
    if node.join_type in (P.JoinType.LEFT_SEMI, P.JoinType.LEFT_ANTI,
                          P.JoinType.LEFT_ANTI_NULL_AWARE, P.JoinType.EXISTENCE):
        return capacity
    if node.out_rows_hint:
        return min(max(2 * node.out_rows_hint, 4096) * scale, capacity * 64)
    k = min(node.fanout_hint * scale, 256) if node.fanout_hint else JOIN_FANOUT * scale
    return capacity * k


def device_budget_bytes(device: Union[str, torch.device], memory_fraction: float) -> int:
    """Usable device bytes: the card's memory, or 4 GiB on the CPU, times
    the memory fraction."""
    device = torch.device(device)
    if device.type == "cuda":
        limit = torch.cuda.get_device_properties(device).total_memory
    else:
        limit = CPU_MEMORY_LIMIT
    return int(limit * memory_fraction)


def plan_tiles(plan: P.PlanNode, total_rows: int, budget: int, scale: int = 1) -> int:
    """Input tiles (a power of two, at most 4096) so that one tile's run of
    ``plan`` at growth ``scale`` fits ``budget``."""
    tiles = 1
    while tiles < 4096:
        if plan_peak_bytes(plan, max(-(-total_rows // tiles), 1), scale) <= budget:
            return tiles
        tiles *= 2
    return tiles

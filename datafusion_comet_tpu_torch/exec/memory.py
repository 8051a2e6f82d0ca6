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


def plan_peak_bytes(plan: P.PlanNode, capacity: int) -> int:
    """Upper bound on resident bytes while running ``plan`` over inputs of
    ``capacity`` rows: the sum of every operator's output batch. An
    aggregate counts its ``max_groups`` (2^16 where statistics gave none),
    an expand its projections' rows per input row and a join its first
    fan-out's rows per input row."""
    total = 0
    stack = [plan]
    while stack:
        node = stack.pop()
        stack.extend(node.children())
        cap = capacity
        if isinstance(node, P.HashAggregate):
            cap = min(node.max_groups or DEFAULT_MAX_GROUPS, capacity)
        elif isinstance(node, P.Expand):
            cap = capacity * len(node.projections)
        elif isinstance(node, P.HashJoin):
            cap = capacity * JOIN_FANOUT
        if node.schema is not None:
            total += batch_bytes(node.schema, cap)
    return total


def device_budget_bytes(device: Union[str, torch.device], memory_fraction: float) -> int:
    """Usable device bytes: the card's memory, or 4 GiB on the CPU, times
    the memory fraction."""
    device = torch.device(device)
    if device.type == "cuda":
        limit = torch.cuda.get_device_properties(device).total_memory
    else:
        limit = CPU_MEMORY_LIMIT
    return int(limit * memory_fraction)


def plan_tiles(plan: P.PlanNode, total_rows: int, budget: int) -> int:
    """Input tiles (a power of two, at most 4096) so that one tile's run of
    ``plan`` fits ``budget``."""
    tiles = 1
    while tiles < 4096:
        if plan_peak_bytes(plan, max(-(-total_rows // tiles), 1)) <= budget:
            return tiles
        tiles *= 2
    return tiles

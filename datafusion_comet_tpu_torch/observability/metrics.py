"""Per-operator metrics tree (port of
``datafusion_comet_tpu/observability/metrics.py``).

A tree of ``MetricsNode`` mirrors the bound plan (``build_metrics_tree``);
a run with a ``MetricsCollector`` in its ``EvalContext`` records every
operator's output batch: its live-row count stays a device tensor until
``Session.explain`` reads them all in one copy, its capacity and buffer
bytes (``batch_static_bytes``) are known on the host. Marginal times come
from ``Session.explain(profile_ops=True)``.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional

import torch

from datafusion_comet_tpu_torch.ir import plan as P

__all__ = ["MetricsNode", "MetricsCollector", "build_metrics_tree", "batch_static_bytes",
           "ROOFLINE_GBPS"]

# The memory rate an operator's bytes are held to (GB/s) by device type:
# an NVIDIA H100 80GB HBM3 (the card the port is measured on, at its 700 W
# power limit) moves 3.35 TB/s; the CPU figure is the JAX package's.
ROOFLINE_GBPS = {"cuda": 3350.0, "cpu": 50.0}


@dataclasses.dataclass
class MetricsNode:
    """One plan operator: its name and detail, and the values a run fills
    in (live output rows, marginal ms, output bytes and capacity)."""

    op: str
    detail: str
    children: List["MetricsNode"]
    output_rows: Optional[int] = None
    elapsed_ms: Optional[float] = None
    output_bytes: Optional[int] = None
    capacity: Optional[int] = None
    device_type: str = "cpu"

    @property
    def bytes_touched(self) -> Optional[int]:
        """This operator's bytes: its output written, each child's read."""
        if self.output_bytes is None:
            return None
        return self.output_bytes + sum(c.output_bytes for c in self.children
                                       if c.output_bytes is not None)

    def roofline(self, roof_gbps: Optional[float] = None):
        """(GB/s, % of the device's memory rate) from the marginal time and
        ``bytes_touched``; None without ``profile_ops`` times."""
        roof = roof_gbps or ROOFLINE_GBPS.get(self.device_type, ROOFLINE_GBPS["cpu"])
        bt = self.bytes_touched
        if bt is None or not self.elapsed_ms:
            return None
        gbps = bt / (self.elapsed_ms * 1e-3) / 1e9
        return round(gbps, 2), round(100.0 * gbps / roof, 2)

    def render(self, indent: int = 0) -> str:
        rows = f" rows={self.output_rows}" if self.output_rows is not None else ""
        t = f" time={self.elapsed_ms:.1f}ms" if self.elapsed_ms is not None else ""
        by = f" bytes={_human_bytes(self.output_bytes)}" if self.output_bytes is not None else ""
        cap = f" cap={self.capacity}" if self.capacity is not None else ""
        rl = self.roofline()
        rls = f" {rl[0]}GB/s({rl[1]}%roof)" if rl else ""
        lines = ["  " * indent + f"{self.op}[{self.detail}]{rows}{cap}{by}{t}{rls}"]
        lines += [c.render(indent + 1) for c in self.children]
        return "\n".join(lines)

    def to_dict(self) -> dict:
        d = {"op": self.op, "detail": self.detail}
        for k in ("output_rows", "elapsed_ms", "output_bytes", "capacity"):
            v = getattr(self, k)
            if v is not None:
                d[k] = round(v, 3) if isinstance(v, float) else v
        rl = self.roofline()
        if rl:
            d["gb_per_s"], d["pct_roofline"] = rl
        if self.children:
            d["children"] = [c.to_dict() for c in self.children]
        return d

    def top_sinks(self, k: int = 3) -> List["MetricsNode"]:
        """The k operators of the largest marginal time."""
        flat: List[MetricsNode] = []

        def walk(n: "MetricsNode") -> None:
            flat.append(n)
            for c in n.children:
                walk(c)

        walk(self)
        return sorted([n for n in flat if n.elapsed_ms], key=lambda n: -n.elapsed_ms)[:k]


def _human_bytes(n: int) -> str:
    for unit in ("B", "KiB", "MiB", "GiB"):
        if n < 1024 or unit == "GiB":
            return f"{n:.1f}{unit}" if unit != "B" else f"{n}B"
        n /= 1024
    return f"{n}B"


def batch_static_bytes(batch) -> int:
    """A batch's buffer bytes (children included), from shapes alone."""

    def arr_bytes(a) -> int:
        return 0 if a is None else a.numel() * a.element_size()

    def cv_bytes(cv) -> int:
        return (arr_bytes(cv.data) + arr_bytes(cv.validity) + arr_bytes(cv.lengths)
                + sum(cv_bytes(c) for c in cv.children))

    return arr_bytes(batch.row_mask) + sum(cv_bytes(c) for c in batch.columns)


def _detail(plan: P.PlanNode) -> str:
    if isinstance(plan, P.Scan):
        return plan.table
    if isinstance(plan, P.Filter):
        return repr(plan.predicate)[:60]
    if isinstance(plan, P.HashAggregate):
        return f"mode={plan.mode} groups<={plan.max_groups}"
    if isinstance(plan, P.EQUI_JOINS):
        return plan.join_type
    if isinstance(plan, P.ShuffleExchange):
        return plan.partitioning
    return ""


def build_metrics_tree(plan: P.PlanNode, device_type: str = "cpu") -> MetricsNode:
    return MetricsNode(op=type(plan).__name__, detail=_detail(plan),
                       children=[build_metrics_tree(c, device_type) for c in plan.children()],
                       device_type=device_type)


class MetricsCollector:
    """Records each operator's output during a run (``record``, called by
    ``engine.run_plan``): its live-row count as a device tensor, its
    capacity and bytes; ``fill`` writes them into the tree after one
    device-to-host copy of the counts."""

    def __init__(self):
        self.names: List[int] = []  # id(plan) per recorded operator
        self.counts: List[torch.Tensor] = []
        self.static: Dict[int, tuple] = {}  # id(plan) -> (capacity, bytes)

    def record(self, plan: P.PlanNode, batch) -> None:
        self.names.append(id(plan))
        self.counts.append(batch.num_rows())
        self.static[id(plan)] = (batch.capacity, batch_static_bytes(batch))

    def resolved(self) -> Dict[int, int]:
        """{id(plan): live rows}, in one device-to-host copy."""
        if not self.counts:
            return {}
        host = torch.stack(self.counts).cpu().tolist()
        return dict(zip(self.names, host))

    def fill(self, tree: MetricsNode, plan: P.PlanNode, resolved: Dict[int, int]) -> None:
        if id(plan) in resolved:
            tree.output_rows = resolved[id(plan)]
        if id(plan) in self.static:
            tree.capacity, tree.output_bytes = self.static[id(plan)]
        for sub, child in zip(tree.children, plan.children()):
            self.fill(sub, child, resolved)

"""Query engine: a bound plan tree executed operator by operator over
device-resident tables (port of the ``Session`` subset of
``datafusion_comet_tpu/exec/engine.py`` that TPC-H Q1/Q6 reach).

PyTorch runs eagerly, so there is no whole-plan compile: ``compile`` binds
and prunes the plan and returns a function over the registered tables.
Data enters once per table (``register_numpy``) and leaves once at
``collect``; everything between stays on the session's device.
"""

from __future__ import annotations

from typing import Callable, Dict, List, Optional, Tuple, Union

import numpy as np
import torch

from datafusion_comet_tpu_torch import types as T
from datafusion_comet_tpu_torch.conf import Config
from datafusion_comet_tpu_torch.exec.batch import Batch, from_numpy, to_numpy
from datafusion_comet_tpu_torch.exec.evaluator import EvalContext
from datafusion_comet_tpu_torch.exec.operators import aggregate as AGG
from datafusion_comet_tpu_torch.exec.operators import basic as B
from datafusion_comet_tpu_torch.ir import plan as P
from datafusion_comet_tpu_torch.ir.pruning import prune_columns

__all__ = ["Session", "run_plan", "QueryExecutionError"]


class QueryExecutionError(RuntimeError):
    """An ANSI-mode runtime error raised by the query (Spark's SparkError)."""


def run_plan(plan: P.PlanNode, tables: Dict[str, Batch], ctx: EvalContext,
             conf: Config) -> Batch:
    """Execute a bound plan over registered tables."""
    if isinstance(plan, P.Scan):
        b = tables[plan.table]
        if plan.projection is not None:
            b = b.select([b.schema.index_of(n) for n in plan.projection], plan.schema)
        return b
    child = run_plan(plan.children()[0], tables, ctx, conf)
    if isinstance(plan, P.Filter):
        return B.filter_op(child, plan.predicate, ctx)
    if isinstance(plan, P.Projection):
        return B.project_op(child, plan.exprs, plan.schema, ctx)
    if isinstance(plan, P.HashAggregate):
        return AGG.hash_aggregate(child, plan.group_exprs, plan.agg_exprs, plan.mode,
                                  plan.schema, ctx, conf.agg_dense_max_domain)
    if isinstance(plan, P.Sort):
        return B.sort_op(child, plan.orders, ctx)
    raise NotImplementedError(f"run_plan: {type(plan).__name__}")


class Session:
    """Table registry + plan executor on one device.

    ``device`` defaults to ``"cuda"``: without a card that raises, and a
    caller that means the CPU passes ``device="cpu"``."""

    def __init__(self, device: Union[str, torch.device, None] = None,
                 conf: Optional[Config] = None):
        self.device = torch.device(device or "cuda")
        if self.device.type == "cuda":
            if not torch.cuda.is_available():
                raise RuntimeError("Session runs on a CUDA card and none is available; "
                                   "pass device='cpu' to run on the CPU")
            if self.device.index is None:
                self.device = torch.device("cuda", torch.cuda.current_device())
        self.conf = conf or Config()
        self.tables: Dict[str, Batch] = {}

    def register_batch(self, name: str, batch: Batch) -> None:
        if batch.device != self.device:
            raise ValueError(f"batch lives on {batch.device}, session on {self.device}")
        self.tables[name] = batch

    def register_numpy(self, name: str, data: Dict[str, np.ndarray], schema: T.Schema,
                       **kw) -> None:
        """Stage host columns on the session's device (see batch.from_numpy)."""
        kw.setdefault("dict_max_size", self.conf.scan_dictionary_max_size)
        self.tables[name] = from_numpy(data, schema, self.device, **kw)

    def compile(self, plan: P.PlanNode
                ) -> Tuple[P.PlanNode, Callable[[Dict[str, Batch]], Batch]]:
        """Prune + bind a plan; returns (bound plan, fn(tables) -> batch).
        ``fn`` raises QueryExecutionError when a flag of the error side
        channel fired: an ANSI error, or a kernel's bucket code out of range.

        The dense aggregate has no static capacity to overflow, so there is
        no re-plan loop; it comes with the sorted aggregate path."""
        bound = P.bind_plan(prune_columns(plan))

        def fn(tables: Dict[str, Batch]) -> Batch:
            errs: List[Tuple[torch.Tensor, str]] = []
            out = run_plan(bound, tables, EvalContext(errors=errs), self.conf)
            if errs:  # every flag of the query in one device-to-host read
                hit = torch.stack([f.any() for f, _ in errs]).tolist()
                fired = [m for (_, m), h in zip(errs, hit) if h]
                if fired:
                    raise QueryExecutionError("; ".join(dict.fromkeys(fired)))
            return out

        return bound, fn

    def execute(self, plan: P.PlanNode) -> Batch:
        return self.compile(plan)[1](self.tables)

    def collect(self, plan: P.PlanNode) -> Dict[str, np.ndarray]:
        return to_numpy(self.execute(plan))

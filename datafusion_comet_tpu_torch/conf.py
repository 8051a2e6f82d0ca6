"""Session settings (port of the ``datafusion_comet_tpu/conf.py`` keys the
Q1/Q6/Q12/Q3 slices and the runtime filters read).

The JAX package keeps a process-wide mutable registry; here the settings are
one immutable object that a ``Session`` owns and passes down, so two sessions
in one process never see each other's values. The per-operator and
per-expression gates (exec/registry.py) are one field, ``gates``, keyed by
the JAX package's config strings.
"""

from __future__ import annotations

import dataclasses
from typing import Mapping, Tuple, Union

__all__ = ["Config", "CAST_ALLOW_INCOMPATIBLE", "JSON_DEVICE_ENABLED"]

# the gates that are not an operator's or an expression's enable switch
CAST_ALLOW_INCOMPATIBLE = "comet.expression.Cast.allowIncompatible"
JSON_DEVICE_ENABLED = "comet.expr.json.deviceEnabled"


@dataclasses.dataclass(frozen=True)
class Config:
    # comet.exec.agg.denseMaxDomain: group-by key domains at most this large
    # (provable from dictionary / narrow-type packing) aggregate on the dense
    # bucket path.
    agg_dense_max_domain: int = 64
    # comet.scan.dictionary.maxSize: string columns with at most this many
    # distinct values are dictionary-encoded at staging (sorted dictionary +
    # int32 codes, order-isomorphic to string order). 0 disables.
    scan_dictionary_max_size: int = 1 << 16
    # comet.memory.fraction: the share of the device's memory the planner may
    # plan into. A plan whose resident-bytes estimate is over it runs its
    # join hash-partitioned (the grace join).
    memory_fraction: float = 0.8
    # comet.exec.stage.maxJoinsPerProgram: a plan with more joins than this
    # runs as several stages, each join-carrying child its own stage whose
    # result becomes a temporary table. 0 disables the split.
    stage_max_joins: int = 2
    # comet.exec.stage.maxHeavyOpsPerProgram: beyond the join budget, a stage
    # with more heavy operators (joins, sorts, grouping aggregates) than this
    # is cut below a Sort or grouping HashAggregate. 0 disables the split.
    stage_max_heavy_ops: int = 3
    # comet.exec.runtimeFilter.enabled: inject plan-time runtime semi-join
    # filters (exec/runtime_filter.py): a selective Scan+Filter dimension
    # chain is evaluated on the host, its surviving join keys become a
    # constant table, and a LEFT_SEMI join against it is pushed down the
    # fact side of an equi-join.
    runtime_filter_enabled: bool = True
    # comet.exec.agg.approxPercentile.sketchSize: the samples an approx_percentile
    # PARTIAL state keeps per group (its sketch is 8 bytes a sample).
    approx_percentile_sketch: int = 512
    # comet.tracing.enabled: append the engine's spans to the Chrome-trace
    # file (observability/trace.py; COMET_TPU_TRACING=1 turns it on too)
    tracing_enabled: bool = False
    # comet.debug.validateBatches: check every operator's output batch
    # (exec/debug.py ``check_batch``), at a host copy per check
    debug_validate_batches: bool = False
    # the boolean gates by key (every gate is true unless set here):
    # comet.exec.operator.<Op>.enabled and comet.expr.<name>.enabled turn a
    # plan node or an expression off (the plan is then unsupported:
    # exec/registry.py), comet.expression.Cast.allowIncompatible allows the
    # cast pairs the cast matrix marks incompatible, and
    # comet.expr.json.deviceEnabled runs get_json_object's simple paths on
    # the device. A mapping is kept as sorted (key, value) pairs.
    gates: Union[Mapping[str, bool], Tuple[Tuple[str, bool], ...]] = ()

    def __post_init__(self):
        object.__setattr__(self, "gates", tuple(sorted(dict(self.gates).items())))
        object.__setattr__(self, "_gate_map", dict(self.gates))

    def gate(self, key: str) -> bool:
        """The value of a boolean gate (true where unset)."""
        return self._gate_map.get(key, True)

"""Session settings (port of the ``datafusion_comet_tpu/conf.py`` keys the
Q1/Q6/Q12 slice reads).

The JAX package keeps a process-wide mutable registry; here the settings are
one immutable object that a ``Session`` owns and passes down, so two sessions
in one process never see each other's values.
"""

from __future__ import annotations

import dataclasses

__all__ = ["Config"]


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

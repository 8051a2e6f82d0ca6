"""Device profile of a callable through ``torch.profiler`` (the port's
counterpart of ``datafusion_comet_tpu/observability/xla_profile.py``:
``parse_xla_trace`` :34, ``device_profile`` :69).

``device_profile(fn)`` runs ``fn`` once to warm it (unless ``warmup`` is
False), then once under the profiler, and returns the JAX module's report
keys: ``lanes`` ({lane: {op: total µs}}: ``device`` for the card's kernels
and copies, ``host`` for the CPU-side ops and the engine's
``record_function`` spans) and ``top_device_ops`` ([(op, µs)], the 25
largest device lanes' ops), plus ``device_events`` and ``host_events``,
the event counts of each side. With no card it profiles CPU activity only:
``device`` is empty and ``device_events`` 0.
"""

from __future__ import annotations

import collections
from typing import Callable, Dict

import torch

__all__ = ["device_profile", "parse_profile"]


def _sync() -> None:
    if torch.cuda.is_available():
        torch.cuda.synchronize()


def parse_profile(prof) -> dict:
    """A finished ``torch.profiler.profile``'s events as the report: a
    device row is an op with device time of its own (kernels, copies,
    memsets), a host row every CPU-side op or span."""
    lanes: Dict[str, collections.Counter] = {"device": collections.Counter(),
                                             "host": collections.Counter()}
    counts = collections.Counter()
    for ev in prof.key_averages():
        if ev.device_type == torch.autograd.DeviceType.CUDA:
            if ev.self_device_time_total:
                lanes["device"][ev.key] += ev.self_device_time_total
                counts["device"] += ev.count
        else:
            lanes["host"][ev.key] += ev.cpu_time_total
            counts["host"] += ev.count
    return {"lanes": {k: dict(v) for k, v in lanes.items() if v},
            "top_device_ops": lanes["device"].most_common(25),
            "device_events": counts["device"], "host_events": counts["host"]}


def device_profile(fn: Callable[[], object], warmup: bool = True) -> dict:
    """Run ``fn`` under torch.profiler (CUDA activity where a card is
    available) and return the parsed report; warm it first unless
    ``warmup`` is False, so the capture holds execution, not first-use
    builds."""
    from torch.profiler import ProfilerActivity, profile

    if warmup:
        fn()
        _sync()
    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if torch.cuda.is_available()
                                     else [])
    with profile(activities=acts) as prof:
        fn()
        _sync()
    return parse_profile(prof)

"""Chrome-trace recorder: spans and counters appended to a JSON trace file
(port of ``datafusion_comet_tpu/observability/trace.py``).

The event format and file name are the JAX package's (begin ``B`` and end
``E`` spans, ``C`` counters, ``comet-event-trace.json``), so
chrome://tracing and Perfetto read the port's traces as they read its.
The recorder is off unless ``COMET_TPU_TRACING=1`` is set (the JAX
package's ``comet.tracing.enabled`` reads the same variable) or a
``Session`` is made with ``Config(tracing_enabled=True)``; the file is
``COMET_TPU_TRACE_FILE`` or ``comet-event-trace.json`` in the working
directory.

``with_trace`` also opens a ``torch.profiler.record_function`` range of the
span's name, recorder on or off, so the engine's spans show in a
torch.profiler trace (``observability/profile.py``) as well.
"""

from __future__ import annotations

import json
import os
import threading
import time
from contextlib import contextmanager
from typing import Any, Dict, Optional

from torch.profiler import record_function

__all__ = ["Tracer", "tracer", "with_trace", "trace_counter"]


class Tracer:
    def __init__(self, path: str = "comet-event-trace.json", enabled: bool = False):
        self.path = path
        self.enabled = enabled
        self._lock = threading.Lock()
        self._started = False

    def _emit(self, ev: Dict[str, Any]) -> None:
        if not self.enabled:
            return
        with self._lock:
            new = not self._started and not os.path.exists(self.path)
            with open(self.path, "a") as f:
                if new:
                    f.write("[\n")
                f.write(json.dumps(ev) + ",\n")
            self._started = True

    def _event(self, name: str, ph: str, tid: int, **extra) -> Dict[str, Any]:
        return {"name": name, "ph": ph, "ts": time.time() * 1e6, "pid": os.getpid(),
                "tid": tid, **extra}

    def begin(self, name: str, **args) -> None:
        self._emit(self._event(name, "B", threading.get_ident() % (1 << 31), args=args))

    def end(self, name: str) -> None:
        self._emit(self._event(name, "E", threading.get_ident() % (1 << 31)))

    def counter(self, name: str, **values) -> None:
        self._emit(self._event(name, "C", 0, args=values))


tracer = Tracer(path=os.environ.get("COMET_TPU_TRACE_FILE", "comet-event-trace.json"),
                enabled=os.environ.get("COMET_TPU_TRACING", "0") == "1")


@contextmanager
def with_trace(name: str, t: Optional[Tracer] = None, **args):
    """A span of the recorder and a torch.profiler range of one name."""
    tr = t or tracer
    tr.begin(name, **args)
    try:
        with record_function(name):
            yield
    finally:
        tr.end(name)


def trace_counter(name: str, t: Optional[Tracer] = None, **values) -> None:
    (t or tracer).counter(name, **values)

"""The JAX side of the port's parity tests compiles the same XLA programs
as the JAX package's own tests (the TPC-DS and TPC-H plans at the same
scale and staging) and as other parity files: this turns on JAX's
persistent compilation cache for the test run, in a directory of the
system's temporary one that the run's xdist workers share (keyed by the
run's ``PYTEST_XDIST_TESTRUNUID``, a process's own id outside xdist), so a
program compiled in one worker is read, not compiled, in the others. The
first port test module imported (every worker imports them all at
collection) turns it on; a compile under half a second is not written. Nothing changes but compile time: a cache entry is the
program JAX would compile, and a read that fails falls back to compiling."""

import os
import tempfile


def enable() -> None:
    try:
        import jax
        from jax.experimental.compilation_cache import compilation_cache
    except ImportError:  # the card's machine has no JAX: nothing to cache
        return
    run = os.environ.get("PYTEST_XDIST_TESTRUNUID") or f"pid{os.getpid()}"
    path = os.path.join(tempfile.gettempdir(), f"comet-port-tests-jax-cache-{run}")
    os.makedirs(path, exist_ok=True)
    jax.config.update("jax_compilation_cache_dir", path)
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 0.5)
    # a compile before this call decided "no cache" for the process: ask again
    compilation_cache.reset_cache()

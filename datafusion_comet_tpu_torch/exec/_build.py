"""Build the port's CUDA sources (``csrc/bucket_kernels.cu``,
``csrc/partition_kernels.cu``) with nvcc, each into a shared library with a
plain C interface, and load them with ctypes.

The first use on a machine with the CUDA toolkit compiles; later uses load
the library keyed by a digest of the source and the flags, from ``_build/``
beside the package (listed in .gitignore). Nothing here runs at import
time: this module is imported on machines without a compiler or a card.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

__all__ = ["build", "load"]

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3", "-shared",
              "-Xcompiler", "-fPIC", "-Xptxas", "-v")


def nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") or "/usr/local/cuda"
    for cand in (Path(home) / "bin" / "nvcc", shutil.which("nvcc")):
        if cand and Path(cand).exists():
            return str(cand)
    raise RuntimeError("nvcc not found: set CUDA_HOME to the CUDA toolkit that builds csrc/")


def _lib_path(name: str) -> Path:
    h = hashlib.sha256((CSRC / f"{name}.cu").read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:16]}.so"


def build(name: str) -> str:
    """Compile ``csrc/<name>.cu`` unless its library exists. Returns nvcc's
    output (ptxas register and shared-memory use), "" when nothing was
    built; raises with that output when nvcc fails."""
    so = _lib_path(name)
    if so.exists():
        return ""
    BUILD_DIR.mkdir(exist_ok=True)
    tmp = so.with_name(f"{so.name}.{os.getpid()}.tmp")
    r = subprocess.run([nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")],
                       stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    if r.returncode:
        raise RuntimeError(f"nvcc failed on {name}.cu:\n{r.stdout}")
    os.replace(tmp, so)
    return r.stdout


@functools.lru_cache(maxsize=None)
def load(name: str) -> ctypes.CDLL:
    """The built library of ``csrc/<name>.cu``, building it first if needed."""
    build(name)
    return ctypes.CDLL(str(_lib_path(name)))

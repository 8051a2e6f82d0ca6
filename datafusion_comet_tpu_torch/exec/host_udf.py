"""Scalar Python UDFs, evaluated on the host (port of
``datafusion_comet_tpu/exec/host_udf.py``).

The analog of the reference's JVM UDF callback: the whole argument batch
crosses to the host once, the UDF runs there (row at a time, or over the
batch through its ``batch_fn``), and its results come back as one column.
The JAX package evaluates the UDF inside its compiled program through
``jax.pure_callback``, or between two programs where the backend has no
callbacks; eager PyTorch evaluates it in place: one device-to-host copy of
the live-row mask and the arguments, the UDF, one host-to-device copy of
the result. A UDF in any plan node runs there, with no stage split.

``batch_mode="raw"`` hands ``batch_fn`` each argument as a ``HostColumn``:
numpy arrays under the JAX package's field names (``data``, ``validity``,
``lengths``, ``is_dict``, and a dictionary column's ``dictionary.values``
and ``dictionary.lengths``).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Optional, Tuple

import numpy as np
import torch

from datafusion_comet_tpu_torch import types as T
from datafusion_comet_tpu_torch.exec.batch import (Batch, ColumnVector, map_buffers,
                                                  nested_from_py, nested_to_py)
from datafusion_comet_tpu_torch.ir import expr as E

__all__ = ["eval_python_udf", "HostColumn"]


@dataclasses.dataclass(frozen=True)
class HostColumn:
    """A column's buffers as host numpy arrays (``batch_mode="raw"``)."""

    data: np.ndarray
    validity: np.ndarray
    lengths: Optional[np.ndarray]
    dtype: T.DataType
    dictionary: Any = None  # the StringDict: ``values`` (K, w), ``lengths`` (K,)
    children: Tuple["HostColumn", ...] = ()

    @property
    def is_dict(self) -> bool:
        return self.dictionary is not None


def _host_column(cv: ColumnVector) -> HostColumn:
    return HostColumn(cv.data.cpu().numpy(), cv.validity.cpu().numpy(),
                      None if cv.lengths is None else cv.lengths.cpu().numpy(), cv.dtype,
                      cv.dictionary, tuple(_host_column(c) for c in cv.children))


def _run_udf(e: E.PythonUdf, mask: np.ndarray, cols, cap: int):
    """The columnar ``batch_fn`` where the UDF has one (a list of Python
    values or a ColumnVector), else the row loop: None for a dead row, the
    UDF of the row's values (None for a null) for a live one."""
    if e.batch_fn is not None:
        return e.batch_fn(mask, *cols)
    return [e.fn(*[c[i] for c in cols]) if mask[i] else None for i in range(cap)]


def eval_python_udf(e: E.PythonUdf, b: Batch, ctx, ev) -> ColumnVector:
    arg_cvs = [ev(a, b, ctx) for a in e.args]
    cap, dev = b.capacity, b.device
    if ctx.validating:
        # Session.validate checks the plan without running user code
        return nested_from_py([], e.out_dtype, cap, dev)
    mask = b.row_mask.cpu().numpy()
    if e.batch_fn is not None and e.batch_mode == "raw":
        results = e.batch_fn(mask, *[_host_column(cv) for cv in arg_cvs])
    else:
        results = _run_udf(e, mask, [nested_to_py(cv) for cv in arg_cvs], cap)
    if isinstance(results, ColumnVector):  # a fully columnar batch_fn
        return map_buffers(results, lambda a: torch.as_tensor(a).to(dev))
    return nested_from_py(list(results), e.out_dtype, cap, dev)

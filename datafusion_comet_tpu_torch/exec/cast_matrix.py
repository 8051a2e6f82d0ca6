"""The cast support matrix: compatible, incompatible or unsupported for each
pair of types (port of ``datafusion_comet_tpu/exec/cast_matrix.py``; it
renders no document).

``cast_support(frm, to)`` probes the evaluator's Cast itself on a one-row
batch of CPU tensors (a pair the evaluator cannot cast raises) and overlays
the JAX package's list of known deviations, so the matrix follows the code.
"""

from __future__ import annotations

from typing import Dict, Tuple

import numpy as np
import torch

from datafusion_comet_tpu_torch import types as T

__all__ = ["cast_support", "support_for_types", "MATRIX_TYPES"]

MATRIX_TYPES = [
    ("boolean", T.BOOL),
    ("byte", T.INT8),
    ("short", T.INT16),
    ("int", T.INT32),
    ("long", T.INT64),
    ("float", T.FLOAT32),
    ("double", T.FLOAT64),
    ("decimal(10,2)", T.decimal(10, 2)),
    ("decimal(38,10)", T.decimal(38, 10)),
    ("date", T.DATE),
    ("timestamp", T.TIMESTAMP),
    ("timestamp_ntz", T.TIMESTAMP_NTZ),
    ("string", T.string(64)),
]

# the JAX package's documented deviations (its "incompatible" tier)
_INCOMPATIBLE: Dict[Tuple[str, str], str] = {
    ("float", "string"): "subnormals print 0.0 in the JAX package (XLA flushes them)",
    ("double", "string"): "subnormals print 0.0 in the JAX package (XLA flushes them)",
    ("string", "timestamp"): "fractional-zone offsets (e.g. +05:30) via the fixed-offset "
                             "table only",
    ("string", "timestamp_ntz"): "same parser caveats as string->timestamp",
    ("double", "decimal(38,10)"): "values needing >2^53 integer precision round through f64",
    ("float", "decimal(38,10)"): "rounds through f64 first",
}

_CACHE: Dict[Tuple[str, str], Tuple[str, str]] = {}


def cast_support(frm_name: str, to_name: str) -> Tuple[str, str]:
    """('compatible' | 'incompatible' | 'unsupported', note) of a named pair."""
    key = (frm_name, to_name)
    if key not in _CACHE:
        frm, to = dict(MATRIX_TYPES)[frm_name], dict(MATRIX_TYPES)[to_name]
        if frm == to:
            level = ("compatible", "identity")
        else:
            level = _probe(frm, to)
            if level[0] == "compatible" and key in _INCOMPATIBLE:
                level = ("incompatible", _INCOMPATIBLE[key])
        _CACHE[key] = level
    return _CACHE[key]


def support_for_types(frm: T.DataType, to: T.DataType) -> Tuple[str, str]:
    """The support level of any pair of types, mapped onto the named grid
    (JAX ``cast_matrix.py:75``); a pair outside the grid is compatible."""
    def name_of(dt: T.DataType):
        for n, t in MATRIX_TYPES:
            if t.type_id == dt.type_id and not dt.is_decimal and not dt.is_binary:
                return n
        if dt.is_decimal:
            return "decimal(38,10)" if dt.is_wide_decimal else "decimal(10,2)"
        return "string" if dt.type_id == "STRING" else None

    fn, tn = name_of(frm), name_of(to)
    if fn is None or tn is None:
        return ("compatible", "")
    return cast_support(fn, tn)


def _probe(frm: T.DataType, to: T.DataType) -> Tuple[str, str]:
    from datafusion_comet_tpu_torch.exec.batch import Batch, ColumnVector
    from datafusion_comet_tpu_torch.exec.evaluator import evaluate
    from datafusion_comet_tpu_torch.ir import expr as E

    schema = T.Schema([T.Field("x", frm)])
    one = torch.ones(1, dtype=torch.bool)
    if frm.is_binary:
        cv = ColumnVector(torch.zeros((1, frm.byte_width), dtype=torch.uint8), one,
                          torch.zeros(1, dtype=torch.int32), frm)
    else:
        cv = ColumnVector(torch.from_numpy(np.zeros(1, frm.np_dtype())), one, None, frm)
    try:
        evaluate(E.bind(E.Cast(E.col("x"), to), schema), Batch((cv,), one, schema))
        return ("compatible", "")
    except NotImplementedError as e:
        return ("unsupported", str(e)[:80])
    except Exception as e:  # a type or shape error: the pair is not expressible
        return ("unsupported", type(e).__name__)

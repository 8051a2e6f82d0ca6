"""Plan and expression serde: a versioned JSON form of the IR (port of
``datafusion_comet_tpu/ir/serde.py``, its format for every node and
expression the port has).

``{"version": 1, "plan": <node>}``, every node and expression a
``{"_k": <class name>, ...fields}`` object of its dataclass fields (a
node's ``schema`` and an expression's ``dtype``, which binding computes,
are left out); data types, schemas, sort orders, aggregates and window
specs serialize structurally; a ``PythonUdf`` (a host callable) does not
serialize, nor a ``MapInBatch``'s function. The port's plan nodes hold their planner
hints as fields (``Filter.out_rows_hint``, ``HashAggregate.
group_key_ranges`` and ``merge_rows``, the ``HashJoin`` hints), so they
serialize too; the JAX package keeps its hints as attributes outside the
JSON. The session keys its subquery reuse by this form
(``Session.scalar_subquery``).
"""

from __future__ import annotations

import dataclasses
import json
from typing import Any, Dict

import numpy as np

from datafusion_comet_tpu_torch import types as T
from datafusion_comet_tpu_torch.ir import expr as E
from datafusion_comet_tpu_torch.ir import plan as P

__all__ = ["plan_to_json", "plan_from_json", "expr_to_dict", "expr_from_dict"]

VERSION = 1

_EXPR_CLASSES = {cls.__name__: cls for cls in vars(E).values()
                 if isinstance(cls, type) and issubclass(cls, E.Expr)}
_PLAN_CLASSES = {cls.__name__: cls for cls in vars(P).values()
                 if isinstance(cls, type) and issubclass(cls, P.PlanNode)}
# the spec dataclasses that are neither expressions nor plan nodes
_SPEC_CLASSES = {cls.__name__: cls for cls in (E.SortOrder, E.AggExpr, E.WindowFrame,
                                               E.WindowExpr)}


def _dtype_to_dict(dt: T.DataType) -> Dict[str, Any]:
    out: Dict[str, Any] = {"id": dt.type_id}
    if dt.is_decimal:
        out["precision"] = dt.precision
        out["scale"] = dt.scale
    if dt.is_binary:
        out["max_len"] = dt.max_len
    if dt.tz:
        out["tz"] = dt.tz
    if dt.element is not None:
        out["element"] = _dtype_to_dict(dt.element)
        out["max_elems"] = dt.max_elems
    if dt.struct_fields:
        out["fields"] = _schema_to_dict(dt.struct_fields)
    return out


def _dtype_from_dict(d: Dict[str, Any]) -> T.DataType:
    return T.DataType(d["id"], precision=d.get("precision", 0), scale=d.get("scale", 0),
                      max_len=d.get("max_len", 0), tz=d.get("tz"),
                      element=_dtype_from_dict(d["element"]) if "element" in d else None,
                      max_elems=d.get("max_elems", 0),
                      struct_fields=tuple(_schema_from_dict(d.get("fields", [])).fields))


def _schema_to_dict(s):
    """A schema's (or a struct's) fields."""
    return [{"name": f.name, "dtype": _dtype_to_dict(f.dtype), "nullable": f.nullable}
            for f in (s.fields if isinstance(s, T.Schema) else s)]


def _schema_from_dict(d) -> T.Schema:
    return T.Schema([T.Field(f["name"], _dtype_from_dict(f["dtype"]), f.get("nullable", True))
                     for f in d])


def _fields_to_dict(obj) -> Dict[str, Any]:
    """A dataclass's constructor fields (a node's schema and an
    expression's dtype are not among them). The tuples of an aggregate or
    a window spec are plain lists, as the JAX package writes them."""
    out: Dict[str, Any] = {"_k": type(obj).__name__}
    spec = type(obj).__name__ in _SPEC_CLASSES
    for f in dataclasses.fields(obj):
        if f.init:
            v = getattr(obj, f.name)
            out[f.name] = ([_value_to_dict(x) for x in v] if spec and isinstance(v, tuple)
                           else _value_to_dict(v))
    return out


def _value_to_dict(v: Any) -> Any:
    if isinstance(v, E.PythonUdf):  # JAX ``serde.py:186``
        raise TypeError("PythonUdf carries a host callable and does not serialize")
    if isinstance(v, (P.PlanNode, E.Expr) + tuple(_SPEC_CLASSES.values())):
        return _fields_to_dict(v)
    if isinstance(v, T.DataType):
        return {"_k": "DataType", **_dtype_to_dict(v)}
    if isinstance(v, T.Schema):
        return {"_k": "Schema", "fields": _schema_to_dict(v)}
    if isinstance(v, tuple):
        return {"_k": "tuple", "items": [_value_to_dict(x) for x in v]}
    if isinstance(v, dict):
        return {"_k": "dict", "items": [[k, _value_to_dict(x)] for k, x in v.items()]}
    if isinstance(v, bytes):
        return {"_k": "bytes", "hex": v.hex()}
    if v is None or isinstance(v, (bool, int, float, str)):
        return v
    if isinstance(v, np.generic):
        return v.item()
    raise TypeError(f"cannot serialize {type(v).__name__}: {v!r}")


def _value_from_dict(v: Any) -> Any:
    if not isinstance(v, dict):
        return v
    k = v.get("_k")
    if k == "tuple":
        return tuple(_value_from_dict(x) for x in v["items"])
    if k == "dict":
        return {key: _value_from_dict(x) for key, x in v["items"]}
    if k == "bytes":
        return bytes.fromhex(v["hex"])
    if k == "DataType":
        return _dtype_from_dict(v)
    if k == "Schema":
        return _schema_from_dict(v["fields"])
    cls = _EXPR_CLASSES.get(k) or _PLAN_CLASSES.get(k) or _SPEC_CLASSES.get(k)
    if cls is None:
        raise TypeError(f"cannot deserialize {k!r}")
    return cls(**{name: tuple(map(_value_from_dict, x)) if isinstance(x, list)
                  else _value_from_dict(x) for name, x in v.items() if name != "_k"})


def expr_to_dict(e: E.Expr) -> Dict[str, Any]:
    return _value_to_dict(e)


def expr_from_dict(d: Dict[str, Any]) -> E.Expr:
    return _value_from_dict(d)


def plan_to_json(plan: P.PlanNode, indent=None) -> str:
    return json.dumps({"version": VERSION, "plan": _value_to_dict(plan)}, indent=indent)


def plan_from_json(s: str) -> P.PlanNode:
    doc = json.loads(s)
    if doc.get("version") != VERSION:
        raise ValueError(f"unsupported plan IR version {doc.get('version')}")
    return _value_from_dict(doc["plan"])

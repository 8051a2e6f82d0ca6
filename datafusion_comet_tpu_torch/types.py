"""Logical type system (port of ``datafusion_comet_tpu/types.py``: its
scalar types and the nested LIST, MAP and STRUCT).

Physical mapping, the same as the JAX package so both hold identical buffers:

- fixed-width numerics map onto the matching torch dtype;
- DECIMAL(p<=18, s) is a scaled int64; wider decimals are a scaled int64
  while their values provably fit ("narrow storage") and a (rows, 2) int64
  [hi, lo] two's-complement i128 otherwise (``is_wide_decimal``);
- DATE is int32 days since the Unix epoch, TIMESTAMP and TIMESTAMP_NTZ
  int64 microseconds since it: a TIMESTAMP is an instant and carries its
  session zone (``tz``, "UTC" by default), a TIMESTAMP_NTZ a wall clock;
- STRING/BYTES are fixed-capacity padded uint8 matrices plus int32 lengths,
  or int32 codes into a sorted host dictionary (exec/dictionary.py);
- a LIST carries a fixed per-row element capacity ``max_elems`` (E): its
  buffer holds each row's element count and its one child the elements,
  (cap, E) or (cap, E, L) for string elements; a MAP is a LIST of
  STRUCT(key, value) entries; a STRUCT's buffer is an int8 placeholder and
  its fields are its row-shaped children.

Pure metadata: nothing here touches torch.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np

__all__ = [
    "DataType", "BOOL", "INT8", "INT16", "INT32", "INT64", "FLOAT32", "FLOAT64",
    "DATE", "TIMESTAMP", "TIMESTAMP_NTZ", "NULLTYPE", "string", "binary", "decimal", "Field",
    "Schema", "common_type", "MAX_DECIMAL_PRECISION", "list_", "struct", "map_",
    "DEFAULT_LIST_ELEMS",
]

# Default padded width for STRING columns when nothing tighter is known.
DEFAULT_STRING_LEN = 200

# Spark constants (DecimalType).
MAX_DECIMAL_PRECISION = 38
MAX_INT64_DECIMAL_PRECISION = 18

_NP_DTYPES = {
    "BOOL": np.bool_, "INT8": np.int8, "INT16": np.int16, "INT32": np.int32,
    "INT64": np.int64, "FLOAT": np.float32, "DOUBLE": np.float64,
    "DATE": np.int32, "TIMESTAMP": np.int64, "TIMESTAMP_NTZ": np.int64, "NULL": np.int8,
    "DECIMAL": np.int64, "STRING": np.uint8, "BYTES": np.uint8,
    "LIST": np.int32, "MAP": np.int32, "STRUCT": np.int8,
}


@dataclasses.dataclass(frozen=True)
class DataType:
    """A logical data type; equality is structural."""

    type_id: str
    precision: int = 0  # decimal only
    scale: int = 0  # decimal only
    max_len: int = 0  # string/binary only: padded byte width
    tz: Optional[str] = None  # timestamp only
    element: Optional["DataType"] = None  # LIST: element type; MAP: the entry STRUCT
    max_elems: int = 0  # LIST/MAP: the per-row element capacity
    struct_fields: Tuple["Field", ...] = ()  # STRUCT only

    @property
    def is_integer(self) -> bool:
        return self.type_id in ("INT8", "INT16", "INT32", "INT64")

    @property
    def is_floating(self) -> bool:
        return self.type_id in ("FLOAT", "DOUBLE")

    @property
    def is_decimal(self) -> bool:
        return self.type_id == "DECIMAL"

    @property
    def is_wide_decimal(self) -> bool:
        """DECIMAL(p>18): may need two-limb i128 storage."""
        return self.type_id == "DECIMAL" and self.precision > MAX_INT64_DECIMAL_PRECISION

    @property
    def is_string(self) -> bool:
        return self.type_id == "STRING"

    @property
    def is_binary(self) -> bool:
        return self.type_id in ("STRING", "BYTES")

    @property
    def is_temporal(self) -> bool:
        return self.type_id in ("DATE", "TIMESTAMP", "TIMESTAMP_NTZ")

    @property
    def is_boolean(self) -> bool:
        return self.type_id == "BOOL"

    @property
    def is_list(self) -> bool:
        return self.type_id == "LIST"

    @property
    def is_map(self) -> bool:
        return self.type_id == "MAP"

    @property
    def is_struct(self) -> bool:
        return self.type_id == "STRUCT"

    @property
    def is_nested(self) -> bool:
        return self.type_id in ("LIST", "MAP", "STRUCT")

    @property
    def key_type(self) -> "DataType":
        assert self.is_map and self.element is not None
        return self.element.struct_fields[0].dtype

    @property
    def value_type(self) -> "DataType":
        assert self.is_map and self.element is not None
        return self.element.struct_fields[1].dtype

    def np_dtype(self) -> np.dtype:
        """numpy dtype of the primary data buffer."""
        if self.type_id not in _NP_DTYPES:
            raise NotImplementedError(f"no physical dtype for {self}")
        return np.dtype(_NP_DTYPES[self.type_id])

    @property
    def byte_width(self) -> int:
        if self.is_binary:
            return self.max_len or DEFAULT_STRING_LEN
        return self.np_dtype().itemsize

    def int_bounds(self) -> Tuple[int, int]:
        assert self.is_integer
        bits = {"INT8": 8, "INT16": 16, "INT32": 32, "INT64": 64}[self.type_id]
        return -(1 << (bits - 1)), (1 << (bits - 1)) - 1

    def __repr__(self) -> str:
        if self.type_id == "DECIMAL":
            return f"decimal({self.precision},{self.scale})"
        if self.type_id == "STRING":
            return f"string({self.max_len})" if self.max_len else "string"
        if self.type_id == "TIMESTAMP" and self.tz:
            return f"timestamp<{self.tz}>"
        if self.type_id == "LIST":
            return f"array<{self.element!r}>[{self.max_elems}]"
        if self.type_id == "MAP":
            return f"map<{self.key_type!r},{self.value_type!r}>[{self.max_elems}]"
        if self.type_id == "STRUCT":
            inner = ",".join(f"{f.name}:{f.dtype!r}" for f in self.struct_fields)
            return f"struct<{inner}>"
        return self.type_id.lower()


BOOL = DataType("BOOL")
INT8 = DataType("INT8")
INT16 = DataType("INT16")
INT32 = DataType("INT32")
INT64 = DataType("INT64")
FLOAT32 = DataType("FLOAT")
FLOAT64 = DataType("DOUBLE")
DATE = DataType("DATE")
TIMESTAMP = DataType("TIMESTAMP", tz="UTC")
TIMESTAMP_NTZ = DataType("TIMESTAMP_NTZ")
NULLTYPE = DataType("NULL")


def string(max_len: int = DEFAULT_STRING_LEN) -> DataType:
    return DataType("STRING", max_len=max_len)


def binary(max_len: int = DEFAULT_STRING_LEN) -> DataType:
    return DataType("BYTES", max_len=max_len)


def decimal(precision: int, scale: int) -> DataType:
    if not (0 < precision <= MAX_DECIMAL_PRECISION) or scale > precision:
        raise ValueError(f"invalid decimal({precision},{scale})")
    return DataType("DECIMAL", precision=precision, scale=scale)


# the per-row element capacity of a LIST or MAP when none is given
DEFAULT_LIST_ELEMS = 16


def list_(element: DataType, max_elems: int = DEFAULT_LIST_ELEMS) -> DataType:
    """ARRAY<element> with a fixed per-row element capacity."""
    return DataType("LIST", element=element, max_elems=max_elems)


def struct(*fields) -> DataType:
    """STRUCT<fields>, of Fields or (name, dtype) pairs."""
    fs = tuple(f if isinstance(f, Field) else Field(f[0], f[1]) for f in fields)
    return DataType("STRUCT", struct_fields=fs)


def map_(key: DataType, value: DataType, max_elems: int = DEFAULT_LIST_ELEMS) -> DataType:
    """MAP<key, value>: a LIST of STRUCT(key, value) entries."""
    return DataType("MAP", element=struct(("key", key), ("value", value)), max_elems=max_elems)


@dataclasses.dataclass(frozen=True)
class Field:
    name: str
    dtype: DataType
    nullable: bool = True


@dataclasses.dataclass(frozen=True)
class Schema:
    fields: Tuple[Field, ...]

    def __init__(self, fields):
        object.__setattr__(self, "fields", tuple(fields))

    def __len__(self) -> int:
        return len(self.fields)

    def __iter__(self):
        return iter(self.fields)

    def index_of(self, name: str) -> int:
        for i, f in enumerate(self.fields):
            if f.name == name:
                return i
        raise KeyError(f"column {name!r} not in schema {self.names}")

    def field(self, name: str) -> Field:
        return self.fields[self.index_of(name)]

    @property
    def names(self):
        return [f.name for f in self.fields]

    def __repr__(self) -> str:
        inner = ", ".join(f"{f.name}: {f.dtype!r}" for f in self.fields)
        return f"Schema({inner})"


_INT_RANK = {"INT8": 1, "INT16": 2, "INT32": 3, "INT64": 4}


def common_type(a: DataType, b: DataType) -> DataType:
    """Least common type for comparison operands (Spark TypeCoercion subset:
    integer widening, integer/decimal promotion, widest-fit decimals)."""
    if a == b:
        return a
    if a.type_id == "NULL":
        return b
    if b.type_id == "NULL":
        return a
    if a.is_integer and b.is_integer:
        return a if _INT_RANK[a.type_id] >= _INT_RANK[b.type_id] else b
    if a.is_floating and b.is_floating:
        return FLOAT64 if "DOUBLE" in (a.type_id, b.type_id) else FLOAT32
    if a.is_floating and (b.is_integer or b.is_decimal):
        return a if a.type_id == "DOUBLE" or b.is_integer else FLOAT64
    if b.is_floating and (a.is_integer or a.is_decimal):
        return b if b.type_id == "DOUBLE" or a.is_integer else FLOAT64
    if a.is_decimal and b.is_integer:
        return common_type(a, decimal_for_int(b))
    if b.is_decimal and a.is_integer:
        return common_type(decimal_for_int(a), b)
    if a.is_decimal and b.is_decimal:
        s = max(a.scale, b.scale)
        ints = max(a.precision - a.scale, b.precision - b.scale)
        return decimal(min(ints + s, MAX_DECIMAL_PRECISION), s)
    if a.is_string and b.is_string:
        return string(max(a.max_len, b.max_len))
    if a.type_id == "DATE" and b.type_id == "DATE":
        return a
    raise TypeError(f"no common type for {a!r} and {b!r}")


def decimal_for_int(t: DataType) -> DataType:
    """The decimal an integer type widens to (Spark DecimalType.forType)."""
    return {
        "INT8": decimal(3, 0),
        "INT16": decimal(5, 0),
        "INT32": decimal(10, 0),
        "INT64": decimal(20, 0),
    }[t.type_id]

"""Expression IR and Spark type inference (port of
``datafusion_comet_tpu/ir/expr.py``: every expression class it has, with
``if_`` and ``coalesce`` built on ``CaseWhen``): casts with their session
time zone, every ``TemporalFunc`` and ``StringFunc`` (the bytes and JSON
family too), ``SplitPart``, ``SubstringIndex``, ``Soundex``,
``FormatNumber``, ``HashFunc``, the regex nodes (``RLike``,
``RegexpExtract``, ``RegexpExtractAll``, ``RegexpReplace``), host Python
UDFs (``PythonUdf``), the nondeterministic ``RandExpr``,
``MonotonicallyIncreasingId`` and ``SparkPartitionId``, a session's scalar
subqueries (``ScalarSubquery``), the bloom-filter probe
(``BloomMightContain``), the window specs ``WindowFrame`` and
``WindowExpr``, the nested-type nodes (``ArrayExpr``, ``MapExpr``,
``StructExpr``, ``GetStructField``, ``HigherOrderFunc`` with its
``LambdaVar``, ``Split``) and an aggregate's FILTER clause
(``AggExpr.filter``).

Expressions are built unbound (column names); ``bind(expr, schema)`` resolves
references to column indices and computes result types, including Spark's
decimal precision/scale rules (DecimalPrecision + adjustPrecisionScale with
precision loss allowed). Evaluation lives in exec/evaluator.py.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional, Tuple

from datafusion_comet_tpu_torch import types as T

__all__ = [
    "Expr", "EvalMode", "ColumnRef", "BoundRef", "Literal", "Alias", "BinaryOp", "UnaryOp",
    "Cast", "CaseWhen", "InList", "Like", "StringFunc", "TemporalFunc", "MathFunc", "DATE_FIELDS",
    "HashFunc", "SplitPart", "SubstringIndex", "Soundex", "FormatNumber", "RandExpr",
    "MonotonicallyIncreasingId", "SparkPartitionId", "BloomMightContain", "ScalarSubquery",
    "RLike", "RegexpExtract", "RegexpExtractAll", "RegexpReplace", "PythonUdf",
    "LambdaVar", "HigherOrderFunc", "Split", "ArrayExpr", "StructExpr", "GetStructField",
    "MapExpr", "SortOrder", "AggFunc", "AggExpr", "WindowFrame",
    "WindowExpr", "col", "lit", "if_", "coalesce", "bind",
]

# the TemporalFunc fields of a date, each INT32
DATE_FIELDS = ("year", "month", "day", "quarter", "dayofweek", "dayofyear", "weekofyear")

# each TemporalFunc's result type (JAX ``ir/expr.py:_bind``)
TEMPORAL_TYPES = {
    **{f: T.INT32 for f in DATE_FIELDS + ("hour", "minute", "second", "unix_date", "weekday",
                                          "datediff")},
    "unix_seconds": T.INT64, "timestampadd": T.TIMESTAMP, "timestampdiff": T.INT64,
    "convert_timezone": T.TIMESTAMP_NTZ, "date_add": T.DATE, "date_sub": T.DATE,
    "last_day": T.DATE, "trunc_date": T.DATE, "from_utc_timestamp": T.TIMESTAMP_NTZ,
    "to_utc_timestamp": T.TIMESTAMP, "date_trunc": T.TIMESTAMP, "unix_timestamp": T.INT64,
    "unix_micros": T.INT64, "unix_millis": T.INT64, "timestamp_seconds": T.TIMESTAMP,
    "timestamp_millis": T.TIMESTAMP, "timestamp_micros": T.TIMESTAMP, "add_months": T.DATE,
    "next_day": T.DATE, "make_date": T.DATE, "months_between": T.FLOAT64,
    "from_unixtime": T.string(19),
}

class EvalMode:
    """Spark evaluation modes."""

    LEGACY = "LEGACY"
    ANSI = "ANSI"
    TRY = "TRY"


@dataclasses.dataclass(frozen=True)
class Expr:
    """Base expression node; ``dtype`` is None until bound."""

    def children(self) -> Tuple["Expr", ...]:
        return ()

    dtype: Optional[T.DataType] = dataclasses.field(default=None, init=False)

    def alias(self, name: str) -> "Alias":
        return Alias(self, name)

    def cast(self, to: T.DataType, mode: str = EvalMode.LEGACY) -> "Cast":
        return Cast(self, to, mode)

    def is_null(self) -> "UnaryOp":
        return UnaryOp("isnull", self)

    def is_not_null(self) -> "UnaryOp":
        return UnaryOp("isnotnull", self)

    def __add__(self, o):
        return BinaryOp("add", self, _e(o))

    def __radd__(self, o):
        return BinaryOp("add", _e(o), self)

    def __sub__(self, o):
        return BinaryOp("sub", self, _e(o))

    def __rsub__(self, o):
        return BinaryOp("sub", _e(o), self)

    def __mul__(self, o):
        return BinaryOp("mul", self, _e(o))

    def __rmul__(self, o):
        return BinaryOp("mul", _e(o), self)

    def __truediv__(self, o):
        return BinaryOp("div", self, _e(o))

    def __eq__(self, o):  # type: ignore[override]
        return BinaryOp("eq", self, _e(o))

    def __ne__(self, o):  # type: ignore[override]
        return BinaryOp("ne", self, _e(o))

    def __lt__(self, o):
        return BinaryOp("lt", self, _e(o))

    def __le__(self, o):
        return BinaryOp("le", self, _e(o))

    def __gt__(self, o):
        return BinaryOp("gt", self, _e(o))

    def __ge__(self, o):
        return BinaryOp("ge", self, _e(o))

    def __and__(self, o):
        return BinaryOp("and", self, _e(o))

    def __or__(self, o):
        return BinaryOp("or", self, _e(o))

    def __invert__(self):
        return UnaryOp("not", self)

    def __hash__(self):
        return object.__hash__(self)

    def between(self, lo, hi) -> "Expr":
        return (self >= _e(lo)) & (self <= _e(hi))

    def isin(self, *values) -> "InList":
        return InList(self, tuple(_e(v) for v in values))

    def like(self, pattern: str) -> "Like":
        return Like(self, pattern)

    @property
    def name(self) -> str:
        if isinstance(self, Alias):
            return self.out_name
        if isinstance(self, (ColumnRef, BoundRef)):
            return self.col_name
        return type(self).__name__.lower()


def _e(v: Any) -> Expr:
    return v if isinstance(v, Expr) else lit(v)


def _node(cls):
    """Frozen dataclass node with identity equality (``==`` builds exprs)."""
    return dataclasses.dataclass(frozen=True, eq=False, repr=True)(cls)


@_node
class ColumnRef(Expr):
    col_name: str


@_node
class BoundRef(Expr):
    index: int
    col_name: str
    ref_dtype: T.DataType

    def __post_init__(self):
        object.__setattr__(self, "dtype", self.ref_dtype)


@_node
class Literal(Expr):
    value: Any
    lit_dtype: T.DataType

    def __post_init__(self):
        object.__setattr__(self, "dtype", self.lit_dtype)


@_node
class Alias(Expr):
    child: Expr
    out_name: str

    def children(self):
        return (self.child,)


@_node
class BinaryOp(Expr):
    """Arithmetic add/sub/mul/div/mod/pmod; comparison
    eq/ne/lt/le/gt/ge/eqns; Kleene logic and/or."""

    op: str
    left: Expr
    right: Expr
    eval_mode: str = EvalMode.LEGACY

    def children(self):
        return (self.left, self.right)


@_node
class UnaryOp(Expr):
    """not, isnull, isnotnull and isnan, each BOOL; negate and abs, of
    their input's type."""

    op: str
    child: Expr
    eval_mode: str = EvalMode.LEGACY

    def children(self):
        return (self.child,)


@_node
class Cast(Expr):
    """``timezone``: the session zone of a timestamp's cast to or from a
    string or a date (Spark's Cast.timeZoneId); None renders and parses
    in UTC."""

    child: Expr
    to: T.DataType
    eval_mode: str = EvalMode.LEGACY
    timezone: Optional[str] = None

    def children(self):
        return (self.child,)


@_node
class CaseWhen(Expr):
    """CASE WHEN c1 THEN v1 ... [ELSE e] END; the first true branch wins."""

    branches: Tuple[Tuple[Expr, Expr], ...]  # (condition, value)
    else_value: Optional[Expr]

    def children(self):
        out = []
        for c, v in self.branches:
            out += [c, v]
        if self.else_value is not None:
            out.append(self.else_value)
        return tuple(out)


@_node
class InList(Expr):
    """child IN (v1, ...): an OR of equalities, with SQL null logic."""

    child: Expr
    values: Tuple[Expr, ...]
    negated: bool = False

    def children(self):
        return (self.child,) + self.values


@_node
class Like(Expr):
    """SQL LIKE with a literal pattern: '%' matches any run of bytes, '_'
    one byte (the JAX package's semantics; Spark's '_' is one character,
    ROADMAP C10)."""

    child: Expr
    pattern: str
    negated: bool = False

    def children(self):
        return (self.child,)


@_node
class StringFunc(Expr):
    """A string function by name over ``args`` (JAX ``ir/expr.py:312``),
    typed by ``_string_func_type``."""

    func: str
    args: Tuple[Expr, ...]

    def children(self):
        return self.args


@_node
class TemporalFunc(Expr):
    """A date/time function by name over ``args`` (``TEMPORAL_TYPES``);
    ``tz`` names the session time zone, applied to a timestamp before its
    fields are read, ``unit`` the calendar unit of timestampadd and
    timestampdiff (convert_timezone carries its source zone in ``tz`` and
    its target in ``unit``), as in the JAX package."""

    func: str
    args: Tuple[Expr, ...]
    tz: Optional[str] = None
    unit: Optional[str] = None

    def children(self):
        return self.args


@_node
class MathFunc(Expr):
    """A math function by name over ``args`` (JAX ``ir/expr.py:345``):
    round, bround, floor, ceil, the float functions (sqrt, exp, ln, ...),
    log, pow, atan2, hypot, sign, greatest, least, nanvl, width_bucket,
    factorial and the bit functions."""

    func: str
    args: Tuple[Expr, ...]
    eval_mode: str = EvalMode.LEGACY

    def children(self):
        return self.args


@_node
class HashFunc(Expr):
    """Spark's murmur3 hash (``hash``, INT32) or ``xxhash64`` (INT64) of
    its arguments, each hashed into the running seed."""

    func: str
    args: Tuple[Expr, ...]
    seed: int = 42

    def children(self):
        return self.args


@_node
class SplitPart(Expr):
    """split_part(str, literal delim, part): 1-based, a negative part
    counts from the end, part 0 an error, a part out of range ''."""

    child: Expr
    delim: str
    part: int = 1
    max_parts: int = 0

    def children(self):
        return (self.child,)


@_node
class FormatNumber(Expr):
    """format_number(v, d): HALF_EVEN to d decimals, the integer part
    comma-grouped (exec/format_number.py), at most ``out_len`` bytes."""

    child: Expr
    decimals: int = 0
    out_len: int = 32

    def children(self):
        return (self.child,)


@_node
class Soundex(Expr):
    """American Soundex of an ASCII string; a row whose first byte is not
    a letter passes through unchanged."""

    child: Expr

    def children(self):
        return (self.child,)


@_node
class SubstringIndex(Expr):
    """substring_index(str, literal delim, n): before the n-th occurrence
    from the left (n > 0), after the |n|-th from the right (n < 0, a
    one-byte delimiter), '' for n = 0."""

    child: Expr
    delim: str
    count: int = 1
    max_parts: int = 0

    def children(self):
        return (self.child,)


@_node
class RLike(Expr):
    """Regex match (Spark RLIKE) against a literal pattern, compiled to a
    DFA on the host and run over the bytes on the device
    (exec/regex_dfa.py)."""

    child: Expr
    pattern: str
    negated: bool = False

    def children(self):
        return (self.child,)


@_node
class RegexpExtract(Expr):
    """regexp_extract for a linear, backtracking-free pattern
    (exec/regex_extract.py); ir/functions.py builds it only where the
    pattern linearizes, else the host bridge."""

    child: Expr
    pattern: str
    group_idx: int = 1
    out_len: int = 0  # 0: the child's width

    def children(self):
        return (self.child,)


@_node
class RegexpExtractAll(Expr):
    """regexp_extract_all for a linear pattern that cannot match empty:
    every non-overlapping match's group as a LIST<STRING>."""

    child: Expr
    pattern: str
    group_idx: int = 1
    max_parts: int = 0  # 0: DEFAULT_LIST_ELEMS
    out_len: int = 0  # an element's width; 0: the child's

    def children(self):
        return (self.child,)


@_node
class RegexpReplace(Expr):
    """regexp_replace of a linear pattern that cannot match empty by a
    literal replacement (no $n group references)."""

    child: Expr
    pattern: str
    replacement: str
    out_len: int = 0  # 0: the child's width times the growth bound

    def children(self):
        return (self.child,)


@_node
class PythonUdf(Expr):
    """A scalar Python UDF evaluated on the host (exec/host_udf.py):
    ``fn(row values...)`` with None for a null, a None result a null.
    ``batch_fn(mask, *columns)``, where set, takes the whole batch instead:
    Python value lists (``batch_mode="py"``) or host numpy columns
    (``"raw"``), and returns a list of values or a ColumnVector."""

    fn: object
    args: Tuple[Expr, ...]
    out_dtype: T.DataType
    udf_name: str = "python_udf"
    batch_fn: object = None
    batch_mode: str = "py"

    def children(self):
        return self.args


@_node
class Split(Expr):
    """split(str, literal delim) with Spark's default limit -1 (trailing
    empty fields kept): a LIST of strings of at most ``max_parts`` fields
    (0: ``T.DEFAULT_LIST_ELEMS``); more fields raise a QueryExecutionError
    naming the cap."""

    child: Expr
    delim: str
    max_parts: int = 0

    def children(self):
        return (self.child,)


@_node
class LambdaVar(Expr):
    """A lambda variable in a higher-order function's body; binding gives
    it the type of what the function binds it to."""

    var_name: str


@_node
class HigherOrderFunc(Expr):
    """transform, filter, exists, forall, aggregate, zip_with and
    array_sort (its default comparator, no body) over arrays, and
    transform_keys, transform_values and map_filter over maps. ``args``: the
    inputs (and ``aggregate``'s initial value); ``params``: the lambda's
    variables in ``body``."""

    func: str
    args: Tuple[Expr, ...]
    params: Tuple[str, ...] = ()
    body: Optional[Expr] = None

    def children(self):
        return self.args + ((self.body,) if self.body is not None else ())


@_node
class ArrayExpr(Expr):
    """Array functions over LIST columns: array, size, array_contains,
    array_position, element_at, get_array_item (0-based), array_min,
    array_max, sort_array, array_distinct, array_remove, array_append,
    array_prepend, array_repeat, arrays_overlap, slice, array_join,
    array_union, array_intersect, array_except, array_compact,
    array_reverse, flatten, array_insert, arrays_zip and
    get_array_struct_field."""

    func: str
    args: Tuple[Expr, ...]

    def children(self):
        return self.args


@_node
class StructExpr(Expr):
    """struct / named_struct."""

    args: Tuple[Expr, ...]
    names: Tuple[str, ...]

    def children(self):
        return self.args


@_node
class GetStructField(Expr):
    """One field of a STRUCT, by name or ordinal (an ordinal once bound)."""

    child: Expr
    field: object

    def children(self):
        return (self.child,)


@_node
class MapExpr(Expr):
    """Map functions: map (k1, v1, k2, v2, ...), map_from_arrays,
    map_from_entries, map_concat, map_keys, map_values, map_entries,
    element_at, map_contains_key and size. Keys are de-duplicated keeping
    the last (Spark's LAST_WIN policy)."""

    func: str
    args: Tuple[Expr, ...]

    def children(self):
        return self.args


@_node
class RandExpr(Expr):
    """rand() or randn() (``func``) with a seed: Spark's XORShiftRandom,
    seeded per partition, one draw per live row (exec/random_xorshift.py)."""

    func: str
    seed: int


@_node
class MonotonicallyIncreasingId(Expr):
    pass


@_node
class SparkPartitionId(Expr):
    pass


@_node
class BloomMightContain(Expr):
    """Whether ``child`` may be in a Spark bloom filter (Spark's
    BloomFilterMightContain): ``filter`` is a literal of the serialized
    filter's bytes or a ``ScalarSubquery`` of a BLOOM_FILTER aggregate,
    known on the host before the plan runs; the probe is k gathers a row
    (exec/operators/agg_special.py). A null filter gives null."""

    filter: Expr
    child: Expr

    def children(self):
        return (self.filter, self.child)


@_node
class ScalarSubquery(Expr):
    """The one value of a session's uncorrelated scalar subquery
    (``Session.scalar_subquery``), which the session runs before the plan
    that holds it: null where the subquery gave no row or a null. A leaf,
    like a literal, of the subquery column's type."""

    subquery_id: int
    sub_dtype: T.DataType

    def __post_init__(self):
        object.__setattr__(self, "dtype", self.sub_dtype)


@dataclasses.dataclass(frozen=True)
class SortOrder:
    child: Expr
    ascending: bool = True
    nulls_first: Optional[bool] = None  # default: Spark = nulls first iff ascending

    def resolved_nulls_first(self) -> bool:
        return self.ascending if self.nulls_first is None else self.nulls_first


class AggFunc:
    SUM = "sum"
    COUNT = "count"
    AVG = "avg"
    MIN = "min"
    MAX = "max"
    VAR_SAMP = "var_samp"
    VAR_POP = "var_pop"
    STDDEV_SAMP = "stddev_samp"
    STDDEV_POP = "stddev_pop"
    FIRST = "first"
    LAST = "last"
    COVAR_SAMP = "covar_samp"
    COVAR_POP = "covar_pop"
    CORR = "corr"
    BIT_AND = "bit_and"
    BIT_OR = "bit_or"
    BIT_XOR = "bit_xor"
    BOOL_AND = "bool_and"
    BOOL_OR = "bool_or"
    BLOOM_FILTER = "bloom_filter"  # Spark's BloomFilterAggregate
    # exact; extra[0] the percentage literal
    PERCENTILE = "percentile"
    MEDIAN = "median"
    # extra = (percentage literal, optional accuracy literal): an element of
    # the input at rank ceil(p x n), within the sketch's rank error
    APPROX_PERCENTILE = "approx_percentile"
    APPROX_COUNT_DISTINCT = "approx_count_distinct"  # HyperLogLog
    # a LIST of each group's values (the set: distinct, in value order) of
    # at most ``AggExpr.max_elems`` items
    COLLECT_LIST = "collect_list"
    COLLECT_SET = "collect_set"
    # a plan-level rewrite (ir/plan.py::_rewrite_distinct), never evaluated
    COUNT_DISTINCT = "count_distinct"


# the special aggregates (exec/operators/agg_special.py); all but
# APPROX_PERCENTILE and the collects run in SINGLE mode only
SPECIAL_FUNCS = (AggFunc.PERCENTILE, AggFunc.MEDIAN, AggFunc.APPROX_PERCENTILE,
                 AggFunc.APPROX_COUNT_DISTINCT, AggFunc.BLOOM_FILTER, AggFunc.COLLECT_LIST,
                 AggFunc.COLLECT_SET)
COLLECT_FUNCS = (AggFunc.COLLECT_LIST, AggFunc.COLLECT_SET)
# the variance family: (n, avg, m2) states, a DOUBLE result
WELFORD_FUNCS = (AggFunc.VAR_SAMP, AggFunc.VAR_POP, AggFunc.STDDEV_SAMP, AggFunc.STDDEV_POP)
# the covariance family: (n, xavg, yavg, ck, xm2, ym2) states, a DOUBLE result
COVAR_FUNCS = (AggFunc.COVAR_SAMP, AggFunc.COVAR_POP, AggFunc.CORR)
BIT_FUNCS = (AggFunc.BIT_AND, AggFunc.BIT_OR, AggFunc.BIT_XOR)
BOOL_FUNCS = (AggFunc.BOOL_AND, AggFunc.BOOL_OR)


@dataclasses.dataclass(frozen=True)
class AggExpr:
    """One aggregate: function + input (None for COUNT(*)). ``ignore_nulls``:
    FIRST and LAST skip null inputs; ``extra``: the second input of the
    covariance family, a BLOOM_FILTER's expected item count (a literal,
    1,000,000 when absent), which gives its number of hash functions, a
    PERCENTILE's percentage, or an APPROX_PERCENTILE's percentage and
    accuracy (literals);
    ``num_bits``: a BLOOM_FILTER's size in bits (Spark's numBits, a
    multiple of 64); ``max_elems``: a collect's list capacity (values past
    it in a group are dropped, as in the JAX package: ROADMAP C31);
    ``filter``: the FILTER (WHERE ...) clause, a predicate over the input
    rows: only the rows where it is true are aggregated (merges never read
    it)."""

    func: str
    child: Optional[Expr]
    out_name: str
    ignore_nulls: bool = True
    extra: Tuple[Expr, ...] = ()
    num_bits: int = 4096
    max_elems: int = 16
    filter: Optional[Expr] = None

    def result_dtype(self) -> T.DataType:
        cd = self.child.dtype if self.child is not None else None
        if self.func in (AggFunc.COUNT, AggFunc.COUNT_DISTINCT):
            return T.INT64
        if self.func == AggFunc.SUM:
            if cd.is_decimal:
                return T.decimal(min(cd.precision + 10, T.MAX_DECIMAL_PRECISION), cd.scale)
            return T.INT64 if cd.is_integer else T.FLOAT64
        if self.func == AggFunc.AVG:
            if cd.is_decimal:
                # Spark: avg = decimal(p+4, s+4) bounded
                return T.decimal(min(cd.precision + 4, T.MAX_DECIMAL_PRECISION),
                                 min(cd.scale + 4, T.MAX_DECIMAL_PRECISION))
            return T.FLOAT64
        if self.func in (AggFunc.MIN, AggFunc.MAX, AggFunc.FIRST, AggFunc.LAST) + BIT_FUNCS:
            return cd
        if self.func in BOOL_FUNCS:
            return T.BOOL
        if self.func == AggFunc.BLOOM_FILTER:
            # Spark's BloomFilterImpl.writeTo: three big-endian ints, then the longs
            return T.binary(12 + (self.num_bits // 64) * 8)
        if self.func in COLLECT_FUNCS:
            return T.list_(cd, self.max_elems)
        if self.func == AggFunc.PERCENTILE and self.extra and isinstance(
                self.extra[0], Literal) and isinstance(self.extra[0].value, (list, tuple)):
            return T.list_(T.FLOAT64, len(self.extra[0].value))
        if self.func in WELFORD_FUNCS + COVAR_FUNCS + (AggFunc.PERCENTILE, AggFunc.MEDIAN):
            return T.FLOAT64
        if self.func == AggFunc.APPROX_COUNT_DISTINCT:
            return T.INT64
        if self.func == AggFunc.APPROX_PERCENTILE:  # an element of the input
            return cd
        raise NotImplementedError(f"aggregate {self.func}")


@dataclasses.dataclass(frozen=True)
class WindowFrame:
    """A ROWS or RANGE frame: ``lower`` None is UNBOUNDED PRECEDING,
    ``upper`` 0 CURRENT ROW and None UNBOUNDED FOLLOWING; other bounds are
    row offsets (ROWS) or value offsets of the one order key (RANGE),
    negative preceding."""

    frame_type: str = "rows"  # rows | range
    lower: Optional[int] = None
    upper: Optional[int] = 0


@dataclasses.dataclass(frozen=True)
class WindowExpr:
    """One window function (JAX ``ir/expr.py:793``): ranking (row_number,
    rank, dense_rank, percent_rank, cume_dist, ntile with its bucket count
    in ``offset``), lag and lead (``offset`` rows, a literal ``default``),
    nth_value, or an aggregate (count, sum, avg, min, max, first, last) over
    ``frame``, within ``partition_by`` in ``order_by`` order."""

    func: str
    child: Optional[Expr]
    out_name: str
    partition_by: Tuple[Expr, ...] = ()
    order_by: Tuple[SortOrder, ...] = ()
    frame: WindowFrame = WindowFrame()
    offset: int = 1
    default: Optional[Expr] = None


def col(name: str) -> ColumnRef:
    return ColumnRef(name)


def if_(cond: Expr, then: Any, otherwise: Any = None) -> CaseWhen:
    """Spark's If: a CaseWhen with one branch (no else: null)."""
    return CaseWhen(((cond, _e(then)),), _e(otherwise) if otherwise is not None else None)


def coalesce(*args: Any) -> CaseWhen:
    """COALESCE(a, b, ...): the first argument that is not null."""
    exprs = [_e(a) for a in args]
    branches = tuple((UnaryOp("isnotnull", a), a) for a in exprs[:-1])
    return CaseWhen(branches, exprs[-1])


def lit(value: Any, dtype: Optional[T.DataType] = None) -> Literal:
    if dtype is None:
        dtype = _infer_literal_type(value)
    if dtype.is_decimal and isinstance(value, float):
        value = round(value * 10**dtype.scale)
    elif dtype.is_decimal and isinstance(value, int) and dtype.scale:
        value = value * 10**dtype.scale
    return Literal(value, dtype)


def _infer_literal_type(v: Any) -> T.DataType:
    if v is None:
        return T.NULLTYPE
    if isinstance(v, bool):
        return T.BOOL
    if isinstance(v, int):
        return T.INT32 if -(2**31) <= v < 2**31 else T.INT64
    if isinstance(v, float):
        return T.FLOAT64
    if isinstance(v, str):
        return T.string(max(len(v.encode()), 1))
    if isinstance(v, bytes):
        return T.binary(max(len(v), 1))
    raise TypeError(f"cannot infer literal type for {v!r}")


_CMP_OPS = {"eq", "ne", "lt", "le", "gt", "ge", "eqns"}
_LOGIC_OPS = {"and", "or"}
_ARITH_OPS = {"add", "sub", "mul", "div", "mod", "pmod"}
_UNARY_OPS = ("not", "isnull", "isnotnull", "isnan")
_SIGNED_OPS = ("negate", "abs")  # UnaryOps of their input's type


def _decimal_arith_type(op: str, a: T.DataType, b: T.DataType) -> T.DataType:
    """Spark DecimalPrecision rules + adjustPrecisionScale."""
    p1, s1, p2, s2 = a.precision, a.scale, b.precision, b.scale
    if op in ("add", "sub"):
        s = max(s1, s2)
        p = max(p1 - s1, p2 - s2) + s + 1
    elif op == "mul":
        p, s = p1 + p2 + 1, s1 + s2
    elif op == "div":
        s = max(6, s1 + p2 + 1)
        p = p1 - s1 + s2 + s
    elif op in ("mod", "pmod"):
        s = max(s1, s2)
        p = min(p1 - s1, p2 - s2) + s
    else:
        raise ValueError(op)
    return _adjust_precision_scale(p, s)


def _adjust_precision_scale(p: int, s: int) -> T.DataType:
    if p <= T.MAX_DECIMAL_PRECISION:
        return T.decimal(p, s)
    int_digits = p - s
    min_scale = min(s, 6)
    adjusted = max(T.MAX_DECIMAL_PRECISION - int_digits, min_scale)
    return T.decimal(T.MAX_DECIMAL_PRECISION, adjusted)


def _to_decimal_if_int(t: T.DataType) -> T.DataType:
    return T.decimal_for_int(t) if t.is_integer else t


def bind(expr: Expr, schema: T.Schema) -> Expr:
    """Resolve column refs against ``schema`` and compute result dtypes.
    Returns a new tree of bound nodes; the original is untouched."""
    e = expr
    if isinstance(e, (BoundRef, Literal, ScalarSubquery)):
        return e
    if isinstance(e, ColumnRef):
        i = schema.index_of(e.col_name)
        return BoundRef(i, e.col_name, schema.fields[i].dtype)
    if isinstance(e, Alias):
        c = bind(e.child, schema)
        out = Alias(c, e.out_name)
        object.__setattr__(out, "dtype", c.dtype)
        return out
    if isinstance(e, BinaryOp):
        l, r = bind(e.left, schema), bind(e.right, schema)
        out = BinaryOp(e.op, l, r, e.eval_mode)
        object.__setattr__(out, "dtype", _binary_result_type(e.op, l, r))
        return out
    if isinstance(e, UnaryOp):
        if e.op not in _UNARY_OPS + _SIGNED_OPS:
            raise NotImplementedError(f"UnaryOp {e.op!r} is not ported yet")
        c = bind(e.child, schema)
        out = UnaryOp(e.op, c, e.eval_mode)
        object.__setattr__(out, "dtype", c.dtype if e.op in _SIGNED_OPS else T.BOOL)
        return out
    if isinstance(e, Cast):
        c = bind(e.child, schema)
        out = Cast(c, e.to, e.eval_mode, e.timezone)
        object.__setattr__(out, "dtype", e.to)
        return out
    if isinstance(e, CaseWhen):
        branches = tuple((bind(c, schema), bind(v, schema)) for c, v in e.branches)
        else_v = bind(e.else_value, schema) if e.else_value is not None else None
        dt = branches[0][1].dtype
        for _, v in branches[1:]:
            dt = T.common_type(dt, v.dtype)
        if else_v is not None:
            dt = T.common_type(dt, else_v.dtype)
        out = CaseWhen(branches, else_v)
        object.__setattr__(out, "dtype", dt)
        return out
    if isinstance(e, InList):
        out = InList(bind(e.child, schema), tuple(bind(v, schema) for v in e.values), e.negated)
        object.__setattr__(out, "dtype", T.BOOL)
        return out
    if isinstance(e, Like):
        out = Like(bind(e.child, schema), e.pattern, e.negated)
        object.__setattr__(out, "dtype", T.BOOL)
        return out
    if isinstance(e, StringFunc):
        args = tuple(bind(a, schema) for a in e.args)
        out = StringFunc(e.func, args)
        object.__setattr__(out, "dtype", _string_func_type(e.func, args))
        return out
    if isinstance(e, TemporalFunc):
        out = TemporalFunc(e.func, tuple(bind(a, schema) for a in e.args), e.tz, e.unit)
        object.__setattr__(out, "dtype", TEMPORAL_TYPES[e.func])
        return out
    if isinstance(e, HashFunc):
        out = HashFunc(e.func, tuple(bind(a, schema) for a in e.args), e.seed)
        object.__setattr__(out, "dtype", T.INT32 if e.func == "murmur3" else T.INT64)
        return out
    if isinstance(e, (SplitPart, SubstringIndex, Soundex, FormatNumber)):
        c = bind(e.child, schema)
        width = c.dtype.byte_width if c.dtype.is_binary else T.DEFAULT_STRING_LEN
        if isinstance(e, Soundex):
            out, width = Soundex(c), max(width, 4)
        elif isinstance(e, FormatNumber):
            out, width = FormatNumber(c, e.decimals, e.out_len), e.out_len or 32
        else:
            out = type(e)(c, e.delim, e.part if isinstance(e, SplitPart) else e.count,
                          e.max_parts)
        object.__setattr__(out, "dtype", T.string(width))
        return out
    if isinstance(e, (RandExpr, MonotonicallyIncreasingId, SparkPartitionId)):
        out = dataclasses.replace(e)
        object.__setattr__(out, "dtype", {RandExpr: T.FLOAT64, SparkPartitionId: T.INT32}
                           .get(type(e), T.INT64))
        return out
    if isinstance(e, MathFunc):
        args = tuple(bind(a, schema) for a in e.args)
        out = MathFunc(e.func, args, e.eval_mode)
        object.__setattr__(out, "dtype", _math_result_type(e.func, args))
        return out
    if isinstance(e, BloomMightContain):
        out = BloomMightContain(bind(e.filter, schema), bind(e.child, schema))
        object.__setattr__(out, "dtype", T.BOOL)
        return out
    if isinstance(e, (RLike, RegexpExtract, RegexpExtractAll, RegexpReplace, PythonUdf)):
        return _bind_regex_udf(e, schema)
    return _bind_nested(e, schema)


def _bind_regex_udf(e: Expr, schema: T.Schema) -> Expr:
    """The regex nodes and PythonUdf (JAX ``ir/expr.py:1129-1163``,
    ``:1194``). A bound PythonUdf keeps its ``batch_fn`` (the JAX package's
    binding drops it and runs the row function; the results are the
    same)."""
    if isinstance(e, PythonUdf):
        return _typed(PythonUdf(e.fn, tuple(bind(a, schema) for a in e.args), e.out_dtype,
                                e.udf_name, e.batch_fn, e.batch_mode), e.out_dtype)
    c = bind(e.child, schema)
    if isinstance(e, RLike):
        return _typed(RLike(c, e.pattern, e.negated), T.BOOL)
    width = c.dtype.byte_width if c.dtype.is_binary else T.DEFAULT_STRING_LEN
    if isinstance(e, RegexpExtract):
        return _typed(RegexpExtract(c, e.pattern, e.group_idx, e.out_len),
                      T.string(e.out_len or width))
    if isinstance(e, RegexpExtractAll):
        return _typed(RegexpExtractAll(c, e.pattern, e.group_idx, e.max_parts, e.out_len),
                      T.list_(T.string(e.out_len or width),
                              e.max_parts or T.DEFAULT_LIST_ELEMS))
    out_w = e.out_len
    if not out_w:
        # every shortest match may grow to the replacement's length
        from datafusion_comet_tpu_torch.exec.regex_extract import linearize, min_match_len

        lp = linearize(e.pattern, 0)
        R = len(e.replacement.encode("utf-8"))
        mn = min_match_len(lp) if lp is not None else 1
        factor = -(-R // max(mn, 1)) if R > mn else 1
        out_w = min(width * max(factor, 1), 4096)
    return _typed(RegexpReplace(c, e.pattern, e.replacement, e.out_len), T.string(out_w))


# the lambda variables' types while a higher-order function's body binds
_LAMBDA_TYPES: List[Dict[str, T.DataType]] = []


def _bind_body(body: Expr, params, ptypes, schema: T.Schema) -> Expr:
    _LAMBDA_TYPES.append(dict(zip(params, ptypes)))
    try:
        return bind(body, schema)
    finally:
        _LAMBDA_TYPES.pop()


def _typed(out: Expr, dt: T.DataType) -> Expr:
    object.__setattr__(out, "dtype", dt)
    return out


def _bind_nested(e: Expr, schema: T.Schema) -> Expr:
    """The nested-type nodes (JAX ``ir/expr.py:1059-1115``, ``:1169`` and
    ``:1199-1226``)."""
    if isinstance(e, LambdaVar):
        for env in reversed(_LAMBDA_TYPES):
            if e.var_name in env:
                return _typed(LambdaVar(e.var_name), env[e.var_name])
        raise KeyError(f"lambda variable {e.var_name!r} not in scope")
    if isinstance(e, HigherOrderFunc):
        args = tuple(bind(a, schema) for a in e.args)
        arr, f = args[0], e.func
        if f in ("transform_keys", "transform_values", "map_filter"):
            assert arr.dtype.is_map, f"{f} needs a map input"
            kt, vt = arr.dtype.key_type, arr.dtype.value_type
            body = _bind_body(e.body, e.params, (kt, vt), schema)
            dt = {"transform_keys": T.map_(body.dtype, vt, arr.dtype.max_elems),
                  "transform_values": T.map_(kt, body.dtype, arr.dtype.max_elems),
                  "map_filter": arr.dtype}[f]
            return _typed(HigherOrderFunc(f, args, e.params, body), dt)
        assert arr.dtype.is_list, f"{f} needs an array input"
        elem_t = arr.dtype.element
        if f == "zip_with":
            ptypes = (elem_t, args[1].dtype.element)
        elif f == "aggregate":
            ptypes = (args[1].dtype, elem_t)  # (acc, x); the initial value is args[1]
        elif f == "array_sort":
            ptypes = ()
        else:  # transform, filter, exists, forall: (x) or (x, index)
            ptypes = (elem_t, T.INT32)[: max(len(e.params), 1)]
        body = None if e.body is None else _bind_body(e.body, e.params, ptypes, schema)
        ne = max(arr.dtype.max_elems, args[1].dtype.max_elems if f == "zip_with" else 0)
        dt = {"transform": T.list_(body.dtype, ne) if body is not None else arr.dtype,
              "filter": arr.dtype, "exists": T.BOOL, "forall": T.BOOL,
              "aggregate": body.dtype if body is not None else elem_t,
              "zip_with": T.list_(body.dtype, ne) if body is not None else arr.dtype,
              "array_sort": arr.dtype}[f]
        return _typed(HigherOrderFunc(f, args, e.params, body), dt)
    if isinstance(e, Split):
        c = bind(e.child, schema)
        width = c.dtype.byte_width if c.dtype.is_binary else T.DEFAULT_STRING_LEN
        return _typed(Split(c, e.delim, e.max_parts),
                      T.list_(T.string(width), e.max_parts or T.DEFAULT_LIST_ELEMS))
    if isinstance(e, ArrayExpr):
        args = tuple(bind(a, schema) for a in e.args)
        return _typed(ArrayExpr(e.func, args), _array_func_type(e.func, args))
    if isinstance(e, StructExpr):
        args = tuple(bind(a, schema) for a in e.args)
        names = e.names or tuple(f"col{i + 1}" for i in range(len(args)))
        return _typed(StructExpr(args, names),
                      T.struct(*[(n, a.dtype) for n, a in zip(names, args)]))
    if isinstance(e, GetStructField):
        c = bind(e.child, schema)
        st = c.dtype
        assert st is not None and st.is_struct, f"get_struct_field on {st!r}"
        idx = (next(i for i, f in enumerate(st.struct_fields) if f.name == e.field)
               if isinstance(e.field, str) else int(e.field))
        return _typed(GetStructField(c, idx), st.struct_fields[idx].dtype)
    if isinstance(e, MapExpr):
        args = tuple(bind(a, schema) for a in e.args)
        return _typed(MapExpr(e.func, args), _map_func_type(e.func, args))
    raise NotImplementedError(f"bind: {type(e).__name__}")


def _array_func_type(func: str, args: Tuple[Expr, ...]) -> T.DataType:
    """JAX ``ir/expr.py:1260``."""
    a0 = args[0].dtype if args else None
    if func == "array":
        ct = args[0].dtype
        for a in args[1:]:
            ct = T.common_type(ct, a.dtype)
        return T.list_(ct, max(len(args), 1))
    if func == "size":
        return T.INT32
    if func in ("array_contains", "arrays_overlap"):
        return T.BOOL
    if func == "array_position":
        return T.INT64
    if func in ("element_at", "get_array_item", "array_min", "array_max"):
        assert a0 is not None and a0.is_list
        return a0.element
    if func in ("sort_array", "array_distinct", "array_remove", "array_compact",
                "array_reverse", "slice", "array_except"):
        assert a0 is not None and a0.is_list
        return a0
    if func in ("array_append", "array_prepend", "array_insert"):
        return T.list_(a0.element, a0.max_elems + 1)
    if func == "arrays_zip":
        assert all(a.dtype.is_list for a in args)
        return T.list_(T.struct(*[(str(i), a.dtype.element) for i, a in enumerate(args)]),
                       max(a.dtype.max_elems for a in args))
    if func == "get_array_struct_field":
        assert a0 is not None and a0.is_list and a0.element.is_struct
        return T.list_(a0.element.struct_fields[int(args[1].value)].dtype, a0.max_elems)
    if func == "array_repeat":
        n = args[1]
        count = n.value if isinstance(n, Literal) else T.DEFAULT_LIST_ELEMS
        return T.list_(args[0].dtype, max(int(count), 1))
    if func == "array_union":
        b = args[1].dtype
        return T.list_(T.common_type(a0.element, b.element), a0.max_elems + b.max_elems)
    if func == "array_intersect":
        return T.list_(a0.element, min(a0.max_elems, args[1].dtype.max_elems))
    if func == "array_join":
        assert a0 is not None and a0.is_list and a0.element.is_string
        sep_w = args[1].dtype.byte_width if args[1].dtype.is_binary else 4
        return T.string(a0.max_elems * (a0.element.byte_width + sep_w))
    if func == "flatten":
        assert a0 is not None and a0.is_list and a0.element.is_list
        return T.list_(a0.element.element, a0.max_elems * a0.element.max_elems)
    raise NotImplementedError(f"array func {func}")


def _map_func_type(func: str, args: Tuple[Expr, ...]) -> T.DataType:
    """JAX ``ir/expr.py:1318``."""
    a0 = args[0].dtype if args else None
    if func == "map":
        kt, vt = args[0].dtype, args[1].dtype
        for i in range(2, len(args), 2):
            kt = T.common_type(kt, args[i].dtype)
            vt = T.common_type(vt, args[i + 1].dtype)
        return T.map_(kt, vt, max(len(args) // 2, 1))
    if func == "map_from_arrays":
        ka, va = args[0].dtype, args[1].dtype
        assert ka.is_list and va.is_list
        return T.map_(ka.element, va.element, ka.max_elems)
    if func in ("map_keys", "map_values", "map_entries"):
        assert a0 is not None and a0.is_map
        return T.list_({"map_keys": a0.key_type, "map_values": a0.value_type,
                        "map_entries": a0.element}[func], a0.max_elems)
    if func == "map_concat":
        kt, vt, total = a0.key_type, a0.value_type, 0
        for a in args:
            assert a.dtype.is_map
            kt = T.common_type(kt, a.dtype.key_type)
            vt = T.common_type(vt, a.dtype.value_type)
            total += a.dtype.max_elems
        return T.map_(kt, vt, total)
    if func == "map_from_entries":
        assert a0 is not None and a0.is_list and a0.element.is_struct
        fs = a0.element.struct_fields
        return T.map_(fs[0].dtype, fs[1].dtype, a0.max_elems)
    if func == "element_at":
        assert a0 is not None and a0.is_map
        return a0.value_type
    if func == "map_contains_key":
        return T.BOOL
    if func == "size":
        return T.INT32
    raise NotImplementedError(f"map func {func}")


def _string_func_type(func: str, args: Tuple[Expr, ...]) -> T.DataType:
    """JAX ``ir/expr.py:1364-1385``: concat and concat_ws are as wide as
    their string inputs together, lpad, rpad and repeat four times their
    input."""
    a0 = args[0].dtype if args else None
    if func in ("length", "ascii", "instr", "locate", "char_length", "bit_length",
                "octet_length", "levenshtein", "json_array_length"):
        return T.INT32
    if func in ("substring", "upper", "lower", "trim", "ltrim", "rtrim", "reverse", "replace",
                "translate", "initcap", "left", "right", "btrim"):
        return a0
    if func in ("startswith", "endswith", "contains"):
        return T.BOOL
    if func in ("concat", "concat_ws"):
        return T.string(max(sum(a.dtype.byte_width for a in args if a.dtype.is_binary), 1))
    if func in ("lpad", "rpad", "repeat"):
        return T.string(a0.byte_width * 4)
    if func == "chr":
        return T.string(1)
    if func == "space":
        n = args[0]
        cap = int(n.value) if isinstance(n, Literal) and n.value is not None else 64
        return T.string(max(min(cap, 1 << 15), 1))
    return _bytes_func_type(func, args)


def _bytes_func_type(func: str, args: Tuple[Expr, ...]) -> T.DataType:
    """The bytes and JSON family (JAX ``ir/expr.py:1387-1426``)."""
    a0 = args[0].dtype if args else None
    w = a0.byte_width if a0 is not None and a0.is_binary else T.DEFAULT_STRING_LEN
    if func == "hex":
        return T.string(2 * a0.byte_width) if a0 is not None and a0.is_binary else T.string(16)
    if func == "unhex":
        return T.binary(max((w + 1) // 2, 1))
    if func == "base64":
        enc = (w + 2) // 3 * 4
        return T.string(max(enc + 2 * max((enc - 1) // 76, 0), 4))
    if func == "unbase64":
        return T.binary(max(w // 4 * 3 + 3, 3))
    if func in ("encode", "decode", "get_json_object"):
        # get_json_object: a matched span cannot outgrow its document
        assert a0 is not None and (func != "get_json_object" or a0.is_binary)
        return (T.binary if func == "encode" else T.string)(a0.byte_width)
    if func in ("bin", "conv", "md5", "sha1"):
        return T.string({"bin": 64, "conv": 65, "md5": 32, "sha1": 40}[func])
    if func == "sha2":
        bits = args[1]
        b = int(bits.value) if isinstance(bits, Literal) and bits.value is not None else 256
        return T.string({0: 64, 224: 56, 256: 64, 384: 96, 512: 128}.get(b, 64))
    if func == "crc32":
        return T.INT64
    raise NotImplementedError(f"string func {func}")


def _math_result_type(func: str, args: Tuple[Expr, ...]) -> T.DataType:
    """JAX ``ir/expr.py:1020-1056``."""
    a0 = args[0].dtype
    if func in ("round", "bround"):
        if a0.is_decimal:
            # Spark round(decimal(p, s), d): decimal(p - s + d + 1, d), bounded
            d = args[1].value if len(args) > 1 else 0
            return _adjust_precision_scale(a0.precision - a0.scale + max(d, 0) + 1, max(d, 0))
        return a0
    if func in ("floor", "ceil"):
        if a0.is_decimal:
            return _adjust_precision_scale(a0.precision - a0.scale + 1, 0)
        return a0 if a0.is_integer else T.INT64
    if func in ("width_bucket", "factorial"):
        return T.INT64
    if func == "bit_count":
        return T.INT32
    if func == "getbit":
        return T.INT8
    if func == "shiftrightunsigned":
        return a0 if a0.is_integer else T.INT64
    if func in ("greatest", "least"):
        dt = a0
        for a in args[1:]:
            dt = T.common_type(dt, a.dtype)
        return dt
    return T.FLOAT64  # sign and the float functions


def _binary_result_type(op: str, l: Expr, r: Expr) -> T.DataType:
    lt, rt = l.dtype, r.dtype
    if op in _CMP_OPS or op in _LOGIC_OPS:
        return T.BOOL
    if op in _ARITH_OPS:
        if lt.is_decimal or rt.is_decimal:
            return _decimal_arith_type(op, _to_decimal_if_int(lt), _to_decimal_if_int(rt))
        if op == "div":
            # Spark's '/' of non-decimals is DOUBLE; the JAX package binds
            # FLOAT / FLOAT as FLOAT but computes it in DOUBLE too (ROADMAP C14)
            return T.FLOAT64
        return T.common_type(lt, rt)
    raise NotImplementedError(op)

"""Expression evaluator: bound expression IR -> tensor ops over a Batch
(port of ``datafusion_comet_tpu/exec/evaluator.py``: every scalar
expression of ``ir/expr.py``). Families apart: casts to and from strings
(exec/casts.py, Ryu in exec/ryu.py), dates and timestamps in a session
zone (exec/temporal.py), the string functions (exec/string_funcs.py),
rand and randn (exec/random_xorshift.py), the bytes functions
(exec/bytes_funcs.py), JSON paths (exec/json_path.py), the regex nodes
(exec/regex_dfa.py, exec/regex_extract.py), Python UDFs on the host
(exec/host_udf.py); here the literals, arithmetic
and comparisons, the numeric cast matrix, LIKE, CASE and IN, the math
functions, a session's scalar subqueries (a literal of the value the
session materialized before the plan ran, ``EvalContext.subquery_values``),
the bloom-filter probe (exec/operators/agg_special.py), and Spark's
murmur3 and xxhash64 (``HashFunc``, hash partitioning, bloom filters and
the HyperLogLog sketch).

Spark semantics kept from the JAX package:
- three-valued logic through validity vectors, Kleene AND/OR;
- decimal arithmetic on scaled int64 while host-side magnitude bounds prove
  it exact, exact i128 (exec/decimal_wide.py) otherwise, HALF_UP rescaling;
- dictionary-coded strings compare against literals as code ranges, with
  each other as codes when they share a dictionary; anything else decodes
  (``_dedict``) and compares padded bytes as unsigned, the zero padding
  giving the shorter-prefix rule;
- LEGACY/ANSI/TRY modes with an error side channel in ``EvalContext``;
- floats as Spark (Java) has them: NaN equals NaN and ranks above +Inf,
  -0.0 equals 0.0, x / 0.0 is +-Inf or NaN; subnormals kept (XLA on the CPU
  flushes them, ROADMAP C13);
- a function of a dictionary column's strings (LIKE, a cast, a string
  function with literal arguments) runs over the dictionary's entries and
  is gathered back by code (``_eval_on_dict``): LIKE over ``p_type``'s 150
  entries instead of its rows.

The storage choice (narrow int64 or two-limb i128) follows the same bounds
as the JAX package, so both packages hold the same buffers for each node.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from datafusion_comet_tpu_torch import types as T
from datafusion_comet_tpu_torch.exec import casts as CS
from datafusion_comet_tpu_torch.exec import decimal_wide as DW
from datafusion_comet_tpu_torch.exec import nested as NESTED
from datafusion_comet_tpu_torch.exec import random_xorshift as RX
from datafusion_comet_tpu_torch.exec import string_funcs as SF
from datafusion_comet_tpu_torch.exec import temporal as TM
from datafusion_comet_tpu_torch.exec.batch import Batch, ColumnVector, quantize_bound
from datafusion_comet_tpu_torch.ir import expr as E
from datafusion_comet_tpu_torch.utils import int128

__all__ = ["EvalContext", "evaluate", "evaluate_predicate", "murmur3_hash_i32",
           "murmur3_hash_i64", "murmur3_hash_bytes", "murmur3_column", "xxhash64_i32",
           "xxhash64_i64", "xxhash64_bytes", "xxhash64_column"]


@dataclasses.dataclass
class EvalContext:
    # the partition this batch belongs to, of how many, and the index of its
    # first row in the partition (rand's seed, monotonically_increasing_id)
    partition_id: int = 0
    num_partitions: int = 1
    batch_row_offset: int = 0
    # error side channel: (flag tensor, message) pairs, read once at the end
    # of the query; ANSI errors per row, kernel code-range checks per launch
    errors: Optional[List[Tuple[torch.Tensor, str]]] = None
    # live-row mask of the batch being evaluated: errors on dead rows don't fire
    row_mask: Optional[torch.Tensor] = None
    # capacity-overflow flags (a join's fan-out, a compaction), read by the
    # session's re-plan loop; None outside a query
    overflow_flags: Optional[List[torch.Tensor]] = None
    # where a list: the name of the operator that raised each flag, in step
    # with ``overflow_flags`` (``flag_overflow``), and the capacity it would
    # have needed, where it knows it ((key, count tensor) or None)
    overflow_ops: Optional[List[str]] = None
    overflow_needs: Optional[list] = None
    # the capacities earlier attempts of this run proved needed, by (id of
    # the plan node, kind): the operator takes at least that much
    grown: Optional[Dict[tuple, int]] = None
    # what the last hash join would have needed where it overflowed: ("K",
    # the largest match count) on the block path, ("rows", the pairs) on the
    # compacted list
    join_need: Optional[Tuple[str, torch.Tensor]] = None
    # the re-plan loop's growth factor for capacities chosen from estimates
    agg_scale: int = 1
    # whether the joins may take their statistics' unique-build and
    # key-packing hints: true on a plan's first run only, so a hint that
    # proved wrong (its flag fired) is not taken again
    unique_join_ok: bool = True
    # where a list: each INNER join's path and hints, and each nested-loop
    # join's input capacities, in run order
    join_log: Optional[list] = None
    # the session's scalar subqueries' values by id: (value, valid)
    subquery_values: Optional[Dict[int, Tuple[object, bool]]] = None
    # inside a higher-order function's body: each lambda variable's column
    lambda_env: Optional[Dict[str, ColumnVector]] = None
    # where set (``Session.explain``), a MetricsCollector that records
    # every operator's output (observability/metrics.py)
    metrics: Optional[object] = None
    # the session's comet.expr.json.deviceEnabled: get_json_object runs the
    # device path scan, else the host bridge (ir/functions.py)
    json_device: bool = True
    # under ``Session.validate``: Python UDFs give nulls without running
    validating: bool = False

    def flag_overflow(self, flag: torch.Tensor, op: str, need: Optional[torch.Tensor] = None,
                      key: Optional[tuple] = None) -> None:
        """Record a capacity-overflow flag raised by the operator ``op``,
        and (``need``) the capacity that would have held it, under ``key``
        (``grown``)."""
        if self.overflow_flags is not None:
            self.overflow_flags.append(flag)
            if self.overflow_ops is not None:
                self.overflow_ops.append(op)
                self.overflow_needs.append(None if need is None else (key, need))

    def floor(self, key: tuple) -> int:
        """The capacity earlier attempts proved ``key`` needs (0: none)."""
        return (self.grown or {}).get(key, 0)

    def record_error(self, flags: torch.Tensor, message: str) -> None:
        if self.errors is not None:
            if self.row_mask is not None and flags.shape == self.row_mask.shape:
                flags = flags & self.row_mask
            self.errors.append((flags, message))


def evaluate(e: E.Expr, batch: Batch, ctx: Optional[EvalContext] = None) -> ColumnVector:
    """Evaluate a bound expression over a batch."""
    assert e.dtype is not None, f"expression not bound: {e!r}"
    ctx = ctx or EvalContext()
    prev = ctx.row_mask
    ctx.row_mask = batch.row_mask
    try:
        return _ev(e, batch, ctx)
    finally:
        ctx.row_mask = prev


def evaluate_predicate(e: E.Expr, batch: Batch, ctx: Optional[EvalContext] = None) -> torch.Tensor:
    """SQL filter semantics: keep rows where the predicate is TRUE (null
    drops), composed with the batch's live-row mask."""
    cv = evaluate(e, batch, ctx)
    return batch.row_mask & cv.validity & cv.data.bool()


def _ev(e: E.Expr, b: Batch, ctx: EvalContext) -> ColumnVector:
    if isinstance(e, E.BoundRef):
        return b.columns[e.index]
    if isinstance(e, E.Literal):
        return _literal(e, b.capacity, b.device)
    if isinstance(e, E.Alias):
        return _ev(e.child, b, ctx)
    if isinstance(e, E.BinaryOp):
        return _binary(e, b, ctx)
    if isinstance(e, E.UnaryOp):
        return _unary(e, b, ctx)
    if isinstance(e, E.Cast):
        return _cast(_ev(e.child, b, ctx), e.child.dtype, e.to, e.eval_mode, ctx, e.timezone)
    if isinstance(e, E.CaseWhen):
        return _case_when(e, b, ctx)
    if isinstance(e, E.InList):
        return _in_list(e, b, ctx)
    if isinstance(e, E.Like):
        return _like(e, b, ctx)
    if isinstance(e, E.StringFunc):
        return _string_func(e, b, ctx)
    if isinstance(e, E.TemporalFunc):
        return _temporal_func(e, b, ctx)
    if isinstance(e, E.MathFunc):
        return _math_func(e, b, ctx)
    if isinstance(e, E.HashFunc):
        return _hash_func(e, b, ctx)
    if isinstance(e, (E.SplitPart, E.SubstringIndex, E.Soundex, E.FormatNumber)):
        return _split_like(e, b, ctx)
    if isinstance(e, E.LambdaVar):  # JAX ``evaluator.py:200-211``
        assert ctx.lambda_env is not None and e.var_name in ctx.lambda_env, (
            f"lambda variable {e.var_name!r} evaluated outside its lambda")
        return ctx.lambda_env[e.var_name]
    if isinstance(e, E.HigherOrderFunc):
        return NESTED.ev_hof(e, b, ctx, _ev)
    if isinstance(e, (E.ArrayExpr, E.StructExpr, E.GetStructField, E.MapExpr)):
        return NESTED.ev_nested(e, b, ctx, _ev)
    if isinstance(e, E.Split):
        return NESTED.ev_split(e, _ev(e.child, b, ctx), ctx)
    if isinstance(e, (E.RLike, E.RegexpExtract, E.RegexpExtractAll, E.RegexpReplace)):
        return _regex(e, b, ctx)
    if isinstance(e, E.PythonUdf):
        from datafusion_comet_tpu_torch.exec.host_udf import eval_python_udf

        return eval_python_udf(e, b, ctx, _ev)
    if isinstance(e, E.RandExpr):
        fn = RX.rand_column if e.func == "rand" else RX.randn_column
        return fn(RX.init_seed_host(e.seed, ctx.partition_id), b.row_mask)
    if isinstance(e, E.MonotonicallyIncreasingId):
        # Spark: the partition id above bit 33, the row's index in it below
        idx = torch.arange(b.capacity, dtype=torch.int64, device=b.device) + ctx.batch_row_offset
        return ColumnVector((ctx.partition_id << 33) | idx, torch.ones_like(b.row_mask), None,
                            T.INT64)
    if isinstance(e, E.SparkPartitionId):
        return ColumnVector(torch.full((b.capacity,), ctx.partition_id, dtype=torch.int32,
                                       device=b.device), torch.ones_like(b.row_mask), None,
                            T.INT32)
    if isinstance(e, E.ScalarSubquery):
        value, valid = _subquery_value(e, ctx)
        return _literal(E.Literal(value if valid else None, e.dtype), b.capacity, b.device)
    if isinstance(e, E.BloomMightContain):
        from datafusion_comet_tpu_torch.exec.operators.agg_special import bloom_might_contain

        if isinstance(e.filter, E.Literal):
            fb = e.filter.value
        elif isinstance(e.filter, E.ScalarSubquery):
            value, valid = _subquery_value(e.filter, ctx)
            fb = value if valid else None
        else:
            raise NotImplementedError("a bloom filter must be a literal or a scalar subquery")
        return bloom_might_contain(fb, _ev(e.child, b, ctx))
    raise NotImplementedError(f"evaluate: {type(e).__name__}")


def _subquery_value(e: E.ScalarSubquery, ctx: EvalContext):
    """(value, valid) of a materialized subquery (JAX ``evaluator.py:422``)."""
    vals = ctx.subquery_values
    if vals is None or e.subquery_id not in vals:
        raise RuntimeError(f"scalar subquery {e.subquery_id} is not materialized: run the "
                           "plan through the session that registered it")
    return vals[e.subquery_id]


def _torch_dtype(dt: T.DataType) -> torch.dtype:
    return torch.from_numpy(np.zeros(0, dt.np_dtype())).dtype


# -------------------------------------------------------------------------------------
# literals
# -------------------------------------------------------------------------------------


def _literal(e: E.Literal, cap: int, device) -> ColumnVector:
    dt = e.dtype
    ones = torch.ones(cap, dtype=torch.bool, device=device)
    if e.value is None:
        if dt.is_binary:
            return ColumnVector(torch.zeros((cap, dt.byte_width), dtype=torch.uint8, device=device),
                                ~ones, torch.zeros(cap, dtype=torch.int32, device=device), dt)
        shape = (cap, 2) if dt.is_wide_decimal else (cap,)
        return ColumnVector(torch.zeros(shape, dtype=_torch_dtype(dt), device=device), ~ones,
                            None, dt)
    if dt.is_binary:
        # one padded row on the device, broadcast to every row (a view)
        raw = e.value.encode("utf-8") if isinstance(e.value, str) else bytes(e.value)
        row = np.zeros(dt.byte_width, np.uint8)
        row[: len(raw)] = np.frombuffer(raw, np.uint8)
        return ColumnVector(torch.from_numpy(row).to(device).expand(cap, dt.byte_width), ones,
                            torch.full((cap,), len(raw), dtype=torch.int32, device=device), dt)
    if dt.is_wide_decimal:
        v = int(e.value)
        if abs(v) < _NARROW_LIMIT:
            return ColumnVector(torch.full((cap,), v, dtype=torch.int64, device=device), ones,
                                None, dt, mag_bound=quantize_bound(abs(v)))
        zero = torch.zeros(cap, dtype=torch.int64, device=device)
        limbs = int128.const_u128(v & ((1 << 128) - 1), zero)
        return ColumnVector(DW.pack(limbs), ones, None, dt)
    data = torch.full((cap,), np.asarray(e.value).astype(dt.np_dtype()).item(),
                      dtype=_torch_dtype(dt), device=device)
    bound = quantize_bound(abs(int(e.value))) if dt.is_decimal or dt.is_integer else None
    return ColumnVector(data, ones, None, dt, mag_bound=bound)


# -------------------------------------------------------------------------------------
# decimal helpers
# -------------------------------------------------------------------------------------

# Narrow-storage threshold: a decimal stays 1-D int64 while its sound
# magnitude bound is below this (margin under 2^63 so one add can't wrap).
_NARROW_LIMIT = 1 << 62


def _rescale_up_i64(data: torch.Tensor, k: int) -> torch.Tensor:
    return data if k == 0 else data * 10**k


def _decimal_downscale_half_up_i64(data: torch.Tensor, k: int) -> torch.Tensor:
    """Divide by 10^k with HALF_UP rounding (int64 path)."""
    if k == 0:
        return data
    d = 10**k
    q = data // d  # floor division, as in JAX
    r = data - q * d
    negative = data < 0
    adj = negative & (r != 0)
    q_trunc = torch.where(adj, q + 1, q)
    r_trunc = torch.where(adj, r - d, r)
    round_away = (r_trunc.abs() * 2) >= d
    return q_trunc + torch.where(round_away, torch.where(negative, -1, 1), 0)


def _div_i64_half_up(num: torch.Tensor, den: torch.Tensor) -> torch.Tensor:
    q = num // den
    r = num - q * den
    adjust = (r != 0) & ((num < 0) != (den < 0))  # floor -> trunc
    q_t = torch.where(adjust, q + 1, q)
    r_t = torch.where(adjust, r - den, r)
    round_away = (r_t.abs() * 2) >= den.abs()
    sign = torch.where((num < 0) != (den < 0), -1, 1)
    return q_t + torch.where(round_away & (r_t != 0), sign, 0)


def _dec_bound(cv: ColumnVector, dt: T.DataType) -> int:
    """Sound bound on max |unscaled value| of ``cv`` viewed as ``dt``: the
    tracked bound when present, else the type's."""
    if cv.mag_bound is not None:
        return cv.mag_bound
    if cv.dtype.is_integer or cv.dtype.is_boolean:
        return min(10**dt.precision - 1, 1 << 63)
    if cv.dtype.is_decimal and not cv.is_wide_storage and cv.dtype.precision > 18:
        return (1 << 63) - 1  # narrow storage itself proves the values fit
    return 10**dt.precision - 1


def _with_bound(cv: ColumnVector, bound: int) -> ColumnVector:
    return ColumnVector(cv.data, cv.validity, cv.lengths, cv.dtype, cv.dictionary,
                        quantize_bound(bound))


# -------------------------------------------------------------------------------------
# binary ops
# -------------------------------------------------------------------------------------


def _binary(e: E.BinaryOp, b: Batch, ctx: EvalContext) -> ColumnVector:
    op = e.op
    if op in ("and", "or"):
        return _kleene(op, _ev(e.left, b, ctx), _ev(e.right, b, ctx))
    if op in ("eq", "ne", "lt", "le", "gt", "ge", "eqns"):
        # dictionary fast path: codes against a host-side literal rank; the
        # column side is evaluated once either way
        l = r = None
        if _binary_literal(e.right):
            l = _ev(e.left, b, ctx)
            if l.is_dict:
                return _dict_code_compare(op, l, e.right.value, False)
        elif _binary_literal(e.left):
            r = _ev(e.right, b, ctx)
            if r.is_dict:
                return _dict_code_compare(op, r, e.left.value, True)
        l = l if l is not None else _ev(e.left, b, ctx)
        r = r if r is not None else _ev(e.right, b, ctx)
        return _compare(op, l, r)
    l, r = _ev(e.left, b, ctx), _ev(e.right, b, ctx)
    if op in ("add", "sub", "mul", "div", "mod", "pmod"):
        return _arith(e, l, r, ctx)
    raise NotImplementedError(op)


def _unary(e: E.UnaryOp, b: Batch, ctx: EvalContext) -> ColumnVector:
    """JAX ``evaluator.py:922-943``: isnull and isnotnull read the validity
    and are never null; NOT of a null is null; isnan is true on a valid NaN,
    never null; negate and abs keep the input's type and storage (a
    two-limb decimal through i128, a narrow one with its bound; an integer
    wraps at its minimum, as Java's does)."""
    c = _ev(e.child, b, ctx)
    if e.op in ("negate", "abs"):
        if c.is_wide_storage:
            p = DW.pair(c.data)
            res = int128.neg(p) if e.op == "negate" else int128.abs_(p)
            return ColumnVector(DW.pack(res), c.validity, None, c.dtype)
        data = -c.data if e.op == "negate" else c.data.abs()
        return ColumnVector(data, c.validity, None, c.dtype, mag_bound=c.mag_bound)
    if e.op == "isnull":
        return ColumnVector(~c.validity, torch.ones_like(c.validity), None, T.BOOL)
    if e.op == "isnotnull":
        return ColumnVector(c.validity, torch.ones_like(c.validity), None, T.BOOL)
    if e.op == "not":
        return ColumnVector(~c.data.bool(), c.validity, None, T.BOOL)
    if e.op != "isnan":
        raise NotImplementedError(f"UnaryOp {e.op!r} is not ported yet")
    nan = torch.isnan(c.data) if c.dtype.is_floating else torch.zeros_like(c.validity)
    return ColumnVector(nan & c.validity, torch.ones_like(c.validity), None, T.BOOL)


def _binary_literal(e: E.Expr) -> bool:
    return isinstance(e, E.Literal) and e.dtype is not None and e.dtype.is_binary \
        and e.value is not None


def _kleene(op: str, l: ColumnVector, r: ColumnVector) -> ColumnVector:
    ld, rd = l.data.bool(), r.data.bool()
    lv, rv = l.validity, r.validity
    if op == "and":
        data = (ld | ~lv) & (rd | ~rv)  # null reads as True; falseness dominates
        validity = (lv & rv) | (lv & ~ld) | (rv & ~rd)
    else:
        data = (ld & lv) | (rd & rv)  # null reads as False; trueness dominates
        validity = (lv & rv) | (lv & ld) | (rv & rd)
    return ColumnVector(data, validity, None, T.BOOL)


def _dict_code_compare(op: str, cv: ColumnVector, value, flip: bool) -> ColumnVector:
    """Dictionary codes against a literal: two int compares against the
    literal's host-side ranks in the sorted dictionary."""
    raw = value.encode("utf-8") if isinstance(value, str) else bytes(value)
    d = cv.dictionary
    lp = d.insertion_point(raw, "left")   # #entries < raw
    rp = d.insertion_point(raw, "right")  # #entries <= raw
    codes = cv.data
    eq = (codes >= lp) & (codes < rp)
    if flip:  # literal OP column -> mirror the operator
        op = {"lt": "gt", "le": "ge", "gt": "lt", "ge": "le"}.get(op, op)
    data = {"eq": eq, "ne": ~eq, "lt": codes < lp, "le": codes < rp, "gt": codes >= rp,
            "ge": codes >= lp, "eqns": eq}[op]
    if op == "eqns":
        return ColumnVector(data & cv.validity, torch.ones_like(cv.validity), None, T.BOOL)
    return ColumnVector(data, cv.validity, None, T.BOOL)


def _dedict(cv: ColumnVector) -> ColumnVector:
    return cv.decode() if cv.is_dict else cv


def _eval_on_dict(cv: ColumnVector, fn, ctx: EvalContext) -> ColumnVector:
    """``fn`` (a column of the K dictionary entries -> a column of K rows)
    over the dictionary, its result gathered back by code. Error flags that
    ``fn`` raises per entry go to the live, valid rows that hold the entry
    (JAX ``evaluator.py:88``)."""
    d = cv.dictionary
    K = max(d.size, 1)
    dev = cv.data.device
    vals, lens = d.device_arrays(dev, cv.dtype.byte_width)
    small = ColumnVector(vals, torch.ones(K, dtype=torch.bool, device=dev), lens, cv.dtype)
    outer_errors, outer_mask = ctx.errors, ctx.row_mask
    entry_errors: List[Tuple[torch.Tensor, str]] = []
    ctx.errors = entry_errors if outer_errors is not None else None
    ctx.row_mask = None
    try:
        res = fn(small)
    finally:
        ctx.errors, ctx.row_mask = outer_errors, outer_mask
    idx = cv.data.long().clamp(0, K - 1)
    if outer_errors is not None:
        for flags, msg in entry_errors:
            row_flags = flags[idx] & cv.validity
            if outer_mask is not None:
                row_flags = row_flags & outer_mask
            outer_errors.append((row_flags, msg))
    lengths = None if res.lengths is None else res.lengths[idx]
    return ColumnVector(res.data[idx], cv.validity & res.validity[idx], lengths, res.dtype,
                        res.dictionary, children=tuple(c.take(idx) for c in res.children))


# A cast to or from a string runs over blocks of this many rows: its
# per-byte intermediates (Ryu's layout, the parse's digit planes) take
# about 4 KB a row, so a whole 30M-row column at once would not fit the card.
CAST_CHUNK_ROWS = 1 << 22


def _by_chunks(cv: ColumnVector, fn, ctx: EvalContext) -> ColumnVector:
    """``fn`` over consecutive blocks of ``CAST_CHUNK_ROWS`` rows of ``cv``,
    the results concatenated; the error flags ``fn`` records per block are
    joined back into whole-column flags (same messages, same order in every
    block) and recorded under the live-row mask."""
    outer_errors, outer_mask = ctx.errors, ctx.row_mask
    parts, errs = [], []
    try:
        for i in range(0, cv.capacity, CAST_CHUNK_ROWS):
            sl = slice(i, i + CAST_CHUNK_ROWS)
            ctx.errors = [] if outer_errors is not None else None
            ctx.row_mask = None
            parts.append(fn(ColumnVector(cv.data[sl], cv.validity[sl],
                                         None if cv.lengths is None else cv.lengths[sl],
                                         cv.dtype, None, cv.mag_bound)))
            errs.append(ctx.errors or [])
    finally:
        ctx.errors, ctx.row_mask = outer_errors, outer_mask
    for k, (_, msg) in enumerate(errs[0]):
        ctx.record_error(torch.cat([e[k][0] for e in errs]), msg)
    first = parts[0]
    lengths = None if first.lengths is None else torch.cat([p.lengths for p in parts])
    return ColumnVector(torch.cat([p.data for p in parts]), torch.cat([p.validity for p in parts]),
                        lengths, first.dtype, None, first.mag_bound)


_pad_width = SF.pad_width


def _string_eq(l: ColumnVector, r: ColumnVector) -> torch.Tensor:
    """Equal bytes (the narrower side zero-padded) and equal lengths."""
    w = max(l.data.shape[1], r.data.shape[1])
    return (_pad_width(l.data, w) == _pad_width(r.data, w)).all(1) & (l.lengths == r.lengths)


def _string_lt(l: ColumnVector, r: ColumnVector) -> torch.Tensor:
    """Unsigned byte order: the first differing byte decides; with none,
    the shorter string is the smaller (the zero padding encodes the
    shorter-prefix rule)."""
    w = max(l.data.shape[1], r.data.shape[1])
    ld, rd = _pad_width(l.data, w), _pad_width(r.data, w)
    diff = ld != rd
    first = diff.to(torch.uint8).argmax(1, keepdim=True)
    lb, rb = ld.gather(1, first)[:, 0], rd.gather(1, first)[:, 0]
    return torch.where(diff.any(1), lb < rb, l.lengths < r.lengths)


def _compare(op: str, l: ColumnVector, r: ColumnVector) -> ColumnVector:
    if l.is_dict or r.is_dict:
        if l.is_dict and r.is_dict and l.dictionary == r.dictionary:
            # one sorted dictionary: code order is string order
            return _compare_result(op, l.data == r.data, l.data < r.data, l, r)
        l, r = _dedict(l), _dedict(r)
    lt_, rt_ = l.dtype, r.dtype
    if lt_.is_binary or rt_.is_binary:
        # the byte order only where the operator reads it
        lt = _string_lt(l, r) if op in ("lt", "le", "gt", "ge") else None
        return _compare_result(op, _string_eq(l, r), lt, l, r)
    if lt_.is_decimal or rt_.is_decimal:
        ldt = lt_ if lt_.is_decimal else T.decimal_for_int(lt_)
        rdt = rt_ if rt_.is_decimal else T.decimal_for_int(rt_)
        ct = T.common_type(ldt, rdt)
        lk, rk = ct.scale - ldt.scale, ct.scale - rdt.scale
        if (l.is_wide_storage or r.is_wide_storage
                or _dec_bound(l, ldt) * 10**lk >= _NARROW_LIMIT
                or _dec_bound(r, rdt) * 10**rk >= _NARROW_LIMIT):
            eq, lt = DW.compare(DW.lift(l, lk), DW.lift(r, rk))
            return _compare_result(op, eq, lt, l, r)
        # bounds prove the upscale to the common scale fits int64
        ld = _rescale_up_i64(l.data.long(), lk)
        rd = _rescale_up_i64(r.data.long(), rk)
    elif lt_.is_floating or rt_.is_floating:
        ct = T.common_type(lt_, rt_)
        ld, rd = _coerce(l, ct).data, _coerce(r, ct).data
        return _compare_result(op, _float_eq(ld, rd), _float_lt(ld, rd), l, r)
    else:
        ct = T.common_type(lt_, rt_)
        ld, rd = _coerce(l, ct).data, _coerce(r, ct).data
    return _compare_result(op, ld == rd, ld < rd, l, r)


def _float_eq(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Spark float equality: NaN equals NaN (and -0.0 equals 0.0)."""
    return (a == b) | (torch.isnan(a) & torch.isnan(b))


def _float_lt(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Spark float order: NaN above every value, +Inf included."""
    return torch.where(torch.isnan(a), False, torch.where(torch.isnan(b), True, a < b))


def _compare_result(op: str, eq: torch.Tensor, lt: Optional[torch.Tensor], l: ColumnVector,
                    r: ColumnVector) -> ColumnVector:
    """The comparison ``op`` from equality and less-than (which eq, ne and
    eqns do not read: None there)."""
    both = l.validity & r.validity
    if op == "eqns":
        data = torch.where(both, eq, l.validity == r.validity)
        return ColumnVector(data, torch.ones_like(both), None, T.BOOL)
    if op in ("eq", "ne"):
        return ColumnVector(eq if op == "eq" else ~eq, both, None, T.BOOL)
    data = {"lt": lt, "le": lt | eq, "gt": ~(lt | eq), "ge": ~lt}[op]
    return ColumnVector(data, both, None, T.BOOL)


def _coerce(cv: ColumnVector, to: T.DataType) -> ColumnVector:
    if cv.dtype == to:
        return cv
    return _cast(cv, cv.dtype, to, E.EvalMode.LEGACY, EvalContext())


def _arith(e: E.BinaryOp, l: ColumnVector, r: ColumnVector, ctx: EvalContext) -> ColumnVector:
    op, out = e.op, e.dtype
    validity = l.validity & r.validity
    if out.is_decimal:
        return _decimal_arith(e, l, r, validity, ctx)
    # JAX ``evaluator.py:731-770``: division runs in DOUBLE; floats follow
    # Java (x / 0.0 is +-Inf or NaN, x % 0.0 NaN, never null); integer mod
    # truncates toward zero and is null on a zero divisor (ANSI: an error)
    work = T.FLOAT64 if op == "div" else out
    ld, rd = _coerce(l, work).data, _coerce(r, work).data
    if op in ("add", "sub", "mul", "div"):
        data = {"add": torch.add, "sub": torch.sub, "mul": torch.mul, "div": torch.div}[op](ld, rd)
        return ColumnVector(data.to(_torch_dtype(out)), validity, None, out)
    is_zero = rd == 0
    safe = torch.where(is_zero, torch.ones_like(rd), rd)
    if out.is_floating:
        data = torch.where(is_zero, torch.full_like(ld, float("nan")), _c_fmod(ld, safe))
        return ColumnVector(data, validity, None, out)
    data = ld - (ld.double() / safe.double()).trunc().to(ld.dtype) * safe
    if op == "pmod":
        data = torch.where(data < 0, data + safe.abs(), data)
    if e.eval_mode == E.EvalMode.ANSI:
        ctx.record_error(is_zero & validity, "DIVIDE_BY_ZERO")
    return ColumnVector(data, validity & ~is_zero, None, out)


def _c_fmod(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a - b x trunc(a / b), as the JAX package computes a float mod."""
    return a - b * torch.trunc(a / b)


def _arith_bound(op: str, lb: int, rb: int, s1: int, s2: int, so: int, prec: int):
    """(sound output |unscaled| bound, narrow path is exact) for a decimal
    op with input bounds lb/rb at scales s1/s2 and output scale/precision."""
    if op in ("add", "sub"):
        if so < s1 or so < s2:
            return 10**38, False
        ob = lb * 10 ** (so - s1) + rb * 10 ** (so - s2)
        return ob, ob < _NARROW_LIMIT
    if op == "mul":
        raw_scale = s1 + s2
        raw = lb * rb
        ob = raw * 10 ** (so - raw_scale) if so >= raw_scale else raw // 10 ** (raw_scale - so) + 1
        # the interior i128 product is exact while |l|, |r| fit i64 and the
        # downscale divisor fits i64
        return ob, ob < _NARROW_LIMIT and (so >= raw_scale or raw_scale - so <= 18)
    if op == "div":
        k = so - s1 + s2
        if k < 0:
            return 10**38, False
        nb = lb * 10**k  # |quotient| <= |scaled numerator| since |den| >= 1
        ob = min(nb + 1, 10**prec - 1)
        return ob, nb + 1 < _NARROW_LIMIT or (nb < 2**126 and ob < _NARROW_LIMIT)
    if op in ("mod", "pmod"):
        s = max(s1, s2)
        ab, cb = lb * 10 ** (s - s1), rb * 10 ** (s - s2)
        mb = cb if op == "pmod" else min(ab, cb)
        ob = mb * 10 ** (so - s) if so >= s else mb // 10 ** (s - so) + 1
        return ob, ab < _NARROW_LIMIT and cb < _NARROW_LIMIT
    return 10**38, False


def _decimal_arith(e: E.BinaryOp, l: ColumnVector, r: ColumnVector, validity,
                   ctx: EvalContext) -> ColumnVector:
    op, out = e.op, e.dtype
    lt_ = l.dtype if l.dtype.is_decimal else T.decimal_for_int(l.dtype)
    rt_ = r.dtype if r.dtype.is_decimal else T.decimal_for_int(r.dtype)
    s1, s2, so = lt_.scale, rt_.scale, out.scale
    lb, rb = _dec_bound(l, lt_), _dec_bound(r, rt_)
    ob, narrow_ok = _arith_bound(op, lb, rb, s1, s2, so, out.precision)
    if l.is_wide_storage or r.is_wide_storage or not narrow_ok:
        res, zero_div = DW.arith(op, l, r, lt_, rt_, out)
        if op in ("div", "mod", "pmod"):
            if e.eval_mode == E.EvalMode.ANSI:
                ctx.record_error(zero_div & validity, "DIVIDE_BY_ZERO")
            validity = validity & ~zero_div
        over = DW.overflow_check(res, out.precision)
        if e.eval_mode == E.EvalMode.ANSI:
            ctx.record_error(over & validity, "NUMERIC_VALUE_OUT_OF_RANGE")
        validity = validity & ~over  # LEGACY/TRY: overflow -> null
        eff = min(ob, 10**out.precision - 1)  # overflow rows are null
        if out.is_wide_decimal and eff >= _NARROW_LIMIT:
            return ColumnVector(DW.pack(res), validity, None, out)
        return _with_bound(ColumnVector(res[1], validity, None, out), eff)
    ld, rd = l.data.long(), r.data.long()
    if op in ("add", "sub"):
        a, c = _rescale_up_i64(ld, so - s1), _rescale_up_i64(rd, so - s2)
        data = a + c if op == "add" else a - c
    elif op == "mul":
        raw_scale = s1 + s2
        if lb * rb < _NARROW_LIMIT and raw_scale >= so:
            # bounds prove the raw product fits int64: plain multiply and an
            # int64 HALF_UP rescale (the Q6 revenue path)
            raw = ld * rd
            data = raw if raw_scale == so else _decimal_downscale_half_up_i64(raw, raw_scale - so)
        else:
            prod = int128.mul_i64(ld, rd)
            if raw_scale == so:
                data = int128.to_i64(prod)
            else:
                data = int128.div_i128_i64_half_up(
                    prod, torch.full_like(ld, 10 ** (raw_scale - so)))
    elif op in ("mod", "pmod"):
        # JAX ``evaluator.py:889-900``: the truncated remainder at the common
        # scale (through a double quotient, as there), never an error
        s = max(s1, s2)
        a, c = _rescale_up_i64(ld, s - s1), _rescale_up_i64(rd, s - s2)
        is_zero = c == 0
        safe = torch.where(is_zero, torch.ones_like(c), c)
        m = a - (a.double() / safe.double()).trunc().long() * safe
        if op == "pmod":
            m = torch.where(m < 0, m + safe.abs(), m)
        data = (_rescale_up_i64(m, so - s) if so >= s
                else _decimal_downscale_half_up_i64(m, s - so))
        validity = validity & ~is_zero
    else:  # div
        k = so - s1 + s2
        is_zero = rd == 0
        safe = torch.where(is_zero, torch.ones_like(rd), rd)
        if lb * 10**k + 1 < _NARROW_LIMIT:
            data = _div_i64_half_up(_rescale_up_i64(ld, k), safe)
        else:
            # the numerator needs i128; rows whose quotient overflows the
            # output precision go null (ANSI: error)
            q = DW._div_i128_i64_full(int128.mul_pow10_i64(ld, k), safe)
            over = ~DW.fits_i64(q) | (q[1].abs() > 10 ** min(out.precision, 18) - 1)
            if e.eval_mode == E.EvalMode.ANSI:
                ctx.record_error(over & validity & ~is_zero, "NUMERIC_VALUE_OUT_OF_RANGE")
            validity = validity & ~over
            data = q[1]
        if e.eval_mode == E.EvalMode.ANSI:
            ctx.record_error(is_zero & validity, "DIVIDE_BY_ZERO")
        validity = validity & ~is_zero
    return _with_bound(ColumnVector(data, validity, None, out), ob)


# -------------------------------------------------------------------------------------
# cast
# -------------------------------------------------------------------------------------


def _cast_bound(cv: ColumnVector, frm: T.DataType, to: T.DataType) -> int:
    """Sound |unscaled| bound of cast(cv as to), computed on the host."""
    if frm.is_decimal:
        fb = _dec_bound(cv, frm)
        k = to.scale - frm.scale
        return fb * 10**k if k >= 0 else fb // 10 ** (-k) + 1
    lo, hi = (0, 1) if frm.is_boolean else frm.int_bounds()
    return max(abs(int(lo)), int(hi)) * 10**to.scale


def _cast(cv: ColumnVector, frm: T.DataType, to: T.DataType, mode: str, ctx: EvalContext,
          tz: Optional[str] = None) -> ColumnVector:
    """The Spark cast matrix as the JAX package has it (``evaluator.py:951``,
    exec/cast_matrix.py lists it): a dictionary column's entries cast once
    and gathered back by code; strings to and from every scalar type
    (exec/casts.py); timestamps to and from dates and numbers (seconds),
    in the session zone ``tz`` where a timestamp meets a string or a date;
    integers, decimals, floats and booleans among themselves."""
    if frm == to:
        return cv
    if cv.is_dict:
        return _eval_on_dict(cv, lambda s: _cast(s, frm, to, mode, ctx, tz), ctx)
    if frm.type_id == "NULL":
        return _literal(E.Literal(None, to), cv.capacity, cv.data.device)
    if (to.is_binary != frm.is_binary) and cv.capacity > CAST_CHUNK_ROWS:
        return _by_chunks(cv, lambda s: _cast(s, frm, to, mode, ctx, tz), ctx)
    validity = cv.validity
    ts_ids = ("TIMESTAMP", "TIMESTAMP_NTZ")
    if to.is_binary:
        if frm.is_binary:  # to another width: cut or zero-padded bytes, lengths capped
            w = to.byte_width
            data = cv.data[:, :w] if cv.data.shape[1] >= w else _pad_width(cv.data, w)
            return ColumnVector(data, validity, cv.lengths.clamp(max=w), to)
        if frm.is_integer or frm.is_decimal or frm.type_id == "DATE" or frm.is_boolean:
            return CS.cast_to_string(cv, frm, to)
        if frm.is_floating:
            return CS.float_to_string(cv, frm, to)
        if frm.type_id in ts_ids:
            micros = cv.data.long()
            if tz and frm.type_id == "TIMESTAMP":  # rendered on the session's wall clock
                micros = micros + TM.tz_offset_micros(micros, tz, local=False)
            return CS.timestamp_to_string(micros, validity, to)
        raise NotImplementedError(f"cast {frm!r} -> string")
    if frm.is_binary:
        return CS.cast_string_to(cv, to, mode, ctx, tz)
    if frm.type_id in ts_ids or to.type_id in ts_ids or frm.type_id == "DATE" \
            or to.type_id == "DATE":
        return _cast_temporal(cv, frm, to, mode, ctx, tz)
    if frm.is_floating or to.is_floating:
        return _cast_float(cv, frm, to, mode, ctx)
    if to.is_integer and frm.is_integer and T.common_type(frm, to) == to:  # widening
        return ColumnVector(cv.data.to(_torch_dtype(to)), validity, None, to)
    if to.is_decimal and (frm.is_decimal or frm.is_integer or frm.is_boolean):
        nb = _cast_bound(cv, frm, to)
        if cv.is_wide_storage or nb >= _NARROW_LIMIT:
            return _cast_wide_decimal(cv, frm, to, mode, ctx, validity, nb)
        if frm.is_decimal:
            k = to.scale - frm.scale
            data = (_rescale_up_i64(cv.data.long(), k) if k >= 0
                    else _decimal_downscale_half_up_i64(cv.data.long(), -k))
        else:
            data = cv.data.long() * 10**to.scale
        return _with_bound(ColumnVector(data, validity, None, to), nb)
    if frm.is_decimal and to.is_integer:
        # the fraction truncated toward zero (JAX ``evaluator.py:1018-1029``)
        if cv.is_wide_storage:
            p = int128.div_pow10_i128_trunc(DW.pair(cv.data), frm.scale)
            fits = DW.fits_i64(p)
            if mode == E.EvalMode.ANSI:
                ctx.record_error(~fits & validity, "CAST_OVERFLOW")
            return _int_narrow(p[1], validity & fits, to, mode, ctx)
        return _int_narrow(_decimal_truncate_i64(cv.data.long(), frm.scale), validity, to,
                           mode, ctx)
    if to.is_integer and (frm.is_integer or frm.is_boolean):  # Java narrowing
        return _int_narrow(cv.data.long(), validity, to, mode, ctx)
    if to.is_boolean and frm.is_integer:
        return ColumnVector(cv.data != 0, validity, None, to)
    raise NotImplementedError(f"cast {frm!r} -> {to!r}")


def _cast_temporal(cv: ColumnVector, frm: T.DataType, to: T.DataType, mode: str,
                   ctx: EvalContext, tz: Optional[str]) -> ColumnVector:
    """The date and timestamp rows of the matrix (JAX ``evaluator.py:
    1037-1089``): a timestamp to a number is its seconds (floored for an
    integer), a number to a timestamp seconds (a float's fraction kept to
    the microsecond, NaN, infinities and overflow null), a timestamp to a
    date its day (on the session's wall clock), a date to a timestamp its
    midnight; a date to an integer or a float its day number, a date or a
    timestamp to a boolean whether it is not the epoch."""
    validity = cv.validity
    ts_ids = ("TIMESTAMP", "TIMESTAMP_NTZ")
    x = cv.data
    if frm.type_id in ts_ids and (to.is_integer or to.is_floating):
        if to.is_integer:
            return _int_narrow(x.long() // 1_000_000, validity, to, mode, ctx)
        return ColumnVector((x.double() / 1e6).to(_torch_dtype(to)), validity, None, to)
    if to.type_id == "DATE" and frm.type_id in ts_ids:
        micros = x.long()
        if tz and frm.type_id == "TIMESTAMP":
            micros = micros + TM.tz_offset_micros(micros, tz, local=False)
        return ColumnVector((micros // TM.MU_DAY).int(), validity, None, to)
    if to.type_id in ts_ids and frm.type_id == "DATE":
        micros = x.long() * TM.MU_DAY
        if tz and to.type_id == "TIMESTAMP":  # local midnight; a DST gap takes the earlier offset
            micros = micros - TM.tz_offset_micros(micros, tz, local=True)
        return ColumnVector(micros, validity, None, to)
    if to.type_id in ts_ids and (frm.is_integer or frm.is_floating or frm.is_boolean):
        if frm.is_floating:
            sec = x.double()
            ok = torch.isfinite(sec) & (sec.abs() < 9.3e12)
            micros = torch.where(ok, sec * 1e6, 0.0).long()
            return ColumnVector(micros, validity & ok, None, to)
        return ColumnVector(x.long() * 1_000_000, validity, None, to)
    if frm.type_id == "DATE" and to.is_integer:
        return _int_narrow(x.long(), validity, to, mode, ctx)
    if frm.type_id == "DATE" and to.is_floating:
        return ColumnVector(x.to(_torch_dtype(to)), validity, None, to)
    if frm.is_temporal and to.is_boolean:
        return ColumnVector(x != 0, validity, None, to)
    raise NotImplementedError(f"cast {frm!r} -> {to!r}")


def _decimal_truncate_i64(data: torch.Tensor, scale: int) -> torch.Tensor:
    """An unscaled decimal's integer part, truncated toward zero."""
    if scale == 0:
        return data
    d = 10**scale
    q = torch.div(data, d, rounding_mode="floor")
    return torch.where((data < 0) & (data - q * d != 0), q + 1, q)


def _int_narrow(data: torch.Tensor, validity: torch.Tensor, to: T.DataType, mode: str,
                ctx: EvalContext) -> ColumnVector:
    """An int64 as the integer type ``to``: wrapped as Java narrows
    (LEGACY), null out of range (TRY), or recorded as CAST_OVERFLOW
    (ANSI)."""
    lo, hi = to.int_bounds()
    in_range = (data >= lo) & (data <= hi)
    if mode == E.EvalMode.ANSI:
        ctx.record_error(~in_range & validity, "CAST_OVERFLOW")
    elif mode == E.EvalMode.TRY:
        validity = validity & in_range
    return ColumnVector(data.to(_torch_dtype(to)), validity, None, to)


def _cast_float(cv: ColumnVector, frm: T.DataType, to: T.DataType, mode: str,
                ctx: EvalContext) -> ColumnVector:
    """The float rows of the cast matrix (JAX ``evaluator.py:1010-1060``,
    ``:1118``): integers, bools, floats and decimals to a float (a two-limb
    decimal through ``int128.to_f64``); a float to an integer (truncated:
    LEGACY wraps through int64 as Java's narrowing does, TRY is null out of
    range, ANSI records CAST_OVERFLOW), to a bool (non-zero) and to a
    decimal (scaled, rounded half to even, null where not finite or over
    the precision, ANSI CAST_OVERFLOW)."""
    validity = cv.validity
    if to.is_floating:
        if frm.is_decimal:
            data = (int128.to_f64(DW.pair(cv.data)) if cv.is_wide_storage
                    else cv.data.double())
            # a divisor on the device: CUDA divides by a host scalar as a
            # product with its reciprocal, one ulp off the quotient
            data = data / torch.full((), 10.0**frm.scale, dtype=torch.float64,
                                     device=data.device)
        elif frm.is_floating or frm.is_integer or frm.is_boolean:
            data = cv.data
        else:
            raise NotImplementedError(f"cast {frm!r} -> {to!r}")
        return ColumnVector(data.to(_torch_dtype(to)), validity, None, to)
    x = cv.data
    if to.is_integer:
        lo, hi = to.int_bounds()
        if mode == E.EvalMode.LEGACY:
            data = DW.f64_to_i64_sat(x)
        else:
            trunc = torch.trunc(x)
            in_range = (trunc >= lo) & (trunc <= hi) & ~torch.isnan(x)
            data = DW.f64_to_i64_sat(torch.where(in_range, trunc, 0)).clamp(lo, hi)
            if mode == E.EvalMode.ANSI:
                ctx.record_error(~in_range & validity, "CAST_OVERFLOW")
            else:
                validity = validity & in_range
        return ColumnVector(data.to(_torch_dtype(to)), validity, None, to)
    if to.is_boolean:
        return ColumnVector(x != 0, validity, None, to)
    if not to.is_decimal:
        raise NotImplementedError(f"cast {frm!r} -> {to!r}")
    scaled = x.double() * (10.0**to.scale)
    ok = torch.isfinite(scaled)
    p = DW.f64_to_i128(torch.where(ok, torch.round(scaled), 0.0))
    if mode == E.EvalMode.ANSI:
        ctx.record_error(~ok & validity, "CAST_OVERFLOW")
    validity = validity & ok
    over = DW.overflow_check(p, to.precision)
    if mode == E.EvalMode.ANSI:
        ctx.record_error(over & validity, "CAST_OVERFLOW")
    validity = validity & ~over
    eff = 10**to.precision - 1  # a float has no magnitude bound: the type's
    if to.is_wide_decimal and eff >= _NARROW_LIMIT:
        return ColumnVector(DW.pack(p), validity, None, to)
    return _with_bound(ColumnVector(p[1], validity, None, to), eff)


def _cast_wide_decimal(cv: ColumnVector, frm: T.DataType, to: T.DataType, mode: str,
                       ctx: EvalContext, validity, nb: int) -> ColumnVector:
    """Casts to decimals needing i128: rescale + precision-overflow check
    (null in LEGACY/TRY, error in ANSI). Storage narrows back to 1-D int64
    when the post-check bound fits."""
    if frm.is_decimal:
        p = DW.rescale(DW.lift(cv), to.scale - frm.scale)
    else:
        p = int128.mul_pow10_i128(int128.from_i64(cv.data.long()), to.scale)
    over = DW.overflow_check(p, to.precision)
    if mode == E.EvalMode.ANSI:
        ctx.record_error(over & validity, "CAST_OVERFLOW")
    validity = validity & ~over
    eff = min(nb, 10**to.precision - 1)
    if to.is_wide_decimal and eff >= _NARROW_LIMIT:
        return ColumnVector(DW.pack(p), validity, None, to)
    return _with_bound(ColumnVector(p[1], validity, None, to), eff)


# -------------------------------------------------------------------------------------
# math
# -------------------------------------------------------------------------------------

def _sign(x: torch.Tensor) -> torch.Tensor:
    """-1.0, 0.0 or 1.0, NaN of a NaN (``torch.sign`` gives 0.0 there)."""
    return torch.where(torch.isnan(x), x, torch.sign(x))


_FLOAT_FUNCS = {
    "sqrt": torch.sqrt, "exp": torch.exp, "ln": torch.log, "log10": torch.log10,
    "log2": torch.log2, "sin": torch.sin, "cos": torch.cos, "tan": torch.tan,
    "asin": torch.asin, "acos": torch.acos, "atan": torch.atan,
    "cbrt": lambda v: torch.sign(v) * v.abs().pow(1.0 / 3.0),
    "expm1": torch.expm1, "log1p": torch.log1p, "sinh": torch.sinh, "cosh": torch.cosh,
    "tanh": torch.tanh, "degrees": torch.rad2deg, "radians": torch.deg2rad,
    "signum": _sign, "acosh": torch.acosh, "asinh": torch.asinh, "atanh": torch.atanh,
    "cot": lambda v: 1.0 / torch.tan(v), "csc": lambda v: 1.0 / torch.sin(v),
    "sec": lambda v: 1.0 / torch.cos(v), "rint": torch.round,  # half to even, as rint
}
_FACTORIALS = [math.factorial(i) for i in range(21)]  # factorial's 0..20


def _popcount64(x: torch.Tensor) -> torch.Tensor:
    """Set bits of each int64 (SWAR; the masks drop the sign extension of
    the arithmetic shifts)."""
    x = x - ((x >> 1) & 0x5555555555555555)
    x = (x & 0x3333333333333333) + ((x >> 2) & 0x3333333333333333)
    x = (x + (x >> 4)) & 0x0F0F0F0F0F0F0F0F
    return (x * 0x0101010101010101) >> 56


def _math_func(e: E.MathFunc, b: Batch, ctx: EvalContext) -> ColumnVector:
    """JAX ``evaluator.py:2430-2629``, branch by branch. Decimal ROUND,
    FLOOR and CEIL take narrow storage, as there; a two-limb decimal raises
    NotImplementedError (ROADMAP A.8)."""
    f, out = e.func, e.dtype
    args = [_ev(a, b, ctx) for a in e.args]
    cv = args[0]

    def f64(c: ColumnVector) -> torch.Tensor:
        return _coerce(c, T.FLOAT64).data

    if f in ("round", "bround", "floor", "ceil") and cv.is_wide_storage:
        raise NotImplementedError(f"{f} of a two-limb decimal is not ported yet")
    if f == "round":
        d = int(e.args[1].value) if len(e.args) > 1 else 0
        if cv.dtype.is_decimal:
            k = cv.dtype.scale - out.scale
            x = cv.data.long()
            data = _decimal_downscale_half_up_i64(x, k) if k > 0 else _rescale_up_i64(x, -k)
            return ColumnVector(data, cv.validity, None, out)
        if cv.dtype.is_integer:
            if d >= 0:
                return cv
            p = 10 ** (-d)
            data = torch.div(cv.data + torch.sign(cv.data) * (p // 2), p,
                             rounding_mode="floor") * p
            return ColumnVector(data.to(cv.data.dtype), cv.validity, None, out)
        # HALF_UP on the scaled value, as the JAX package rounds a float
        factor = 10.0**d
        x = cv.data * factor
        return ColumnVector(torch.sign(x) * torch.floor(x.abs() + 0.5) / factor, cv.validity,
                            None, out)
    if f == "width_bucket":
        # Spark WidthBucket.computeBucketNumber: null for a bucket count <= 0
        # or Long.MaxValue, a NaN value, equal bounds or a bound NaN or
        # infinite; below the range 0, at or above it n + 1; a descending
        # range counts down
        v, lo, hi = f64(args[0]), f64(args[1]), f64(args[2])
        n = _coerce(args[3], T.INT64).data.long()
        valid = args[0].validity & args[1].validity & args[2].validity & args[3].validity
        bad = ((n <= 0) | (n == (1 << 63) - 1) | torch.isnan(v) | (lo == hi) | torch.isnan(lo)
               | torch.isinf(lo) | torch.isnan(hi) | torch.isinf(hi))
        lower, upper = torch.minimum(lo, hi), torch.maximum(lo, hi)
        nf = n.double()
        span = torch.where(upper - lower == 0, 1.0, upper - lower)
        asc = (nf * (v - lower) / span).long() + 1
        desc = (nf * (upper - v) / span).long() + 1
        up_is_max = lo < hi
        below = torch.where(up_is_max, v < lower, v > upper)
        above = torch.where(up_is_max, v >= upper, v <= lower)
        bucket = torch.where(below, 0, torch.where(above, n + 1,
                                                   torch.where(up_is_max, asc, desc)))
        return ColumnVector(bucket, valid & ~bad, None, T.INT64)
    if f in ("floor", "ceil"):
        if cv.dtype.is_decimal:
            dnum = 10**cv.dtype.scale
            q = torch.div(cv.data, dnum, rounding_mode="floor")
            data = q if f == "floor" else q + (cv.data - q * dnum != 0).long()
            return ColumnVector(data.long(), cv.validity, None, out)
        if cv.dtype.is_integer:
            return cv
        fn = torch.floor if f == "floor" else torch.ceil
        return ColumnVector(fn(cv.data).long(), cv.validity, None, out)
    if f in _FLOAT_FUNCS:
        x = f64(cv)
        valid = cv.validity
        if f in ("ln", "log10", "log2"):
            valid = valid & (x > 0.0)  # Spark: the log of a value <= 0 is null
        if f == "log1p":
            valid = valid & (x > -1.0)
        return ColumnVector(_FLOAT_FUNCS[f](x), valid, None, T.FLOAT64)
    if f == "factorial":  # defined on 0..20, null elsewhere
        n = cv.data.int()
        table = torch.tensor(_FACTORIALS, dtype=torch.int64, device=n.device)
        return ColumnVector(table[n.clamp(0, 20).long()], cv.validity & (n >= 0) & (n <= 20),
                            None, T.INT64)
    if f == "bit_count":
        return ColumnVector(_popcount64(cv.data.long()).int(), cv.validity, None, T.INT32)
    if f == "getbit":
        x = _coerce(cv, T.INT64).data
        pos = _coerce(args[1], T.INT32).data.long()
        bit = (x >> pos.clamp(0, 63)) & 1
        both = cv.validity & args[1].validity
        bad = (pos < 0) | (pos >= 64)
        if e.eval_mode == E.EvalMode.ANSI:
            ctx.record_error(both & bad, "INVALID_PARAMETER_VALUE")
        return ColumnVector(bit.to(torch.int8), both & ~bad, None, T.INT8)
    if f == "shiftrightunsigned":
        x = cv.data
        bits = 64 if x.dtype == torch.int64 else 32
        s = _coerce(args[1], T.INT32).data.long() % bits  # Java: the count mod the width
        if bits == 32:
            val = ((x.long() & 0xFFFFFFFF) >> s).to(x.dtype)
        else:
            val = torch.where(s == 0, x, (x >> s) & ((torch.ones_like(x) << (64 - s)) - 1))
        return ColumnVector(val, cv.validity & args[1].validity, None, out)
    if f == "nanvl":
        a, c = _coerce(args[0], T.FLOAT64), _coerce(args[1], T.FLOAT64)
        nan = torch.isnan(a.data)
        return ColumnVector(torch.where(nan, c.data, a.data),
                            a.validity & torch.where(nan, c.validity, True), None, T.FLOAT64)
    if f == "bround":  # HALF_EVEN at scale d (Spark BRound), doubles and integers
        d = (int(e.args[1].value) if len(e.args) > 1 and isinstance(e.args[1], E.Literal)
             else 0)
        if cv.dtype.is_integer:
            if d >= 0:
                return cv
            m = 10 ** (-d)
            r = torch.round(cv.data.long().double() / m).long() * m
            return ColumnVector(r.to(cv.data.dtype), cv.validity, None, cv.dtype)
        if cv.dtype.is_decimal:
            raise NotImplementedError("bround over decimal")
        scale = 10.0**d
        return ColumnVector(torch.round(f64(cv) * scale) / scale, cv.validity, None, T.FLOAT64)
    if f == "log" and len(args) == 2:  # Logarithm(base, x): null for x <= 0 or base <= 0
        base, x = f64(args[0]), f64(args[1])
        ok = args[0].validity & args[1].validity & (x > 0.0) & (base > 0.0)
        return ColumnVector(torch.log(x) / torch.log(base), ok, None, T.FLOAT64)
    if f in ("pow", "atan2", "hypot"):
        fn = {"pow": torch.pow, "atan2": torch.atan2, "hypot": torch.hypot}[f]
        return ColumnVector(fn(f64(args[0]), f64(args[1])), args[0].validity & args[1].validity,
                            None, T.FLOAT64)
    if f == "sign":
        return ColumnVector(_sign(f64(cv)), cv.validity, None, T.FLOAT64)
    if f in ("greatest", "least"):  # nulls skipped
        acc = _coerce(args[0], out)
        for a in args[1:]:
            a = _coerce(a, out)
            beats = a.data > acc.data if f == "greatest" else a.data < acc.data
            take = a.validity & (~acc.validity | beats)
            acc = ColumnVector(torch.where(take, a.data, acc.data), acc.validity | a.validity,
                               None, out)
        return acc
    raise NotImplementedError(f"math func {f}")


# -------------------------------------------------------------------------------------
# conditionals
# -------------------------------------------------------------------------------------


def _case_when(e: E.CaseWhen, b: Batch, ctx: EvalContext) -> ColumnVector:
    """Branches apply in reverse over the ELSE value, so the first true
    condition wins; a null condition counts as false. A string result is
    padded bytes and lengths (dictionary branches are decoded, as in the
    JAX package), the narrower branches zero-padded to the widest."""
    out_t = e.dtype
    if e.else_value is not None:
        result = _coerce(_ev(e.else_value, b, ctx), out_t)
    else:
        result = _literal(E.Literal(None, out_t), b.capacity, b.device)
    result = _dedict(result)
    for cond, value in reversed(e.branches):
        c = _ev(cond, b, ctx)
        v = _dedict(_coerce(_ev(value, b, ctx), out_t))
        if out_t.is_decimal and v.is_wide_storage != result.is_wide_storage:
            # one branch narrow by its bound, the other two-limb: widen both
            v = ColumnVector(DW.pack(DW.lift(v)), v.validity, None, out_t)
            result = ColumnVector(DW.pack(DW.lift(result)), result.validity, None, out_t)
        take = c.validity & c.data.bool()
        lengths = (torch.where(take, v.lengths, result.lengths) if out_t.is_binary else None)
        result = ColumnVector(_select_cv(take, v, result),
                              torch.where(take, v.validity, result.validity), lengths, out_t)
    return result


def _select_cv(take: torch.Tensor, a: ColumnVector, b: ColumnVector) -> torch.Tensor:
    if a.data.dim() == 2:
        w = max(a.data.shape[1], b.data.shape[1])
        return torch.where(take[:, None], _pad_width(a.data, w), _pad_width(b.data, w))
    return torch.where(take, a.data, b.data)


def _in_list(e: E.InList, b: Batch, ctx: EvalContext) -> ColumnVector:
    """An OR of equalities (Kleene: a null element makes a miss null)."""
    acc: Optional[ColumnVector] = None
    for v in e.values:
        node = E.BinaryOp("eq", e.child, v)
        object.__setattr__(node, "dtype", T.BOOL)
        eq = _binary(node, b, ctx)
        acc = eq if acc is None else _kleene("or", acc, eq)
    if e.negated:
        return ColumnVector(~acc.data.bool(), acc.validity, None, T.BOOL)
    return acc


# -------------------------------------------------------------------------------------
# LIKE (JAX ``evaluator.py:1537-1612``)
# -------------------------------------------------------------------------------------


def _segment_match_positions(mat: torch.Tensor, lens: torch.Tensor, seg: bytes) -> torch.Tensor:
    """(cap, P) bool: whether ``seg`` ('_' matching any byte) matches at
    byte offset p and fits inside the string, P = max(w - len(seg) + 1, 1)."""
    cap, w = mat.shape
    m = len(seg)
    P = max(w - m + 1, 1)
    dev = mat.device
    if m == 0:
        return torch.ones((cap, P), dtype=torch.bool, device=dev)
    acc = torch.ones((cap, P), dtype=torch.bool, device=dev)
    base = torch.arange(P, device=dev)
    for j, chb in enumerate(seg):
        if chb != ord("_"):
            acc &= mat[:, (base + j).clamp(max=w - 1)] == chb
    return acc & ((base[None, :] + m) <= lens[:, None])


def _like(e: E.Like, b: Batch, ctx: EvalContext) -> ColumnVector:
    cv = _ev(e.child, b, ctx)
    if cv.is_dict:  # match the K entries, map back by code
        return _eval_on_dict(cv, lambda s: _like_cv(e, s), ctx)
    return _like_cv(e, cv)


def _like_cv(e: E.Like, cv: ColumnVector) -> ColumnVector:
    """LIKE over padded bytes: the pattern's '%'-separated segments matched
    left to right, each at its first position at or after the previous
    one's end; the first anchored at offset 0 unless the pattern starts
    with '%', the last at the string's end unless it ends with '%'. '_'
    is one byte."""
    pat = e.pattern
    anchored_start = not pat.startswith("%")
    anchored_end = not pat.endswith("%")
    segs = [s.encode("utf-8") for s in pat.split("%") if s != ""]
    mat, lens = cv.data, cv.lengths
    cap = mat.shape[0]
    dev = mat.device
    if not segs:  # only '%'s, or the empty pattern
        res = torch.ones(cap, dtype=torch.bool, device=dev) if "%" in pat else lens == 0
    else:
        cur = torch.zeros(cap, dtype=torch.int64, device=dev)
        ok = torch.ones(cap, dtype=torch.bool, device=dev)
        for i, seg in enumerate(segs):
            matches = _segment_match_positions(mat, lens, seg)
            if i == 0 and anchored_start:
                ok = ok & matches[:, 0]
                cur = torch.full((cap,), len(seg), dtype=torch.int64, device=dev)
            else:
                poss = torch.arange(matches.shape[1], device=dev)[None, :]
                avail = matches & (poss >= cur[:, None])
                ok = ok & avail.any(1)
                cur = avail.to(torch.uint8).argmax(1) + len(seg)
        if anchored_end:
            last = segs[-1]
            if len(segs) == 1 and anchored_start:
                ok = ok & (lens == len(last))
            else:  # the last segment also matches at the very end
                end_matches = _segment_match_positions(mat, lens, last)
                end_pos = (lens.long() - len(last)).clamp(min=0)
                at = end_pos.clamp(max=end_matches.shape[1] - 1)[:, None]
                hit_end = end_matches.gather(1, at)[:, 0]
                ok = ok & hit_end & (end_pos + len(last) >= cur)
        res = ok
    if e.negated:
        res = ~res
    return ColumnVector(res, cv.validity, None, T.BOOL)


# -------------------------------------------------------------------------------------
# string functions (exec/string_funcs.py; JAX ``evaluator.py:1614``)
# -------------------------------------------------------------------------------------


_BYTES_FUNCS = ("hex", "unhex", "base64", "unbase64", "encode", "decode", "bin", "conv",
                "crc32", "md5", "sha1", "sha2")


def _string_func(e: E.StringFunc, b: Batch, ctx: EvalContext) -> ColumnVector:
    """A dictionary column with literal arguments: the function over the
    entries, gathered back by code; anything else over the padded bytes."""
    args = [_ev(a, b, ctx) for a in e.args]
    if args and args[0].is_dict and all(isinstance(a, E.Literal) for a in e.args[1:]):
        lits = e.args[1:]
        return _eval_on_dict(
            args[0], lambda s: _string_impl(e, [s] + [_literal(a, s.capacity, s.data.device)
                                                      for a in lits], ctx), ctx)
    args = [_dedict(a) for a in args]
    cap = args[0].capacity
    width = max([a.data.shape[1] for a in args if a.data.dim() == 2]
                + [e.dtype.byte_width if e.dtype.is_binary else 1])
    rows = max(STRING_BLOCK_BYTES // (8 * width), 1)
    if cap <= rows:
        return _string_impl(e, args, ctx)
    # a (rows, width) int64 gather index a byte position (concat, lpad), a
    # dozen (width, rows) tables of the JSON scan: over blocks of rows, so
    # that one stays near STRING_BLOCK_BYTES
    parts = [_string_impl(e, [_slice_rows(a, i, i + rows) for a in args], ctx)
             for i in range(0, cap, rows)]
    lengths = None if parts[0].lengths is None else torch.cat([p.lengths for p in parts])
    return ColumnVector(torch.cat([p.data for p in parts]), torch.cat([p.validity for p in parts]),
                        lengths, parts[0].dtype)


# the bytes of one (rows, width) int64 table a string function may build:
# a column with more rows than fit runs in blocks of rows
STRING_BLOCK_BYTES = 1 << 30


def _slice_rows(cv: ColumnVector, lo: int, hi: int) -> ColumnVector:
    return ColumnVector(cv.data[lo:hi], cv.validity[lo:hi],
                        None if cv.lengths is None else cv.lengths[lo:hi], cv.dtype, None,
                        cv.mag_bound)


def _string_impl(e: E.StringFunc, args: List[ColumnVector], ctx: EvalContext) -> ColumnVector:
    if e.func in _BYTES_FUNCS:
        return _bytes_func(e, args)
    if e.func == "json_array_length":
        from datafusion_comet_tpu_torch.exec.json_path import device_json_array_length

        return device_json_array_length(args[0])
    if e.func == "get_json_object":
        return _get_json_object(e, args[0], ctx)
    return SF.string_func(e, args)


def _null_column(cap: int, dt: T.DataType, dev) -> ColumnVector:
    return ColumnVector(torch.zeros((cap, dt.byte_width), dtype=torch.uint8, device=dev),
                        torch.zeros(cap, dtype=torch.bool, device=dev),
                        torch.zeros(cap, dtype=torch.int32, device=dev), dt)


def _bytes_func(e: E.StringFunc, args: List[ColumnVector]) -> ColumnVector:
    """The bytes family (JAX ``evaluator.py:1634-1714``)."""
    from datafusion_comet_tpu_torch.exec import bytes_funcs as BF

    f, dt, cv = e.func, e.dtype, args[0]
    lit = e.args[1].value if len(e.args) > 1 and isinstance(e.args[1], E.Literal) else None
    if f == "hex":
        data, lens = (BF.hex_of_bytes(cv.data, cv.lengths, dt) if cv.dtype.is_binary
                      else BF.hex_of_int(cv.data, dt))
        return ColumnVector(data, cv.validity, lens, dt)
    if f == "unhex":
        data, lens, invalid = BF.unhex(cv.data, cv.lengths, dt)
        return ColumnVector(data, cv.validity & ~invalid, lens, dt)
    if f == "base64":
        chunk = bool(lit) if len(e.args) > 1 and isinstance(e.args[1], E.Literal) else True
        data, lens = BF.base64_encode(cv.data, cv.lengths, dt, chunk)
        return ColumnVector(data, cv.validity, lens, dt)
    if f == "unbase64":
        data, lens = BF.base64_decode(cv.data, cv.lengths, dt)
        return ColumnVector(data, cv.validity, lens, dt)
    if f in ("encode", "decode"):
        charset = str(lit).lower() if lit is not None else "utf-8"
        if charset.replace("_", "-") not in ("utf-8", "utf8"):
            raise NotImplementedError(
                f"{f} charset {charset!r} (only UTF-8 is byte-identity on the "
                "padded-bytes representation)")
        return ColumnVector(cv.data, cv.validity, cv.lengths, dt)  # UTF-8: the same bytes
    if f == "bin":
        data, lens = BF.bin_of_int(cv.data, dt)
        return ColumnVector(data, cv.validity, lens, dt)
    if f == "conv":
        if not (isinstance(e.args[1], E.Literal) and isinstance(e.args[2], E.Literal)):
            raise NotImplementedError("conv requires literal from/to bases")
        fb, tb = int(e.args[1].value), int(e.args[2].value)
        if not (2 <= fb <= 36 and 2 <= abs(tb) <= 36):
            return _null_column(cv.capacity, dt, cv.data.device)  # Spark: NULL
        data, lens, null_out = BF.conv(cv.data, cv.lengths, fb, tb, dt)
        return ColumnVector(data, cv.validity & ~null_out, lens, dt)
    if f == "crc32":
        return ColumnVector(BF.crc32(cv.data, cv.lengths), cv.validity, None, T.INT64)
    if f in ("md5", "sha1"):
        data, lens = (BF.md5 if f == "md5" else BF.sha1)(cv.data, cv.lengths, dt)
        return ColumnVector(data, cv.validity, lens, dt)
    bits = int(lit) if lit is not None else 256
    if bits not in (0, 224, 256, 384, 512):
        return _null_column(cv.capacity, dt, cv.data.device)  # Spark: NULL
    data, lens = BF.sha2(cv.data, cv.lengths, bits, dt)
    return ColumnVector(data, cv.validity, lens, dt)


def _get_json_object(e: E.StringFunc, cv: ColumnVector, ctx: EvalContext) -> ColumnVector:
    """The device path scan (JAX ``evaluator.py:1720-1738``), or the host
    bridge where the session turned comet.expr.json.deviceEnabled off."""
    from datafusion_comet_tpu_torch.exec.json_path import device_get_json_object, parse_path

    path = e.args[1]
    assert isinstance(path, E.Literal) and path.value is not None
    if not ctx.json_device:
        from datafusion_comet_tpu_torch.exec.batch import nested_from_py, nested_to_py
        from datafusion_comet_tpu_torch.ir.functions import json_path_host

        fn = json_path_host(str(path.value))
        return nested_from_py([fn(v) for v in nested_to_py(cv)], e.dtype, cv.capacity,
                              cv.data.device)
    steps = parse_path(str(path.value))
    if steps is None:
        raise NotImplementedError(
            f"device JSON path: unsupported path {path.value!r} "
            "(use ir.functions.get_json_object host bridge)")
    return device_get_json_object(cv, steps, e.dtype)


def _regex(e, b: Batch, ctx: EvalContext) -> ColumnVector:
    """RLIKE and the three device regexp forms (JAX ``evaluator.py:212-300``),
    a dictionary column over its entries. regexp_extract_all's and
    regexp_replace's overflows are errors in every mode."""
    from datafusion_comet_tpu_torch.exec import regex_extract as RE

    cv = _ev(e.child, b, ctx)
    if isinstance(e, E.RLike):
        from datafusion_comet_tpu_torch.exec.regex_dfa import compile_dfa, dfa_match

        trans, accepting = compile_dfa(e.pattern)

        def small(s: ColumnVector) -> ColumnVector:
            m = dfa_match(s.data, s.lengths, trans, accepting)
            return ColumnVector(~m if e.negated else m, s.validity, None, T.BOOL)
    elif isinstance(e, E.RegexpExtract):
        lp = RE.linearize(e.pattern, e.group_idx)
        if lp is None:
            raise NotImplementedError(
                f"regexp_extract pattern {e.pattern!r} needs the host bridge")

        def small(s: ColumnVector) -> ColumnVector:
            ob, ol, ov = RE.extract_device(s.data, s.lengths, s.validity, lp, e.group_idx,
                                           e.dtype.byte_width)
            return ColumnVector(ob, ov, ol, e.dtype)
    elif isinstance(e, E.RegexpExtractAll):
        lp = RE.linearize(e.pattern, e.group_idx)
        if lp is None or RE.min_match_len(lp) == 0:
            raise NotImplementedError(
                f"regexp_extract_all pattern {e.pattern!r} needs the host bridge")
        E_, w = e.dtype.max_elems, e.dtype.element.byte_width

        def small(s: ColumnVector) -> ColumnVector:
            cnt, eb, el, ev2, ovf = RE.extract_all_device(s.data, s.lengths, s.validity, lp,
                                                          e.group_idx, E_, w)
            ctx.record_error(ovf, f"regexp_extract_all produced more than max_parts={E_} "
                                  "matches")
            elem = ColumnVector(eb, ev2 & s.validity[:, None], el, e.dtype.element)
            return ColumnVector(torch.where(s.validity, cnt, 0), s.validity, None, e.dtype,
                                children=(elem,))
    else:
        lp = RE.linearize(e.pattern, 0)
        if lp is None or RE.min_match_len(lp) == 0:
            raise NotImplementedError(
                f"regexp_replace pattern {e.pattern!r} needs the host bridge")
        repl = e.replacement.encode("utf-8")

        def small(s: ColumnVector) -> ColumnVector:
            ob, ol, ovf = RE.replace_device(s.data, s.lengths, s.validity, lp, repl,
                                            e.dtype.byte_width)
            ctx.record_error(ovf, "regexp_replace output exceeded the declared string width "
                                  f"{e.dtype.byte_width} (pass out_len)")
            return ColumnVector(ob, s.validity, ol, e.dtype)
    return _eval_on_dict(cv, small, ctx) if cv.is_dict else small(cv)


def _split_like(e, b: Batch, ctx: EvalContext) -> ColumnVector:
    """SplitPart, SubstringIndex, Soundex and FormatNumber (JAX
    ``evaluator.py:314-385``), a dictionary column over its entries."""
    cv = _ev(e.child, b, ctx)
    if isinstance(e, E.FormatNumber):
        out, bad = SF.format_number(_dedict(cv), e.decimals, e.dtype)
        ctx.record_error(bad, f"format_number: value does not fit (out_len={e.dtype.byte_width}"
                              " or scaled magnitude beyond int64)")
        return out
    parts = 0 if isinstance(e, E.Soundex) else (e.max_parts or 16)

    def small(s: ColumnVector) -> ColumnVector:
        if isinstance(e, E.Soundex):
            return SF.soundex(s, e.dtype)
        if isinstance(e, E.SplitPart):
            out, ovf, zp = SF.split_part(s, e.delim.encode("utf-8"), e.part, parts, e.dtype)
            ctx.record_error(zp & s.validity, "split_part: part must not be 0")
        else:
            out, ovf = SF.substring_index(s, e.delim.encode("utf-8"), e.count, parts, e.dtype)
        ctx.record_error(ovf, f"{type(e).__name__}: more than {parts} fields (raise max_parts)")
        return out

    return _eval_on_dict(cv, small, ctx) if cv.is_dict else small(cv)


# -------------------------------------------------------------------------------------
# temporal (exec/temporal.py)
# -------------------------------------------------------------------------------------


def _temporal_func(e: E.TemporalFunc, b: Batch, ctx: EvalContext) -> ColumnVector:
    return TM.temporal_func(e, [_dedict(_ev(a, b, ctx)) for a in e.args])


# -------------------------------------------------------------------------------------
# Spark murmur3 (Murmur3_x86_32 hashInt / hashLong / hashUnsafeBytes, seed carried
# column to column)
# -------------------------------------------------------------------------------------
# Each 32-bit word lives in the low half of an int64 as an unsigned value, so
# shifts are logical and no product can overflow: a multiply by a 32-bit
# constant splits it into 16-bit halves.

_M32 = 0xFFFFFFFF


def _mul32(x: torch.Tensor, c: int) -> torch.Tensor:
    lo, hi = c & 0xFFFF, c >> 16
    return (x * lo + (((x * hi) & 0xFFFF) << 16)) & _M32


def _rotl32(x: torch.Tensor, r: int) -> torch.Tensor:
    return ((x << r) | (x >> (32 - r))) & _M32


def _mix_k1(k1: torch.Tensor) -> torch.Tensor:
    return _mul32(_rotl32(_mul32(k1, 0xCC9E2D51), 15), 0x1B873593)


def _mix_h1(h1: torch.Tensor, k1: torch.Tensor) -> torch.Tensor:
    return (_rotl32(h1 ^ k1, 13) * 5 + 0xE6546B64) & _M32


def _fmix(h1: torch.Tensor, length) -> torch.Tensor:
    h1 = h1 ^ length
    h1 = _mul32(h1 ^ (h1 >> 16), 0x85EBCA6B)
    h1 = _mul32(h1 ^ (h1 >> 13), 0xC2B2AE35)
    return h1 ^ (h1 >> 16)


def _u32(x: torch.Tensor) -> torch.Tensor:
    return x.long() & _M32


def _i32(h: torch.Tensor) -> torch.Tensor:
    return torch.where(h >= (1 << 31), h - (1 << 32), h).int()


def murmur3_hash_i32(value: torch.Tensor, seed: torch.Tensor) -> torch.Tensor:
    """Spark hashInt: int32 hashes of int32 values under int32 seeds."""
    return _i32(_fmix(_mix_h1(_u32(seed), _mix_k1(_u32(value))), 4))


def murmur3_hash_i64(value: torch.Tensor, seed: torch.Tensor) -> torch.Tensor:
    """Spark hashLong: the low 32-bit half first, then the high half."""
    v = value.long()
    h1 = _mix_h1(_u32(seed), _mix_k1(v & _M32))
    h1 = _mix_h1(h1, _mix_k1((v >> 32) & _M32))
    return _i32(_fmix(h1, 8))


def murmur3_hash_bytes(mat: torch.Tensor, lens: torch.Tensor, seed: torch.Tensor
                       ) -> torch.Tensor:
    """Spark hashUnsafeBytes of each row's first ``lens`` bytes of ``mat``
    (cap, w): the 4-byte little-endian words, then each tail byte as a
    signed int8 (at most three, in order), then fmix with the length."""
    cap, w = mat.shape
    h1 = _u32(seed).expand(cap)
    lens = lens.long()
    m = mat.long()
    for i in range(w // 4):
        word = m[:, 4 * i] | (m[:, 4 * i + 1] << 8) | (m[:, 4 * i + 2] << 16) \
            | (m[:, 4 * i + 3] << 24)
        h1 = torch.where(4 * (i + 1) <= lens, _mix_h1(h1, _mix_k1(word)), h1)
    tail0 = (lens // 4) * 4
    for t in range(3):
        j = tail0 + t
        byte = m.gather(1, j.clamp(max=max(w - 1, 0)).view(-1, 1))[:, 0] if w else lens * 0
        signed = torch.where(byte >= 128, byte - 256, byte) & _M32
        h1 = torch.where(j < lens, _mix_h1(h1, _mix_k1(signed)), h1)
    return _i32(_fmix(h1, lens))


def _hash_func(e: E.HashFunc, b: Batch, ctx: EvalContext) -> ColumnVector:
    """Spark's hash (murmur3, INT32) or xxhash64 (INT64) of the arguments,
    each hashed into the running seed; never null (JAX ``evaluator.py:2702``)."""
    murmur = e.func == "murmur3"
    if not murmur and e.func != "xxhash64":
        raise NotImplementedError(f"hash {e.func}")
    h = torch.full((b.capacity,), e.seed, dtype=torch.int32 if murmur else torch.int64,
                   device=b.device)
    for a in e.args:
        cv = _ev(a, b, ctx)
        h = murmur3_column(cv, h) if murmur else xxhash64_column(cv, h)
    return ColumnVector(h, torch.ones_like(b.row_mask), None, T.INT32 if murmur else T.INT64)


def murmur3_column(cv: ColumnVector, seed: torch.Tensor) -> torch.Tensor:
    """Hash one column into the running int32 seed; a null leaves the seed
    unchanged (Spark). Ints, dates and bools hash as an int, longs,
    timestamps and decimals of at most 18 digits as a long, strings their
    bytes, floats their bits (JAX ``_murmur3_column``); a wider decimal
    raises NotImplementedError, as there."""
    dt = cv.dtype
    if dt.type_id in ("INT8", "INT16", "INT32", "DATE") or dt.is_boolean:
        h = murmur3_hash_i32(cv.data.int(), seed)
    elif dt.type_id in ("INT64", "TIMESTAMP", "TIMESTAMP_NTZ") or (
            dt.is_decimal and dt.precision <= 18):
        h = murmur3_hash_i64(cv.data, seed)
    elif dt.is_binary:
        cv = _dedict(cv)
        h = murmur3_hash_bytes(cv.data, cv.lengths, seed)
    elif dt.is_floating:
        # the bits, -0.0 hashed as 0.0; a DOUBLE NaN as Java's canonical NaN
        # (doubleToLongBits), a FLOAT NaN with its own bits (JAX
        # ``evaluator.py:2906-2914``)
        d = torch.where(cv.data == 0.0, torch.zeros_like(cv.data), cv.data)
        if dt.type_id == "FLOAT":
            h = murmur3_hash_i32(d.view(torch.int32), seed)
        else:
            bits = torch.where(torch.isnan(d), 0x7FF8000000000000, d.view(torch.int64))
            h = murmur3_hash_i64(bits, seed)
    else:
        raise NotImplementedError(f"murmur3 for {dt!r}")
    return torch.where(cv.validity, h, seed)


# -------------------------------------------------------------------------------------
# Spark xxhash64 (XXH64 hashInt / hashLong / hashUnsafeBytes, JAX
# ``evaluator.py:2717-2858``)
# -------------------------------------------------------------------------------------
# int64 arithmetic wraps mod 2^64 as Java's longs do; a right shift of a
# long is logical (``>>>``), so the sign bits the arithmetic shift copies in
# are masked off.


def _s64(c: int) -> int:
    return c - (1 << 64) if c >= (1 << 63) else c


_XXP1 = _s64(0x9E3779B185EBCA87)
_XXP2 = _s64(0xC2B2AE3D27D4EB4F)
_XXP3 = _s64(0x165667B19E3779F9)
_XXP4 = _s64(0x85EBCA77C2B2AE63)
_XXP5 = _s64(0x27D4EB2F165667C5)


def _lsr64(x: torch.Tensor, r: int) -> torch.Tensor:
    return (x >> r) & ((1 << (64 - r)) - 1)


def _rotl64(x: torch.Tensor, r: int) -> torch.Tensor:
    return (x << r) | _lsr64(x, 64 - r)


def _xx_fmix(h: torch.Tensor) -> torch.Tensor:
    h = (h ^ _lsr64(h, 33)) * _XXP2
    h = (h ^ _lsr64(h, 29)) * _XXP3
    return h ^ _lsr64(h, 32)


def _xx_round(acc: torch.Tensor, inp: torch.Tensor) -> torch.Tensor:
    return _rotl64(acc + inp * _XXP2, 31) * _XXP1


def xxhash64_i32(value: torch.Tensor, seed: torch.Tensor) -> torch.Tensor:
    """Spark XXH64.hashInt: int64 hashes of int32 values under int64 seeds."""
    h = (seed + _XXP5 + 4) ^ ((value.long() & 0xFFFFFFFF) * _XXP1)
    return _xx_fmix(_rotl64(h, 23) * _XXP2 + _XXP3)


def xxhash64_i64(value: torch.Tensor, seed: torch.Tensor) -> torch.Tensor:
    """Spark XXH64.hashLong."""
    h = (seed + _XXP5 + 8) ^ (_rotl64(value.long() * _XXP2, 31) * _XXP1)
    return _xx_fmix(_rotl64(h, 27) * _XXP1 + _XXP4)


def xxhash64_bytes(mat: torch.Tensor, lens: torch.Tensor, seed: torch.Tensor) -> torch.Tensor:
    """Spark XXH64.hashUnsafeBytes of each row's first ``lens`` bytes of
    ``mat`` (cap, w): 32-byte stripes into four accumulators where the row
    has 32 bytes or more, then its 8-byte words, one 4-byte word and its
    tail bytes, little-endian."""
    cap, w = mat.shape
    m = mat.long()
    lens = lens.long()
    seed = seed.long().expand(cap)
    zero = torch.zeros(cap, dtype=torch.int64, device=mat.device)

    def word(j: int, n: int) -> torch.Tensor:  # n bytes from byte j, padding past w
        out = zero
        for k in range(n):
            if j + k < w:
                out = out | (m[:, j + k] << (8 * k))
        return out

    v = [seed + _XXP1 + _XXP2, seed + _XXP2, seed.clone(), seed - _XXP1]
    stripes = zero
    for s in range(w // 32):
        active = (s + 1) * 32 <= lens
        v = [torch.where(active, _xx_round(acc, word(32 * s + 8 * k, 8)), acc)
             for k, acc in enumerate(v)]
        stripes = stripes + active.long()
    h_long = _rotl64(v[0], 1) + _rotl64(v[1], 7) + _rotl64(v[2], 12) + _rotl64(v[3], 18)
    for acc in v:
        h_long = (h_long ^ _xx_round(zero, acc)) * _XXP1 + _XXP4
    long_input = lens >= 32
    h = torch.where(long_input, h_long, seed + _XXP5) + lens
    consumed = torch.where(long_input, stripes * 32, 0)
    for j in range(w // 8):
        active = (8 * j >= consumed) & (8 * j + 8 <= lens)
        h = torch.where(active, _rotl64(h ^ _xx_round(zero, word(8 * j, 8)), 27) * _XXP1 + _XXP4,
                        h)
    consumed = (lens // 8) * 8
    for j in range(w // 4 + 1):
        active = (4 * j == consumed) & (4 * j + 4 <= lens)
        w4 = word(4 * j, 4) if 4 * j + 4 <= w else zero
        h = torch.where(active, _rotl64(h ^ (w4 * _XXP1), 23) * _XXP2 + _XXP3, h)
    consumed = (lens // 4) * 4
    for j in range(w):
        active = (j >= consumed) & (j < lens)
        h = torch.where(active, _rotl64(h ^ (m[:, j] * _XXP5), 11) * _XXP1, h)
    return _xx_fmix(h)


def xxhash64_column(cv: ColumnVector, seed: torch.Tensor) -> torch.Tensor:
    """Hash one column into the running int64 seed (JAX
    ``_xxhash64_column``); a null leaves the seed unchanged. Strings hash
    their bytes (a dictionary column decoded first), ints, dates and bools
    as an int, INT64 and narrow decimals as a long, a FLOAT's bits as an
    int and a DOUBLE's as a long, -0.0 as 0.0 and a DOUBLE NaN as Java's
    canonical NaN (a FLOAT NaN keeps its bits, as in the JAX package); any
    other type raises NotImplementedError, as there."""
    dt = cv.dtype
    seed = seed.long()
    if dt.is_binary:
        cv = _dedict(cv)
        h = xxhash64_bytes(cv.data, cv.lengths, seed)
    elif dt.type_id in ("INT8", "INT16", "INT32", "DATE") or dt.is_boolean:
        h = xxhash64_i32(cv.data.int(), seed)
    elif dt.type_id in ("INT64", "TIMESTAMP", "TIMESTAMP_NTZ"):
        h = xxhash64_i64(cv.data, seed)
    elif dt.type_id == "FLOAT":
        d = torch.where(cv.data == 0.0, torch.zeros_like(cv.data), cv.data)
        h = xxhash64_i32(d.view(torch.int32), seed)
    elif dt.type_id == "DOUBLE":
        d = torch.where(cv.data == 0.0, torch.zeros_like(cv.data), cv.data)
        h = xxhash64_i64(torch.where(torch.isnan(d), 0x7FF8000000000000, d.view(torch.int64)),
                         seed)
    elif dt.is_decimal and dt.precision <= 18:
        h = xxhash64_i64(cv.data, seed)
    else:
        raise NotImplementedError(f"xxhash64 for {dt!r}")
    return torch.where(cv.validity, h, seed)

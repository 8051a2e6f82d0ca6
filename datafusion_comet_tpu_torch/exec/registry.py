"""The operator registry and the per-node config gates (port of
``datafusion_comet_tpu/exec/registry.py``).

- ``OPERATORS`` maps a plan-node class to its executor, with signature
  ``(plan, tables, ctx, conf, fanout) -> Batch``; ``engine.run_plan``
  resolves every node through it, so an extension registers a node of its
  own with ``OPERATORS.register(MyNode)`` and no engine change.
- Every registered operator has the gate
  ``comet.exec.operator.<Op>.enabled`` (the exchange none), and every
  expression node or function the evaluator dispatches on the gate
  ``comet.expr.<name>.enabled``; a cast pair the cast matrix marks
  incompatible is refused unless ``comet.expression.Cast.allowIncompatible``.
  The JAX package keeps the gates in its process-wide config; here they are
  the session's ``Config.gates``, by the same keys. A gate that is off makes
  the plan unsupported: there is no second runtime to fall back to, so
  ``gate_reasons`` gives the strings ``Session.validate`` reports and the
  session raises ``UnsupportedPlanError`` with them.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, List, Optional, Type

from datafusion_comet_tpu_torch.conf import CAST_ALLOW_INCOMPATIBLE, Config
from datafusion_comet_tpu_torch.ir import expr as E
from datafusion_comet_tpu_torch.ir import plan as P

__all__ = ["OPERATORS", "OperatorRegistry", "UnsupportedPlanError", "expression_gate_key",
           "expression_gate", "gate_reasons", "EXPR_GATES"]


class UnsupportedPlanError(NotImplementedError):
    """A plan cannot run: an operator with no executor, or a gate that is
    off. ``reasons`` holds one string per cause (the fallback reasons the
    reference attaches to a Spark plan it cannot convert)."""

    def __init__(self, reasons: List[str]):
        super().__init__("; ".join(reasons))
        self.reasons = list(reasons)


ExecFn = Callable[..., Any]


class OperatorRegistry:
    """Plan-node class -> executor, each with its config gate's key."""

    def __init__(self) -> None:
        self._handlers: Dict[Type[P.PlanNode], ExecFn] = {}
        self._gates: Dict[Type[P.PlanNode], str] = {}

    def register(self, node_type: Type[P.PlanNode], name: Optional[str] = None,
                 gated: bool = True) -> Callable[[ExecFn], ExecFn]:
        op = name or node_type.__name__

        def deco(fn: ExecFn) -> ExecFn:
            self._handlers[node_type] = fn
            if gated:
                self._gates[node_type] = f"comet.exec.operator.{op}.enabled"
            return fn

        return deco

    def resolve(self, node_type: Type[P.PlanNode]) -> ExecFn:
        """The executor of ``node_type`` or of its nearest registered base."""
        for t in node_type.__mro__:
            fn = self._handlers.get(t)
            if fn is not None:
                return fn
        raise UnsupportedPlanError([f"operator {node_type.__name__}: no registered executor"])

    def gate(self, node_type: Type[P.PlanNode]) -> Optional[str]:
        return self._gates.get(node_type)


OPERATORS = OperatorRegistry()

# a function-style node's gate is its function's name (one per kernel the
# evaluator dispatches on, as the reference has one per Spark expression)
_FUNC_NODE_TYPES = (E.StringFunc, E.TemporalFunc, E.MathFunc, E.HashFunc)

# the expression gates (the JAX package's config entries): only these
# names can be turned off
EXPR_GATES = frozenset((
    # structural nodes
    "Cast", "CaseWhen", "InList", "Like", "RLike", "ArrayExpr",
    "StructExpr", "GetStructField", "MapExpr", "BloomMightContain",
    "RandExpr", "MonotonicallyIncreasingId", "SparkPartitionId",
    "PythonUdf", "ScalarSubquery",
    # binary and unary ops
    "add", "sub", "mul", "div", "mod", "pmod", "and", "or", "eq", "ne",
    "eqns", "lt", "le", "gt", "ge", "band", "bor", "bxor", "shiftleft",
    "shiftright", "not", "negate", "isnull", "isnotnull", "isnan", "abs",
    # string functions
    "substring", "upper", "lower", "length", "concat", "trim", "ltrim",
    "rtrim", "startswith", "endswith", "contains", "replace", "lpad",
    "rpad", "ascii", "instr", "repeat", "reverse", "split_part",
    "concat_ws", "translate", "initcap", "octet_length", "bit_length",
    "hex", "unhex", "base64", "unbase64", "encode", "decode", "bin",
    "conv", "md5", "sha1", "sha2", "crc32", "get_json_object",
    # temporal functions
    "year", "month", "day", "quarter", "dayofweek", "dayofyear", "hour",
    "minute", "second", "date_add", "date_sub", "datediff", "trunc_date",
    "last_day", "unix_date", "from_utc_timestamp", "to_utc_timestamp",
    "date_trunc", "unix_timestamp", "timestamp_seconds",
    "timestamp_millis", "timestamp_micros", "unix_micros", "unix_millis",
    "add_months", "months_between", "next_day", "make_date",
    "from_unixtime",
    # math functions
    "round", "floor", "ceil", "sqrt", "exp", "ln", "log10", "log2",
    "pow", "sin", "cos", "tan", "atan", "atan2", "sign", "greatest",
    "least",
    # hash functions
    "murmur3_hash", "xxhash64",
))


def expression_gate(name: str) -> str:
    return f"comet.expr.{name}.enabled"


def expression_gate_key(e: Any) -> Optional[str]:
    """The gate name of a bound expression node (None: an ungated core
    node: column references, literals, aliases)."""
    if isinstance(e, _FUNC_NODE_TYPES):
        return e.func
    if isinstance(e, (E.BoundRef, E.Literal, E.Alias, E.ColumnRef)):
        return None
    if isinstance(e, (E.BinaryOp, E.UnaryOp)):
        return e.op
    return type(e).__name__


def _iter_exprs(value: Any):
    """Every expression reachable from a plan node's field value (tuples,
    the aggregate, window and sort-order specs, nested children)."""
    if isinstance(value, E.Expr):
        yield value
        for c in value.children():
            yield from _iter_exprs(c)
    elif isinstance(value, (E.AggExpr, E.WindowExpr, E.SortOrder)):
        for f in dataclasses.fields(value):
            yield from _iter_exprs(getattr(value, f.name))
    elif isinstance(value, (tuple, list)):
        for v in value:
            yield from _iter_exprs(v)


def _node_exprs(plan: P.PlanNode):
    for f in dataclasses.fields(plan):
        v = getattr(plan, f.name)
        if isinstance(v, P.PlanNode) or (
                isinstance(v, (tuple, list)) and v and isinstance(v[0], P.PlanNode)):
            continue  # the walk visits the children
        yield from _iter_exprs(v)


def gate_reasons(plan: P.PlanNode, conf: Optional[Config] = None) -> List[str]:
    """The reasons a plan is unsupported under ``conf``'s gates (empty: it
    is not), the JAX package's strings (JAX ``registry.py:217-253``)."""
    conf = conf or Config()
    reasons: List[str] = []
    seen_ops, seen_exprs = set(), set()

    def walk(p: P.PlanNode) -> None:
        t = type(p)
        if t not in seen_ops:
            seen_ops.add(t)
            g = OPERATORS.gate(t)
            if g is not None and not conf.gate(g):
                reasons.append(f"operator {t.__name__} disabled by {g}")
        for e in _node_exprs(p):
            key = expression_gate_key(e)
            if key in EXPR_GATES and key not in seen_exprs:
                seen_exprs.add(key)
                g = expression_gate(key)
                if not conf.gate(g):
                    reasons.append(f"expression {key} disabled by {g}")
            if isinstance(e, E.Cast) and not conf.gate(CAST_ALLOW_INCOMPATIBLE):
                frm = e.child.dtype
                if frm is not None and e.to is not None:
                    from datafusion_comet_tpu_torch.exec.cast_matrix import support_for_types

                    lvl, note = support_for_types(frm, e.to)
                    pair = f"cast {frm.type_id}->{e.to.type_id}"
                    if lvl == "incompatible" and pair not in seen_exprs:
                        seen_exprs.add(pair)
                        reasons.append(f"{pair} is Incompatible ({note}); set "
                                       f"{CAST_ALLOW_INCOMPATIBLE}=true to allow")
        for c in p.children():
            walk(c)

    walk(plan)
    return reasons

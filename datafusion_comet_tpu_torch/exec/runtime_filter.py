"""Runtime semi-join filters (the port's own copy of
``datafusion_comet_tpu/exec/runtime_filter.py``, the bloom-filter join
pushdown analog).

A selective dimension chain (Scan -> Filter / Projection over a small
registered table) is evaluated on the host at plan time
(exec/host_filter.py); its surviving join keys are registered as a constant
key table (``__rf_<hash>``, statistics included, on the session's device);
and a LEFT_SEMI join against that table is pushed down the fact side of the
INNER join, to just above the scan that sources its key. The key set is
small with an exact range (``rf_dense_range``), so the injected join takes
the membership bitmap (operators/join.py), and the engine compacts its
output to twice its row estimate where that cuts the capacity at least 8x:
the operators above then run at the thinned size.

Safety: the filter only removes rows whose key cannot match the dimension
side of the equi-join chain (equality carried through INNER and LEFT_SEMI
join keys), so results are unchanged. Only an INNER join plants one; on its
way down it passes an INNER, LEFT_SEMI, LEFT_ANTI or LEFT join (below a
LEFT join's preserved side, the rows it removes are the INNER join's above
to drop) and stops above a RIGHT or FULL join, as the JAX injector does.

Gates, the JAX package's: the fact side's scan has at least 65,536 rows
(``_MIN_TARGET_ROWS``); the dimension table's capacity is at most 2^22
(``_MAX_DIM_CAPACITY``); at most 2^20 keys survive (``_MAX_KEYS``); the
keys are at most an eighth of the fact key's domain (``_MIN_REDUCTION``,
the default of the JAX package's ``comet.exec.runtimeFilter.minReduction``).
One filter per source scan (the most selective) and one per join.
"""

from __future__ import annotations

import copy
import dataclasses
import hashlib
import weakref
from typing import Dict, List, Optional, Set, Tuple

import numpy as np

from datafusion_comet_tpu_torch import types as T
from datafusion_comet_tpu_torch.exec.host_filter import HostColumns, eval_dim_filter
from datafusion_comet_tpu_torch.ir import expr as E
from datafusion_comet_tpu_torch.ir import plan as P

__all__ = ["inject_runtime_filters", "injected_filters"]

_MIN_TARGET_ROWS = 65536  # fact sides below this are not filtered
_MAX_DIM_CAPACITY = 1 << 22  # the largest dimension table evaluated on the host
_MAX_KEYS = 1 << 20  # larger key sets are not worth a semi join
_MIN_REDUCTION = 8  # the least cut of the fact key's domain worth a filter

# per registered batch's host columns (an entry dies with them): under
# (repr(filters), key column), the sorted distinct keys that pass and the
# name of their key table, or None where no conjunct could run on the host
_KEY_SETS: "weakref.WeakKeyDictionary[HostColumns, dict]" = weakref.WeakKeyDictionary()

_SEMI_ANTI = (P.JoinType.LEFT_SEMI, P.JoinType.LEFT_ANTI, P.JoinType.LEFT_ANTI_NULL_AWARE)


def inject_runtime_filters(plan: P.PlanNode, session) -> P.PlanNode:
    """A rewritten copy of the unbound, pruned ``plan`` with runtime
    semi-join filters injected where profitable; ``session`` gives the
    registered tables and statistics and receives the key tables.

    Two phases: every candidate (join, side) is planned without changing
    the tree, and at most one filter, the most selective, is approved per
    source scan and per join; then the tree is rebuilt bottom-up with the
    approved ones. The approval rides a node attribute, cleared after."""
    if not session.conf.runtime_filter_enabled:
        return plan
    cands: List[Tuple[P.PlanNode, str, "_RF", int]] = []
    _collect(plan, session, cands)
    best: Dict[int, Tuple[P.PlanNode, str, "_RF"]] = {}
    for join, side, rf, scan_key in cands:
        cur = best.get(scan_key)
        if cur is None or rf.est_ratio < cur[2].est_ratio:
            best[scan_key] = (join, side, rf)
    for join, side, rf in best.values():
        approved = getattr(join, "_rf_approved", None) or {}
        keep = min(list(approved.items()) + [(side, rf)], key=lambda kv: kv[1].est_ratio)
        join._rf_approved = dict([keep])
    out = _rewrite(plan, session)
    for join, _side, _rf in best.values():
        if getattr(join, "_rf_approved", None) is not None:
            join._rf_approved = None
    return out


def injected_filters(session) -> List[dict]:
    """The runtime filters of the session's last planned query: per
    injected join, in plan order, its key table, key count, key range and
    row estimate."""
    out, stack = [], [p for _, p in reversed(session.stages)]
    while stack:
        p = stack.pop()
        if isinstance(p, P.HashJoin) and p.rf_injected:
            out.append({"table": p.right.table, "keys": session.stats[p.right.table].rows,
                        "range": list(p.rf_dense_range), "out_rows_hint": p.out_rows_hint})
        stack.extend(reversed(p.children()))
    return out


def _collect(p: P.PlanNode, session, out: List) -> None:
    for c in p.children():
        _collect(c, session, out)
    if not (isinstance(p, P.HashJoin) and p.join_type == P.JoinType.INNER):
        return
    if len(p.left_keys) != 1 or len(p.right_keys) != 1:
        return
    lk, rk = _src_col(p.left_keys[0]), _src_col(p.right_keys[0])
    if lk is None or rk is None:
        return
    for target, tkey, other, okey, side in ((p.left, lk, p.right, rk, "left"),
                                            (p.right, rk, p.left, lk, "right")):
        rf = _plan_filter(target, tkey, other, okey, session)
        if rf is None:
            continue
        scan = _source_scan(target, tkey)
        if scan is None:
            continue
        out.append((p, side, rf, id(scan)))


def _source_scan(p: P.PlanNode, col: str) -> Optional[P.Scan]:
    """The one scan inside ``p`` that sources ``col`` (the key of the
    per-scan approval), or None where there are several."""
    hits: List[P.Scan] = []

    def walk(q):
        if isinstance(q, P.Scan):
            if any(f.name == col for f in q.out_schema().fields):
                hits.append(q)
            return
        for c in q.children():
            walk(c)

    walk(p)
    return hits[0] if len(hits) == 1 else None


def _rewrite(p: P.PlanNode, session) -> P.PlanNode:
    for c in p.children():
        new = _rewrite(c, session)
        if new is not c:
            p = _swap_child(p, c, new)
    if isinstance(p, P.HashJoin) and p.join_type == P.JoinType.INNER:
        p = _try_filter_join(p, session)
    return p


def _swap_child(p: P.PlanNode, old: P.PlanNode, new: P.PlanNode) -> P.PlanNode:
    cp = copy.copy(p)
    cp.schema = None  # its children changed: bound again later
    for f in dataclasses.fields(cp):
        v = getattr(cp, f.name, None)
        if v is old:
            setattr(cp, f.name, new)
        elif isinstance(v, tuple) and any(x is old for x in v):
            setattr(cp, f.name, tuple(new if x is old else x for x in v))
    return cp


def _try_filter_join(j: P.HashJoin, session) -> P.HashJoin:
    approved = getattr(j, "_rf_approved", None)
    if not approved:
        return j
    out = j
    for side, rf in approved.items():
        target = j.left if side == "left" else j.right
        tkey = _src_col((j.left_keys if side == "left" else j.right_keys)[0])
        if tkey is None:
            continue
        new_target = _push_semi(target, tkey, rf, session)
        if new_target is None:
            continue
        out = _swap_child(out, target, new_target)
        # the join's own estimate: the dimension's selectivity is applied
        # inside the filtered side already, so the fact rows times the ratio
        # (the stats walk keeps a hint set here)
        if out.out_rows_hint is None:
            trows = _subtree_scan_rows(target, tkey, session)
            if trows:
                out.out_rows_hint = max(int(trows * rf.est_ratio), 1)
        break  # one filter per join
    if getattr(out, "_rf_approved", None) is not None:
        out._rf_approved = None
    return out


# -- dimension discovery ---------------------------------------------------------


def _src_col(e: E.Expr) -> Optional[str]:
    while isinstance(e, (E.Alias, E.Cast)):
        e = e.child
    if isinstance(e, (E.ColumnRef, E.BoundRef)):
        return e.col_name
    return None


def _out_names(p: P.PlanNode) -> Optional[Set[str]]:
    """Output column names of an (unbound) subtree; None where unknown."""
    if p.schema is not None:
        return {f.name for f in p.schema.fields}
    if isinstance(p, P.Scan):
        return {f.name for f in p.out_schema().fields}
    if isinstance(p, (P.Filter, P.Sort, P.Limit, P.Sample, P.ShuffleExchange)):  # JAX :208
        return _out_names(p.children()[0])
    if isinstance(p, P.Projection):
        return {e.name for e in p.exprs}
    if isinstance(p, P.HashAggregate):
        return {g.name for g in p.group_exprs} | {a.out_name for a in p.agg_exprs}
    if isinstance(p, P.EQUI_JOINS):  # JAX :220
        if p.join_type in _SEMI_ANTI:
            return _out_names(p.left)
        l, r = _out_names(p.left), _out_names(p.right)
        if l is None or r is None:
            return None
        return l | r
    return None


def _dim_sources(p: P.PlanNode, col: str, out: List[Tuple[P.PlanNode, str]],
                 depth: int = 0) -> None:
    """The (subtree, column) sites whose column equals ``col`` in ``p``'s
    output, through projection renames and INNER / LEFT_SEMI key equality."""
    if depth > 32:
        return
    out.append((p, col))
    if isinstance(p, (P.Filter, P.Sort, P.Limit)):
        _dim_sources(p.children()[0], col, out, depth + 1)
    elif isinstance(p, P.Projection):
        for e in p.exprs:
            if e.name == col:
                src = _src_col(e)
                if src:
                    _dim_sources(p.child, src, out, depth + 1)
                break
    elif isinstance(p, P.EQUI_JOINS):  # JAX :252
        sides = [(p.left, p.left_keys, p.right, p.right_keys)]
        if p.join_type not in _SEMI_ANTI + (P.JoinType.EXISTENCE,):
            sides.append((p.right, p.right_keys, p.left, p.left_keys))
        for side, keys, oside, okeys in sides:
            names = _out_names(side)
            if names is not None and col in names:
                _dim_sources(side, col, out, depth + 1)
                # INNER and LEFT_SEMI keep key-equal rows only: the equality
                # carries to the other side's key
                if p.join_type in (P.JoinType.INNER, P.JoinType.LEFT_SEMI):
                    for k, ok in zip(keys, okeys):
                        if _src_col(k) == col:
                            okc = _src_col(ok)
                            if okc:
                                _dim_sources(oside, okc, out, depth + 1)
                break


def _dim_chain(p: P.PlanNode, col: str):
    """(scan, filters, the column's name at the scan) where ``p`` is a
    Scan -> (Filter | Projection)* chain exposing ``col``; else None."""
    filters: List[E.Expr] = []
    cur, name = p, col
    for _ in range(16):
        if isinstance(cur, P.Scan):
            if any(f.name == name for f in cur.out_schema().fields):
                return cur, filters, name
            return None
        if isinstance(cur, P.Filter):
            filters.append(cur.predicate)
            cur = cur.child
            continue
        if isinstance(cur, P.Projection):
            nxt = None
            for e in cur.exprs:
                if e.name == name:
                    nxt = _src_col(e)
            if nxt is None:
                return None
            name = nxt
            cur = cur.child
            continue
        return None
    return None


# -- planning --------------------------------------------------------------------


@dataclasses.dataclass
class _RF:
    table: str  # the registered key table
    col: str  # its one column
    keys: np.ndarray
    lo: int
    hi: int
    est_ratio: float  # the estimated surviving share of the fact side


def _plan_filter(target: P.PlanNode, tkey: str, other: P.PlanNode, okey: str,
                 session) -> Optional[_RF]:
    """A selective dimension source of ``okey`` on the other side, evaluated
    on the host and gated on its estimated reduction."""
    trows = _subtree_scan_rows(target, tkey, session)
    if trows is None or trows < _MIN_TARGET_ROWS:
        return None
    sites: List[Tuple[P.PlanNode, str]] = []
    _dim_sources(other, okey, sites)
    seen: Set[int] = set()
    for sub, col in sites:
        if id(sub) in seen:
            continue
        seen.add(id(sub))
        chain = _dim_chain(sub, col)
        if chain is None:
            continue
        scan, filters, key_at_scan = chain
        if not filters:
            continue  # no selectivity without a filter
        batch = session.tables.get(scan.table)
        if batch is None or batch.capacity > _MAX_DIM_CAPACITY:
            continue
        hit = _dim_keys(session, scan.table, filters, key_at_scan)
        if hit is None or len(hit[0]) == 0 or len(hit[0]) > _MAX_KEYS:
            continue
        keys, name = hit
        lo, hi = int(keys.min()), int(keys.max())
        # the surviving share of the fact side: keys over the key domain's
        # span (the exact column range where statistics have it)
        domain = _key_domain(target, tkey, session)
        if domain is None:
            st = session.stats.get(scan.table)
            if st is not None and key_at_scan in st.ranges:
                dlo, dhi = st.ranges[key_at_scan]
                domain = dhi - dlo + 1
        if domain is None or domain <= 0:
            continue
        ratio = len(keys) / domain
        if ratio * _MIN_REDUCTION > 1.0:
            continue
        _register_keys(session, name, keys, batch.schema.field(key_at_scan).dtype)
        return _RF(name, f"__rfk_{name[5:]}", keys, lo, hi, ratio)
    return None


def _dim_keys(session, table: str, filters: List[E.Expr], key: str
              ) -> Optional[Tuple[np.ndarray, str]]:
    """The distinct keys of the dimension rows that pass ``filters`` and the
    name of their key table, or None where no conjunct could run on the
    host. Kept in ``_KEY_SETS`` under the filters' structure (their repr),
    so a plan that repeats them evaluates nothing again; the batch is
    immutable, so the keys are those a new evaluation would give."""
    cols = session.host_columns(table)
    memo = _KEY_SETS.setdefault(cols, {})
    at = (repr(filters), key)
    if at not in memo:
        try:
            mask, applied = eval_dim_filter(cols.batch, filters, cols)
        except Exception:  # a conjunct the host cannot run: no filter from this site
            mask, applied = None, False
        keys = _key_values(cols, key, mask) if applied else None
        memo[at] = None if keys is None else (keys, _key_table_name(table, key, keys))
    return memo[at]


def _key_domain(target: P.PlanNode, col: str, session) -> Optional[int]:
    """The span of ``col``'s values at its one source scan inside the
    target (a foreign key's span is about its distinct count)."""
    hits: List[Tuple[int, int]] = []

    def walk(p):
        if isinstance(p, P.Scan):
            st = session.stats.get(p.table)
            if st is not None and col in st.ranges and \
                    any(f.name == col for f in p.out_schema().fields):
                hits.append(st.ranges[col])
            return
        for c in p.children():
            walk(c)

    walk(target)
    if len(hits) != 1:
        return None
    lo, hi = hits[0]
    return hi - lo + 1


def _subtree_scan_rows(p: P.PlanNode, col: str, session) -> Optional[int]:
    """Rows of the largest scan inside ``p`` that sources ``col``."""
    best: List[int] = []

    def walk(q):
        if isinstance(q, P.Scan):
            if any(f.name == col for f in q.out_schema().fields):
                st = session.stats.get(q.table)
                b = session.tables.get(q.table)
                if st is not None:
                    best.append(st.rows)
                elif b is not None:
                    best.append(b.capacity)
            return
        for c in q.children():
            walk(c)

    walk(p)
    return max(best) if best else None


def _key_values(cols, col: str, mask: np.ndarray) -> Optional[np.ndarray]:
    """The distinct valid keys of the rows in ``mask``, sorted, as int64;
    None for a column that is not a plain integer or date."""
    try:
        cv = cols.batch.columns[cols.batch.schema.index_of(col)]
    except (KeyError, ValueError):
        return None
    if cv.is_dict or not (cv.dtype.is_integer or cv.dtype.type_id == "DATE"):
        return None
    hc = cols.get(col)
    return np.unique(hc.vals[mask & hc.valid].astype(np.int64))


def _key_table_name(dim_table: str, dim_col: str, keys: np.ndarray) -> str:
    """The key table's name, from its content: ``__rf_<sha1 prefix>``."""
    h = hashlib.sha1()
    h.update(dim_table.encode())
    h.update(dim_col.encode())
    h.update(keys.tobytes())
    return f"__rf_{h.hexdigest()[:12]}"


def _register_keys(session, name: str, keys: np.ndarray, dtype: T.DataType) -> None:
    """Register the key set as the one-column table ``name`` (one already
    registered under that name is reused)."""
    if name in session.tables:
        return
    col = f"__rfk_{name[5:]}"
    schema = T.Schema([T.Field(col, dtype, nullable=False)])
    session.register_numpy(name, {col: keys.astype(np.int64)}, schema)


# -- push-down -------------------------------------------------------------------


def _nondeterministic(e: Optional[E.Expr]) -> bool:
    """Whether an expression draws rand()/randn() or reads a row's
    position, which a filter below it would change."""
    if e is None:
        return False
    if isinstance(e, (E.RandExpr, E.MonotonicallyIncreasingId)):
        return True
    return any(_nondeterministic(c) for c in e.children())


def _push_semi(p: P.PlanNode, col: str, rf: _RF, session) -> Optional[P.PlanNode]:
    """The semi join against the key table inserted as low as ``col`` flows
    unchanged: a new tree, shared nodes untouched. It stays above a Filter
    or Projection that draws rand() or reads row positions (their values
    follow the live rows below them)."""
    if (isinstance(p, P.Filter) and _nondeterministic(p.predicate)) or (
            isinstance(p, P.Projection) and any(_nondeterministic(x) for x in p.exprs)):
        return None
    if isinstance(p, (P.Filter, P.Sort, P.Limit)):
        sub = _push_semi(p.children()[0], col, rf, session)
        if sub is None:
            return _attach(p, col, rf, session)
        return _swap_child(p, p.children()[0], sub)
    if isinstance(p, P.Projection):
        src = None
        for e in p.exprs:
            if e.name == col:
                src = _src_col(e)
        if src:
            sub = _push_semi(p.child, src, rf, session)
            if sub is not None:
                return _swap_child(p, p.child, sub)
        return _attach(p, col, rf, session)
    if isinstance(p, P.HashAggregate):
        for g in p.group_exprs:
            if g.name == col:
                src = _src_col(g)
                if src:
                    sub = _push_semi(p.child, src, rf, session)
                    if sub is not None:
                        return _swap_child(p, p.child, sub)
        return _attach(p, col, rf, session)
    if isinstance(p, P.EQUI_JOINS):  # JAX :484
        semi_like = p.join_type in _SEMI_ANTI + (P.JoinType.EXISTENCE,)
        for side in ((p.left,) if semi_like else (p.left, p.right)):
            names = _out_names(side)
            if names is not None and col in names:
                # below INNER, LEFT_SEMI, LEFT_ANTI and a LEFT join's probe
                # side: a row removed there cannot come back as nulls
                if p.join_type in (P.JoinType.INNER, P.JoinType.LEFT_SEMI, P.JoinType.LEFT,
                                   P.JoinType.LEFT_ANTI):
                    sub = _push_semi(side, col, rf, session)
                    if sub is not None:
                        return _swap_child(p, side, sub)
                break
        return _attach(p, col, rf, session)
    return _attach(p, col, rf, session)


def _attach(p: P.PlanNode, col: str, rf: _RF, session) -> Optional[P.PlanNode]:
    names = _out_names(p)
    if names is None or col not in names:
        return None
    build = P.Scan(rf.table, session.tables[rf.table].schema)
    j = P.HashJoin(p, build, (E.ColumnRef(col),), (E.ColumnRef(rf.col),),
                   P.JoinType.LEFT_SEMI, "right")
    j.rf_dense_range = (rf.lo, rf.hi)
    # a bitmap semi join is one scatter and one gather: it does not count
    # toward the stage split's joins (engine._count_joins)
    j.rf_injected = True
    rows = _subtree_scan_rows(p, col, session)
    if rows:
        j.out_rows_hint = max(int(rows * rf.est_ratio), 1)
    return j

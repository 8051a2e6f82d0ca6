"""PyTorch port, COUNT(DISTINCT) (``ir/plan.py::_rewrite_distinct``) and the
group-only aggregate it rewrites into, exactly against the JAX package:

- the rewritten trees, grouped and ungrouped: a group-only aggregate over
  (groups, x), then COUNT(x) per group over it, node for node (modes, keys,
  aggregates, capacities, output schemas);
- results through the ``Session`` with null inputs and dead rows, grouped
  by a dictionary-coded key (the dense path), by an int64 key (the sorted
  path) and ungrouped, against the JAX ``Session`` and a Python oracle;
- the refusals: a DISTINCT beside a plain aggregate, and two different
  DISTINCT inputs, raise NotImplementedError in both packages;
- ``hash_aggregate`` with no aggregate expression, on the dense and the
  sorted path, against the JAX ``hash_aggregate``: values, validity,
  storage and bounds of the key columns."""

import numpy as np
import pytest

from datafusion_comet_tpu.exec.engine import Session as JaxSession
from datafusion_comet_tpu_torch.exec.engine import Session
from test_torch_minmax import PKG, _assert_same, _batch, _schema, _table
from test_torch_q9 import one_torch_thread  # noqa: F401 (a fixture)

pytestmark = pytest.mark.usefixtures("one_torch_thread")

KEYS = {"dense": ("k",), "sorted": ("a",), "ungrouped": ()}


def _plan(pkg, keys, aggs):
    M, _, E, P = PKG[pkg][:4]
    scan = P.Scan("t", _schema(M))
    return P.HashAggregate(scan, tuple(E.col(k) for k in keys),
                           tuple(E.AggExpr(f, E.col(c), o) for f, c, o in aggs))


def _tree(p, P):
    """Each node, top-down: its type, mode, keys, aggregates, group
    capacity and output fields."""
    out = []
    while True:
        row = [type(p).__name__, [(f.name, f.dtype.type_id, f.nullable) for f in p.schema.fields]]
        if isinstance(p, P.HashAggregate):
            row += [p.mode, [g.name for g in p.group_exprs],
                    [(a.func, a.out_name, a.child.name) for a in p.agg_exprs], p.max_groups]
        out.append(row)
        if isinstance(p, P.Scan):
            return out
        (p,) = p.children()


@pytest.mark.parametrize("path", sorted(KEYS))
def test_rewrite_trees_match_jax(path):
    aggs = [("count_distinct", "i", "di"), ("count_distinct", "i", "di2")]
    trees = {pkg: _tree(PKG[pkg][3].bind_plan(_plan(pkg, KEYS[path], aggs)), PKG[pkg][3])
             for pkg in PKG}
    assert trees["port"] == trees["jax"]
    top, inner = trees["port"][0], trees["port"][1]
    assert top[4] == [("count", "di", "__distinct_key"), ("count", "di2", "__distinct_key")]
    assert inner[3] == list(KEYS[path]) + ["__distinct_key"] and inner[4] == []


def _oracle(data, validity, mask, keys, col):
    """{group: distinct non-null values of ``col``} over the live rows."""
    out = {}
    for i in np.flatnonzero(mask):
        g = tuple(data[k][i] for k in keys)
        vals = out.setdefault(g, set())
        if validity[col][i]:
            vals.add(int(data[col][i]))
    return {g: len(v) for g, v in out.items()}


@pytest.mark.parametrize("col", ["i", "v"])
@pytest.mark.parametrize("path", sorted(KEYS))
def test_count_distinct_matches_jax_and_oracle(path, col):
    """Nulls are no value (a group of only nulls counts 0), dead rows are
    no row; the dictionary key's groups, the int64 key's and ungrouped."""
    data, validity, mask = _table(3000, 200, seed=4)
    keys = KEYS[path]
    data = dict(data, live=mask.astype(np.int32))  # the dead rows: a filter drops them
    outs = {}
    for pkg, S in (("jax", JaxSession), ("port", Session)):
        M, _, E, P = PKG[pkg][:4]
        schema = M.Schema(list(_schema(M).fields) + [M.Field("live", M.INT32)])
        s = S() if pkg == "jax" else S(device="cpu")
        s.register_numpy("t", data, schema, validity=validity)
        plan = P.HashAggregate(P.Scan("t", schema).filter(E.col("live") == E.lit(1)),
                               tuple(E.col(k) for k in keys),
                               (E.AggExpr("count_distinct", E.col(col), "nd"),))
        outs[pkg] = s.collect(plan)
    assert list(outs["port"]) == list(outs["jax"])
    for k in outs["jax"]:
        assert outs["port"][k].dtype == outs["jax"][k].dtype, k
        np.testing.assert_array_equal(outs["port"][k], outs["jax"][k], err_msg=k)
    got = {tuple(outs["port"][k][i] for k in keys): int(outs["port"]["nd"][i])
           for i in range(len(outs["port"]["nd"]))}
    want = _oracle(data, validity, mask, keys, col)
    assert got == want
    if keys:
        assert min(got.values()) == 0  # the group whose values are all null


@pytest.mark.parametrize("aggs,match", [
    ([("count_distinct", "i", "di"), ("sum", "l", "sl")], "mixed DISTINCT and plain"),
    ([("count_distinct", "i", "di"), ("count_distinct", "l", "dl")], "different DISTINCT"),
])
def test_unsupported_distinct_shapes_raise_in_both(aggs, match):
    for pkg in PKG:
        with pytest.raises(NotImplementedError, match=match):
            PKG[pkg][3].bind_plan(_plan(pkg, ("k",), aggs))


@pytest.mark.parametrize("keys", [("k",), ("a",), ("k", "i"), ("a", "v"), ("d", "w")])
def test_group_only_aggregate_matches_jax(keys):
    """No aggregate expression: the distinct key tuples of the live rows,
    on the dense path (a dictionary key) and the sorted path (the others),
    null keys a group of their own."""
    data, validity, mask = _table(3000, 200, seed=5)
    outs = {}
    for pkg in PKG:
        M, _, E, P, AGG, Ctx = PKG[pkg]
        batch = _batch(pkg, data, validity, mask)
        node = P.bind_plan(P.HashAggregate(P.Scan("t", batch.schema),
                                           tuple(E.col(k) for k in keys), ()))
        ctx = Ctx(overflow_flags=[])
        if pkg == "jax":
            outs[pkg] = AGG.hash_aggregate(batch, node.group_exprs, (), "single", 1 << 12,
                                           node.schema, ctx)
        else:
            outs[pkg] = AGG.hash_aggregate(batch, node.group_exprs, (), "single", node.schema,
                                           ctx, max_groups=1 << 12)
    _assert_same(outs["jax"], outs["port"])
    live = int(outs["port"].row_mask.sum())
    assert live == len({tuple(data[k][i] if k not in validity or validity[k][i] else None
                              for k in keys) for i in np.flatnonzero(mask)})

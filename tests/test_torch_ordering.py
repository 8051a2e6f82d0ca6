"""PyTorch port, the sort elision (``ir/ordering.py`` and
``engine.apply_orderings``, the Sort branch of the JAX package's
``_apply_orderings``) against the JAX package:

- every ported TPC-H query at SF 0.01 with the default staging: the same
  values and order, and each output column's storage (narrow or two-limb)
  and magnitude bound (Q1's sums and averages keep their bounds now that
  its Sort is gone, as in the JAX package);
- every stage of every query planned to the same tree: a root Sort that
  its aggregate already satisfies is dropped, or becomes a Limit where it
  has a fetch or a skip, in both packages alike;
- on small plans: a Sort by the group keys (with and without fetch and
  skip, through a projection's alias) is elided; descending, a non-key
  prefix, a nullable key asking nulls first, and a PARTIAL aggregate keep
  their Sort."""

import numpy as np
import pytest

from datafusion_comet_tpu import types as JT
from datafusion_comet_tpu.exec import batch as JB
from datafusion_comet_tpu.exec.engine import Session as JaxSession
from datafusion_comet_tpu.exec.engine import _apply_orderings as jax_apply_orderings
from datafusion_comet_tpu.ir import expr as JE
from datafusion_comet_tpu.ir import plan as JP
from datafusion_comet_tpu.models import tpch as JTPCH
from datafusion_comet_tpu_torch import types as PT
from datafusion_comet_tpu_torch.exec import batch as PB
from datafusion_comet_tpu_torch.exec.engine import Session, apply_orderings
from datafusion_comet_tpu_torch.ir import expr as PE
from datafusion_comet_tpu_torch.ir import plan as PP
from datafusion_comet_tpu_torch.models import tpch
from _torch_threads import one_torch_thread  # noqa: F401 (a fixture)

pytestmark = pytest.mark.usefixtures("one_torch_thread")

NAMES = ("lineitem", "orders", "customer", "supplier", "nation", "region")


@pytest.fixture(scope="module")
def sessions():
    data = tpch.generate_tables(NAMES, 0.01)
    js, ps = JaxSession(), Session(device="cpu")
    for t in NAMES:
        js.register_numpy(t, data[t], JTPCH.SCHEMAS[t])
        ps.register_numpy(t, data[t], tpch.SCHEMAS[t])
    return js, ps


def tree(plan):
    """A plan's shape: node type (a Limit with its limit and offset, a Sort
    with its fetch and skip) and its children's shapes."""
    own = type(plan).__name__
    if own == "Limit":
        own = (own, plan.limit, plan.offset)
    elif own == "Sort":
        own = (own, plan.fetch, plan.skip)
    return (own,) + tuple(tree(c) for c in plan.children())


def _types(shape):
    own = shape[0] if isinstance(shape[0], str) else shape[0][0]
    return [own] + [t for c in shape[1:] for t in _types(c)]


@pytest.mark.parametrize("q", ["q1", "q3", "q4", "q5", "q6", "q12", "q15"])
def test_outputs_keep_jax_storage_and_bounds(sessions, q):
    js, ps = sessions
    jb, pb = js.execute(getattr(JTPCH, q)()), ps.execute(getattr(tpch, q)())
    want, got = JB.to_numpy(jb), PB.to_numpy(pb)
    assert list(want) == list(got)
    for k in want:
        assert want[k].dtype == got[k].dtype, k
        np.testing.assert_array_equal(want[k], got[k], err_msg=k)
    for jc, pc, f in zip(jb.columns, pb.columns, pb.schema.fields):
        assert np.asarray(jc.data).ndim == pc.data.dim(), f.name
        assert jc.mag_bound == pc.mag_bound, f.name
    if q == "q1":  # the aggregate's bounds reach the output
        bounds = {f.name: c.mag_bound for f, c in zip(pb.schema.fields, pb.columns)}
        assert bounds["sum_qty"] == 999_999_999
        assert bounds["avg_price"] == 99_999_999_999_999_999


@pytest.mark.parametrize("q", list(tpch.QUERIES))
def test_stages_plan_to_the_same_trees(sessions, q):
    js, ps = sessions
    want = js._plan_stages(getattr(JTPCH, q)())
    got = ps._plan_stages(tpch.QUERIES[q]())
    assert [(n is None, tree(p)) for n, p in got] == [(n is None, tree(p)) for n, p in want]
    sorts = [t for _, p in got for t in _types(tree(p)) if t == "Sort"]
    # Q1, Q4 and Q12 sort by their group keys: no Sort is left (Q6, Q14,
    # Q17 and Q19 have none)
    assert bool(sorts) == (q not in ("q1", "q4", "q6", "q12", "q14", "q17", "q19"))


def _agg(M, P, E, nullable: bool):
    schema = M.Schema([M.Field("g", M.INT64, nullable), M.Field("h", M.string(3), False),
                       M.Field("v", M.INT64, False)])
    return P.Scan("t", schema).aggregate([E.col("g"), E.col("h")],
                                          [E.AggExpr("sum", E.col("v"), "s")])


CASES = {
    # (sort orders, fetch, skip, nullable keys, project first): elided?
    "keys": ((("g", True, None), ("h", True, None)), None, 0, False, False),
    "prefix_fetch": ((("g", True, None),), 5, 0, False, False),
    "prefix_skip": ((("g", True, None),), None, 3, False, False),
    "fetch_skip": ((("g", True, None), ("h", True, None)), 4, 2, False, False),
    "alias": ((("gg", True, None),), None, 0, False, True),
    "descending": ((("g", False, None),), None, 0, False, False),
    "second_key_first": ((("h", True, None),), None, 0, False, False),
    "aggregate_value": ((("s", True, None),), 3, 0, False, False),
    "nullable_nulls_first": ((("g", True, None),), None, 0, True, False),
    "nullable_nulls_last": ((("g", True, False),), None, 0, True, False),
}


def _case_plan(M, P, E, case):
    orders, fetch, skip, nullable, project = CASES[case]
    plan = _agg(M, P, E, nullable)
    if project:
        plan = plan.project([E.col("g").alias("gg"), E.col("h"), E.col("s")])
    s = P.Sort(plan, tuple(E.SortOrder(E.col(c), asc, nf) for c, asc, nf in orders), fetch)
    s.skip = skip
    return P.bind_plan(s)


@pytest.mark.parametrize("case", list(CASES))
def test_sort_elision_cases_match_jax(case):
    got = tree(apply_orderings(_case_plan(PT, PP, PE, case)))
    want = tree(jax_apply_orderings(_case_plan(JT, JP, JE, case)))
    assert got == want
    elided = case in ("keys", "prefix_fetch", "prefix_skip", "fetch_skip", "alias",
                      "nullable_nulls_last")
    assert ("Sort" not in _types(got)) == elided
    if case == "fetch_skip":
        assert got[0] == ("Limit", 4, 2)


def test_partial_aggregate_keeps_its_sort():
    """Only a SINGLE or FINAL aggregate's output is in key order."""
    agg = _agg(PT, PP, PE, False)
    partial = PP.HashAggregate(agg.child, agg.group_exprs, agg.agg_exprs, PP.AggMode.PARTIAL)
    plan = PP.bind_plan(PP.Sort(partial, (PE.SortOrder(PE.col("g")),)))
    assert isinstance(apply_orderings(plan), PP.Sort)
    assert apply_orderings(plan) is plan  # nothing to drop: the same tree

"""PyTorch port, staging and the dense aggregate against the JAX package:
``from_numpy`` field by field (capacity, codes, dictionaries, magnitude
bounds, storage), ``from_arrays`` on a JAX batch's own arrays, and
``hash_aggregate`` on the bucket kernels' plain versions with null keys,
null values, empty buckets and the ungrouped-over-empty case."""

import numpy as np
import pytest
import torch

from datafusion_comet_tpu import types as JT
from datafusion_comet_tpu.exec import batch as JB
from datafusion_comet_tpu.exec.operators import aggregate as JAGG
from datafusion_comet_tpu.ir import expr as JE
from datafusion_comet_tpu.ir import plan as JP
from datafusion_comet_tpu.models import tpch as JTPCH
from datafusion_comet_tpu_torch import types as PT
from datafusion_comet_tpu_torch.exec import batch as PB
from datafusion_comet_tpu_torch.exec.operators import aggregate as PAGG
from datafusion_comet_tpu_torch.ir import expr as PE
from datafusion_comet_tpu_torch.ir import plan as PP
from datafusion_comet_tpu_torch.models import tpch as PTPCH
from _torch_threads import one_torch_thread  # noqa: F401 (a fixture)

pytestmark = pytest.mark.usefixtures("one_torch_thread")


def jax_arrays(b):
    """A JAX batch's buffers laid out as the port's to_arrays lays them out."""
    out = {"row_mask": np.asarray(b.row_mask)}
    for f, c in zip(b.schema.fields, b.columns):
        out[f"{f.name}.data"] = np.asarray(c.data)
        out[f"{f.name}.validity"] = np.asarray(c.validity)
        out[f"{f.name}.lengths"] = None if c.lengths is None else np.asarray(c.lengths)
        out[f"{f.name}.dict_values"] = None if c.dictionary is None else c.dictionary.values
        out[f"{f.name}.dict_lengths"] = None if c.dictionary is None else c.dictionary.lengths
        out[f"{f.name}.mag_bound"] = c.mag_bound
    return out


def assert_same_arrays(j, p):
    assert sorted(j) == sorted(p)
    for k in j:
        a, b = j[k], p[k]
        if a is None or isinstance(a, int):
            assert a == b, k
        else:
            assert a.dtype == b.dtype and a.shape == b.shape, (k, a.dtype, b.dtype, a.shape, b.shape)
            np.testing.assert_array_equal(a, b, err_msg=k)


def _mixed_table(n=40, seed=0):
    rng = np.random.default_rng(seed)
    k1 = np.array(["x", "yy", None, "x", "zzz"], object)[rng.integers(0, 5, n)]
    k2 = rng.random(n) < 0.5
    k2v = rng.random(n) < 0.9
    v = rng.integers(-10**6, 10**6, n).astype(np.int64)
    vv = rng.random(n) < 0.8
    w = np.array([int(x) * 10**20 if i % 3 else int(x) for i, x in enumerate(rng.integers(-999, 999, n))],
                 object)
    i32 = rng.integers(-100, 100, n).astype(np.int32)
    data = {"k1": k1, "k2": k2, "v": v, "w": w, "i": i32,
            "s": np.array([f"s{j}" for j in rng.integers(0, 30, n)], object)}
    validity = {"k2": k2v, "v": vv}
    fields = [("k1", "string", (3,)), ("k2", "BOOL", ()), ("v", "decimal", (15, 2)),
              ("w", "decimal", (38, 2)), ("i", "INT32", ()), ("s", "string", (4,))]
    return data, validity, fields


def _schema(T, fields):
    out = []
    for name, kind, args in fields:
        dt = getattr(T, kind)(*args) if kind in ("string", "decimal") else getattr(T, kind)
        out.append(T.Field(name, dt))
    return T.Schema(out)


@pytest.mark.parametrize("dict_max_size", [1 << 16, 4])
def test_from_numpy_field_by_field(dict_max_size):
    data, validity, fields = _mixed_table()
    jb = JB.from_numpy(data, _schema(JT, fields), validity=validity, dict_max_size=dict_max_size)
    pb = PB.from_numpy(data, _schema(PT, fields), "cpu", validity=validity,
                       dict_max_size=dict_max_size)
    assert jb.capacity == pb.capacity
    assert_same_arrays(jax_arrays(jb), PB.to_arrays(pb))
    # the 4-entry limit leaves the 30-value column padded, in both packages
    assert (pb.column("s").dictionary is None) == (dict_max_size == 4)


def test_from_numpy_lineitem_and_to_numpy():
    d = JTPCH.generate_table("lineitem", 0.001)
    jb = JB.from_numpy(d, JTPCH.SCHEMAS["lineitem"])
    pb = PB.from_numpy(d, PTPCH.SCHEMAS["lineitem"], "cpu")
    assert_same_arrays(jax_arrays(jb), PB.to_arrays(pb))
    jn, pn = JB.to_numpy(jb), PB.to_numpy(pb)
    assert sorted(jn) == sorted(pn)
    for k in jn:
        np.testing.assert_array_equal(jn[k], pn[k], err_msg=k)


@pytest.mark.parametrize("sf,seed", [(0.001, 19920401), (0.002, 7)])
def test_generator_is_bit_identical(sf, seed):
    j = JTPCH.generate_table("lineitem", sf, seed)
    p = PTPCH.generate_table("lineitem", sf, seed)
    assert sorted(j) == sorted(p)
    for k in j:
        assert j[k].dtype == p[k].dtype
        np.testing.assert_array_equal(j[k], p[k], err_msg=k)


def test_from_arrays_carries_a_jax_batch_over():
    data, validity, fields = _mixed_table(seed=3)
    jb = JB.from_numpy(data, _schema(JT, fields), validity=validity)
    arrays = jax_arrays(jb)
    pb = PB.from_arrays(_schema(PT, fields), arrays, "cpu")
    assert_same_arrays(arrays, PB.to_arrays(pb))
    assert pb.column("k1").dictionary == PB.from_numpy(
        data, _schema(PT, fields), "cpu", validity=validity).column("k1").dictionary


# ---- the dense aggregate -----------------------------------------------------------


def _aggs(E):
    c = E.col
    return [
        E.AggExpr("sum", c("v"), "sum_v"),
        E.AggExpr("sum", c("w"), "sum_w"),
        E.AggExpr("sum", c("i"), "sum_i"),
        E.AggExpr("avg", c("v"), "avg_v"),
        E.AggExpr("avg", c("w"), "avg_w"),
        E.AggExpr("count", c("v"), "count_v"),
        E.AggExpr("count", None, "count_star"),
        E.AggExpr("sum", c("v") * (E.lit(1).cast(PT.decimal(10, 0) if E is PE else JT.decimal(10, 0))
                                   - c("v")), "sum_expr"),
    ]


def _run_both(group_names, mask_fn=None, seed=0, n=40):
    data, validity, fields = _mixed_table(n=n, seed=seed)
    jb = JB.from_numpy(data, _schema(JT, fields), validity=validity)
    pb = PB.from_numpy(data, _schema(PT, fields), "cpu", validity=validity)
    if mask_fn is not None:
        m = mask_fn(np.asarray(jb.row_mask))
        jb = jb.with_mask(jb.row_mask & m)
        pb = pb.with_mask(pb.row_mask & torch.from_numpy(m))
    jplan = JP.bind_plan(JP.HashAggregate(JP.Scan("t", jb.schema),
                                          tuple(JE.col(g) for g in group_names), tuple(_aggs(JE))))
    pplan = PP.bind_plan(PP.HashAggregate(PP.Scan("t", pb.schema),
                                          tuple(PE.col(g) for g in group_names), tuple(_aggs(PE))))
    assert repr(jplan.schema) == repr(pplan.schema)
    jout = JAGG.hash_aggregate(jb, jplan.group_exprs, jplan.agg_exprs, "single", 1 << 16,
                               jplan.schema)
    pout = PAGG.hash_aggregate(pb, pplan.group_exprs, pplan.agg_exprs, "single", pplan.schema)
    return jout, pout


def _same_result(jout, pout, storage=True):
    jn, pn = JB.to_numpy(jout), PB.to_numpy(pout)
    assert sorted(jn) == sorted(pn)
    for k in jn:
        np.testing.assert_array_equal(jn[k], pn[k], err_msg=k)
        assert jn[k].dtype == pn[k].dtype, k
    if storage:
        for jc, pc, f in zip(jout.columns, pout.columns, pout.schema.fields):
            assert np.asarray(jc.data).ndim == pc.data.dim(), f.name
            assert jc.mag_bound == pc.mag_bound, f.name


@pytest.mark.parametrize("groups", [("k1",), ("k1", "k2"), ("k2",)])
@pytest.mark.parametrize("seed", [0, 1])
def test_dense_aggregate_matches_jax(groups, seed):
    """Null keys form their own group, null values are skipped, and the
    bucket layout (capacity 2^bits, presence mask) is the JAX package's."""
    jout, pout = _run_both(groups, seed=seed)
    assert jout.capacity == pout.capacity
    np.testing.assert_array_equal(np.asarray(jout.row_mask), pout.row_mask.numpy())
    _same_result(jout, pout)


def test_dense_aggregate_empty_buckets_and_all_null_group():
    """Rows filtered so some groups hold only null values (sum null, count 0)
    and some buckets are empty."""
    jout, pout = _run_both(("k1", "k2"), mask_fn=lambda m: np.arange(len(m)) % 4 == 0, seed=2)
    _same_result(jout, pout)


@pytest.mark.parametrize("keep", ["all", "some", "none"])
def test_ungrouped_aggregate(keep):
    """Exactly one output row, even over empty input: sum null, count 0."""
    masks = {"all": None, "some": lambda m: np.arange(len(m)) % 3 == 0,
             "none": lambda m: np.zeros(len(m), bool)}
    jout, pout = _run_both((), mask_fn=masks[keep])
    assert pout.capacity == jout.capacity == 8 and bool(pout.row_mask[0])
    _same_result(jout, pout)
    if keep == "none":
        pn = PB.to_numpy(pout)
        assert not pn["sum_v__valid"][0] and pn["count_star"][0] == 0


def test_partial_mode_state_fields():
    jschema = JP.bind_plan(JP.HashAggregate(JP.Scan("lineitem", JTPCH.SCHEMAS["lineitem"]),
                                            (JE.col("l_returnflag"),),
                                            tuple(JTPCH.q1().child.agg_exprs), "partial")).schema
    pschema = PP.bind_plan(PP.HashAggregate(PP.Scan("lineitem", PTPCH.SCHEMAS["lineitem"]),
                                            (PE.col("l_returnflag"),),
                                            tuple(PTPCH.q1().child.agg_exprs), "partial")).schema
    assert repr(jschema) == repr(pschema)


def test_wide_key_domain_is_not_silently_wrong():
    """Keys beyond the dense domain take the sorted path: the JAX package's
    groups and values, not an error or a truncated domain."""
    jout, pout = _run_both(("i",), seed=3)
    assert pout.capacity == min(1 << 16, jout.capacity)
    _same_result(jout, pout)

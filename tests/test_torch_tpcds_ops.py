"""PyTorch port, the operators and expressions TPC-DS brings (``Union``,
``Expand``, NOT, IS [NOT] NULL, ``if_``, ``coalesce`` and the decimal to
integer cast), through the port's ``Session`` on the CPU against the JAX
``Session`` on the same seeded inputs: values, order, storage (dictionary
codes or padded bytes, one or two decimal limbs), bounds and the output
schema's nullability.

- ``Union``: one table twice (a shared dictionary stays codes), two tables
  with different dictionaries (decoded), narrow and two-limb storage of
  one decimal type (widened), padded strings of two widths (padded to the
  wider), and the first input's nullability;
- ``Expand``: output row ``i * n_proj + j`` is projection ``j`` of row
  ``i``, dead input rows stay dead in every projection, and a typed null
  literal sits beside a dictionary column (decoded) and a padded one;
- NOT, IS NULL and IS NOT NULL over nulls, in projections, in filters and
  under ``if_`` and ``coalesce``; the cast of narrow and two-limb decimals
  to integers in the LEGACY and TRY modes; the runtime filters' host
  evaluator over NOT and the null tests."""

import numpy as np
import pytest

from datafusion_comet_tpu import types as JT
from datafusion_comet_tpu.exec import batch as JB
from datafusion_comet_tpu.exec.engine import Session as JaxSession
from datafusion_comet_tpu.ir import expr as JE
from datafusion_comet_tpu.ir import plan as JP
from datafusion_comet_tpu_torch import types as PT
from datafusion_comet_tpu_torch.conf import Config
from datafusion_comet_tpu_torch.exec import batch as PB
from datafusion_comet_tpu_torch.exec.engine import Session
from datafusion_comet_tpu_torch.ir import expr as PE
from datafusion_comet_tpu_torch.ir import plan as PP
from test_torch_q9 import same
from _torch_threads import one_torch_thread  # noqa: F401 (a fixture)

pytestmark = pytest.mark.usefixtures("one_torch_thread")

JAX, PORT = (JT, JE, JP), (PT, PE, PP)
N = 300


def _tables(T, seed=5):
    """Seeded tables: ``a`` and ``b`` with a string column each (dictionary
    coded under the default staging; different values, so different
    dictionaries), a nullable int and bool, a narrow and a wide decimal(38,
    2); ``w``, strings of another width."""
    rng = np.random.default_rng(seed)

    def table(prefix, wide):
        k = rng.integers(-50, 50, N)
        dec = rng.integers(-10**6, 10**6, N).astype(object)
        if wide:
            dec[::7] = [int(v) * 10**22 for v in dec[::7]]
        data = {"k": k.astype(np.int32), "s": np.array([f"{prefix}{v % 13}" for v in k], object),
                "n": rng.integers(0, 9, N).astype(np.int64),
                "f": rng.integers(0, 2, N).astype(bool), "d": dec}
        valid = {"n": rng.random(N) > 0.3, "f": rng.random(N) > 0.3}
        schema = T.Schema([T.Field("k", T.INT32, False), T.Field("s", T.string(6), False),
                           T.Field("n", T.INT64), T.Field("f", T.BOOL),
                           T.Field("d", T.decimal(38, 2), False)])
        return data, schema, valid

    w = rng.integers(0, 1000, N)
    wide = ({"k": w.astype(np.int32), "s": np.array([f"long-{v:06d}" for v in w], object),
             "n": w.astype(np.int64), "f": (w % 2).astype(bool),
             "d": (w * 3).astype(object)},
            T.Schema([T.Field("k", T.INT32, False), T.Field("s", T.string(12), False),
                      T.Field("n", T.INT64, False), T.Field("f", T.BOOL, False),
                      T.Field("d", T.decimal(38, 2), False)]), {})
    return {"a": table("x", False), "b": table("y", True), "w": wide}


def _run(build, dict_max_size=1 << 16):
    """``build(T, E, P)``'s plan through both packages, held equal in
    values, storage, bounds and output schema: (JAX batch, port batch)."""
    js = JaxSession()
    ps = Session(device="cpu", conf=Config(scan_dictionary_max_size=dict_max_size))
    for name, (data, schema, valid) in _tables(JT).items():
        js.register_numpy(name, data, schema, validity=valid, dict_max_size=dict_max_size)
    for name, (data, schema, valid) in _tables(PT).items():
        ps.register_numpy(name, data, schema, validity=valid)
    jb, pb = js.execute(build(*JAX)), ps.execute(build(*PORT))
    same(JB.to_numpy(jb), PB.to_numpy(pb))
    for jc, pc, f in zip(jb.columns, pb.columns, pb.schema.fields):
        assert np.asarray(jc.data).ndim == pc.data.dim(), f.name
        assert jc.mag_bound == pc.mag_bound, f.name
        assert (jc.lengths is None) == (pc.lengths is None), f.name
        assert (jc.dictionary is None) == (pc.dictionary is None), f.name
    assert [(f.name, f.dtype.type_id, f.nullable) for f in jb.schema.fields] == \
        [(f.name, f.dtype.type_id, f.nullable) for f in pb.schema.fields]
    return jb, pb


def _scan(T, P, name):
    return P.Scan(name, _tables(T)[name][1])


# ---- Union ---------------------------------------------------------------------------


def test_union_one_table_twice_keeps_the_shared_dictionary():
    def build(T, E, P):
        return P.Union((_scan(T, P, "a").filter(E.col("k") > 0), _scan(T, P, "a")))

    _, pb = _run(build)
    assert pb.capacity == 2 * 512 and pb.column("s").is_dict


def test_union_of_two_dictionaries_decodes():
    def build(T, E, P):
        return P.Union((_scan(T, P, "a"), _scan(T, P, "b").filter(E.col("k") < 10)))

    _, pb = _run(build)
    assert not pb.column("s").is_dict and pb.column("s").lengths is not None


def test_union_widens_mixed_decimal_storage():
    """``a.d`` stages narrow with a bound, ``b.d`` in two limbs: the union
    holds two limbs and no bound, in both packages."""
    def build(T, E, P):
        return P.Union((_scan(T, P, "a"), _scan(T, P, "b"), _scan(T, P, "a")))

    _, pb = _run(build)
    assert pb.column("d").is_wide_storage and pb.column("d").mag_bound is None


@pytest.mark.parametrize("dict_max_size", [1 << 16, 0])
def test_union_pads_strings_to_the_wider_input(dict_max_size):
    def build(T, E, P):
        return P.Union((_scan(T, P, "a"), _scan(T, P, "w")))

    _, pb = _run(build, dict_max_size)
    assert pb.column("s").data.shape[1] == 12


def test_union_takes_the_first_inputs_nullability():
    """``w.n`` is not nullable and ``a.n`` is: the union's ``n`` is as its
    first input's, either way round."""
    def build(first, second):
        return lambda T, E, P: P.Union((_scan(T, P, first), _scan(T, P, second)))

    _, pb = _run(build("w", "a"))
    assert not pb.schema.field("n").nullable and not pb.column("n").validity.all()
    _, pb = _run(build("a", "w"))
    assert pb.schema.field("n").nullable


def test_union_under_an_aggregate_and_a_sort():
    def build(T, E, P):
        u = P.Union((_scan(T, P, "a"), _scan(T, P, "b"), _scan(T, P, "w")))
        agg = u.aggregate([E.col("s")], [E.AggExpr("sum", E.col("d"), "sd"),
                                         E.AggExpr("count", E.col("n"), "cn")])
        return agg.sort([E.SortOrder(E.col("sd"), ascending=False), E.SortOrder(E.col("s"))],
                        fetch=20)

    _run(build)


# ---- Expand --------------------------------------------------------------------------


def _rollup(T, E, P, child):
    """ROLLUP(s, k) with a tag, as the TPC-DS models lay it out."""
    projs = ((E.col("s"), E.col("k"), E.lit(0), E.col("d")),
             (E.col("s"), E.lit(None, T.INT32), E.lit(1), E.col("d")),
             (E.lit(None, T.string(6)), E.lit(None, T.INT32), E.lit(2), E.col("d")))
    return P.Expand(child, projs, ("s", "k", "tag", "d"))


@pytest.mark.parametrize("dict_max_size", [1 << 16, 0])
def test_expand_interleaves_projections_and_repeats_the_mask(dict_max_size):
    """Row ``i * 3 + j`` is projection ``j`` of input row ``i``, live where
    row ``i`` is; a typed null literal beside the dictionary column decodes
    it, beside a padded one keeps it padded."""
    def build(T, E, P):
        return _rollup(T, E, P, _scan(T, P, "a").filter(E.col("k") > -20))

    jb, pb = _run(build, dict_max_size)
    mask = pb.row_mask.numpy()
    assert pb.capacity == 3 * 512 and mask.sum() == 3 * (_tables(PT)["a"][0]["k"] > -20).sum()
    assert (mask.reshape(-1, 3) == mask.reshape(-1, 3)[:, :1]).all()
    tags = pb.column("tag").data.numpy().reshape(-1, 3)
    assert (tags == [0, 1, 2]).all()
    s = pb.column("s")
    assert not s.is_dict and s.data.shape[1] == 6
    assert not s.validity.numpy().reshape(-1, 3)[:, 2].any()


def test_expand_under_a_rollup_aggregate_and_its_sort():
    """The rolled-up keys are the first nullable group keys: the Sort above
    the aggregate asks for nulls first (ascending) and is not elided; the
    answer equals JAX's."""
    def build(T, E, P):
        r = _rollup(T, E, P, _scan(T, P, "b"))
        agg = r.aggregate([E.col("s"), E.col("k"), E.col("tag")],
                          [E.AggExpr("avg", E.col("d"), "ad"),
                           E.AggExpr("count", None, "c")])
        return agg.sort([E.SortOrder(E.col("s")), E.SortOrder(E.col("k"))], fetch=40)

    jb, pb = _run(build)
    out = PB.to_numpy(pb)
    assert not out["s__valid"][0] and not out["k__valid"][0]  # the grand total first


# ---- NOT, the null tests, if_, coalesce, the decimal to integer cast -----------------


def test_not_and_null_tests_over_nulls():
    def build(T, E, P):
        n, f = E.col("n"), E.col("f")
        return _scan(T, P, "a").project([
            E.col("k"), (~f).alias("not_f"), (~(n > 4)).alias("not_gt"), n.is_null().alias("nn"),
            f.is_not_null().alias("fnn"), (~n.is_null()).alias("not_nn"),
            E.if_(~(n > 4), E.lit(1), E.lit(0)).alias("if_not"),
            E.if_(n.is_null(), E.col("k")).alias("if_null"),
            E.coalesce(n, E.col("k").cast(T.INT64), 0).alias("co"),
            E.coalesce(E.lit(None, T.INT64), n).alias("co_null")])

    jb, pb = _run(build)
    out = PB.to_numpy(pb)
    a, valid = _tables(PT)["a"][0], _tables(PT)["a"][2]
    np.testing.assert_array_equal(out["nn"], ~valid["n"])
    assert out["nn__valid"].all() and out["fnn__valid"].all()
    np.testing.assert_array_equal(out["not_f__valid"], valid["f"])  # NOT of a null is null
    np.testing.assert_array_equal(out["co"], np.where(valid["n"], a["n"], a["k"]))


@pytest.mark.parametrize("where", ["not", "isnull", "isnotnull"])
def test_not_and_null_tests_in_filters(where):
    def build(T, E, P):
        pred = {"not": ~(E.col("f") & (E.col("n") > 3)), "isnull": E.col("n").is_null(),
                "isnotnull": E.col("f").is_not_null() & ~E.col("n").is_null()}[where]
        return _scan(T, P, "a").filter(pred).project([E.col("k"), E.col("n"), E.col("f")])

    _run(build)


@pytest.mark.parametrize("mode", ["LEGACY", "TRY"])
@pytest.mark.parametrize("to", ["INT64", "INT32", "INT16"])
def test_decimal_to_integer_cast(mode, to):
    """Narrow and two-limb decimals to integers, truncated toward zero,
    wrapped as Java narrows (LEGACY) or null out of range (TRY)."""
    def build(T, E, P):
        dt = getattr(T, to)
        return P.Union((_scan(T, P, "a"), _scan(T, P, "b"))).project([
            E.col("d").cast(dt, mode).alias("di"),
            (E.col("d") * E.lit(-3)).cast(dt, mode).alias("neg")])

    _run(build)


@pytest.mark.parametrize("pred", ["not_cmp", "not_nullable", "isnull", "isnotnull", "not_or"])
def test_host_filter_not_and_null_tests(pred):
    """The runtime filters' host evaluator reads NOT (only where no row of
    the capacity, padding included, holds a null under it; else the
    conjunct is skipped) and IS [NOT] NULL as the JAX package's does: the
    same mask and ``applied``, over 256 rows (no padding)."""
    from datafusion_comet_tpu.exec import host_filter as JH
    from datafusion_comet_tpu_torch.exec import host_filter as PH

    def build(T, E):
        k, n = E.col("k"), E.col("n")
        return {"not_cmp": ~(k > 3), "not_nullable": ~(n > 3), "isnull": n.is_null(),
                "isnotnull": n.is_not_null() & (k < 20),
                "not_or": ~((k < -10) | (k > 10))}[pred]

    def rows(table):
        data, schema, valid = table
        return ({k: v[:256] for k, v in data.items()}, schema,
                {k: v[:256] for k, v in valid.items()})

    data, schema, valid = rows(_tables(JT)["a"])
    jb = JB.from_numpy(data, schema, validity=valid)
    pdata, pschema, pvalid = rows(_tables(PT)["a"])
    pb = PB.from_numpy(pdata, pschema, "cpu", validity=pvalid)
    want = JH.eval_dim_filter(jb, [JE.bind(build(JT, JE), schema)])
    got = PH.eval_dim_filter(pb, [PE.bind(build(PT, PE), pschema)])
    np.testing.assert_array_equal(got[0], np.asarray(want[0]))
    assert got[1] == want[1] == (pred != "not_nullable")

"""The port's nested types against the JAX package on the CPU: LIST, MAP
and STRUCT columns staged from the same Python rows, every array, map and
struct function with its null cases, evaluated in both packages and held
equal (values, element counts, validity, error flags)."""

import numpy as np
import pytest

from _torch_nested import assert_same, assert_same_errors, run_all, stage
from _torch_threads import one_torch_thread  # noqa: F401

from datafusion_comet_tpu_torch import types as PT
from datafusion_comet_tpu_torch.exec import batch as PB

pytestmark = pytest.mark.usefixtures("one_torch_thread")

NAN = float("nan")

ROWS = {
    "a": [[3, 1, 2], None, [], [5, None, 5, 1], [2, 2], [7], [None], [4, 9, 4, 9, 1, 0]],
    "b": [[1, 8], [2], None, [None, 6], [3, 2], [], [1], [0, 9]],
    "f": [[1.5, NAN, -0.0], [0.0], None, [NAN, NAN, None], [], [2.0, -1.0], [0.0, -0.0],
          [NAN]],
    "s": [["ab", "c", "ab"], None, [], ["x", None, "yz"], ["q"], ["", "a"], ["b", "b"],
          ["zz", "a", "m"]],
    "n": [[[1, 2], [3]], [[]], None, [[4], None], [[5, 6, 7]], [], [[8], [9, 10]], [[0]]],
    "m": [{"k1": 1, "k2": 2}, None, {}, {"a": None, "b": 3}, {"z": 9}, {"k1": 5},
          {"x": 1, "y": 2, "z": 3}, {"q": 0}],
    "i": [1, 2, None, -1, 0, 3, 1, -2],
    "x": [2, 5, 1, None, 2, 7, 0, 9],
    "k": ["k1", "x", None, "b", "z", "k2", "y", "q"],
    "t": ["a,b,,c", "", None, ",", "one", "x,y", "a,b,c,d,e", ",,"],
}
FIELDS = [
    ("a", lambda T: T.list_(T.INT64, 6)), ("b", lambda T: T.list_(T.INT64, 3)),
    ("f", lambda T: T.list_(T.FLOAT64, 3)), ("s", lambda T: T.list_(T.string(4), 3)),
    ("n", lambda T: T.list_(T.list_(T.INT32, 3), 2)),
    ("m", lambda T: T.map_(T.string(4), T.INT32, 3)), ("i", lambda T: T.INT32),
    ("x", lambda T: T.INT64), ("k", lambda T: T.string(4)), ("t", lambda T: T.string(12)),
]
N = 8


@pytest.fixture(scope="module")
def batches():
    return stage(FIELDS, ROWS)


def _arr(f, *args):
    return lambda E, T: E.ArrayExpr(f, tuple(E.col(a) if isinstance(a, str) else a(E, T)
                                             for a in args))


def _lit(v, t=None):
    return lambda E, T: E.lit(v, t(T) if t else None)


ARRAY_CASES = {
    "array": _arr("array", "x", "x", _lit(4)),
    "size": _arr("size", "a"),
    "contains": _arr("array_contains", "a", "x"),
    "contains_null_item": _arr("array_contains", "a", _lit(8)),
    "contains_nan": _arr("array_contains", "f", _lit(NAN)),
    "contains_str": _arr("array_contains", "s", "k"),
    "position": _arr("array_position", "a", "x"),
    "element_at": _arr("element_at", "a", "i"),
    "get_array_item": _arr("get_array_item", "a", "i"),
    "element_at_str": _arr("element_at", "s", _lit(-1)),
    "min": _arr("array_min", "a"), "max": _arr("array_max", "a"),
    "min_f": _arr("array_min", "f"), "max_f": _arr("array_max", "f"),
    "max_s": lambda E, T: E.ArrayExpr("array_max", (E.col("a"),)),
    "sort": _arr("sort_array", "a"),
    "sort_desc": _arr("sort_array", "a", _lit(False)),
    "sort_f": _arr("sort_array", "f"),
    "distinct": _arr("array_distinct", "a"), "distinct_f": _arr("array_distinct", "f"),
    "distinct_s": _arr("array_distinct", "s"),
    "remove": _arr("array_remove", "a", "x"), "compact": _arr("array_compact", "a"),
    "append": _arr("array_append", "a", "x"), "prepend": _arr("array_prepend", "b", "x"),
    "append_s": _arr("array_append", "s", "k"),
    "repeat": _arr("array_repeat", "x", _lit(3)),
    "overlap": _arr("arrays_overlap", "a", "b"),
    "slice": _arr("slice", "a", _lit(2), _lit(2)), "slice_neg": _arr("slice", "a", _lit(-2),
                                                                     _lit(3)),
    "join": _arr("array_join", "s", _lit("-")),
    "join_repl": _arr("array_join", "s", _lit(","), _lit("N")),
    "union": _arr("array_union", "a", "b"), "intersect": _arr("array_intersect", "a", "b"),
    "except": _arr("array_except", "a", "b"), "reverse": _arr("array_reverse", "s"),
    "flatten": _arr("flatten", "n"),
    "insert": _arr("array_insert", "b", _lit(2), "x"),
    "insert_past": _arr("array_insert", "b", _lit(5), "x"),
    "zip": _arr("arrays_zip", "a", "b"),
}


@pytest.mark.parametrize("names", [list(ARRAY_CASES)[i::3] for i in range(3)],
                         ids=["part0", "part1", "part2"])
def test_array_functions_equal_jax(batches, names):
    jb, pb = batches
    for name, (jcv, pcv, jerr, perr) in zip(names, run_all([ARRAY_CASES[n] for n in names],
                                                           jb, pb)):
        try:
            assert_same(jcv, pcv, N)
            assert_same_errors(jerr, perr, np.ones(N, bool))
        except AssertionError as err:
            raise AssertionError(f"{name}: {err}") from err


MAP_CASES = {
    "map": lambda E, T: E.MapExpr("map", (E.lit("k1"), E.col("x"), E.lit("k2"), E.col("i"),
                                          E.lit("k1"), E.col("i"))),
    "map_from_arrays": lambda E, T: E.MapExpr("map_from_arrays", (E.col("b"), E.col("b"))),
    "keys": lambda E, T: E.MapExpr("map_keys", (E.col("m"),)),
    "values": lambda E, T: E.MapExpr("map_values", (E.col("m"),)),
    "entries": lambda E, T: E.MapExpr("map_entries", (E.col("m"),)),
    "element_at": lambda E, T: E.MapExpr("element_at", (E.col("m"), E.col("k"))),
    "contains_key": lambda E, T: E.MapExpr("map_contains_key", (E.col("m"), E.col("k"))),
    "size": lambda E, T: E.MapExpr("size", (E.col("m"),)),
    "concat": lambda E, T: E.MapExpr("map_concat", (E.col("m"), E.MapExpr(
        "map", (E.lit("k1"), E.col("i"))))),
    "from_entries": lambda E, T: E.MapExpr("map_from_entries", (E.ArrayExpr(
        "arrays_zip", (E.col("b"), E.col("a"))),)),
    "struct": lambda E, T: E.StructExpr((E.col("x"), E.col("k"), E.col("a")), ("p", "q", "r")),
    "get_field": lambda E, T: E.GetStructField(E.StructExpr((E.col("x"), E.col("k")),
                                                            ("p", "q")), "q"),
    "zip_field": lambda E, T: E.ArrayExpr("get_array_struct_field", (E.ArrayExpr(
        "arrays_zip", (E.col("a"), E.col("s"))), E.lit(1))),
}


def test_map_and_struct_functions_equal_jax(batches):
    jb, pb = batches
    for name, (jcv, pcv, jerr, perr) in zip(MAP_CASES, run_all(list(MAP_CASES.values()),
                                                               jb, pb)):
        try:
            assert_same(jcv, pcv, N)
            assert_same_errors(jerr, perr, np.ones(N, bool))
        except AssertionError as err:
            raise AssertionError(f"{name}: {err}") from err


def test_null_map_key_and_array_index_errors_equal_jax(batches):
    """A null map key and element_at(.., 0) flag the same rows in both."""
    jb, pb = batches
    builds = [lambda E, T: E.MapExpr("map", (E.col("k"), E.col("x"))),
              _arr("element_at", "a", _lit(0)),
              _arr("slice", "a", _lit(0), _lit(1))]
    for jcv, pcv, jerr, perr in run_all(builds, jb, pb):
        assert jerr and len(jerr) == len(perr)
        assert_same_errors(jerr, perr, np.ones(N, bool))


def test_nested_staging_round_trips():
    """from_numpy / to_numpy of nested columns give the rows back, as the
    JAX package's, with (cap, E) and (cap, E, L) element buffers."""
    from datafusion_comet_tpu.exec import batch as JB
    from datafusion_comet_tpu import types as JT

    sch = [("a", lambda T: T.list_(T.INT64, 6)), ("s", lambda T: T.list_(T.string(4), 3)),
           ("m", lambda T: T.map_(T.string(4), T.INT32, 3)),
           ("st", lambda T: T.struct(("p", T.INT32), ("q", T.string(3))))]
    data = {"a": ROWS["a"], "s": ROWS["s"], "m": ROWS["m"],
            "st": [(1, "a"), None, {"p": 2, "q": None}, (3, "bc"), (None, "x"), (0, ""),
                   (5, "z"), (6, "y")]}
    jb = JB.from_numpy(data, JT.Schema([JT.Field(n, f(JT)) for n, f in sch]), dictionary=False)
    pb = PB.from_numpy(data, PT.Schema([PT.Field(n, f(PT)) for n, f in sch]), "cpu",
                       dict_max_size=0)
    assert tuple(pb.column("a").children[0].data.shape) == (8, 6)
    assert tuple(pb.column("s").children[0].data.shape) == (8, 3, 4)
    jn, pn = JB.to_numpy(jb), PB.to_numpy(pb)
    for name, _ in sch:
        assert list(jn[name]) == list(pn[name]) == [
            dict(sorted(v.items())) if isinstance(v, dict) and name == "m" else v
            for v in (pn[name])]
        np.testing.assert_array_equal(jn[name + "__valid"], pn[name + "__valid"])
    with pytest.raises(ValueError, match="max_elems"):
        PB.from_numpy({"a": [[1] * 7]}, PT.Schema([PT.Field("a", PT.list_(PT.INT64, 6))]),
                      "cpu")

"""The port's higher-order functions against the JAX package on the CPU:
transform (with the index form and an outer column), filter, exists and
forall (three-valued), aggregate, zip_with, array_sort, and the map
lambdas transform_keys, transform_values and map_filter, over lists with
nulls and empty and null rows."""

import numpy as np
import pytest

from _torch_nested import assert_same, run_all, stage
from _torch_threads import one_torch_thread  # noqa: F401

from datafusion_comet_tpu_torch.exec import batch as PB

pytestmark = pytest.mark.usefixtures("one_torch_thread")

ROWS = {
    "a": [[3, 1, 2], None, [], [5, None, 5, 1], [2, 2], [7], [None], [4, 9, 4, 9, 1]],
    "b": [[1, 8], [2], None, [None, 6, 1], [3], [], [1], [0, 9, 2]],
    "s": [["ab", "c"], None, [], ["x", None], ["q"], ["", "a"], ["b", "b"], ["zz"]],
    "m": [{"k1": 1, "k2": 2}, None, {}, {"a": None, "b": 3}, {"z": 9}, {"k1": 5},
          {"x": 1, "y": 2}, {"q": 0}],
    "x": [2, 5, 1, None, 2, 7, 0, 9],
}
FIELDS = [
    ("a", lambda T: T.list_(T.INT64, 5)), ("b", lambda T: T.list_(T.INT64, 3)),
    ("s", lambda T: T.list_(T.string(3), 2)), ("m", lambda T: T.map_(T.string(3), T.INT32, 2)),
    ("x", lambda T: T.INT64),
]
N = 8


def _hof(f, args, params=(), body=None):
    def build(E, T):
        v = {p: E.LambdaVar(p) for p in params}
        return E.HigherOrderFunc(f, tuple(E.col(a) if isinstance(a, str) else a(E, T)
                                          for a in args), tuple(params),
                                 None if body is None else body(E, T, v))
    return build


CASES = {
    "transform": _hof("transform", ["a"], ["x"], lambda E, T, v: v["x"] * 2),
    "transform_index": _hof("transform", ["a"], ["x", "i"],
                            lambda E, T, v: v["x"] + v["i"]),
    "transform_outer": _hof("transform", ["a"], ["y"], lambda E, T, v: v["y"] + E.col("x")),
    "transform_str": _hof("transform", ["s"], ["y"],
                          lambda E, T, v: E.StringFunc("upper", (v["y"],))),
    "filter": _hof("filter", ["a"], ["y"], lambda E, T, v: v["y"] > 2),
    "filter_null": _hof("filter", ["a"], ["y"], lambda E, T, v: v["y"].is_null()),
    "exists": _hof("exists", ["a"], ["y"], lambda E, T, v: v["y"] > 4),
    "forall": _hof("forall", ["a"], ["y"], lambda E, T, v: v["y"] > 0),
    "aggregate": _hof("aggregate", ["a", lambda E, T: E.lit(0, T.INT64)], ["acc", "y"],
                      lambda E, T, v: v["acc"] + v["y"]),
    "zip_with": _hof("zip_with", ["a", "b"], ["p", "q"], lambda E, T, v: v["p"] * v["q"]),
    "array_sort": _hof("array_sort", ["a"]),
    "transform_values": _hof("transform_values", ["m"], ["k", "w"],
                             lambda E, T, v: v["w"] + 10),
    "transform_keys": _hof("transform_keys", ["m"], ["k", "w"],
                           lambda E, T, v: E.StringFunc("upper", (v["k"],))),
    "map_filter": _hof("map_filter", ["m"], ["k", "w"], lambda E, T, v: v["w"] > 1),
}


@pytest.fixture(scope="module")
def batches():
    return stage(FIELDS, ROWS)


def test_higher_order_functions_equal_jax(batches):
    jb, pb = batches
    for name, (jcv, pcv, _, _) in zip(CASES, run_all(list(CASES.values()), jb, pb)):
        try:
            assert_same(jcv, pcv, N)
        except AssertionError as err:
            raise AssertionError(f"{name}: {err}") from err


def test_aggregate_sum_and_filter_equal_python(batches):
    """The HOF sum of each list equals Python's sum where no item is null,
    and filter keeps the Python filter's items, in order."""
    jb, pb = batches
    [(_, agg, _, _), (_, flt, _, _)] = run_all([CASES["aggregate"], CASES["filter"]], jb, pb)
    sums = PB.nested_to_py(agg, np.arange(N)) if agg.dtype.is_nested else None
    assert sums is None
    got = agg.data.numpy()[:N]
    ok = agg.validity.numpy()[:N]
    kept = PB.nested_to_py(flt, np.arange(N))
    for i, a in enumerate(ROWS["a"]):
        if a is None:
            assert not ok[i] and kept[i] is None
            continue
        assert kept[i] == [y for y in a if y is not None and y > 2]
        if None not in a:
            assert ok[i] and got[i] == sum(a)
        else:
            assert not ok[i]

"""PyTorch port, HashFunc: Spark's murmur3 ``hash`` and ``xxhash64`` of
every type the JAX package hashes (integers, dates, timestamps with and
without a zone, booleans, floats as Spark hashes them: -0.0 as 0.0, a
double NaN as Java's canonical one; narrow decimals; strings of 0 to 70
bytes, padded and dictionary-coded), several arguments chained through
the seed, nulls leaving the seed, against the JAX package exactly; a
two-limb decimal raises in both."""

import numpy as np
import pytest

from _torch_expr import assert_same, run_both, stage
from _torch_threads import one_torch_thread  # noqa: F401 (a fixture)
from datafusion_comet_tpu_torch import types as PT
from datafusion_comet_tpu_torch.exec import batch as PB
from datafusion_comet_tpu_torch.exec import evaluator as PEV
from datafusion_comet_tpu_torch.ir import expr as PE

pytestmark = pytest.mark.usefixtures("one_torch_thread")

N = 24
TYPES = {"i8": lambda T: T.INT8, "i16": lambda T: T.INT16, "i32": lambda T: T.INT32,
         "i64": lambda T: T.INT64, "d": lambda T: T.DATE, "ts": lambda T: T.TIMESTAMP,
         "ntz": lambda T: T.TIMESTAMP_NTZ, "b": lambda T: T.BOOL, "f": lambda T: T.FLOAT32,
         "g": lambda T: T.FLOAT64, "dec": lambda T: T.decimal(12, 3),
         "s": lambda T: T.string(72)}


def _batches(dict_strings):
    rng = np.random.default_rng(23)
    i64 = rng.integers(-2**62, 2**62, N)
    g = rng.standard_normal(N) * 1e3
    g[:4] = [0.0, -0.0, np.nan, np.inf]
    f = g.astype(np.float32)
    strs = np.array(["".join(chr(97 + (i * k) % 26) for k in range(3 * i)) for i in range(N)],
                    dtype=object)
    strs[5] = None
    data = {"i8": i64.astype(np.int8), "i16": i64.astype(np.int16), "i32": i64.astype(np.int32),
            "i64": i64, "d": i64.astype(np.int32), "ts": i64 // 1000, "ntz": i64 // 999,
            "b": i64 % 2 == 0, "f": f, "g": g, "dec": i64 % 10**11, "s": strs}
    valid = {k: (np.arange(N) + len(k)) % 7 != 0 for k in data if k != "s"}
    return stage([(k, TYPES[k]) for k in data], data, validity=valid,
                 dict_strings=dict_strings, mask=np.arange(N) != 9)


@pytest.mark.parametrize("dict_strings", [False, True])
def test_hashes_equal_jax(dict_strings):
    jb, pb = _batches(dict_strings)
    for func in ("murmur3", "xxhash64"):
        for c in TYPES:
            j, p = run_both(lambda E, T: E.HashFunc(func, (E.col(c),)), jb, pb)
            assert_same(j, p, N)
        j, p = run_both(lambda E, T: E.HashFunc(func, tuple(E.col(c) for c in TYPES), 7),
                        jb, pb)
        assert_same(j, p, N)


def test_a_two_limb_decimal_raises():
    s = PT.Schema([PT.Field("w", PT.decimal(30, 2))])
    b = PB.from_numpy({"w": np.array([10**25, 3], object)}, s, "cpu")
    for func in ("murmur3", "xxhash64"):
        with pytest.raises(NotImplementedError):
            PEV.evaluate(PE.bind(PE.HashFunc(func, (PE.col("w"),)), s), b)

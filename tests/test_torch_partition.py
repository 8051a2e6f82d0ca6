"""PyTorch port, the partition sort (``exec/kernels.py::partition_sort``,
the CUDA kernel's plain version on the CPU) and the grace join's partition
ids, exactly against the JAX package:

- tile-local mode against the Pallas kernel it replaces,
  ``benchmarks/pallas_scatter_probe.py::tile_partition_sort_pallas``, run
  interpreted as it runs off the TPU;
- global mode against ``exec/grace.py::partition_perm`` (perm and starts);
- the murmur3 partition ids against ``exec/grace.py::_hash_pids``."""

import importlib.util
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from datafusion_comet_tpu import types as JT
from datafusion_comet_tpu.exec import batch as JB
from datafusion_comet_tpu.exec import grace as JG
from datafusion_comet_tpu.exec.evaluator import EvalContext as JEvalContext
from datafusion_comet_tpu.ir import expr as JE
from datafusion_comet_tpu_torch import types as PT
from datafusion_comet_tpu_torch.exec import batch as PB
from datafusion_comet_tpu_torch.exec import grace as PG
from datafusion_comet_tpu_torch.exec import kernels as KN
from datafusion_comet_tpu_torch.ir import expr as PE

ROOT = Path(__file__).resolve().parent.parent


@pytest.fixture(scope="module")
def probe():
    spec = importlib.util.spec_from_file_location(
        "pallas_scatter_probe", ROOT / "benchmarks" / "pallas_scatter_probe.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("K", [16, 128])
def test_tile_local_matches_pallas_kernel(probe, K):
    rng = np.random.default_rng(K)
    n = 4096
    codes = rng.integers(0, K, n).astype(np.int32)
    limbs = np.concatenate([probe.pack_limbs(rng.integers(0, 1 << 62, n).astype(np.int64))
                            for _ in range(4)], axis=1)
    want, want_counts = probe.tile_partition_sort_pallas(jnp.asarray(codes), jnp.asarray(limbs),
                                                         K, KN.PARTITION_TILE)
    perm, counts = KN.partition_sort(torch.from_numpy(codes), K, local=True)
    np.testing.assert_array_equal(limbs[perm.numpy()], np.asarray(want))
    np.testing.assert_array_equal(counts[:, :K].numpy(), np.asarray(want_counts).astype(np.int32))
    assert counts[:, K].sum() == 0


def _jax_mask_batch(mask: np.ndarray):
    return JB.Batch((), jnp.asarray(mask), JT.Schema([]))


@pytest.mark.parametrize("K,n,dead", [(1, 4096, 0.0), (2, 5000, 0.1), (16, 1000, 0.3),
                                      (64, 70_001, 0.05), (16, 777, 1.0)])
def test_global_matches_jax_partition_perm(K, n, dead):
    rng = np.random.default_rng(n + K)
    pids = rng.integers(0, K, n).astype(np.int32)
    mask = rng.random(n) >= dead
    jperm, jstarts = JG.partition_perm(_jax_mask_batch(mask), jnp.asarray(pids), K)
    pbatch = PB.Batch((), torch.from_numpy(mask), PT.Schema([]))
    perm, starts = PG.partition_perm(pbatch, torch.from_numpy(pids), K)
    np.testing.assert_array_equal(perm.numpy(), np.asarray(jperm))
    np.testing.assert_array_equal(starts.numpy(), np.asarray(jstarts))


def test_global_and_local_orders_by_code_stably():
    rng = np.random.default_rng(3)
    n, K = 3 * KN.PARTITION_TILE + 77, 5
    codes = rng.integers(0, K + 1, n).astype(np.int32)  # code K: dead rows
    perm, counts = KN.partition_sort(torch.from_numpy(codes), K)
    np.testing.assert_array_equal(perm.numpy(), np.argsort(codes, kind="stable"))
    assert counts.shape == (4, K + 1) and counts.sum() == n
    lperm, _ = KN.partition_sort(torch.from_numpy(codes), K, local=True)
    tiles = np.arange(n) // KN.PARTITION_TILE
    np.testing.assert_array_equal(lperm.numpy(), np.lexsort((codes, tiles)))


@pytest.mark.parametrize("local", [False, True])
def test_kernel_destination_rule_gives_the_plain_permutation(local):
    """The CUDA kernel writes perm[base[t, c] + rank] = i, where rank counts
    the earlier rows of code c in tile t; this replays that rule on the
    host with the wrapper's own base (partition_base)."""
    rng = np.random.default_rng(int(local))
    n, K = 5 * KN.PARTITION_TILE + 123, 9
    codes = np.where(rng.random(n) < 0.2, K, rng.integers(0, K, n)).astype(np.int32)
    want, counts = KN.partition_sort_plain(torch.from_numpy(codes), K, local=local)
    base = KN.partition_base(counts, local).numpy()
    perm = np.full(n, -1, np.int64)
    seen = {}
    for i, c in enumerate(codes):
        t = i // KN.PARTITION_TILE
        rank = seen.get((t, c), 0)
        seen[(t, c)] = rank + 1
        perm[base[t, c] + rank] = i
    np.testing.assert_array_equal(perm, want.numpy())


@pytest.mark.parametrize("bad", [-1, 17])
def test_codes_outside_range_raise(bad):
    codes = torch.tensor([0, 3, bad, 16], dtype=torch.int32)
    with pytest.raises(ValueError, match=r"outside \[0, 16\]"):
        KN.partition_sort(codes, 16)


def test_bad_arguments_raise():
    with pytest.raises(ValueError):
        KN.partition_sort(torch.zeros(4, dtype=torch.int32), 129)
    with pytest.raises(TypeError):
        KN.partition_sort(torch.zeros(4, dtype=torch.int64), 4)


_EDGES = {
    "INT64": np.array([0, 1, -1, 2**63 - 1, -2**63, 2**32, -2**32 - 7, 123456789012], np.int64),
    "INT32": np.array([0, 1, -1, 2**31 - 1, -2**31, 65536, -77, 9], np.int32),
    "DATE": np.array([0, -1, 8035, 10561, -719162, 2932896, 1, 20000], np.int32),
    "TIMESTAMP": np.array([0, -1, 1, 694224000000000, -62135596800000000, 253402300799999999,
                           2**63 - 1, -2**63], np.int64),
}


@pytest.mark.parametrize("tid", ["INT64", "INT32", "DATE", "TIMESTAMP"])
@pytest.mark.parametrize("K", [2, 16, 64])
def test_hash_pids_match_jax(tid, K):
    rng = np.random.default_rng(K)
    edge = _EDGES[tid]
    info = np.iinfo(edge.dtype)
    vals = np.concatenate([edge, rng.integers(info.min, info.max, 300, dtype=edge.dtype)])
    valid = rng.random(len(vals)) > 0.1
    jt, pt = getattr(JT, tid), getattr(PT, tid)
    data = {"k": vals}
    jb = JB.from_numpy(data, JT.Schema([JT.Field("k", jt)]), validity={"k": valid})
    pb = PB.from_numpy(data, PT.Schema([PT.Field("k", pt)]), "cpu", validity={"k": valid})
    jkey = JE.bind(JE.col("k"), jb.schema)
    pkey = PE.bind(PE.col("k"), pb.schema)
    want = JG._hash_pids(jb, [jkey], [None], K, JEvalContext())
    got = PG.hash_pids(pb, [pkey], [None], K)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert got.min() >= 0 and got.max() < K


def test_hash_pids_two_keys_and_widening_match_jax():
    """Two key columns chain the seed; an INT32 key joined to an INT64 key
    hashes as INT64 on both sides (grace_key_cast)."""
    rng = np.random.default_rng(5)
    data = {"a": rng.integers(-1000, 1000, 200).astype(np.int32),
            "b": rng.integers(-2**40, 2**40, 200).astype(np.int64)}
    valid = {"a": rng.random(200) > 0.2, "b": rng.random(200) > 0.2}
    jb = JB.from_numpy(data, JT.Schema([JT.Field("a", JT.INT32), JT.Field("b", JT.INT64)]),
                       validity=valid)
    pb = PB.from_numpy(data, PT.Schema([PT.Field("a", PT.INT32), PT.Field("b", PT.INT64)]),
                       "cpu", validity=valid)
    assert PG.grace_key_cast(PT.INT32, PT.INT64) == PT.INT64
    assert JG.grace_key_cast(JT.INT32, JT.INT64) == JT.INT64
    jkeys = [JE.bind(JE.col(c), jb.schema) for c in "ab"]
    pkeys = [PE.bind(PE.col(c), pb.schema) for c in "ab"]
    for jcasts, pcasts in (([None, None], [None, None]), ([JT.INT64, None], [PT.INT64, None])):
        want = JG._hash_pids(jb, jkeys, jcasts, 16, JEvalContext())
        got = PG.hash_pids(pb, pkeys, pcasts, 16)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_grace_key_cast_refuses_what_jax_refuses():
    for a, b in ((PT.FLOAT64, PT.FLOAT64), (PT.INT64, PT.DATE), (PT.decimal(10, 2), PT.INT64)):
        with pytest.raises(ValueError):
            PG.grace_key_cast(a, b)


def test_grace_key_cast_refuses_string_keys_until_their_hash_is_ported():
    """The JAX package partitions on string keys; the port has no murmur3 of
    strings yet, so such a join is not picked for grace and runs directly."""
    assert JG.grace_key_cast(JT.string(5), JT.string(5)) is None
    with pytest.raises(ValueError, match="unhashable"):
        PG.grace_key_cast(PT.string(5), PT.string(5))
    assert PG.grace_key_cast(PT.TIMESTAMP, PT.TIMESTAMP) is None

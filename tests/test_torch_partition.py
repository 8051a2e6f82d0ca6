"""PyTorch port, the stable partition (``exec/kernels.py::partition_columns``
and ``partition_sort``, the CUDA kernel's plain version on the CPU), the
grace join's partition ids and the compactions on it, exactly against the
JAX package:

- tile-local mode against the Pallas kernel it replaces,
  ``benchmarks/pallas_scatter_probe.py::tile_partition_sort_pallas``, run
  interpreted as it runs off the TPU: its sorted payload and its counts;
- global mode against ``exec/grace.py::partition_perm`` (perm and starts)
  and ``exec/grace.py::partition_sort`` (every column kind moved);
- ``compact_batch`` against ``exec/operators/basic.py::compact_batch``;
- the kernel's destination rule (grid, count matrix, tile ranks) replayed
  on the host against the plain version;
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
from datafusion_comet_tpu.exec.operators import basic as JBASIC
from datafusion_comet_tpu.ir import expr as JE
from datafusion_comet_tpu_torch import types as PT
from datafusion_comet_tpu_torch.exec import batch as PB
from datafusion_comet_tpu_torch.exec import grace as PG
from datafusion_comet_tpu_torch.exec import kernels as KN
from datafusion_comet_tpu_torch.exec.operators import basic as PBASIC
from datafusion_comet_tpu_torch.ir import expr as PE
from _torch_threads import one_torch_thread  # noqa: F401 (a fixture)

pytestmark = pytest.mark.usefixtures("one_torch_thread")

ROOT = Path(__file__).resolve().parent.parent


@pytest.fixture(scope="module")
def probe():
    spec = importlib.util.spec_from_file_location(
        "pallas_scatter_probe", ROOT / "benchmarks" / "pallas_scatter_probe.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _probe_inputs(probe, K, n=4096):
    rng = np.random.default_rng(K)
    codes = rng.integers(0, K, n).astype(np.int32)
    limbs = np.concatenate([probe.pack_limbs(rng.integers(0, 1 << 62, n).astype(np.int64))
                            for _ in range(4)], axis=1)
    want, want_counts = probe.tile_partition_sort_pallas(jnp.asarray(codes), jnp.asarray(limbs),
                                                         K, KN.PARTITION_TILE)
    return codes, limbs, np.asarray(want), np.asarray(want_counts).astype(np.int32)


@pytest.mark.parametrize("K", [16, 128])
def test_tile_local_matches_pallas_kernel(probe, K):
    codes, limbs, want, want_counts = _probe_inputs(probe, K)
    perm, counts = KN.partition_sort(torch.from_numpy(codes), K, local=True)
    np.testing.assert_array_equal(limbs[perm.numpy()], want)
    np.testing.assert_array_equal(counts[:, :K].numpy(), want_counts)
    assert counts[:, K].sum() == 0


@pytest.mark.parametrize("K", [16, 128])
def test_tile_local_payload_matches_pallas_kernel(probe, K):
    """partition_columns moves the payload itself, as the Pallas kernel's
    permutation matmul does: its output is the kernel's sorted limbs."""
    codes, limbs, want, want_counts = _probe_inputs(probe, K)
    (got,), counts = KN.partition_columns(torch.from_numpy(codes), K, [torch.from_numpy(limbs)],
                                          local=True)
    assert got.dtype == torch.float32 and got.shape == want.shape
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(counts[:, :K].numpy(), want_counts)


def _jax_mask_batch(mask: np.ndarray):
    return JB.Batch((), jnp.asarray(mask), JT.Schema([]))


@pytest.mark.parametrize("K,n,dead", [(1, 4096, 0.0), (2, 5000, 0.1), (16, 1000, 0.3),
                                      (64, 70_001, 0.05), (16, 777, 1.0)])
def test_global_matches_jax_partition_perm(K, n, dead):
    rng = np.random.default_rng(n + K)
    pids = rng.integers(0, K, n).astype(np.int32)
    mask = rng.random(n) >= dead
    jperm, jstarts = JG.partition_perm(_jax_mask_batch(mask), jnp.asarray(pids), K)
    perm, counts = KN.partition_sort(torch.from_numpy(np.where(mask, pids, K).astype(np.int32)), K)
    np.testing.assert_array_equal(perm.numpy(), np.asarray(jperm))
    sizes = counts.long().sum(0)[:K]
    np.testing.assert_array_equal(torch.cat([sizes.new_zeros(1), sizes.cumsum(0)]).numpy(),
                                  np.asarray(jstarts))


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


def _replay_kernel(codes: np.ndarray, K: int, local: bool, most_blocks: int) -> np.ndarray:
    """The destinations the CUDA kernel gives, computed as it does: block b
    takes the rows [b * per * 1024, (b + 1) * per * 1024); the count pass
    fills a code-major (K+1, blocks) matrix whose exclusive scan is each
    (code, block)'s first destination; the scatter pass walks the block's
    1024-row tiles in order and ranks each row among its tile's (local: its
    512-row tile's) rows of its code. Returns perm (perm[dest] = row)."""
    n = len(codes)
    blocks, per = KN.partition_grid(n, most_blocks)
    span = per * KN.B3_TILE
    assert (blocks - 1) * span < n <= blocks * span  # no block without a row
    cnt = np.zeros((K + 1, blocks), np.int64)
    np.add.at(cnt, (codes, np.arange(n) // span), 1)
    flat = cnt.reshape(-1)
    base = (np.cumsum(flat) - flat).reshape(K + 1, blocks)
    perm = np.full(n, -1, np.int64)
    for b in range(blocks):
        run = base[:, b].copy()
        for t0 in range(b * span, min((b + 1) * span, n), KN.B3_TILE):
            seg_len = KN.PARTITION_TILE if local else KN.B3_TILE
            for s0 in range(t0, min(t0 + KN.B3_TILE, n), seg_len):
                seg = codes[s0:min(s0 + seg_len, t0 + KN.B3_TILE, n)]
                starts = np.concatenate([[0], np.cumsum(np.bincount(seg, minlength=K + 1))])
                seen = np.zeros(K + 1, np.int64)
                for i, c in enumerate(seg):
                    dest = s0 + starts[c] + seen[c] if local else run[c] + seen[c]
                    perm[dest] = s0 + i
                    seen[c] += 1
                if not local:
                    run += seen
    return perm


@pytest.mark.parametrize("most_blocks", [1, 2, 660])
@pytest.mark.parametrize("local", [False, True])
def test_kernel_destination_rule_gives_the_plain_permutation(local, most_blocks):
    """The CUDA kernel's destination rule, replayed on the host with the
    wrapper's own grid (partition_grid), gives the plain permutation, for
    one block, two blocks of two tiles and one block a tile."""
    rng = np.random.default_rng(int(local))
    n, K = 5 * KN.PARTITION_TILE + 123, 9
    codes = np.where(rng.random(n) < 0.2, K, rng.integers(0, K, n)).astype(np.int32)
    want, _ = KN.partition_sort_plain(torch.from_numpy(codes), K, local=local)
    np.testing.assert_array_equal(_replay_kernel(codes, K, local, most_blocks), want.numpy())


@pytest.mark.parametrize("n,most,want", [(1, 660, (1, 1)), (1024, 660, (1, 1)),
                                         (1025, 660, (2, 1)), (16_777_216, 660, (656, 25)),
                                         (2_683, 2, (2, 2)), (70_001, 1, (1, 69))])
def test_partition_grid(n, most, want):
    """Blocks never outnumber the card's resident blocks or the tiles, and
    every block has at least one tile."""
    blocks, per = KN.partition_grid(n, most)
    assert (blocks, per) == want
    tiles = -(-n // KN.B3_TILE)
    assert blocks <= min(most, tiles) and (blocks - 1) * per < tiles <= blocks * per


@pytest.mark.parametrize("bad", [-1, 17])
def test_codes_outside_range_raise(bad):
    codes = torch.tensor([0, 3, bad, 16], dtype=torch.int32)
    with pytest.raises(ValueError, match=r"outside \[0, 16\]"):
        KN.partition_sort(codes, 16)
    with pytest.raises(ValueError, match=r"outside \[0, 16\]"):
        KN.partition_columns(codes, 16, [torch.arange(4)])


def test_bad_arguments_raise():
    with pytest.raises(ValueError):
        KN.partition_sort(torch.zeros(4, dtype=torch.int32), 129)
    with pytest.raises(TypeError):
        KN.partition_sort(torch.zeros(4, dtype=torch.int64), 4)
    mask = torch.ones(4, dtype=torch.bool)
    with pytest.raises(ValueError, match="num_parts=1"):
        KN.partition_columns(mask, 2, [])
    with pytest.raises(ValueError, match="limit"):
        KN.partition_columns(mask, 1, [], local=True, limit=2)
    with pytest.raises(ValueError, match="rows"):
        KN.partition_columns(mask, 1, [torch.zeros(5)])
    with pytest.raises(ValueError, match="64"):
        KN.partition_columns(mask, 1, [torch.zeros(4)] * 65)


@pytest.mark.parametrize("limit", [None, 0, 3000, 4096, 9000])
def test_plain_version_moves_every_width_by_the_stable_order(limit):
    """Rows of 1, 4, 8, 16 and 25 bytes follow the stable sort by code; a
    limit keeps that order's first rows; the sizes count every code."""
    rng = np.random.default_rng(11)
    n, K = 4096, 16
    codes = torch.from_numpy(np.where(rng.random(n) < 0.25, K, rng.integers(0, K, n))
                             .astype(np.int32))
    tensors = [torch.from_numpy(rng.random(n) < 0.5),
               torch.from_numpy(rng.integers(-2**31, 2**31, n).astype(np.int32)),
               torch.from_numpy(rng.integers(-2**63, 2**63 - 1, n, dtype=np.int64)),
               torch.from_numpy(rng.integers(-2**63, 2**63 - 1, (n, 2), dtype=np.int64)),
               torch.from_numpy(rng.integers(0, 256, (n, 25)).astype(np.uint8))]
    outs, sizes = KN.partition_columns(codes, K, tensors, limit=limit)
    order = np.argsort(codes.numpy(), kind="stable")[:limit]
    for t, o in zip(tensors, outs):
        assert o.dtype == t.dtype and o.shape == (len(order),) + tuple(t.shape[1:])
        np.testing.assert_array_equal(o.numpy(), t.numpy()[order])
    np.testing.assert_array_equal(sizes.numpy(), np.bincount(codes.numpy(), minlength=K + 1))


def _arrays(b, np_of):
    out = {"row_mask": np_of(b.row_mask)}
    for f, c in zip(b.schema.fields, b.columns):
        out[f"{f.name}.data"] = np_of(c.data)
        out[f"{f.name}.validity"] = np_of(c.validity)
        out[f"{f.name}.lengths"] = None if c.lengths is None else np_of(c.lengths)
        out[f"{f.name}.dict"] = None if c.dictionary is None else (
            c.dictionary.values.tobytes(), c.dictionary.lengths.tobytes())
        out[f"{f.name}.mag_bound"] = c.mag_bound
    return out


def _assert_same_arrays(j, p):
    assert sorted(j) == sorted(p)
    for k in j:
        a, b = j[k], p[k]
        if a is None or isinstance(a, (int, tuple)):
            assert a == b, k
        else:
            assert a.dtype == b.dtype and a.shape == b.shape, (k, a.dtype, b.dtype)
            np.testing.assert_array_equal(a, b, err_msg=k)


def _every_kind(M, n: int, seed: int):
    """A batch of every column kind: int64 with nulls, int32, dictionary
    codes, a two-limb decimal(38, 2), a padded string of width 5 (its
    dictionary refused), with about a fifth of the rows dead."""
    rng = np.random.default_rng(seed)
    data = {"a": rng.integers(-2**62, 2**62, n).astype(np.int64),
            "i": rng.integers(-2**31, 2**31, n).astype(np.int32),
            "d": np.array(["AIR", "MAIL", "SHIP", None], object)[rng.integers(0, 4, n)],
            "w": np.array([int(x) * 10**20 for x in rng.integers(-999, 999, n)], object),
            "s": np.array([f"s{j}" for j in rng.integers(0, 3000, n)], object)}
    validity = {"a": rng.random(n) > 0.1, "w": rng.random(n) > 0.1}
    schema = M.Schema([M.Field("a", M.INT64), M.Field("i", M.INT32), M.Field("d", M.string(4)),
                       M.Field("w", M.decimal(38, 2)), M.Field("s", M.string(5))])
    if M is JT:
        b = JB.from_numpy(data, schema, validity=validity, dict_max_size=16)
        live = np.asarray(b.row_mask) & (rng.random(b.capacity) > 0.2)
        return b.with_mask(jnp.asarray(live))
    b = PB.from_numpy(data, schema, "cpu", validity=validity, dict_max_size=16)
    live = b.row_mask.numpy() & (rng.random(b.capacity) > 0.2)
    return b.with_mask(torch.from_numpy(live))


@pytest.mark.parametrize("K,n", [(1, 3000), (16, 8192), (64, 5000)])
def test_grace_partition_sort_matches_jax(K, n):
    """Every column kind, moved into partition order in one pass, equals the
    JAX package's grace.partition_sort: data, validity, lengths, mask, starts."""
    jb, pb = _every_kind(JT, n, K), _every_kind(PT, n, K)
    assert pb.column("s").lengths is not None and pb.column("d").dictionary is not None
    assert pb.column("w").data.shape == (pb.capacity, 2)
    pids = np.random.default_rng(n).integers(0, K, pb.capacity).astype(np.int32)
    jsorted, jstarts = JG.partition_sort(jb, jnp.asarray(pids), K)
    psorted, pstarts = PG.partition_sort(pb, torch.from_numpy(pids), K)
    _assert_same_arrays(_arrays(jsorted, np.asarray), _arrays(psorted, lambda t: t.numpy()))
    np.testing.assert_array_equal(pstarts.numpy(), np.asarray(jstarts))


@pytest.mark.parametrize("n,new_cap", [(3000, 4096), (3000, 2048), (3000, 1024), (8192, 2048)])
def test_compact_batch_matches_jax(n, new_cap):
    """One pass of the partition with one part and a limit equals the JAX
    package's compact_batch, every buffer and the overflow flag included."""
    jb, pb = _every_kind(JT, n, 5), _every_kind(PT, n, 5)
    jout, jovf = JBASIC.compact_batch(jb, new_cap)
    pout, povf = PBASIC.compact_batch(pb, new_cap)
    assert pout.capacity == min(new_cap, pb.capacity)
    _assert_same_arrays(_arrays(jout, np.asarray), _arrays(pout, lambda t: t.numpy()))
    assert bool(povf) == bool(jovf) == (int(pb.num_rows()) > new_cap)


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
    """Both packages partition on string keys now that the port hashes
    strings (the name is kept from when it refused them): a string pair
    hashes as it is, a string against raw bytes is refused in both."""
    for M, G in ((JT, JG), (PT, PG)):
        assert G.grace_key_cast(M.string(5), M.string(5)) is None
        assert G.grace_key_cast(M.string(5), M.string(25)) is None
        with pytest.raises(ValueError, match="mixed"):
            G.grace_key_cast(M.string(5), M.binary(5))
    assert PG.grace_key_cast(PT.TIMESTAMP, PT.TIMESTAMP) is None

"""The port's hand-written CUDA kernels and their plain PyTorch versions:
per-bucket counts and exact int64 sums over int32 bucket codes
(``csrc/bucket_kernels.cu``), which the dense aggregate runs on, port of
``datafusion_comet_tpu/exec/pallas_kernels.py``; and the stable partition
(``csrc/partition_kernels.cu``), which moves rows with their payload into
partition order for the grace join and every compaction, port of
``benchmarks/pallas_scatter_probe.py::tile_partition_sort_pallas``.
Part one below is the bucket kernels, part two the partition.

Contract of the bucket kernels: ``codes`` int32 (n,) in [0, B] with 1 <=
B <= 4096; code == B marks a dead row (padding or filtered out) and is
dropped; a code outside [0, B] raises. For every wrapper, a CPU tensor goes
to the plain PyTorch version, a CUDA tensor launches the kernel or raises:
there is no fallback. Each wrapper counts its launches in
``<wrapper>.launches``.

On the card the kernel flags codes outside [0, B] in a device scalar.
Given ``errors`` (a query's ``EvalContext.errors``), the wrapper appends
the flag there and the session reads it with every other flag at the end
of the query; without it the wrapper reads the flag at once (a host sync).

bucket_count replaces ``pallas_kernels.py::_kernel`` (launched by
``_bucket_count_pallas``). On the TPU each 2048-row tile becomes a one-hot
(TILE, B) f32 matrix, column-summed into a VMEM accumulator carried across
the sequential grid: exact only to 2^24 rows per bucket.

bucket_sum replaces ``pallas_kernels.py::_sum_kernel`` (launched by
``_bucket_sum_pallas``). On the TPU values split by sign into 4 byte limbs
each, one (8, TILE) @ (TILE, B) one-hot matmul per tile, and an f32
cross-tile accumulator: gated to 32-bit values and not exact from about 2M
rows on.

Bound on an H100 (3.35 TB/s): each reads 4 bytes of code per row, plus 8
bytes per live row and lane of values for bucket_sum, and writes 8 bytes per
bin. At Q1's SF1 shape (n = 8,388,608 rows, 5.9M of them live, B = 64) that
is 33.6 MB, 10 us, for a count and about 223 MB, 67 us, for a four-lane sum.

Design. Blocks run in parallel with nothing carried between them, so each
keeps private bins in shared memory and flushes each nonzero bin with one
global u64 atomic into an output the wrapper zeroes; u64 addition wraps mod
2^64, so sums are exact two's-complement int64 at any n, with no float
anywhere. The first design kept one u64 histogram per block and did a
64-bit shared atomicAdd per row and lane: on sm_90a that is a
compare-and-swap loop, and Q1's rows fall on 6 of 64 buckets, so every
warp spun on the same few words (7% and 22% of the byte bounds on an H100).
The kernels now use only native 32-bit shared atomics and never put two
lanes of a warp on one word where the domain is small. ``bucket_layout(k,
B)`` picks, from the shape alone:

- ``count_private`` (count, B <= 227): per-thread u32 counters, bin-major
  with the thread minor, incremented with a plain ``++``; B KB at 256
  threads.
- ``count_shared`` (count, B >= 228): one u32 histogram per block, each
  warp's equal codes grouped by ``__match_any_sync`` and added once.
- ``sum_replicated`` (sums, k * B <= 908 per launch): 32 lane copies of
  the bins, each a u32 lo and hi word; the lo add returns the old word and
  its carry goes into the hi add. k * B * 256 bytes; more lanes than fit
  go to further launches.
- ``sum_shared`` (sums, B >= 909): one lo/hi histogram per block, an
  atomic pair per live row and lane.

Codes are read as 16-byte vectors with the unaligned head and the ragged
tail taken row by row; values only for live rows, and not at all by a warp
whose tile holds no live row. The grid is what the layout's occupancy allows
on every SM, but no more blocks than give each at least one tile a warp and
as many code bytes as it holds shared bytes, so small inputs (the grace
join's pairs) do not pay to zero and flush many blocks.
"""

from __future__ import annotations

import ctypes
import functools
import math
from typing import List, NamedTuple, Optional, Sequence, Tuple

import torch

from datafusion_comet_tpu_torch.exec import _build

__all__ = ["bucket_count", "bucket_sum", "bucket_count_plain", "bucket_sum_plain",
           "bucket_layout", "BucketLayout", "grid_for", "zeroed_outputs", "MAX_BUCKETS",
           "SMEM_MAX", "partition_columns", "partition_columns_plain", "partition_sort",
           "partition_sort_plain", "partition_grid", "PARTITION_TILE", "B3_TILE", "MAX_PARTS",
           "MAX_COLUMNS"]

MAX_BUCKETS = 4096
SMEM_MAX = 232_448  # kSmemMax in the .cu: the H100's opt-in shared memory per block
_THREADS = 256  # kThreads in the .cu
_TILE_ROWS = 512  # rows a warp takes per tile: 32 lanes x 4 vectors x 4 codes
# the kernel variants, in the order of the .cu's Layout enum
LAYOUTS = ("count_private", "count_shared", "sum_replicated", "sum_shared")


class BucketLayout(NamedTuple):
    """One launch's kernel variant (a name of ``LAYOUTS``), its threads a
    block, its dynamic shared bytes a block, and the value lanes it takes
    (0 for a count)."""
    name: str
    threads: int
    smem_bytes: int
    lanes: int


def _round16(x: int) -> int:
    return -(-x // 16) * 16


def bucket_layout(k: int, num_buckets: int) -> BucketLayout:
    """The kernel variant for k value lanes (0: a count) over B buckets,
    chosen from the shape alone. A sum whose lanes do not all fit one
    block's shared memory takes ``lanes`` per launch."""
    B = num_buckets
    if k == 0:
        if 4 * B * _THREADS <= SMEM_MAX:
            return BucketLayout("count_private", _THREADS, 4 * B * _THREADS, 0)
        return BucketLayout("count_shared", _THREADS, _round16(4 * B), 0)
    if 8 * B * 32 <= SMEM_MAX:
        lanes = min(k, SMEM_MAX // (8 * B * 32))
        return BucketLayout("sum_replicated", _THREADS, 8 * lanes * B * 32, lanes)
    lanes = min(k, SMEM_MAX // (8 * B))
    return BucketLayout("sum_shared", _THREADS, _round16(8 * lanes * B), lanes)


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    lib = _build.load("bucket_kernels")
    p, i64, i32 = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
    lib.bucket_launch.argtypes = [i32, p, p, i64, i32, i32, i32, i32, p, p, p]
    lib.bucket_launch.restype = i32
    lib.bucket_blocks_per_sm.argtypes = [i32, i32, ctypes.POINTER(i32)]
    lib.bucket_blocks_per_sm.restype = i32
    for name in ("bucket_kernels_smem_max", "bucket_kernels_threads"):
        getattr(lib, name).argtypes = []
        getattr(lib, name).restype = i32
    if (lib.bucket_kernels_smem_max(), lib.bucket_kernels_threads()) != (SMEM_MAX, _THREADS):
        raise RuntimeError("bucket_kernels.cu and kernels.py disagree on shared bytes or threads")
    return lib


def _check(codes: torch.Tensor, num_buckets: int) -> None:
    if not 1 <= num_buckets <= MAX_BUCKETS:
        raise ValueError(f"num_buckets={num_buckets} outside [1, {MAX_BUCKETS}]")
    if codes.dtype != torch.int32 or codes.dim() != 1:
        raise TypeError(f"codes must be 1-D int32, got {codes.dtype} {tuple(codes.shape)}")


def _check_range_cpu(codes: torch.Tensor, num_buckets: int) -> None:
    if codes.numel() and (int(codes.min()) < 0 or int(codes.max()) > num_buckets):
        raise ValueError(f"bucket codes outside [0, {num_buckets}]")


def _on_card(*tensors: torch.Tensor) -> None:
    for t in tensors:
        if t.device.type != "cuda":
            raise ValueError(f"the kernels take CPU or CUDA tensors, got {t.device}")


def _raise(rc: int, what: str) -> None:
    if rc:
        raise RuntimeError(f"{what} launch failed: CUDA error {rc}")


@functools.lru_cache(maxsize=None)
def _most_blocks(layout: BucketLayout, device: int) -> int:
    """Blocks of ``layout`` resident on the whole card at once."""
    per_sm = ctypes.c_int(0)
    with torch.cuda.device(device):
        _raise(_lib().bucket_blocks_per_sm(LAYOUTS.index(layout.name), layout.smem_bytes,
                                           ctypes.byref(per_sm)), f"{layout.name} occupancy")
    if per_sm.value < 1:
        raise RuntimeError(f"{layout} fits no SM")
    return per_sm.value * torch.cuda.get_device_properties(device).multi_processor_count


def grid_for(layout: BucketLayout, n: int, most_blocks: int) -> int:
    """Blocks for n rows: as many as fit the card at once (``most_blocks``),
    but no more than give each block one tile a warp and at least as many
    code bytes (4 a row) as it zeroes and flushes of shared memory."""
    tile_rows = _TILE_ROWS * layout.threads // 32  # one tile for each warp of a block
    grid = max(1, min(most_blocks, -(-n // max(tile_rows, layout.smem_bytes // 4))))
    # u32 counters and shared words: no block may see 2^32 rows
    if (-(-n // (grid * tile_rows)) + 1) * tile_rows >= 1 << 32:
        raise ValueError(f"{n} rows over {grid} blocks overflow the kernels' u32 counters")
    return grid


@functools.lru_cache(maxsize=1024)
def _launch_plan(k: int, num_buckets: int, n: int, device: int) -> Tuple[int, int, int]:
    """(variant, shared bytes, blocks) of one launch over n rows and k
    lanes (0: a count), from the shape alone; cached, so that a call's host
    path does one lookup."""
    lay = bucket_layout(k, num_buckets)
    return LAYOUTS.index(lay.name), lay.smem_bytes, grid_for(lay, n, _most_blocks(lay, device))


def _launch(codes: torch.Tensor, values: Optional[torch.Tensor], k: int, num_buckets: int,
            out: torch.Tensor, bad: torch.Tensor, what: str) -> None:
    """One kernel launch on the current stream over the k lanes of
    contiguous ``values`` (None for a count) into zeroed ``out`` and
    ``bad``; k lanes must fit one launch. No checks, no count."""
    n = codes.shape[0]
    variant, smem, grid = _launch_plan(k, num_buckets, n, codes.device.index or 0)
    stream = torch.cuda.current_stream(codes.device).cuda_stream
    _raise(_lib().bucket_launch(variant, codes.data_ptr(),
                                None if values is None else values.data_ptr(), n, k,
                                num_buckets, smem, grid, out.data_ptr(), bad.data_ptr(),
                                stream), what)


def zeroed_outputs(shape: Tuple[int, ...], device) -> Tuple[torch.Tensor, torch.Tensor]:
    """A zeroed int64 output of ``shape`` and the zeroed bad-code flag (1,),
    as views of one buffer: one memset a call instead of two."""
    size = math.prod(shape)
    buf = torch.zeros(size + 1, dtype=torch.int64, device=device)
    return buf[:size].view(shape), buf[size:]


def _report_bad(bad: torch.Tensor, num_buckets: int,
                errors: Optional[List[Tuple[torch.Tensor, str]]], what: str = "bucket") -> None:
    msg = f"{what} codes outside [0, {num_buckets}]"
    if errors is not None:
        errors.append((bad, msg))
    elif int(bad.item()):
        raise ValueError(msg)


def bucket_count_plain(codes: torch.Tensor, num_buckets: int) -> torch.Tensor:
    """Plain PyTorch version of bucket_count (any device)."""
    out = torch.zeros(num_buckets + 1, dtype=torch.int64, device=codes.device)
    out.index_add_(0, codes.long(), torch.ones(codes.shape[0], dtype=torch.int64,
                                               device=codes.device))
    return out[:num_buckets]


def bucket_sum_plain(codes: torch.Tensor, values: torch.Tensor, num_buckets: int) -> torch.Tensor:
    """Plain PyTorch version of bucket_sum (any device)."""
    v = values if values.dim() == 2 else values[None]
    out = torch.zeros(v.shape[0], num_buckets + 1, dtype=torch.int64, device=codes.device)
    out.index_add_(1, codes.long(), v)
    out = out[:, :num_buckets]
    return out if values.dim() == 2 else out[0]


def bucket_count(codes: torch.Tensor, num_buckets: int,
                 errors: Optional[List[Tuple[torch.Tensor, str]]] = None) -> torch.Tensor:
    """Histogram int64 (B,) of codes in [0, B); code == B is dropped."""
    _check(codes, num_buckets)
    if codes.device.type == "cpu":
        _check_range_cpu(codes, num_buckets)
        return bucket_count_plain(codes, num_buckets)
    _on_card(codes)
    codes = codes.contiguous()
    out, bad = zeroed_outputs((num_buckets,), codes.device)
    if codes.shape[0]:
        _launch(codes, None, 0, num_buckets, out, bad, "bucket_count")
        bucket_count.launches += 1
    _report_bad(bad, num_buckets, errors)
    return out


bucket_count.launches = 0


def bucket_sum(codes: torch.Tensor, values: torch.Tensor, num_buckets: int,
               errors: Optional[List[Tuple[torch.Tensor, str]]] = None) -> torch.Tensor:
    """Exact per-bucket int64 sums (mod 2^64, as int64 addition wraps):
    values (n,) -> (B,), or (k, n) -> (k, B) with one launch for as many
    lanes as ``bucket_layout(k, B)`` takes (all four of Q1's at B = 64)."""
    _check(codes, num_buckets)
    if values.dtype != torch.int64 or values.dim() not in (1, 2) \
            or values.shape[-1] != codes.shape[0]:
        raise TypeError(f"values must be int64 (n,) or (k, n) with n={codes.shape[0]}, "
                        f"got {values.dtype} {tuple(values.shape)}")
    if codes.device.type == "cpu" and values.device.type == "cpu":
        _check_range_cpu(codes, num_buckets)
        return bucket_sum_plain(codes, values, num_buckets)
    _on_card(codes, values)
    v = (values if values.dim() == 2 else values[None]).contiguous()
    codes = codes.contiguous()
    out, bad = zeroed_outputs((v.shape[0], num_buckets), codes.device)
    k = v.shape[0]
    if codes.shape[0] and k:
        per = bucket_layout(k, num_buckets).lanes  # more lanes go to further launches
        for j in range(0, k, per):
            _launch(codes, v[j], min(per, k - j), num_buckets, out[j], bad, "bucket_sum")
            bucket_sum.launches += 1
    _report_bad(bad, num_buckets, errors)
    return out if values.dim() == 2 else out[0]


bucket_sum.launches = 0


# =====================================================================================
# Part two: the stable partition (B3), payload included
# =====================================================================================
#
# partition_columns and partition_sort replace benchmarks/pallas_scatter_probe.py::
# kernel, launched by tile_partition_sort_pallas (pallas_call at :93), and the
# lax.sort of (key, iota, payload) in the JAX package's grace.partition_sort and
# compact_batch. Contract: codes int32 (n,) in [0, K] with 1 <= K <= 128, code K
# marking a dead row, or, for K = 1, the bool row mask itself (live rows code 0).
# Two destination rules share one kernel:
#   - global: the stable sort of the rows by code, dead rows last (bit for bit
#     the JAX package's lax.sort with iota as the tie-break); a ``limit`` keeps
#     the first ``limit`` rows of that order and writes nothing past them;
#   - local: each 512-row tile's rows ordered by code, stably, in the tile's own
#     slots (the TPU kernel's contract, whose counts are counts[:, :K]).
# partition_columns moves the given tensors' rows (any dtype, any row width)
# into that order and returns the per-code totals (global) or the per-tile
# counts (local); partition_sort returns the permutation and the per-tile
# counts. A code outside [0, K] raises; on the card it is flagged as for the
# bucket kernels (sorted as dead meanwhile).
#
# On the TPU each 512-row tile became a one-hot (tile, 128) f32 matrix;
# triangular matmuls took the prefix sums (Mosaic has no cumsum) and a (tile,
# tile) one-hot permutation matmul moved 16-bit limb planes of the payload.
# Here (csrc/partition_kernels.cu) a global call is two launches with nothing
# between them: a count pass over a persistent grid, whose last block scans the
# (K+1, blocks) count matrix on the card, and a scatter pass that ranks each
# 1024-row tile stably (__match_any_sync, warp-private histograms), copies the
# columns' rows into shared memory with cp.async, a group of columns at a time,
# and writes them out in destination order, as runs of one code. A local call
# is the scatter pass alone. Nothing is gathered afterwards.
#
# Bound on an H100 (3.35 TB/s), each input read once and each output written
# once: 4 bytes of code a row (1 for a mask), each moved row's bytes read and
# written, and the totals. At Q12's SF10 orders side (n = 16,777,216, K = 16,
# five tensors of 15 bytes a row in all) 570 MB, 0.170 ms; at Q12 direct's
# SF10 compaction (n = 268,435,456, a limit of 134,217,728 rows, 44 bytes a
# row) 12.1 GB, 3.61 ms.

PARTITION_TILE = 512  # kLocalTile in the .cu: the TPU kernel's tile, one row of counts
B3_TILE = 1024  # kTile in the .cu: rows a block ranks at once
MAX_PARTS = 128
MAX_COLUMNS = 64  # kMaxCols in the .cu: tensors one call moves


@functools.lru_cache(maxsize=None)
def _plib() -> ctypes.CDLL:
    lib = _build.load("partition_kernels")
    p, i64, i32 = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
    lib.b3_launch.argtypes = [p, i32, i64, i32, i32, i64, i32, i32, p, p, p, p, p, p, i32,
                              ctypes.POINTER(p), ctypes.POINTER(p), ctypes.POINTER(i64),
                              ctypes.POINTER(i32), p]
    lib.b3_launch.restype = i32
    lib.b3_blocks_per_sm.argtypes = [ctypes.POINTER(i32)]
    lib.b3_blocks_per_sm.restype = i32
    for name in ("b3_tile", "b3_max_parts", "b3_max_columns"):
        getattr(lib, name).argtypes = []
        getattr(lib, name).restype = i32
    if (lib.b3_tile(), lib.b3_max_parts(), lib.b3_max_columns()) != (B3_TILE, MAX_PARTS,
                                                                    MAX_COLUMNS):
        raise RuntimeError("partition_kernels.cu and kernels.py disagree on tile, parts or columns")
    return lib


@functools.lru_cache(maxsize=None)
def _b3_most_blocks(device: int) -> int:
    """Scatter-pass blocks resident on the whole card at once."""
    per_sm = ctypes.c_int(0)
    with torch.cuda.device(device):
        _raise(_plib().b3_blocks_per_sm(ctypes.byref(per_sm)), "partition occupancy")
    if per_sm.value < 1:
        raise RuntimeError("the partition kernel fits no SM")
    return per_sm.value * torch.cuda.get_device_properties(device).multi_processor_count


def partition_grid(n: int, most_blocks: int) -> Tuple[int, int]:
    """(blocks, tiles a block) of one call over n >= 1 rows: each block takes
    a contiguous run of 1024-row tiles, as many blocks as fit the card at
    once, and none without a tile. Block b's rows are [b * tiles * 1024,
    (b + 1) * tiles * 1024)."""
    tiles = -(-n // B3_TILE)
    per = -(-tiles // max(1, min(most_blocks, tiles)))
    return -(-tiles // per), per


def _check_parts(codes: torch.Tensor, num_parts: int) -> None:
    if not 1 <= num_parts <= MAX_PARTS:
        raise ValueError(f"num_parts={num_parts} outside [1, {MAX_PARTS}]")
    if codes.dim() != 1 or codes.dtype not in (torch.int32, torch.bool):
        raise TypeError(f"codes must be 1-D int32 (or a bool row mask), got {codes.dtype} "
                        f"{tuple(codes.shape)}")
    if codes.dtype == torch.bool and num_parts != 1:
        raise ValueError("a bool row mask partitions into num_parts=1 (live rows, then dead)")
    if codes.shape[0] >= 1 << 31:
        raise ValueError("the partition takes fewer than 2^31 rows (int32 indices)")
    if codes.device.type == "cpu" and codes.dtype == torch.int32 and codes.numel() and (
            int(codes.min()) < 0 or int(codes.max()) > num_parts):
        raise ValueError(f"partition codes outside [0, {num_parts}]")


def _sort_key(codes: torch.Tensor, num_parts: int, local: bool) -> torch.Tensor:
    """The key whose stable sort is the partition order: the code (a mask's
    live rows 0, dead 1), or (local) tile x (K + 1) + code."""
    key = (~codes).long() if codes.dtype == torch.bool else codes.long()
    if local:
        key = key + torch.arange(codes.shape[0], device=codes.device) // PARTITION_TILE * (
            num_parts + 1)
    return key


def _tile_counts_plain(key: torch.Tensor, num_parts: int) -> torch.Tensor:
    t, nb = -(-key.shape[0] // PARTITION_TILE), num_parts + 1
    return torch.bincount(key, minlength=t * nb).view(t, nb).int()


def partition_columns_plain(codes: torch.Tensor, num_parts: int, tensors: Sequence[torch.Tensor],
                            local: bool = False, limit: Optional[int] = None
                            ) -> Tuple[List[torch.Tensor], torch.Tensor]:
    """Plain PyTorch version of partition_columns (any device): one stable
    sort of the key, then one index_select per tensor."""
    key = _sort_key(codes, num_parts, local)
    counts = (_tile_counts_plain(key, num_parts) if local
              else torch.bincount(key, minlength=num_parts + 1))
    perm = torch.sort(key, stable=True).indices
    if limit is not None:
        perm = perm[:limit]
    return [t.index_select(0, perm) for t in tensors], counts


def _word_bytes(width: int, *ptrs: int) -> int:
    """The widest word (16, 8, 4, 2 or 1 bytes) that divides a row's width
    and aligns every pointer."""
    for w in (16, 8, 4, 2):
        if width % w == 0 and all(p % w == 0 for p in ptrs):
            return w
    return 1


def _launch_b3(codes: torch.Tensor, num_parts: int, ins: Sequence[torch.Tensor],
               outs: Sequence[torch.Tensor], local: bool, limit: int, aux: torch.Tensor,
               perm: Optional[torch.Tensor], tile_counts: Optional[torch.Tensor]) -> None:
    """Both passes (the scatter pass alone when ``local``) on the current
    stream, over n >= 1 rows, into zeroed ``aux`` (K + 1 totals, the bad
    flag, the last block's ticket); no checks, no count."""
    n = codes.shape[0]
    dev = codes.device
    blocks, per = partition_grid(n, _b3_most_blocks(dev.index or 0))
    cnt = torch.empty((num_parts + 1) * blocks, dtype=torch.int32, device=dev)
    moved = [(i, o) for i, o in zip(ins, outs) if i.numel()]
    k = len(moved)
    words, word_bytes = [], []
    for i, o in moved:
        width = i.numel() // n * i.element_size()
        w = _word_bytes(width, i.data_ptr(), o.data_ptr())
        words.append(width // w)
        word_bytes.append(w)
    p = ctypes.c_void_p
    k8 = aux.element_size()
    _raise(_plib().b3_launch(
        codes.data_ptr(), int(codes.dtype == torch.bool), n, num_parts, int(local), limit, blocks,
        per, cnt.data_ptr(), aux.data_ptr(), aux.data_ptr() + k8 * (num_parts + 1),
        aux.data_ptr() + k8 * (num_parts + 2), None if perm is None else perm.data_ptr(),
        None if tile_counts is None else tile_counts.data_ptr(), k,
        (p * k)(*[i.data_ptr() for i, _ in moved]), (p * k)(*[o.data_ptr() for _, o in moved]),
        (ctypes.c_longlong * k)(*words), (ctypes.c_int * k)(*word_bytes),
        torch.cuda.current_stream(dev).cuda_stream), "partition")


def _partition_columns_card(codes: torch.Tensor, num_parts: int, tensors: Sequence[torch.Tensor],
                            local: bool, limit: Optional[int],
                            errors: Optional[List[Tuple[torch.Tensor, str]]]
                            ) -> Tuple[List[torch.Tensor], torch.Tensor]:
    _on_card(codes, *tensors)
    codes = codes.contiguous()
    tensors = [t.contiguous() for t in tensors]
    n = codes.shape[0]
    rows = n if limit is None else max(0, min(limit, n))
    outs = [torch.empty((rows,) + tuple(t.shape[1:]), dtype=t.dtype, device=t.device)
            for t in tensors]
    aux = torch.zeros(num_parts + 3, dtype=torch.int64, device=codes.device)
    tile_counts = (torch.empty(-(-n // PARTITION_TILE), num_parts + 1, dtype=torch.int32,
                               device=codes.device) if local else None)
    if n:
        _launch_b3(codes, num_parts, tensors, outs, local, rows, aux, None, tile_counts)
        partition_columns.launches += 1 if local else 2  # the count pass, the scatter pass
    if codes.dtype == torch.int32:
        _report_bad(aux[num_parts + 1:num_parts + 2], num_parts, errors, "partition")
    return outs, tile_counts if local else aux[:num_parts + 1]


def partition_columns(codes: torch.Tensor, num_parts: int, tensors: Sequence[torch.Tensor],
                      local: bool = False, limit: Optional[int] = None,
                      errors: Optional[List[Tuple[torch.Tensor, str]]] = None,
                      tag: Optional[str] = None) -> Tuple[List[torch.Tensor], torch.Tensor]:
    """The rows of each tensor (n, ...) in partition order: (reordered
    tensors, sizes). Global: sizes are the int64 (K + 1,) rows of each code,
    dead rows (code K) included, and ``limit`` keeps the first ``limit`` rows
    of the order. Local: sizes are the int32 (T, K + 1) counts of each 512-row
    tile. At most 64 tensors a call. ``tag`` names the call in the log."""
    _check_parts(codes, num_parts)
    n = codes.shape[0]
    if local and limit is not None:
        raise ValueError("a limit applies to the global order only")
    if len(tensors) > MAX_COLUMNS:
        raise ValueError(f"{len(tensors)} tensors, more than {MAX_COLUMNS} a call")
    for t in tensors:
        if t.dim() == 0 or t.shape[0] != n:
            raise ValueError(f"a tensor of shape {tuple(t.shape)} has not the codes' {n} rows")
    if codes.device.type == "cpu":
        outs, sizes = partition_columns_plain(codes, num_parts, tensors, local, limit)
    else:
        outs, sizes = _partition_columns_card(codes, num_parts, tensors, local, limit, errors)
    if partition_columns.log is not None:
        partition_columns.log.append({
            "n": n, "K": num_parts, "local": local, "limit": limit,
            "codes": str(codes.dtype).replace("torch.", ""),
            "tensors": [(str(t.dtype).replace("torch.", ""), tuple(t.shape[1:])) for t in tensors],
            "sizes": sizes, "code_values": codes.clone(), "tag": tag})
    return outs, sizes


partition_columns.launches = 0
# None, or a list that gets each call's shape, its sizes tensor, a copy of its
# codes and its tag (chip_smoke.py reads it around one run of a query, apart
# from the runs it times)
partition_columns.log = None


def partition_sort_plain(codes: torch.Tensor, num_parts: int, local: bool = False
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of partition_sort (any device): per-tile
    bincount and one stable sort."""
    key = _sort_key(codes, num_parts, local)
    counts = _tile_counts_plain(key if local else _sort_key(codes, num_parts, True), num_parts)
    return torch.sort(key, stable=True).indices.int(), counts


def partition_sort(codes: torch.Tensor, num_parts: int, local: bool = False,
                   errors: Optional[List[Tuple[torch.Tensor, str]]] = None
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(perm int32 (n,), counts int32 (T, K+1)): the stable sort of rows by
    code, across the whole input or (``local``) inside each 512-row tile,
    with the counts of each 512-row tile; no payload moves."""
    _check_parts(codes, num_parts)
    if codes.device.type == "cpu":
        return partition_sort_plain(codes, num_parts, local)
    _on_card(codes)
    codes = codes.contiguous()
    n = codes.shape[0]
    counts = torch.empty(-(-n // PARTITION_TILE), num_parts + 1, dtype=torch.int32,
                         device=codes.device)
    perm = torch.empty(n, dtype=torch.int32, device=codes.device)
    aux = torch.zeros(num_parts + 3, dtype=torch.int64, device=codes.device)
    if n:
        _launch_b3(codes, num_parts, (), (), local, n, aux, perm, counts)
        partition_sort.launches += 1 if local else 2
    if codes.dtype == torch.int32:
        _report_bad(aux[num_parts + 1:num_parts + 2], num_parts, errors, "partition")
    return perm, counts


partition_sort.launches = 0

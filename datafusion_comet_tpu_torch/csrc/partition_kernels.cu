// Stable partition of rows by a small code, payload included, for Hopper
// (sm_90a). Replaces benchmarks/pallas_scatter_probe.py::kernel (launched by
// tile_partition_sort_pallas): there each 512-row tile's destinations came
// from one-hot prefix matmuls and a (tile, tile) permutation matmul moved the
// rows' 16-bit limb planes. Here the rows themselves are moved, every column
// in one pass. Plain C entry points, loaded with ctypes by
// datafusion_comet_tpu_torch/exec/_build.py; the Python wrappers
// (partition_columns, partition_sort), the plain PyTorch version and the
// grid arithmetic live in exec/kernels.py.
//
// Contract: the row codes are int32 in [0, K] with 1 <= K <= kMaxParts, code
// K marking a dead row, or (K = 1) a bool row mask whose live rows take code 0
// and dead rows code 1. An int32 code outside [0, K] is counted into *bad and
// sorted as dead. Two destination rules:
//   - global: stable and code-major over the whole input, dead rows last;
//     rows whose destination is at or past `limit` write nothing;
//   - local: inside each 512-row tile, code-major and stable, in the tile's
//     own slots (the TPU kernel's contract).
// Outputs, each optional: every column (a row of 1-16 bytes or any multiple
// of its word) in destination order, the destinations' row indices (perm),
// the per-code totals (global), the per-(512-row tile, code) counts.
//
// Design. Bound by bytes: the codes read once, each row of each column read
// once and written once. A persistent grid (occupancy x SMs) gives each block
// a contiguous run of 1024-row tiles, so that a block's rows keep their order.
//   1. Count (global only): each block counts its rows' codes in per-warp
//      histograms (the lanes of one code found by __match_any_sync, their
//      leader adding __popc: no shared atomics), codes read as 16-byte
//      vectors, and writes one count per code into a code-major (K+1, G)
//      matrix. The last block to finish (a ticket) scans that matrix in place
//      into each (code, block)'s first destination and writes the totals: the
//      cross-block prefix never leaves the card.
//   2. Scatter: each block walks its tiles in order with the next tile's
//      codes in flight (cp.async) while the current one is ranked: per warp,
//      128 rows ranked stably with __match_any_sync into a warp-private
//      histogram; then a scan over the warps and one over the codes gives
//      each row its slot in the tile (code-major) and its destination. The
//      columns' rows are copied into shared memory with cp.async, a group
//      of columns at a time with all their copies in flight (16-byte chunks
//      that hold a row to be written), and written out in slot order, so
//      consecutive threads write consecutive rows of one code's run. A tile
//      with no row before the limit moves no column.
// Local mode needs no count pass: one launch.

#include <cstdint>
#include <cuda_pipeline.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kTile = 1024;               // rows a block ranks at once
constexpr int kWarpRows = kTile / kWarps;  // 128: four rounds of 32 lanes
constexpr int kLocalTile = 512;           // the TPU kernel's tile
constexpr int kMaxParts = 128;
constexpr int kBins = kMaxParts + 2;      // codes 0..K, and K + 1 for rows past n
constexpr int kMaxCols = 64;
constexpr int kStageBytes = kTile * 16;   // 16 bytes of every row of a tile
constexpr unsigned kFull = 0xffffffffu;

struct Columns {
  const void* in[kMaxCols];
  void* out[kMaxCols];
  int64_t words[kMaxCols];  // words a row
  int word_bytes[kMaxCols];  // 1, 2, 4, 8 or 16
  int count;
};

__device__ __forceinline__ int clean_code(int c, int K, int& nbad) {
  if (static_cast<unsigned>(c) > static_cast<unsigned>(K)) {
    ++nbad;
    return K;
  }
  return c;
}

// Block-wide exclusive scan of one int a thread; returns the thread's prefix.
__device__ int block_exclusive_scan(int v, int* warp_sums) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int x = v;
  for (int d = 1; d < 32; d <<= 1) {
    const int y = __shfl_up_sync(kFull, x, d);
    if (lane >= d) x += y;
  }
  if (lane == 31) warp_sums[warp] = x;
  __syncthreads();
  int before = 0;
  for (int w = 0; w < warp; ++w) before += warp_sums[w];
  return before + x - v;
}

// ---- pass 1: counts per (code, block), then the last block's scan --------------------

template <bool kMask>
__global__ void __launch_bounds__(kThreads)
b3_count_kernel(const void* __restrict__ src, int64_t n, int K, int tiles_per_block, int G,
                int32_t* __restrict__ cnt, int64_t* __restrict__ totals,
                unsigned long long* __restrict__ bad, unsigned long long* __restrict__ ticket) {
  __shared__ int hist[kWarps][kBins];
  __shared__ int warp_sums[kWarps];
  __shared__ bool last;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int i = threadIdx.x; i < kWarps * kBins; i += kThreads) (&hist[0][0])[i] = 0;
  __syncthreads();
  const int64_t r0 = static_cast<int64_t>(blockIdx.x) * tiles_per_block * kTile;
  const int64_t r1 = r0 + static_cast<int64_t>(tiles_per_block) * kTile < n
                         ? r0 + static_cast<int64_t>(tiles_per_block) * kTile : n;
  int nbad = 0;
  if (kMask) {
    // live rows: bytes != 0, 16 a vector; the block's start is 16-aligned
    // when the mask is (r0 is a multiple of kTile)
    const uint8_t* m = static_cast<const uint8_t*>(src);
    int live = 0;
    int64_t i = r0;
    if ((reinterpret_cast<uintptr_t>(m) & 15) == 0) {
      const int64_t v1 = r0 + ((r1 - r0) & ~int64_t(15));
      for (int64_t v = r0 + 16 * threadIdx.x; v < v1; v += 16 * kThreads) {
        const uint4 q = *reinterpret_cast<const uint4*>(m + v);
        live += (__popc(__vcmpne4(q.x, 0)) + __popc(__vcmpne4(q.y, 0)) +
                 __popc(__vcmpne4(q.z, 0)) + __popc(__vcmpne4(q.w, 0))) >> 3;
      }
      i = v1;
    }
    for (int64_t v = i + threadIdx.x; v < r1; v += kThreads) live += m[v] != 0;
    live = __reduce_add_sync(kFull, live);
    if (lane == 0) hist[warp][0] = live;
    __syncthreads();
    if (threadIdx.x == 0) {
      int s = 0;
      for (int w = 0; w < kWarps; ++w) s += hist[w][0];
      hist[0][0] = s;
      hist[0][1] = static_cast<int>(r1 - r0) - s;
    }
  } else {
    const int32_t* codes = static_cast<const int32_t*>(src);
    int64_t i = r0;
    if ((reinterpret_cast<uintptr_t>(codes) & 15) == 0) {
      // whole 16-byte vectors; every lane takes the same number of rounds
      const int64_t nv = (r1 - r0) >> 2;
      const int64_t rounds = (nv + kThreads - 1) / kThreads;
      for (int64_t k = 0; k < rounds; ++k) {
        const int64_t v = k * kThreads + threadIdx.x;
        int4 q = make_int4(K + 1, K + 1, K + 1, K + 1);
        if (v < nv) q = *reinterpret_cast<const int4*>(codes + r0 + 4 * v);
        const int cs[4] = {q.x, q.y, q.z, q.w};
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int c = v < nv ? clean_code(cs[j], K, nbad) : K + 1;
          const unsigned peers = __match_any_sync(kFull, c);
          if (c <= K && lane == __ffs(peers) - 1) hist[warp][c] += __popc(peers);
          __syncwarp();
        }
      }
      i = r0 + 4 * nv;
    }
    const int64_t rounds = (r1 - i + kThreads - 1) / kThreads;
    for (int64_t k = 0; k < rounds; ++k) {
      const int64_t v = i + k * kThreads + threadIdx.x;
      const int c = v < r1 ? clean_code(codes[v], K, nbad) : K + 1;
      const unsigned peers = __match_any_sync(kFull, c);
      if (c <= K && lane == __ffs(peers) - 1) hist[warp][c] += __popc(peers);
      __syncwarp();
    }
    __syncthreads();
    for (int c = threadIdx.x; c <= K; c += kThreads) {
      int s = 0;
      for (int w = 0; w < kWarps; ++w) s += hist[w][c];
      hist[0][c] = s;  // only thread c reads and writes column c
    }
  }
  __syncthreads();
  for (int c = threadIdx.x; c <= K; c += kThreads) cnt[static_cast<int64_t>(c) * G + blockIdx.x] = hist[0][c];
  nbad = __reduce_add_sync(kFull, nbad);
  if (lane == 0 && nbad) atomicAdd(bad, static_cast<unsigned long long>(nbad));
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) last = atomicAdd(ticket, 1ull) == static_cast<unsigned long long>(G - 1);
  __syncthreads();
  if (!last) return;
  // the last block: exclusive scan of the (K+1) x G matrix in code-major order
  const int L = (K + 1) * G;
  const int per = (L + kThreads - 1) / kThreads;
  const int lo = threadIdx.x * per < L ? threadIdx.x * per : L;
  const int hi = lo + per < L ? lo + per : L;
  int s = 0;
  for (int k = lo; k < hi; ++k) s += __ldcg(cnt + k);
  int run = block_exclusive_scan(s, warp_sums);
  for (int k = lo; k < hi; ++k) {
    const int v = __ldcg(cnt + k);
    __stcg(cnt + k, run);
    run += v;
  }
  __syncthreads();
  for (int c = threadIdx.x; c <= K; c += kThreads) {
    const int64_t end = c == K ? n : __ldcg(cnt + static_cast<int64_t>(c + 1) * G);
    totals[c] = end - __ldcg(cnt + static_cast<int64_t>(c) * G);
  }
}

// ---- pass 2: rank, stage and write ----------------------------------------------------

// The codes of tile t into shared memory: 16-byte cp.async copies when the
// tile is whole and the codes aligned, else row by row.
template <bool kMask>
__device__ __forceinline__ void load_tile(const void* src, bool aligned, int64_t n, int64_t t,
                                          void* buf) {
  const int64_t row0 = t * kTile;
  const int m = n - row0 < kTile ? static_cast<int>(n - row0) : kTile;
  constexpr int kBytes = kMask ? 1 : 4;
  const char* g = static_cast<const char*>(src) + row0 * kBytes;
  if (aligned && m == kTile) {
    constexpr int kChunks = kTile * kBytes / 16;
    for (int k = threadIdx.x; k < kChunks; k += kThreads)
      __pipeline_memcpy_async(static_cast<char*>(buf) + 16 * k, g + 16 * k, 16);
  } else if (kMask) {
    for (int k = threadIdx.x; k < m; k += kThreads)
      static_cast<uint8_t*>(buf)[k] = reinterpret_cast<const uint8_t*>(g)[k];
  } else {
    for (int k = threadIdx.x; k < m; k += kThreads)
      static_cast<int32_t*>(buf)[k] = reinterpret_cast<const int32_t*>(g)[k];
  }
  __pipeline_commit();
}

// Calls f with a value of the unsigned word type of `bytes` (1, 2, 4, 8, 16).
template <typename F>
__device__ __forceinline__ void by_word(int bytes, F&& f) {
  switch (bytes) {
    case 16: f(uint4{}); break;
    case 8: f(uint64_t{}); break;
    case 4: f(uint32_t{}); break;
    case 2: f(uint16_t{}); break;
    default: f(uint8_t{});
  }
}

__device__ __forceinline__ bool row_written(const unsigned* written, int r) {
  return (written[r >> 5] >> (r & 31)) & 1u;
}

// Copy a one-word column's rows of the tile (a row is one W), in row order,
// into `plane`: 16-byte cp.async copies when the tile is whole and the column
// aligned, else row by row. A chunk none of whose rows is written is skipped.
// The caller commits and waits.
template <typename W>
__device__ __forceinline__ void load_plane(const W* __restrict__ in, int64_t row0, int m,
                                           const unsigned* written, W* plane) {
  constexpr int R = 16 / sizeof(W);  // rows a chunk
  constexpr unsigned kChunkRows = R == 32 ? ~0u : (1u << R) - 1u;
  const W* g = in + row0;
  if (m == kTile && reinterpret_cast<uintptr_t>(g) % 16 == 0) {
    for (int k = threadIdx.x; k < kTile / R; k += kThreads) {
      const int r = k * R;
      if ((written[r >> 5] >> (r & 31)) & kChunkRows) __pipeline_memcpy_async(plane + r, g + r, 16);
    }
  } else {
    for (int r = threadIdx.x; r < m; r += kThreads)
      if (row_written(written, r)) plane[r] = g[r];
  }
}

// Write a staged one-word column: consecutive threads take consecutive
// slots, which are consecutive destinations within each code's run.
template <typename W>
__device__ __forceinline__ void write_plane(W* __restrict__ out, int m, const int32_t* dst,
                                            const uint16_t* row_of_slot, const W* plane) {
#pragma unroll
  for (int q = 0; q < kTile / kThreads; ++q) {
    const int s = threadIdx.x + q * kThreads;
    if (s < m) {
      const int32_t d = dst[s];
      if (d >= 0) out[d] = plane[row_of_slot[s]];
    }
  }
}

// A column whose row is several words (padded strings, misaligned rows):
// staged in row order 16 bytes a row a pass.
template <typename W>
__device__ __forceinline__ void move_column(const W* __restrict__ in, W* __restrict__ out,
                                            int64_t words, int64_t row0, int m,
                                            const unsigned* written, const uint16_t* row_of_slot,
                                            const int32_t* dst, W* stage) {
  constexpr int J = 16 / sizeof(W);
  for (int64_t j0 = 0; j0 < words; j0 += J) {
    const int jp = words - j0 < J ? static_cast<int>(words - j0) : J;
    for (int k = threadIdx.x; k < m * jp; k += kThreads) {
      const int r = k / jp, w = k - r * jp;
      if (row_written(written, r)) stage[r * J + w] = in[(row0 + r) * words + j0 + w];
    }
    __syncthreads();
    for (int k = threadIdx.x; k < m * jp; k += kThreads) {
      const int s = k / jp, w = k - s * jp;
      const int32_t d = dst[s];
      if (d >= 0) out[static_cast<int64_t>(d) * words + j0 + w] = stage[row_of_slot[s] * J + w];
    }
    __syncthreads();
  }
}

// Every column of the tile into its destinations. One-word columns go in
// groups whose planes fill the stage: all of a group's copies in flight at
// once, then one write phase. Other columns go one at a time.
__device__ __forceinline__ void move_columns(const Columns& cols, int64_t row0, int m,
                                             const unsigned* written, const uint16_t* row_of_slot,
                                             const int32_t* dst, unsigned char* stage) {
  int k = 0;
  while (k < cols.count) {
    if (cols.words[k] != 1) {
      by_word(cols.word_bytes[k], [&](auto w) {
        using W = decltype(w);
        move_column(static_cast<const W*>(cols.in[k]), static_cast<W*>(cols.out[k]),
                    cols.words[k], row0, m, written, row_of_slot, dst,
                    reinterpret_cast<W*>(stage));
      });
      ++k;
      continue;
    }
    int k1 = k, bytes = 0;
    while (k1 < cols.count && cols.words[k1] == 1 &&
           bytes + kTile * cols.word_bytes[k1] <= kStageBytes)
      bytes += kTile * cols.word_bytes[k1++];
    for (int j = k, off = 0; j < k1; off += kTile * cols.word_bytes[j++])
      by_word(cols.word_bytes[j], [&](auto w) {
        using W = decltype(w);
        load_plane(static_cast<const W*>(cols.in[j]), row0, m, written,
                   reinterpret_cast<W*>(stage + off));
      });
    __pipeline_commit();
    __pipeline_wait_prior(0);
    __syncthreads();
    for (int j = k, off = 0; j < k1; off += kTile * cols.word_bytes[j++])
      by_word(cols.word_bytes[j], [&](auto w) {
        using W = decltype(w);
        write_plane(static_cast<W*>(cols.out[j]), m, dst, row_of_slot,
                    reinterpret_cast<const W*>(stage + off));
      });
    __syncthreads();
    k = k1;
  }
}

template <bool kMask>
__global__ void __launch_bounds__(kThreads, 4)
b3_scatter_kernel(const void* __restrict__ src, int64_t n, int K, bool local, int tiles_per_block,
                  const int32_t* __restrict__ base, int G, int64_t limit,
                  int32_t* __restrict__ perm, int32_t* __restrict__ tile_counts,
                  unsigned long long* __restrict__ bad, const Columns cols) {
  __shared__ __align__(16) unsigned char code_buf[2][kTile * 4];
  __shared__ __align__(16) unsigned char stage[kStageBytes];
  __shared__ int hist[kWarps][kBins];  // per warp: counts, then offsets within the segment
  __shared__ int seg_count[2][kBins];
  __shared__ int seg_start[2][kBins];
  __shared__ int run_base[kBins];      // global: the block's next destination of each code
  __shared__ uint16_t row_of_slot[kTile];
  __shared__ int32_t dst[kTile];       // by slot; -1: write nothing
  __shared__ unsigned written[kTile / 32];  // by row: whether it is written
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const unsigned lanes_below = (1u << lane) - 1u;
  const int64_t T = (n + kTile - 1) / kTile;
  const int64_t T_local = (n + kLocalTile - 1) / kLocalTile;
  const int64_t t0 = static_cast<int64_t>(blockIdx.x) * tiles_per_block;
  const int64_t t1 = t0 + tiles_per_block < T ? t0 + tiles_per_block : T;
  const bool aligned = (reinterpret_cast<uintptr_t>(src) & 15) == 0;
  const int nseg = local ? 2 : 1;
  if (!local)
    for (int c = threadIdx.x; c <= K; c += kThreads)
      run_base[c] = base[static_cast<int64_t>(c) * G + blockIdx.x];
  int nbad = 0;
  int buf = 0;
  if (t0 < t1) load_tile<kMask>(src, aligned, n, t0, code_buf[0]);
  for (int64_t t = t0; t < t1; ++t) {
    if (t + 1 < t1) load_tile<kMask>(src, aligned, n, t + 1, code_buf[buf ^ 1]);
    else __pipeline_commit();
    for (int c = lane; c <= K + 1; c += 32) hist[warp][c] = 0;
    __pipeline_wait_prior(1);
    __syncthreads();
    const int64_t row0 = t * kTile;
    const int m = n - row0 < kTile ? static_cast<int>(n - row0) : kTile;
    // rank: each warp its 128 rows, in four rounds of 32
    int code[4], rank[4];
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int i = warp * kWarpRows + r * 32 + lane;
      int c = K + 1;
      if (i < m) {
        if (kMask) c = code_buf[buf][i] ? 0 : 1;
        else c = clean_code(reinterpret_cast<const int32_t*>(code_buf[buf])[i], K, nbad);
      }
      const unsigned peers = __match_any_sync(kFull, c);
      const int before = hist[warp][c];
      __syncwarp();
      if (lane == __ffs(peers) - 1) hist[warp][c] = before + __popc(peers);
      __syncwarp();
      code[r] = c;
      rank[r] = before + __popc(peers & lanes_below);
    }
    __syncthreads();
    // over the warps: each warp's first rank in its segment, the segments' counts
    for (int c = threadIdx.x; c <= K; c += kThreads) {
      int run = 0, first_half = 0;
      for (int w = 0; w < kWarps; ++w) {
        if (w == kWarps / 2) {
          first_half = run;
          if (local) {
            seg_count[0][c] = run;
            run = 0;
          }
        }
        const int v = hist[w][c];
        hist[w][c] = run;
        run += v;
      }
      seg_count[local ? 1 : 0][c] = run;
      if (tile_counts) {
        const int64_t lt = 2 * t;  // the 512-row tiles of this tile
        tile_counts[lt * (K + 1) + c] = first_half;
        if (lt + 1 < T_local) tile_counts[(lt + 1) * (K + 1) + c] = local ? run : run - first_half;
      }
    }
    __syncthreads();
    // over the codes: each code's first slot in its segment
    if (warp < nseg) {
      int carry = 0;
      for (int c0 = 0; c0 <= K; c0 += 32) {
        const int c = c0 + lane;
        const int v = c <= K ? seg_count[warp][c] : 0;
        int x = v;
        for (int d = 1; d < 32; d <<= 1) {
          const int y = __shfl_up_sync(kFull, x, d);
          if (lane >= d) x += y;
        }
        if (c <= K) seg_start[warp][c] = carry + x - v;
        carry += __shfl_sync(kFull, x, 31);
      }
    }
    __syncthreads();
    const int seg = local ? warp / (kWarps / 2) : 0;
    int writes = 0;
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int c = code[r];
      const int i = warp * kWarpRows + r * 32 + lane;
      bool w = false;
      if (c <= K) {
        const int within = hist[warp][c] + rank[r];  // rank among code c's rows of the segment
        const int slot = seg * kLocalTile + seg_start[seg][c] + within;
        int64_t d = local ? row0 + slot : static_cast<int64_t>(run_base[c]) + within;
        if (d >= limit) d = -1;
        row_of_slot[slot] = static_cast<uint16_t>(i);
        dst[slot] = static_cast<int32_t>(d);
        if (perm && d >= 0) perm[d] = static_cast<int32_t>(row0 + i);
        w = d >= 0;
      }
      const unsigned bits = __ballot_sync(kFull, w);
      if (lane == 0) written[(warp * kWarpRows + r * 32) >> 5] = bits;
      writes |= w;
    }
    // a tile none of whose rows is written (past a limit) moves no column
    const bool any_write = __syncthreads_or(writes);
    if (any_write) move_columns(cols, row0, m, written, row_of_slot, dst, stage);
    if (!local)
      for (int c = threadIdx.x; c <= K; c += kThreads) run_base[c] += seg_count[0][c];
    __syncthreads();
    buf ^= 1;
  }
  if (bad) {
    nbad = __reduce_add_sync(kFull, nbad);
    if (lane == 0 && nbad) atomicAdd(bad, static_cast<unsigned long long>(nbad));
  }
}

template <bool kMask>
cudaError_t launch(const void* src, long long n, int K, int local, long long limit, int G,
                   int tiles_per_block, void* cnt, void* totals, void* bad, void* ticket,
                   void* perm, void* tile_counts, const Columns& cols, cudaStream_t stream) {
  if (!local) {
    b3_count_kernel<kMask><<<G, kThreads, 0, stream>>>(
        src, n, K, tiles_per_block, G, static_cast<int32_t*>(cnt), static_cast<int64_t*>(totals),
        static_cast<unsigned long long*>(bad), static_cast<unsigned long long*>(ticket));
    const cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return e;
  }
  b3_scatter_kernel<kMask><<<G, kThreads, 0, stream>>>(
      src, n, K, local != 0, tiles_per_block, static_cast<const int32_t*>(cnt), G, limit,
      static_cast<int32_t*>(perm), static_cast<int32_t*>(tile_counts),
      local ? static_cast<unsigned long long*>(bad) : nullptr, cols);
  return cudaGetLastError();
}

}  // namespace

// One call: the count pass and its scan (global), then the scatter pass, on
// `stream`. `is_mask`: src is a bool row mask (K = 1). G blocks of
// `tiles_per_block` tiles cover the rows; cnt holds (K+1) x G int32; totals
// (K+1 int64), bad and ticket (u64) come zeroed. perm and tile_counts may be
// null; ncols columns move, in_ptrs[k] to out_ptrs[k], words[k] words of
// word_bytes[k] bytes a row.
extern "C" int b3_launch(const void* src, int is_mask, long long n, int K, int local,
                         long long limit, int G, int tiles_per_block, void* cnt, void* totals,
                         void* bad, void* ticket, void* perm, void* tile_counts, int ncols,
                         void* const* in_ptrs, void* const* out_ptrs, const long long* words,
                         const int* word_bytes, void* stream) {
  if (n <= 0) return 0;
  if (K < 1 || K > kMaxParts || (is_mask && K != 1) || ncols < 0 || ncols > kMaxCols ||
      n >= (1ll << 31) || G < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  Columns cols{};
  cols.count = ncols;
  for (int k = 0; k < ncols; ++k) {
    cols.in[k] = in_ptrs[k];
    cols.out[k] = out_ptrs[k];
    cols.words[k] = words[k];
    cols.word_bytes[k] = word_bytes[k];
  }
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const cudaError_t e =
      is_mask ? launch<true>(src, n, K, local, limit, G, tiles_per_block, cnt, totals, bad, ticket,
                             perm, tile_counts, cols, s)
              : launch<false>(src, n, K, local, limit, G, tiles_per_block, cnt, totals, bad,
                              ticket, perm, tile_counts, cols, s);
  return static_cast<int>(e);
}

// Scatter-pass blocks resident on one SM (the larger of the two passes'
// shared memory), for the wrapper's grid.
extern "C" int b3_blocks_per_sm(int* out) {
  return static_cast<int>(cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      out, b3_scatter_kernel<false>, kThreads, 0));
}

extern "C" int b3_tile() { return kTile; }

extern "C" int b3_max_parts() { return kMaxParts; }

extern "C" int b3_max_columns() { return kMaxCols; }

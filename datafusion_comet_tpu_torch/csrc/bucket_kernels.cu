// Per-bucket counts and exact int64 sums over int32 bucket codes, for
// Hopper (sm_90a). Plain C entry points, loaded with ctypes by
// datafusion_comet_tpu_torch/exec/_build.py; the Python wrappers, the plain
// PyTorch versions and the layout choice (kernels.py::bucket_layout) live in
// exec/kernels.py.
//
// Replaces datafusion_comet_tpu/exec/pallas_kernels.py::_kernel (count) and
// ::_sum_kernel (sums). Bound on an H100 (3.35 TB/s): 4 bytes of code a row,
// plus 8 bytes a live row and lane of values for a sum, plus 8 bytes a bin
// written.
//
// Contract: codes[i] in [0, B]; code == B is a dead row and is dropped; a
// code outside [0, B] is counted into *bad and otherwise ignored. Sums are
// taken mod 2^64 on the unsigned bit patterns, which is exact two's-
// complement int64 arithmetic. The caller zeroes out and bad, picks the
// layout, its threads and shared bytes, and the grid, and reads the error
// code each entry point returns (cudaGetLastError after the launch).
//
// The first design kept one u64 histogram per block and did a shared
// atomicAdd per row and lane. On sm_90a a 64-bit shared atomicAdd is a
// compare-and-swap loop (ATOMS.CAST.SPIN.64); only 32-bit adds are native
// (ATOMS.ADD). Q1's rows fall on 6 of 64 buckets, so a warp's 32 lanes hit
// about 6 words and every warp of the block spins on the same few. The
// layouts below never put two lanes of a warp on one shared word where the
// domain is small, and use only native 32-bit shared atomics:
//
//   count_private  (count, B <= 227): per-thread u32 counters laid out
//       bin-major, cnt[b * blockDim + thread]: each thread increments its own
//       word in its own bank with a plain ++, no atomics. B * 1 KB of shared
//       memory at 256 threads.
//   count_shared   (count, B >= 228): one u32 histogram per block; each warp
//       groups equal codes with __match_any_sync and its leader adds the
//       group's popcount.
//   sum_replicated (sums, k * B <= 908 lanes x buckets per launch): 32 copies
//       of the bins, one per warp lane, bins[(j * B + c) * 32 + lane], each a
//       u32 lo word and a u32 hi word in two planes. A warp's add hits 32
//       distinct, bank-contiguous words; the lo add returns the old word, and
//       its carry goes into the hi add, which is exact mod 2^64. k * B * 256
//       bytes.
//   sum_shared     (sums, B >= 909): one lo/hi histogram per block, one
//       atomic pair per live row and lane (a large domain rarely repeats a
//       code within a warp).
//
// Codes are read as 16-byte vectors, four codes a lane and four vectors a
// lane per tile (512 rows a warp), with the rows before the first 16-byte
// boundary and after the last whole vector taken one by one. Values are read
// only for lanes holding a live row (two 16-byte loads where the lane's row
// is 16-byte aligned, else one 8-byte load per live row), and a warp whose
// tile has no live row at all (the padding tail) issues no value load.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kWarp = 32;
constexpr int kThreads = 256;  // every layout; kernels.py::_THREADS
constexpr int kVecs = 4;       // 16-byte code vectors per lane per tile
constexpr int kSmemMax = 232448;  // the H100's opt-in shared memory per block
constexpr int kMaxDevices = 64;

enum Layout : int { kCountPrivate = 0, kCountShared = 1, kSumReplicated = 2, kSumShared = 3,
                    kLayouts = 4 };

__device__ __forceinline__ unsigned long long warp_sum(unsigned long long s) {
#pragma unroll
  for (int o = kWarp / 2; o; o >>= 1) s += __shfl_xor_sync(kFull, s, o);
  return s;
}

// k is the number of value lanes (0 for a count); smem_words the dynamic
// shared memory in u32 words (a multiple of 4); head the rows before codes'
// first 16-byte boundary.
template <int L>
__global__ void __launch_bounds__(kThreads)
bucket_kernel(const int32_t* __restrict__ codes, const int64_t* __restrict__ values, int64_t n,
              int head, int k, int B, int smem_words, unsigned long long* __restrict__ out,
              unsigned long long* __restrict__ bad) {
  extern __shared__ __align__(16) unsigned sm[];
  constexpr bool kRep = L == kSumReplicated;
  for (int t = threadIdx.x; t < smem_words / 4; t += kThreads)
    reinterpret_cast<uint4*>(sm)[t] = make_uint4(0u, 0u, 0u, 0u);
  __syncthreads();

  const int lane = threadIdx.x & (kWarp - 1);
  constexpr int T = kThreads;  // every launch's blockDim.x
  const int plane = k * B * (kRep ? kWarp : 1);  // sums: words of the lo plane
  unsigned nbad = 0;
  auto slot = [&](int j, int c) { return kRep ? ((j * B + c) << 5) + lane : j * B + c; };
  auto add_lo = [&](int s, unsigned long long v) {
    return atomicAdd(&sm[s], static_cast<unsigned>(v));
  };
  auto add_hi = [&](int s, unsigned long long v, unsigned old) {
    const unsigned lo = static_cast<unsigned>(v);
    atomicAdd(&sm[plane + s], static_cast<unsigned>(v >> 32) + (old + lo < old ? 1u : 0u));
  };

  // the rows before the first whole vector and after the last, one a thread
  const int64_t nvec = (n - head) >> 2;
  if (blockIdx.x == 0 && threadIdx.x < 8) {
    const int64_t i = threadIdx.x < 4 ? threadIdx.x : head + 4 * nvec + (threadIdx.x - 4);
    if (threadIdx.x < 4 ? i < head : i < n) {
      const int c = codes[i];
      if (static_cast<unsigned>(c) >= static_cast<unsigned>(B)) {
        nbad += c != B;
      } else if constexpr (L == kCountPrivate) {
        sm[c * T + threadIdx.x] += 1u;
      } else if constexpr (L == kCountShared) {
        atomicAdd(&sm[c], 1u);
      } else {
        for (int j = 0; j < k; ++j) {
          const unsigned long long v = static_cast<unsigned long long>(values[j * n + i]);
          add_hi(slot(j, c), v, add_lo(slot(j, c), v));
        }
      }
    }
  }

  const int4* vec = reinterpret_cast<const int4*>(codes + head);
  const int64_t ntiles = (nvec + kWarp * kVecs - 1) / (kWarp * kVecs);
  const int64_t nwarps = static_cast<int64_t>(gridDim.x) * (T / kWarp);
  // a tile's codes; rows past n read as dead
  auto load_tile = [&](int64_t tile, int (&c)[kVecs][4]) {
#pragma unroll
    for (int u = 0; u < kVecs; ++u) {
      const int64_t v = tile * (kWarp * kVecs) + u * kWarp + lane;
      const int4 q = v < nvec ? __ldg(vec + v) : make_int4(B, B, B, B);
      c[u][0] = q.x;
      c[u][1] = q.y;
      c[u][2] = q.z;
      c[u][3] = q.w;
    }
  };
  int64_t tile = static_cast<int64_t>(blockIdx.x) * (T / kWarp) + threadIdx.x / kWarp;
  int c[kVecs][4];
  load_tile(tile, c);
  // the loop bound is uniform across a warp, so every lane takes every tile;
  // the next tile's codes load while this one's are counted
  for (; tile < ntiles; tile += nwarps) {
    int next[kVecs][4];
    load_tile(tile + nwarps, next);
    const int64_t v0 = tile * (kWarp * kVecs) + lane;
    unsigned live = 0;  // bit 4u + e: row e of vector u is live
#pragma unroll
    for (int u = 0; u < kVecs; ++u) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        if (static_cast<unsigned>(c[u][e]) < static_cast<unsigned>(B)) {
          live |= 1u << (4 * u + e);
        } else {
          nbad += c[u][e] != B;
        }
      }
    }
    if constexpr (L == kCountPrivate) {
      unsigned* mine = sm + threadIdx.x;
#pragma unroll
      for (int u = 0; u < kVecs; ++u) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          if (live >> (4 * u + e) & 1u) mine[c[u][e] * T] += 1u;
        }
      }
    } else if constexpr (L == kCountShared) {
#pragma unroll
      for (int u = 0; u < kVecs; ++u) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int x = live >> (4 * u + e) & 1u ? c[u][e] : B;  // dead and bad rows: B
          const unsigned peers = __match_any_sync(kFull, x);
          if (x != B && lane == __ffs(peers) - 1)
            atomicAdd(&sm[x], static_cast<unsigned>(__popc(peers)));
        }
      }
    } else if (__ballot_sync(kFull, live)) {  // no live row in the tile: no value load
      for (int j = 0; j < k; ++j) {
        const int64_t* row = values + j * n + head;
        const bool aligned = (reinterpret_cast<uintptr_t>(row) & 15) == 0;
        unsigned long long x[kVecs][4];
#pragma unroll
        for (int u = 0; u < kVecs; ++u) {
          const unsigned m = live >> (4 * u) & 15u;
          const int64_t* p = row + 4 * (v0 + u * kWarp);
#pragma unroll
          for (int e = 0; e < 4; ++e) x[u][e] = 0;
          if (m && aligned) {
            const longlong2 a = __ldg(reinterpret_cast<const longlong2*>(p));
            const longlong2 b = __ldg(reinterpret_cast<const longlong2*>(p) + 1);
            x[u][0] = a.x;
            x[u][1] = a.y;
            x[u][2] = b.x;
            x[u][3] = b.y;
          } else if (m) {
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              if (m >> e & 1u) x[u][e] = __ldg(p + e);
            }
          }
        }
        // a vector's four lo adds, then the hi adds that take their carries,
        // so the lo adds' returns overlap
#pragma unroll
        for (int u = 0; u < kVecs; ++u) {
          unsigned old[4];
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            if (live >> (4 * u + e) & 1u) old[e] = add_lo(slot(j, c[u][e]), x[u][e]);
          }
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            if (live >> (4 * u + e) & 1u) add_hi(slot(j, c[u][e]), x[u][e], old[e]);
          }
        }
      }
    }
#pragma unroll
    for (int u = 0; u < kVecs; ++u) {
#pragma unroll
      for (int e = 0; e < 4; ++e) c[u][e] = next[u][e];
    }
  }
  __syncthreads();

  // flush: one global atomic per nonzero bin and block
  const int warp = threadIdx.x / kWarp, nw = T / kWarp;
  if constexpr (L == kCountPrivate) {
    for (int b = warp; b < B; b += nw) {
      unsigned long long s = 0;
      for (int t = lane; t < T; t += kWarp) s += sm[b * T + t];
      s = warp_sum(s);
      if (lane == 0 && s) atomicAdd(out + b, s);
    }
  } else if constexpr (L == kSumReplicated) {
    for (int b = warp; b < k * B; b += nw) {
      const int s0 = (b << 5) + lane;
      const unsigned long long s =
          warp_sum(sm[s0] | static_cast<unsigned long long>(sm[plane + s0]) << 32);
      if (lane == 0 && s) atomicAdd(out + b, s);
    }
  } else {
    const int bins = L == kCountShared ? B : k * B;
    for (int b = threadIdx.x; b < bins; b += T) {
      const unsigned long long s =
          L == kCountShared ? sm[b] : sm[b] | static_cast<unsigned long long>(sm[plane + b]) << 32;
      if (s) atomicAdd(out + b, s);
    }
  }
  nbad = __reduce_add_sync(kFull, nbad);
  if (lane == 0 && nbad) atomicAdd(bad, static_cast<unsigned long long>(nbad));
}

template <int L>
const void* entry() {
  auto* f = &bucket_kernel<L>;
  return reinterpret_cast<const void*>(f);
}

const void* kernel_of(int layout) {
  switch (layout) {
    case kCountPrivate: return entry<kCountPrivate>();
    case kCountShared: return entry<kCountShared>();
    case kSumReplicated: return entry<kSumReplicated>();
    default: return entry<kSumShared>();
  }
}

// Shared bytes the layout needs for k lanes over B buckets (a count: k == 0).
long long smem_needed(int layout, int k, int B) {
  switch (layout) {
    case kCountPrivate: return 4LL * B * kThreads;
    case kCountShared: return 4LL * B;
    case kSumReplicated: return 8LL * k * B * kWarp;
    default: return 8LL * k * B;
  }
}

// Lift the kernel's dynamic shared-memory cap to kSmemMax, once per device:
// without it a launch above 48 KB is refused.
int opt_in(int layout) {
  static bool done[kMaxDevices][kLayouts] = {};
  int dev = 0;
  if (cudaError_t e = cudaGetDevice(&dev)) return static_cast<int>(e);
  if (dev < kMaxDevices && done[dev][layout]) return 0;
  const cudaError_t e = cudaFuncSetAttribute(
      kernel_of(layout), cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemMax);
  if (e == cudaSuccess && dev < kMaxDevices) done[dev][layout] = true;
  return static_cast<int>(e);
}

}  // namespace

// Blocks of the layout's kernel that fit one SM at smem dynamic bytes.
extern "C" int bucket_blocks_per_sm(int layout, int smem, int* blocks) {
  if (layout < 0 || layout >= kLayouts || smem < 0 || smem > kSmemMax)
    return static_cast<int>(cudaErrorInvalidValue);
  if (int e = opt_in(layout)) return e;
  return static_cast<int>(
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks, kernel_of(layout), kThreads, smem));
}

extern "C" int bucket_launch(int layout, const void* codes, const void* values, long long n,
                             int k, int B, int smem, int grid, void* out, void* bad,
                             void* stream) {
  if (n <= 0) return 0;
  const bool count = layout == kCountPrivate || layout == kCountShared;
  if (layout < 0 || layout >= kLayouts || B < 1 || (count ? k != 0 : k < 1) || grid < 1
      || smem % 16 || smem > kSmemMax || smem < smem_needed(layout, k, B)
      || reinterpret_cast<uintptr_t>(codes) % 4 || (!count && !values))
    return static_cast<int>(cudaErrorInvalidValue);
  if (int e = opt_in(layout)) return e;
  const long long lead =
      static_cast<long long>((16 - reinterpret_cast<uintptr_t>(codes) % 16) % 16 / 4);
  int head = static_cast<int>(lead < n ? lead : n);
  // the kernel's parameters, in order, for cudaLaunchKernel
  const auto* c = static_cast<const int32_t*>(codes);
  const auto* v = static_cast<const int64_t*>(values);
  int64_t rows = n;
  int words = smem / 4;
  auto* o = static_cast<unsigned long long*>(out);
  auto* b = static_cast<unsigned long long*>(bad);
  void* args[] = {&c, &v, &rows, &head, &k, &B, &words, &o, &b};
  cudaLaunchKernel(kernel_of(layout), dim3(grid), dim3(kThreads), args, smem,
                   static_cast<cudaStream_t>(stream));
  return static_cast<int>(cudaGetLastError());
}

extern "C" int bucket_kernels_smem_max() { return kSmemMax; }
extern "C" int bucket_kernels_threads() { return kThreads; }

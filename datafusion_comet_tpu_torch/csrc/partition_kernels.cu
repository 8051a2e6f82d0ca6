// Stable partition sort of row indices by a small int32 code, for Hopper
// (sm_90a). Plain C entry points, loaded with ctypes by
// datafusion_comet_tpu_torch/exec/_build.py; the Python wrapper, the plain
// PyTorch version and the design notes live in exec/kernels.py
// (partition_sort).
//
// Contract: codes[i] in [0, K] with 1 <= K <= kMaxParts; code K marks a dead
// row; a code outside [0, K] is counted into *bad and sorted as dead. One
// block handles one tile of kTile rows (the last tile may be ragged). Pass 1
// writes counts (T, K+1), one int32 row per tile. The caller scans them into
// base (T, K+1): the first destination of code c's rows of tile t. Pass 2
// writes perm[base[t][c] + rank] = i, where rank is row i's stable rank among
// the rows of code c in tile t. The caller zeroes bad and reads the error
// code each entry point returns (cudaGetLastError after the launch).

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kTile = 512;  // rows per tile = threads per block
constexpr int kWarps = kTile / 32;
constexpr int kMaxParts = 128;

__device__ __forceinline__ int clean_code(int c, int K) {
  return static_cast<unsigned>(c) > static_cast<unsigned>(K) ? K : c;
}

__global__ void __launch_bounds__(kTile)
partition_count_kernel(const int32_t* __restrict__ codes, int64_t n, int K,
                       int32_t* __restrict__ counts, unsigned long long* __restrict__ bad) {
  __shared__ int hist[kMaxParts + 1];
  __shared__ int nbad;
  for (int c = threadIdx.x; c <= K; c += blockDim.x) hist[c] = 0;
  if (threadIdx.x == 0) nbad = 0;
  __syncthreads();
  const int64_t i = static_cast<int64_t>(blockIdx.x) * kTile + threadIdx.x;
  if (i < n) {
    const int raw = codes[i];
    const int c = clean_code(raw, K);
    if (c != raw) atomicAdd(&nbad, 1);
    atomicAdd(&hist[c], 1);
  }
  __syncthreads();
  int32_t* row = counts + static_cast<int64_t>(blockIdx.x) * (K + 1);
  for (int c = threadIdx.x; c <= K; c += blockDim.x) row[c] = hist[c];
  if (threadIdx.x == 0 && nbad) atomicAdd(bad, static_cast<unsigned long long>(nbad));
}

// Stable rank inside the tile: within a warp, the lanes holding the same
// code find each other with __match_any_sync and a lane's rank is the number
// of its peers on lower lanes; across warps, an exclusive scan of per-warp
// code counts in shared memory gives each warp's first slot of each code.
// Rows past n take code K + 1, which no real row has, and write nothing.
__global__ void __launch_bounds__(kTile)
partition_scatter_kernel(const int32_t* __restrict__ codes, int64_t n, int K,
                         const int32_t* __restrict__ base, int32_t* __restrict__ perm) {
  __shared__ int warp_count[kWarps * (kMaxParts + 1)];
  const int nb = K + 1;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  for (int t = threadIdx.x; t < kWarps * nb; t += blockDim.x) warp_count[t] = 0;
  __syncthreads();
  const int64_t i = static_cast<int64_t>(blockIdx.x) * kTile + threadIdx.x;
  const int c = i < n ? clean_code(codes[i], K) : K + 1;
  const unsigned peers = __match_any_sync(0xffffffffu, c);
  const int rank = __popc(peers & ((1u << lane) - 1u));
  if (c <= K && lane == __ffs(peers) - 1) warp_count[warp * nb + c] = __popc(peers);
  __syncthreads();
  for (int cc = threadIdx.x; cc < nb; cc += blockDim.x) {
    int run = 0;
    for (int w = 0; w < kWarps; ++w) {
      const int v = warp_count[w * nb + cc];
      warp_count[w * nb + cc] = run;
      run += v;
    }
  }
  __syncthreads();
  if (c <= K) {
    const int dst = base[static_cast<int64_t>(blockIdx.x) * nb + c] + warp_count[warp * nb + c]
                    + rank;
    perm[dst] = static_cast<int32_t>(i);
  }
}

int tiles(int64_t n) { return static_cast<int>((n + kTile - 1) / kTile); }

}  // namespace

extern "C" int partition_count_launch(const void* codes, long long n, int K, void* counts,
                                      void* bad, void* stream) {
  if (n <= 0) return 0;
  if (K < 1 || K > kMaxParts) return static_cast<int>(cudaErrorInvalidValue);
  partition_count_kernel<<<tiles(n), kTile, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(codes), n, K, static_cast<int32_t*>(counts),
      static_cast<unsigned long long*>(bad));
  return static_cast<int>(cudaGetLastError());
}

extern "C" int partition_scatter_launch(const void* codes, long long n, int K, const void* base,
                                        void* perm, void* stream) {
  if (n <= 0) return 0;
  if (K < 1 || K > kMaxParts) return static_cast<int>(cudaErrorInvalidValue);
  partition_scatter_kernel<<<tiles(n), kTile, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(codes), n, K, static_cast<const int32_t*>(base),
      static_cast<int32_t*>(perm));
  return static_cast<int>(cudaGetLastError());
}

extern "C" int partition_kernels_tile() { return kTile; }

extern "C" int partition_kernels_max_parts() { return kMaxParts; }

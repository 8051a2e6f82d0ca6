// Per-bucket counts and exact int64 sums over int32 bucket codes, for
// Hopper (sm_90a). Plain C entry points, loaded with ctypes by
// datafusion_comet_tpu_torch/exec/_build.py; the Python wrappers, the plain
// PyTorch versions and the design notes live in exec/kernels.py.
//
// Contract: codes[i] in [0, B]; code == B is a dead row and is dropped; a
// code outside [0, B] is counted into *bad and otherwise ignored. Sums are
// taken mod 2^64 on the unsigned bit patterns, which is exact two's-
// complement int64 arithmetic. The caller zeroes out and bad, keeps
// k * B + 1 <= kMaxBins, and reads the error code each entry point returns
// (cudaGetLastError after the launch).

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kBlocksPerSm = 4;
constexpr int kMaxBins = 6144;  // 48 KB of u64 bins: no shared-memory opt-in needed

int grid_for(int64_t n) {
  static int sms = 0;
  if (sms == 0) {
    int dev = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (sms <= 0) sms = 1;
  }
  const int64_t want = (n + kThreads - 1) / kThreads;
  const int64_t most = static_cast<int64_t>(sms) * kBlocksPerSm;
  return static_cast<int>(want < most ? want : most);
}

// One block keeps a private histogram of k * B u64 bins (plus one bin for
// bad codes) in shared memory, fills it with shared atomics over a
// grid-stride loop, and flushes each nonzero bin with one global atomic.
// kCount: add 1 per row (k == 1); else add values[j * n + i] to lane j.
template <bool kCount>
__global__ void __launch_bounds__(kThreads)
bucket_kernel(const int32_t* __restrict__ codes, const int64_t* __restrict__ values,
              int64_t n, int k, int B, unsigned long long* __restrict__ out,
              unsigned long long* __restrict__ bad) {
  extern __shared__ unsigned long long bins[];
  const int nbins = k * B;
  for (int t = threadIdx.x; t <= nbins; t += blockDim.x) bins[t] = 0ULL;
  __syncthreads();
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  for (int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x; i < n;
       i += stride) {
    const int c = codes[i];
    if (c == B) continue;  // dead row
    if (static_cast<unsigned>(c) > static_cast<unsigned>(B)) {
      atomicAdd(&bins[nbins], 1ULL);
      continue;
    }
    if constexpr (kCount) {
      atomicAdd(&bins[c], 1ULL);
    } else {
      for (int j = 0; j < k; ++j) {
        atomicAdd(&bins[j * B + c],
                  static_cast<unsigned long long>(values[static_cast<int64_t>(j) * n + i]));
      }
    }
  }
  __syncthreads();
  for (int t = threadIdx.x; t < nbins; t += blockDim.x) {
    const unsigned long long v = bins[t];
    if (v) atomicAdd(&out[t], v);
  }
  if (threadIdx.x == 0 && bins[nbins]) atomicAdd(bad, bins[nbins]);
}

int launch(bool count, const void* codes, const void* values, long long n, int k, int B,
           void* out, void* bad, void* stream) {
  if (n <= 0) return 0;
  if (B < 1 || k < 1 || k * B + 1 > kMaxBins) return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = static_cast<size_t>(k * B + 1) * sizeof(unsigned long long);
  const auto* c = static_cast<const int32_t*>(codes);
  const auto* v = static_cast<const int64_t*>(values);
  auto* o = static_cast<unsigned long long*>(out);
  auto* b = static_cast<unsigned long long*>(bad);
  auto s = static_cast<cudaStream_t>(stream);
  if (count) {
    bucket_kernel<true><<<grid_for(n), kThreads, smem, s>>>(c, v, n, 1, B, o, b);
  } else {
    bucket_kernel<false><<<grid_for(n), kThreads, smem, s>>>(c, v, n, k, B, o, b);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int bucket_count_launch(const void* codes, long long n, int B, void* out, void* bad,
                                   void* stream) {
  return launch(true, codes, nullptr, n, 1, B, out, bad, stream);
}

extern "C" int bucket_sum_launch(const void* codes, const void* values, long long n, int k,
                                 int B, void* out, void* bad, void* stream) {
  return launch(false, codes, values, n, k, B, out, bad, stream);
}

extern "C" int bucket_kernels_max_bins() { return kMaxBins; }

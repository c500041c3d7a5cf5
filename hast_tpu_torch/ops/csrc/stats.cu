// K7 `count_stats`: the jellyfish-histo bins and the total of a count
// table, both int64.
//
// Replaces hast_tpu/ops/kmer_count.py `_histo_kernel` (bincount of
// clip(c, 0, high + 1) with bin 0 zeroed) and `_total_kernel` (an exact
// total as two int32 limbs, since x64 is off on the TPU): bins and the
// total are int64 here, so no bin can wrap at 2^31 rows.  Counts <= 0
// (the pads) go to no bin; counts above high go to bin high + 1.
//
// What bounds it on an H100: reading 4 bytes a count, and atomics on the
// few bins that real counts hit (a coverage peak).  Each block keeps
// 32-bit sub-histograms in shared memory when the high + 2 bins fit in
// the default 48 KB (high <= 12,286; the pipeline uses 10,000) and adds
// its non-zero bins to the int64 bins once; larger histograms take
// global 64-bit atomics.  The total is a warp shuffle sum and one 64-bit
// atomic per warp.  Integer atomics make bins and total exact.
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxSharedBytes = 48 * 1024;

__global__ void count_stats_kernel(const int32_t* __restrict__ counts,
                                   int64_t n, int high, int use_shared,
                                   unsigned long long* __restrict__ bins,
                                   unsigned long long* __restrict__ total) {
  extern __shared__ unsigned s_bins[];
  const int n_bins = high + 2;
  if (use_shared) {
    for (int b = threadIdx.x; b < n_bins; b += blockDim.x) s_bins[b] = 0;
    __syncthreads();
  }
  long long sum = 0;
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  for (int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x +
                   threadIdx.x;
       i < n; i += stride) {
    const int c = counts[i];
    sum += c;
    if (c > 0) {
      const int b = c < high + 1 ? c : high + 1;
      if (use_shared)
        atomicAdd(&s_bins[b], 1u);
      else
        atomicAdd(&bins[b], 1ull);
    }
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    sum += __shfl_xor_sync(0xFFFFFFFFu, sum, off);
  if ((threadIdx.x & 31) == 0 && sum != 0)
    atomicAdd(total, static_cast<unsigned long long>(sum));
  if (use_shared) {
    __syncthreads();
    for (int b = threadIdx.x; b < n_bins; b += blockDim.x)
      if (s_bins[b]) atomicAdd(&bins[b], static_cast<unsigned long long>(
                                             s_bins[b]));
  }
}

}  // namespace

// counts (n,) int32 -> bins (high + 2,) int64 and total () int64, both
// zeroed by the caller and added to here.
extern "C" int hast_count_stats(const void* counts, int64_t n, int high,
                                void* bins, void* total, void* stream) {
  const int64_t shared_bytes = static_cast<int64_t>(high + 2) * 4;
  const int use_shared = shared_bytes <= kMaxSharedBytes ? 1 : 0;
  const int64_t want = (n + kThreads * 16 - 1) / (kThreads * 16);
  const int blocks = static_cast<int>(want < 1 ? 1 : (want < 1056 ? want
                                                                  : 1056));
  count_stats_kernel<<<blocks, kThreads,
                       use_shared ? static_cast<size_t>(shared_bytes) : 0,
                       static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(counts), n, high, use_shared,
      static_cast<unsigned long long*>(bins),
      static_cast<unsigned long long*>(total));
  return static_cast<int>(cudaGetLastError());
}

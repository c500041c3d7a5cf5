// K14 `route_kmers`: one dp shard's canonical k-mers, each put in the row
// of the shard that owns its hash range, before the all_to_all.
//
// Replaces the per-shard body of hast_tpu/parallel/mesh.py
// `sharded_count_chunk` up to the all_to_all (mesh.py:476-513).  Reads are
// ASCII, coded (b >> 1) & 3; window p is valid iff p + k <= length and its
// k bytes are A, C, G or T in either case (kmer.cuh kAcgtAny, the rule of
// kmer_count.py `_ACGT`).  A valid key goes to shard
// min(kmer_hash(hi, lo) / (2^32 / dp), dp - 1), the branch JAX takes
// without x64 (shard 0 when dp = 1).  Row d of the (dp, cap) buffer holds
// the keys bound for shard d, then INT64_MAX; keys past a row's cap are
// dropped and counted.  JAX routes invalid windows, the sentinel, to the
// tail of the shard's own row: the caller fills the buffer with INT64_MAX
// beforehand, so they need no slot.
//
// JAX sorts (dest, hi, lo) only so that sentinels are shed before real
// keys.  Here each block counts its tile's keys per destination in shared
// memory, reserves a range of each row with one global atomic per
// destination, and writes its keys there: the same multiset per row when
// nothing is dropped (the receiver sorts it, K5), and always the same drop
// count, sum over d of max(0, real_d - cap).  The order inside a row
// depends on the blocks' timing.
//
// What bounds it on an H100: the 8-byte key written per valid window; the
// reads' bytes (100 a read) stay in L1 across a read's windows.  The
// atomics are per block and destination, not per key.
#include <cuda_runtime.h>

#include <cstdint>

#include "kmer.cuh"
#include "probe.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kPerThread = 4;   // windows a thread holds per tile

__device__ __forceinline__ int route_of(uint64_t key, int dp) {
  if (dp == 1) return 0;
  const uint32_t h = hast::kmer_hash(static_cast<uint32_t>(key >> 32),
                                     static_cast<uint32_t>(key));
  const uint32_t width = static_cast<uint32_t>((1ull << 32) / dp);
  const uint32_t d = h / width;
  return d < static_cast<uint32_t>(dp - 1) ? static_cast<int>(d) : dp - 1;
}

__global__ void route_kmers_kernel(const uint8_t* __restrict__ reads,
                                   const int32_t* __restrict__ lengths,
                                   int64_t n_reads, int stride, int k,
                                   int dp, int64_t cap,
                                   int64_t* __restrict__ buf,
                                   unsigned long long* __restrict__ fill,
                                   unsigned long long* __restrict__ dropped) {
  extern __shared__ unsigned long long shared[];
  unsigned long long* base = shared;                       // [dp]
  unsigned int* count = reinterpret_cast<unsigned int*>(shared + dp);
  const int n_win = stride - k + 1;
  const int64_t total = n_reads * n_win;
  const int64_t tile = static_cast<int64_t>(kThreads) * kPerThread;
  unsigned long long lost = 0;
  for (int64_t t0 = static_cast<int64_t>(blockIdx.x) * tile; t0 < total;
       t0 += static_cast<int64_t>(gridDim.x) * tile) {
    for (int d = threadIdx.x; d < dp; d += blockDim.x) count[d] = 0;
    __syncthreads();
    uint64_t key[kPerThread];
    int dest[kPerThread];
    unsigned int off[kPerThread];
#pragma unroll
    for (int j = 0; j < kPerThread; ++j) {
      const int64_t t = t0 + static_cast<int64_t>(j) * kThreads + threadIdx.x;
      dest[j] = -1;
      if (t >= total) continue;
      const int64_t r = t / n_win;
      const int p = static_cast<int>(t - r * n_win);
      if (p + k > lengths[r]) continue;
      if (!hast::canonical_window_bytes<hast::kAcgtAny>(
              reads + r * stride + p, k, key[j]))
        continue;
      dest[j] = route_of(key[j], dp);
      off[j] = atomicAdd(&count[dest[j]], 1u);
    }
    __syncthreads();
    for (int d = threadIdx.x; d < dp; d += blockDim.x)
      base[d] = count[d] ? atomicAdd(fill + d,
                                     static_cast<unsigned long long>(count[d]))
                         : 0ull;
    __syncthreads();
#pragma unroll
    for (int j = 0; j < kPerThread; ++j) {
      if (dest[j] < 0) continue;
      const unsigned long long slot = base[dest[j]] + off[j];
      if (slot < static_cast<unsigned long long>(cap)) {
        buf[dest[j] * cap + static_cast<int64_t>(slot)] =
            static_cast<int64_t>(key[j]);
      } else {
        ++lost;
      }
    }
    __syncthreads();   // count and base are reused by the next tile
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) lost += __shfl_xor_sync(0xFFFFFFFFu, lost, o);
  if ((threadIdx.x & 31) == 0 && lost) atomicAdd(dropped, lost);
}

}  // namespace

// reads (n, stride) uint8 ASCII, lengths (n,) int32 -> buf (dp, cap) int64,
// filled with INT64_MAX by the caller; fill (dp,) and dropped (1,) uint64
// scratch zeroed by the caller: fill[d] ends as the keys bound for row d,
// dropped as the keys past the cap.
extern "C" int hast_route_kmers(const void* reads, const void* lengths,
                                int64_t n, int stride, int k, int dp,
                                int64_t cap, void* buf, void* fill,
                                void* dropped, void* stream) {
  const int64_t n_win = stride - k + 1;
  const int64_t tiles =
      (n * n_win + kThreads * kPerThread - 1) / (kThreads * kPerThread);
  const int blocks = static_cast<int>(tiles < 1 ? 1 : (tiles < 132 * 16
                                                           ? tiles
                                                           : 132 * 16));
  const size_t smem = dp * (sizeof(unsigned long long) + sizeof(unsigned int));
  route_kmers_kernel<<<blocks, kThreads, smem,
                       static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(reads),
      static_cast<const int32_t*>(lengths), n, stride, k, dp, cap,
      static_cast<int64_t*>(buf), static_cast<unsigned long long*>(fill),
      static_cast<unsigned long long*>(dropped));
  return static_cast<int>(cudaGetLastError());
}

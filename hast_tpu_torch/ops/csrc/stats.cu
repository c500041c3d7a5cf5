// K7 `count_stats`: the jellyfish-histo bins and the total of a count
// table, both int64, from one read of the counts.
//
// Replaces hast_tpu/ops/kmer_count.py `_histo_kernel` (bincount of
// clip(c, 0, high + 1) with bin 0 zeroed) and `_total_kernel` (an exact
// total as two int32 limbs, since x64 is off on the TPU): bins and the
// total are int64 here, so no bin can wrap at 2^31 rows.  Counts <= 0
// (the pads) go to no bin but enter the total; counts above high go to
// bin high + 1.
//
// What bounds it on an H100 (80GB HBM3, 700 W; chip_smoke.py
// time_count_stats): reading 4 bytes a count.  2^26 counts at high
// 10,000 take 0.1003-0.1006 ms on the device, 0.80 of the 0.0802 ms that
// their 268 MB take at 3.35 TB/s (the first form, a thread a count a
// step, 0.2233-0.2234), and within 3 % of that on peaked, all-equal and
// past-the-limit counts.  The design:
//  - a persistent grid (the blocks the card holds at once) walks the
//    counts as int4, a scalar head up to the first 16-byte boundary and a
//    scalar tail; each thread has the next kVecs loads in flight while it
//    bins the last kVecs (8 measured 11 % slower, 2 3 %), and each block
//    zeroes and flushes its bins once;
//  - bins [0, kLaneBins) are private to each lane (32-bit, lane l's bin b
//    at word 32 b + l of its warp's copy, so every lane has a bank of its
//    own): no atomic, however the counts pile up; bin 0 takes the pads
//    and is never flushed; below high 62 every bin is a lane's, high + 1
//    too (DeviceCountTable.total bins at high 0).  Else bin high + 1,
//    where repeats pile up, is a per-thread register (as a global atomic
//    on one word, past the shared limit, it took 0.53 ms);
//  - the other bins are the block's shared histogram of high + 2 words
//    (shared atomics), in opt-in shared memory above 48 KB, while lane
//    copies and histogram fit in one block's 227 KB (high <= kSharedHigh,
//    41,726, hast_count_stats_shared_high); past that, global 64-bit
//    atomics;
//  - at the end a warp sums its lanes' copies bin by bin into the block's
//    bins, and the block adds its non-zero bins to the int64 output,
//    zeroed by the caller (one fill kernel: a scratch kept zero that the
//    last block to finish empties into the output, one launch, measured
//    slower, since that copy is one block long); the
//    total is a per-thread int64 sum, a warp shuffle sum and one 64-bit
//    atomic a warp.  Integer atomics make bins and total exact.
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kLaneBins = 64;               // bins private to each lane
constexpr int kVecs = 4;                    // int4 loads in flight a thread
constexpr int kGroup = kThreads * kVecs;    // int4 a block bins a step
constexpr int64_t kMaxSmem = 232448;        // opt-in shared memory a block
// the most high whose shared form fits: the lane copies, then high + 2
// bins in whole chunks
constexpr int kSharedHigh =
    static_cast<int>((kMaxSmem / 4 - kWarps * kLaneBins * 32) & ~3) - 2;

__host__ __device__ inline int lane_bins(int high) {
  return high + 2 < kLaneBins ? high + 2 : kLaneBins;
}

// Shared words of the block: each warp's lane copies, then the block's
// bins (high + 2 of them in the shared form, the lane bins' in the
// global), rounded up to whole 16-byte chunks.
__host__ __device__ inline int64_t smem_words(int high, bool shared) {
  const int64_t blk = shared ? static_cast<int64_t>(high) + 2
                             : lane_bins(high);
  return static_cast<int64_t>(kWarps) * lane_bins(high) * 32 +
         ((blk + 3) & ~int64_t{3});
}

__device__ __forceinline__ int4 load_or_zero(const int4* vec, int64_t i,
                                             int64_t m) {
  return i < m ? __ldg(vec + i) : make_int4(0, 0, 0, 0);
}

// out: high + 2 int64 bins, then the total; zeroed, added to.
template <bool kShared>
__global__ void __launch_bounds__(kThreads)
count_stats_kernel(const int32_t* __restrict__ counts, int64_t n, int head,
                   int high, unsigned long long* __restrict__ out) {
  extern __shared__ __align__(16) unsigned s_mem[];
  const int nl = lane_bins(high);
  const int hi1 = high + 1;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  unsigned* s_lane = s_mem + warp * nl * 32 + lane;   // bin b: s_lane[32 b]
  unsigned* s_blk = s_mem + kWarps * nl * 32;
  const int64_t chunks = smem_words(high, kShared) / 4;
  for (int64_t c = threadIdx.x; c < chunks; c += kThreads)
    reinterpret_cast<uint4*>(s_mem)[c] = make_uint4(0u, 0u, 0u, 0u);
  __syncthreads();

  long long sum = 0;
  unsigned over = 0;   // counts above high, a pile-up bin of its own
  auto add = [&](int c) {
    sum += c;
    const int b = min(max(c, 0), hi1);
    if (b < nl)
      s_lane[32 * b] += 1u;
    else if (b == hi1)
      ++over;
    else if (kShared)
      atomicAdd(s_blk + b, 1u);
    else
      atomicAdd(out + b, 1ull);
  };

  const int4* vec = reinterpret_cast<const int4*>(counts + head);
  const int64_t m = (n - head) / 4;
  const int64_t stride = static_cast<int64_t>(gridDim.x) * kGroup;
  int64_t g = static_cast<int64_t>(blockIdx.x) * kGroup + threadIdx.x;
  int4 next[kVecs];
#pragma unroll
  for (int u = 0; u < kVecs; ++u)
    next[u] = load_or_zero(vec, g + u * kThreads, m);
  for (; g < m; g += stride) {
    int4 v[kVecs];
#pragma unroll
    for (int u = 0; u < kVecs; ++u) {
      v[u] = next[u];
      next[u] = load_or_zero(vec, g + stride + u * kThreads, m);
    }
#pragma unroll
    for (int u = 0; u < kVecs; ++u) {
      add(v[u].x);
      add(v[u].y);
      add(v[u].z);
      add(v[u].w);
    }
  }
  // the head (before the first 16-byte boundary) and the tail, at most
  // three counts each
  if (blockIdx.x == 0 && threadIdx.x < 8) {
    const int t = threadIdx.x;
    const int64_t i = t < 4 ? t : head + 4 * m + (t - 4);
    if (t < 4 ? t < head : i < n) add(counts[i]);
  }

#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    sum += __shfl_xor_sync(0xFFFFFFFFu, sum, off);
  if (lane == 0 && sum != 0)
    atomicAdd(out + hi1 + 1, static_cast<unsigned long long>(sum));
  over = __reduce_add_sync(0xFFFFFFFFu, over);
  if (lane == 0 && over) {
    if (kShared)
      atomicAdd(s_blk + hi1, over);
    else
      atomicAdd(out + hi1, static_cast<unsigned long long>(over));
  }
  __syncwarp();
  for (int b = 1; b < nl; ++b) {
    const unsigned v = __reduce_add_sync(0xFFFFFFFFu, s_lane[32 * b]);
    if (lane == 0 && v) atomicAdd(s_blk + b, v);
  }
  __syncthreads();
  const int nb = kShared ? hi1 + 1 : nl;
  for (int b = threadIdx.x + 1; b < nb; b += kThreads)
    if (s_blk[b])
      atomicAdd(out + b, static_cast<unsigned long long>(s_blk[b]));
}

template <bool kShared>
cudaError_t launch(const int32_t* counts, int64_t n, int high,
                   unsigned long long* out, cudaStream_t s) {
  const int64_t words = smem_words(high, kShared);
  // counts before the first 16-byte boundary (a view may start off one)
  const int64_t skip =
      ((16 - (reinterpret_cast<uintptr_t>(counts) & 15)) & 15) / 4;
  const int head = static_cast<int>(skip < n ? skip : n);
  // a persistent grid: the blocks the card holds at once, at most one
  // for each kGroup int4
  cudaError_t e = cudaFuncSetAttribute(
      count_stats_kernel<kShared>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(kMaxSmem));
  int dev = 0, sms = 0, per_sm = 0;
  if (e == cudaSuccess) e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, count_stats_kernel<kShared>, kThreads,
        static_cast<size_t>(4 * words));
  if (e != cudaSuccess) return e;
  const int64_t want = ((n - head) / 4 + kGroup - 1) / kGroup;
  const int64_t cap = static_cast<int64_t>(sms) * (per_sm > 0 ? per_sm : 1);
  const int blocks = static_cast<int>(want < 1 ? 1 : (want < cap ? want
                                                                 : cap));
  count_stats_kernel<kShared><<<blocks, kThreads,
                                static_cast<size_t>(4 * words), s>>>(
      counts, n, head, high, out);
  return cudaGetLastError();
}

}  // namespace

// counts (n,) int32, any 4-byte alignment -> out (high + 3,) int64: bins
// [0, high + 2), then the total; zeroed by the caller and added to here.
// One launch (none when n is 0).
extern "C" int hast_count_stats(const void* counts, int64_t n, int high,
                                void* out, void* stream) {
  if (n <= 0) return 0;
  const auto* c = static_cast<const int32_t*>(counts);
  auto* o = static_cast<unsigned long long*>(out);
  const auto s = static_cast<cudaStream_t>(stream);
  const cudaError_t e =
      high <= kSharedHigh ? launch<true>(c, n, high, o, s)
                          : launch<false>(c, n, high, o, s);
  return static_cast<int>(e);
}

// The most high whose bins count_stats keeps in shared memory; past it
// they are global atomics.
extern "C" int hast_count_stats_shared_high() { return kSharedHigh; }

// K5 `sort_pairs`: stable LSD radix sort of int64 keys carrying an int32
// payload (or none).
//
// Replaces the `lax.sort` of hast_tpu/ops/kmer_count.py
// `_merge_rle_kernel` (keys with their counts, before the fold) and of
// `chunk_sorted_kmers`.  Only the low `bits` bits are sorted, 8 a pass:
// callers pass 2k + 1, since every real key is below 2^(2k) and the
// sentinel INT64_MAX has all of those bits set, so the sentinel still
// sorts last and the result equals a full stable sort of the int64 keys
// (ceil((2k+1)/8) passes: 4 at k = 15, 6 at k = 21, 8 at k = 31).
// Passes alternate between buffers a and b, and the result lies in a
// after an odd number of passes, in b after an even one.  Pass 0 reads
// the input and writes a, so b may be the input itself: the fold then
// sorts in its concat and one more buffer pair.
//
// Each pass: (1) per-tile 8-bit digit histograms in shared memory,
// stored digit-major as hist[d * n_tiles + tile]; (2) one exclusive scan
// of that array (scan.cuh) gives each (digit, tile) its first output
// slot; (3) a stable scatter: each tile walks its elements in index
// order, 256 at a time, and ranks equal digits with __match_any_sync
// within a warp and per-warp digit counts across the block.
//
// What bounds it on an H100: memory traffic, 12 bytes read for the
// histogram, 12 read and 12 written by the scatter per element and pass
// (plus 8 for the digit read); the scatter's writes land in up to 256
// runs per tile, so they coalesce only partly.  The design is the plain
// three-step pass, kept simple and exact; a one-sweep decoupled look-back
// sort is later work.
#include <cuda_runtime.h>

#include <cstdint>

#include "scan.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kItems = 32;
constexpr int kTile = kThreads * kItems;
constexpr int kDigits = 256;

__device__ __forceinline__ unsigned digit_of(int64_t key, int shift) {
  return static_cast<unsigned>(
             static_cast<unsigned long long>(key) >> shift) & 0xFFu;
}

__global__ void radix_hist_kernel(const int64_t* __restrict__ keys,
                                  int64_t n, int shift,
                                  int32_t* __restrict__ hist,
                                  int64_t n_tiles) {
  __shared__ int s_hist[kDigits];
  s_hist[threadIdx.x] = 0;
  __syncthreads();
  const int64_t base = static_cast<int64_t>(blockIdx.x) * kTile;
  for (int r = 0; r < kItems; ++r) {
    const int64_t i = base + r * kThreads + threadIdx.x;
    if (i < n) atomicAdd(&s_hist[digit_of(keys[i], shift)], 1);
  }
  __syncthreads();
  hist[threadIdx.x * n_tiles + blockIdx.x] = s_hist[threadIdx.x];
}

struct HistVal {
  const int32_t* hist;
  __device__ long long operator()(int64_t i) const { return hist[i]; }
};

struct HistEmit {
  int32_t* hist;
  __device__ void operator()(int64_t i, long long prefix, long long,
                             bool ok) const {
    if (ok) hist[i] = static_cast<int32_t>(prefix);
  }
};

__global__ void radix_scatter_kernel(const int64_t* __restrict__ keys_in,
                                     const int32_t* __restrict__ pay_in,
                                     int64_t n, int shift,
                                     const int32_t* __restrict__ offsets,
                                     int64_t n_tiles,
                                     int64_t* __restrict__ keys_out,
                                     int32_t* __restrict__ pay_out) {
  __shared__ int s_base[kDigits];
  __shared__ int s_warp[kWarps][kDigits];
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  s_base[tid] = offsets[tid * n_tiles + blockIdx.x];
  for (int w = 0; w < kWarps; ++w) s_warp[w][tid] = 0;
  __syncthreads();
  const int64_t base = static_cast<int64_t>(blockIdx.x) * kTile;
  for (int r = 0; r < kItems; ++r) {
    const int64_t i = base + r * kThreads + tid;
    const bool ok = i < n;
    int64_t key = 0;
    int32_t pay = 0;
    if (ok) {
      key = keys_in[i];
      if (pay_in != nullptr) pay = pay_in[i];
    }
    // past the end: digit 256, ranked among themselves and never stored
    const unsigned d = ok ? digit_of(key, shift) : kDigits;
    const unsigned peers = __match_any_sync(0xFFFFFFFFu, d);
    const unsigned below = peers & ((1u << lane) - 1u);
    if (ok && below == 0) s_warp[warp][d] = __popc(peers);
    __syncthreads();
    if (ok) {
      int dst = s_base[d] + __popc(below);
      for (int w = 0; w < warp; ++w) dst += s_warp[w][d];
      keys_out[dst] = key;
      if (pay_out != nullptr) pay_out[dst] = pay;
    }
    __syncthreads();
    int round = 0;
    for (int w = 0; w < kWarps; ++w) {
      round += s_warp[w][tid];
      s_warp[w][tid] = 0;
    }
    s_base[tid] += round;
    __syncthreads();
  }
}

}  // namespace

// keys (n,) int64 and pay (n,) int32 or null, unchanged unless b is
// them; a/b buffers of the same shapes; hist (256 * ceil(n / 8192),) int32; tile_sums
// (scan_tiles(hist size) + 1,) int64.  n < 2^31.
extern "C" int hast_sort_pairs(const void* keys, const void* pay,
                               void* keys_a, void* pay_a, void* keys_b,
                               void* pay_b, int64_t n, int bits, void* hist,
                               void* tile_sums, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int64_t n_tiles = (n + kTile - 1) / kTile;
  const int passes = (bits + 7) / 8;
  const int64_t* k_in = static_cast<const int64_t*>(keys);
  const int32_t* p_in = static_cast<const int32_t*>(pay);
  int32_t* h = static_cast<int32_t*>(hist);
  for (int pass = 0; pass < passes && n_tiles > 0; ++pass) {
    int64_t* k_out = static_cast<int64_t*>(pass % 2 == 0 ? keys_a : keys_b);
    int32_t* p_out = pay == nullptr ? nullptr
                     : static_cast<int32_t*>(pass % 2 == 0 ? pay_a : pay_b);
    const int shift = 8 * pass;
    radix_hist_kernel<<<static_cast<unsigned>(n_tiles), kThreads, 0, s>>>(
        k_in, n, shift, h, n_tiles);
    const cudaError_t e = hast::device_scan(
        HistVal{h}, HistEmit{h}, kDigits * n_tiles,
        static_cast<long long*>(tile_sums), s);
    if (e != cudaSuccess) return static_cast<int>(e);
    radix_scatter_kernel<<<static_cast<unsigned>(n_tiles), kThreads, 0, s>>>(
        k_in, p_in, n, shift, h, n_tiles, k_out, p_out);
    k_in = k_out;
    p_in = p_out;
  }
  return static_cast<int>(cudaGetLastError());
}

// K4 `count_windows`: every canonical k-mer window of a packed batch as
// one int64 key, invalid or out-of-range windows as the sentinel.
//
// Replaces hast_tpu/ops/kmer_count.py `count_kernel_multi` (masked
// batches), `count_kernel_multi_clean` (good = null: validity from the
// lengths alone) and `count_kernel_multi_range` (ranged = 1), all with
// sort=False; with K5 it is also `chunk_sorted_kmers`.  A window p of
// read r is valid iff p + k <= length and, when a mask is given, all k
// of its mask bits are set (bit j of mask byte m is base 8m + j).  A
// valid key outside [lo, hi) becomes the sentinel too.  The bounds are
// uint64 and compared as uint64: estimate_boundaries returns 2^64 - 1 as
// the last bound and even splits at or above 2^63, which as int64 would
// be negative.  Keys are below 2^62 (k <= 31), so the sentinel
// INT64_MAX sorts after every real key.
//
// What bounds it on an H100: the 8-byte key written per window (the
// packed read, 28 bytes for 100 bp, and its 14-byte mask stay in L1);
// the window itself is a few dozen integer ops.  One thread per window,
// as K1, recomputing the window from the packed bytes (kmer.cuh), with no
// shared memory and no ordering between threads.
#include <cuda_runtime.h>

#include <cstdint>

#include "kmer.cuh"

namespace {

constexpr int64_t kSent = INT64_MAX;

__global__ void count_windows_kernel(const uint8_t* __restrict__ packed,
                                     const int32_t* __restrict__ lengths,
                                     const uint8_t* __restrict__ good,
                                     int lg, int64_t n, int lp, int k,
                                     int n_win, int ranged,
                                     unsigned long long lo,
                                     unsigned long long hi,
                                     int64_t* __restrict__ keys) {
  const int64_t total = n * n_win;
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  for (int64_t t = static_cast<int64_t>(blockIdx.x) * blockDim.x +
                   threadIdx.x;
       t < total; t += stride) {
    const int64_t r = t / n_win;
    const int p = static_cast<int>(t - r * n_win);
    bool ok = p + k <= lengths[r];
    if (ok && good != nullptr) {
      const uint8_t* g = good + r * lg;
      for (int j = p; j < p + k; ++j) {
        if (!((g[j >> 3] >> (j & 7)) & 1)) {
          ok = false;
          break;
        }
      }
    }
    int64_t key = kSent;
    if (ok) {
      const unsigned long long w =
          hast::canonical_window(packed + r * lp, p, k);
      if (!ranged || (w >= lo && w < hi)) key = static_cast<int64_t>(w);
    }
    keys[t] = key;
  }
}

}  // namespace

// packed (n, lp) uint8; lengths (n,) int32; good (n, lg) uint8 or null
// -> keys (n * (4*lp - k + 1),) int64.
extern "C" int hast_count_windows(const void* packed, const void* lengths,
                                  const void* good, int lg, int64_t n,
                                  int lp, int k, int ranged,
                                  unsigned long long lo,
                                  unsigned long long hi, void* keys,
                                  void* stream) {
  const int n_win = 4 * lp - k + 1;
  const int64_t total = n * n_win;
  const int threads = 256;
  const int64_t want = (total + threads - 1) / threads;
  const int blocks = static_cast<int>(want < 65536 ? want : 65536);
  count_windows_kernel<<<blocks, threads, 0,
                         static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(packed),
      static_cast<const int32_t*>(lengths),
      static_cast<const uint8_t*>(good), lg, n, lp, k, n_win, ranged, lo,
      hi, static_cast<int64_t*>(keys));
  return static_cast<int>(cudaGetLastError());
}

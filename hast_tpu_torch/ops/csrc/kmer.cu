// K1 `canonical_windows`: every canonical k-mer window of a packed batch.
//
// Replaces hast_tpu/ops/encode.py `canonical_kmers` + `window_valid` (and
// the unpack in hast_tpu/pipeline/classify.py `tally_step`).  Off the
// classify launch sequence -- K3 runs the same device function inline --
// it exists so a fault can be placed in one piece, and for later slices.
// One thread per (read, window); see kmer.cuh for what bounds it.
#include <cuda_runtime.h>

#include <cstdint>

#include "kmer.cuh"

namespace {

__global__ void canonical_windows_kernel(const uint8_t* __restrict__ packed,
                                         const int32_t* __restrict__ lengths,
                                         int64_t n, int lp, int k, int n_win,
                                         int64_t* __restrict__ keys,
                                         uint8_t* __restrict__ valid) {
  const int64_t total = n * n_win;
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  for (int64_t t = static_cast<int64_t>(blockIdx.x) * blockDim.x +
                   threadIdx.x;
       t < total; t += stride) {
    const int64_t r = t / n_win;
    const int p = static_cast<int>(t - r * n_win);
    keys[t] = static_cast<int64_t>(
        hast::canonical_window(packed + r * lp, p, k));
    valid[t] = (p + k <= lengths[r]) ? 1 : 0;
  }
}

}  // namespace

// packed (n, lp) uint8, lengths (n,) int32 -> keys, valid (n, 4*lp-k+1).
extern "C" int hast_canonical_windows(const void* packed, const void* lengths,
                                      int64_t n, int lp, int k, void* keys,
                                      void* valid, void* stream) {
  const int n_win = 4 * lp - k + 1;
  const int64_t total = n * n_win;
  const int threads = 256;
  const int64_t want = (total + threads - 1) / threads;
  const int blocks = static_cast<int>(want < 65536 ? want : 65536);
  canonical_windows_kernel<<<blocks, threads, 0,
                             static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(packed),
      static_cast<const int32_t*>(lengths), n, lp, k, n_win,
      static_cast<int64_t*>(keys), static_cast<uint8_t*>(valid));
  return static_cast<int>(cudaGetLastError());
}

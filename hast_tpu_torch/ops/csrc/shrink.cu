// K12 `shrink_run`: the distinct rows of a folded count run, copied into
// buffers of their own size.
//
// Replaces hast_tpu/ops/kmer_count.py `_shrink` (the first n_pad rows of
// the fold's keys and counts), which `DeviceCounter._settle` runs after
// every fold so that the resident run holds its distinct keys and not the
// whole fold buffer.  The JAX run keeps a power-of-two length for its
// compiled shapes; here the copy is exactly the n distinct rows.
//
// What bounds it on an H100: bytes (12 an element read and 12 written), no
// arithmetic.  A grid-stride loop copies key and count of element i in one
// thread, neighbouring threads on neighbouring addresses.
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr int64_t kMaxBlocks = 132 * 16;

__global__ void shrink_run_kernel(const int64_t* __restrict__ keys,
                                  const int32_t* __restrict__ counts,
                                  int64_t n, int64_t* __restrict__ out_keys,
                                  int32_t* __restrict__ out_counts) {
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  for (int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x +
                   threadIdx.x;
       i < n; i += stride) {
    out_keys[i] = keys[i];
    out_counts[i] = counts[i];
  }
}

}  // namespace

// keys (>= n,) int64, counts (>= n,) int32 -> out_keys (n,), out_counts
// (n,): their first n elements.
extern "C" int hast_shrink_run(const void* keys, const void* counts,
                               int64_t n, void* out_keys, void* out_counts,
                               void* stream) {
  const int64_t want = (n + kThreads - 1) / kThreads;
  const int blocks = static_cast<int>(
      want < 1 ? 1 : (want < kMaxBlocks ? want : kMaxBlocks));
  shrink_run_kernel<<<blocks, kThreads, 0,
                      static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int64_t*>(keys), static_cast<const int32_t*>(counts),
      n, static_cast<int64_t*>(out_keys), static_cast<int32_t*>(out_counts));
  return static_cast<int>(cudaGetLastError());
}

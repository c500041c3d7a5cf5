// K2 `probe`: membership payload of each canonical key.
//
// Replaces hast_tpu/ops/hashtable.py `probe_quot` and `probe`.  Off the
// classify launch sequence -- K3 runs `probe_key` inline -- it serves
// the stage-03 segment vote next and lets a fault be placed in one piece.
// One thread per key; see probe.cuh for what bounds it.
#include <cuda_runtime.h>

#include <cstdint>

#include "probe.cuh"

namespace {

__global__ void probe_kernel(hast::Table table,
                             const int64_t* __restrict__ keys, int64_t n,
                             int32_t* __restrict__ out) {
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  for (int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x +
                   threadIdx.x;
       i < n; i += stride) {
    out[i] = hast::probe_key(table, static_cast<uint64_t>(keys[i]));
  }
}

}  // namespace

// table (n_buckets, 4) uint32 bits, keys (n,) int64 -> out (n,) int32.
extern "C" int hast_probe(const void* table, int64_t n_buckets, int bbits,
                          int fmt, int k, int max_probe, const void* keys,
                          int64_t n, void* out, void* stream) {
  const hast::Table t{static_cast<const uint4*>(table),
                      static_cast<uint32_t>(n_buckets), bbits, fmt, k,
                      max_probe};
  const int threads = 256;
  const int64_t want = (n + threads - 1) / threads;
  const int blocks = static_cast<int>(want < 65536 ? want : 65536);
  probe_kernel<<<blocks, threads, 0, static_cast<cudaStream_t>(stream)>>>(
      t, static_cast<const int64_t*>(keys), n, static_cast<int32_t*>(out));
  return static_cast<int>(cudaGetLastError());
}

// K3 `classify_tally`: per-read votes scatter-added into the barcode tally.
//
// Replaces hast_tpu/pipeline/classify.py `tally_step`, the only device
// launch of the classify main path.  Per read: unpack, canonical windows
// and validity (kmer.cuh), the two-bucket probe (probe.cuh), the votes
// v0 = #windows with payload bit 0 and v1 = #windows with bit 1, the
// N-read short-circuit to (0, 0, 1), then int32 atomics of
// (v0, v1, unknown) into acc[id]; ids outside [0, cap) are dropped.
//
// What bounds it on an H100: the probe's two random 16-byte row reads
// per window (92 windows x 2 rows for a 100-bp read at k = 21); the
// packed read itself is 28 bytes.  One warp per read: its lanes stride
// over the read's valid windows, so 32 probes (64 row reads) of one read
// are in flight together, a shuffle reduction sums the votes, and one
// lane issues at most three atomics per read.  Windows past the read's
// length are never probed.  Reads shorter than k and batches whose
// stride holds fewer than k bases vote (0, 0, 1).
#include <cuda_runtime.h>

#include <cstdint>

#include "kmer.cuh"
#include "probe.cuh"

namespace {

constexpr int kWarpsPerBlock = 8;

__global__ void classify_tally_kernel(hast::Table table,
                                      const uint8_t* __restrict__ packed,
                                      const int32_t* __restrict__ lengths,
                                      const int32_t* __restrict__ ids,
                                      const uint8_t* __restrict__ has_n,
                                      int64_t n, int lp,
                                      int32_t* __restrict__ acc,
                                      int64_t cap) {
  const int lane = threadIdx.x & 31;
  const int64_t n_warps =
      (static_cast<int64_t>(gridDim.x) * blockDim.x) >> 5;
  const int n_win = 4 * lp - table.k + 1;
  for (int64_t r = (static_cast<int64_t>(blockIdx.x) * blockDim.x +
                    threadIdx.x) >> 5;
       r < n; r += n_warps) {
    const int64_t id = ids[r];
    if (id < 0 || id >= cap) continue;  // warp-uniform
    const bool is_n = has_n[r] != 0;
    int v0 = 0, v1 = 0;
    if (!is_n) {
      const int last = min(n_win, lengths[r] - table.k + 1);
      const uint8_t* row = packed + r * lp;
      for (int p = lane; p < last; p += 32) {
        const int pay =
            hast::probe_key(table, hast::canonical_window(row, p, table.k));
        v0 += pay & 1;
        v1 += (pay >> 1) & 1;
      }
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) {
        v0 += __shfl_xor_sync(0xFFFFFFFFu, v0, off);
        v1 += __shfl_xor_sync(0xFFFFFFFFu, v1, off);
      }
    }
    if (lane == 0) {
      int32_t* a = acc + id * 3;
      if (v0) atomicAdd(a, v0);
      if (v1) atomicAdd(a + 1, v1);
      if (is_n || (v0 == 0 && v1 == 0)) atomicAdd(a + 2, 1);
    }
  }
}

}  // namespace

// acc (cap, 3) int32 updated in place; packed (n, lp) uint8; lengths and
// ids (n,) int32; has_n (n,) uint8.
extern "C" int hast_classify_tally(const void* table, int64_t n_buckets,
                                   int bbits, int fmt, int k, int max_probe,
                                   const void* packed, const void* lengths,
                                   const void* ids, const void* has_n,
                                   int64_t n, int lp, void* acc, int64_t cap,
                                   void* stream) {
  const hast::Table t{static_cast<const uint4*>(table),
                      static_cast<uint32_t>(n_buckets), bbits, fmt, k,
                      max_probe};
  const int threads = 32 * kWarpsPerBlock;
  const int64_t want = (n + kWarpsPerBlock - 1) / kWarpsPerBlock;
  const int blocks = static_cast<int>(want < 65536 ? want : 65536);
  classify_tally_kernel<<<blocks, threads, 0,
                          static_cast<cudaStream_t>(stream)>>>(
      t, static_cast<const uint8_t*>(packed),
      static_cast<const int32_t*>(lengths), static_cast<const int32_t*>(ids),
      static_cast<const uint8_t*>(has_n), n, lp, static_cast<int32_t*>(acc),
      cap);
  return static_cast<int>(cudaGetLastError());
}

// K13 `vote_reads`: each read's (v0, v1) marker votes, with no tally.
//
// Replaces hast_tpu/pipeline/classify.py `vote_kernel_packed` (packed
// form: 4 bases a byte, base i at bits 2*(i & 3) of byte i >> 2; votes
// stored as uint16), `vote_kernel` and `vote_kernel_multi` (ASCII form:
// one byte a base, coded (b >> 1) & 3 whatever the byte is; votes int32),
// and the per-shard probe of hast_tpu/parallel/mesh.py `sharded_vote_step`
// and `sharded_classify_step` (`_probe_local`): the table may be the
// slice of rows [row_lo, row_lo + n_rows) that one tp shard holds, and a
// window then counts only the hits in the buckets that slice owns
// (probe.cuh `probe_key_owned`).  In both forms a window p is valid iff
// p + k <= length and it lies inside the row's stride: no byte is bad.
// v0 counts the valid windows whose payload has bit 0, v1 those with
// bit 1.
//
// What bounds it on an H100: as K3, the probe's two random 16-byte row
// reads per window (92 windows x 2 rows for a 100-bp read at k = 21); the
// read is 28 packed or 100 ASCII bytes.  K3's structure: one warp per
// read, its lanes striding the read's valid windows so that 32 probes are
// in flight together, a shuffle sum, and lane 0 storing the two votes.
// Windows past the read's length are never probed.
#include <cuda_runtime.h>

#include <cstdint>

#include "kmer.cuh"
#include "probe.cuh"

namespace {

constexpr int kWarpsPerBlock = 8;

template <bool kAscii, typename Vote>
__global__ void vote_reads_kernel(hast::Table table, uint32_t row_lo,
                                  uint32_t n_rows,
                                  const uint8_t* __restrict__ reads,
                                  const int32_t* __restrict__ lengths,
                                  int64_t n, int stride,
                                  Vote* __restrict__ votes) {
  const int lane = threadIdx.x & 31;
  const int64_t n_warps =
      (static_cast<int64_t>(gridDim.x) * blockDim.x) >> 5;
  const int n_win = (kAscii ? stride : 4 * stride) - table.k + 1;
  for (int64_t r = (static_cast<int64_t>(blockIdx.x) * blockDim.x +
                    threadIdx.x) >> 5;
       r < n; r += n_warps) {
    const int last = min(n_win, lengths[r] - table.k + 1);
    const uint8_t* row = reads + r * stride;
    int v0 = 0, v1 = 0;
    for (int p = lane; p < last; p += 32) {
      uint64_t key;
      if constexpr (kAscii) {
        hast::canonical_window_bytes<hast::kAnyByte>(row + p, table.k, key);
      } else {
        key = hast::canonical_window(row, p, table.k);
      }
      const int pay = hast::probe_key_owned(table, key, row_lo, n_rows);
      v0 += pay & 1;
      v1 += (pay >> 1) & 1;
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      v0 += __shfl_xor_sync(0xFFFFFFFFu, v0, off);
      v1 += __shfl_xor_sync(0xFFFFFFFFu, v1, off);
    }
    if (lane == 0) {
      votes[2 * r] = static_cast<Vote>(v0);
      votes[2 * r + 1] = static_cast<Vote>(v1);
    }
  }
}

}  // namespace

// The table's rows [row_lo, row_lo + n_rows) at `table`; reads (n, stride)
// uint8, packed (ascii = 0, 4 bases a byte) or ASCII (ascii = 1); lengths
// (n,) int32 -> votes (n, 2), uint16 for packed reads, int32 for ASCII.
extern "C" int hast_vote_reads(const void* table, int64_t n_buckets,
                               int bbits, int fmt, int k, int max_probe,
                               int64_t row_lo, int64_t n_rows,
                               const void* reads, const void* lengths,
                               int64_t n, int stride, int ascii, void* votes,
                               void* stream) {
  const hast::Table t{static_cast<const uint4*>(table),
                      static_cast<uint32_t>(n_buckets), bbits, fmt, k,
                      max_probe};
  const int threads = 32 * kWarpsPerBlock;
  const int64_t want = (n + kWarpsPerBlock - 1) / kWarpsPerBlock;
  const int blocks = static_cast<int>(want < 65536 ? want : 65536);
  const auto s = static_cast<cudaStream_t>(stream);
  const auto* r = static_cast<const uint8_t*>(reads);
  const auto* len = static_cast<const int32_t*>(lengths);
  const auto lo = static_cast<uint32_t>(row_lo);
  const auto rows = static_cast<uint32_t>(n_rows);
  if (ascii) {
    vote_reads_kernel<true, int32_t><<<blocks, threads, 0, s>>>(
        t, lo, rows, r, len, n, stride, static_cast<int32_t*>(votes));
  } else {
    vote_reads_kernel<false, uint16_t><<<blocks, threads, 0, s>>>(
        t, lo, rows, r, len, n, stride, static_cast<uint16_t*>(votes));
  }
  return static_cast<int>(cudaGetLastError());
}

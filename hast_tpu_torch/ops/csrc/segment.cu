// K9 `segment_votes`: per-record marker votes of stage 03's segment
// classifier.
//
// Replaces hast_tpu/pipeline/rephase.py `_strict_vote` and the host loop
// that adds its per-piece votes into each record's (v0, v1)
// (`_segment_hits_batch`, rephase.py:237-272).  For every window of k
// bytes inside a record: the key is min(forward, reverse complement) of
// the codes (c >> 1) & 3, the window is valid iff all k bytes are
// uppercase A, C, G or T (kmer.cuh `canonical_window_ascii`), and a valid
// window's payload comes from the two-bucket probe of the segment table
// (probe.cuh, both formats).  v0 counts valid windows with payload bit 0,
// v1 those with bit 1, and both are added into out[record].
//
// The JAX path cuts records into 4096-byte pieces with k - 1 overlap to
// fit static TPU shapes; every window falls in exactly one piece, so the
// sum over pieces is the sum over the record's windows, which is what
// this kernel adds, with no padding, no piece loop and no mask upload.
//
// What bounds it on an H100: the probe's two random 16-byte row reads per
// valid window; the record bytes are read once.  A segment table of a
// human marker set (2 x 10^8 keys per haplotype) lies in HBM, not in the
// 50 MB L2.  Design: records are split into tiles of kTile windows, one
// block a tile (grid-stride); the block stages the tile's kTile + k - 1
// bytes in shared memory, each thread takes windows kThreads apart and
// probes only valid ones, the votes are summed by warp shuffles and
// across warps in shared memory, and thread 0 issues one 64-bit atomic
// per haplotype per tile.  Integer atomics give the same sums in any
// order, so the result equals the plain PyTorch twin exactly.
#include <cuda_runtime.h>

#include <cstdint>

#include "kmer.cuh"
#include "probe.cuh"

namespace {

constexpr int kTile = 1024;    // windows a tile (SEGMENT_TILE in rephase.py)
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;

__global__ void segment_votes_kernel(hast::Table table,
                                     const uint8_t* __restrict__ data,
                                     const int64_t* __restrict__ starts,
                                     const int64_t* __restrict__ tile_start,
                                     int64_t n_rec,
                                     unsigned long long* __restrict__ out) {
  __shared__ uint8_t s_bytes[kTile + hast::kMaxK - 1];
  __shared__ int s_votes[2][kWarps];
  const int k = table.k;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int64_t n_tiles = tile_start[n_rec];
  for (int64_t tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
    // the record of this tile: the last r with tile_start[r] <= tile
    // (records without windows have no tile and are skipped over)
    int64_t lo = 0, hi = n_rec;
    while (hi - lo > 1) {
      const int64_t mid = (lo + hi) >> 1;
      if (tile_start[mid] <= tile) lo = mid; else hi = mid;
    }
    const int64_t p0 = (tile - tile_start[lo]) * kTile;
    const int64_t n_win = starts[lo + 1] - starts[lo] - k + 1;
    const int nw = static_cast<int>(n_win - p0 < kTile ? n_win - p0 : kTile);
    const uint8_t* src = data + starts[lo] + p0;
    __syncthreads();  // the previous tile's readers are done with s_bytes
    for (int i = threadIdx.x; i < nw + k - 1; i += kThreads)
      s_bytes[i] = src[i];
    __syncthreads();
    int v0 = 0, v1 = 0;
    for (int p = threadIdx.x; p < nw; p += kThreads) {
      uint64_t key;
      if (hast::canonical_window_ascii(s_bytes + p, k, key)) {
        const int pay = hast::probe_key(table, key);
        v0 += pay & 1;
        v1 += (pay >> 1) & 1;
      }
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      v0 += __shfl_xor_sync(0xFFFFFFFFu, v0, off);
      v1 += __shfl_xor_sync(0xFFFFFFFFu, v1, off);
    }
    if (lane == 0) {
      s_votes[0][warp] = v0;
      s_votes[1][warp] = v1;
    }
    __syncthreads();
    if (threadIdx.x == 0) {
      unsigned long long t0 = 0, t1 = 0;
#pragma unroll
      for (int w = 0; w < kWarps; ++w) {
        t0 += s_votes[0][w];
        t1 += s_votes[1][w];
      }
      if (t0) atomicAdd(out + 2 * lo, t0);
      if (t1) atomicAdd(out + 2 * lo + 1, t1);
    }
  }
}

}  // namespace

// data (n_bytes,) uint8 ASCII records back to back; starts (n_rec + 1,)
// int64 record offsets; tile_start (n_rec + 1,) int64, the prefix sum of
// each record's ceil(max(0, length - k + 1) / kTile) tiles; out (n_rec, 2)
// int64, added to.  max_tiles bounds the grid (n_bytes / kTile + n_rec).
extern "C" int hast_segment_votes(const void* table, int64_t n_buckets,
                                  int bbits, int fmt, int k, int max_probe,
                                  const void* data, const void* starts,
                                  const void* tile_start, int64_t n_rec,
                                  int64_t max_tiles, void* out,
                                  void* stream) {
  const hast::Table t{static_cast<const uint4*>(table),
                      static_cast<uint32_t>(n_buckets), bbits, fmt, k,
                      max_probe};
  const int64_t cap = 1 << 20;
  const int blocks = static_cast<int>(
      max_tiles < 1 ? 1 : (max_tiles < cap ? max_tiles : cap));
  segment_votes_kernel<<<blocks, kThreads, 0,
                         static_cast<cudaStream_t>(stream)>>>(
      t, static_cast<const uint8_t*>(data),
      static_cast<const int64_t*>(starts),
      static_cast<const int64_t*>(tile_start), n_rec,
      static_cast<unsigned long long*>(out));
  return static_cast<int>(cudaGetLastError());
}

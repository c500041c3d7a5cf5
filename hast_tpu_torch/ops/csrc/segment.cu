// K9 `segment_votes`: per-record marker votes of stage 03's segment
// classifier.
//
// Replaces hast_tpu/pipeline/rephase.py `_strict_vote` and the host loop
// that adds its per-piece votes into each record's (v0, v1)
// (`_segment_hits_batch`, rephase.py:237-272).  For every window of k
// bytes inside a record: the key is min(forward, reverse complement) of
// the codes (c >> 1) & 3, the window is valid iff all k bytes are
// uppercase A, C, G or T (kmer.cuh `kAcgtUpper`), and a valid window's
// payload comes from the two-bucket probe of the segment table
// (probe.cuh, both formats).  v0 counts valid windows with payload bit 0,
// v1 those with bit 1, and both are added into out[record].
//
// The JAX path cuts records into 4096-byte pieces with k - 1 overlap to
// fit static TPU shapes; every window falls in exactly one piece, so the
// sum over pieces is the sum over the record's windows, which is what
// this kernel adds, with no padding, no piece loop and no mask upload.
//
// What bounds it on an H100: the probe's arithmetic (a Feistel
// permutation and eight slot tests a quot key) and its two random
// 16-byte row reads per valid window; the record bytes are read once.  A
// segment table of a human marker set (2 x 10^8 keys per haplotype) lies
// in HBM, not in the 50 MB L2.  Design:
//  - records are cut into tiles of kTile windows; each block walks a
//    contiguous range of tiles, so it searches tile_start once and
//    follows the records forward;
//  - the block loads a tile's bytes once (16-byte loads from the aligned
//    address below the tile) and packs them into 2-bit codes and
//    uppercase-ACGT flags in shared memory (two buffers, so one barrier a
//    tile); each thread takes kPer consecutive windows, cuts the first
//    one's words and run of good bases from the packed words and rolls
//    the rest one base a window (kmer.cuh, shared with K14);
//  - each warp compacts its valid keys into shared memory with ballots,
//    then its lanes probe them densely, kBatch keys a lane at a time with
//    all 2 x kBatch row loads issued before any row is tested, so an
//    HBM-resident table has several misses a lane in flight;
//  - votes are summed in registers across a record's tiles, then by warp
//    shuffles and across warps in shared memory, and thread 0 issues one
//    64-bit atomic per haplotype per block and record.  Integer atomics
//    give the same sums in any order, so the result equals the plain
//    PyTorch twin exactly.
#include <cuda_runtime.h>

#include <cstdint>

#include "kmer.cuh"
#include "probe.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kPer = 16;                  // windows a thread rolls a tile
constexpr int kTile = kThreads * kPer;    // SEGMENT_TILE in rephase.py
constexpr int kBatch = 4;                 // keys a lane probes at a time
// 16-byte chunks of a tile's packed bytes: up to 15 bytes of alignment,
// kTile + k - 1 bytes, and the two words packed_bases and packed_flags
// read past the last thread's windows (chunk (15 + 16 * (kThreads - 1) +
// kMaxK) / 16 + 2 = 259 at most)
constexpr int kChunks = kTile / 16 + 4;

// Block totals of v0 and v1 added into out[rec]; every thread calls it.
__device__ __forceinline__ void flush_votes(int& v0, int& v1, int64_t rec,
                                            int (*s_votes)[kWarps],
                                            unsigned long long* out) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    v0 += __shfl_xor_sync(0xFFFFFFFFu, v0, off);
    v1 += __shfl_xor_sync(0xFFFFFFFFu, v1, off);
  }
  if ((threadIdx.x & 31) == 0) {
    s_votes[0][threadIdx.x >> 5] = v0;
    s_votes[1][threadIdx.x >> 5] = v1;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    unsigned long long t0 = 0, t1 = 0;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      t0 += s_votes[0][w];
      t1 += s_votes[1][w];
    }
    if (t0) atomicAdd(out + 2 * rec, t0);
    if (t1) atomicAdd(out + 2 * rec + 1, t1);
  }
  __syncthreads();   // s_votes is reused by the next flush
  v0 = v1 = 0;
}

__global__ void __launch_bounds__(kThreads)
segment_votes_kernel(hast::Table table, const uint8_t* __restrict__ data,
                     const int64_t* __restrict__ starts,
                     const int64_t* __restrict__ tile_start, int64_t n_rec,
                     unsigned long long* __restrict__ out) {
  __shared__ uint32_t s_codes[2][kChunks];
  __shared__ uint16_t s_good[2][kChunks];
  __shared__ uint64_t s_keys[kWarps][32 * kPer];
  __shared__ int s_votes[2][kWarps];
  const int k = table.k;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const unsigned lt = (1u << lane) - 1u;
  uint64_t* wkeys = s_keys[warp];

  // this block's tiles [t0, t1), and the record of t0: the last r with
  // tile_start[r] <= t0 (records without windows have no tile)
  const int64_t n_tiles = tile_start[n_rec];
  const int64_t per_block = (n_tiles + gridDim.x - 1) / gridDim.x;
  const int64_t t0 = static_cast<int64_t>(blockIdx.x) * per_block;
  const int64_t t1 = t0 + per_block < n_tiles ? t0 + per_block : n_tiles;
  if (t0 >= t1) return;
  int64_t rec = 0, hi = n_rec;
  while (hi - rec > 1) {
    const int64_t mid = (rec + hi) >> 1;
    if (tile_start[mid] <= t0) rec = mid; else hi = mid;
  }

  int v0 = 0, v1 = 0;
  for (int64_t tile = t0; tile < t1; ++tile) {
    int64_t r = rec;
    while (tile_start[r + 1] <= tile) ++r;
    if (r != rec) {
      flush_votes(v0, v1, rec, s_votes, out);
      rec = r;
    }
    const int64_t p0 = (tile - tile_start[rec]) * kTile;
    const int64_t n_win = starts[rec + 1] - starts[rec] - k + 1;
    const int nw = static_cast<int>(n_win - p0 < kTile ? n_win - p0 : kTile);
    // the tile's bytes from the 16-byte aligned address at or below them
    // (an aligned chunk holding a byte of the data lies in its page)
    const uintptr_t src = reinterpret_cast<uintptr_t>(data + starts[rec] + p0);
    const uint4* chunk = reinterpret_cast<const uint4*>(src & ~uintptr_t{15});
    const int off = static_cast<int>(src & 15);
    const int chunks = (off + nw + k - 1 + 15) >> 4;
    uint32_t* codes32 = s_codes[(tile - t0) & 1];
    uint16_t* good16 = s_good[(tile - t0) & 1];
    for (int c = threadIdx.x; c < chunks; c += kThreads) {
      const uint4 v = __ldg(chunk + c);
      const uint32_t words[4] = {v.x, v.y, v.z, v.w};
      uint32_t cw = 0, gw = 0;
#pragma unroll
      for (int t = 0; t < 16; ++t) {
        const uint32_t b = (words[t >> 2] >> (8 * (t & 3))) & 0xFFu;
        cw |= ((b >> 1) & 3u) << (2 * t);
        gw |= static_cast<uint32_t>(hast::byte_ok<hast::kAcgtUpper>(b)) << t;
      }
      codes32[c] = cw;
      good16[c] = static_cast<uint16_t>(gw);
    }
    // the other buffer's readers finished before the previous barrier
    __syncthreads();

    // windows [first, first + per) of the tile: cut, roll, and compact
    // the valid keys into the warp's slots
    const int first = threadIdx.x * kPer;
    const int per = nw - first;
    const int p = off + first;            // its first base in the buffer
    hast::Window win = hast::first_window(hast::packed_bases(codes32, p),
                                          hast::packed_flags(good16, p), k);
    uint64_t next = hast::packed_bases(codes32, p + k);
    uint64_t flags = hast::packed_flags(good16, p + k);
    int cnt = 0;
#pragma unroll
    for (int j = 0; j < kPer; ++j) {
      if (j) {
        hast::roll_window(win, static_cast<uint32_t>(next & 3u),
                          flags & 1u, k);
        next >>= 2;
        flags >>= 1;
      }
      const bool ok = j < per && win.run >= k;
      const unsigned m = __ballot_sync(0xFFFFFFFFu, ok);
      if (ok) wkeys[cnt + __popc(m & lt)] = hast::canonical_of(win);
      cnt += __popc(m);
    }
    __syncwarp();

    for (int base = 0; base < cnt; base += 32 * kBatch) {
      hast::ProbeRows a[kBatch];
      uint4 r1[kBatch], r2[kBatch];
#pragma unroll
      for (int j = 0; j < kBatch; ++j) {
        if (base + 32 * j + lane < cnt) {
          a[j] = hast::probe_rows(table, wkeys[base + 32 * j + lane]);
          r1[j] = __ldg(table.rows + a[j].b[0]);
          r2[j] = __ldg(table.rows + a[j].b[1]);
        }
      }
#pragma unroll
      for (int j = 0; j < kBatch; ++j) {
        if (base + 32 * j + lane < cnt) {
          const int pay = hast::probe_hit(table, a[j], r1[j], r2[j], true,
                                          true);
          v0 += pay & 1;
          v1 += (pay >> 1) & 1;
        }
      }
    }
    __syncwarp();   // the warp's slots are refilled next tile
  }
  flush_votes(v0, v1, rec, s_votes, out);
}

// Blocks of segment_votes_kernel the card holds at once.
int resident_blocks() {
  static const int n = [] {
    int dev = 0, sms = 132, per_sm = 1;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, segment_votes_kernel, kThreads, 0);
    return sms * (per_sm > 0 ? per_sm : 1);
  }();
  return n;
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
  const int64_t cap = resident_blocks();
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

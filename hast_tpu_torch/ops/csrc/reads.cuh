// The read-tile vote routine of K3 `classify_tally` and K13 `vote_reads`
// (device functions).
//
// Both kernels vote reads the same way: every window p of a read with
// p + k <= length that lies inside the row's stride is cut into its
// canonical key, probed in the two-bucket marker table (probe.cuh, both
// formats), and v0 counts the windows whose payload has bit 0, v1 those
// with bit 1.  Rows are packed (4 bases a byte, base i at bits 2*(i & 3)
// of byte i >> 2: the native reader's layout) or ASCII (one byte a base,
// coded (b >> 1) & 3 whatever the byte is: no byte makes a window
// invalid).  The kernel that calls the routine says which reads to vote
// (a read with length 0 gets no probe) and what to do with the sums.
//
// What bounds it on an H100: the probe's arithmetic (a Feistel
// permutation and eight slot tests a quot key, some 140 int32
// operations) and its two random 16-byte row reads a window; a 100-bp
// read is 28 packed bytes.  Design:
//  - a block takes a tile of whole reads, as many consecutive rows as
//    fit in kTile windows of the stride (22 rows of 92 windows for
//    100-bp reads in 28-byte rows), and stages their bytes once from
//    16-byte loads at the aligned address below them: packed rows as
//    they are (read as little-endian words they are kmer.cuh's packing
//    for any stride), ASCII rows packed into 2-bit codes;
//  - each thread takes kPer consecutive windows of the tile in (read, p)
//    order, cuts the first from the packed words and rolls the rest one
//    base a window (kmer.cuh), cutting anew where its run crosses into
//    the next read: some 20 operations a window instead of k byte loads;
//  - each warp compacts its valid keys with ballots, each beside its
//    read's row in the tile, and its lanes probe them densely, kBatch
//    keys a lane with all 2 x kBatch row loads issued before any row is
//    tested; a row outside the owned range [row_lo, row_lo + n_rows) (a
//    tp shard's slice of the table) is not loaded and adds nothing;
//  - a hit adds its two payload bits into its read's 64-bit (v0, v1)
//    counter in shared memory; integer sums are exact in any order.
// A row with more than kTile windows (the native paths' len_cap 8,192
// and 65,536 redo, whose stride is the batch's longest read) takes the
// long form: a block takes kWarps consecutive reads.  A read of at most
// kWarpTile windows (most of such a batch: its short reads) is voted by
// one warp alone, staged and rolled as a tile of its own; the block then
// walks each longer read's windows in successive tiles through two
// staging buffers (one barrier a tile), keeping the sums in registers
// until the read ends.  The longest read's walk, one tile after another,
// bounds it: on a batch of 8,192 reads in 2,048-byte rows, 1 % of them
// 1,000-8,192 bases, those long reads alone took 0.042 ms of the whole
// batch's 0.051-0.053 on an H100.
// The constants are the fastest of the variants timed on an H100 (K3 and
// K13 on 2^20-, 2^21- and 2^24-row tables): 2,048-window tiles, two keys
// a lane and 48 registers, five blocks an SM.  4,096-window tiles with
// four keys a lane at 78 registers (three blocks an SM) were slower on
// every table, and at 48 registers (40 KB of shared memory a block)
// 1.2-2.2x slower on the 2^21- and 2^24-row tables.
#pragma once

#include <cstdint>

#include "kmer.cuh"
#include "probe.cuh"

namespace hast {
namespace reads {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kBlocksPerSm = 5;          // resident blocks (48 registers)
// the long form's: both walks inlined spill at 48 registers, and at 64
// (four blocks an SM) its device time on a len_cap 8,192 batch fell
// from 0.060 to 0.051-0.053 ms on an H100
constexpr int kLongBlocksPerSm = 4;
constexpr int kPer = 8;                  // windows a thread rolls a tile
constexpr int kTile = kThreads * kPer;   // windows a tile holds
constexpr int kBatch = 2;                // keys a lane probes at a time
constexpr int kMaxRows = 128;            // rows a tile holds (fit a byte)
constexpr int kWarpTile = 32 * kPer;     // the long form's warp a read
// Words of a tile's staged codes: at most kTile + kMaxRows * (kMaxK - 1)
// bases (5,888 bases: 1,472 packed bytes in 95 16-byte chunks with the
// alignment and the two zero chunks; 369 ASCII chunks of one word each
// and three zero words), or a long row's kTile + kMaxK - 1 bases; a
// warp's read in the long form, kWarpTile + kMaxK - 1 bases.
constexpr int kCodeWords = 384;
constexpr int kWarpCodeWords = 32;

// Rows of a tile for n_win windows a row (the short form): whole rows, at
// most kTile windows and kMaxRows rows.
__host__ __device__ inline int tile_rows(int n_win) {
  return n_win > 0 && kTile / n_win < kMaxRows ? kTile / n_win : kMaxRows;
}

// Shared memory of a block.  len[i] and cnt[i] belong to the tile's row
// i (the long form's read i): the length to vote it by (0: not voted) and
// its sums (v0 in the low 32 bits, v1 in the high).  The packed form
// stages 16-byte chunks into codes (the long form's block walks) and
// wcodes (its warps' reads).
template <bool kLong>
struct alignas(16) Smem {
  uint32_t codes[kLong ? 2 : 1][kCodeWords];
  uint32_t wcodes[kLong ? kWarps : 1][kLong ? kWarpCodeWords : 4];
  int32_t len[kLong ? kWarps : kMaxRows];
  unsigned long long cnt[kLong ? kWarps : kMaxRows];
  uint64_t keys[kWarps][32 * kPer];           // a warp's compacted keys
  uint8_t row[kLong ? 1 : kWarps][kLong ? 1 : 32 * kPer];   // and rows
};

// Four ASCII bytes (little-endian in w) as 8 bits of 2-bit codes (b >> 1)
// & 3, the first byte's at bits 0-1.
__device__ __forceinline__ uint32_t ascii_codes4(uint32_t w) {
  const uint32_t x = (w >> 1) & 0x03030303u;
  const uint32_t y = x | (x >> 6);
  return (y & 0xFu) | ((y >> 12) & 0xF0u);
}

// Stage bytes [src, src + n_bytes) as codes from the 16-byte aligned
// address at or below src (an aligned chunk holding a byte of the input
// lies in its page), zeros after for packed_bases' reads past the last
// base; returns the base index of src's first base in codes.  The
// kGroup threads of a group (a block or a warp) call it, tid their index.
template <bool kAscii, int kGroup>
__device__ __forceinline__ int stage(const uint8_t* src, int n_bytes,
                                     uint32_t* codes, int tid) {
  const uintptr_t a = reinterpret_cast<uintptr_t>(src);
  const uint4* chunk = reinterpret_cast<const uint4*>(a & ~uintptr_t{15});
  const int off = static_cast<int>(a & 15);
  const int chunks = (off + n_bytes + 15) >> 4;
  if constexpr (kAscii) {
    for (int c = tid; c < chunks + 3; c += kGroup) {
      uint32_t cw = 0;
      if (c < chunks) {
        const uint4 v = __ldg(chunk + c);
        cw = ascii_codes4(v.x) | ascii_codes4(v.y) << 8 |
             ascii_codes4(v.z) << 16 | ascii_codes4(v.w) << 24;
      }
      codes[c] = cw;
    }
    return off;
  } else {
    uint4* dst = reinterpret_cast<uint4*>(codes);
    for (int c = tid; c < chunks + 2; c += kGroup)
      dst[c] = c < chunks ? __ldg(chunk + c) : make_uint4(0u, 0u, 0u, 0u);
    return 4 * off;
  }
}

// Barrier of a group: the block, or one warp.
template <int kGroup>
__device__ __forceinline__ void group_sync() {
  if constexpr (kGroup == 32)
    __syncwarp();
  else
    __syncthreads();
}

// Vote the rows of a tile into sm.cnt.  src: the tile's first row, of
// stride bytes; rows rows in the short form, one in the long form (the
// block's read `slot`, walked by the whole block or, kGroup 32, by this
// warp alone in one tile: at most kWarpTile windows); n_win = bases a row
// - k + 1 windows a row; it: the long form's block walks' tile count,
// whose parity picks the staging buffer.  sm.len and sm.cnt are set, and
// a barrier passed, before the call; the caller passes a barrier after it
// before it reads sm.cnt.  Every thread of the group calls it.
template <bool kAscii, bool kLong, int kGroup = kThreads>
__device__ __forceinline__ void vote_tile(const Table& t, uint32_t row_lo,
                                          uint32_t n_rows, const uint8_t* src,
                                          int stride, int n_win, int rows,
                                          int slot, int& it,
                                          Smem<kLong>& sm) {
  constexpr int kT = kGroup * kPer;   // windows a tile of the group
  const int k = t.k;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int tid = kGroup == 32 ? lane : threadIdx.x;
  const unsigned lt = (1u << lane) - 1u;
  const int bases = kAscii ? stride : 4 * stride;
  // the second row is not loaded where the full format has one choice
  const bool second = t.fmt == kQuot || t.max_probe > 1;
  const uint4 none = make_uint4(0u, 0u, 0u, 0u);
  uint64_t* wkeys = sm.keys[warp];
  uint8_t* wrows = sm.row[kLong ? 0 : warp];
  // windows the group walks: the tile's rows, or the long row's valid ones
  const int nw = kLong ? min(n_win, sm.len[slot] - k + 1) : rows * n_win;
  unsigned long long mine = 0;   // the long form's sums of this thread

  for (int p0 = 0; p0 < nw; p0 += kT, ++it) {
    const int nt = min(kT, nw - p0);
    uint32_t* codes = kGroup == 32 ? sm.wcodes[kLong ? warp : 0]
                                   : sm.codes[kLong ? it & 1 : 0];
    const int base0 =
        kLong ? stage<kAscii, kGroup>(
                    src + (kAscii ? p0 : p0 / 4),
                    kAscii ? nt + k - 1 : (nt + k + 2) / 4, codes, tid)
              : stage<kAscii, kGroup>(src, rows * stride, codes, tid);
    // the long form's other buffer was last read before this barrier
    group_sync<kGroup>();

    // windows [first, first + per) of the tile: window (r, p) starts at
    // base r * bases + p - p0 of the staged codes
    const int first = tid * kPer;
    const int per = nt - first;
    int r = 0, p = p0 + first;
    if (!kLong && per > 0) {
      r = first / n_win;   // once a thread
      p = first - r * n_win;
    }
    Window w{0, 0, 0};
    uint64_t next = 0;
    int len = 0;
    auto cut = [&]() {
      const int bi = base0 + r * bases + p - p0;
      w = first_window(packed_bases(codes, bi), ~0ull, k);
      next = packed_bases(codes, bi + k);
      len = sm.len[slot + r];
    };
    if (per > 0) cut();
    int cnt = 0;
#pragma unroll
    for (int j = 0; j < kPer; ++j) {
      if (j && j < per) {
        if (!kLong && ++p == n_win) {
          ++r;
          p = 0;
          cut();
        } else {
          if (kLong) ++p;
          roll_window(w, static_cast<uint32_t>(next & 3u), true, k);
          next >>= 2;
        }
      }
      const bool ok = j < per && p + k <= len;
      const unsigned m = __ballot_sync(0xFFFFFFFFu, ok);
      if (ok) {
        const int s = cnt + __popc(m & lt);
        wkeys[s] = canonical_of(w);
        if (!kLong) wrows[s] = static_cast<uint8_t>(r);
      }
      cnt += __popc(m);
    }
    __syncwarp();

    for (int base = 0; base < cnt; base += 32 * kBatch) {
      ProbeRows a[kBatch];
      uint4 r1[kBatch], r2[kBatch];
      bool own0[kBatch], own1[kBatch];
#pragma unroll
      for (int j = 0; j < kBatch; ++j) {
        const int s = base + 32 * j + lane;
        own0[j] = own1[j] = false;
        if (s < cnt) {
          a[j] = probe_rows(t, wkeys[s]);
          // a bucket below row_lo wraps past n_rows: one compare a bucket
          own0[j] = a[j].b[0] - row_lo < n_rows;
          own1[j] = second && a[j].b[1] - row_lo < n_rows;
          r1[j] = own0[j] ? __ldg(t.rows + (a[j].b[0] - row_lo)) : none;
          r2[j] = own1[j] ? __ldg(t.rows + (a[j].b[1] - row_lo)) : none;
        }
      }
#pragma unroll
      for (int j = 0; j < kBatch; ++j) {
        const int s = base + 32 * j + lane;
        if (s < cnt && (own0[j] || own1[j])) {
          const int pay = probe_hit(t, a[j], r1[j], r2[j], own0[j], own1[j]);
          if (pay) {
            const unsigned long long v =
                (pay & 1) | static_cast<unsigned long long>(pay >> 1) << 32;
            if (kLong)
              mine += v;
            else
              atomicAdd(&sm.cnt[wrows[s]], v);
          }
        }
      }
    }
    __syncwarp();   // the warp's slots (and a warp's codes) are refilled
  }

  if (kLong) {
    // the group's sums into sm.cnt[slot]: a warp sum, one atomic a warp
    const uint32_t v0 = __reduce_add_sync(0xFFFFFFFFu,
                                          static_cast<uint32_t>(mine));
    const uint32_t v1 = __reduce_add_sync(0xFFFFFFFFu,
                                          static_cast<uint32_t>(mine >> 32));
    if (lane == 0 && (v0 | v1))
      atomicAdd(&sm.cnt[slot], v0 | static_cast<unsigned long long>(v1) << 32);
  }
}

// Vote a block's rows into sm.cnt (sm.len and sm.cnt set, a barrier
// passed; the caller passes a barrier after it).  The short form votes
// its tile of rows; the long form's warp w votes read w where it holds at
// most kWarpTile windows, and the block then walks each longer read in
// turn (a uniform branch: sm.len is not written here).
template <bool kAscii, bool kLong>
__device__ __forceinline__ void vote_rows(const Table& t, uint32_t row_lo,
                                          uint32_t n_rows, const uint8_t* src,
                                          int stride, int n_win, int rows,
                                          Smem<kLong>& sm) {
  int it = 0;
  if constexpr (!kLong) {
    vote_tile<kAscii, false>(t, row_lo, n_rows, src, stride, n_win, rows, 0,
                             it, sm);
  } else {
    auto walks = [&](int i) { return min(n_win, sm.len[i] - t.k + 1); };
    const int warp = threadIdx.x >> 5;
    int one = 0;   // a warp's read is one tile in its own buffer
    if (warp < rows && walks(warp) <= kWarpTile)
      vote_tile<kAscii, true, 32>(t, row_lo, n_rows, src + warp * stride,
                                  stride, n_win, 1, warp, one, sm);
    for (int i = 0; i < rows; ++i)
      if (walks(i) > kWarpTile)
        vote_tile<kAscii, true>(t, row_lo, n_rows,
                                src + static_cast<int64_t>(i) * stride,
                                stride, n_win, 1, i, it, sm);
  }
}

}  // namespace reads
}  // namespace hast

// K10 `grow_tally` and K11 `pack_tally`: the stage-01 device tally's
// growth and its narrow image for the copy to the host; K15
// `tally_votes`: per-read votes scatter-added into a barcode tally.
//
// K10 replaces hast_tpu/pipeline/classify.py `_grow_acc` (the (cap, 3)
// int32 tally concatenated with zero rows): dst holds src's elements and
// zeros after them.  The JAX driver doubles the tally once per loop step;
// the wrapper computes the final size first, so one launch does all the
// doublings a batch needs.  Its rows are 3 x 2^a int32, so both ends are
// whole 16-byte words from 4 rows on: one wave of threads (at most the
// blocks the SMs hold at once) copies src and zeroes the rest as int4; a
// 1- or 2-row tally, or one not 16-byte aligned, takes the int32 loop.
//
// K11 replaces `_pack_acc` (the uint8 and uint16 low-byte images of the
// tally and the number of entries that do not fit each) behind
// `_fetch_acc*`: the host reads the two counts and copies the narrowest
// image that is exact, a quarter of the int32 bytes when every count is
// below 256.  An entry fits 8 bits iff (v >> 8) == 0 and 16 bits iff
// (v >> 16) == 0 (arithmetic shifts, as the JAX test on int32).
//
// What bounds both on an H100: bytes (K10 reads the old tally and writes
// the new one; K11 reads 4 bytes an entry and writes 3), with one or two
// integer operations an element.  Both are grid-stride loops with
// neighbouring threads on neighbouring addresses (K10 a 16-byte word a
// thread a step, K11 one element); K11 counts the entries that do not
// fit with a warp shuffle sum and one 64-bit atomic per warp and count,
// so the counts are exact.
//
// K15 replaces the tally of hast_tpu/parallel/mesh.py
// `sharded_classify_step` (mesh.py:140-146): votes of N-containing reads
// become (0, 0), unknown = has_n | (v0 == 0 & v1 == 0), and
// `jax.ops.segment_sum` of (v0, v1, unknown) by barcode id, which drops
// ids outside [0, num_barcodes), negative ones included; it adds into a
// tally the caller gives, so one zeroed tally serves every dp row on a
// device.  What bounds it: on the device, the 13 bytes a read (votes,
// flag, id) and the tally's rows, far below a launch; the call is the
// host's.  One thread a read loads its two votes as one 8-byte word; the
// warp's reads of one barcode find each other with __match_any_sync (ids
// outside the tally are dropped first and join no group), sum their
// (v0, v1, unknown) with __reduce_add_sync, and the lowest lane adds each
// non-zero sum with one int32 atomic (the JAX tally is int32, so the sums
// are exact in any order).  stLFR fastqs hold a barcode's reads in a row,
// so a warp of sorted ids makes about one atomic per barcode and column
// instead of one per read.  A warp in which no read shares its barcode
// with its neighbour (random ids) skips the match after one shuffle and
// one vote: there the match and the sums cost more than they save (0.0081
// against 0.0029 ms on the device for 65,536 random ids, H100).
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr int64_t kMaxBlocks = 132 * 16;

int blocks_for(int64_t n) {
  const int64_t want = (n + kThreads - 1) / kThreads;
  return static_cast<int>(want < 1 ? 1 : (want < kMaxBlocks ? want
                                                            : kMaxBlocks));
}

// kVec: n_src and n_dst count int4 words (both ends whole words)
template <bool kVec>
__global__ void grow_tally_kernel(const int32_t* __restrict__ src,
                                  int64_t n_src, int32_t* __restrict__ dst,
                                  int64_t n_dst) {
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  const int64_t i0 = static_cast<int64_t>(blockIdx.x) * blockDim.x +
                     threadIdx.x;
  if constexpr (kVec) {
    const int4* s4 = reinterpret_cast<const int4*>(src);
    int4* d4 = reinterpret_cast<int4*>(dst);
    for (int64_t i = i0; i < n_src; i += stride) d4[i] = __ldg(s4 + i);
    for (int64_t i = n_src + i0; i < n_dst; i += stride)
      d4[i] = make_int4(0, 0, 0, 0);
  } else {
    for (int64_t i = i0; i < n_dst; i += stride)
      dst[i] = i < n_src ? src[i] : 0;
  }
}

__global__ void pack_tally_kernel(const int32_t* __restrict__ acc, int64_t n,
                                  uint8_t* __restrict__ lo8,
                                  uint16_t* __restrict__ lo16,
                                  unsigned long long* __restrict__ over) {
  long long over8 = 0, over16 = 0;
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  for (int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x +
                   threadIdx.x;
       i < n; i += stride) {
    const int32_t v = acc[i];
    lo8[i] = static_cast<uint8_t>(v & 0xFF);
    lo16[i] = static_cast<uint16_t>(v & 0xFFFF);
    over8 += (v >> 8) != 0;
    over16 += (v >> 16) != 0;
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    over8 += __shfl_xor_sync(0xFFFFFFFFu, over8, off);
    over16 += __shfl_xor_sync(0xFFFFFFFFu, over16, off);
  }
  if ((threadIdx.x & 31) == 0) {
    if (over8) atomicAdd(over, static_cast<unsigned long long>(over8));
    if (over16) atomicAdd(over + 1, static_cast<unsigned long long>(over16));
  }
}

__global__ void tally_votes_kernel(const int2* __restrict__ votes,
                                   const uint8_t* __restrict__ has_n,
                                   const int32_t* __restrict__ ids, int64_t n,
                                   int32_t* __restrict__ tally,
                                   int64_t n_ids) {
  const int lane = threadIdx.x & 31;
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  // the whole warp steps together: the match and the sums take all lanes
  for (int64_t first = static_cast<int64_t>(blockIdx.x) * blockDim.x +
                       (threadIdx.x & ~31);
       first < n; first += stride) {
    const int64_t i = first + lane;
    const int32_t id = i < n ? ids[i] : -1;
    const bool keep = id >= 0 && id < n_ids;
    int v0 = 0, v1 = 0, unk = 0;
    if (keep) {
      const bool is_n = has_n[i] != 0;
      const int2 v = votes[i];
      v0 = is_n ? 0 : v.x;
      v1 = is_n ? 0 : v.y;
      unk = is_n || (v0 == 0 && v1 == 0);
    }
    int32_t* a = tally + static_cast<int64_t>(keep ? id : 0) * 3;
    // a warp with no two neighbouring reads of one barcode (random ids)
    // skips the match: one read, one group
    const int prev = __shfl_up_sync(0xFFFFFFFFu, keep ? id : -1, 1);
    if (!__any_sync(0xFFFFFFFFu, keep && lane > 0 && prev == id)) {
      if (keep) {
        if (v0) atomicAdd(a, v0);
        if (v1) atomicAdd(a + 1, v1);
        if (unk) atomicAdd(a + 2, unk);
      }
      continue;
    }
    // dropped lanes all carry -1, a group of their own that adds nothing
    const unsigned peers = __match_any_sync(0xFFFFFFFFu, keep ? id : -1);
    const int s0 = __reduce_add_sync(peers, v0);
    const int s1 = __reduce_add_sync(peers, v1);
    const int su = __reduce_add_sync(peers, unk);
    if (keep && lane == __ffs(peers) - 1) {
      if (s0) atomicAdd(a, s0);
      if (s1) atomicAdd(a + 1, s1);
      if (su) atomicAdd(a + 2, su);
    }
  }
}

}  // namespace

// src (n_src,) int32 -> dst (n_dst,) int32, n_dst >= n_src: src, then 0.
extern "C" int hast_grow_tally(const void* src, int64_t n_src, void* dst,
                               int64_t n_dst, void* stream) {
  // the blocks of one wave: the SMs' count times the blocks an SM holds
  static const int wave = [] {
    int dev = 0, sms = 0, per_sm = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, grow_tally_kernel<true>, kThreads, 0);
    return sms * per_sm > 0 ? sms * per_sm : 1;
  }();
  const auto st = static_cast<cudaStream_t>(stream);
  const auto* s = static_cast<const int32_t*>(src);
  auto* d = static_cast<int32_t*>(dst);
  const bool vec = n_src % 4 == 0 && n_dst % 4 == 0 &&
                   reinterpret_cast<uintptr_t>(src) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(dst) % 16 == 0;
  const int64_t n = vec ? n_dst / 4 : n_dst;
  const int64_t want = (n + kThreads - 1) / kThreads;
  const int blocks = static_cast<int>(want < 1 ? 1 : (want < wave ? want
                                                                  : wave));
  if (vec) {
    grow_tally_kernel<true><<<blocks, kThreads, 0, st>>>(s, n_src / 4, d,
                                                         n_dst / 4);
  } else {
    grow_tally_kernel<false><<<blocks, kThreads, 0, st>>>(s, n_src, d,
                                                          n_dst);
  }
  return static_cast<int>(cudaGetLastError());
}

// acc (n,) int32 -> lo8 (n,) uint8, lo16 (n,) uint16, and over (2,) int64
// (zeroed by the caller, added to): the entries with v >> 8 != 0 and with
// v >> 16 != 0.
extern "C" int hast_pack_tally(const void* acc, int64_t n, void* lo8,
                               void* lo16, void* over, void* stream) {
  pack_tally_kernel<<<blocks_for(n), kThreads, 0,
                      static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(acc), n, static_cast<uint8_t*>(lo8),
      static_cast<uint16_t*>(lo16),
      static_cast<unsigned long long*>(over));
  return static_cast<int>(cudaGetLastError());
}

// votes (n, 2) int32, has_n (n,) uint8, ids (n,) int32 -> added into
// tally (n_ids, 3) int32.
extern "C" int hast_tally_votes(const void* votes, const void* has_n,
                                const void* ids, int64_t n, void* tally,
                                int64_t n_ids, void* stream) {
  tally_votes_kernel<<<blocks_for(n), kThreads, 0,
                       static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int2*>(votes), static_cast<const uint8_t*>(has_n),
      static_cast<const int32_t*>(ids), n, static_cast<int32_t*>(tally),
      n_ids);
  return static_cast<int>(cudaGetLastError());
}

// K10 `grow_tally` and K11 `pack_tally`: the stage-01 device tally's
// growth and its narrow image for the copy to the host; K15
// `tally_votes`: per-read votes scatter-added into a barcode tally.
//
// K10 replaces hast_tpu/pipeline/classify.py `_grow_acc` (the (cap, 3)
// int32 tally concatenated with zero rows): dst holds src's elements and
// zeros after them.  The JAX driver doubles the tally once per loop step;
// the wrapper computes the final size first, so one launch does all the
// doublings a batch needs.
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
// integer operations an element.  Both are grid-stride loops, one element
// a thread a step with neighbouring threads on neighbouring addresses; K11
// counts the entries that do not fit with a warp shuffle sum and one
// 64-bit atomic per warp and count, so the counts are exact.
//
// K15 replaces the tally of hast_tpu/parallel/mesh.py
// `sharded_classify_step` (mesh.py:140-146): votes of N-containing reads
// become (0, 0), unknown = has_n | (v0 == 0 & v1 == 0), and
// `jax.ops.segment_sum` of (v0, v1, unknown) by barcode id, which drops
// ids outside [0, num_barcodes), negative ones included.  What bounds
// it: the 13 bytes a read (votes, flag, id) and the tally's rows; one
// thread a read, int32 atomics into its row (the JAX tally is int32), so
// the sums are exact in any order.
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

__global__ void grow_tally_kernel(const int32_t* __restrict__ src,
                                  int64_t n_src, int32_t* __restrict__ dst,
                                  int64_t n_dst) {
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  for (int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x +
                   threadIdx.x;
       i < n_dst; i += stride)
    dst[i] = i < n_src ? src[i] : 0;
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

__global__ void tally_votes_kernel(const int32_t* __restrict__ votes,
                                   const uint8_t* __restrict__ has_n,
                                   const int32_t* __restrict__ ids, int64_t n,
                                   int32_t* __restrict__ tally,
                                   int64_t n_ids) {
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  for (int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x +
                   threadIdx.x;
       i < n; i += stride) {
    const int64_t id = ids[i];
    if (id < 0 || id >= n_ids) continue;
    const bool is_n = has_n[i] != 0;
    const int32_t v0 = is_n ? 0 : votes[2 * i];
    const int32_t v1 = is_n ? 0 : votes[2 * i + 1];
    int32_t* a = tally + id * 3;
    if (v0) atomicAdd(a, v0);
    if (v1) atomicAdd(a + 1, v1);
    if (is_n || (v0 == 0 && v1 == 0)) atomicAdd(a + 2, 1);
  }
}

}  // namespace

// src (n_src,) int32 -> dst (n_dst,) int32, n_dst >= n_src: src, then 0.
extern "C" int hast_grow_tally(const void* src, int64_t n_src, void* dst,
                               int64_t n_dst, void* stream) {
  grow_tally_kernel<<<blocks_for(n_dst), kThreads, 0,
                      static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(src), n_src, static_cast<int32_t*>(dst),
      n_dst);
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
      static_cast<const int32_t*>(votes), static_cast<const uint8_t*>(has_n),
      static_cast<const int32_t*>(ids), n, static_cast<int32_t*>(tally),
      n_ids);
  return static_cast<int>(cudaGetLastError());
}

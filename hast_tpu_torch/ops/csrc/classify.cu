// K3 `classify_tally`: per-read votes scatter-added into the barcode tally.
//
// Replaces hast_tpu/pipeline/classify.py `tally_step`, the only device
// launch of the classify main path.  Per read: the votes v0 and v1 of its
// canonical windows in the marker table (reads.cuh, shared with K13), the
// N-read short-circuit to (0, 0, 1), then int32 atomics of (v0, v1,
// unknown = has_n || no vote) into acc[id]; ids outside [0, cap) are
// dropped.  A read with an N or a dropped id is never probed.  Reads
// shorter than k and batches whose stride holds fewer than k bases vote
// (0, 0, 1).
//
// What bounds it on an H100: the probe's arithmetic and its two random
// 16-byte row reads a window (reads.cuh); the packed read is 28 bytes.  A
// block votes a tile of whole reads through reads.cuh's routine (rolled
// windows from the staged packed rows, compacted keys, two keys a lane in
// flight), then one thread a read forms (v0, v1, unknown), and each warp
// sums the reads of equal id (__match_any_sync; stLFR batches come in
// barcode order, so a warp's reads share a few ids) so that one lane adds
// each distinct id's three sums into acc.  A warp whose neighbouring
// reads all differ in id skips the match, which cost about a tenth of
// the kernel's time on random ids.  Rows past a tile's windows take the
// long form: a block takes eight reads, a warp each for the short ones and
// the whole block for each longer one in turn (reads.cuh).
#include <cuda_runtime.h>

#include <cstdint>

#include "reads.cuh"

namespace {

using hast::reads::kBlocksPerSm;
using hast::reads::kLongBlocksPerSm;
using hast::reads::kThreads;

template <bool kLong>
__global__ void __launch_bounds__(kThreads,
                                  kLong ? kLongBlocksPerSm : kBlocksPerSm)
classify_tally_kernel(hast::Table table, const uint8_t* __restrict__ packed,
                      const int32_t* __restrict__ lengths,
                      const int32_t* __restrict__ ids,
                      const uint8_t* __restrict__ has_n, int64_t n, int lp,
                      int tile_rows, int32_t* __restrict__ acc, int64_t cap) {
  __shared__ hast::reads::Smem<kLong> sm;
  const int n_win = 4 * lp - table.k + 1;
  const int64_t row0 = static_cast<int64_t>(blockIdx.x) * tile_rows;
  const int rows = static_cast<int>(n - row0 < tile_rows ? n - row0
                                                         : tile_rows);
  // a read is voted by its length unless it has an N or a dropped id
  for (int i = threadIdx.x; i < rows; i += kThreads) {
    const int64_t r = row0 + i;
    const int32_t id = ids[r];
    sm.len[i] = !has_n[r] && id >= 0 && id < cap ? lengths[r] : 0;
    sm.cnt[i] = 0;
  }
  __syncthreads();
  hast::reads::vote_rows<false, kLong>(table, 0u, table.n_buckets,
                                       packed + row0 * lp, lp, n_win, rows,
                                       sm);
  __syncthreads();

  // one thread a read; whole warps, so that each can match ids
  const int i = threadIdx.x;
  if (i >= ((rows + 31) & ~31)) return;
  const bool in = i < rows;
  const int32_t id = in ? ids[row0 + i] : -1;
  const bool keep = in && id >= 0 && id < cap;
  const unsigned long long v = keep ? sm.cnt[i] : 0ull;
  const uint32_t v0 = static_cast<uint32_t>(v);
  const uint32_t v1 = static_cast<uint32_t>(v >> 32);
  const uint32_t unk = keep && (has_n[row0 + i] || (v0 == 0 && v1 == 0));
  int32_t* a = acc + static_cast<int64_t>(keep ? id : 0) * 3;
  // a warp with no two neighbouring reads of one id (random ids) skips
  // the match, as K15 does: one read, one group
  const int lane = threadIdx.x & 31;
  const int prev = __shfl_up_sync(0xFFFFFFFFu, keep ? id : -1, 1);
  if (!__any_sync(0xFFFFFFFFu, keep && lane > 0 && prev == id)) {
    if (keep) {
      if (v0) atomicAdd(a, static_cast<int32_t>(v0));
      if (v1) atomicAdd(a + 1, static_cast<int32_t>(v1));
      if (unk) atomicAdd(a + 2, 1);
    }
    return;
  }
  // dropped lanes all carry -1, a group of their own that adds nothing
  const unsigned same = __match_any_sync(0xFFFFFFFFu, keep ? id : -1);
  const uint32_t s0 = __reduce_add_sync(same, v0);
  const uint32_t s1 = __reduce_add_sync(same, v1);
  const uint32_t s2 = __reduce_add_sync(same, unk);
  if (keep && lane == __ffs(same) - 1) {
    if (s0) atomicAdd(a, static_cast<int32_t>(s0));
    if (s1) atomicAdd(a + 1, static_cast<int32_t>(s1));
    if (s2) atomicAdd(a + 2, static_cast<int32_t>(s2));
  }
}

}  // namespace

// acc (cap, 3) int32 updated in place; packed (n, lp) uint8; lengths and
// ids (n,) int32; has_n (n,) uint8.  One launch: the short form where a
// tile holds a whole row's windows, else the long form, eight reads a
// block.
extern "C" int hast_classify_tally(const void* table, int64_t n_buckets,
                                   int bbits, int fmt, int k, int max_probe,
                                   const void* packed, const void* lengths,
                                   const void* ids, const void* has_n,
                                   int64_t n, int lp, void* acc, int64_t cap,
                                   void* stream) {
  const hast::Table t{static_cast<const uint4*>(table),
                      static_cast<uint32_t>(n_buckets), bbits, fmt, k,
                      max_probe};
  const auto s = static_cast<cudaStream_t>(stream);
  const auto* pk = static_cast<const uint8_t*>(packed);
  const auto* len = static_cast<const int32_t*>(lengths);
  const auto* id = static_cast<const int32_t*>(ids);
  const auto* hn = static_cast<const uint8_t*>(has_n);
  auto* out = static_cast<int32_t*>(acc);
  const int n_win = 4 * lp - k + 1;
  if (n_win > hast::reads::kTile) {
    constexpr int rows = hast::reads::kWarps;
    classify_tally_kernel<true>
        <<<static_cast<unsigned>((n + rows - 1) / rows), kThreads, 0, s>>>(
            t, pk, len, id, hn, n, lp, rows, out, cap);
  } else {
    const int rows = hast::reads::tile_rows(n_win);
    classify_tally_kernel<false>
        <<<static_cast<unsigned>((n + rows - 1) / rows), kThreads, 0, s>>>(
            t, pk, len, id, hn, n, lp, rows, out, cap);
  }
  return static_cast<int>(cudaGetLastError());
}

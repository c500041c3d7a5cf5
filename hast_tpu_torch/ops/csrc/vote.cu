// K13 `vote_reads`: each read's (v0, v1) marker votes, with no tally.
//
// Replaces hast_tpu/pipeline/classify.py `vote_kernel_packed` (packed
// form: 4 bases a byte, base i at bits 2*(i & 3) of byte i >> 2; votes
// stored as uint16), `vote_kernel` and `vote_kernel_multi` (ASCII form:
// one byte a base, coded (b >> 1) & 3 whatever the byte is; votes int32),
// and the per-shard probe of hast_tpu/parallel/mesh.py `sharded_vote_step`
// and `sharded_classify_step` (`_probe_local`): the table may be the
// slice of rows [row_lo, row_lo + n_rows) that one tp shard holds, and a
// window then counts only the hits in the buckets that slice owns.  In
// both forms a window p is valid iff p + k <= length and it lies inside
// the row's stride: no byte is bad.  v0 counts the valid windows whose
// payload has bit 0, v1 those with bit 1.
//
// What bounds it on an H100: as K3, the probe's arithmetic and its two
// random 16-byte row reads a window; the read is 28 packed or 100 ASCII
// bytes.  K3's design, through the same routine (reads.cuh): a block
// votes a tile of whole reads (rolled windows from the staged rows, ASCII
// rows packed into codes as they are staged; compacted keys, two a lane
// in flight; a bucket another shard owns is not loaded), then one thread
// a read stores its two votes, coalesced.  Rows past a tile's windows
// take the long form: a block takes eight reads, a warp each for the
// short ones and the whole block for each longer one in turn.
#include <cuda_runtime.h>

#include <cstdint>

#include "reads.cuh"

namespace {

using hast::reads::kBlocksPerSm;
using hast::reads::kLongBlocksPerSm;
using hast::reads::kThreads;

template <bool kAscii, bool kLong, typename Vote>
__global__ void __launch_bounds__(kThreads,
                                  kLong ? kLongBlocksPerSm : kBlocksPerSm)
vote_reads_kernel(hast::Table table, uint32_t row_lo, uint32_t n_rows,
                  const uint8_t* __restrict__ reads,
                  const int32_t* __restrict__ lengths, int64_t n, int stride,
                  int tile_rows, Vote* __restrict__ votes) {
  __shared__ hast::reads::Smem<kLong> sm;
  const int n_win = (kAscii ? stride : 4 * stride) - table.k + 1;
  const int64_t row0 = static_cast<int64_t>(blockIdx.x) * tile_rows;
  const int rows = static_cast<int>(n - row0 < tile_rows ? n - row0
                                                         : tile_rows);
  for (int i = threadIdx.x; i < rows; i += kThreads) {
    sm.len[i] = lengths[row0 + i];
    sm.cnt[i] = 0;
  }
  __syncthreads();
  hast::reads::vote_rows<kAscii, kLong>(table, row_lo, n_rows,
                                        reads + row0 * stride, stride, n_win,
                                        rows, sm);
  __syncthreads();
  for (int i = threadIdx.x; i < rows; i += kThreads) {
    const unsigned long long v = sm.cnt[i];
    if constexpr (sizeof(Vote) == 2)   // both uint16 votes in one word
      reinterpret_cast<uint32_t*>(votes)[row0 + i] =
          static_cast<uint32_t>(v & 0xFFFFu) |
          static_cast<uint32_t>(v >> 32) << 16;
    else
      reinterpret_cast<int2*>(votes)[row0 + i] =
          make_int2(static_cast<int>(v), static_cast<int>(v >> 32));
  }
}

template <bool kAscii, typename Vote>
cudaError_t launch(const hast::Table& t, uint32_t row_lo, uint32_t n_rows,
                   const uint8_t* reads, const int32_t* lengths, int64_t n,
                   int stride, Vote* votes, cudaStream_t s) {
  const int n_win = (kAscii ? stride : 4 * stride) - t.k + 1;
  if (n_win > hast::reads::kTile) {
    constexpr int rows = hast::reads::kWarps;
    vote_reads_kernel<kAscii, true, Vote>
        <<<static_cast<unsigned>((n + rows - 1) / rows), kThreads, 0, s>>>(
            t, row_lo, n_rows, reads, lengths, n, stride, rows, votes);
  } else {
    const int rows = hast::reads::tile_rows(n_win);
    vote_reads_kernel<kAscii, false, Vote>
        <<<static_cast<unsigned>((n + rows - 1) / rows), kThreads, 0, s>>>(
            t, row_lo, n_rows, reads, lengths, n, stride, rows, votes);
  }
  return cudaGetLastError();
}

}  // namespace

// The table's rows [row_lo, row_lo + n_rows) at `table`; reads (n, stride)
// uint8, packed (ascii = 0, 4 bases a byte) or ASCII (ascii = 1); lengths
// (n,) int32 -> votes (n, 2), uint16 for packed reads, int32 for ASCII.
// One launch: the short form where a tile holds a whole row's windows,
// else the long form, eight reads a block.
extern "C" int hast_vote_reads(const void* table, int64_t n_buckets,
                               int bbits, int fmt, int k, int max_probe,
                               int64_t row_lo, int64_t n_rows,
                               const void* reads, const void* lengths,
                               int64_t n, int stride, int ascii, void* votes,
                               void* stream) {
  const hast::Table t{static_cast<const uint4*>(table),
                      static_cast<uint32_t>(n_buckets), bbits, fmt, k,
                      max_probe};
  const auto s = static_cast<cudaStream_t>(stream);
  const auto* r = static_cast<const uint8_t*>(reads);
  const auto* len = static_cast<const int32_t*>(lengths);
  const auto lo = static_cast<uint32_t>(row_lo);
  const auto rows = static_cast<uint32_t>(n_rows);
  const cudaError_t e =
      ascii ? launch<true>(t, lo, rows, r, len, n, stride,
                           static_cast<int32_t*>(votes), s)
            : launch<false>(t, lo, rows, r, len, n, stride,
                            static_cast<uint16_t*>(votes), s);
  return static_cast<int>(e);
}

// The read tiles' geometry (reads.cuh), for the edge batches of
// utils/synthetic.py: windows a tile, rows a tile, the most windows a
// long-form warp votes alone, and reads a long-form block takes.
extern "C" int hast_read_tile_geometry(int* out) {
  out[0] = hast::reads::kTile;
  out[1] = hast::reads::kMaxRows;
  out[2] = hast::reads::kWarpTile;
  out[3] = hast::reads::kWarps;
  return 0;
}

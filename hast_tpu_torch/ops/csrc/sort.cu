// K5 `sort_pairs`: stable LSD radix sort of int64 keys carrying an int32
// payload (or none), one sweep a digit.
//
// Replaces the `lax.sort` of hast_tpu/ops/kmer_count.py
// `_merge_rle_kernel` (keys with their counts, before the fold) and of
// `chunk_sorted_kmers`.  Only the low `bits` bits are sorted, 8 a pass:
// callers pass 2k + 1, since every real key is below 2^(2k) and the
// sentinel INT64_MAX has all of those bits set, so the sentinel still
// sorts last and the result equals a full stable sort of the int64 keys
// (ceil((2k+1)/8) passes: 4 at k = 15, 6 at k = 21, 8 at k = 31).
// Passes alternate between buffers a and b, and the result lies in a
// after an odd number of passes, in b after an even one.  Pass 0 reads
// the input and writes a, so b may be the input itself: the fold then
// sorts in its concat and one more buffer pair.
//
// What bounds it on an H100: memory traffic.  A pass must read and write
// each key and payload once (24 bytes an element).  A histogram and a
// scan of their own each pass would read the keys twice more, and a
// scatter straight from the input order stores to up to 256 places a
// round, so that every 8-byte key and 4-byte payload store costs a whole
// 32-byte sector.  This design is the one-sweep sort of Adinets and
// Merrill ("Onesweep", 2022):
//   1. one histogram launch reads the keys once and counts every pass's
//      digits together (shared-memory bins, then global atomics), and a
//      one-block launch turns each pass's bins into exclusive digit
//      offsets;
//   2. one launch a pass: a block takes the next tile from a global
//      atomic counter (a tile waits only on tiles claimed before it, so
//      no wait can block a tile that is not yet running), loads 16 keys a
//      thread with coalesced loads, counts its digits and publishes the
//      256 counts at once as status words (2 flag bits, 30 count bits),
//      so that later tiles can look past it while it works; it then ranks
//      the digits stably in shared memory (within a warp, the lanes of a
//      digit found by an atomic OR of lane bits; per-warp digit counts; a
//      scan over the warps) and walks back over its predecessors' words,
//      adding aggregates until an inclusive prefix, to learn each digit's
//      global offset (decoupled look-back);
//   3. the block exchanges its keys, then its payloads, through shared
//      memory into digit order, so that consecutive threads store to
//      consecutive addresses inside each digit's run.
// The input is swept in portions of at most 2^28 elements, each with its
// own look-back, so that a prefix always fits the 30 count bits; the
// portions of a pass follow each other on the stream, and the last tile
// of each hands the next one its digits' first output slots.
#include <cuda_runtime.h>

#include <cstdint>

#include "scan.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kItems = 16;
constexpr int kWarpItems = 32 * kItems;
constexpr int kTile = kThreads * kItems;      // 4,096 keys
constexpr int kDigits = 256;
constexpr int64_t kMaxPortion = int64_t{1} << 28;
constexpr unsigned kFlagA = 1u << 30;         // aggregate of the tile alone
constexpr unsigned kFlagP = 2u << 30;         // inclusive prefix
constexpr unsigned kFlagMask = 3u << 30;
constexpr unsigned kCountMask = kFlagA - 1u;
constexpr int kHistBlocks = 132 * 4;

__device__ __forceinline__ unsigned digit_of(int64_t key, int shift) {
  return static_cast<unsigned>(
             static_cast<unsigned long long>(key) >> shift) & 0xFFu;
}

// Every pass's digit counts over keys [0, n), added into
// bins[pass * bins_stride + digit].
__global__ void onesweep_hist_kernel(const int64_t* __restrict__ keys,
                                     int64_t n, int passes,
                                     unsigned* __restrict__ bins,
                                     int64_t bins_stride) {
  __shared__ unsigned s_bins[8 * kDigits];
  for (int i = threadIdx.x; i < passes * kDigits; i += kThreads)
    s_bins[i] = 0;
  __syncthreads();
  const int64_t stride = static_cast<int64_t>(gridDim.x) * kThreads;
  for (int64_t i = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
       i < n; i += stride) {
    const int64_t key = keys[i];
    for (int p = 0; p < passes; ++p)
      atomicAdd(&s_bins[p * kDigits + digit_of(key, 8 * p)], 1u);
  }
  __syncthreads();
  for (int i = threadIdx.x; i < passes * kDigits; i += kThreads) {
    const unsigned c = s_bins[i];
    if (c) atomicAdd(&bins[(i / kDigits) * bins_stride + i % kDigits], c);
  }
}

// One block: each pass's digit counts (bins[pass * bins_stride + digit])
// -> its exclusive digit offsets, the first output slot of each digit in
// the pass's first portion.
__global__ void onesweep_offsets_kernel(unsigned* __restrict__ bins,
                                        int passes, int64_t bins_stride) {
  for (int p = 0; p < passes; ++p) {
    unsigned* b = bins + p * bins_stride + threadIdx.x;
    long long all;
    *b = static_cast<unsigned>(hast::block_exclusive_scan(*b, &all));
  }
}

__device__ __forceinline__ unsigned load_status(const unsigned* p) {
  return *reinterpret_cast<const volatile unsigned*>(p);
}

__device__ __forceinline__ void store_status(unsigned* p, unsigned v) {
  *reinterpret_cast<volatile unsigned*>(p) = v;
}

// One digit pass over one portion: keys_in[0, n) (and pay_in) scattered
// stably by digit into keys_out (pay_out); bins: the portion's first
// output slot of each digit; bins_next: null, or where the last tile
// writes the next portion's; status: n_tiles * 256 words, zero at launch;
// tile_counter: one word, zero at launch.  One block a tile.
__global__ void __launch_bounds__(kThreads, 3)
onesweep_pass_kernel(const int64_t* __restrict__ keys_in,
                     const int32_t* __restrict__ pay_in, int64_t n,
                     int shift, const unsigned* __restrict__ bins,
                     unsigned* __restrict__ bins_next,
                     unsigned* __restrict__ status,
                     unsigned* __restrict__ tile_counter,
                     int64_t* __restrict__ keys_out,
                     int32_t* __restrict__ pay_out) {
  // the per-warp digit counts and lane sets, then the keys, then the
  // payloads
  __shared__ __align__(16) unsigned char s_raw[kTile * sizeof(int64_t)];
  __shared__ long long s_off[kDigits];     // output slot - tile position
  __shared__ unsigned s_start[kDigits];    // tile position of each digit
  __shared__ unsigned s_count[kDigits];    // the tile's count of each digit
  __shared__ unsigned s_tile;
  unsigned(*s_hist)[kDigits] = reinterpret_cast<unsigned(*)[kDigits]>(s_raw);
  unsigned(*s_lanes)[kDigits] = s_hist + kWarps;
  int64_t* s_keys = reinterpret_cast<int64_t*>(s_raw);
  int32_t* s_pay = reinterpret_cast<int32_t*>(s_raw);

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const unsigned lanes_below = (1u << lane) - 1u;
  if (tid == 0) s_tile = atomicAdd(tile_counter, 1u);
  for (int w = 0; w < kWarps; ++w) {
    s_hist[w][tid] = 0;
    s_lanes[w][tid] = 0;
  }
  s_count[tid] = 0;
  __syncthreads();
  const int64_t tile = s_tile;
  const int64_t base = tile * kTile;
  const int valid = static_cast<int>(n - base < kTile ? n - base : kTile);

  // load: warp w holds [w * 512, (w + 1) * 512) of the tile, item i of
  // lane l at w * 512 + i * 32 + l, so (w, i, l) is the input order
  int64_t key[kItems];
  const int first = warp * kWarpItems + lane;
#pragma unroll
  for (int i = 0; i < kItems; ++i) {
    const int j = first + i * 32;
    key[i] = j < valid ? keys_in[base + j] : 0;
  }

  // the tile's digit counts, published before the ranking so that the
  // tiles after this one can look past it early
  const int d = tid;
#pragma unroll
  for (int i = 0; i < kItems; ++i)
    if (first + i * 32 < valid) atomicAdd(&s_count[digit_of(key[i], shift)],
                                          1u);
  __syncthreads();
  const unsigned count = s_count[d];
  unsigned* my_status = status + tile * kDigits + d;
  store_status(my_status, (tile == 0 ? kFlagP : kFlagA) | count);

  // rank: each item's place among the warp's earlier items of its digit
  // (the lanes holding a digit found by an atomic OR of lane bits), then
  // (pos) its place in the tile in digit order
  unsigned pos[kItems];
#pragma unroll
  for (int i = 0; i < kItems; ++i) {
    const bool ok = first + i * 32 < valid;
    const unsigned dd = ok ? digit_of(key[i], shift) : 0;
    if (ok) atomicOr(&s_lanes[warp][dd], 1u << lane);
    __syncwarp();
    unsigned peers = 0, before = 0;
    if (ok) {
      peers = s_lanes[warp][dd];
      before = s_hist[warp][dd];
    }
    __syncwarp();
    if (ok && (peers & lanes_below) == 0) {
      s_hist[warp][dd] = before + __popc(peers);
      s_lanes[warp][dd] = 0;
    }
    __syncwarp();
    pos[i] = before + __popc(peers & lanes_below);
  }
  __syncthreads();

  // thread d: the warps' counts of digit d -> exclusive prefixes over the
  // warps, and the digit's first tile position
  unsigned below_warp = 0;
#pragma unroll
  for (int w = 0; w < kWarps; ++w) {
    const unsigned c = s_hist[w][d];
    s_hist[w][d] = below_warp;
    below_warp += c;
  }
  long long tile_total;
  s_start[d] = static_cast<unsigned>(
      hast::block_exclusive_scan(count, &tile_total));
  __syncthreads();

#pragma unroll
  for (int i = 0; i < kItems; ++i) {
    if (first + i * 32 < valid) {
      const unsigned dd = digit_of(key[i], shift);
      pos[i] += s_start[dd] + s_hist[warp][dd];
    }
  }
  __syncthreads();   // s_hist is overwritten by the keys below
#pragma unroll
  for (int i = 0; i < kItems; ++i)
    if (first + i * 32 < valid) s_keys[pos[i]] = key[i];

  // decoupled look-back: the sum of digit d over the earlier tiles
  unsigned before_tiles = 0;
  if (tile > 0) {
    int64_t t = tile - 1;
    while (true) {
      unsigned v;
      do {
        v = load_status(status + t * kDigits + d);
      } while ((v & kFlagMask) == 0);
      before_tiles += v & kCountMask;
      if (v & kFlagP) break;
      --t;
    }
    store_status(my_status, kFlagP | (before_tiles + count));
  }
  if (bins_next != nullptr && tile == gridDim.x - 1)
    bins_next[d] = bins[d] + before_tiles + count;
  s_off[d] = static_cast<long long>(bins[d]) + before_tiles - s_start[d];
  __syncthreads();

  // store: tile position j goes to s_off[digit] + j, consecutive within
  // a digit's run (n < 2^31, so a slot fits 32 bits)
  unsigned dst[kItems];
#pragma unroll
  for (int r = 0; r < kItems; ++r) {
    const int j = r * kThreads + tid;
    if (j < valid) {
      const int64_t k = s_keys[j];
      dst[r] = static_cast<unsigned>(s_off[digit_of(k, shift)] + j);
      keys_out[dst[r]] = k;
    }
  }
  if (pay_in == nullptr) return;
  __syncthreads();   // the keys are read before the payloads replace them
#pragma unroll
  for (int i = 0; i < kItems; ++i) {
    const int j = first + i * 32;
    if (j < valid) s_pay[pos[i]] = pay_in[base + j];
  }
  __syncthreads();
#pragma unroll
  for (int r = 0; r < kItems; ++r) {
    const int j = r * kThreads + tid;
    if (j < valid) pay_out[dst[r]] = s_pay[j];
  }
}

struct Layout {
  int passes;
  int64_t portion;
  int64_t portions;
  int64_t status_words;   // one portion's tiles x 256
  int64_t bin_words;      // passes x portions x 256: each portion's slots
  int64_t counter_words;  // passes x portions
};

Layout layout_of(int64_t n, int bits, int64_t portion) {
  Layout l;
  l.passes = (bits + 7) / 8;
  l.portion = portion;
  l.portions = (n + portion - 1) / portion;
  const int64_t widest = n < portion ? n : portion;
  l.status_words = (widest + kTile - 1) / kTile * kDigits;
  l.bin_words = l.passes * l.portions * kDigits;
  l.counter_words = l.passes * l.portions;
  return l;
}

bool bad_args(int64_t n, int bits, int64_t portion) {
  return n < 0 || n >= (int64_t{1} << 31) || bits < 1 || bits > 64 ||
         portion < kTile || portion > kMaxPortion || portion % kTile != 0;
}

}  // namespace

// Bytes of scratch hast_sort_pairs needs for n keys, bits and portion (a
// multiple of the 4,096-key tile, at most 2^28); -1 for arguments it
// refuses.
extern "C" int64_t hast_sort_scratch_bytes(int64_t n, int bits,
                                           int64_t portion) {
  if (bad_args(n, bits, portion)) return -1;
  const Layout l = layout_of(n, bits, portion);
  return 4 * (l.status_words + l.bin_words + l.counter_words);
}

// keys (n,) int64 and pay (n,) int32 or null, unchanged unless b is
// them; a/b buffers of the same shapes; scratch of
// hast_sort_scratch_bytes(n, bits, portion) bytes.  0 < n < 2^31.
extern "C" int hast_sort_pairs(const void* keys, const void* pay,
                               void* keys_a, void* pay_a, void* keys_b,
                               void* pay_b, int64_t n, int bits,
                               int64_t portion, void* scratch,
                               void* stream) {
  if (bad_args(n, bits, portion) || n == 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const Layout l = layout_of(n, bits, portion);
  unsigned* status = static_cast<unsigned*>(scratch);
  unsigned* bins = status + l.status_words;
  unsigned* counters = bins + l.bin_words;
  cudaError_t e = cudaMemsetAsync(
      bins, 0, 4 * (l.bin_words + l.counter_words), s);
  if (e != cudaSuccess) return static_cast<int>(e);
  const int64_t* k_in = static_cast<const int64_t*>(keys);
  const int32_t* p_in = static_cast<const int32_t*>(pay);
  const int64_t bins_stride = l.portions * kDigits;
  const int64_t blocks = (n + kThreads - 1) / kThreads;
  onesweep_hist_kernel<<<static_cast<unsigned>(
                             blocks < kHistBlocks ? blocks : kHistBlocks),
                         kThreads, 0, s>>>(k_in, n, l.passes, bins,
                                           bins_stride);
  onesweep_offsets_kernel<<<1, kDigits, 0, s>>>(bins, l.passes, bins_stride);
  for (int pass = 0; pass < l.passes; ++pass) {
    int64_t* k_out = static_cast<int64_t*>(pass % 2 == 0 ? keys_a : keys_b);
    int32_t* p_out = pay == nullptr ? nullptr
                     : static_cast<int32_t*>(pass % 2 == 0 ? pay_a : pay_b);
    for (int64_t q = 0; q < l.portions; ++q) {
      const int64_t begin = q * portion;
      const int64_t len = n - begin < portion ? n - begin : portion;
      const int64_t tiles = (len + kTile - 1) / kTile;
      e = cudaMemsetAsync(status, 0, 4 * tiles * kDigits, s);
      if (e != cudaSuccess) return static_cast<int>(e);
      onesweep_pass_kernel<<<static_cast<unsigned>(tiles), kThreads, 0, s>>>(
          k_in + begin, p_in == nullptr ? nullptr : p_in + begin, len,
          8 * pass, bins + pass * bins_stride + q * kDigits,
          q + 1 < l.portions ? bins + pass * bins_stride + (q + 1) * kDigits
                             : nullptr,
          status, counters + pass * l.portions + q, k_out, p_out);
    }
    k_in = k_out;
    p_in = p_out;
  }
  return static_cast<int>(cudaGetLastError());
}

// K5 `sort_pairs`: stable LSD radix sort of int64 keys carrying an int32
// payload (or none), one sweep a digit of at most 8 bits.
//
// Replaces the `lax.sort` of hast_tpu/ops/kmer_count.py
// `_merge_rle_kernel` (keys with their counts, before the fold) and of
// `chunk_sorted_kmers`.  Only the low `bits` bits are sorted: callers
// pass 2k + 1, since every real key is below 2^(2k) and the sentinel
// INT64_MAX has all of those bits set, so the sentinel still sorts last
// and the result equals a full stable sort of the int64 keys.  The bits
// are split as evenly as ceil((2k+1)/8) passes allow (4 at k = 15, 6 at
// k = 21: 8, 7, 7, 7, 7, 7; 8 at k = 31).  A pass whose digit is the
// same in every key moves nothing, and is skipped (below).  The executed
// passes alternate between buffers a and b, the first reading the
// input, and the result lies in a after an odd number of passes, in b
// after an even one; b may be the input itself, so that the fold sorts
// in its concat and one more buffer pair.
//
// What bounds it on an H100: memory traffic.  A pass must read and write
// each key and payload once (24 bytes an element).  This is the
// one-sweep sort of Adinets and Merrill ("Onesweep", 2022):
//   1. one histogram launch reads the keys once, four loads in flight a
//      thread, and counts every pass's digits together (shared-memory
//      bins, then global atomics); a one-block launch turns each pass's
//      bins into exclusive digit offsets and plans the passes: a pass
//      whose digit is constant is skipped, unless the result must
//      change buffers once more (then it runs as a stable copy);
//   2. one launch a pass: a block takes the next tile of 4,096 keys
//      from a global atomic counter (a tile waits only on tiles claimed
//      before it), loads 16 keys a thread with coalesced loads and ranks
//      them stably in shared memory: a warp ranks its 512 keys, in input
//      order, against its own 16-bit digit counters (the lanes of a
//      digit found by __match_any_sync, their leader adding to the
//      counter), then a thread a 2-digit word sums the warps' counters
//      into prefixes and the block scans the digit counts;
//   3. the block publishes its digit counts as status words and walks
//      back over its predecessors' words, adding aggregates until an
//      inclusive prefix, to learn each digit's global offset (decoupled
//      look-back, a thread's two digits in one load), while its
//      payloads load;
//   4. the keys and payloads are exchanged through shared memory into
//      digit order, so that consecutive threads store to consecutive
//      addresses inside each digit's run.
// Where the payloads' bits fit above the keys' (16 bits or more left, k
// <= 23; the first pass ORs the payloads to find out), a pair moves as
// one 8-byte word from the second pass to the last: the second packs,
// the last unpacks (a key with bit 2k set is the sentinel), so the
// passes between move 16 bytes a pair instead of 24 and store one run a
// digit instead of two.  At k = 21 a fold's counts fit while every one
// is below 2^21; a single larger count moves the whole sort unpacked.
// Each way a pass moves its pairs is its own instance of the tile
// routine.  Three blocks an SM (49 KB of shared memory and at most 85
// registers a thread each).  Wider digits would cut passes (11 bits: 4
// at k = 21), but a digit's run in a tile is 4,096 / 2^bits keys long on
// uniform keys, and the passes slow down as the runs shorten: at 2^26
// pairs on an H100 a pass took 0.85 ms at 8 bits, 0.97 at 9, 1.36 at 10
// and 2.0 at 11 on 8,192-key tiles, 1.28 at 11 on 16,384-key tiles, so
// 8 bits stays.  Status words carry a 2-bit epoch (the executed pass and
// portion), so one zero fill a call serves every pass.  The input is
// swept in portions of at most 2^27 elements, each with its own
// look-back, so that a prefix fits the 28 count bits; the portions of a
// pass follow each other on the stream, and the last tile of each hands
// the next one its digits' first output slots.
#include <cuda_runtime.h>

#include <cstdint>

#include "scan.cuh"

namespace {

constexpr int kBits = 8;
constexpr int kDigits = 1 << kBits;
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kItems = 16;
constexpr int kWarpItems = 32 * kItems;
constexpr int kTile = kThreads * kItems;
constexpr int kWords = kDigits / 2;     // a warp's 16-bit counters, 2 a word
// digits a thread owns in the per-digit steps (one counter word), and
// the threads that own some
constexpr int kOwn = 2;
constexpr int kOwners = kDigits / kOwn;
constexpr int kMaxPasses = (64 + kBits - 1) / kBits;
constexpr int64_t kMaxPortion = int64_t{1} << 27;
// a status word: epoch (2 bits) | flag (2 bits) | count (28 bits)
constexpr unsigned kFlagA = 1u << 28;         // aggregate of the tile alone
constexpr unsigned kFlagP = 2u << 28;         // inclusive prefix
constexpr unsigned kFlagMask = 3u << 28;
constexpr unsigned kCountMask = kFlagA - 1u;
constexpr int kHistThreads = 512;
constexpr int kHistBlocks = 132 * 2;
constexpr int kPlanThreads = 1024;
constexpr int kBlocksPerSm = 3;
// shared memory of a pass block: the keys (first the warps' counters),
// the payloads, the digits' output offsets
constexpr int kKeyBytes = kTile * 8;
constexpr int kSmem = kKeyBytes + kTile * 4 + kDigits * 4;
static_assert(kWarps * kWords * 4 <= kKeyBytes && kTile <= 32768 &&
              kBlocksPerSm * (kSmem + 1024) <= 232448,
              "sort.cu: unsupported tile");

// The passes' digits: pass p sorts bits [shift[p], shift[p] + width),
// mask[p] = 2^width - 1.
struct Digits {
  int shift[kMaxPasses];
  unsigned mask[kMaxPasses];
};

__device__ __forceinline__ unsigned digit_of(int64_t key, int shift,
                                             unsigned mask) {
  return static_cast<unsigned>(
             static_cast<unsigned long long>(key) >> shift) & mask;
}

// A thread's two status words, read whole from the L2.
__device__ __forceinline__ void load_status(const unsigned* p,
                                            unsigned (&v)[2]) {
  asm volatile("ld.volatile.global.v2.u32 {%0, %1}, [%2];"
               : "=r"(v[0]), "=r"(v[1])
               : "l"(p));
}

__device__ __forceinline__ void store_status(unsigned* p,
                                             const unsigned (&v)[2]) {
  asm volatile("st.volatile.global.v2.u32 [%0], {%1, %2};"
               ::"l"(p), "r"(v[0]), "r"(v[1])
               : "memory");
}

// Every pass's digit counts over keys [0, n), added into
// bins[pass * bins_stride + digit].
__global__ void __launch_bounds__(kHistThreads)
onesweep_hist_kernel(const int64_t* __restrict__ keys, int64_t n,
                     int passes, Digits digits, unsigned* __restrict__ bins,
                     int64_t bins_stride) {
  __shared__ unsigned s_bins[kMaxPasses * kDigits];
  for (int i = threadIdx.x; i < passes * kDigits; i += kHistThreads)
    s_bins[i] = 0;
  __syncthreads();
  const int64_t stride = static_cast<int64_t>(gridDim.x) * kHistThreads;
  for (int64_t i = static_cast<int64_t>(blockIdx.x) * kHistThreads +
                   threadIdx.x;
       i < n; i += 4 * stride) {
    int64_t key[4];
#pragma unroll
    for (int u = 0; u < 4; ++u)
      if (i + u * stride < n) key[u] = keys[i + u * stride];
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      if (i + u * stride >= n) break;
      // unrolled, so that the digits stay in parameter registers
#pragma unroll
      for (int p = 0; p < kMaxPasses; ++p)
        if (p < passes)
          atomicAdd(&s_bins[p * kDigits + digit_of(key[u], digits.shift[p],
                                                   digits.mask[p])],
                    1u);
    }
  }
  __syncthreads();
  for (int i = threadIdx.x; i < passes * kDigits; i += kHistThreads) {
    const unsigned c = s_bins[i];
    if (c) atomicAdd(&bins[(i / kDigits) * bins_stride + i % kDigits], c);
  }
}

// One block: each pass's digit counts (bins[pass * bins_stride + digit],
// over all n keys) -> its exclusive digit offsets, the first output slot
// of each digit in the pass's first portion; then the plan: plan[pass] is
// the pass's rank among the passes that run, or -1.  A pass whose digit
// is constant moves nothing and is skipped, except that the passes that
// run must be as many as `passes` modulo 2 (the result's buffer), and at
// least 2 when none would run and the input is not buffer b;
// plan[kMaxPasses]: the passes that run.
__global__ void __launch_bounds__(kPlanThreads)
onesweep_plan_kernel(unsigned* __restrict__ bins, int passes,
                     int64_t bins_stride, int64_t n, int in_place,
                     int* __restrict__ plan) {
  constexpr int kPer = (kDigits + kPlanThreads - 1) / kPlanThreads;
  __shared__ int s_constant[kMaxPasses];
  for (int p = 0; p < passes; ++p) {
    unsigned* b = bins + p * bins_stride;
    unsigned c[kPer];
    long long sum = 0;
    bool constant = false;
#pragma unroll
    for (int r = 0; r < kPer; ++r) {
      const int d = threadIdx.x * kPer + r;
      c[r] = d < kDigits ? b[d] : 0;
      sum += c[r];
      constant |= c[r] == n;
    }
    long long all;
    long long run = hast::block_exclusive_scan(sum, &all);
#pragma unroll
    for (int r = 0; r < kPer; ++r) {
      const int d = threadIdx.x * kPer + r;
      if (d < kDigits) b[d] = static_cast<unsigned>(run);
      run += c[r];
    }
    constant = __syncthreads_or(constant);
    if (threadIdx.x == 0) s_constant[p] = constant;
  }
  __syncthreads();
  if (threadIdx.x != 0) return;
  int moving = 0;
  for (int p = 0; p < passes; ++p) moving += !s_constant[p];
  int copies = (passes - moving) & 1;
  if (moving + copies == 0 && !in_place) copies = 2;
  int rank = 0;
  for (int p = 0; p < passes; ++p) {
    bool run = !s_constant[p];
    if (!run && copies > 0) {
      run = true;
      --copies;
    }
    plan[p] = run ? rank++ : -1;
  }
  plan[kMaxPasses] = rank;
}

// How a pass moves its pairs: keys and payloads in and out (kSplit),
// packed into one word on the way out (kPack), packed both ways
// (kPacked), or unpacked on the way out (kUnpack).  A packed word holds
// the key's low `bits` bits and the payload above them.
enum Move { kSplit, kPack, kPacked, kUnpack };

// One tile of a pass (see onesweep_pass_kernel).  pay_or: null, or (the
// first pass) where the payloads' bits are ORed.
template <Move kMove>
__device__ __forceinline__ void sort_tile(
    const int64_t* k_in, const int32_t* p_in, int64_t* k_out,
    int32_t* p_out, int64_t n, int shift, unsigned mask, int bits,
    unsigned epoch, const unsigned* __restrict__ bins,
    unsigned* __restrict__ bins_next, unsigned* __restrict__ status,
    unsigned* __restrict__ tile_counter, unsigned* __restrict__ pay_or) {
  constexpr bool kPayIn = kMove == kSplit || kMove == kPack;
  extern __shared__ __align__(16) unsigned char s_raw[];
  unsigned* s_hist = reinterpret_cast<unsigned*>(s_raw);  // [warp][word]
  int64_t* s_keys = reinterpret_cast<int64_t*>(s_raw);
  int32_t* s_pay = reinterpret_cast<int32_t*>(s_raw + kKeyBytes);
  int* s_off = reinterpret_cast<int*>(s_raw + kKeyBytes + kTile * 4);
  __shared__ unsigned s_tile;
  const unsigned long long key_mask =
      bits >= 64 ? ~0ull : (1ull << bits) - 1ull;

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const unsigned lanes_below = (1u << lane) - 1u;
  // warp w holds [w * 32 * kItems, (w + 1) * 32 * kItems) of a tile, item
  // i of lane l at w * 32 * kItems + i * 32 + l, so (w, i, l) is the
  // input order
  const int first = warp * kWarpItems + lane;
  const bool owner = tid < kOwners;   // of digits [tid * kOwn, + kOwn)

  if (tid == 0) s_tile = atomicAdd(tile_counter, 1u);
  for (int i = tid; i < kWarps * kWords; i += kThreads) s_hist[i] = 0;
  __syncthreads();
  const int64_t tile = s_tile;
  const int64_t base = tile * kTile;
  const int valid = static_cast<int>(n - base < kTile ? n - base : kTile);
  int64_t key[kItems];
#pragma unroll
  for (int i = 0; i < kItems; ++i) {
    const int j = first + i * 32;
    key[i] = j < valid ? k_in[base + j] : 0;
  }

  // rank in the warp: each key's place among the warp's earlier keys
  // of its digit (16 bits, two a register)
  unsigned* w_hist = s_hist + warp * kWords;
  unsigned pos[kItems / 2];
#pragma unroll
  for (int i = 0; i < kItems; ++i) {
    const bool ok = first + i * 32 < valid;
    const unsigned d = ok ? digit_of(key[i], shift, mask) : kDigits;
    const unsigned peers = __match_any_sync(0xFFFFFFFFu, d);
    const int leader = __ffs(peers) - 1;
    unsigned before = 0;
    if (ok && lane == leader) {
      const unsigned half = (d & 1u) * 16;
      before =
          (atomicAdd(&w_hist[d >> 1], __popc(peers) << half) >> half) &
          0xFFFFu;
    }
    before = __shfl_sync(0xFFFFFFFFu, before, leader) +
             __popc(peers & lanes_below);
    if (i & 1) pos[i / 2] |= before << 16;
    else pos[i / 2] = before;
  }
  __syncthreads();

  // the owned digits: the warps' counters -> exclusive prefixes over
  // the warps, and the tile's count of each digit
  unsigned count[kOwn];
  long long own_sum = 0;
  if (owner) {
    unsigned run = 0;   // two 16-bit sums, each below 2^16
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      const unsigned c = s_hist[w * kWords + tid];
      s_hist[w * kWords + tid] = run;
      run += c;
    }
    count[0] = run & 0xFFFFu;
    count[1] = run >> 16;
    own_sum = count[0] + count[1];
  }
  long long tile_total;
  unsigned start = static_cast<unsigned>(
      hast::block_exclusive_scan(owner ? own_sum : 0, &tile_total));
  unsigned first_slot[kOwn];   // each owned digit's first tile position
  unsigned* my_status = status + tile * kDigits + tid * kOwn;
  if (owner) {
    unsigned word[kOwn];
#pragma unroll
    for (int r = 0; r < kOwn; ++r) {
      first_slot[r] = start;
      start += count[r];
      word[r] = epoch | (tile == 0 ? kFlagP : kFlagA) | count[r];
    }
    store_status(my_status, word);
    const unsigned add = first_slot[0] | first_slot[1] << 16;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) s_hist[w * kWords + tid] += add;
  }
  __syncthreads();

  // each key's place in the tile, in digit order
#pragma unroll
  for (int i = 0; i < kItems; ++i) {
    if (first + i * 32 < valid) {
      const unsigned d = digit_of(key[i], shift, mask);
      const unsigned add = (w_hist[d >> 1] >> ((d & 1u) * 16)) & 0xFFFFu;
      pos[i / 2] += add << ((i & 1) * 16);
    }
  }
  __syncthreads();   // the counters give way to the keys
#pragma unroll
  for (int i = 0; i < kItems; ++i) {
    if (first + i * 32 < valid) {
      const unsigned at = (pos[i / 2] >> ((i & 1) * 16)) & 0xFFFFu;
      s_keys[at] = key[i];
    }
  }
  int32_t val[kItems];
  if (kPayIn && p_in != nullptr) {
    unsigned bits_or = 0;
#pragma unroll
    for (int i = 0; i < kItems; ++i) {
      const int j = first + i * 32;
      val[i] = j < valid ? p_in[base + j] : 0;
      bits_or |= static_cast<unsigned>(val[i]);
    }
    if (pay_or != nullptr) {   // the first pass: may the payloads pack?
      bits_or = __reduce_or_sync(0xFFFFFFFFu, bits_or);
      if (lane == 0 && bits_or) atomicOr(pay_or, bits_or);
    }
  }

  // decoupled look-back: each owned digit's sum over the earlier tiles
  if (owner) {
    unsigned before[kOwn];
#pragma unroll
    for (int r = 0; r < kOwn; ++r) before[r] = 0;
    if (tile > 0) {
      unsigned open = (1u << kOwn) - 1u;   // digits without a prefix yet
      int64_t t = tile - 1;
      while (open) {
        unsigned v[kOwn];
        load_status(status + t * kDigits + tid * kOwn, v);
        bool ready = true;
#pragma unroll
        for (int r = 0; r < kOwn; ++r)
          if ((open >> r & 1u) &&
              ((v[r] & kFlagMask) == 0 || (v[r] & (3u << 30)) != epoch))
            ready = false;
        if (!ready) continue;
#pragma unroll
        for (int r = 0; r < kOwn; ++r) {
          if (open >> r & 1u) {
            before[r] += v[r] & kCountMask;
            if (v[r] & kFlagP) open &= ~(1u << r);
          }
        }
        --t;
      }
      unsigned word[kOwn];
#pragma unroll
      for (int r = 0; r < kOwn; ++r)
        word[r] = epoch | kFlagP | (before[r] + count[r]);
      store_status(my_status, word);
    }
    const unsigned* my_bins = bins + tid * kOwn;
    const bool last = bins_next != nullptr && tile == gridDim.x - 1;
#pragma unroll
    for (int r = 0; r < kOwn; ++r) {
      const unsigned slot = my_bins[r] + before[r];
      s_off[tid * kOwn + r] = static_cast<int>(slot) -
                              static_cast<int>(first_slot[r]);
      if (last) bins_next[tid * kOwn + r] = slot + count[r];
    }
  }
  if (kPayIn && p_in != nullptr) {
#pragma unroll
    for (int i = 0; i < kItems; ++i)
      if (first + i * 32 < valid)
        s_pay[(pos[i / 2] >> ((i & 1) * 16)) & 0xFFFFu] = val[i];
  }
  __syncthreads();

  // store: tile position j goes to s_off[digit] + j, consecutive within
  // a digit's run (n < 2^31, so a slot fits 32 bits)
#pragma unroll
  for (int r = 0; r < kItems; ++r) {
    const int j = r * kThreads + tid;
    if (j < valid) {
      const int64_t k = s_keys[j];
      const int dst = s_off[digit_of(k, shift, mask)] + j;
      if (kMove == kPack) {
        k_out[dst] = static_cast<int64_t>(
            (static_cast<unsigned long long>(k) & key_mask) |
            static_cast<unsigned long long>(
                static_cast<uint32_t>(s_pay[j])) << bits);
      } else if (kMove == kUnpack) {
        const unsigned long long low =
            static_cast<unsigned long long>(k) & key_mask;
        // every key is below 2^(bits - 1) but the sentinel
        k_out[dst] = low >> (bits - 1) ? INT64_MAX
                                       : static_cast<int64_t>(low);
        p_out[dst] = static_cast<int32_t>(
            static_cast<unsigned long long>(k) >> bits);
      } else {
        k_out[dst] = k;
        if (kMove == kSplit && p_out != nullptr) p_out[dst] = s_pay[j];
      }
    }
  }
}

// One digit pass over one portion, keys [begin, begin + n) of the pass's
// input scattered stably by digit into its output (payloads alike).  The
// pass's rank r = plan[pass] picks the buffers: the input (keys, pay)
// when r = 0, else the one rank r - 1 wrote; a when r is even, b when it
// is odd; r = -1 returns at once.  may_pack: the payloads may ride above
// the keys' `bits` bits, and do from rank 1 to the second last rank if
// the first pass's OR of them (pay_or) shows they fit.  bins: the
// portion's first output slot of each digit; bins_next: null, or where
// the last tile writes the next portion's; status: n_tiles * kDigits
// words, zero before the call's first pass; tile_counter: one word, zero
// at launch.  One block a tile.
__global__ void __launch_bounds__(kThreads, kBlocksPerSm)
onesweep_pass_kernel(const int64_t* keys, const int32_t* pay,
                     int64_t* keys_a, int32_t* pay_a, int64_t* keys_b,
                     int32_t* pay_b, int64_t begin, int64_t n, int pass,
                     int shift, unsigned mask, int bits, int may_pack,
                     int portion, int portions,
                     const int* __restrict__ plan,
                     const unsigned* __restrict__ bins,
                     unsigned* __restrict__ bins_next,
                     unsigned* __restrict__ status,
                     unsigned* __restrict__ tile_counter,
                     unsigned* __restrict__ pay_or) {
  const int rank = plan[pass];
  if (rank < 0) return;
  const bool fits = may_pack && rank > 0 &&
                    (64 - bits >= 32 || *pay_or >> (64 - bits) == 0);
  const bool packed_in = fits && rank > 1;
  const bool packed_out = fits && rank < plan[kMaxPasses] - 1;
  const int64_t* k_in = (rank == 0 ? keys : rank & 1 ? keys_a : keys_b) +
                        begin;
  const int32_t* p_in =
      pay == nullptr || packed_in
          ? nullptr
          : (rank == 0 ? pay : rank & 1 ? pay_a : pay_b) + begin;
  int64_t* k_out = rank & 1 ? keys_b : keys_a;
  int32_t* p_out =
      pay == nullptr || packed_out ? nullptr : rank & 1 ? pay_b : pay_a;
  // the status words' epoch: the executed pass and portion, so that a
  // word left by the previous portion or pass reads as not ready
  const unsigned epoch =
      (static_cast<unsigned>(rank * portions + portion) & 3u) << 30;
  unsigned* or_word = may_pack && rank == 0 ? pay_or : nullptr;
#define HAST_SORT_TILE(move)                                              \
  sort_tile<move>(k_in, p_in, k_out, p_out, n, shift, mask, bits, epoch,  \
                  bins, bins_next, status, tile_counter, or_word)
  if (packed_in && packed_out) HAST_SORT_TILE(kPacked);
  else if (packed_in) HAST_SORT_TILE(kUnpack);
  else if (packed_out) HAST_SORT_TILE(kPack);
  else HAST_SORT_TILE(kSplit);
#undef HAST_SORT_TILE
}

struct Layout {
  int passes;
  Digits digits;          // bits split as evenly as kBits allows
  int64_t portions;
  int64_t status_words;   // one portion's tiles x kDigits
  int64_t bin_words;      // passes x portions x kDigits: each portion's slots
  int64_t counter_words;  // passes x portions, then the payloads' OR
};

Layout layout_of(int64_t n, int bits, int64_t portion) {
  Layout l;
  l.passes = (bits + kBits - 1) / kBits;
  for (int p = 0, shift = 0; p < l.passes; ++p) {
    const int width = bits / l.passes + (p < bits % l.passes);
    l.digits.shift[p] = shift;
    l.digits.mask[p] = (1u << width) - 1u;
    shift += width;
  }
  l.portions = (n + portion - 1) / portion;
  const int64_t widest = n < portion ? n : portion;
  l.status_words = (widest + kTile - 1) / kTile * kDigits;
  l.bin_words = l.passes * l.portions * kDigits;
  l.counter_words = l.passes * l.portions + 1;
  return l;
}

bool bad_args(int64_t n, int bits, int64_t portion) {
  return n < 0 || n >= (int64_t{1} << 31) || bits < 1 || bits > 64 ||
         portion < kTile || portion > kMaxPortion || portion % kTile != 0;
}

}  // namespace

// The keys a pass block ranks together, and the digit's bits.
extern "C" void hast_sort_geometry(int* out) {
  out[0] = kTile;
  out[1] = kBits;
}

// Bytes of scratch hast_sort_pairs needs for n keys, bits and portion (a
// multiple of the tile, at most 2^27); -1 for arguments it refuses.
extern "C" int64_t hast_sort_scratch_bytes(int64_t n, int bits,
                                           int64_t portion) {
  if (bad_args(n, bits, portion)) return -1;
  const Layout l = layout_of(n, bits, portion);
  return 4 * (l.status_words + l.bin_words + l.counter_words + kMaxPasses +
              1);
}

// keys (n,) int64 and pay (n,) int32 or null, unchanged unless b is
// them; a/b buffers of the same shapes; scratch of
// hast_sort_scratch_bytes(n, bits, portion) bytes, 16-byte aligned.
// 0 < n < 2^31.  One zero fill, a histogram, a plan and a launch a pass
// and portion.
extern "C" int hast_sort_pairs(const void* keys, const void* pay,
                               void* keys_a, void* pay_a, void* keys_b,
                               void* pay_b, int64_t n, int bits,
                               int64_t portion, void* scratch,
                               void* stream) {
  if (bad_args(n, bits, portion) || n == 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if (reinterpret_cast<uintptr_t>(scratch) & 15)
    return static_cast<int>(cudaErrorMisalignedAddress);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const Layout l = layout_of(n, bits, portion);
  unsigned* status = static_cast<unsigned*>(scratch);
  unsigned* bins = status + l.status_words;
  unsigned* counters = bins + l.bin_words;
  unsigned* pay_or = counters + l.counter_words - 1;
  int* plan = reinterpret_cast<int*>(counters + l.counter_words);
  // the payloads may ride above the keys' bits if 16 bits are left there
  const bool may_pack = pay != nullptr && bits + 16 <= 64;
  cudaError_t e = cudaMemsetAsync(
      status, 0, 4 * (l.status_words + l.bin_words + l.counter_words), s);
  if (e != cudaSuccess) return static_cast<int>(e);
  const auto* k_in = static_cast<const int64_t*>(keys);
  const auto* p_in = static_cast<const int32_t*>(pay);
  const int64_t bins_stride = l.portions * kDigits;
  const int64_t blocks = (n + kHistThreads - 1) / kHistThreads;
  onesweep_hist_kernel<<<static_cast<unsigned>(
                             blocks < kHistBlocks ? blocks : kHistBlocks),
                         kHistThreads, 0, s>>>(k_in, n, l.passes, l.digits,
                                               bins, bins_stride);
  onesweep_plan_kernel<<<1, kPlanThreads, 0, s>>>(
      bins, l.passes, bins_stride, n, keys == keys_b, plan);
  e = cudaFuncSetAttribute(onesweep_pass_kernel,
                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                           kSmem);
  if (e != cudaSuccess) return static_cast<int>(e);
  for (int pass = 0; pass < l.passes; ++pass) {
    for (int64_t q = 0; q < l.portions; ++q) {
      const int64_t begin = q * portion;
      const int64_t len = n - begin < portion ? n - begin : portion;
      const int64_t tiles = (len + kTile - 1) / kTile;
      unsigned* pass_bins = bins + pass * bins_stride + q * kDigits;
      onesweep_pass_kernel<<<static_cast<unsigned>(tiles), kThreads, kSmem,
                             s>>>(
          k_in, p_in, static_cast<int64_t*>(keys_a),
          static_cast<int32_t*>(pay_a), static_cast<int64_t*>(keys_b),
          static_cast<int32_t*>(pay_b), begin, len, pass,
          l.digits.shift[pass], l.digits.mask[pass], bits, may_pack,
          static_cast<int>(q), static_cast<int>(l.portions), plan, pass_bins,
          q + 1 < l.portions ? pass_bins + kDigits : nullptr, status,
          counters + pass * l.portions + q, pay_or);
    }
  }
  return static_cast<int>(cudaGetLastError());
}

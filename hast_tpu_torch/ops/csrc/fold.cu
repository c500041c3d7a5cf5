// K6 `fold_runs`: sum the counts of equal keys of a sorted run into the
// front slots.
//
// Replaces the body of hast_tpu/ops/kmer_count.py `_merge_rle_kernel`
// after its sort (K5 does the sort).  Group g is the g-th distinct key in
// order.  out_key[g] is the group's key and out_count[g] the int32 sum of
// its counts (wrapping, as the JAX scatter-add does); the sentinel group
// (INT64_MAX, the invalid-window pads) keeps its key with count 0, every
// other slot is (INT64_MAX, 0), and n_unique counts the groups that are
// not the sentinel.
//
// What bounds it on an H100: bytes.  The work must read each key and
// count once and write every output slot once (24 bytes an element).
// The design is one pass of a segmented scan with a decoupled look-back,
// then one tail launch:
//  - a tile of kTile elements is loaded coalesced into shared memory (and
//    the keys just before and after it), and each thread folds kItems
//    consecutive elements; a block scan of the threads' aggregates gives
//    each element its group within the tile.  An aggregate is (group
//    starts, count sum after the last start, or over everything when
//    there is none), and two compose in order as a segmented sum;
//  - the tile publishes its aggregate in a 64-bit status word and stages
//    its group ends (an element whose successor differs) in shared
//    memory.  A look-back warp walks back over the predecessors' words,
//    32 at a time, until an inclusive prefix, publishes the tile's own,
//    and writes its group slots coalesced, each slot once, by the tile
//    that holds the group's last element, the carried count added to a
//    group that began in an earlier tile.  No fill first, no second read
//    of the keys, no atomics on the counts;
//  - a tile waits on its predecessors, and those that started late hold
//    up every tile after them.  So the blocks are persistent, with two
//    staging buffers and a look-back warp for each: the workers fold the
//    next tile while the last one's warp waits, and only the warps wait;
//  - the tail launch reads the group total, writes (INT64_MAX, 0) into
//    slots [groups, n) and n_unique, and zeroes the status words and the
//    tile counter for the next call on the stream.  The wrapper keeps one
//    such scratch buffer a card and stream, zeroed when it is allocated,
//    so that a call is two launches and no memset.
// The sums are uint32 additions in a fixed order, so the result equals
// the twin bit for bit.
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kItems = 8;
constexpr int kTile = kThreads * kItems;   // FOLD_TILE in kmer_count.py
constexpr int64_t kSent = INT64_MAX;
// A status word: 0 while the tile is unpublished, else the high half is
// (1 + the tile's group starts), bit 31 clear (its aggregate), or
// kPrefix | the starts through the tile (the inclusive prefix; n < 2^31),
// and the low half the count sum of the open group.
constexpr uint32_t kPrefix = 1u << 31;
// Blocks an SM holds (registers capped to fit them) and the pause between
// polls of a status word, both chosen by timing on an H100: two blocks
// an SM, or polls 300 ns apart, ran slower
constexpr int kBlocksPerSm = 3;
constexpr unsigned kPollNs = 600;
constexpr int kLook = 2;                       // buffers and look-back warps
constexpr int kBlock = kThreads + 32 * kLook;
constexpr int kKeySlots = kTile + kTile / 16;  // kslot(kTile - 1) < this
constexpr int kCountSlots = kTile + kTile / 8;
constexpr int kBufBytes = kKeySlots * 8 + kCountSlots * 4;

// Shared-memory slots of element e: a thread reads elements kItems
// apart, so one pad word every 16 keys and every 8 counts keeps a
// half-warp's key reads and a warp's count reads on distinct banks.
__device__ __forceinline__ int kslot(int e) { return e + (e >> 4); }
__device__ __forceinline__ int cslot(int e) { return e + (e >> 3); }

struct Agg {
  uint32_t s;   // group starts
  uint32_t c;   // count sum after the last start (over all if s == 0)
};

__device__ __forceinline__ Agg compose(Agg older, Agg newer) {
  return {older.s + newer.s, newer.s ? newer.c : older.c + newer.c};
}

__device__ __forceinline__ Agg shfl_up(Agg a, int off) {
  return {__shfl_up_sync(0xFFFFFFFFu, a.s, off),
          __shfl_up_sync(0xFFFFFFFFu, a.c, off)};
}

__device__ __forceinline__ Agg warp_inclusive(Agg x, int lane) {
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const Agg y = shfl_up(x, off);
    if (lane >= off) x = compose(y, x);
  }
  return x;
}

__device__ __forceinline__ unsigned long long load_status(
    const unsigned long long* p) {
  return *reinterpret_cast<const volatile unsigned long long*>(p);
}

__device__ __forceinline__ void store_status(unsigned long long* p,
                                             uint32_t hi, uint32_t c) {
  *reinterpret_cast<volatile unsigned long long*>(p) =
      static_cast<unsigned long long>(hi) << 32 | c;
}

// The earlier tiles' inclusive prefix, by one warp: lane l reads the word
// of tile t - l, and each window of 32 folds, oldest first, up to the
// newest inclusive prefix in it.
__device__ __forceinline__ Agg look_back(const unsigned long long* status,
                                         int64_t tile, int lane) {
  Agg acc{0u, 0u};
  for (int64_t t = tile - 1; t >= 0; t -= 32) {
    const int64_t at = t - lane;
    unsigned long long v = static_cast<unsigned long long>(kPrefix) << 32;
    if (at >= 0) {
      // a word still zero is polled again after a pause: the pause keeps
      // the polls of the waiting tiles off the words being published
      while (((v = load_status(status + at)) >> 32) == 0)
        __nanosleep(kPollNs);
    }
    const uint32_t hi = static_cast<uint32_t>(v >> 32);
    const bool prefix = hi & kPrefix;
    const Agg a{prefix ? hi & ~kPrefix : hi - 1u, static_cast<uint32_t>(v)};
    const unsigned pm = __ballot_sync(0xFFFFFFFFu, prefix);
    const int stop = pm ? __ffs(pm) - 1 : 31;
    Agg w{0u, 0u};
    for (int l = stop; l >= 0; --l)
      w = compose(w, {__shfl_sync(0xFFFFFFFFu, a.s, l),
                      __shfl_sync(0xFFFFFFFFu, a.c, l)});
    acc = compose(w, acc);
    if (pm) break;
  }
  return acc;
}

// Barriers by number: 1 the workers alone; 2 + b "buffer b holds a
// claimed tile and is free" and 4 + b "the workers staged buffer b",
// each between the workers and look-back warp b.
__device__ __forceinline__ void workers_sync() {
  asm volatile("bar.sync 1, %0;" ::"n"(kThreads) : "memory");
}

__device__ __forceinline__ void pair_sync(int id) {
  asm volatile("bar.sync %0, %1;" ::"r"(id), "n"(kThreads + 32) : "memory");
}

__device__ __forceinline__ void pair_arrive(int id) {
  asm volatile("bar.arrive %0, %1;" ::"r"(id), "n"(kThreads + 32)
               : "memory");
}

// status: one word a tile, zero at launch; tail[0] the tile counter, zero
// at launch; tail[1] gets the group total.  A block's iteration i uses
// buffer b = i & 1: look-back warp b claims its tile (after iteration i -
// 1's claim, so a block's tiles ascend), hands it to the workers, walks
// back, waits for the staging, publishes the inclusive prefix, writes the
// group slots, and goes on to iteration i + 2.  The first iteration past
// the last tile ends the block.
__global__ void __launch_bounds__(kBlock, kBlocksPerSm)
fold_tiles_kernel(const int64_t* __restrict__ keys,
                  const int32_t* __restrict__ counts, int64_t n,
                  int64_t* __restrict__ out_keys,
                  int32_t* __restrict__ out_counts,
                  unsigned long long* __restrict__ status,
                  uint32_t* __restrict__ tail) {
  // two buffers, each the tile's keys and counts, then its group ends'
  // keys and sums
  extern __shared__ __align__(16) unsigned char s_buf[];
  __shared__ Agg s_warp[kWarps];
  __shared__ int64_t s_edge[2];     // the keys before and after the tile
  __shared__ int64_t s_tile[kLook];
  __shared__ uint32_t s_first_start[kLook], s_last_end[kLook];
  __shared__ Agg s_agg[kLook];
  __shared__ int s_claimed;         // the block's iterations claimed
  const int64_t n_tiles = (n + kTile - 1) / kTile;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  if (tid == 0) s_claimed = 0;
  __syncthreads();

  if (warp >= kWarps) {
    const int b = warp - kWarps;
    const int64_t* s_keys =
        reinterpret_cast<const int64_t*>(s_buf + b * kBufBytes);
    const uint32_t* s_counts =
        reinterpret_cast<const uint32_t*>(s_keys + kKeySlots);
    for (int i = b;; i += kLook) {
      if (lane == 0)
        while (*reinterpret_cast<volatile int*>(&s_claimed) < i) {
        }
      __syncwarp();
      // iteration i - 1 was past the end: its workers left, so leave too
      // (lane 0's reading: once lane 0 has claimed below, the other
      // look-back warp may rewrite the word)
      if (__shfl_sync(0xFFFFFFFFu,
                      i > 0 && *reinterpret_cast<volatile int64_t*>(
                                   &s_tile[b ^ 1]) >= n_tiles,
                      0))
        break;
      int64_t tile = 0;
      if (lane == 0) {
        tile = atomicAdd(tail, 1u);
        s_tile[b] = tile;
        __threadfence_block();
        *reinterpret_cast<volatile int*>(&s_claimed) = i + 1;
      }
      tile = __shfl_sync(0xFFFFFFFFu, tile, 0);
      pair_arrive(2 + b);
      if (tile >= n_tiles) break;
      const Agg pre = look_back(status, tile, lane);
      pair_sync(4 + b);
      const Agg agg = s_agg[b];
      if (lane == 0) {
        const Agg all = compose(pre, agg);
        if (tile > 0) store_status(status + tile, kPrefix | all.s, all.c);
        if ((tile + 1) * kTile >= n) tail[1] = all.s;   // the last tile
      }
      // the tile's group slots: g0 is the group of its first element
      const uint32_t first_start = s_first_start[b];
      const int64_t g0 = static_cast<int64_t>(pre.s) + first_start - 1;
      const int n_ends = static_cast<int>(agg.s - first_start +
                                          s_last_end[b]);
      for (int j = lane; j < n_ends; j += 32) {
        out_keys[g0 + j] = s_keys[kslot(j)];
        out_counts[g0 + j] = static_cast<int32_t>(
            s_counts[cslot(j)] + (j == 0 && !first_start ? pre.c : 0u));
      }
      __syncwarp();   // the buffer is read before it is handed back
    }
    return;
  }

  for (int i = 0;; ++i) {
    const int b = i & 1;
    pair_sync(2 + b);
    const int64_t tile = s_tile[b];
    if (tile >= n_tiles) break;
    int64_t* s_keys = reinterpret_cast<int64_t*>(s_buf + b * kBufBytes);
    uint32_t* s_counts = reinterpret_cast<uint32_t*>(s_keys + kKeySlots);
    const int64_t base = tile * kTile;
    const int valid = static_cast<int>(n - base < kTile ? n - base : kTile);
    const bool has_prev = base > 0, has_next = base + valid < n;
#pragma unroll
    for (int k = 0; k < kItems; ++k) {
      const int j = k * kThreads + tid;
      if (j < valid) {
        s_keys[kslot(j)] = keys[base + j];
        s_counts[cslot(j)] = static_cast<uint32_t>(counts[base + j]);
      }
    }
    if (tid == 0 && has_prev) s_edge[0] = keys[base - 1];
    if (tid == 1 && has_next) s_edge[1] = keys[base + valid];
    workers_sync();

    // this thread's elements [first, first + kItems): start and end
    // flags, counts (0 for the sentinel's), and their aggregate
    const int first = tid * kItems;
    int64_t key[kItems];
    uint32_t cnt[kItems];
    bool start[kItems], end[kItems];
    Agg mine{0u, 0u};
#pragma unroll
    for (int k = 0; k < kItems; ++k) {
      const int e = first + k;
      const bool in = e < valid;
      key[k] = in ? s_keys[kslot(e)] : 0;
      cnt[k] = in && key[k] != kSent ? s_counts[cslot(e)] : 0u;
      start[k] = in && (e ? key[k] != s_keys[kslot(e - 1)]
                          : !has_prev || key[k] != s_edge[0]);
      end[k] = in && (e + 1 < valid ? key[k] != s_keys[kslot(e + 1)]
                                    : !has_next || key[k] != s_edge[1]);
      mine = compose(mine, {start[k] ? 1u : 0u, cnt[k]});
      if (e == valid - 1) s_last_end[b] = end[k];
    }
    if (tid == 0) s_first_start[b] = start[0];

    // block scan of the aggregates: the warps', then the threads'
    const Agg incl = warp_inclusive(mine, lane);
    if (lane == 31) s_warp[warp] = incl;
    workers_sync();   // also: every worker has read its elements
    if (warp == 0) {
      Agg w = lane < kWarps ? s_warp[lane] : Agg{0u, 0u};
      w = warp_inclusive(w, lane);
      if (lane < kWarps) s_warp[lane] = w;
    }
    workers_sync();
    const Agg tile_agg = s_warp[kWarps - 1];
    const Agg lane_excl = shfl_up(incl, 1);
    Agg run = compose(warp ? s_warp[warp - 1] : Agg{0u, 0u},
                      lane ? lane_excl : Agg{0u, 0u});
    if (tid == 0) {
      store_status(status + tile, tile == 0 ? kPrefix | tile_agg.s
                                            : 1u + tile_agg.s, tile_agg.c);
      s_agg[b] = tile_agg;
    }

    // stage the group ends in order: slot = starts through the element
    // less the tile's first start flag (a group carried in takes slot 0)
    const uint32_t first_start = s_first_start[b];
#pragma unroll
    for (int k = 0; k < kItems; ++k) {
      run = compose(run, {start[k] ? 1u : 0u, cnt[k]});
      if (end[k]) {
        const int slot = static_cast<int>(run.s - first_start);
        s_keys[kslot(slot)] = key[k];
        s_counts[cslot(slot)] = run.c;
      }
    }
    workers_sync();   // s_warp and s_edge are written again next tile
    pair_arrive(4 + b);
  }
}

// The persistent grid of fold_tiles_kernel on the current card: the
// blocks it holds at once (the shared-memory limit is raised first).
int fold_grid() {
  static int grids[64] = {};
  int dev = 0;
  cudaGetDevice(&dev);
  if (dev < 0 || dev >= 64) return 0;
  if (grids[dev] == 0) {
    int sms = 0, per_sm = 0;
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    cudaFuncSetAttribute(fold_tiles_kernel,
                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                         kLook * kBufBytes);
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, fold_tiles_kernel, kBlock, kLook * kBufBytes);
    grids[dev] = sms * per_sm;
  }
  return grids[dev];
}

// Slots [groups, n) -> (INT64_MAX, 0), n_unique, and the scratch zeroed:
// one slot a thread (a grid-stride loop over fewer blocks wrote at 0.6 of
// this rate, H100).
__global__ void fold_tail_kernel(const int64_t* __restrict__ keys, int64_t n,
                                 int64_t* __restrict__ out_keys,
                                 int32_t* __restrict__ out_counts,
                                 int64_t* __restrict__ n_unique,
                                 unsigned long long* __restrict__ status,
                                 int64_t n_tiles,
                                 uint32_t* __restrict__ tail) {
  const int64_t groups = tail[1];
  const int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x +
                    threadIdx.x;
  if (groups + i < n) {
    out_keys[groups + i] = kSent;
    out_counts[groups + i] = 0;
  }
  if (i < n_tiles) status[i] = 0;
  if (i == 0) {
    *n_unique = groups - (keys[n - 1] == kSent ? 1 : 0);
    tail[0] = 0;
  }
}

}  // namespace

// keys (n,) int64 ascending, counts (n,) int32 -> out_keys (n,) int64,
// out_counts (n,) int32, n_unique () int64; scratch of 1 + ceil(n /
// kTile) uint64 words (the tile counter and the group total, then a
// status word a tile), zero but for the group total, and so again when
// the call's work is done.
// 0 < n < 2^31.
extern "C" int hast_fold_runs(const void* keys, const void* counts,
                              int64_t n, void* out_keys, void* out_counts,
                              void* n_unique, void* scratch, void* stream) {
  if (n <= 0 || n >= (int64_t{1} << 31))
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int64_t n_tiles = (n + kTile - 1) / kTile;
  // the tile counter and group total first, at a place no status word of
  // a longer run takes
  auto* tail = static_cast<uint32_t*>(scratch);
  auto* status = static_cast<unsigned long long*>(scratch) + 1;
  const auto* k = static_cast<const int64_t*>(keys);
  auto* ok = static_cast<int64_t*>(out_keys);
  auto* oc = static_cast<int32_t*>(out_counts);
  const int grid = fold_grid();
  if (grid <= 0) return static_cast<int>(cudaErrorInvalidConfiguration);
  fold_tiles_kernel<<<static_cast<unsigned>(n_tiles < grid ? n_tiles : grid),
                      kBlock, kLook * kBufBytes, s>>>(
      k, static_cast<const int32_t*>(counts), n, ok, oc, status, tail);
  const cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  fold_tail_kernel<<<static_cast<unsigned>((n + 255) / 256), 256, 0, s>>>(
      k, n, ok, oc, static_cast<int64_t*>(n_unique), status, n_tiles, tail);
  return static_cast<int>(cudaGetLastError());
}

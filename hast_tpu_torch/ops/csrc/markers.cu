// K8 `marker_filter`: the stage-00 marker algebra for both parents in one
// call.  A row of a is kept iff it is real, its key is absent from b and
// a_lower <= count <= a_upper; a row of b likewise against a, with b's
// bounds.  Each parent's kept keys go to the front of its output,
// ascending, INT64_MAX after them, and their numbers to kept[0], kept[1].
//
// Replaces hast_tpu/ops/kmer_count.py `_unique_filter_kernel` and
// `_compact_kernel`.  Both runs are sorted and distinct, so one merge of
// the real prefixes a[:a_n] and b[:b_n] settles membership for both, as
// the reference's one tag sort does: ties order a first, so a key is
// shared iff the row after an a row, or the row before a b row, in the
// merged order holds the same key.  Pads are never merged and a key equal
// to INT64_MAX is never kept, so lower = 0 keeps no pad.
//
// What bounds it on an H100: bytes.  The work reads each parent's keys
// and counts once and writes every output slot once.  Design, on the
// model of fold.cu (K6):
//  - merge-path tiles: tile t owns merged rows [t*kTile, (t+1)*kTile), so
//    tiles stay balanced however the keys interleave.  The splits (the a
//    rows before each tile edge) are searched by one warp of each block,
//    the scout, eight edges at a time in order of the edges, and
//    published in the scratch ahead of the tiles.  A search is some seven
//    dependent trips to HBM, longer than a tile's merge; a tile claimed
//    early, to search it ahead, would hold up the look-back of every tile
//    after it (claimed a ring of eight ahead, the tiles went through in
//    index order, one at a time);
//  - as in fold.cu a look-back warp for each of two staging buffers claims
//    a tile when its buffer is free, but here it also loads the tile: its
//    a and b pieces, with the a row just before the tile and the b row
//    just after it (so that an equal pair split by a tile's edge is seen
//    from both sides), and their counts, as four bulk copies into shared
//    memory that land while the workers merge the other buffer (loaded
//    by the workers themselves, the tiles moved at a third of the rate);
//  - each worker merges kItems rows from a start that a merge-path search
//    in shared memory finds, keeping the two heads in registers, and tests
//    them; a block scan of the kept counts (a and b packed in one word)
//    ranks each kept key;
//  - one pass of a decoupled look-back, both chains (kept a, kept b) in
//    one 64-bit status word a tile: the look-back warp walks back while
//    the workers merge, publishes the inclusive prefix and writes the
//    tile's kept keys, each once and coalesced;
//  - a tail launch writes INT64_MAX into slots [kept, len) of each output
//    and zeroes the status words, the splits and the counters for the
//    next call on the stream (the wrapper keeps one zeroed scratch buffer
//    a card and stream), so a call is two launches and no memset.
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 256;              // workers
constexpr int kWarps = kThreads / 32;
constexpr int kItems = 8;
constexpr int kTile = kThreads * kItems;   // MARKER_TILE in kmer_count.py
constexpr int kLook = 2;                   // buffers and look-back warps
constexpr int kFree = 2, kStaged = kFree + kLook;   // barrier numbers
constexpr int kScout = kWarps + kLook;     // the scout's warp
constexpr int kEdges = 8;                  // edges a scout searches at once
constexpr int kBlock = kThreads + 32 * kLook + 32;
constexpr int kBlocksPerSm = 3;
constexpr unsigned kPollNs = 600;
constexpr int64_t kSent = INT64_MAX;
// A buffer: the 16-byte chunks holding the tile's keys (chunk 0 kept for
// the a row before it, then the a rows, then the b rows and the b row
// after them), then those holding its counts (a's, then b's).  Each run
// lands as whole aligned chunks, so up to a chunk of slack each.
constexpr int kKeyBytes = (kTile + 16) * 8;
constexpr int kCountBytes = (kTile + 16) * 4;
constexpr int kBufBytes = kKeyBytes + kCountBytes;

// A status word: 0 while the tile is unpublished, else kReady with the
// tile's own kept counts or kPrefix with those through the tile; kept a
// in bits 0-30, kept b in bits 31-61 (a run has fewer than 2^31 rows).
constexpr unsigned long long kPrefix = 1ull << 63;
constexpr unsigned long long kReady = 1ull << 62;
constexpr uint32_t kMask31 = (1u << 31) - 1;

struct Kept {
  uint32_t a, b;
};

__device__ __forceinline__ unsigned long long pack(Kept k) {
  return k.a | static_cast<unsigned long long>(k.b) << 31;
}

// The block's state at the head of its dynamic shared memory; the
// buffers follow it.  Buffer b's tile and its splits (the a rows before
// and after it).
struct Shared {
  unsigned long long bar[kLook];   // buffer b's loads landed
  int64_t tile[kLook], i0[kLook], i1[kLook];
  // slots of a[i0], b[j0] among the keys and of their counts
  int a_slot[kLook], b_slot[kLook], ac_slot[kLook], bc_slot[kLook];
  Kept agg[kLook];         // buffer b's kept counts
  uint32_t warp_sums[kWarps];
  int claimed;             // the block's iterations claimed
};
constexpr int kHead = (sizeof(Shared) + 15) & ~15;
constexpr int kSmem = kHead + kLook * kBufBytes;

template <typename T>
__device__ __forceinline__ T vload(const T& x) {
  return *reinterpret_cast<const volatile T*>(&x);
}

template <typename T>
__device__ __forceinline__ void vstore(T& x, T v) {
  *reinterpret_cast<volatile T*>(&x) = v;
}

__device__ __forceinline__ unsigned long long load_status(
    const unsigned long long* p) {
  return *reinterpret_cast<const volatile unsigned long long*>(p);
}

__device__ __forceinline__ void store_status(unsigned long long* p,
                                             unsigned long long v) {
  *reinterpret_cast<volatile unsigned long long*>(p) = v;
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(unsigned long long* bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;" ::"r"(smem_addr(bar))
               : "memory");
  asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
}

// The one arrival of a buffer's phase, with the bytes its loads bring.
__device__ __forceinline__ void mbar_expect(unsigned long long* bar,
                                            uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;"
               ::"r"(smem_addr(bar)), "r"(bytes) : "memory");
}

__device__ __forceinline__ void mbar_wait(unsigned long long* bar,
                                          uint32_t parity) {
  uint32_t done = 0;
  while (!done)
    asm volatile(
        "{ .reg .pred p; mbarrier.try_wait.parity.shared::cta.b64 p, [%1], "
        "%2; selp.u32 %0, 1, 0, p; }"
        : "=r"(done) : "r"(smem_addr(bar)), "r"(parity) : "memory");
}

// The shared memory a buffer's loads write was read and written by the
// threads before: order those accesses before the loads'.
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
}

__device__ __forceinline__ void bulk_load(void* dst, const void* src,
                                          uint32_t bytes,
                                          unsigned long long* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];" ::"r"(smem_addr(dst)), "l"(src), "r"(bytes),
      "r"(smem_addr(bar)) : "memory");
}

// The 16-byte chunks holding bytes [lo, hi) of the input, as a load.
struct Span {
  const unsigned char* src;
  uint32_t bytes;
};

__device__ __forceinline__ Span chunks_of(const void* lo, const void* hi) {
  const uintptr_t a = reinterpret_cast<uintptr_t>(lo) & ~uintptr_t{15};
  const uintptr_t b = (reinterpret_cast<uintptr_t>(hi) + 15) & ~uintptr_t{15};
  return {reinterpret_cast<const unsigned char*>(a),
          lo < hi ? static_cast<uint32_t>(b - a) : 0u};
}

// The bytes from the start of a span's chunks to p.
__device__ __forceinline__ uint32_t offset_in(const Span& s, const void* p) {
  return static_cast<uint32_t>(static_cast<const unsigned char*>(p) - s.src);
}

// The kept counts of the tiles before `tile`, by one warp: lane l reads
// the word of tile t - l, and each window of 32 sums, newest first, down
// to the newest inclusive prefix in it.
__device__ __forceinline__ Kept look_back(const unsigned long long* status,
                                          int64_t tile, int lane) {
  Kept acc{0u, 0u};
  for (int64_t t = tile - 1; t >= 0; t -= 32) {
    const int64_t at = t - lane;
    unsigned long long v = kPrefix;   // before tile 0: nothing kept
    if (at >= 0) {
      // a word still zero is polled again after a pause: the pause keeps
      // the polls of the waiting tiles off the words being published
      while ((v = load_status(status + at)) == 0) __nanosleep(kPollNs);
    }
    const unsigned pm = __ballot_sync(0xFFFFFFFFu, (v & kPrefix) != 0);
    const int stop = pm ? __ffs(pm) - 1 : 31;
    const bool in = lane <= stop;
    acc.a += __reduce_add_sync(0xFFFFFFFFu,
                               in ? static_cast<uint32_t>(v) & kMask31 : 0u);
    acc.b += __reduce_add_sync(
        0xFFFFFFFFu, in ? static_cast<uint32_t>(v >> 31) & kMask31 : 0u);
    if (pm) break;
  }
  return acc;
}

// The a rows among the first d rows of the merge of a[:a_n] and b[:b_n],
// ties a first: the first i with a[i] > b[d - 1 - i].  One warp searches
// kEdges diagonals at once, four lanes a diagonal (lanes 4g to 4g + 3
// diagonal g) and four probes a lane: 16 probes a round, some seven
// rounds, each one trip to memory.  Returns the split of this lane's
// diagonal (-1 where live is false).
__device__ __forceinline__ int64_t merge_split(const int64_t* a, int64_t a_n,
                                               const int64_t* b, int64_t b_n,
                                               int64_t d, bool live,
                                               int lane) {
  constexpr int kProbes = 16;
  const int u = lane & 3;
  const int group = lane & ~3;
  int64_t lo = d > b_n ? d - b_n : 0;
  int64_t hi = d < a_n ? d : a_n;
  if (!live) lo = hi = -1;
  while (__any_sync(0xFFFFFFFFu, hi > lo)) {
    const int64_t r = hi - lo;
    unsigned below = 0;
#pragma unroll
    for (int p = 0; p < 4; ++p) {
      const int j = 4 * u + p;
      const int64_t m =
          r <= kProbes ? lo + j : lo + (j + 1) * r / (kProbes + 1);
      if (m < hi && a[m] <= b[d - 1 - m]) below |= 1u << p;
    }
    // the group's true probes, a prefix of its 16 in order
    int c = 0;
#pragma unroll
    for (int p = 0; p < 4; ++p)
      c += __popc(__ballot_sync(0xFFFFFFFFu, below >> p & 1u) >> group & 15u);
    if (r <= kProbes) {
      lo = hi = lo + c;
    } else if (r > 0) {
      const int64_t l = lo;
      if (c < kProbes) hi = l + (c + 1) * r / (kProbes + 1);
      if (c > 0) lo = l + c * r / (kProbes + 1) + 1;
    }
  }
  return lo;
}

// Barriers by number: 1 the workers alone; kFree + b "buffer b holds a
// claimed tile and its splits and is free" and kStaged + b "the workers staged
// buffer b", each between the workers and look-back warp b.
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

// status: one word a tile, zero at launch; splits: n_tiles + 1 words,
// zero at launch, the scouts' split + 1 of each tile edge; counters: the
// tile counter and the edge counter, zero at launch.  A block's iteration
// i uses buffer b = i % kLook: look-back warp b claims its tile (after
// iteration i - 1's claim, so a block's tiles ascend), waits for its
// splits, hands it to the workers, walks back, waits for the staging,
// publishes the inclusive prefix, writes the kept keys, and goes on to
// iteration i + kLook.  The first iteration past the last tile ends the
// block.
__global__ void __launch_bounds__(kBlock, kBlocksPerSm)
marker_tiles_kernel(const int64_t* __restrict__ a_keys,
                    const int32_t* __restrict__ a_counts, int64_t a_n,
                    const int64_t* __restrict__ b_keys,
                    const int32_t* __restrict__ b_counts, int64_t b_n,
                    long long a_lower, long long a_upper, long long b_lower,
                    long long b_upper, int64_t* __restrict__ a_out,
                    int64_t* __restrict__ b_out, int64_t* __restrict__ kept,
                    unsigned long long* __restrict__ status,
                    unsigned long long* __restrict__ splits,
                    uint32_t* __restrict__ counters) {
  extern __shared__ __align__(16) unsigned char s_mem[];
  Shared& sh = *reinterpret_cast<Shared*>(s_mem);
  unsigned char* s_buf = s_mem + kHead;
  const int64_t m_total = a_n + b_n;
  const int64_t n_tiles = (m_total + kTile - 1) / kTile;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  if (tid == 0) {
    sh.claimed = 0;
    for (int b = 0; b < kLook; ++b) mbar_init(&sh.bar[b]);
  }
  __syncthreads();

  if (warp == kScout) {
    // edges [e0, e0 + kEdges) at a time, in order, until past the last
    for (;;) {
      uint32_t e0 = 0;
      if (lane == 0) e0 = atomicAdd(counters + 1, kEdges);
      e0 = __shfl_sync(0xFFFFFFFFu, e0, 0);
      if (e0 > n_tiles) return;
      const int64_t e = e0 + (lane >> 2);
      const int64_t d = e * kTile < m_total ? e * kTile : m_total;
      const int64_t split = merge_split(a_keys, a_n, b_keys, b_n, d,
                                        e <= n_tiles, lane);
      if ((lane & 3) == 0 && e <= n_tiles)
        store_status(splits + e, static_cast<unsigned long long>(split) + 1);
    }
  }

  if (warp >= kWarps) {
    const int b = warp - kWarps;
    unsigned char* buf = s_buf + b * kBufBytes;
    const int64_t* s_keys = reinterpret_cast<const int64_t*>(buf);
    for (int i = b;; i += kLook) {
      if (lane == 0)
        while (vload(sh.claimed) < i) {
        }
      __syncwarp();
      // iteration i - 1 was past the end: its workers left, so leave too,
      // passing the end on to the next look-back warp (lane 0's reading:
      // the next claim may rewrite the word once lane 0 has claimed)
      if (__shfl_sync(0xFFFFFFFFu,
                      i > 0 && vload(sh.tile[(i - 1) % kLook]) >= n_tiles,
                      0)) {
        if (lane == 0) {
          vstore(sh.tile[b], n_tiles);
          __threadfence_block();
          vstore(sh.claimed, i + 1);
        }
        return;
      }
      int64_t tile = 0;
      if (lane == 0) {
        tile = atomicAdd(counters, 1u);
        vstore(sh.tile[b], tile);
        __threadfence_block();
        vstore(sh.claimed, i + 1);
      }
      tile = __shfl_sync(0xFFFFFFFFu, tile, 0);
      if (tile < n_tiles) {
        // the tile's splits, which the scouts publish ahead of the claims
        int64_t split = 0;
        if (lane < 2) {
          unsigned long long v;
          while ((v = load_status(splits + tile + lane)) == 0)
            __nanosleep(100);
          split = static_cast<int64_t>(v - 1);
        }
        const int64_t i0 = __shfl_sync(0xFFFFFFFFu, split, 0);
        const int64_t i1 = __shfl_sync(0xFFFFFFFFu, split, 1);
        if (lane == 0) {
          // load the tile into the buffer while the workers merge the
          // other one: a rows [i0 - 1, i1) from chunk 1, b rows [j0, j1]
          // after them, then the counts
          const int64_t d0 = tile * kTile;
          const int64_t j0 = d0 - i0;
          const int64_t j1 =
              (d0 + kTile < m_total ? d0 + kTile : m_total) - i1;
          const int64_t* a_first = a_keys + (i0 > 0 ? i0 - 1 : 0);
          const Span sa = chunks_of(a_first, a_keys + i1);
          const Span sb = chunks_of(b_keys + j0,
                                    b_keys + (j1 < b_n ? j1 + 1 : j1));
          const Span sac = chunks_of(a_counts + i0, a_counts + i1);
          const Span sbc = chunks_of(b_counts + j0, b_counts + j1);
          const uint32_t b_at = 16 + sa.bytes;   // b's chunks, in bytes
          const uint32_t bc_at = kKeyBytes + sac.bytes;
          vstore(sh.i0[b], i0);
          vstore(sh.i1[b], i1);
          sh.a_slot[b] = (16 + offset_in(sa, a_keys + i0)) / 8;
          sh.b_slot[b] = (b_at + offset_in(sb, b_keys + j0)) / 8;
          sh.ac_slot[b] = offset_in(sac, a_counts + i0) / 4;
          sh.bc_slot[b] = (sac.bytes + offset_in(sbc, b_counts + j0)) / 4;
          unsigned long long* bar = &sh.bar[b];
          fence_proxy_async();
          mbar_expect(bar, sa.bytes + sb.bytes + sac.bytes + sbc.bytes);
          if (sa.bytes) bulk_load(buf + 16, sa.src, sa.bytes, bar);
          if (sb.bytes) bulk_load(buf + b_at, sb.src, sb.bytes, bar);
          if (sac.bytes) bulk_load(buf + kKeyBytes, sac.src, sac.bytes, bar);
          if (sbc.bytes) bulk_load(buf + bc_at, sbc.src, sbc.bytes, bar);
        }
      }
      pair_arrive(kFree + b);
      if (tile >= n_tiles) return;
      const Kept pre = look_back(status, tile, lane);
      pair_sync(kStaged + b);
      const Kept agg = sh.agg[b];
      const Kept all{pre.a + agg.a, pre.b + agg.b};
      if (lane == 0) {
        if (tile > 0) store_status(status + tile, kPrefix | pack(all));
        if (tile == n_tiles - 1) {
          kept[0] = all.a;
          kept[1] = all.b;
        }
      }
      for (uint32_t r = lane; r < agg.a; r += 32)
        a_out[pre.a + r] = s_keys[r];
      for (uint32_t r = lane; r < agg.b; r += 32)
        b_out[pre.b + r] = s_keys[agg.a + r];
      __syncwarp();   // the buffer is read before it is handed back
    }
  }

  for (int i = 0;; ++i) {
    const int b = i % kLook;
    pair_sync(kFree + b);
    const int64_t tile = sh.tile[b];
    if (tile >= n_tiles) break;
    const int64_t i0 = sh.i0[b];
    const int64_t d0 = tile * kTile;
    const int n = static_cast<int>(m_total - d0 < kTile ? m_total - d0
                                                        : kTile);
    const int na = static_cast<int>(sh.i1[b] - i0);
    const int nb = n - na;
    const int64_t j0 = d0 - i0;
    int64_t* s_keys = reinterpret_cast<int64_t*>(s_buf + b * kBufBytes);
    const uint32_t* s_counts =
        reinterpret_cast<const uint32_t*>(s_buf + b * kBufBytes + kKeyBytes);
    // A[-1] is the a row before the tile and B[nb] the b row after it;
    // where there is none, INT64_MAX
    int64_t* A = s_keys + sh.a_slot[b];
    int64_t* B = s_keys + sh.b_slot[b];
    const uint32_t* a_count = s_counts + sh.ac_slot[b];
    const uint32_t* b_count = s_counts + sh.bc_slot[b];
    mbar_wait(&sh.bar[b], (i / kLook) & 1);
    if (tid == 0 && i0 == 0) A[-1] = kSent;
    if (tid == 1 && j0 + nb == b_n) B[nb] = kSent;
    workers_sync();

    // this thread's merged rows [dd, dd + kItems), from its split: the
    // first a row greater than the b row before its diagonal
    const int dd = tid * kItems < n ? tid * kItems : n;
    int lo = dd > nb ? dd - nb : 0, hi = dd < na ? dd : na;
    while (lo < hi) {
      const int mid = (lo + hi) >> 1;
      if (A[mid] <= B[dd - 1 - mid])
        lo = mid + 1;
      else
        hi = mid;
    }
    int ia = lo, jb = dd - lo;
    // the rows at the heads of a and b, and the last a row taken: a step
    // loads one key and one count
    int64_t av = A[ia], bv = B[jb], prev_a = A[ia - 1];
    int64_t key[kItems];
    uint32_t keep = 0, from_b = 0, ka = 0, kb = 0;
#pragma unroll
    for (int k = 0; k < kItems; ++k) {
      if (dd + k < n) {
        const bool take_a = ia < na && (jb >= nb || av <= bv);
        const bool shared = take_a ? bv == av : prev_a == bv;
        const long long c =
            static_cast<int32_t>(take_a ? a_count[ia] : b_count[jb]);
        key[k] = take_a ? av : bv;
        const bool ok = !shared && key[k] != kSent &&
                        c >= (take_a ? a_lower : b_lower) &&
                        c <= (take_a ? a_upper : b_upper);
        keep |= static_cast<uint32_t>(ok) << k;
        from_b |= static_cast<uint32_t>(!take_a) << k;
        ka += ok && take_a;
        kb += ok && !take_a;
        if (take_a) {
          prev_a = av;
          av = A[++ia];
        } else {
          bv = B[++jb];
        }
      }
    }

    // block scan of the kept counts, a in the low half, b in the high
    // (a tile keeps at most kTile of each)
    const uint32_t v = ka | kb << 16;
    uint32_t incl = v;
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const uint32_t y = __shfl_up_sync(0xFFFFFFFFu, incl, off);
      if (lane >= off) incl += y;
    }
    if (lane == 31) sh.warp_sums[warp] = incl;
    workers_sync();   // also: every worker has read the buffer's keys
    if (warp == 0) {
      uint32_t w = lane < kWarps ? sh.warp_sums[lane] : 0u;
#pragma unroll
      for (int off = 1; off < 32; off <<= 1) {
        const uint32_t y = __shfl_up_sync(0xFFFFFFFFu, w, off);
        if (lane >= off) w += y;
      }
      if (lane < kWarps) sh.warp_sums[lane] = w;
    }
    workers_sync();
    const uint32_t total = sh.warp_sums[kWarps - 1];
    const uint32_t ex = (warp ? sh.warp_sums[warp - 1] : 0u) + incl - v;
    const Kept agg{total & 0xFFFFu, total >> 16};

    // stage the kept keys in order: a's at the front, then b's
    uint32_t pa = ex & 0xFFFFu, pb = agg.a + (ex >> 16);
#pragma unroll
    for (int k = 0; k < kItems; ++k)
      if (keep >> k & 1u) s_keys[from_b >> k & 1u ? pb++ : pa++] = key[k];
    if (tid == 0) {
      store_status(status + tile, (tile == 0 ? kPrefix : kReady) | pack(agg));
      sh.agg[b] = agg;
    }
    pair_arrive(kStaged + b);
  }
}

// The persistent grid of marker_tiles_kernel on the current card: the
// blocks it holds at once (the shared-memory limit is raised first).
int marker_grid() {
  static int grids[64] = {};
  int dev = 0;
  cudaGetDevice(&dev);
  if (dev < 0 || dev >= 64) return 0;
  if (grids[dev] == 0) {
    int sms = 0, per_sm = 0;
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    cudaFuncSetAttribute(marker_tiles_kernel,
                         cudaFuncAttributeMaxDynamicSharedMemorySize, kSmem);
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, marker_tiles_kernel, kBlock, kSmem);
    grids[dev] = sms * per_sm;
  }
  return grids[dev];
}

// Slots [kept, len) of each output -> INT64_MAX, and the scratch zeroed:
// one slot a thread.
__global__ void marker_tail_kernel(int64_t* __restrict__ a_out,
                                   int64_t a_len, int64_t* __restrict__ b_out,
                                   int64_t b_len, int64_t* __restrict__ kept,
                                   unsigned long long* __restrict__ scratch,
                                   int64_t n_tiles) {
  const int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x +
                    threadIdx.x;
  const int64_t ka = n_tiles ? kept[0] : 0;
  const int64_t kb = n_tiles ? kept[1] : 0;
  if (ka + i < a_len) a_out[ka + i] = kSent;
  if (kb + i < b_len) b_out[kb + i] = kSent;
  if (i <= 2 * n_tiles + 1) scratch[i] = 0;
  if (i == 0 && n_tiles == 0) {
    kept[0] = 0;
    kept[1] = 0;
  }
}

}  // namespace

// a_keys (a_len,) int64 ascending, real for the first a_n rows and
// INT64_MAX after, a_counts (a_len,) int32 beside them, and b likewise;
// the bounds inclusive -> a_out (a_len,) int64, b_out (b_len,) int64,
// kept (2,) int64.  scratch: 2 + 2 * ceil((a_n + b_n) / kTile) uint64
// words (the two counters, a status word a tile, then a split a tile
// edge), zero, and so again when the call's work is done.  a and b may
// be the same run.  a_len, b_len < 2^31.  Two launches.
extern "C" int hast_marker_filter(const void* a_keys, const void* a_counts,
                                  int64_t a_len, int64_t a_n,
                                  const void* b_keys, const void* b_counts,
                                  int64_t b_len, int64_t b_n,
                                  long long a_lower, long long a_upper,
                                  long long b_lower, long long b_upper,
                                  void* a_out, void* b_out, void* kept,
                                  void* scratch, void* stream) {
  if (a_n < 0 || b_n < 0 || a_n > a_len || b_n > b_len ||
      a_len >= (int64_t{1} << 31) || b_len >= (int64_t{1} << 31))
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int64_t n_tiles = (a_n + b_n + kTile - 1) / kTile;
  auto* ao = static_cast<int64_t*>(a_out);
  auto* bo = static_cast<int64_t*>(b_out);
  auto* kp = static_cast<int64_t*>(kept);
  auto* words = static_cast<unsigned long long*>(scratch);
  if (n_tiles > 0) {
    const int grid = marker_grid();
    if (grid <= 0) return static_cast<int>(cudaErrorInvalidConfiguration);
    const unsigned blocks =
        static_cast<unsigned>(n_tiles < grid ? n_tiles : grid);
    marker_tiles_kernel<<<blocks, kBlock, kSmem, s>>>(
        static_cast<const int64_t*>(a_keys),
        static_cast<const int32_t*>(a_counts), a_n,
        static_cast<const int64_t*>(b_keys),
        static_cast<const int32_t*>(b_counts), b_n, a_lower, a_upper,
        b_lower, b_upper, ao, bo, kp, words + 1, words + 1 + n_tiles,
        static_cast<uint32_t*>(scratch));
    const cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  int64_t slots = a_len > b_len ? a_len : b_len;
  if (slots < 2 * n_tiles + 2) slots = 2 * n_tiles + 2;
  marker_tail_kernel<<<static_cast<unsigned>((slots + 255) / 256), 256, 0,
                       s>>>(ao, a_len, bo, b_len, kp, words, n_tiles);
  return static_cast<int>(cudaGetLastError());
}

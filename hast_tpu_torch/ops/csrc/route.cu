// K14 `route_kmers`: the canonical k-mers of a batch's dp source shards,
// each written straight into the slot of the shard that owns its hash
// range: the route and the all_to_all in one launch.
//
// Replaces the body of hast_tpu/parallel/mesh.py `sharded_count_chunk` up
// to the receivers' sort (mesh.py:476-521).  Reads are ASCII, coded
// (b >> 1) & 3; window p is valid iff p + k <= length and its k bytes are
// A, C, G or T in either case (the rule of kmer_count.py `_ACGT`).  A
// valid key goes to shard min(kmer_hash(hi, lo) / (2^32 / dp), dp - 1),
// the branch JAX takes without x64 (shard 0 when dp = 1).  The launch
// covers n_src source shards of w reads each; the key of source s bound
// for shard d takes slot j of out[d, s * cap + j], j < cap, so that row d
// of the (dp, n_src * cap) buffer is what shard d receives, and every
// (d, s) segment ends in INT64_MAX past its keys.  Keys past a segment's
// cap are dropped and counted per source.  With n_src = 1 this is one
// shard's (dp, cap) send buffer.
//
// JAX sorts (dest, hi, lo) only so that sentinels are shed before real
// keys.  Here the same multiset reaches each segment when nothing is
// dropped (the receiver sorts it, K5), and always the same drop count,
// sum over d of max(0, real_d - cap); the order inside a segment depends
// on the blocks' timing.
//
// What bounds it on an H100: bytes, the 8-byte slot written for every
// entry of the receive buffer (keys and pads) and the reads read once.
// The design:
//  - one warp a read segment of up to 128 windows; the warp loads its
//    bytes once into shared memory (16 bytes a lane when the rows allow)
//    and packs them once (2 bits a base and an ACGT flag a base); each
//    lane takes its first window's words and run of ACGT bytes from the
//    packed bases in a few shifts, then rolls the forward and
//    reverse-complement words and the run (kmer.cuh's rolled windows,
//    shared with K9) over up to 3 more consecutive
//    windows: a byte step a window instead of k;
//  - the route by a multiply-high with a magic number made on the host,
//    exact for every 32-bit hash, instead of a division a window;
//  - for dp <= 32, a ballot per destination gives each lane its rank and
//    the warp its count; one shared atomic per warp and destination, one
//    global atomic per block and destination reserve the slots (past 32,
//    a shared atomic per key);
//  - the pads: a tail pass writes INT64_MAX from each segment's fill
//    count to its cap, so every slot of the buffer is written once (one
//    fill of the buffer before the keys took as long on the device, H100,
//    and writes the keys' slots twice).
#include <cuda_runtime.h>

#include <cstdint>

#include "kmer.cuh"
#include "probe.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kPer = 4;                      // windows a lane rolls a segment
constexpr int kSegWindows = 32 * kPer;       // windows a warp covers a segment
constexpr int kSegBytes = kSegWindows + 32;  // its bytes: + k - 1 <= 30
// a warp's shared bytes: the segment, its codes (uint16 a lane of 8 bases)
// and its ACGT flags (uint8 a lane), rounded to 16
constexpr int kWarpShared = kSegBytes + kSegBytes / 4 + kSegBytes / 8 + 4;
static_assert(kWarpShared % 16 == 0, "uint4 slots a warp");
constexpr int64_t kSent = INT64_MAX;

// floor(h / (2^32 / dp)), clamped to dp - 1: magic = 2^64 / width rounded
// up (width = floor(2^32 / dp)), and the high word of h * magic is exact
// for every h < 2^32 (the rounding adds less than h / 2^64 < 1 / width).
__device__ __forceinline__ int route_of(uint64_t key, uint64_t magic,
                                        int dp) {
  const uint32_t h = hast::kmer_hash(static_cast<uint32_t>(key >> 32),
                                     static_cast<uint32_t>(key));
  const uint32_t d = static_cast<uint32_t>(__umul64hi(h, magic));
  return d < static_cast<uint32_t>(dp - 1) ? static_cast<int>(d) : dp - 1;
}

// Windows of read r that may be keys: p + k <= min(length, stride).
__device__ __forceinline__ int windows_of(const int32_t* lengths, int64_t r,
                                          int stride, int k) {
  const int len = min(lengths[r], stride);
  return len >= k ? len - k + 1 : 0;
}

template <bool kBallot>
__global__ void __launch_bounds__(kThreads) route_kmers_kernel(
    const uint8_t* __restrict__ reads, const int32_t* __restrict__ lengths,
    int64_t w, int stride, int k, int dp, uint64_t magic, int64_t cap,
    bool vec, int64_t* __restrict__ out,
    unsigned long long* __restrict__ fill,
    unsigned long long* __restrict__ dropped) {
  extern __shared__ uint4 shared[];
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  uint8_t* buf =
      reinterpret_cast<uint8_t*>(shared + warp * (kWarpShared / 16));
  uint16_t* codes = reinterpret_cast<uint16_t*>(buf + kSegBytes);
  uint8_t* good = buf + kSegBytes + kSegBytes / 4;
  const uint32_t* codes32 = reinterpret_cast<const uint32_t*>(codes);
  const uint16_t* good16 = reinterpret_cast<const uint16_t*>(good);
  unsigned long long* base = reinterpret_cast<unsigned long long*>(
      shared + kWarps * kWarpShared / 16);
  unsigned int* count = reinterpret_cast<unsigned int*>(base + dp);

  const int s = blockIdx.y;                  // source shard of this block
  const int64_t n_src = gridDim.y;
  reads += s * w * stride;
  lengths += s * w;
  fill += static_cast<int64_t>(s) * dp;
  out += s * cap;
  const int64_t row = n_src * cap;           // a receiver's row
  const unsigned lt = (1u << lane) - 1u;

  for (int d = threadIdx.x; d < dp; d += kThreads) count[d] = 0;
  // the warp's read and the window its next segment starts at
  const int64_t r_step = static_cast<int64_t>(gridDim.x) * kWarps;
  int64_t r = static_cast<int64_t>(blockIdx.x) * kWarps + warp;
  int seg = 0;
  int n_win = r < w ? windows_of(lengths, r, stride, k) : 0;
  while (r < w && n_win == 0) {
    r += r_step;
    n_win = r < w ? windows_of(lengths, r, stride, k) : 0;
  }
  unsigned long long lost = 0;

  while (__syncthreads_or(r < w)) {
    uint64_t key[kPer];
    int dest[kPer];
    unsigned slot[kPer];
    bool valid[kPer];
#pragma unroll
    for (int j = 0; j < kPer; ++j) valid[j] = false;
    const bool busy = r < w;                 // warp-uniform
    int per = 0;
    if (busy) {
      const uint8_t* src = reads + r * stride + seg;
      const int avail = min(stride - seg, kSegBytes);
      if (vec) {
        for (int i = lane; 16 * i < avail; i += 32)
          reinterpret_cast<uint4*>(buf)[i] =
              __ldg(reinterpret_cast<const uint4*>(src) + i);
      } else {
        for (int i = lane; i < avail; i += 32) buf[i] = src[i];
      }
      __syncwarp();
      // base i's code at bits 2i of codes32[i / 16], its ACGT flag at bit
      // i of good16[i / 16]: lane l packs bytes [8l, 8l + 8)
      if (8 * lane < kSegBytes) {
        uint32_t cw = 0, gw = 0;
#pragma unroll
        for (int t = 0; t < 8; ++t) {
          const uint32_t b = buf[8 * lane + t];
          cw |= ((b >> 1) & 3u) << (2 * t);
          gw |= static_cast<uint32_t>(
              hast::byte_ok<hast::kAcgtAnyCase>(b)) << t;
        }
        codes[lane] = static_cast<uint16_t>(cw);
        good[lane] = static_cast<uint8_t>(gw);
      }
      __syncwarp();
      const int nw = min(n_win - seg, kSegWindows);
      per = (nw + 31) >> 5;
      const int first = lane * per;
      if (first < nw) {
        // the first window from the packed codes (q + 2 <= 9: first <
        // 128), then a roll a window
        hast::Window win = hast::first_window(
            hast::packed_bases(codes32, first),
            hast::packed_flags(good16, first), k);
#pragma unroll
        for (int j = 0; j < kPer; ++j) {
          if (j < per) {
            if (j) {
              const uint32_t b = buf[first + k - 1 + j];
              hast::roll_window(win, (b >> 1) & 3u,
                                hast::byte_ok<hast::kAcgtAnyCase>(b), k);
            }
            if (first + j < nw && win.run >= k) {
              key[j] = hast::canonical_of(win);
              dest[j] = route_of(key[j], magic, dp);
              valid[j] = true;
            }
          }
        }
      }
      __syncwarp();                          // buf is refilled next tile
      if constexpr (kBallot) {
        // lane d holds the warp's keys for destination d so far
        unsigned total = 0;
#pragma unroll
        for (int j = 0; j < kPer; ++j) {
          if (j >= per) break;
          const unsigned before = total;
          unsigned rank = 0;
          for (int d = 0; d < dp; ++d) {
            const bool mine = valid[j] && dest[j] == d;
            const unsigned m = __ballot_sync(0xFFFFFFFFu, mine);
            if (mine) rank = __popc(m & lt);
            if (lane == d) total += __popc(m);
          }
          slot[j] = rank + __shfl_sync(0xFFFFFFFFu, before,
                                       valid[j] ? dest[j] : 0);
        }
        const unsigned off =
            lane < dp && total ? atomicAdd(&count[lane], total) : 0u;
#pragma unroll
        for (int j = 0; j < kPer; ++j) {
          if (j >= per) break;
          slot[j] += __shfl_sync(0xFFFFFFFFu, off, valid[j] ? dest[j] : 0);
        }
      } else {
#pragma unroll
        for (int j = 0; j < kPer; ++j)
          if (valid[j]) slot[j] = atomicAdd(&count[dest[j]], 1u);
      }
    }
    __syncthreads();
    for (int d = threadIdx.x; d < dp; d += kThreads) {
      const unsigned c = count[d];
      base[d] = c ? atomicAdd(fill + d, static_cast<unsigned long long>(c))
                  : 0ull;
      count[d] = 0;
    }
    __syncthreads();
#pragma unroll
    for (int j = 0; j < kPer; ++j) {
      if (!valid[j]) continue;
      const unsigned long long at = base[dest[j]] + slot[j];
      if (at < static_cast<unsigned long long>(cap)) {
        out[dest[j] * row + static_cast<int64_t>(at)] =
            static_cast<int64_t>(key[j]);
      } else {
        ++lost;
      }
    }
    if (busy) {                              // the warp's next segment
      seg += kSegWindows;
      while (r < w && seg >= n_win) {
        r += r_step;
        seg = 0;
        n_win = r < w ? windows_of(lengths, r, stride, k) : 0;
      }
    }
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    lost += __shfl_xor_sync(0xFFFFFFFFu, lost, o);
  if (lane == 0 && lost) atomicAdd(dropped + s, lost);
}

// INT64_MAX from each (d, s) segment's fill count to its cap.
__global__ void route_pad_kernel(const unsigned long long* __restrict__ fill,
                                 int dp, int64_t n_seg, int64_t cap,
                                 int64_t* __restrict__ out) {
  const int64_t row = n_seg / dp * cap;      // n_src * cap
  for (int64_t g = blockIdx.y; g < n_seg; g += gridDim.y) {
    const int64_t s = g / dp, d = g - s * dp;
    const unsigned long long f = fill[g];
    const int64_t from = f < static_cast<unsigned long long>(cap)
                             ? static_cast<int64_t>(f)
                             : cap;
    int64_t* p = out + d * row + s * cap;
    for (int64_t i = from + static_cast<int64_t>(blockIdx.x) * blockDim.x +
                     threadIdx.x;
         i < cap; i += static_cast<int64_t>(gridDim.x) * blockDim.x)
      p[i] = kSent;
  }
}

// The grid's blocks: the SMs times the blocks of 256 threads an SM holds
// at most; blocks past what the registers let run wait for a slot.
int resident_blocks() {
  static const int n = [] {
    int dev = 0, sms = 132;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    return sms * (2048 / kThreads);
  }();
  return n;
}

}  // namespace

// reads (n_src * w, stride) uint8 ASCII, lengths (n_src * w,) int32: rows
// [s * w, (s + 1) * w) are source shard s -> out (dp, n_src * cap) int64,
// key of source s bound for shard d in out[d, s * cap + j], then INT64_MAX;
// counts (n_src * dp + n_src,) uint64 scratch, zeroed here: [s * dp + d]
// ends as the keys of source s bound for d, [n_src * dp + s] as the keys
// of source s past the cap.
extern "C" int hast_route_kmers(const void* reads, const void* lengths,
                                int64_t w, int n_src, int stride, int k,
                                int dp, int64_t cap, void* out, void* counts,
                                void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  auto* cnt = static_cast<unsigned long long*>(counts);
  auto* o = static_cast<int64_t*>(out);
  const int64_t n_counts = static_cast<int64_t>(n_src) * (dp + 1);
  const int blocks = resident_blocks();
  const cudaError_t err = cudaMemsetAsync(cnt, 0, n_counts * 8, st);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (w > 0 && stride >= k) {
    // a key per (uint64) multiply-high: width = floor(2^32 / dp) >= 2^21
    const uint64_t width = (1ull << 32) / static_cast<uint64_t>(dp);
    const uint64_t magic = UINT64_MAX / width + 1;
    const bool vec = stride % 16 == 0 &&
                     reinterpret_cast<uintptr_t>(reads) % 16 == 0;
    const int64_t tiles = (w + kWarps - 1) / kWarps;
    const int64_t per_src = blocks / n_src > 0 ? blocks / n_src : 1;
    const dim3 grid(static_cast<unsigned>(tiles < per_src ? tiles : per_src),
                    static_cast<unsigned>(n_src));
    const size_t smem = kWarps * kWarpShared +
                        dp * (sizeof(unsigned long long) + sizeof(unsigned));
    const auto* rd = static_cast<const uint8_t*>(reads);
    const auto* ln = static_cast<const int32_t*>(lengths);
    if (dp <= 32) {
      route_kmers_kernel<true><<<grid, kThreads, smem, st>>>(
          rd, ln, w, stride, k, dp, magic, cap, vec, o, cnt,
          cnt + static_cast<int64_t>(n_src) * dp);
    } else {
      route_kmers_kernel<false><<<grid, kThreads, smem, st>>>(
          rd, ln, w, stride, k, dp, magic, cap, vec, o, cnt,
          cnt + static_cast<int64_t>(n_src) * dp);
    }
  }
  if (cap > 0) {
    const int64_t n_seg = static_cast<int64_t>(n_src) * dp;
    const int64_t ys = n_seg < 65535 ? n_seg : 65535;
    const int64_t per_seg = (cap + kThreads - 1) / kThreads;
    int64_t xs = blocks / ys > 0 ? blocks / ys : 1;
    if (xs > per_seg) xs = per_seg;
    route_pad_kernel<<<dim3(static_cast<unsigned>(xs),
                            static_cast<unsigned>(ys)),
                       kThreads, 0, st>>>(cnt, dp, n_seg, cap, o);
  }
  return static_cast<int>(cudaGetLastError());
}

// K4 `count_windows`: every canonical k-mer window of a packed batch as
// one int64 key, invalid or out-of-range windows as the sentinel; and K1
// `canonical_windows`, the same tiles with every key kept and a valid
// byte beside each.
//
// Replaces hast_tpu/ops/kmer_count.py `count_kernel_multi` (masked
// batches), `count_kernel_multi_clean` (good = null: validity from the
// lengths alone) and `count_kernel_multi_range` (ranged = 1), all with
// sort=False; with K5 it is also `chunk_sorted_kmers`.  A window p of
// read r is valid iff p + k <= length and, when a mask is given, all k
// of its mask bits are set (bit j of mask byte m is base 8m + j).  A
// valid key outside [lo, hi) becomes the sentinel too.  The bounds are
// uint64 and compared as uint64: the boundary sample (kmer_count.py
// _sample_bounds) returns 2^64 - 1 as the last bound and even splits at
// or above 2^63, which as int64 would be negative.  Keys are below 2^62
// (k <= 31), so the sentinel INT64_MAX sorts after every real key.
//
// K1 replaces hast_tpu/ops/encode.py `canonical_kmers` + `window_valid`
// (and the unpack of hast_tpu/pipeline/classify.py `tally_step`): the
// clean form's windows, each key kept (a window past the read's length
// too, rolled from the row's bytes as the twin computes it) and valid =
// p + k <= length; a packed read has no mask.  It has no pipeline caller:
// K3, K9, K13 and K14 roll the same windows inline.
//
// What bounds it on an H100 (80GB HBM3, 700 W; chip_smoke.py): the
// 8-byte key written per window (K1: and its valid byte); the packed read
// (28 bytes for 100 bp) and its 14-byte mask are read once.  On 65,536
// 100-bp reads at k = 21, K4 takes 0.0286 ms masked and 0.0226 clean on
// the device against a 0.0153 ms bound, K1 0.0239 against 0.0168 (a
// thread a window cut from its k single bases, K1's first form, took
// 0.1259).  So:
//  - a block takes kTile consecutive windows of the output (a tile may
//    begin and end inside a read), stages the packed bytes and mask bytes
//    of the reads they touch into shared memory with 16-byte loads from
//    the aligned address below them, and the reads' lengths;
//  - the staged bytes are addressed by base: the native reader puts base
//    i at bits 2*(i & 3) of byte i >> 2, which read as little-endian words
//    is kmer.cuh's packing, bits 2*(i & 15) of codes32[i >> 4]; the mask
//    puts base j at bit j & 7 of byte j >> 3, bit j & 15 of good16[j >> 4].
//    So base p of staged read r is base 4*r*lp + p of the codes and bit
//    8*r*lg + p of the flags, for any stride;
//  - each thread takes kPer consecutive windows, cuts the first one's
//    words and run of good bases from the packed words and rolls the rest
//    one base a window (kmer.cuh, shared with K9 and K14), cutting anew
//    where its run crosses into the next read; no division in the window
//    loop (one 32-bit division a thread finds its first read);
//  - the keys go to shared memory, swizzled so that neither the rolling
//    threads' 8-byte stores nor the 16-byte reads after them meet on a
//    bank, and leave as coalesced 16-byte stores of the tile's contiguous
//    32 KB of output.
#include <cuda_runtime.h>

#include <cstdint>

#include "kmer.cuh"

namespace {

constexpr int64_t kSent = INT64_MAX;
constexpr int kThreads = 256;
constexpr int kPer = 16;                 // windows a thread rolls
constexpr int kTile = kThreads * kPer;   // windows a block writes

// Shared slot of the tile's window o: o and o ^ 1 stay one 16-byte pair
// (swapped when (o >> 4) is odd), and window j of thread t, o = 16t + j,
// lands on slot 16t + (j ^ (t & 15)): 16 distinct 8-byte banks a
// half-warp.
__device__ __forceinline__ int oslot(int o) { return o ^ ((o >> 4) & 15); }

// Reads a tile touches (its first may start before it, its last end after
// it), and the bytes staged for `bytes` bytes of them: 15 of alignment,
// then two 16-byte chunks of zeros for packed_bases' and packed_flags'
// reads past the last base.
__host__ __device__ inline int tile_rows(int n_win) {
  return (kTile - 1) / n_win + 2;
}

__host__ __device__ inline int staged_chunks(int bytes) {
  return (bytes + 15 + 15) / 16 + 2;
}

// Copy bytes [src, src + bytes) into dst from the 16-byte aligned address
// at or below src (an aligned chunk holding a byte of the input lies in
// its page), zeros after; returns src's offset in dst.
__device__ __forceinline__ int stage(const uint8_t* src, int bytes,
                                     uint4* dst) {
  const uintptr_t a = reinterpret_cast<uintptr_t>(src);
  const uint4* chunk = reinterpret_cast<const uint4*>(a & ~uintptr_t{15});
  const int off = static_cast<int>(a & 15);
  const int chunks = (off + bytes + 15) >> 4;
  for (int c = threadIdx.x; c < chunks + 2; c += kThreads)
    dst[c] = c < chunks ? __ldg(chunk + c) : make_uint4(0u, 0u, 0u, 0u);
  return off;
}

// kEvery (K1): every key kept, and valid[w] = (p + k <= length) beside
// it, each thread's 16 flags one 16-byte store.
template <bool kMasked, bool kRanged, bool kEvery>
__global__ void __launch_bounds__(kThreads)
count_windows_kernel(const uint8_t* __restrict__ packed,
                     const int32_t* __restrict__ lengths,
                     const uint8_t* __restrict__ good, int lg, int64_t n,
                     int lp, int k, int n_win, unsigned long long lo,
                     unsigned long long hi, int64_t* __restrict__ keys,
                     uint8_t* __restrict__ valid) {
  // keys of the tile, the reads' lengths, their codes, their flags
  extern __shared__ __align__(16) unsigned char s_mem[];
  int64_t* s_keys = reinterpret_cast<int64_t*>(s_mem);
  const int max_rows = tile_rows(n_win);
  int32_t* s_len = reinterpret_cast<int32_t*>(s_keys + kTile);
  uint4* s_codes = reinterpret_cast<uint4*>(s_len + ((max_rows + 3) & ~3));
  uint4* s_good = s_codes + staged_chunks(max_rows * lp);

  const int64_t w0 = static_cast<int64_t>(blockIdx.x) * kTile;
  const int64_t total = n * n_win;
  const int nt = static_cast<int>(total - w0 < kTile ? total - w0 : kTile);
  const int64_t row0 = w0 / n_win;   // once a block
  const int p0 = static_cast<int>(w0 - row0 * n_win);
  const int rows = (p0 + nt - 1) / n_win + 1;
  for (int r = threadIdx.x; r < rows; r += kThreads)
    s_len[r] = lengths[row0 + r];
  const int off_c = stage(packed + row0 * lp, rows * lp, s_codes);
  const int off_g = kMasked ? stage(good + row0 * lg, rows * lg, s_good) : 0;
  __syncthreads();

  const uint32_t* codes32 = reinterpret_cast<const uint32_t*>(s_codes);
  const uint16_t* good16 = reinterpret_cast<const uint16_t*>(s_good);
  const int first = threadIdx.x * kPer;
  const int cnt = nt - first;
  if (cnt > 0) {
    int r = (p0 + first) / n_win;
    int p = p0 + first - r * n_win;
    hast::Window w;
    uint64_t next, flags = 0;
    int len;
    // the window at (r, p) cut from the packed words, and the bases and
    // flags that roll in after it
    auto cut = [&]() {
      const int cb = 4 * (off_c + r * lp) + p;
      const int gb = 8 * (off_g + r * lg) + p;
      w = hast::first_window(hast::packed_bases(codes32, cb),
                             kMasked ? hast::packed_flags(good16, gb) : ~0ull,
                             k);
      next = hast::packed_bases(codes32, cb + k);
      if (kMasked) flags = hast::packed_flags(good16, gb + k);
      len = s_len[r];
    };
    cut();
    uint32_t flags4[kPer / 4] = {};   // kEvery: window j's flag, byte j
#pragma unroll
    for (int j = 0; j < kPer; ++j) {
      if (j >= cnt) break;
      if (j) {
        if (++p == n_win) {
          ++r;
          p = 0;
          cut();
        } else {
          hast::roll_window(w, static_cast<uint32_t>(next & 3u),
                            !kMasked || (flags & 1u), k);
          next >>= 2;
          if (kMasked) flags >>= 1;
        }
      }
      const uint64_t key = hast::canonical_of(w);
      bool ok = p + k <= len;
      if (kMasked) ok = ok && w.run >= k;
      if (kRanged) ok = ok && key >= lo && key < hi;
      if (kEvery) flags4[j >> 2] |= static_cast<uint32_t>(ok) << 8 * (j & 3);
      s_keys[oslot(first + j)] =
          ok || kEvery ? static_cast<int64_t>(key) : kSent;
    }
    if (kEvery) {
      uint8_t* v = valid + w0 + first;   // 16-byte aligned
      if (cnt >= kPer) {
        *reinterpret_cast<uint4*>(v) =
            make_uint4(flags4[0], flags4[1], flags4[2], flags4[3]);
      } else {
#pragma unroll
        for (int j = 0; j < kPer; ++j)
          if (j < cnt) v[j] = (flags4[j >> 2] >> 8 * (j & 3)) & 1u;
      }
    }
  }
  __syncthreads();

  // the tile's keys, two a 16-byte store (keys + w0 is 16-byte aligned)
  int64_t* out = keys + w0;
  for (int u = threadIdx.x; 2 * u + 1 < nt; u += kThreads) {
    const int o = 2 * u;
    const int s = (o >> 4) & 15;
    uint4 v = *reinterpret_cast<const uint4*>(s_keys + ((o ^ s) & ~1));
    if (s & 1) v = make_uint4(v.z, v.w, v.x, v.y);
    reinterpret_cast<uint4*>(out)[u] = v;
  }
  if ((nt & 1) && threadIdx.x == 0) out[nt - 1] = s_keys[oslot(nt - 1)];
}

// One launch of count_windows_kernel over the n * (4*lp - k + 1) windows
// of the batch, kTile a block.
template <bool kMasked, bool kRanged, bool kEvery = false>
cudaError_t launch(const uint8_t* packed, const int32_t* lengths,
                   const uint8_t* good, int lg, int64_t n, int lp, int k,
                   unsigned long long lo, unsigned long long hi,
                   int64_t* keys, uint8_t* valid, cudaStream_t s) {
  const int n_win = 4 * lp - k + 1;
  const int64_t blocks = (n * n_win + kTile - 1) / kTile;
  const int rows = tile_rows(n_win);
  const size_t smem =
      kTile * sizeof(int64_t) + ((rows + 3) & ~3) * sizeof(int32_t) +
      16 * (staged_chunks(rows * lp) + (kMasked ? staged_chunks(rows * lg)
                                                : 0));
  auto* kernel = count_windows_kernel<kMasked, kRanged, kEvery>;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return e;
  }
  kernel<<<static_cast<unsigned>(blocks), kThreads, smem, s>>>(
      packed, lengths, good, lg, n, lp, k, n_win, lo, hi, keys, valid);
  return cudaGetLastError();
}

bool misaligned(const void* p) {
  return reinterpret_cast<uintptr_t>(p) & 15;
}

}  // namespace

// packed (n, lp) uint8; lengths (n,) int32; good (n, lg) uint8 or null
// -> keys (n * (4*lp - k + 1),) int64, 16-byte aligned.  One launch.
extern "C" int hast_count_windows(const void* packed, const void* lengths,
                                  const void* good, int lg, int64_t n,
                                  int lp, int k, int ranged,
                                  unsigned long long lo,
                                  unsigned long long hi, void* keys,
                                  void* stream) {
  if (n <= 0 || 4 * lp - k + 1 <= 0) return 0;
  if (misaligned(keys)) return static_cast<int>(cudaErrorMisalignedAddress);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const auto* pk = static_cast<const uint8_t*>(packed);
  const auto* ln = static_cast<const int32_t*>(lengths);
  const auto* gd = static_cast<const uint8_t*>(good);
  auto* out = static_cast<int64_t*>(keys);
  cudaError_t e;
  if (gd)
    e = ranged ? launch<true, true>(pk, ln, gd, lg, n, lp, k, lo, hi, out,
                                    nullptr, s)
               : launch<true, false>(pk, ln, gd, lg, n, lp, k, lo, hi, out,
                                     nullptr, s);
  else
    e = ranged ? launch<false, true>(pk, ln, gd, lg, n, lp, k, lo, hi, out,
                                     nullptr, s)
               : launch<false, false>(pk, ln, gd, lg, n, lp, k, lo, hi,
                                      out, nullptr, s);
  return static_cast<int>(e);
}

// K1: packed (n, lp) uint8, lengths (n,) int32 -> keys (n, 4*lp - k + 1)
// int64 and valid (same shape) uint8, both 16-byte aligned.  One launch.
extern "C" int hast_canonical_windows(const void* packed, const void* lengths,
                                      int64_t n, int lp, int k, void* keys,
                                      void* valid, void* stream) {
  if (n <= 0 || 4 * lp - k + 1 <= 0) return 0;
  if (misaligned(keys) || misaligned(valid))
    return static_cast<int>(cudaErrorMisalignedAddress);
  return static_cast<int>(launch<false, false, true>(
      static_cast<const uint8_t*>(packed),
      static_cast<const int32_t*>(lengths), nullptr, 0, n, lp, k, 0, 0,
      static_cast<int64_t*>(keys), static_cast<uint8_t*>(valid),
      static_cast<cudaStream_t>(stream)));
}

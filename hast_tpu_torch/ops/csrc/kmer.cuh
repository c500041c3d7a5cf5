// Canonical k-mer windows over 2-bit packed reads and over ASCII bytes
// (device functions).
//
// Replaces hast_tpu/ops/encode.py `canonical_kmers` + `window_valid` and
// the 4-bases-per-byte unpack of hast_tpu/pipeline/classify.py
// `tally_step`.  A read row holds 4 bases per byte, base i at bits
// 2*(i & 3) of byte i >> 2 (the native reader's packing).  Codes are
// A=0 C=1 T=2 G=3 and the complement is code ^ 2, so for k <= 31 the
// forward word, its reverse complement and their minimum (the canonical
// key) all fit below 2^62 in one uint64 -- the (hi, lo) uint32 pair of
// the JAX package is (key >> 32, key & 0xFFFFFFFF).
//
// What bounds it on an H100: a window cut from its k single bases costs
// some 200 instructions, so no kernel here does that.  Every kernel that
// reads windows (K1 and K4 in count.cu, K3/K13 through reads.cuh, K9,
// K14) rolls them instead (below: a step a window instead of k): K9 and
// K14 from ASCII bytes they pack in shared memory, K1, K4 and K3/K13 from
// the packed rows as the native reader lays them out, K13 from ASCII rows
// too.
#pragma once

#include <cstdint>

namespace hast {

constexpr int kMaxK = 31;

// Which ASCII bytes make a base good, where a window must hold k good
// bases.  The repository has two such rules, and bytes such as a, N, R
// and U tell them apart (K13's ASCII form has none: every byte is a base,
// and validity comes from the read's length):
//   kAcgtUpper    uppercase A, C, G or T only (rephase.py `_strict_vote`,
//                 K9)
//   kAcgtAnyCase  A, C, G or T in either case (kmer_count.py `_ACGT`, the
//                 stage-00 counting of mesh.py `sharded_count_chunk`, K14)
enum ByteRule : int { kAcgtUpper, kAcgtAnyCase };

__device__ __forceinline__ bool is_acgt(uint32_t b) {
  return b == 'A' || b == 'C' || b == 'G' || b == 'T';
}

template <ByteRule kRule>
__device__ __forceinline__ bool byte_ok(uint32_t b) {
  if constexpr (kRule == kAcgtUpper) return is_acgt(b);
  return is_acgt(b & ~0x20u);
}

// Rolled windows over packed words (K1, K3, K4, K9, K13, K14).  Codes lie
// base i at bits 2 * (i & 15) of codes32[i >> 4] and flags bit i & 15 of
// good16[i >> 4], set iff base i is good: K9, K13 and K14 pack ASCII
// bytes so (codes (c >> 1) & 3, flags from the byte rule); the native
// reader's packed rows and ACGT masks, read as little-endian words, are
// already so (K1, K3, K4, K13).  A thread cuts its first window's words and
// run of good bases from the packed words in a few shifts, then rolls one
// base a window: a step a window instead of k.

// 32 bases from base p, base p at bits 0-1 (reads codes32[(p >> 4) + 2]).
__device__ __forceinline__ uint64_t packed_bases(const uint32_t* codes32,
                                                 int p) {
  const int q = p >> 4, o = p & 15;
  const uint64_t lo = codes32[q] | static_cast<uint64_t>(codes32[q + 1])
                                       << 32;
  return o ? (lo >> (2 * o)) |
                 (static_cast<uint64_t>(codes32[q + 2]) << (64 - 2 * o))
           : lo;
}

// At least 33 flags from base p, base p at bit 0 (reads good16[(p >> 4)
// + 2]).
__device__ __forceinline__ uint64_t packed_flags(const uint16_t* good16,
                                                 int p) {
  const int q = p >> 4;
  return (good16[q] | static_cast<uint64_t>(good16[q + 1]) << 16 |
          static_cast<uint64_t>(good16[q + 2]) << 32) >> (p & 15);
}

// A window's state: forward word, reverse complement (each below 4^k)
// and the run of good bases that ends at its last base.
struct Window {
  uint64_t fwd, rc;
  int run;
};

// The window of bases [p, p + k): le = packed_bases(codes32, p), flags =
// packed_flags(good16, p).  The reverse complement flips each code's high
// bit; the forward word is the same codes in reverse order (bit reversal,
// then each pair's two bits swapped back); run is k when every base is
// good, else the good bases after the last bad one.
__device__ __forceinline__ Window first_window(uint64_t le, uint64_t flags,
                                               int k) {
  const uint64_t kmask = (1ull << (2 * k)) - 1;
  le &= kmask;
  Window w;
  w.rc = le ^ (0xAAAAAAAAAAAAAAAAull & kmask);
  const uint64_t r = __brevll(le);
  w.fwd = (((r >> 1) & 0x5555555555555555ull) |
           ((r & 0x5555555555555555ull) << 1)) >> (64 - 2 * k);
  w.run = k - 1 - (63 - __clzll(~flags & ((1ull << k) - 1)));
  return w;
}

// The next window: base code c (0..3) enters, good says whether its byte
// passed the rule.
__device__ __forceinline__ void roll_window(Window& w, uint32_t c, bool good,
                                            int k) {
  w.fwd = ((w.fwd << 2) | c) & ((1ull << (2 * k)) - 1);
  w.rc = (w.rc >> 2) | (static_cast<uint64_t>(c ^ 2u) << (2 * (k - 1)));
  w.run = good ? w.run + 1 : 0;
}

__device__ __forceinline__ uint64_t canonical_of(const Window& w) {
  return w.fwd < w.rc ? w.fwd : w.rc;
}

}  // namespace hast

// Canonical k-mer windows over 2-bit packed reads (device functions).
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
// What bounds it on an H100: nothing here touches device memory except
// the k bytes of the row (L1-resident: a 100-bp read is 28 bytes), so
// the window is a few dozen integer ops; the probe that follows is what
// costs.  The design therefore recomputes each window from the packed
// bytes instead of materialising codes or a rolling state, which keeps
// one thread per window with no shared memory and no ordering.
#pragma once

#include <cstdint>

namespace hast {

constexpr int kMaxK = 31;

__device__ __forceinline__ uint32_t base_at(const uint8_t* row, int i) {
  return (static_cast<uint32_t>(row[i >> 2]) >> ((i & 3) * 2)) & 3u;
}

// min(forward, reverse complement) of the k bases starting at p.
__device__ __forceinline__ uint64_t canonical_window(const uint8_t* row,
                                                     int p, int k) {
  uint64_t fwd = 0, rc = 0;
  for (int j = 0; j < k; ++j) {
    const uint64_t c = base_at(row, p + j);
    fwd = (fwd << 2) | c;             // base j lands at bit 2*(k-1-j)
    rc |= (c ^ 2ull) << (2 * j);      // its complement at bit 2*j
  }
  return fwd < rc ? fwd : rc;
}

// Which ASCII bytes a window of k bytes may hold.  The repository has
// three rules, and bytes such as a, N, R and U tell them apart:
//   kAnyByte   every byte is a base; validity comes from the read's length
//              (hast_tpu/pipeline/classify.py `vote_kernel`, K13)
//   kAcgtUpper uppercase A, C, G or T only (rephase.py `_strict_vote`, K9)
// and A, C, G or T in either case (kmer_count.py `_ACGT`, the stage-00
// counting of mesh.py `sharded_count_chunk`), which K14 applies to the
// windows it rolls: is_acgt(b & ~0x20).
enum ByteRule : int { kAnyByte, kAcgtUpper };

__device__ __forceinline__ bool is_acgt(uint32_t b) {
  return b == 'A' || b == 'C' || b == 'G' || b == 'T';
}

// The key over k ASCII bytes, each coded (c >> 1) & 3 whatever it is
// (hast_tpu/ops/encode.py `encode_bases`).  Returns whether the bytes
// pass the rule.
template <ByteRule kRule>
__device__ __forceinline__ bool canonical_window_bytes(const uint8_t* s,
                                                       int k,
                                                       uint64_t& key) {
  uint64_t fwd = 0, rc = 0;
  bool ok = true;
  for (int j = 0; j < k; ++j) {
    const uint32_t b = s[j];
    if constexpr (kRule == kAcgtUpper) ok &= is_acgt(b);
    const uint64_t c = (b >> 1) & 3u;
    fwd = (fwd << 2) | c;
    rc |= (c ^ 2ull) << (2 * j);
  }
  key = fwd < rc ? fwd : rc;
  return ok;
}

// K9's rule (soft-masked acgt, N and IUPAC bytes make the window invalid).
__device__ __forceinline__ bool canonical_window_ascii(const uint8_t* s,
                                                       int k,
                                                       uint64_t& key) {
  return canonical_window_bytes<kAcgtUpper>(s, k, key);
}

}  // namespace hast

// Two-bucket membership probe of the marker table (device functions).
//
// Replaces hast_tpu/ops/hashtable.py `probe_quot` ("quot" format, 4-byte
// slots) and `probe` ("full" format, 8-byte slots).  Every hash, the
// Feistel permutation and the quotient split are the uint32 arithmetic
// of the numpy twins in that file, step for step; a slip here makes every
// probe miss silently, so the bit-exact twin checks are the guard.
//
// Table: (n_buckets, 4) uint32 rows, 16 bytes each, stored in an int32
// tensor.  Rows are read as one `uint4` (the tensor is 256-byte aligned,
// so every row is 16-byte aligned); the words are used as uint32, never
// sign-extended.
//
// What bounds it on an H100: two random 16-byte row reads per key, one
// per bucket choice, with no reuse between neighbouring keys.  A 16 MB
// bench-scale table sits in the 50 MB L2; a human-scale one (4.29 GB)
// goes to HBM for every row.  The design issues both row loads before
// it looks at either, so the two misses of a key overlap, and keeps
// nothing else in memory.
#pragma once

#include <cstdint>

namespace hast {

constexpr uint32_t kM1 = 0x85EBCA6Bu;
constexpr uint32_t kM2 = 0xC2B2AE35u;
constexpr uint32_t kGold = 0x9E3779B9u;
constexpr uint32_t kGold2 = 0xC2B2AE3Du;
constexpr uint32_t kHiMask = (1u << 30) - 1u;
constexpr uint32_t kQMask = (1u << 29) - 1u;

enum TableFormat : int { kQuot = 0, kFull = 1 };

// murmur3 fmix32 (hashtable.py `_mix`)
__device__ __forceinline__ uint32_t mix32(uint32_t h) {
  h ^= h >> 16;
  h *= kM1;
  h ^= h >> 13;
  h *= kM2;
  h ^= h >> 16;
  return h;
}

__device__ __forceinline__ uint32_t low_mask(int bits) {
  return bits >= 32 ? 0xFFFFFFFFu : ((1u << bits) - 1u);
}

// hashtable.py `kmer_hash` / `kmer_hash2`
__device__ __forceinline__ uint32_t kmer_hash(uint32_t hi, uint32_t lo) {
  return mix32(lo + hi * kGold);
}

__device__ __forceinline__ uint32_t kmer_hash2(uint32_t hi, uint32_t lo) {
  return mix32(((lo ^ kGold2) + hi * kM2) ^ 0x5BD1E995u);
}

// hashtable.py `_feistel_halves`: 4-round Feistel over two k-bit halves.
__device__ __forceinline__ void feistel(uint32_t hi, uint32_t lo, int k,
                                        uint32_t& a, uint32_t& b) {
  const uint32_t kmask = (1u << k) - 1u;  // k <= 31
  a = ((hi << (32 - k)) | (lo >> k)) & kmask;
  b = lo & kmask;
  a ^= mix32(b * kM1 + 0x9E3779B9u) & kmask;
  b ^= mix32(a * kM1 + 0x85EBCA6Bu) & kmask;
  a ^= mix32(b * kM1 + 0xC2B2AE35u) & kmask;
  b ^= mix32(a * kM1 + 0x27D4EB2Fu) & kmask;
}

// hashtable.py `_quot_bucket_q`: home bucket b1 and quotient q.
__device__ __forceinline__ void quot_bucket_q(uint32_t hi, uint32_t lo,
                                              int k, int bbits,
                                              uint32_t& b1, uint32_t& q) {
  uint32_t a, b;
  feistel(hi, lo, k, a, b);
  if (bbits <= k) {
    b1 = b & low_mask(bbits);
    q = bbits == k ? a : ((b >> bbits) | (a << (k - bbits)));
  } else {
    b1 = (b | (a << k)) & low_mask(bbits);
    q = a >> (bbits - k);
  }
}

// hashtable.py `_quot_alt`: b1 ^ (fmix32(q * GOLD) | 1), masked.
__device__ __forceinline__ uint32_t quot_alt(uint32_t b1, uint32_t q,
                                             int bbits) {
  return b1 ^ ((mix32(q * kGold) | 1u) & low_mask(bbits));
}

__device__ __forceinline__ uint32_t quot_slot(uint32_t w, uint32_t q,
                                              uint32_t rnd) {
  return ((w & kQMask) == q && ((w >> 29) & 1u) == rnd) ? (w >> 30) : 0u;
}

__device__ __forceinline__ uint32_t full_slot(uint32_t shi, uint32_t slo,
                                              uint32_t hi, uint32_t lo) {
  return ((shi & kHiMask) == hi && slo == lo) ? (shi >> 30) : 0u;
}

__device__ __forceinline__ uint32_t max4(uint32_t a, uint32_t b, uint32_t c,
                                         uint32_t d) {
  return max(max(a, b), max(c, d));
}

struct Table {
  const uint4* rows;
  uint32_t n_buckets;
  int bbits;      // log2(n_buckets)
  int fmt;        // TableFormat
  int k;
  int max_probe;  // hash choices of the full format (2)
};

// The two bucket choices of a canonical key and what a slot of either
// row is tested against: the quotient (quot) or the key's halves (full).
// Split from the test so that a kernel can issue the row loads of
// several keys before it tests any.
struct ProbeRows {
  uint32_t b[2];
  uint32_t q, hi, lo;
};

__device__ __forceinline__ ProbeRows probe_rows(const Table& t,
                                                uint64_t key) {
  ProbeRows a;
  a.hi = static_cast<uint32_t>(key >> 32);
  a.lo = static_cast<uint32_t>(key);
  a.q = 0;
  if (t.fmt == kQuot) {
    quot_bucket_q(a.hi, a.lo, t.k, t.bbits, a.b[0], a.q);
    a.b[1] = quot_alt(a.b[0], a.q, t.bbits);
  } else {
    const uint32_t mask = t.n_buckets - 1u;
    a.b[0] = kmer_hash(a.hi, a.lo) & mask;
    a.b[1] = kmer_hash2(a.hi, a.lo) & mask;
  }
  return a;
}

// The payload from the rows r1 (bucket b[0]) and r2 (b[1]); a row whose
// own flag is false adds nothing.  The result is the OR over the two
// bucket choices of the max over the row's matching slots, as the JAX
// probes compute it.
__device__ __forceinline__ int probe_hit(const Table& t, const ProbeRows& a,
                                         const uint4& r1, const uint4& r2,
                                         bool own0, bool own1) {
  if (t.fmt == kQuot) {
    const uint32_t p1 = own0 ? max4(quot_slot(r1.x, a.q, 0),
                                    quot_slot(r1.y, a.q, 0),
                                    quot_slot(r1.z, a.q, 0),
                                    quot_slot(r1.w, a.q, 0)) : 0u;
    const uint32_t p2 = own1 ? max4(quot_slot(r2.x, a.q, 1),
                                    quot_slot(r2.y, a.q, 1),
                                    quot_slot(r2.z, a.q, 1),
                                    quot_slot(r2.w, a.q, 1)) : 0u;
    return static_cast<int>(p1 | p2);
  }
  uint32_t res = own0 ? max(full_slot(r1.x, r1.y, a.hi, a.lo),
                            full_slot(r1.z, r1.w, a.hi, a.lo)) : 0u;
  if (t.max_probe > 1 && own1)
    res |= max(full_slot(r2.x, r2.y, a.hi, a.lo),
               full_slot(r2.z, r2.w, a.hi, a.lo));
  return static_cast<int>(res);
}

// Payload (0..3) of one canonical key on a slice of the table: t.rows
// holds rows [row_lo, row_lo + n_rows) of the t.n_buckets-row table
// (the hashes use the whole table's n_buckets and bbits), and a bucket
// outside the slice adds nothing, as hast_tpu/parallel/mesh.py
// `_probe_local` masks the buckets another tp shard owns.  Both row
// loads issue before either row is looked at.
__device__ __forceinline__ int probe_key_owned(const Table& t, uint64_t key,
                                               uint32_t row_lo,
                                               uint32_t n_rows) {
  const ProbeRows a = probe_rows(t, key);
  const uint4 none = make_uint4(0u, 0u, 0u, 0u);
  // a bucket below row_lo wraps past n_rows, so one compare tests both ends
  const bool own0 = a.b[0] - row_lo < n_rows;
  const bool own1 = a.b[1] - row_lo < n_rows;
  const uint4 r1 = own0 ? __ldg(t.rows + (a.b[0] - row_lo)) : none;
  const uint4 r2 = own1 ? __ldg(t.rows + (a.b[1] - row_lo)) : none;
  return probe_hit(t, a, r1, r2, own0, own1);
}

// Payload (0..3) of one canonical key in the whole table.
__device__ __forceinline__ int probe_key(const Table& t, uint64_t key) {
  return probe_key_owned(t, key, 0u, t.n_buckets);
}

}  // namespace hast

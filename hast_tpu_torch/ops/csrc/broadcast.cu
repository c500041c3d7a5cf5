// K16 `broadcast_probe`: membership payload of each query by a broadcast
// join against a small full-format table.
//
// Replaces docs/experimental/probe_pallas.py `pallas_broadcast_probe` (body
// `_broadcast_probe_kernel`): for each query q the maximum over the table
// slots s of thi[s] >> 30 where (thi[s] & 0x3FFFFFFF) == q_hi and
// tlo[s] == q_lo, 0 if no slot matches.  The maximum, not the OR: a caller
// may pass the same key twice with two payloads.
//
// The Pallas kernel walks the table as its sequential grid and keeps the
// whole query block resident.  Here the queries are the parallel
// dimension: a block holds 1,024 queries in registers (4 a thread) and
// walks the table in tiles of 2,048 slots staged in shared memory, masked
// hi, lo and payload apart.  Every thread reads the same shared address at
// a step, a broadcast with no bank conflict, as 16-byte vectors of four
// slots.  The tail of the last tile is filled with payload-0 slots, which
// add nothing to a maximum, so the inner loop needs no bound test.
//
// JAX pads the table with EMPTY = 0xFFFFFFFF slots to a multiple of its
// chunk.  A pad slot matches only the query (0x3FFFFFFF, 0xFFFFFFFF), with
// payload 3; the kernel compares no pad slot and gives that query 3 when
// pad_hit (n % chunk != 0) says a pad exists.
//
// What bounds it on an H100: operations.  Each (query, slot) pair costs
// two compares and a maximum predicated on them (the key mask and the
// payload shift are done once a slot, at staging), so the work grows with
// queries x slots, while the bytes are the table and the queries read
// once.  Past a few tens of slots the gather probe K2 (two 16-byte rows a
// query) is faster; `cp.async` double buffering and a sorted table are
// for later.
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr int kPerThread = 4;                  // queries held in registers
constexpr int kQueries = kThreads * kPerThread;  // queries a block
constexpr int kTile = 2048;                    // table slots a tile
constexpr uint32_t kHiMask = 0x3FFFFFFFu;
constexpr uint32_t kEmpty = 0xFFFFFFFFu;

__device__ __forceinline__ int hit(uint32_t sh, uint32_t sl, int sp,
                                   uint32_t qh, uint32_t ql) {
  return (sh == qh && sl == ql) ? sp : 0;
}

__global__ void __launch_bounds__(kThreads)
    broadcast_probe_kernel(const uint32_t* __restrict__ thi,
                           const uint32_t* __restrict__ tlo, int64_t n,
                           const uint32_t* __restrict__ qhi,
                           const uint32_t* __restrict__ qlo, int64_t q,
                           int pad_hit, int32_t* __restrict__ out) {
  __shared__ __align__(16) uint32_t s_hi[kTile];
  __shared__ __align__(16) uint32_t s_lo[kTile];
  __shared__ __align__(16) int s_pay[kTile];

  const int64_t base = static_cast<int64_t>(blockIdx.x) * kQueries;
  uint32_t my_hi[kPerThread];
  uint32_t my_lo[kPerThread];
  int best[kPerThread];
#pragma unroll
  for (int j = 0; j < kPerThread; ++j) {
    // lanes past q compare a zero key and write nothing
    const int64_t i = base + j * kThreads + threadIdx.x;
    my_hi[j] = i < q ? qhi[i] : 0u;
    my_lo[j] = i < q ? qlo[i] : 0u;
    best[j] = 0;
  }

  for (int64_t t0 = 0; t0 < n; t0 += kTile) {
    const int64_t rem = n - t0;
    const int count = rem < kTile ? static_cast<int>(rem) : kTile;
    const int padded = (count + 3) & ~3;
    __syncthreads();  // every thread is done with the previous tile
    for (int s = threadIdx.x; s < padded; s += kThreads) {
      if (s < count) {
        const uint32_t h = thi[t0 + s];
        s_hi[s] = h & kHiMask;
        s_lo[s] = tlo[t0 + s];
        s_pay[s] = static_cast<int>(h >> 30);
      } else {
        s_hi[s] = 0u;
        s_lo[s] = 0u;
        s_pay[s] = 0;
      }
    }
    __syncthreads();
    for (int s = 0; s < padded; s += 4) {
      const uint4 h = *reinterpret_cast<const uint4*>(s_hi + s);
      const uint4 l = *reinterpret_cast<const uint4*>(s_lo + s);
      const int4 p = *reinterpret_cast<const int4*>(s_pay + s);
#pragma unroll
      for (int j = 0; j < kPerThread; ++j) {
        int b = best[j];
        b = max(b, hit(h.x, l.x, p.x, my_hi[j], my_lo[j]));
        b = max(b, hit(h.y, l.y, p.y, my_hi[j], my_lo[j]));
        b = max(b, hit(h.z, l.z, p.z, my_hi[j], my_lo[j]));
        b = max(b, hit(h.w, l.w, p.w, my_hi[j], my_lo[j]));
        best[j] = b;
      }
    }
  }

#pragma unroll
  for (int j = 0; j < kPerThread; ++j) {
    const int64_t i = base + j * kThreads + threadIdx.x;
    if (i < q) {
      const bool pad_key = my_hi[j] == kHiMask && my_lo[j] == kEmpty;
      out[i] = (pad_hit && pad_key) ? 3 : best[j];
    }
  }
}

}  // namespace

// table hi/lo (n,) and queries hi/lo (q,) uint32 bits -> out (q,) int32
// payloads; pad_hit != 0 when the JAX function would pad the table.
extern "C" int hast_broadcast_probe(const void* table_hi, const void* table_lo,
                                    int64_t n, const void* q_hi,
                                    const void* q_lo, int64_t q, int pad_hit,
                                    void* out, void* stream) {
  const int64_t blocks = (q + kQueries - 1) / kQueries;
  if (blocks == 0) {
    return static_cast<int>(cudaGetLastError());
  }
  broadcast_probe_kernel<<<static_cast<unsigned>(blocks), kThreads, 0,
                           static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(table_hi),
      static_cast<const uint32_t*>(table_lo), n,
      static_cast<const uint32_t*>(q_hi), static_cast<const uint32_t*>(q_lo),
      q, pad_hit, static_cast<int32_t*>(out));
  return static_cast<int>(cudaGetLastError());
}

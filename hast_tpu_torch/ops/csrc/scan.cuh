// Device-wide exclusive scan in three launches (markers.cu's kernels),
// and the block-wide scan under it (also used by sort.cu, whose
// one-sweep passes scan their digits within a block).
//
// Replaces the sort-based compaction of hast_tpu/ops/kmer_count.py
// `_compact_kernel` (fold.cu's group ids come from its own one-pass
// scan).
//
// What bounds it on an H100: memory traffic -- each element is read
// twice (reduce, apply) and its consumer writes once; the middle launch
// scans one value per 4,096-element tile in a single block, which is
// microseconds at the sizes of the stage-00 folds (<= 2^28 elements,
// 65,536 tiles).  The design keeps the scan generic over a value functor
// (what is summed: a keep flag) and
// an emit functor (what is done with element i's exclusive prefix), so
// no flag or prefix array is materialised between the launches.  Every
// thread of a block calls emit, with ok = false past the end, so an
// emitter may use warp-wide intrinsics.
#pragma once

#include <cuda_runtime.h>

#include <cstdint>

namespace hast {

constexpr int kScanThreads = 256;
constexpr int kScanItems = 16;
constexpr int kScanTile = kScanThreads * kScanItems;

inline int64_t scan_tiles(int64_t n) {
  return (n + kScanTile - 1) / kScanTile;
}

// Exclusive scan of one value per thread across the block; *total gets
// the block's sum.  Every thread of the block must call it.
__device__ __forceinline__ long long block_exclusive_scan(long long v,
                                                          long long* total) {
  __shared__ long long warp_sums[32];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int n_warps = blockDim.x >> 5;
  long long x = v;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const long long y = __shfl_up_sync(0xFFFFFFFFu, x, off);
    if (lane >= off) x += y;
  }
  if (lane == 31) warp_sums[warp] = x;
  __syncthreads();
  if (warp == 0) {
    long long s = lane < n_warps ? warp_sums[lane] : 0;
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const long long y = __shfl_up_sync(0xFFFFFFFFu, s, off);
      if (lane >= off) s += y;
    }
    if (lane < n_warps) warp_sums[lane] = s;
  }
  __syncthreads();
  const long long warp_prefix = warp ? warp_sums[warp - 1] : 0;
  *total = warp_sums[n_warps - 1];
  __syncthreads();  // warp_sums is reused by the next call
  return warp_prefix + x - v;
}

template <typename Val>
__global__ void scan_reduce_kernel(Val val, int64_t n,
                                   long long* tile_sums) {
  const int64_t base = static_cast<int64_t>(blockIdx.x) * kScanTile;
  long long s = 0;
  for (int r = 0; r < kScanItems; ++r) {
    const int64_t i = base + r * kScanThreads + threadIdx.x;
    if (i < n) s += val(i);
  }
  long long total;
  block_exclusive_scan(s, &total);
  if (threadIdx.x == 0) tile_sums[blockIdx.x] = total;
}

// One block: tile sums -> their exclusive prefixes; the grand total goes
// to tile_sums[n_tiles].  Internal linkage: every translation unit that
// includes this header gets its own copy.
static __global__ void scan_tiles_kernel(long long* tile_sums,
                                         int64_t n_tiles) {
  long long carry = 0;
  for (int64_t b = 0; b < n_tiles; b += kScanThreads) {
    const int64_t i = b + threadIdx.x;
    const long long v = i < n_tiles ? tile_sums[i] : 0;
    long long total;
    const long long ex = block_exclusive_scan(v, &total);
    if (i < n_tiles) tile_sums[i] = carry + ex;
    carry += total;
  }
  if (threadIdx.x == 0) tile_sums[n_tiles] = carry;
}

template <typename Val, typename Emit>
__global__ void scan_apply_kernel(Val val, Emit emit, int64_t n,
                                  const long long* tile_sums) {
  const int64_t base = static_cast<int64_t>(blockIdx.x) * kScanTile;
  long long carry = tile_sums[blockIdx.x];
  for (int r = 0; r < kScanItems; ++r) {
    const int64_t i = base + r * kScanThreads + threadIdx.x;
    const bool ok = i < n;
    const long long v = ok ? val(i) : 0;
    long long total;
    const long long ex = block_exclusive_scan(v, &total);
    emit(i, carry + ex, v, ok);
    carry += total;
  }
}

// emit(i, exclusive prefix of val over [0, i), val(i), i < n) for every
// i, in three launches on stream s.  tile_sums holds scan_tiles(n) + 1
// values; the last one is the total.
template <typename Val, typename Emit>
cudaError_t device_scan(Val val, Emit emit, int64_t n, long long* tile_sums,
                        cudaStream_t s) {
  const int64_t n_tiles = scan_tiles(n);
  if (n_tiles > 0)
    scan_reduce_kernel<<<static_cast<unsigned>(n_tiles), kScanThreads, 0,
                         s>>>(val, n, tile_sums);
  scan_tiles_kernel<<<1, kScanThreads, 0, s>>>(tile_sums, n_tiles);
  if (n_tiles > 0)
    scan_apply_kernel<<<static_cast<unsigned>(n_tiles), kScanThreads, 0,
                        s>>>(val, emit, n, tile_sums);
  return cudaGetLastError();
}

}  // namespace hast

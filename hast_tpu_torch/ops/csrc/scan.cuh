// The block-wide exclusive scan of sort.cu, whose one-sweep passes scan
// their digit counts within a block (markers.cu and fold.cu scan within
// their tiles with named barriers of their own, since their look-back
// warps do not take part).
//
// What bounds it on an H100: two rounds of warp shuffles and two
// barriers; it runs once a tile, on values already in registers.
#pragma once

#include <cuda_runtime.h>

#include <cstdint>

namespace hast {

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

}  // namespace hast

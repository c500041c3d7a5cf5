// K8 `marker_filter`: the stage-00 marker algebra for one parent, x,
// against the other, y: keep = key absent from y, real, and
// lower <= count <= upper; the kept keys go to the front, ascending, and
// their number is the scan total.
//
// Replaces hast_tpu/ops/kmer_count.py `_unique_filter_kernel` and
// `_compact_kernel` (the wrapper calls it once for each parent).  Both
// runs are sorted and distinct, so no sort is needed: each x row
// binary-searches the first y_n keys of y.  Sentinel rows are masked
// explicitly, as the JAX kernel does, so lower = 0 cannot keep a pad.  A
// stable scan of the keep flags (scan.cuh) gives each kept key its slot,
// so the output stays ascending; every other slot is INT64_MAX.
//
// What bounds it on an H100: the binary search, about log2(y_n) dependent
// 8-byte reads per row (27 at 1.5e8 keys), the upper levels of which stay
// in L2; the scan and the scatter are streaming.  The search runs once
// per row (the first launch stores the keep flags as bytes), not once in
// each of the scan's two passes.
#include <cuda_runtime.h>

#include <cstdint>

#include "scan.cuh"

namespace {

constexpr int64_t kSent = INT64_MAX;

__device__ __forceinline__ bool contains(const int64_t* __restrict__ y,
                                         int64_t n, int64_t key) {
  int64_t lo = 0, hi = n;
  while (lo < hi) {
    const int64_t mid = (lo + hi) >> 1;
    if (y[mid] < key)
      lo = mid + 1;
    else
      hi = mid;
  }
  return lo < n && y[lo] == key;
}

__global__ void keep_kernel(const int64_t* __restrict__ x_keys,
                            const int32_t* __restrict__ x_counts,
                            int64_t x_len, const int64_t* __restrict__ y_keys,
                            int64_t y_n, long long lower, long long upper,
                            uint8_t* __restrict__ keep,
                            int64_t* __restrict__ out) {
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  for (int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x +
                   threadIdx.x;
       i < x_len; i += stride) {
    const int64_t key = x_keys[i];
    const long long c = x_counts[i];
    keep[i] = (key != kSent && c >= lower && c <= upper &&
               !contains(y_keys, y_n, key)) ? 1 : 0;
    out[i] = kSent;
  }
}

struct KeepVal {
  const uint8_t* keep;
  __device__ long long operator()(int64_t i) const { return keep[i]; }
};

struct CompactEmit {
  const int64_t* keys;
  int64_t* out;
  __device__ void operator()(int64_t i, long long slot, long long kept,
                             bool ok) const {
    if (ok && kept) out[slot] = keys[i];
  }
};

}  // namespace

// x_keys (x_len,) int64 ascending with its counts (x_len,) int32; y_keys
// ascending, its first y_n real -> out (x_len,) int64, the number kept in
// tile_sums[scan_tiles(x_len)]; keep (x_len,) uint8 and tile_sums
// (scan_tiles(x_len) + 1,) int64 are scratch.
extern "C" int hast_marker_filter(const void* x_keys, const void* x_counts,
                                  int64_t x_len, const void* y_keys,
                                  int64_t y_n, long long lower,
                                  long long upper, void* keep,
                                  void* tile_sums, void* out,
                                  void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int64_t* xk = static_cast<const int64_t*>(x_keys);
  uint8_t* kp = static_cast<uint8_t*>(keep);
  int64_t* o = static_cast<int64_t*>(out);
  const int64_t want = (x_len + 255) / 256;
  if (want > 0)
    keep_kernel<<<static_cast<unsigned>(want < 65536 ? want : 65536), 256,
                  0, s>>>(xk, static_cast<const int32_t*>(x_counts), x_len,
                          static_cast<const int64_t*>(y_keys), y_n, lower,
                          upper, kp, o);
  const cudaError_t e =
      hast::device_scan(KeepVal{kp}, CompactEmit{xk, o}, x_len,
                        static_cast<long long*>(tile_sums), s);
  return static_cast<int>(e);
}

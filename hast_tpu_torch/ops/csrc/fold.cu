// K6 `fold_runs`: sum the counts of equal keys of a sorted run into the
// front slots.
//
// Replaces the body of hast_tpu/ops/kmer_count.py `_merge_rle_kernel`
// after its sort (K5 does the sort).  Group g is the g-th distinct key in
// order: a start flag where a key differs from its predecessor, and an
// inclusive scan of the flags (scan.cuh) gives each element its group.
// out_key[g] is the group's key and out_count[g] the int32 sum of its
// counts; the sentinel group (INT64_MAX, the invalid-window pads) keeps
// its key with count 0, every other slot is (INT64_MAX, 0), and
// n_unique counts the groups that are not the sentinel.
//
// What bounds it on an H100: memory traffic (the keys are read four
// times: flag and neighbour, in the reduce and the apply launch) and, on
// duplicate-heavy runs, atomics on one address.  The design sums a group
// inside each warp first (__match_any_sync on the group id, then
// __reduce_add_sync), so a group costs one int32 atomic per warp it
// spans; integer atomics give the same sums in any order, so the result
// is exact and equals the twin's bit for bit.
#include <cuda_runtime.h>

#include <cstdint>

#include "scan.cuh"

namespace {

constexpr int64_t kSent = INT64_MAX;

__global__ void fill_kernel(int64_t* __restrict__ out_keys,
                            int32_t* __restrict__ out_counts, int64_t n) {
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  for (int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x +
                   threadIdx.x;
       i < n; i += stride) {
    out_keys[i] = kSent;
    out_counts[i] = 0;
  }
}

struct StartFlag {
  const int64_t* keys;
  __device__ long long operator()(int64_t i) const {
    return (i == 0 || keys[i] != keys[i - 1]) ? 1 : 0;
  }
};

struct FoldEmit {
  const int64_t* keys;
  const int32_t* counts;
  int64_t* out_keys;
  int32_t* out_counts;
  __device__ void operator()(int64_t i, long long prefix, long long start,
                             bool ok) const {
    const int lane = threadIdx.x & 31;
    // past the end: a group id of its own, so no lane joins it
    const long long g = ok ? prefix + start - 1 : -1 - lane;
    int c = 0;
    if (ok) {
      const int64_t key = keys[i];
      if (start) out_keys[g] = key;
      if (key != kSent) c = counts[i];
    }
    const unsigned peers = __match_any_sync(0xFFFFFFFFu, g);
    const int sum = __reduce_add_sync(peers, c);
    const bool leader = (peers & ((1u << lane) - 1u)) == 0;
    if (ok && leader && sum != 0) atomicAdd(&out_counts[g], sum);
  }
};

// groups (the scan total) less the sentinel group, if the run has one
__global__ void n_unique_kernel(const long long* groups,
                                const int64_t* keys, int64_t n,
                                int64_t* n_unique) {
  *n_unique = *groups - ((n > 0 && keys[n - 1] == kSent) ? 1 : 0);
}

}  // namespace

// keys (n,) int64 ascending, counts (n,) int32 -> out_keys (n,) int64,
// out_counts (n,) int32, n_unique () int64; tile_sums
// (scan_tiles(n) + 1,) int64.
extern "C" int hast_fold_runs(const void* keys, const void* counts,
                              int64_t n, void* out_keys, void* out_counts,
                              void* n_unique, void* tile_sums,
                              void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int64_t* k = static_cast<const int64_t*>(keys);
  int64_t* ok = static_cast<int64_t*>(out_keys);
  int32_t* oc = static_cast<int32_t*>(out_counts);
  long long* ts = static_cast<long long*>(tile_sums);
  const int64_t want = (n + 255) / 256;
  if (want > 0)
    fill_kernel<<<static_cast<unsigned>(want < 65536 ? want : 65536), 256,
                  0, s>>>(ok, oc, n);
  const cudaError_t e = hast::device_scan(
      StartFlag{k},
      FoldEmit{k, static_cast<const int32_t*>(counts), ok, oc}, n, ts, s);
  if (e != cudaSuccess) return static_cast<int>(e);
  n_unique_kernel<<<1, 1, 0, s>>>(ts + hast::scan_tiles(n), k, n,
                                  static_cast<int64_t*>(n_unique));
  return static_cast<int>(cudaGetLastError());
}

// A cloud split into contiguous index ranges, one warp a range, staged
// through shared memory: the layout shared by the ball query (ballquery.cu)
// and the 3-NN search (threenn.cu).
//
// Range q holds the points [q * len, min((q + 1) * len, n)). A block walks
// them in tiles: tile t0 holds, for every range q, its points
// q * len + t0 + [0, chunk) at tile[q * chunk ...], so each warp reads its
// own range in index order, tile after tile, and every point of the cloud is
// read by exactly one warp of the block. The host plan
// (kernels/ballquery_cuda.py::ballquery_plan, kernels/threenn_cuda.py::
// three_nn_plan) picks the ranges, the chunk (a power of two, at least 32)
// and the groups of 32 lanes a block.
#pragma once

#include "common.cuh"

namespace pn12 {

// the largest block of either kernel: 16 warps (the plans keep ranges *
// groups <= 16)
constexpr int kMaxRangeThreads = 512;

// +inf, the coordinates of a pad slot: every distance to it is +inf or
// NaN, so it is never in a radius and never below a finite distance
__device__ __forceinline__ float pad_coordinate() {
  return __int_as_float(0x7f800000);
}

// Stage tile `t0` of every range of `cloud` ((n, 3) f32) into `tile` as
// float4 records (x, y, z, unused), one 16-byte shared load a point for the
// scan; the slots past a range's end are pads. The coordinates travel by
// asynchronous 4-byte copies, all in flight at once, so a thread waits for
// one round trip to L2, not one a point. The whole block calls it; a
// __syncthreads after it makes the tile visible.
__device__ __forceinline__ void stage_ranges(float4* tile,
                                             const float* __restrict__ cloud,
                                             int n, int ranges, int len,
                                             int chunk_shift, int t0) {
  const int chunk = 1 << chunk_shift;
  const int total = ranges << chunk_shift;
  for (int j = threadIdx.x; j < total; j += blockDim.x) {
    const int off = t0 + (j & (chunk - 1));
    const int i = (j >> chunk_shift) * len + off;
    if (off < len && i < n) {
      const float* pt = cloud + 3 * static_cast<size_t>(i);
      float* dst = reinterpret_cast<float*>(tile + j);
      cp_async4(dst, pt, true);
      cp_async4(dst + 1, pt + 1, true);
      cp_async4(dst + 2, pt + 2, true);
    } else {
      const float pad = pad_coordinate();
      tile[j] = make_float4(pad, pad, pad, 0.0f);
    }
  }
  cp_async_commit();
  cp_async_wait<0>();
}

// Whether a plan's launch shape is one the kernels take: ranges and groups
// positive, ranges * groups warps within kMaxRangeThreads, the ranges
// covering n points, a chunk of 32 to 2^20 points.
inline bool valid_ranges(int n, int ranges, int groups, int len,
                         int chunk_shift) {
  return ranges > 0 && groups > 0 &&
         ranges * groups * 32 <= kMaxRangeThreads && len > 0 &&
         static_cast<long long>(ranges) * len >= n && chunk_shift >= 5 &&
         chunk_shift <= 20;
}

}  // namespace pn12

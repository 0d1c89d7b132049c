// Three nearest reference points of every query point.
//
// Replaces: pointnet12_tpu/kernels/threenn_pallas.py::three_nn_pallas
// (_three_nn_kernel, the default mxu=False direct form).
// Contract: the 3 smallest squared distances in ascending order and their
// indices; equal distances go to the lower index first.
//
// What bounds it: the pairs' arithmetic. Every query visits all M
// references, a distance (8 flops, rounded after each) and a compare a
// pair; the (B, N, M) distance matrix is never written, so device memory
// sees only the inputs and the (B, N, 3) outputs.
//
// Design (the layout of ranges.cuh):
// - the references are staged in shared memory as float4 records, one
//   broadcast 16-byte load a reference for a warp's 32 queries, a lane
//   each (two a lane, tried, was slower at every slice shape).
// - the first 32 references go through the exact insertion one by one.
//   After them, a 32-reference chunk is tested against each query's third
//   distance, frozen for the chunk, into one word of flags: straight-line
//   code whose pairs overlap. The flagged references (few) then go
//   through the insertion in ascending index order, a candidate displacing
//   a kept one only when strictly smaller: the sequential scan's result,
//   ties to the lower index.
// - the references are split into `ranges` contiguous ranges, one warp a
//   range, so the small levels fill the card. Each (query, range) keeps its
//   best three in registers; a merge through shared memory orders the
//   ranges' candidates by (d2, index), which is the sequential scan's
//   order, ties across ranges included.
// kernels/threenn_cuda.py::three_nn_in_plan_order models this order in
// plain ops.
#include <math_constants.h>

#include "ranges.cuh"

namespace {

struct Best3 {
  float d0, d1, d2;
  int i0, i1, i2;
};

__device__ __forceinline__ void reset(Best3& t, int m) {
  t.d0 = t.d1 = t.d2 = CUDART_INF_F;
  t.i0 = t.i1 = t.i2 = m;  // a placeholder past every reference
}

// the sequential scan's step: d displaces a kept entry only when strictly
// smaller, so of equal distances the earlier (lower) index stays in front
__device__ __forceinline__ void insert(Best3& t, float d, int j) {
  if (!(d < t.d2)) return;
  if (d < t.d1) {
    t.d2 = t.d1;
    t.i2 = t.i1;
    if (d < t.d0) {
      t.d1 = t.d0;
      t.i1 = t.i0;
      t.d0 = d;
      t.i0 = j;
    } else {
      t.d1 = d;
      t.i1 = j;
    }
  } else {
    t.d2 = d;
    t.i2 = j;
  }
}

// the merge's step: order by (d2, index)
__device__ __forceinline__ bool before(float d, int j, float dk, int ik) {
  return d < dk || (d == dk && j < ik);
}

__device__ __forceinline__ void insert_ordered(Best3& t, float d, int j) {
  if (!before(d, j, t.d2, t.i2)) return;
  if (before(d, j, t.d1, t.i1)) {
    t.d2 = t.d1;
    t.i2 = t.i1;
    if (before(d, j, t.d0, t.i0)) {
      t.d1 = t.d0;
      t.i1 = t.i0;
      t.d0 = d;
      t.i0 = j;
    } else {
      t.d1 = d;
      t.i1 = j;
    }
  } else {
    t.d2 = d;
    t.i2 = j;
  }
}

__device__ __forceinline__ void store(const Best3& t, float* dist, int* idx,
                                      size_t q) {
  dist[3 * q + 0] = t.d0;
  dist[3 * q + 1] = t.d1;
  dist[3 * q + 2] = t.d2;
  idx[3 * q + 0] = t.i0;
  idx[3 * q + 1] = t.i1;
  idx[3 * q + 2] = t.i2;
}

// A block: `groups` groups of 32 queries of one cloud, each group's warps
// one a reference range. Shared memory: the reference tile, then
// (ranges > 1) the candidates, d2 and index planes of ranges * 3 * the
// block's queries.
__global__ void __launch_bounds__(pn12::kMaxRangeThreads, 2)
    three_nn_kernel(const float* __restrict__ query,
                    const float* __restrict__ ref, float* __restrict__ dist,
                    int* __restrict__ idx, int n, int m, int ranges,
                    int groups, int len, int chunk_shift) {
  extern __shared__ float4 tile[];
  const int per_block = groups * 32;
  float* cand_d = reinterpret_cast<float*>(tile + (ranges << chunk_shift));
  int* cand_i = reinterpret_cast<int*>(cand_d + ranges * 3 * per_block);
  const int cloud_blocks = (n + per_block - 1) / per_block;
  const int b = blockIdx.x / cloud_blocks;
  const int q0 = (blockIdx.x - b * cloud_blocks) * per_block;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = warp / ranges, p = warp - g * ranges;
  const int ql = g * 32 + lane;  // this lane's query in the block
  const float* cloud = ref + static_cast<size_t>(b) * m * 3;

  float qx = __int_as_float(0x7fffffff), qy = qx, qz = qx;  // NaN: no candidate
  if (q0 + ql < n) {
    const float* pq = query + (static_cast<size_t>(b) * n + q0 + ql) * 3;
    qx = pq[0];
    qy = pq[1];
    qz = pq[2];
  }
  Best3 best;
  reset(best, m);

  const int lo = p * len, hi = min(lo + len, m);
  for (int t0 = 0; t0 < len; t0 += 1 << chunk_shift) {
    __syncthreads();  // the previous tile is no longer read
    pn12::stage_ranges(tile, cloud, m, ranges, len, chunk_shift, t0);
    __syncthreads();
    const int count = min(1 << chunk_shift, hi - lo - t0);
    const float4* pts = tile + (p << chunk_shift);
    for (int j0 = 0; j0 < count; j0 += 32) {
      if (t0 == 0 && j0 == 0) {
        // the first chunk: every reference would pass an infinite third
        // distance, so insert them in turn
#pragma unroll 4
        for (int u = 0; u < min(count, 32); ++u) {
          const float4 v = pts[u];
          insert(best, pn12::direct_sq_dist(qx, qy, qz, v.x, v.y, v.z), lo + u);
        }
        continue;
      }
      unsigned flagged = 0u;
#pragma unroll
      for (int u = 0; u < 32; ++u) {
        const float4 v = pts[j0 + u];
        const float d = pn12::direct_sq_dist(qx, qy, qz, v.x, v.y, v.z);
        flagged |= (d < best.d2 ? 1u : 0u) << u;
      }
      while (flagged != 0u) {
        const int u = __ffs(flagged) - 1;
        flagged &= flagged - 1u;
        const float4 v = pts[j0 + u];
        insert(best, pn12::direct_sq_dist(qx, qy, qz, v.x, v.y, v.z), lo + t0 + j0 + u);
      }
    }
  }

  if (ranges == 1) {
    if (q0 + ql < n) store(best, dist, idx, static_cast<size_t>(b) * n + q0 + ql);
    return;
  }
  const int at = p * 3 * per_block + ql;
  cand_d[at] = best.d0;
  cand_d[at + per_block] = best.d1;
  cand_d[at + 2 * per_block] = best.d2;
  cand_i[at] = best.i0;
  cand_i[at + per_block] = best.i1;
  cand_i[at + 2 * per_block] = best.i2;
  __syncthreads();
  for (int q = threadIdx.x; q < per_block && q0 + q < n; q += blockDim.x) {
    Best3 t;
    reset(t, m);
    for (int e = 0; e < ranges * 3; ++e) {
      insert_ordered(t, cand_d[e * per_block + q], cand_i[e * per_block + q]);
    }
    store(t, dist, idx, static_cast<size_t>(b) * n + q0 + q);
  }
}

}  // namespace

// query (B, N, 3) f32, ref (B, M, 3) f32 with M >= 3
//   -> dist (B, N, 3) f32 ascending, idx (B, N, 3) i32.
// ranges, groups, len and chunk_shift are the plan's
// (kernels/threenn_cuda.py::three_nn_plan); smem its shared bytes.
PN12_API int pn12_three_nn(const float* query, const float* ref, float* dist,
                           int* idx, int b, int n, int m, int ranges,
                           int groups, int len, int chunk_shift, int smem,
                           void* stream) {
  if (b <= 0 || n <= 0 || m < 3 ||
      !pn12::valid_ranges(m, ranges, groups, len, chunk_shift)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const long long need =
      (static_cast<long long>(ranges) << chunk_shift) * 16 +
      (ranges > 1 ? 2LL * ranges * 3 * groups * 32 * 4 : 0LL);
  if (smem != need) return static_cast<int>(cudaErrorInvalidValue);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        three_nn_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const int per_block = groups * 32;
  const long long blocks =
      static_cast<long long>(b) * ((n + per_block - 1) / per_block);
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  three_nn_kernel<<<static_cast<unsigned>(blocks), ranges * groups * 32, smem,
                    pn12::as_stream(stream)>>>(query, ref, dist, idx, n, m,
                                               ranges, groups, len, chunk_shift);
  return static_cast<int>(cudaGetLastError());
}

// Ball query: the first K point indices within radius of each center.
//
// Replaces both Pallas ball-query kernels on the serving path:
//   pointnet12_tpu/kernels/ballquery_bitmask.py::ballquery_bitmask
//     (_kernel_2d, _kernel_1d, _tile_out), and
//   pointnet12_tpu/kernels/ballquery_pallas.py::ballquery_pallas
//     (_ballquery_kernel, _inclusive_rank).
// Contract: the first K indices i in ascending order with d2(i) <= r^2,
// the unfilled slots repeating the first of them; a center with no point
// in radius gets N in every slot (as ops/ballquery.py::_ballquery_jnp).
// r^2 arrives already rounded to f32 by the wrapper, as `radius * radius`
// is in JAX.
//
// What bounds it: the pairs' arithmetic. At the model's first level the
// scan never stops early (a center holds ~15 points of 4096), so every
// (center, point) pair costs a distance (8 flops, rounded after each) and a
// compare; the cloud (<= 64 KB at the slice) sits in shared memory and
// device memory sees only the inputs and the (B, S, K) indices.
//
// Design (the layout of ranges.cuh; the host plan, kernels/ballquery_cuda.py::
// ballquery_plan, picks the form and split per shape):
// - clouds of up to 256 points (the model's last two levels; plan
//   per_lane 0): a warp a center, the ballot scan of neighbours.cuh straight
//   into the row. Launch latency sets their time, and this form has the
//   shortest chain.
// - a lane for each center (two at the first level, plan per_lane): a warp
//   holds 32 or 64 centers of one cloud, and each point is one broadcast
//   16-byte shared load for all of them. A lane folds 32 in-radius flags
//   into one word, then appends the set bits to its own list in index
//   order; no ballot, no sort.
// - the cloud is split into `ranges` contiguous index ranges, one warp a
//   range, so the card holds enough warps (4096 at the first level, the
//   small levels spread over the card). Each (center, range) keeps its
//   first up-to-K hits (a range stops once all its lanes hold K) and its
//   count, in shared memory, or in a scratch buffer when the plan finds no
//   room.
// - the merge: the first K of the ranges' lists concatenated in ascending
//   order are the first K overall. Each (center, range) copies its list to
//   the center's row at the hits of the ranges before it, the rows staged in
//   shared memory (in the tile, no longer read); the warps pad the slots
//   past the total in turns; then the block's rows go out in whole 32-slot
//   stores.
// kernels/ballquery_cuda.py::first_k_in_plan_order models this order in
// plain ops.
#include <algorithm>

#include "neighbours.cuh"
#include "ranges.cuh"

namespace {

// A block: `groups` groups of 32 * R centers of one cloud (R subgroups of
// 32 a group, one a lane each), each group's warps one a range. Shared
// memory: the tile (later the block's rows, `ks` ints each), then per
// (subgroup, range, lane) the count and, unless `scratch` holds them, the
// list of `ks` ints (k rounded up to odd, so the lanes' appends and reads
// fall on distinct banks).
template <int R>
__global__ void __launch_bounds__(pn12::kMaxRangeThreads, 2)
    ballquery_kernel(const float* __restrict__ xyz,
                     const float* __restrict__ centers, int* __restrict__ out,
                     int* scratch, int n, int s, int k, float r2, int ranges,
                     int groups, int len, int chunk_shift) {
  extern __shared__ float4 tile[];
  const int subgroups = groups * R;  // of 32 centers, a block
  const int ks = k | 1;
  // the tile, which the merge then reuses for the block's rows
  int* rows = reinterpret_cast<int*>(tile);
  int* counts = rows + max((ranges << chunk_shift) * 4, subgroups * 32 * ks);
  const int cloud_subgroups = (s + 31) >> 5;
  const int cloud_blocks = (cloud_subgroups + subgroups - 1) / subgroups;
  const int b = blockIdx.x / cloud_blocks;
  const int g0 = (blockIdx.x - b * cloud_blocks) * subgroups;
  int* lists = scratch != nullptr
                   ? scratch + (static_cast<size_t>(b) * cloud_subgroups + g0) *
                                   ranges * 32 * ks
                   : counts + subgroups * ranges * 32;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = warp / ranges, p = warp - g * ranges;
  const float* cloud = xyz + static_cast<size_t>(b) * n * 3;

  float cx[R], cy[R], cz[R];
  int count[R];
  int* list[R];
  bool valid[R];
  bool full = true;
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const int sg = g * R + r;
    const int c = (g0 + sg) * 32 + lane;  // this lane's r-th center
    cx[r] = cy[r] = cz[r] = __int_as_float(0x7fffffff);  // NaN: no hit
    count[r] = k;  // a lane without a center counts as full
    valid[r] = g0 + sg < cloud_subgroups && c < s;
    if (valid[r]) {
      const float* pc = centers + (static_cast<size_t>(b) * s + c) * 3;
      cx[r] = pc[0];
      cy[r] = pc[1];
      cz[r] = pc[2];
      count[r] = 0;
    }
    full = full && count[r] >= k;
    list[r] = lists + (static_cast<size_t>(sg * ranges + p) * 32 + lane) * ks;
  }
  const int lo = p * len, hi = min(lo + len, n);
  bool done = lo >= hi || __all_sync(pn12::kFullWarp, full);

  for (int t0 = 0; t0 < len; t0 += 1 << chunk_shift) {
    if (__syncthreads_and(done)) break;  // every range of the block is done
    pn12::stage_ranges(tile, cloud, n, ranges, len, chunk_shift, t0);
    __syncthreads();
    if (done) continue;
    const int m = min(1 << chunk_shift, hi - lo - t0);
    const float4* pts = tile + (p << chunk_shift);
    for (int j0 = 0; j0 < m; j0 += 32) {
      unsigned hits[R];
#pragma unroll
      for (int r = 0; r < R; ++r) hits[r] = 0u;
#pragma unroll
      for (int u = 0; u < 32; ++u) {
        const float4 q = pts[j0 + u];
#pragma unroll
        for (int r = 0; r < R; ++r) {
          const float d2 = pn12::direct_sq_dist(cx[r], cy[r], cz[r], q.x, q.y, q.z);
          hits[r] |= (d2 <= r2 ? 1u : 0u) << u;
        }
      }
      full = true;
#pragma unroll
      for (int r = 0; r < R; ++r) {
        while (hits[r] != 0u && count[r] < k) {
          list[r][count[r]++] = lo + t0 + j0 + __ffs(hits[r]) - 1;
          hits[r] &= hits[r] - 1u;
        }
        full = full && count[r] >= k;
      }
      if (__all_sync(pn12::kFullWarp, full)) {
        done = true;
        break;
      }
    }
    done = done || lo + t0 + (1 << chunk_shift) >= hi;
  }
#pragma unroll
  for (int r = 0; r < R; ++r) {
    counts[((g * R + r) * ranges + p) * 32 + lane] = count[r];
  }
  __syncthreads();

  // the merge: each (center, range) lands at the hits of the ranges before
  // it in the center's row, staged in shared memory; the ranges' warps pad
  // the slots past the total in turns
#pragma unroll
  for (int r = 0; r < R; ++r) {
    if (!valid[r]) continue;
    const int sg = g * R + r;
    const int* cnt = counts + sg * ranges * 32 + lane;
    int before = 0, total = 0, first_range = -1;
    for (int q = 0; q < ranges; ++q) {
      const int cq = cnt[q * 32];
      before += q < p ? cq : 0;
      total += cq;
      if (first_range < 0 && cq > 0) first_range = q;
    }
    int* row = rows + (sg * 32 + lane) * ks;
#pragma unroll 4
    for (int j = 0; j < count[r] && before + j < k; ++j) row[before + j] = list[r][j];
    if (total < k) {
      const int first =
          first_range < 0
              ? n
              : lists[(static_cast<size_t>(sg * ranges + first_range) * 32 + lane) * ks];
      for (int j = total + p; j < k; j += ranges) row[j] = first;
    }
  }
  __syncthreads();
  // the rows out, one warp a row, whole 32-slot stores
  for (int rr = warp; rr < subgroups * 32; rr += groups * ranges) {
    const int rc = (g0 + (rr >> 5)) * 32 + (rr & 31);
    if (g0 + (rr >> 5) >= cloud_subgroups || rc >= s) continue;
    int* orow = out + (static_cast<size_t>(b) * s + rc) * k;
    for (int j = lane; j < k; j += 32) orow[j] = rows[rr * ks + j];
  }
}

// The form for tiny clouds (plan per_lane 0): a warp a center, the ballot
// scan of neighbours.cuh straight into the output row, no staging and no
// merge, 8 warps a block.
constexpr int kWarpFormWarps = 8;

__global__ void ballquery_kernel(const float* __restrict__ xyz,
                                 const float* __restrict__ centers,
                                 int* __restrict__ out, int n, int s, int k,
                                 float r2, int queries) {
  const int q = blockIdx.x * kWarpFormWarps + (threadIdx.x >> 5);  // warp-uniform
  if (q >= queries) return;
  const float* c = centers + 3 * static_cast<size_t>(q);
  pn12::first_k_scan(xyz + static_cast<size_t>(q / s) * n * 3, n, c[0], c[1],
                     c[2], r2, k, out + static_cast<size_t>(q) * k,
                     threadIdx.x & 31);
}

template <int R>
cudaError_t run(const float* xyz, const float* centers, int* out,
                int* scratch, int b, int n, int s, int k, float r2,
                int ranges, int groups, int len, int chunk_shift, int smem,
                cudaStream_t stream) {
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        ballquery_kernel<R>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return err;
  }
  const int per_block = groups * R;
  const long long blocks =
      static_cast<long long>(b) * (((s + 31) / 32 + per_block - 1) / per_block);
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  ballquery_kernel<R><<<static_cast<unsigned>(blocks), ranges * groups * 32,
                        smem, stream>>>(xyz, centers, out, scratch, n, s, k,
                                        r2, ranges, groups, len, chunk_shift);
  return cudaGetLastError();
}

}  // namespace

// xyz (B, N, 3) f32, centers (B, S, 3) f32 -> out (B, S, K) i32, K <= N.
// per_lane (R: 1 or 2 centers a lane, 0 a warp a center), ranges, groups,
// len and chunk_shift are the plan's (kernels/ballquery_cuda.py::
// ballquery_plan); scratch is null when the lists fit in shared memory,
// else it holds B * ceil(S / 32) * ranges * 32 * (K | 1) ints; smem is the
// plan's shared bytes (0 at R = 0).
PN12_API int pn12_ballquery(const float* xyz, const float* centers, int* out,
                            int* scratch, int b, int n, int s, int k,
                            float r2, int per_lane, int ranges, int groups,
                            int len, int chunk_shift, int smem, void* stream) {
  if (b <= 0 || n <= 0 || s <= 0 || k <= 0 || k > n ||
      !pn12::valid_ranges(n, ranges, groups, len, chunk_shift)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const long long lanes = static_cast<long long>(groups) * per_lane * ranges * 32;
  const long long region =
      std::max((static_cast<long long>(ranges) << chunk_shift) * 16,
               static_cast<long long>(groups) * per_lane * 32 * (k | 1) * 4);
  const long long need =
      per_lane == 0
          ? 0LL
          : region + lanes * 4 + (scratch != nullptr ? 0LL : lanes * (k | 1) * 4);
  if (smem != need) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = pn12::as_stream(stream);
  cudaError_t err = cudaErrorInvalidValue;
  switch (per_lane) {
    case 0: {
      const long long queries = static_cast<long long>(b) * s;
      if (queries > 0x7fffffffLL - kWarpFormWarps) return static_cast<int>(cudaErrorInvalidValue);
      ballquery_kernel<<<static_cast<unsigned>((queries + kWarpFormWarps - 1) / kWarpFormWarps),
                         kWarpFormWarps * 32, 0, st>>>(xyz, centers, out, n, s, k, r2,
                                                       static_cast<int>(queries));
      err = cudaGetLastError();
      break;
    }
    case 1: err = run<1>(xyz, centers, out, scratch, b, n, s, k, r2, ranges, groups, len, chunk_shift, smem, st); break;
    case 2: err = run<2>(xyz, centers, out, scratch, b, n, s, k, r2, ranges, groups, len, chunk_shift, smem, st); break;
    default: break;
  }
  return static_cast<int>(err);
}

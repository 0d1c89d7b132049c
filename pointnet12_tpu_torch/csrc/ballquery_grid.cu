// Ball query through a voxel grid.
//
// Replaces: pointnet12_tpu/kernels/ballquery_grid.py::ballquery_grid
// (_grid_kernel) -> ballquery_grid_kernel. The grid it reads (the cell
// offsets and the stable sorts of the point and center keys) comes from
// grid_prep.cu, one launch, as the Pallas kernel's came from the XLA prep
// and _cell_offsets.
//
// Contract: that of ballquery.cu (the first K in-radius indices in
// ascending ORIGINAL index, d2 in the direct form of common.cuh, the
// unfilled slots repeating the first, N for a center with none), with the
// candidates of a center limited to the 27 cells around its cell: cells at
// least r wide hold every point within r, and the exact test decides.
//
// What bounds it: neither bytes nor operations. At Path G's SA1 (B=16,
// N=8192, S=1024, K=32, r=0.1, 8^3 cells) the points, centers and indices
// are 3.9 MB (1.15 us at 3.35 TB/s), and the ~5.5M candidate pairs ~9 ops
// each (0.7 us at 67 TFLOP/s). What the design pays for is the walk of each
// center's candidates, the gather of the points in cell order, and the
// selection of the K smallest indices.
// What holds it back on the H100 (trials with clock64 timers in copies whose
// scripts are not kept): a block's chain of steps, each waiting on the last.
// The walk, issue-bound at ~46 instructions a 32-candidate step, takes about
// half of a block's time at Path G; the gather of the union (scattered
// 12-byte points, each staged by ~6 blocks) and the selection most of the
// rest. A copy that walked one column in nine still took more than half the
// time, and pruning cells by the staged points' bounds cost more in its own
// pass than it saved: the staging, the setup and the selection are the floor.
//
// Design: a block of 8 warps takes a run of `run` consecutive sorted
// centers (sorted by cell, so they share cells; runs never cross clouds).
//   0. The cloud's g^3 + 1 offsets and the run's centers go into shared
//      memory: every later step reads them there, with no dependent global
//      load.
//   1. A center whose own cell holds more than `threshold` points (a dense
//      spot: its hits are dense too) takes the index-order scan of step 4;
//      every other one widens, for each of its 9 (x, y) columns, that
//      column's z hull (shared atomicMin / atomicMax).
//   2. The union of the hulls is a list of ranges of sorted positions, one
//      a column, in column order; an exclusive scan gives each its start in
//      the staged order.
//   3. The block stages the union `tile` points at a time as 16-byte
//      records (x, y, z, original index), gathered through perm once a
//      block (8 records a thread in flight), and every warp walks its
//      centers' 9 ranges inside the tile, 32 candidates a step: one LDS.128
//      a candidate. The in-radius candidates go, by ballot and rank, into
//      the center's list of original indices in shared memory; when a
//      step's hits take it past `capacity` (it has 32 slots more), the list
//      is cut to its k smallest, and from then on a hit at or above the
//      largest of them is dropped, so a list holds the k smallest hits so
//      far whatever their number, cut about k ln(hits / k) / (capacity - k)
//      times.
//   4. Each center's row: every list entry's rank among the others (the
//      indices are distinct) places the k smallest ascending; a center over
//      the threshold scans the whole cloud in index order with an early
//      exit at k (neighbours.cuh::first_k_scan). Rows are written at the
//      centers' original positions, so no unsort follows.
// The result is the contract on every path, so the plan (run, capacity,
// threshold, tile: kernels/grid_cuda.py::grid_plan) moves only the time;
// kernels/grid_cuda.py::first_k_grid_in_plan_order renders this search in
// plain ops. The search of csrc/neighbours.cuh::first_k_grid (a warp a
// center, an N-bit mask) stays for the fused grid layer (fused_sa.cu).
// The TPU kernel's fixed windows of 128 sorted points, its per-tile
// overflow rescan and its K passes of masked min were Mosaic's way to
// slice and select; a block reads the cell ranges themselves instead.
#include <climits>

#include "neighbours.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kBatch = 8;  // staged records a thread gathers at once
constexpr size_t kMaxSharedBytes = 232448;  // 227 KB, sm_90's per-block limit
constexpr int kScan = -1;  // a center's count when it scans the cloud

// Shared memory of a block, in this order: the staged records; the run's
// centers (x, y, z, cell); the centers' lists (capacity + 32 slots), counts
// and cuts; a warp's scratch
// row; per (x, y) column of the grid its z hull (lo, hi), the start of its
// range in sorted positions and (with one more) its start in the staged
// order; the cloud's g^3 + 1 cell offsets
// (kernels/grid_cuda.py::grid_shared_bytes computes the same).
size_t shared_bytes(int run, int capacity, int tile, int g) {
  return 16 * (static_cast<size_t>(tile) + run) +
         4 * (static_cast<size_t>(run) * (capacity + 34) + kWarps * capacity +
              4 * static_cast<size_t>(g) * g + 1 + static_cast<size_t>(g) * g * g + 1);
}

// The k smallest of list[0, found) (distinct values) ascending into dst:
// each entry's rank is the number of smaller entries, counted four entries
// a 16-byte load. list[found, found rounded up to 4) must hold INT_MAX, and
// dst must not overlap list; every lane of the warp calls it.
__device__ __forceinline__ void select_first_k(const int* list, int found, int k, int* dst,
                                               int lane) {
  const int found4 = (found + 3) & ~3;
  for (int e = lane; e < found; e += 64) {  // two entries a lane at a time
    const int v0 = list[e];
    const int v1 = e + 32 < found ? list[e + 32] : INT_MAX;
    int r0 = 0, r1 = 0;
    for (int j = 0; j < found4; j += 4) {
      const int4 w = *reinterpret_cast<const int4*>(list + j);
      r0 += (w.x < v0) + (w.y < v0) + (w.z < v0) + (w.w < v0);
      r1 += (w.x < v1) + (w.y < v1) + (w.z < v1) + (w.w < v1);
    }
    if (r0 < k) dst[r0] = v0;
    if (e + 32 < found && r1 < k) dst[r1] = v1;
  }
}

// Pad list[found, found rounded up to 4) with INT_MAX for select_first_k.
__device__ __forceinline__ void pad_list(int* list, int found, int lane) {
  if (lane < (-found & 3)) list[found + lane] = INT_MAX;
  __syncwarp();
}

__global__ void __launch_bounds__(kThreads)
    ballquery_grid_kernel(const float* __restrict__ xyz, const float* __restrict__ centers,
                          const int* __restrict__ perm, const int* __restrict__ offsets,
                          const int* __restrict__ qperm, const int* __restrict__ qcell,
                          int* __restrict__ out, int n, int s, int k, int g, float r2,
                          int run, int capacity, int threshold, int tile, int runs) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int cols = g * g;
  const int cells = cols * g;
  float4* stage = reinterpret_cast<float4*>(smem);
  float4* ctr = stage + tile;
  int* lists = reinterpret_cast<int*>(ctr + run);
  const int slots = capacity + 32;  // a list's slots
  int* count = lists + run * slots;
  int* cutoff = count + run;
  int* scratch = cutoff + run;
  int* zlo = scratch + kWarps * capacity;
  int* zhi = zlo + cols;
  int* start = zhi + cols;
  int* base = start + cols;
  int* off = base + cols + 1;

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int b = blockIdx.x / runs;
  const int q0 = blockIdx.x % runs * run;
  const int m = min(run, s - q0);  // this block's centers
  const float* cloud = xyz + static_cast<size_t>(b) * n * 3;
  const int* bperm = perm + static_cast<size_t>(b) * n;
  const int* center_of = qperm + static_cast<size_t>(b) * s + q0;

  // 0. the cloud's offsets and the run's centers into shared memory
  for (int c = threadIdx.x; c <= cells; c += kThreads) {
    off[c] = offsets[static_cast<size_t>(b) * (cells + 1) + c];
  }
  for (int c = threadIdx.x; c < m; c += kThreads) {
    const float* p = centers + (static_cast<size_t>(b) * s + center_of[c]) * 3;
    ctr[c] = make_float4(p[0], p[1], p[2],
                         __int_as_float(qcell[static_cast<size_t>(b) * s + q0 + c]));
  }
  for (int c = threadIdx.x; c < cols; c += kThreads) {
    zlo[c] = g;
    zhi[c] = -1;
  }
  __syncthreads();

  // 1. a center over the threshold (points in its own cell) scans; every
  //    other one widens the z hull of each of its 9 columns
  for (int p = threadIdx.x; p < m * 9; p += kThreads) {
    const int c = p / 9, j = p % 9;
    const int cell = __float_as_int(ctr[c].w);
    const bool scan = off[cell + 1] - off[cell] > threshold;
    if (j == 0) {
      count[c] = scan ? kScan : 0;
      cutoff[c] = n;
    }
    const int x = cell / cols - 1 + j / 3, y = cell / g % g - 1 + j % 3, z = cell % g;
    if (scan || x < 0 || x >= g || y < 0 || y >= g) continue;
    atomicMin(&zlo[x * g + y], max(z - 1, 0));
    atomicMax(&zhi[x * g + y], min(z + 1, g - 1));
  }
  __syncthreads();

  // 2. the union: column c's hull is the sorted positions start[c] ..,
  //    staged from base[c] (its length first, then an exclusive scan)
  for (int c = threadIdx.x; c < cols; c += kThreads) {
    const bool in = zhi[c] >= zlo[c];
    start[c] = in ? off[c * g + zlo[c]] : 0;
    base[c] = in ? off[c * g + zhi[c] + 1] - start[c] : 0;
  }
  __syncthreads();
  if (warp == 0) {
    int total = 0;
    for (int c0 = 0; c0 < cols; c0 += 32) {
      const int c = c0 + lane;
      const int len = c < cols ? base[c] : 0;
      int incl = len;
      for (int d = 1; d < 32; d <<= 1) {
        const int up = __shfl_up_sync(pn12::kFullWarp, incl, d);
        if (lane >= d) incl += up;
      }
      if (c < cols) base[c] = total + incl - len;
      total += __shfl_sync(pn12::kFullWarp, incl, 31);
    }
    if (lane == 0) base[cols] = total;
  }
  __syncthreads();
  const int staged = base[cols];

  // 3. the union a tile at a time: stage it, walk it
  for (int t0 = 0; t0 < staged; t0 += tile) {
    const int t1 = min(staged, t0 + tile);
    // kBatch records a thread at once: their columns, their original
    // indices, then their coordinates, each round's loads all in flight
    for (int u0 = t0 + threadIdx.x; u0 < t1; u0 += kThreads * kBatch) {
      int o[kBatch];
#pragma unroll
      for (int i = 0; i < kBatch; ++i) {
        const int u = u0 + i * kThreads;
        o[i] = -1;
        if (u < t1) {
          int lo = 0, hi = cols;  // base[lo] <= u < base[hi]: a column that holds u
          while (hi - lo > 1) {
            const int mid = (lo + hi) >> 1;
            if (base[mid] <= u) {
              lo = mid;
            } else {
              hi = mid;
            }
          }
          o[i] = bperm[start[lo] + u - base[lo]];
        }
      }
#pragma unroll
      for (int i = 0; i < kBatch; ++i) {
        if (o[i] < 0) continue;
        const float* p = cloud + 3 * o[i];
        stage[u0 + i * kThreads - t0] = make_float4(p[0], p[1], p[2], __int_as_float(o[i]));
      }
    }
    __syncthreads();
    for (int c = warp; c < m; c += kWarps) {
      int found = count[c];  // warp-uniform, as every count below
      if (found < 0) continue;
      const float4 q = ctr[c];
      const int cell = __float_as_int(q.w);
      const int z0 = max(cell % g - 1, 0), z1 = min(cell % g + 1, g - 1);
      // lane j < 9: the staged range [a, e) of column (qx - 1 + j / 3, qy - 1 + j % 3)
      const int x = cell / cols - 1 + lane / 3, y = cell / g % g - 1 + lane % 3;
      int a = 0, e = 0;
      if (lane < 9 && x >= 0 && x < g && y >= 0 && y < g) {
        const int col = x * g + y;
        a = base[col] + off[col * g + z0] - start[col];
        e = a + off[col * g + z1 + 1] - off[col * g + z0];
      }
      int* list = lists + c * slots;
      int* spare = scratch + warp * capacity;
      // once a list is cut to its k smallest, a hit at or above the largest
      // of them (cut) cannot be among the k smallest
      int cut = cutoff[c];
      for (int j = 0; j < 9; ++j) {
        const int lo = max(__shfl_sync(pn12::kFullWarp, a, j), t0);
        const int hi = min(__shfl_sync(pn12::kFullWarp, e, j), t1);
        for (int u0 = lo; u0 < hi; u0 += 32) {
          const float4 p = stage[min(u0 + lane, hi - 1) - t0];
          const int o = __float_as_int(p.w);
          const unsigned hits = __ballot_sync(
              pn12::kFullWarp, u0 + lane < hi && o < cut &&
                                   pn12::direct_sq_dist(q.x, q.y, q.z, p.x, p.y, p.z) <= r2);
          if ((hits >> lane) & 1u) list[found + __popc(hits & ((1u << lane) - 1u))] = o;
          found += __popc(hits);
          if (found > capacity) {
            // keep the k smallest (the list has 32 slots past its capacity
            // for the step that overflows it)
            __syncwarp();
            pad_list(list, found, lane);
            select_first_k(list, found, k, spare, lane);
            __syncwarp();
            found = k;
            for (int i = lane; i < k; i += 32) list[i] = spare[i];
            cut = spare[k - 1];
            __syncwarp();
          }
        }
      }
      __syncwarp();
      if (lane == 0) {
        count[c] = found;
        cutoff[c] = cut;
      }
    }
    __syncthreads();  // the walks are done before the next tile lands
  }

  // 4. the rows
  for (int c = warp; c < m; c += kWarps) {
    int* row = out + (static_cast<size_t>(b) * s + center_of[c]) * k;
    const int found = count[c];
    if (found < 0) {
      const float4 q = ctr[c];
      pn12::first_k_scan(cloud, n, q.x, q.y, q.z, r2, k, row, lane);
      continue;
    }
    int* list = lists + c * slots;
    int first = n;
    for (int i = lane; i < found; i += 32) first = min(first, list[i]);
    first = __reduce_min_sync(pn12::kFullWarp, first);
    pad_list(list, found, lane);
    select_first_k(list, found, k, row, lane);
    for (int slot = found + lane; slot < k; slot += 32) row[slot] = first;
  }
}

}  // namespace

// xyz (B, N, 3) f32 and centers (B, S, 3) f32 in their original order;
// perm (B, N) i32 (sorted position -> point index), offsets (B, g^3 + 1)
// i32, qperm (B, S) i32 (sorted position -> center index) and qcell (B, S)
// i32 (the centers' cell ids in sorted order), all from grid_prep.cu
// -> out (B, S, K) i32 in the original center order. The plan (run,
// capacity, threshold, tile) and its shared_bytes come from
// kernels/grid_cuda.py::grid_plan; a shared_bytes that this file does not
// compute is refused.
PN12_API int pn12_ballquery_grid(const float* xyz, const float* centers,
                                 const int* perm, const int* offsets,
                                 const int* qperm, const int* qcell, int* out,
                                 int b, int n, int s, int k, int g, float r2,
                                 int run, int capacity, int threshold, int tile,
                                 int smem_bytes, void* stream) {
  if (b <= 0 || n <= 0 || s <= 0 || k <= 0 || g <= 0 || run <= 0 || capacity < k ||
      capacity % 4 != 0 || tile <= 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const size_t smem = shared_bytes(run, capacity, tile, g);
  const int runs = (s + run - 1) / run;
  if (smem != static_cast<size_t>(smem_bytes) || smem > kMaxSharedBytes ||
      static_cast<long long>(b) * runs > 0x7fffffffLL) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        ballquery_grid_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  ballquery_grid_kernel<<<b * runs, kThreads, smem, pn12::as_stream(stream)>>>(
      xyz, centers, perm, offsets, qperm, qcell, out, n, s, k, g, r2, run, capacity,
      threshold, tile, runs);
  return static_cast<int>(cudaGetLastError());
}

// The voxel grid of the grid ball query and the fused grid SA layer, in one
// launch: binning, the stable sorts of the points and of the centers by
// cell id, and the cell offsets.
//
// Replaces: pointnet12_tpu/kernels/ballquery_grid.py::_cell_offsets
// (_cell_offsets_kernel) together with the XLA prep around it,
// ::grid_prep (:242-315): min/max, the keys, the two stable sorts.
// Contract (pointnet12_tpu_torch/ops/grid.py::grid_prep_torch, bit for bit):
//   lo, hi   = the cloud's min and max per axis
//   size     = max(max over axes of (hi - lo) / g, radius)   (fp32 radius)
//   cell     = clamp(floor((p - lo) / size), 0, g - 1) per axis
//   key      = (cx * g + cy) * g + cz
//   perm, skey   = the points' stable sort by key (sorted position ->
//                  original index, and the sorted keys)
//   qperm, sqkey = the same for the centers, binned with the points' lo and
//                  size
//   offsets[c]   = #{i : skey[i] < c} for c in [0, g^3]
// Every step rounds as the plain version does: IEEE division (the build
// keeps -prec-div and passes --fmad=false), min and max exact in any order.
// The plain version divides the extent by g as a multiplication by 1/g on
// the card, which equals the division for the port's g = 8 (a power of 2).
//
// What bounds it: neither bytes (~2.9 MB at B=16, N=8192, 0.9 us at
// 3.35 TB/s) nor operations; a block's chain of dependent steps (the bounds
// reduction, the keys, two passes over them, a scan) on one SM. The work is
// small, so the point of the kernel is one launch where the PyTorch prep
// took 40-60 device events (amin, amax, the keys, two segmented sorts,
// casts, the offsets), and a short chain within it.
//
// Design: a (2, B) grid of 1024-thread blocks. Block (0, b) sorts cloud b's
// points and writes its offsets; block (1, b) sorts its centers. Each
// recomputes the cloud's bounds (reads of 12 bytes a point, from L2), so no
// second launch is needed. The keys are computed once, every thread on its
// own points with no dependence between them, into shared memory (16 bits
// each), and the sorted list is staged there too and written out in index
// order, coalesced, where the scatter would touch a cache line a lane; a
// list too long for shared memory (past ~19K points at g = 8) recomputes
// its keys in each pass and scatters to device memory.
// The sort is a counting sort, stable by construction: warp w owns the
// contiguous index range [w*seg, (w+1)*seg) of the list. Pass 1: each warp
// counts its keys per cell into its column of a cells x warps table in
// shared memory; the lanes that share a key are found by one __ballot_sync
// a key bit (9 for 512 cells), and the lowest of them adds their number.
// An exclusive scan of the table in cell-major order gives each (cell,
// warp) its first sorted position, and the (cell, warp 0) entries are the
// offsets. Pass 2: each warp walks its range again in order; a lane's
// position is its (cell, warp) cursor plus the number of lower lanes with
// its key, and the group's lowest lane then moves the cursor. Within a cell
// the positions follow warp order, then iteration order, then lane order:
// ascending original index, as torch.sort(stable=True) and JAX's stable
// lax.sort place them.
#include <algorithm>

#include <math_constants.h>

#include "common.cuh"

namespace {

constexpr int kThreads = 1024;
constexpr int kWarps = kThreads / 32;
constexpr int kRow = kWarps + 1;  // one cell's per-warp counts, padded
constexpr unsigned kFullWarp = 0xffffffffu;
constexpr size_t kMaxSharedBytes = 232448;  // 227 KB, sm_90's per-block limit
constexpr int kRed = kWarps * 6;            // per-warp min and max, then lo, size
constexpr int kMaxKeyBits = 16;             // keys held in 16 bits: g <= 40

struct Bounds {
  float lx, ly, lz, size;
};

__device__ __forceinline__ int axis_cell(float p, float lo, float size, int g) {
  const float q = floorf(__fdiv_rn(__fsub_rn(p, lo), size));
  return static_cast<int>(fminf(fmaxf(q, 0.0f), static_cast<float>(g - 1)));
}

__device__ __forceinline__ int cell_key(const float* __restrict__ p,
                                        const Bounds& bd, int g) {
  const int cx = axis_cell(p[0], bd.lx, bd.size, g);
  const int cy = axis_cell(p[1], bd.ly, bd.size, g);
  const int cz = axis_cell(p[2], bd.lz, bd.size, g);
  return (cx * g + cy) * g + cz;
}

// The lanes in `live` whose key equals this lane's: one ballot a key bit,
// keys below 2^bits.
__device__ __forceinline__ unsigned same_key_lanes(int key, unsigned live,
                                                   int bits) {
  unsigned peers = live;
#pragma unroll
  for (int k = 0; k < kMaxKeyBits; ++k) {
    if (k < bits) {  // warp-uniform
      const bool bit = (key >> k) & 1;
      const unsigned set = __ballot_sync(kFullWarp, bit);
      peers &= bit ? set : ~set;
    }
  }
  return peers;
}

// Exclusive prefix sum of one value a thread over the block; `sums` holds
// kWarps ints of shared memory. Every thread must call it.
__device__ int block_exclusive_scan(int v, int* sums) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int incl = v;
  for (int d = 1; d < 32; d <<= 1) {
    const int y = __shfl_up_sync(kFullWarp, incl, d);
    if (lane >= d) incl += y;
  }
  if (lane == 31) sums[warp] = incl;
  __syncthreads();
  if (warp == 0) {
    const int s = sums[lane];
    int si = s;
    for (int d = 1; d < 32; d <<= 1) {
      const int y = __shfl_up_sync(kFullWarp, si, d);
      if (lane >= d) si += y;
    }
    sums[lane] = si - s;
  }
  __syncthreads();
  const int out = incl - v + sums[warp];
  __syncthreads();  // sums may be reused by the caller
  return out;
}

// The cloud's lo per axis and the cell size, in every thread; `red` holds
// kRed + 4 floats of shared memory.
__device__ Bounds cloud_bounds(const float* __restrict__ xyz, int n,
                               float radius, int g, float* red) {
  float mn[3] = {CUDART_INF_F, CUDART_INF_F, CUDART_INF_F};
  float mx[3] = {-CUDART_INF_F, -CUDART_INF_F, -CUDART_INF_F};
#pragma unroll 4
  for (int i = threadIdx.x; i < n; i += kThreads) {
    for (int a = 0; a < 3; ++a) {
      const float v = xyz[3 * i + a];
      mn[a] = fminf(mn[a], v);
      mx[a] = fmaxf(mx[a], v);
    }
  }
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int round = 0; round < 2; ++round) {
    for (int d = 16; d > 0; d >>= 1) {
      for (int a = 0; a < 3; ++a) {
        mn[a] = fminf(mn[a], __shfl_xor_sync(kFullWarp, mn[a], d));
        mx[a] = fmaxf(mx[a], __shfl_xor_sync(kFullWarp, mx[a], d));
      }
    }
    if (round == 1) break;
    if (lane == 0) {
      for (int a = 0; a < 3; ++a) {
        red[warp * 6 + a] = mn[a];
        red[warp * 6 + 3 + a] = mx[a];
      }
    }
    __syncthreads();
    if (warp != 0) break;
    for (int a = 0; a < 3; ++a) {  // warp 0 reduces the warps' results
      mn[a] = red[lane * 6 + a];
      mx[a] = red[lane * 6 + 3 + a];
    }
  }
  if (threadIdx.x == 0) {
    const float extent = fmaxf(fmaxf(__fsub_rn(mx[0], mn[0]), __fsub_rn(mx[1], mn[1])),
                               __fsub_rn(mx[2], mn[2]));
    red[kRed + 0] = mn[0];
    red[kRed + 1] = mn[1];
    red[kRed + 2] = mn[2];
    // the plain version's max(extent / g, radius)
    red[kRed + 3] = fmaxf(__fdiv_rn(extent, static_cast<float>(g)), radius);
  }
  __syncthreads();
  return Bounds{red[kRed + 0], red[kRed + 1], red[kRed + 2], red[kRed + 3]};
}

template <bool kStaged>
__global__ void __launch_bounds__(kThreads)
grid_prep_kernel(const float* __restrict__ xyz, const float* __restrict__ centers,
                 int* __restrict__ perm, int* __restrict__ skey,
                 int* __restrict__ offsets, int* __restrict__ qperm,
                 int* __restrict__ sqkey, int n, int s, int g, float radius) {
  // cells x kRow counts, cell-major; with kStaged, then the sorted original
  // indices (count ints), the keys in index order and the sorted keys
  // (count 16-bit values each)
  extern __shared__ int table[];
  __shared__ float red[kRed + 4];
  __shared__ int sums[kWarps];
  const int b = blockIdx.y;
  const bool points = blockIdx.x == 0;
  const int cells = g * g * g;
  const int bits = 32 - __clz(cells - 1);
  const float* cloud = xyz + static_cast<size_t>(b) * n * 3;
  const int count = points ? n : s;
  const float* src = points ? cloud : centers + static_cast<size_t>(b) * s * 3;
  int* out_idx = points ? perm + static_cast<size_t>(b) * n
                        : qperm + static_cast<size_t>(b) * s;
  int* out_key = points ? skey + static_cast<size_t>(b) * n
                        : sqkey + static_cast<size_t>(b) * s;
  const int entries = cells * kRow;
  int* staged_idx = table + entries;
  unsigned short* keys = reinterpret_cast<unsigned short*>(staged_idx + count);
  unsigned short* staged_key = keys + count;

  for (int e = threadIdx.x; e < entries; e += kThreads) table[e] = 0;
  const Bounds bd = cloud_bounds(cloud, n, radius, g, red);  // syncs the block
  if constexpr (kStaged) {
#pragma unroll 4
    for (int i = threadIdx.x; i < count; i += kThreads) {
      keys[i] = static_cast<unsigned short>(cell_key(src + 3 * i, bd, g));
    }
    __syncthreads();
  }
  auto key_of = [&](int i) -> int {
    if constexpr (kStaged) {
      return keys[i];
    } else {
      return cell_key(src + 3 * i, bd, g);
    }
  };

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const unsigned below = (1u << lane) - 1u;
  const int seg = (count + kWarps - 1) / kWarps;
  const int begin = min(count, warp * seg);
  const int end = min(count, begin + seg);

  // pass 1: the warp's counts per cell
  for (int base = begin; base < end; base += 32) {
    const int i = base + lane;
    const bool valid = i < end;
    const int key = valid ? key_of(i) : 0;
    const unsigned peers = same_key_lanes(key, __ballot_sync(kFullWarp, valid), bits);
    if (valid && (peers & below) == 0u) table[key * kRow + warp] += __popc(peers);
    __syncwarp();
  }
  __syncthreads();

  // exclusive scan of the table, cell-major: (cell, warp) -> first position
  const int per = (entries + kThreads - 1) / kThreads;
  const int e0 = min(entries, static_cast<int>(threadIdx.x) * per);
  const int e1 = min(entries, e0 + per);
  int local = 0;
  for (int e = e0; e < e1; ++e) local += table[e];
  int run = block_exclusive_scan(local, sums);
  for (int e = e0; e < e1; ++e) {
    const int c = table[e];
    table[e] = run;
    run += c;
  }
  __syncthreads();

  if (points) {
    int* off = offsets + static_cast<size_t>(b) * (cells + 1);
    for (int c = threadIdx.x; c < cells; c += kThreads) off[c] = table[c * kRow];
    if (threadIdx.x == 0) off[cells] = n;
  }

  // pass 2: scatter in index order through the (cell, warp) cursors
  for (int base = begin; base < end; base += 32) {
    const int i = base + lane;
    const bool valid = i < end;
    const int key = valid ? key_of(i) : 0;
    const unsigned peers = same_key_lanes(key, __ballot_sync(kFullWarp, valid), bits);
    if (valid) {
      const int pos = table[key * kRow + warp] + __popc(peers & below);
      if constexpr (kStaged) {
        staged_idx[pos] = i;
        staged_key[pos] = static_cast<unsigned short>(key);
      } else {
        out_idx[pos] = i;
        out_key[pos] = key;
      }
    }
    __syncwarp();
    if (valid && (peers & below) == 0u) table[key * kRow + warp] += __popc(peers);
    __syncwarp();
  }
  if constexpr (kStaged) {
    __syncthreads();
    for (int i = threadIdx.x; i < count; i += kThreads) {
      out_idx[i] = staged_idx[i];
      out_key[i] = staged_key[i];
    }
  }
}

template <bool kStaged>
cudaError_t launch(const float* xyz, const float* centers, int* perm, int* skey,
                   int* offsets, int* qperm, int* sqkey, int b, int n, int s,
                   int g, float radius, size_t smem, cudaStream_t stream) {
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        grid_prep_kernel<kStaged>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return err;
  }
  grid_prep_kernel<kStaged><<<dim3(2, b), kThreads, smem, stream>>>(
      xyz, centers, perm, skey, offsets, qperm, sqkey, n, s, g, radius);
  return cudaGetLastError();
}

}  // namespace

// xyz (B, N, 3) f32 and centers (B, S, 3) f32 -> perm, skey (B, N) i32,
// offsets (B, g^3 + 1) i32, qperm, sqkey (B, S) i32; radius is the fp32
// radius the plain version compares against.
PN12_API int pn12_grid_prep(const float* xyz, const float* centers, int* perm,
                            int* skey, int* offsets, int* qperm, int* sqkey,
                            int b, int n, int s, int g, float radius,
                            void* stream) {
  if (b <= 0 || b > 65535 || n <= 0 || s <= 0 || g <= 0 || g > 40) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const size_t room = kMaxSharedBytes - sizeof(float) * (kRed + 4) - sizeof(int) * kWarps;
  const size_t table = static_cast<size_t>(g) * g * g * kRow * sizeof(int);
  if (table > room) return static_cast<int>(cudaErrorInvalidValue);
  // staged: the sorted indices, and the keys before and after the sort
  const size_t staged =
      table + static_cast<size_t>(std::max(n, s)) *
                  (sizeof(int) + 2 * sizeof(unsigned short));
  const cudaStream_t st = pn12::as_stream(stream);
  return static_cast<int>(
      staged <= room
          ? launch<true>(xyz, centers, perm, skey, offsets, qperm, sqkey, b, n,
                         s, g, radius, staged, st)
          : launch<false>(xyz, centers, perm, skey, offsets, qperm, sqkey, b,
                          n, s, g, radius, table, st));
}

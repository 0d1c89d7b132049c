// Ball query through a voxel grid.
//
// Replaces: pointnet12_tpu/kernels/ballquery_grid.py::ballquery_grid
// (_grid_kernel) -> ballquery_grid_kernel. The grid it reads (the cell
// offsets and the stable sorts of the point and center keys) comes from
// grid_prep.cu, one launch, as the Pallas kernel's came from the XLA prep
// and _cell_offsets.
//
// ballquery_grid_kernel: the ball-query contract of ballquery.cu (first K
// in-radius indices ascending, pad with the first, N when none), with the
// candidates limited to the 27 cells around each center. One warp per
// center, the search of neighbours.cuh (first_k_grid): a bitmask of N bits
// per warp in shared memory takes the in-radius candidates by ORIGINAL
// index, so the cell order they arrive in does not matter, and a walk over
// the words in order yields the K smallest. The centers are taken in their
// sorted (cell) order, so the warps of a block search neighbouring cells
// and share the points in L1; each writes its row at the center's original
// position, so no unsort follows. What bounds it: the candidate scan (~27
// cells of points, 12 bytes and ~9 flops each, from L1/L2) and the walk of
// N/32 mask words; device memory is read once (points, keys) and the
// (B, S, K) indices written once.
// The TPU kernel's fixed windows of 128 sorted points, its per-tile
// overflow rescan and its K passes of masked min were Mosaic's way to
// slice and select; a warp reads the cell ranges themselves instead.
#include "neighbours.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr size_t kMaxSharedBytes = 232448;  // 227 KB, sm_90's per-block limit

__global__ void ballquery_grid_kernel(
    const float* __restrict__ xyz, const float* __restrict__ centers,
    const int* __restrict__ perm, const int* __restrict__ offsets,
    const int* __restrict__ qperm, const int* __restrict__ qcell,
    int* __restrict__ out, int n, int s, int k, int g, float r2, int queries) {
  extern __shared__ unsigned masks[];
  const int warp = threadIdx.x >> 5;
  const int q = blockIdx.x * kWarps + warp;  // sorted position, warp-uniform
  if (q >= queries) return;
  const int b = q / s;
  const int center = qperm[q];  // original position in [0, s)
  const size_t row = static_cast<size_t>(b) * s + center;
  const float* c = centers + 3 * row;
  const pn12::Grid grid{xyz + static_cast<size_t>(b) * n * 3,
                        perm + static_cast<size_t>(b) * n,
                        offsets + static_cast<size_t>(b) * (g * g * g + 1), n,
                        g};
  pn12::first_k_grid(grid, qcell[q], c[0], c[1], c[2], r2, k,
                     masks + static_cast<size_t>(warp) * pn12::mask_words(n),
                     out + row * k, threadIdx.x & 31);
}

}  // namespace

// xyz (B, N, 3) f32 and centers (B, S, 3) f32 in their original order;
// perm (B, N) i32 (sorted position -> point index), offsets (B, g^3 + 1)
// i32, qperm (B, S) i32 (sorted position -> center index) and qcell (B, S)
// i32 (the centers' cell ids in sorted order), all from grid_prep.cu
// -> out (B, S, K) i32 in the original center order.
PN12_API int pn12_ballquery_grid(const float* xyz, const float* centers,
                                 const int* perm, const int* offsets,
                                 const int* qperm, const int* qcell, int* out,
                                 int b, int n, int s, int k, int g, float r2,
                                 void* stream) {
  if (b <= 0 || n <= 0 || s <= 0 || k <= 0 || g <= 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const size_t smem =
      static_cast<size_t>(kWarps) * pn12::mask_words(n) * sizeof(unsigned);
  if (smem > kMaxSharedBytes) return static_cast<int>(cudaErrorInvalidValue);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        ballquery_grid_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const int queries = b * s;
  const int blocks = (queries + kWarps - 1) / kWarps;
  ballquery_grid_kernel<<<blocks, kThreads, smem, pn12::as_stream(stream)>>>(
      xyz, centers, perm, offsets, qperm, qcell, out, n, s, k, g, r2, queries);
  return static_cast<int>(cudaGetLastError());
}

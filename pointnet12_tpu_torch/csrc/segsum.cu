// Weighted segment sum: the adjoint of a batched row gather.
//
// Replaces: pointnet12_tpu/kernels/segsum_pallas.py::segment_matmul_pallas
// (_segmm_kernel), reached from pointnet12_tpu/ops/segsum.py::segment_matmul.
// It is the backward of every index-based op of the train step:
// three_interpolate's d ref_feats (FP1-FP4, J=3) and the lifted first
// Dense's d points (SA2-SA4, J=1).
// Contract: out[b, m, :] = sum over (j, r) with idx[b, j, r] == m of
// w[b, j, r] * values[b, r, :] (w = 1 when absent); a row whose index lies
// outside [0, M) adds nothing. The entry point zeroes out itself
// (cudaMemsetAsync on the caller's stream) before the kernel.
//
// What bounds it: bytes. Every element of values is read once and costs
// J multiply-adds; 2 flops per 4 bytes is far below the card's fp32 balance
// (~20 flops a byte), so the least time is the values, indices, weights
// and out moving once through device memory: ~13 us at FP1 (B=16, 4096
// rows of 128 channels into 1024 segments), ~42 us over a train step.
//
// Design: the TPU kernel builds a one-hot selection tile in VMEM and
// contracts it on the MXU, O(B*R*M*C) work, because v5e serialises
// scatters. Hopper reduces in L2, so here it is a scatter-add with vector
// reductions: a warp takes one values row (two for C = 64, four for C = 32:
// L = the lanes a row needs, a power of two up to 32), each lane reads its
// channels as float4s once, coalesced, and for each j adds them with one
// atomicAdd(float4*, float4) (sm_90, global memory), which with its result
// unused is one vector RED: 4x fewer reductions than a scalar atomic a
// channel. out (at most 8.4 MB in the train step) stays in the 50 MB L2,
// where the reductions land. Channel counts that are not a multiple of 4 (or
// operands not 16-byte aligned) take the scalar form of the same loop,
// one atomicAdd a channel, so the contract holds at any C. (Sums privatized
// in shared memory, added with its fp32 atomics, ran slower at the train
// step's shapes.)
//
// Non-determinism: the atomics add in an order that varies from run to
// run, so the sums may differ in the last bits between two runs and from
// the plain version (index_add_); compare them with a tolerance.
#include <cstdint>

#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;

__device__ __forceinline__ float4 scale4(float w, float4 v) {
  return make_float4(__fmul_rn(w, v.x), __fmul_rn(w, v.y), __fmul_rn(w, v.z),
                     __fmul_rn(w, v.w));
}

// units: float4s a row when vec, else floats; lanes: L, the lanes a row
// takes; a warp holds 32 / L rows.
template <bool kVec>
__global__ void __launch_bounds__(kThreads)
segment_matmul_kernel(const int* __restrict__ idx, const float* __restrict__ w,
                      const float* __restrict__ values, float* __restrict__ out,
                      int j_count, int r_count, int m, int c, int units,
                      int lanes) {
  const int b = blockIdx.y;
  const int lane = threadIdx.x & 31;
  const int rows_per_warp = 32 / lanes;
  const int r = (blockIdx.x * kWarps + (threadIdx.x >> 5)) * rows_per_warp +
                lane / lanes;
  if (r >= r_count) return;
  const size_t jr = static_cast<size_t>(j_count) * r_count;
  const int* bidx = idx + b * jr + r;
  const float* bw = w == nullptr ? nullptr : w + b * jr + r;
  const float* row = values + (static_cast<size_t>(b) * r_count + r) * c;
  float* bout = out + static_cast<size_t>(b) * m * c;
  for (int u = lane % lanes; u < units; u += lanes) {
    if constexpr (kVec) {
      const float4 v = reinterpret_cast<const float4*>(row)[u];
      for (int j = 0; j < j_count; ++j) {
        const int seg = __ldg(bidx + static_cast<size_t>(j) * r_count);
        if (seg < 0 || seg >= m) continue;
        const float4 add =
            bw == nullptr ? v : scale4(__ldg(bw + static_cast<size_t>(j) * r_count), v);
        atomicAdd(reinterpret_cast<float4*>(bout + static_cast<size_t>(seg) * c) + u,
                  add);
      }
    } else {
      const float v = row[u];
      for (int j = 0; j < j_count; ++j) {
        const int seg = __ldg(bidx + static_cast<size_t>(j) * r_count);
        if (seg < 0 || seg >= m) continue;
        const float add =
            bw == nullptr ? v : __fmul_rn(__ldg(bw + static_cast<size_t>(j) * r_count), v);
        atomicAdd(bout + static_cast<size_t>(seg) * c + u, add);
      }
    }
  }
}

}  // namespace

// idx (B, J, R) i32, w (B, J, R) f32 or NULL, values (B, R, C) f32
//   -> out (B, M, C) f32, zeroed here.
PN12_API int pn12_segment_matmul(const int* idx, const float* w,
                                 const float* values, float* out, int b,
                                 int j, int r, int m, int c, void* stream) {
  if (b <= 0 || j <= 0 || r <= 0 || m <= 0 || c <= 0 || b > 65535) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const cudaStream_t st = pn12::as_stream(stream);
  cudaError_t err = cudaMemsetAsync(
      out, 0, static_cast<size_t>(b) * m * c * sizeof(float), st);
  if (err != cudaSuccess) return static_cast<int>(err);
  const bool vec = c % 4 == 0 &&
                   reinterpret_cast<std::uintptr_t>(values) % 16 == 0 &&
                   reinterpret_cast<std::uintptr_t>(out) % 16 == 0;
  const int units = vec ? c / 4 : c;
  int lanes = 1;
  while (lanes < 32 && lanes < units) lanes <<= 1;
  const int rows_per_block = kWarps * (32 / lanes);
  const dim3 grid((r + rows_per_block - 1) / rows_per_block, b);
  if (vec) {
    segment_matmul_kernel<true><<<grid, kThreads, 0, st>>>(
        idx, w, values, out, j, r, m, c, units, lanes);
  } else {
    segment_matmul_kernel<false><<<grid, kThreads, 0, st>>>(
        idx, w, values, out, j, r, m, c, units, lanes);
  }
  return static_cast<int>(cudaGetLastError());
}

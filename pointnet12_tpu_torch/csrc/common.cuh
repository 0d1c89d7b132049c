// Shared helpers of the point-op kernels.
//
// Every kernel of this directory is exported with a plain C interface and
// bound from Python through ctypes (pointnet12_tpu_torch/kernels/build.py):
// device pointers, sizes and the CUDA stream come in as plain arguments, the
// kernel launches on that stream, allocates nothing, and the entry point
// returns cudaGetLastError() so the Python wrapper can raise on a refused
// launch.
#pragma once

#include <cuda_runtime.h>

#define PN12_API extern "C" __attribute__((visibility("default")))

namespace pn12 {

// Squared distance in the direct form ((dx*dx + dy*dy) + dz*dz), rounded
// after every operation. The explicit _rn intrinsics keep nvcc from
// contracting a multiply and an add into one FMA, which would round
// differently from the reference (one flipped FPS argmax changes every
// index after it); the build passes --fmad=false as well.
__device__ __forceinline__ float direct_sq_dist(float ax, float ay, float az,
                                                float bx, float by, float bz) {
  const float dx = __fsub_rn(ax, bx);
  const float dy = __fsub_rn(ay, by);
  const float dz = __fsub_rn(az, bz);
  return __fadd_rn(__fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy)),
                   __fmul_rn(dz, dz));
}

// Asynchronous copies from device memory into shared memory (cp.async,
// sm_80+). A copy that is not `valid` writes zeros and reads nothing
// (src-size 0); `src` must still be a device address. 16-byte copies need
// both addresses 16-byte aligned and bypass L1 (.cg); 4-byte ones go
// through it (.ca). A thread's copies since its last commit form one group;
// wait<n> returns once at most n of its groups are in flight, and a
// __syncthreads after it makes every thread's landed copies visible.
__device__ __forceinline__ unsigned shared_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   shared_addr(dst)),
               "l"(src), "r"(valid ? 16 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async4(void* dst, const void* src,
                                          bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   shared_addr(dst)),
               "l"(src), "r"(valid ? 4 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// fp32 products on the tensor cores as three TF32 products (fused_sa.cu's
// chain, bn_stats.cu's fp32 route): a_hi b_hi + a_hi b_lo + a_lo b_hi, with
// hi = cvt.rna.tf32(v) and lo = cvt.rna.tf32(v - hi); the dropped a_lo b_lo
// and the lo roundings leave ~2^-22 of each product, fp32's own order.
//
// The bits of cvt.rna.tf32.f32(v) for a finite v: the 13 low bits rounded
// off to nearest, ties away from zero (a carry into the exponent is the
// round up), by integer arithmetic: the conversion unit runs 16 results a
// clock an SM, the integer units 64.
__device__ __forceinline__ unsigned tf32_rna(float v) {
  return (__float_as_uint(v) + 0x1000u) & 0xffffe000u;
}

// v = hi + lo with hi, lo TF32 values: hi = rna(v), so v - hi is exact in
// fp32, and lo = rna(v - hi).
__device__ __forceinline__ void split_tf32(float v, unsigned& hi, unsigned& lo) {
  hi = tf32_rna(v);
  lo = tf32_rna(__fsub_rn(v, __uint_as_float(hi)));
}

// d += a (16 x 8, row-major) * b (8 x 8, column-major), TF32 in, fp32 sum.
// Fragments (g = lane / 4, t = lane % 4): a0..a3 = a(g, t), a(g + 8, t),
// a(g, t + 4), a(g + 8, t + 4); b0, b1 = b(t, g), b(t + 4, g); d0..d3 =
// d(g, 2t), d(g, 2t + 1), d(g + 8, 2t), d(g + 8, 2t + 1).
__device__ __forceinline__ void mma_tf32(float (&d)[4], const unsigned (&a)[4],
                                         unsigned b0, unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0,%1,%2,%3}, "
      "{%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

inline cudaStream_t as_stream(void* stream) {
  return static_cast<cudaStream_t>(stream);
}

}  // namespace pn12

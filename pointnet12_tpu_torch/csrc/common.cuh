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

inline cudaStream_t as_stream(void* stream) {
  return static_cast<cudaStream_t>(stream);
}

}  // namespace pn12

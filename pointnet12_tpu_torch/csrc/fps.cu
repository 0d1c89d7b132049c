// Farthest-point sampling.
//
// Replaces: pointnet12_tpu/kernels/fps_pallas.py::fps_pallas (_fps_kernel).
//
// What bounds it: the time of one iteration, not bytes or FLOPs. Each of
// the npoint iterations needs the previous iteration's argmax, so the layer
// is a serial chain of {distance update, block-wide argmax}, one block a
// cloud. An iteration costs the scan (~10 instructions a point: 8 for the
// direct-form distance, its min, a max; bound by the instruction rate of
// the SM's four schedulers) plus the argmax's dependent latency (two warp
// reductions, a barrier, shared-memory round trips), which sets the pace
// at small N.
// The design keeps that chain short:
//
// - One block a cloud, one launch a call. Thread t owns the contiguous
//   points [t*k, (t+1)*k), so index order is (warp, lane, slot) order: the
//   argmax's tie goes to the lowest warp, then the lowest lane, then the
//   lowest slot, with no index in the reductions.
// - A warp's argmax is __reduce_max_sync on the bits of the running maxima
//   of the lanes (distances are >= +0 and finite, so their bits order as
//   unsigned), one __ballot_sync of the lanes at that maximum and __ffs for
//   the lowest: no shuffled (value, index) pairs. Only that lane then looks
//   for its lowest slot at the maximum.
// - Each warp's winner writes (bits, index) to its slot in shared memory
//   (and in the shared form its x, y, z); after ONE __syncthreads every
//   warp reduces the <= 32 slots itself the same way and reads the winner's
//   coordinates from shared memory: the register form keeps a copy of the
//   whole cloud there by point index. Nothing in the loop reads device
//   memory for the new centroid.
// - One barrier an iteration: the slots are double-buffered by iteration
//   parity. Iteration it writes buffer it&1, meets the barrier and reads
//   it. A warp can write buffer it&1 again only in iteration it+2, after it
//   has passed iteration it+1's barrier; every warp reaches that barrier
//   only after its reads of iteration it. So no write overtakes a read.
//
// Three forms by N, all instances of the one template fps_kernel:
// - register form (kShared false): kSlots <= 32 points a thread in
//   registers (x, y, z and the running minimum: 8 at 1024 threads, 16 at
//   512, 32 below), N <= kSlots * kThreads <= 8192; the cloud's copy in
//   shared memory is 12*N bytes;
// - shared form (kShared true): the coordinates of the first kSlots slots
//   of every thread as x, y, z planes in dynamic shared memory (slot-major,
//   so a warp's reads are conflict-free; 12 bytes a point, 18 slots of 1024
//   threads = 221184 bytes), their minima in registers;
// - streamed (the shared form with k > kSlots): the remaining slots as
//   (x, y, z, running minimum) float4s in a scratch buffer of device memory
//   (slot-major, coalesced, L2-resident), which the kernel fills itself at
//   its start, so a call stays one launch and one device event.
// Points past N (pads) take point 0's coordinates: their distance always
// equals point 0's, which comes first, so a pad never wins.
//
// Numerics, as the Pallas kernel and the plain versions: direct-form
// distances (dx*dx + dy*dy) + dz*dz rounded after every operation, running
// minimum initialised to 1e10, argmax ties to the lowest index.
#include <algorithm>

#include "common.cuh"

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr float kInit = 1e10f;
constexpr size_t kDefaultSharedBytes = 48 * 1024;

// Per warp and parity: the warp's winner (its coordinates in the shared
// form), so no one reads the cloud for it.
struct Winners {
  unsigned bits[2][32];
  int idx[2][32];
  float x[2][32], y[2][32], z[2][32];
};

// k: points a thread owns (kSlots in the register form, ceil(n / kThreads)
// in the shared form). scratch: (B, k - kSlots, kThreads) float4s when the
// shared form streams, else unused.
template <int kThreads, int kSlots, bool kShared>
__global__ void __launch_bounds__(kThreads)
    fps_kernel(const float* __restrict__ xyz, const int* __restrict__ start,
               int* __restrict__ out, float4* scratch, int n, int npoint,
               int k) {
  // x, y, z planes: in the register form the whole cloud by point index
  // (where the block's winner finds its coordinates), in the shared form
  // the held slots, slot-major (where the scan reads them)
  extern __shared__ float planes[];
  __shared__ Winners s;
  constexpr int kWarps = kThreads / 32;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const float* cloud = xyz + static_cast<size_t>(blockIdx.x) * n * 3;
  int* out_row = out + static_cast<size_t>(blockIdx.x) * npoint;
  const int first = tid * k;
  const int held = kShared ? min(k, kSlots) : kSlots;  // slots in the block
  const int streamed = k - held;
  const int plane = kShared ? held * kThreads : n;
  float* sx = planes;
  float* sy = planes + plane;
  float* sz = planes + 2 * plane;
  // this thread's streamed slot j sits at mine[(j - held) * kThreads]
  float4* mine = streamed > 0
      ? scratch + static_cast<size_t>(blockIdx.x) * streamed * kThreads + tid
      : nullptr;

  float px[kShared ? 1 : kSlots], py[kShared ? 1 : kSlots], pz[kShared ? 1 : kSlots];
  float dist[kSlots];
#pragma unroll
  for (int j = 0; j < kSlots; ++j) {
    dist[j] = kInit;
    if (kShared && j >= held) continue;
    const int i = first + j < n ? first + j : 0;  // a pad copies point 0
    const float x = cloud[3 * i + 0], y = cloud[3 * i + 1], z = cloud[3 * i + 2];
    if constexpr (kShared) {
      sx[j * kThreads + tid] = x;
      sy[j * kThreads + tid] = y;
      sz[j * kThreads + tid] = z;
    } else {
      px[j] = x;
      py[j] = y;
      pz[j] = z;
    }
  }
  if constexpr (kShared) {
    for (int j = held; j < k; ++j) {
      const int i = first + j < n ? first + j : 0;
      mine[static_cast<size_t>(j - held) * kThreads] =
          make_float4(cloud[3 * i + 0], cloud[3 * i + 1], cloud[3 * i + 2], kInit);
    }
  } else {
    for (int i = tid; i < n; i += kThreads) {
      sx[i] = cloud[3 * i + 0];
      sy[i] = cloud[3 * i + 1];
      sz[i] = cloud[3 * i + 2];
    }
  }
  __syncthreads();

  int far = start[blockIdx.x];
  float cx = cloud[3 * far + 0], cy = cloud[3 * far + 1], cz = cloud[3 * far + 2];
  if (tid == 0) out_row[0] = far;

  for (int it = 1; it < npoint; ++it) {
    // the scan: 8 operations of the distance, its min and a max a point
    float best = 0.0f;  // every running minimum is >= +0
#pragma unroll
    for (int j = 0; j < kSlots; ++j) {
      if (kShared && j >= held) break;
      float x, y, z;
      if constexpr (kShared) {
        x = sx[j * kThreads + tid];
        y = sy[j * kThreads + tid];
        z = sz[j * kThreads + tid];
      } else {
        x = px[j];
        y = py[j];
        z = pz[j];
      }
      dist[j] = fminf(dist[j], pn12::direct_sq_dist(x, y, z, cx, cy, cz));
      best = fmaxf(best, dist[j]);
    }
    if constexpr (kShared) {
      for (int j = held; j < k; ++j) {
        float4* p = mine + static_cast<size_t>(j - held) * kThreads;
        const float4 q = *p;
        const float d = pn12::direct_sq_dist(q.x, q.y, q.z, cx, cy, cz);
        if (d < q.w) reinterpret_cast<float*>(p)[3] = d;
        best = fmaxf(best, fminf(q.w, d));
      }
    }

    // this warp's winner: the lowest lane at the warp's largest minimum,
    // which alone looks for its lowest slot at it
    const int buf = it & 1;
    const unsigned bits = __float_as_uint(best);
    const unsigned wmax = __reduce_max_sync(kFull, bits);
    if (lane == __ffs(__ballot_sync(kFull, bits == wmax)) - 1) {
      int slot = -1;
#pragma unroll
      for (int j = kSlots - 1; j >= 0; --j) {
        if (j < held && dist[j] == best) slot = j;
      }
      if constexpr (kShared) {
        float x, y, z;
        if (slot >= 0) {
          x = sx[slot * kThreads + tid];
          y = sy[slot * kThreads + tid];
          z = sz[slot * kThreads + tid];
        } else {  // a streamed slot: the first at the maximum
          float4 q;
          for (slot = held;; ++slot) {
            q = mine[static_cast<size_t>(slot - held) * kThreads];
            if (q.w == best || slot == k - 1) break;
          }
          x = q.x;
          y = q.y;
          z = q.z;
        }
        s.x[buf][warp] = x;
        s.y[buf][warp] = y;
        s.z[buf][warp] = z;
      }
      s.bits[buf][warp] = bits;
      s.idx[buf][warp] = first + slot;
    }
    __syncthreads();
    // the block's winner, found by every warp: the lowest warp at the
    // largest (lanes past kWarps hold 0, which lane 0 ties or beats)
    const unsigned wb = lane < kWarps ? s.bits[buf][lane] : 0u;
    const unsigned bmax = __reduce_max_sync(kFull, wb);
    const int w = __ffs(__ballot_sync(kFull, wb == bmax)) - 1;
    far = s.idx[buf][w];
    if constexpr (kShared) {
      cx = s.x[buf][w];
      cy = s.y[buf][w];
      cz = s.z[buf][w];
    } else {
      cx = sx[far];
      cy = sy[far];
      cz = sz[far];
    }
    if (tid == 0) out_row[it] = far;
  }
}

template <int kThreads, int kSlots, bool kShared>
cudaError_t run(const float* xyz, const int* start, int* out, float4* scratch,
                int b, int n, int npoint, int k, cudaStream_t stream) {
  const size_t smem = sizeof(float) * 3 *
      (kShared ? static_cast<size_t>(std::min(k, kSlots)) * kThreads : n);
  if (smem + sizeof(Winners) > kDefaultSharedBytes) {  // static + dynamic
    const cudaError_t err = cudaFuncSetAttribute(
        fps_kernel<kThreads, kSlots, kShared>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return err;
  }
  fps_kernel<kThreads, kSlots, kShared><<<b, kThreads, smem, stream>>>(
      xyz, start, out, scratch, n, npoint, k);
  return cudaGetLastError();
}

// The register form at 4 * kSlots registers of points a thread: up to 8
// at 1024 threads (64 registers a thread), 16 at 512, 32 below.
template <int kThreads>
cudaError_t run_registers(int slots, const float* xyz, const int* start,
                          int* out, int b, int n, int npoint,
                          cudaStream_t stream) {
  switch (slots) {
    case 1: return run<kThreads, 1, false>(xyz, start, out, nullptr, b, n, npoint, 1, stream);
    case 2: return run<kThreads, 2, false>(xyz, start, out, nullptr, b, n, npoint, 2, stream);
    case 4: return run<kThreads, 4, false>(xyz, start, out, nullptr, b, n, npoint, 4, stream);
    case 8: return run<kThreads, 8, false>(xyz, start, out, nullptr, b, n, npoint, 8, stream);
    case 16:
      if constexpr (kThreads <= 512) {
        return run<kThreads, 16, false>(xyz, start, out, nullptr, b, n, npoint, 16, stream);
      }
      return cudaErrorInvalidValue;
    case 32:
      if constexpr (kThreads <= 256) {
        return run<kThreads, 32, false>(xyz, start, out, nullptr, b, n, npoint, 32, stream);
      }
      return cudaErrorInvalidValue;
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// xyz (B, N, 3) f32, start (B,) i32 in [0, N) -> out (B, npoint) i32.
// threads, slots and shared name the instance (kernels/fps_cuda.py::
// fps_plan): shared 0 the register form, slots 1-32 (threads * slots >= N;
// see run_registers); shared 1 the shared form, slots = the planes' depth
// of that thread count (32 at 256 or 512 threads, 18 at 1024), with
// scratch holding B * (ceil(N / threads) - slots) * threads float4s when
// that is positive.
PN12_API int pn12_fps(const float* xyz, const int* start, int* out,
                      void* scratch, int b, int n, int npoint, int threads,
                      int slots, int shared, void* stream) {
  if (b <= 0 || n <= 0 || npoint <= 0 || npoint > n || threads <= 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const cudaStream_t st = pn12::as_stream(stream);
  if (!shared) {
    if (static_cast<long long>(threads) * slots < n) {
      return static_cast<int>(cudaErrorInvalidValue);
    }
    switch (threads) {
      case 32: return static_cast<int>(run_registers<32>(slots, xyz, start, out, b, n, npoint, st));
      case 64: return static_cast<int>(run_registers<64>(slots, xyz, start, out, b, n, npoint, st));
      case 128: return static_cast<int>(run_registers<128>(slots, xyz, start, out, b, n, npoint, st));
      case 256: return static_cast<int>(run_registers<256>(slots, xyz, start, out, b, n, npoint, st));
      case 512: return static_cast<int>(run_registers<512>(slots, xyz, start, out, b, n, npoint, st));
      case 1024: return static_cast<int>(run_registers<1024>(slots, xyz, start, out, b, n, npoint, st));
      default: return static_cast<int>(cudaErrorInvalidValue);
    }
  }
  const int k = (n + threads - 1) / threads;
  if (k > slots && scratch == nullptr) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  float4* sc = static_cast<float4*>(scratch);
  cudaError_t err = cudaErrorInvalidValue;
  if (threads == 256 && slots == 32) {
    err = run<256, 32, true>(xyz, start, out, sc, b, n, npoint, k, st);
  } else if (threads == 512 && slots == 32) {
    err = run<512, 32, true>(xyz, start, out, sc, b, n, npoint, k, st);
  } else if (threads == 1024 && slots == 18) {
    err = run<1024, 18, true>(xyz, start, out, sc, b, n, npoint, k, st);
  }
  return static_cast<int>(err);
}

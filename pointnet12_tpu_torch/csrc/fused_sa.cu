// Fused eval set abstraction: ball query, gather, BN-folded MLP chain and
// K-max of one SA layer in one kernel.
//
// Replaces:
//   pointnet12_tpu/kernels/fused_sa_eval.py::fused_sa_eval_dense
//     (_fused_dense_kernel) -> fused_sa_dense_kernel, and
//   pointnet12_tpu/kernels/fused_sa_eval.py::fused_sa_eval_grid
//     (_fused_grid_kernel) -> fused_sa_grid_kernel.
// Contract (fused_sa_eval_ref, pointnet12_tpu_torch/ops/fused_sa.py::
// fused_sa_eval_torch): idx = the ball query (first K in-radius indices
// ascending, the rest the first of them, N for a center with none);
//   h_0 = relu(w[clamp(idx, 0, N - 1)] - t[center])           (K, C1)
//   h_i = h_{i-1} @ W_i + b_i, with a ReLU between the layers
//   out[center] = relu(max over K of h_L)                      (C_out,)
// w = pts @ W0f + b0f and t = centers @ W0f[:3] are the lifted, BN-folded
// first Dense, computed outside (F.linear); the layers W_i (Ci, Co) are the
// later Denses with their BN folded, all fp32. An empty center gathers
// w[N - 1], the clamped sentinel, as index_points does.
//
// What bounds it: operations. At B=16, N=4096 each of pointnet2_semseg's
// four SA layers runs ~3.2 GFLOP of chain products, while its inputs and
// output are 0.3-15 MB (under 5 us at 3.35 TB/s). As three TF32 products
// each on the 495 TFLOP/s tensor cores that is ~20 us a layer; the
// neighbour search and the elementwise ops stay on the 67 TFLOP/s SIMT
// units (H100 SXM data sheet). The unfused path writes and reads back every
// grouped (B, S, K, C) stage, 67-134 MB each at SA1; here they live in
// shared memory only.
//
// Design: a block of 8 warps takes `cpb` centers of one cloud (1-8, chosen
// by make_layout within 227 KB of shared memory: at pointnet2_semseg's
// SA1-SA4 8 and 4 (two blocks an SM), 4 and 2 (one), with weight chunks of
// 64, 64, 64 and 32 columns).
//   0. The first staged chunk of W_1 is in flight from the block's start.
//   1. Warp i finds center i's neighbours (neighbours.cuh): the dense
//      kernel scans all N in index order (first_k_scan, ballquery.cu's
//      scan); the grid kernel scans the 27 cells around the center through
//      grid_prep's sorted points and a bitmask of original indices
//      (neighbours.cuh::first_k_grid), taking the centers in
//      cell order so a block's centers are neighbours.
//   2. The block gathers the rows w[idx] - t, ReLU, into shared memory, K
//      rows a center rounded up to 16 (the pad rows repeat the center's
//      first neighbour, so they change no max); a warp takes 4 rows at a
//      time across its lanes, so 4 loads a lane are in flight.
//   3. Each layer runs on the tensor cores, fp32-faithful: every product is
//      three TF32 mma.sync m16n8k8, a_hi b_hi + a_hi b_lo + a_lo b_hi with
//      hi = cvt.rna.tf32(v) and lo = cvt.rna.tf32(v - hi) (both computed by
//      integer arithmetic, bit for bit), summed in fp32
//      (the dropped a_lo b_lo and the lo roundings leave ~2^-22 of each
//      product, fp32's own order). The kernel splits both operands as it
//      loads a fragment: the activations from the fp32 buffer, the weights
//      from fp32 chunks of W_i (all Ci rows x 16-64 columns) staged with
//      cp.async in two buffers, the next chunk (of this layer or the next)
//      in flight while the warps multiply the current one. A warp's task is
//      a register tile of 32 x 32 (where one block fills an SM's shared
//      memory, so its threads may hold 255 registers: the kernels' kWide
//      instances), 32 x 16, 16 x 16 or 16 x 8 over all Ci (the largest
//      that leaves no warp idle), whose three products sum in
//      three accumulators (three independent mma chains), the bias added
//      after the sum, as the plain version does, then the ReLU into the
//      other buffer.
//   4. The last layer never reaches shared memory: a warp's task is one
//      center's rows x 16 (or 8) columns, the max over K taken from the
//      accumulators in registers and across the lanes by shuffles, then the
//      ReLU and the only write.
// What holds it back on the H100 (trials whose scripts are not kept): the
// instructions around each mma, not the tensor cores: the split (four
// integer and float operations an operand element, redone for every
// fragment) and the shared-memory loads of the fragments; then the two
// barriers of every weight chunk, so wider chunks won over more centers a
// block. SA4's 256 centers at 2 a block fill 128 of the 132 SMs once.
// The TPU kernels gathered through one-hot selection matmuls (Mosaic has no
// dynamic row gather) with a bf16 hi/lo split, rebuilt index columns with
// matmuls and averaged duplicate window hits; a block here loads w[idx].
#include <algorithm>

#include "neighbours.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxLayers = 8;
constexpr int kMaxCenters = kWarps;  // one search warp a center
// two blocks an SM: 228 KB of shared memory, 1 KB of it reserved a block
constexpr size_t kTwoBlocksBytes = 113 * 1024;
constexpr size_t kMaxSharedBytes = 232448;  // 227 KB, sm_90's per-block limit

struct Chain {
  const float* w[kMaxLayers];  // layer i: (width[i], width[i + 1]), row-major
  const float* b[kMaxLayers];  // (width[i + 1],)
  int width[kMaxLayers + 1];   // width[0] = C1
  int layers;
};

struct Layout {
  int cpb;      // centers a block, <= kMaxCenters
  int kp;       // rows a center: K rounded up to 16
  int ld;       // row stride of the activation buffers: the widest stored
                // width rounded up to 8, plus 4 (A fragments conflict-free)
  int nc;       // columns of a staged weight chunk, at most: 16, 32 or 64
  int wfloats;  // floats of one weight buffer
  int words;    // mask words a warp (grid kernel), else 0
  int vec;      // 16-byte weight copies: every Co % 4 == 0, pointers aligned
};

struct Args {
  const float* xyz;      // (B, N, 3)
  const float* centers;  // (B, S, 3)
  const float* w;        // (B, N, C1)
  const float* t;        // (B, S, C1)
  float* out;            // (B, S, C_out)
  int n, s, k;
  float r2;
  // grid kernel only (grid_prep): perm (B, N), offsets (B, g^3 + 1),
  // qperm (B, S), qcell (B, S)
  const int* perm;
  const int* offsets;
  const int* qperm;
  const int* qcell;
  int g;
};

__host__ __device__ __forceinline__ int round_up(int v, int m) {
  return (v + m - 1) / m * m;
}

// Columns of layer i's staged chunks.
__host__ __device__ __forceinline__ int chunk_cols(const Chain& ch, int nc, int i) {
  const int cols = round_up(ch.width[i + 1], 16);
  return cols < nc ? cols : nc;
}

using pn12::mma_tf32;
using pn12::split_tf32;

// acc[i][j] += a (rows i * 16 .., stride ld, kpad columns) @ b (kpad rows,
// stride ldw; columns j * 8 ..), i < MT, j < NT, as three TF32 products.
// The two small terms sum in accumulators of their own, so a tile has three
// independent chains of mma.sync, and join the large one at the end:
// acc + (a_hi b_lo + a_lo b_hi).
template <int MT, int NT>
__device__ __forceinline__ void mma_tile(const float* a, int ld, const float* b,
                                         int ldw, int kpad, float (&acc)[MT][NT][4],
                                         int lane) {
  const int g = lane >> 2;
  const int t = lane & 3;
  const float* ap = a + g * ld + t;
  const float* bp = b + t * ldw + g;
  float hl[MT][NT][4] = {};
  float lh[MT][NT][4] = {};
  // unrolled: the loads of the next k-steps issue before this one's products
#pragma unroll 4
  for (int k0 = 0; k0 < kpad; k0 += 8) {
    unsigned ah[MT][4], al[MT][4];
#pragma unroll
    for (int i = 0; i < MT; ++i) {
      const float* p = ap + i * 16 * ld + k0;
      split_tf32(p[0], ah[i][0], al[i][0]);               // (g, t)
      split_tf32(p[8 * ld], ah[i][1], al[i][1]);          // (g + 8, t)
      split_tf32(p[4], ah[i][2], al[i][2]);               // (g, t + 4)
      split_tf32(p[8 * ld + 4], ah[i][3], al[i][3]);      // (g + 8, t + 4)
    }
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      unsigned bh[2], bl[2];
      split_tf32(bp[k0 * ldw + j * 8], bh[0], bl[0]);        // (k t, n g)
      split_tf32(bp[(k0 + 4) * ldw + j * 8], bh[1], bl[1]);  // (k t + 4, n g)
#pragma unroll
      for (int i = 0; i < MT; ++i) {
        mma_tf32(lh[i][j], al[i], bh[0], bh[1]);
        mma_tf32(hl[i][j], ah[i], bl[0], bl[1]);
        mma_tf32(acc[i][j], ah[i], bh[0], bh[1]);
      }
    }
  }
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        acc[i][j][e] = __fadd_rn(acc[i][j][e], __fadd_rn(hl[i][j][e], lh[i][j][e]));
}

// Stage columns n0 .. n0 + nc - 1 of layer i's weights (every row, padded
// with zeros to a multiple of 8 rows and past Co) into dst, row stride
// nc + 8 (B fragments conflict-free), with cp.async; the caller commits.
__device__ __forceinline__ void stage_chunk(float* dst, const Chain& ch,
                                            const Layout& lay, int i, int n0) {
  const int ci = ch.width[i];
  const int co = ch.width[i + 1];
  const int nc = chunk_cols(ch, lay.nc, i);
  const int ldw = nc + 8;
  const int rows = round_up(ci, 8);
  const float* w = ch.w[i];
  if (lay.vec) {
    const int segs = nc / 4;
    for (int e = threadIdx.x; e < rows * segs; e += kThreads) {
      const int kk = e / segs;
      const int c = (e % segs) * 4;
      const bool ok = kk < ci && n0 + c < co;  // Co % 4 == 0: the whole segment
      pn12::cp_async16(dst + kk * ldw + c,
                       ok ? w + static_cast<size_t>(kk) * co + n0 + c : w, ok);
    }
  } else {
    for (int e = threadIdx.x; e < rows * nc; e += kThreads) {
      const int kk = e / nc;
      const int c = e % nc;
      const bool ok = kk < ci && n0 + c < co;
      pn12::cp_async4(dst + kk * ldw + c,
                      ok ? w + static_cast<size_t>(kk) * co + n0 + c : w, ok);
    }
  }
}

// One chunk of a layer that is not the last: other[rows, n0 ..] =
// relu(act @ W + b), tasks of 16 * MT rows x 8 * NT columns.
template <int MT, int NT>
__device__ __forceinline__ void hidden_chunk(const float* act, float* other,
                                             int rows, int ld, const float* ws,
                                             int ldw, int kpad, int nc, int n0,
                                             int co, const float* __restrict__ bias) {
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;
  const int t = lane & 3;
  const int groups = nc / (8 * NT);
  const int tasks = rows / (16 * MT) * groups;
  const int stored = round_up(co, 8);  // the pad columns come out 0: W, b are 0
  for (int task = threadIdx.x >> 5; task < tasks; task += kWarps) {
    const int m0 = task / groups * 16 * MT;
    const int c0 = task % groups * 8 * NT;
    float acc[MT][NT][4] = {};
    mma_tile<MT, NT>(act + m0 * ld, ld, ws + c0, ldw, kpad, acc, lane);
#pragma unroll
    for (int j = 0; j < NT; ++j) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int col = n0 + c0 + j * 8 + 2 * t + e;
        if (col >= stored) continue;
        const float bj = col < co ? bias[col] : 0.0f;
#pragma unroll
        for (int i = 0; i < MT; ++i) {
          float* o = other + (m0 + i * 16 + g) * ld + col;
          o[0] = fmaxf(__fadd_rn(acc[i][j][e], bj), 0.0f);
          o[8 * ld] = fmaxf(__fadd_rn(acc[i][j][2 + e], bj), 0.0f);
        }
      }
    }
  }
}

// One chunk of the last layer: out[center, n0 ..] = relu(max over the
// center's kp rows of act @ W + b), tasks of one center x 8 * NT columns,
// its rows 16 * MT at a time; the max from the accumulators, then across
// the 8 lanes of a column.
template <int MT, int NT>
__device__ __forceinline__ void last_chunk(const float* act, int ld, int kp,
                                           int centers, const int* center,
                                           const float* ws, int ldw, int kpad,
                                           int nc, int n0, int co,
                                           const float* __restrict__ bias,
                                           float* out) {
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;
  const int t = lane & 3;
  const int groups = nc / (8 * NT);
  const int tasks = centers * groups;
  for (int task = threadIdx.x >> 5; task < tasks; task += kWarps) {
    const int cc = task / groups;
    const int c0 = task % groups * 8 * NT;
    float mx[NT][2];
    float bj[NT][2];
#pragma unroll
    for (int j = 0; j < NT; ++j) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int col = n0 + c0 + j * 8 + 2 * t + e;
        mx[j][e] = __int_as_float(0xff800000);  // -inf
        bj[j][e] = col < co ? bias[col] : 0.0f;
      }
    }
    for (int m0 = cc * kp; m0 < (cc + 1) * kp; m0 += 16 * MT) {
      float acc[MT][NT][4] = {};
      mma_tile<MT, NT>(act + m0 * ld, ld, ws + c0, ldw, kpad, acc, lane);
#pragma unroll
      for (int i = 0; i < MT; ++i) {
#pragma unroll
        for (int j = 0; j < NT; ++j) {
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            mx[j][e] = fmaxf(mx[j][e], fmaxf(__fadd_rn(acc[i][j][e], bj[j][e]),
                                             __fadd_rn(acc[i][j][2 + e], bj[j][e])));
          }
        }
      }
    }
#pragma unroll
    for (int j = 0; j < NT; ++j) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
#pragma unroll
        for (int off = 4; off < 32; off <<= 1) {
          mx[j][e] = fmaxf(mx[j][e], __shfl_xor_sync(0xffffffffu, mx[j][e], off));
        }
        const int col = n0 + c0 + j * 8 + 2 * t + e;
        if (g == 0 && col < co) {
          out[static_cast<size_t>(center[cc]) * co + col] = fmaxf(mx[j][e], 0.0f);
        }
      }
    }
  }
}

// The task shapes of one chunk: the largest register tile (16 * MT rows x
// 8 * NT columns) that still gives every warp a task, where one does;
// 32 x 32 only in a kWide instance, which runs one block an SM and so may
// hold the registers it needs.
template <bool kWide>
__device__ __forceinline__ void run_chunk(bool last, const float* act, float* other,
                                          int rows, int ld, int kp, int live,
                                          const int* center, const float* ws,
                                          int ldw, int kpad, int nc, int n0, int co,
                                          const float* __restrict__ bias,
                                          float* out) {
  if (!last) {
    if (kWide && rows % 32 == 0 && nc % 32 == 0 && rows / 32 * (nc / 32) >= kWarps) {
      hidden_chunk<2, 4>(act, other, rows, ld, ws, ldw, kpad, nc, n0, co, bias);
    } else if (rows % 32 == 0 && rows / 32 * (nc / 16) >= kWarps) {
      hidden_chunk<2, 2>(act, other, rows, ld, ws, ldw, kpad, nc, n0, co, bias);
    } else if (rows / 16 * (nc / 16) >= kWarps) {
      hidden_chunk<1, 2>(act, other, rows, ld, ws, ldw, kpad, nc, n0, co, bias);
    } else {
      hidden_chunk<1, 1>(act, other, rows, ld, ws, ldw, kpad, nc, n0, co, bias);
    }
    return;
  }
  const bool pairs = live * (nc / 16) >= kWarps;
  if (kWide && kp % 32 == 0 && nc % 32 == 0 && live * (nc / 32) >= kWarps) {
    last_chunk<2, 4>(act, ld, kp, live, center, ws, ldw, kpad, nc, n0, co, bias, out);
  } else if (kp % 32 == 0) {
    if (pairs) {
      last_chunk<2, 2>(act, ld, kp, live, center, ws, ldw, kpad, nc, n0, co, bias, out);
    } else {
      last_chunk<2, 1>(act, ld, kp, live, center, ws, ldw, kpad, nc, n0, co, bias, out);
    }
  } else if (pairs) {
    last_chunk<1, 2>(act, ld, kp, live, center, ws, ldw, kpad, nc, n0, co, bias, out);
  } else {
    last_chunk<1, 1>(act, ld, kp, live, center, ws, ldw, kpad, nc, n0, co, bias, out);
  }
}

template <bool kGrid, bool kWide>
__device__ __forceinline__ void fused_sa(const Args& a, const Chain& ch,
                                         const Layout& lay,
                                         unsigned char* smem) {
  const int rows = lay.cpb * lay.kp;
  float* wbuf = reinterpret_cast<float*>(smem);  // two buffers of wfloats
  float* act = wbuf + 2 * lay.wfloats;
  float* other = act + static_cast<size_t>(rows) * lay.ld;
  int* nbr = reinterpret_cast<int*>(other + static_cast<size_t>(rows) * lay.ld);
  int* center = nbr + lay.cpb * a.k;        // (cpb,) original center index
  unsigned* masks = reinterpret_cast<unsigned*>(center + lay.cpb);

  // 0. the first weight chunk streams in behind the search
  stage_chunk(wbuf, ch, lay, 0, 0);
  pn12::cp_async_commit();

  const int per_cloud = (a.s + lay.cpb - 1) / lay.cpb;
  const int b = blockIdx.x / per_cloud;
  const int j0 = (blockIdx.x % per_cloud) * lay.cpb;
  const int live = min(lay.cpb, a.s - j0);  // centers of this block
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const float* cloud = a.xyz + static_cast<size_t>(b) * a.n * 3;

  // 1. neighbours: warp i searches the block's center i
  if (warp < live) {
    const size_t j = static_cast<size_t>(b) * a.s + j0 + warp;
    const int sidx = kGrid ? a.qperm[j] : j0 + warp;
    const float* q = a.centers + (static_cast<size_t>(b) * a.s + sidx) * 3;
    int* row = nbr + warp * a.k;
    if (kGrid) {
      const pn12::Grid grid{
          cloud, a.perm + static_cast<size_t>(b) * a.n,
          a.offsets + static_cast<size_t>(b) * (a.g * a.g * a.g + 1), a.n,
          a.g};
      pn12::first_k_grid(grid, a.qcell[j], q[0], q[1], q[2], a.r2, a.k,
                         masks + warp * lay.words, row, lane);
    } else {
      pn12::first_k_scan(cloud, a.n, q[0], q[1], q[2], a.r2, a.k, row, lane);
    }
    if (lane == 0) center[warp] = sidx;
  }
  __syncthreads();

  // 2. h_0 = relu(w[idx] - t), the index clamped as index_points does; pad
  // rows repeat the center's first neighbour, pad columns and the rows of
  // absent centers are 0
  const int c1 = ch.width[0];
  const int c1p = round_up(c1, 8);
  const float* w = a.w + static_cast<size_t>(b) * a.n * c1;
  const float* t = a.t + static_cast<size_t>(b) * a.s * c1;
  // a warp takes 4 rows at a time and its lanes the columns: 4 loads of w
  // (and of the centers' t, mostly from L1) in flight a lane, not one
  for (int r0 = warp * 4; r0 < rows; r0 += kWarps * 4) {  // rows % 16 == 0
    const float* src[4];
    const float* sub[4];
    bool ok[4];
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const int cc = (r0 + u) / lay.kp;
      const int slot = r0 + u - cc * lay.kp;
      ok[u] = cc < live;
      const int idx = ok[u] ? min(max(nbr[cc * a.k + (slot < a.k ? slot : 0)], 0), a.n - 1) : 0;
      src[u] = w + static_cast<size_t>(idx) * c1;
      sub[u] = t + static_cast<size_t>(ok[u] ? center[cc] : 0) * c1;
    }
    for (int c = lane; c < c1p; c += 32) {
      float v[4];
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        v[u] = ok[u] && c < c1 ? __fsub_rn(src[u][c], sub[u][c]) : 0.0f;
      }
#pragma unroll
      for (int u = 0; u < 4; ++u) act[(r0 + u) * lay.ld + c] = fmaxf(v[u], 0.0f);
    }
  }

  // 3-4. the folded chain, chunk by chunk, the next chunk always in flight
  const int co_last = ch.width[ch.layers];
  float* out = a.out + static_cast<size_t>(b) * a.s * co_last;
  int q = 0;  // chunks so far, over every layer
  for (int i = 0; i < ch.layers; ++i) {
    const int ci = ch.width[i];
    const int co = ch.width[i + 1];
    const int ncols = chunk_cols(ch, lay.nc, i);
    const int ldw = ncols + 8;
    const int kpad = round_up(ci, 8);
    const bool last = i + 1 == ch.layers;
    for (int n0 = 0; n0 < co; n0 += ncols, ++q) {
      const bool more_cols = n0 + ncols < co;
      if (more_cols || !last) {
        stage_chunk(wbuf + ((q + 1) & 1) * lay.wfloats, ch, lay, more_cols ? i : i + 1,
                    more_cols ? n0 + ncols : 0);
        pn12::cp_async_commit();
        pn12::cp_async_wait<1>();  // chunk q has landed
      } else {
        pn12::cp_async_wait<0>();
      }
      __syncthreads();  // ... for every thread; the layer's input is complete
      run_chunk<kWide>(last, act, other, rows, lay.ld, lay.kp, live, center,
                wbuf + (q & 1) * lay.wfloats, ldw, kpad, ncols, n0, co, ch.b[i], out);
      __syncthreads();  // buffer q & 1 is free; the layer's output complete
    }
    float* tmp = act;
    act = other;
    other = tmp;
  }
}

// kWide: one block an SM (its shared memory sees to that), so up to 255
// registers a thread and 32 x 32 register tiles; else two blocks an SM fit,
// at most 128 registers a thread.
template <bool kWide>
__global__ void __launch_bounds__(kThreads, kWide ? 1 : 2)
    fused_sa_dense_kernel(const Args a, const Chain ch, const Layout lay) {
  extern __shared__ __align__(16) unsigned char smem[];
  fused_sa<false, kWide>(a, ch, lay, smem);
}

template <bool kWide>
__global__ void __launch_bounds__(kThreads, kWide ? 1 : 2)
    fused_sa_grid_kernel(const Args a, const Chain ch, const Layout lay) {
  extern __shared__ __align__(16) unsigned char smem[];
  fused_sa<true, kWide>(a, ch, lay, smem);
}

// The chain from the host arrays of device pointers and widths; false when
// the shapes are out of the kernel's range.
bool make_chain(const void* const* weights, const void* const* biases,
                const int* widths, int layers, Chain* ch) {
  if (layers < 1 || layers > kMaxLayers) return false;
  ch->layers = layers;
  for (int i = 0; i <= layers; ++i) {
    if (widths[i] <= 0) return false;
    ch->width[i] = widths[i];
  }
  for (int i = 0; i < layers; ++i) {
    ch->w[i] = static_cast<const float*>(weights[i]);
    ch->b[i] = static_cast<const float*>(biases[i]);
  }
  return true;
}

// Centers a block, the weight chunks' width and the shared memory they
// need. The widest chunks (64, 32 or 16 columns) that still fit two
// centers a block (one where a cloud has one center), since a wider chunk
// gives the warps larger register tiles and fewer barriers; then, of one
// or two blocks an SM, the choice that keeps the most centers in flight on
// an SM, on a tie two blocks (one block's search and gather run beside
// the other's products). Returns false when not even one center fits.
bool make_layout(const Chain& ch, int k, int n, int s, bool grid, Layout* out,
                 size_t* smem) {
  int widest = 0;  // of the stored activations: every width but the last
  for (int i = 0; i < ch.layers; ++i) widest = std::max(widest, ch.width[i]);
  Layout lay{};
  lay.kp = round_up(k, 16);
  lay.ld = round_up(widest, 8) + 4;
  lay.words = grid ? pn12::mask_words(n) : 0;
  lay.vec = 1;
  for (int i = 0; i < ch.layers; ++i) {
    if (ch.width[i + 1] % 4 != 0 || (reinterpret_cast<size_t>(ch.w[i]) & 15) != 0) {
      lay.vec = 0;
    }
  }
  const size_t per_center =
      (2 * static_cast<size_t>(lay.kp) * lay.ld + k + 1 + lay.words) * 4;
  for (int want : {std::min(2, s), 1}) {
    for (int nc : {64, 32, 16}) {
      int wfloats = 0;
      for (int i = 0; i < ch.layers; ++i) {
        wfloats = std::max(wfloats, round_up(ch.width[i], 8) * (chunk_cols(ch, nc, i) + 8));
      }
      const size_t fixed = 2 * static_cast<size_t>(wfloats) * 4;
      int best_score = 0;
      for (int per_sm : {2, 1}) {
        const size_t limit = per_sm == 2 ? kTwoBlocksBytes : kMaxSharedBytes;
        if (limit <= fixed) continue;
        const int cpb = static_cast<int>(std::min<size_t>(
            {(limit - fixed) / per_center, static_cast<size_t>(kMaxCenters),
             static_cast<size_t>(s)}));
        const int score = cpb * per_sm;
        if (cpb < want || score <= best_score) continue;
        best_score = score;
        lay.cpb = cpb;
        lay.nc = nc;
        lay.wfloats = wfloats;
      }
      if (best_score > 0) {
        *smem = 2 * static_cast<size_t>(lay.wfloats) * 4 + lay.cpb * per_center;
        *out = lay;
        return true;
      }
    }
  }
  return false;
}

template <typename Kernel>
int launch(Kernel narrow, Kernel wide, const Args& a, const void* const* weights,
           const void* const* biases, const int* widths, int layers, int b,
           bool grid, void* stream) {
  Chain ch;
  if (b <= 0 || a.n <= 0 || a.s <= 0 || a.k <= 0 ||
      !make_chain(weights, biases, widths, layers, &ch)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  Layout lay;
  size_t smem = 0;
  if (!make_layout(ch, a.k, a.n, a.s, grid, &lay, &smem) || smem > kMaxSharedBytes) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const Kernel kernel = smem > kTwoBlocksBytes ? wide : narrow;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const int blocks = b * ((a.s + lay.cpb - 1) / lay.cpb);
  kernel<<<blocks, kThreads, smem, pn12::as_stream(stream)>>>(a, ch, lay);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// xyz (B, N, 3), centers (B, S, 3), w (B, N, C1), t (B, S, C1), the layers
// as host arrays of device pointers (weights[i] (widths[i], widths[i+1]),
// biases[i] (widths[i+1],)) and widths (layers + 1 ints), all f32
// -> out (B, S, widths[layers]) f32.
PN12_API int pn12_fused_sa_dense(const float* xyz, const float* centers,
                                 const float* w, const float* t,
                                 const void* const* weights,
                                 const void* const* biases, const int* widths,
                                 int layers, float* out, int b, int n, int s,
                                 int k, float r2, void* stream) {
  const Args a{xyz, centers, w, t, out, n, s, k, r2,
               nullptr, nullptr, nullptr, nullptr, 0};
  return launch(fused_sa_dense_kernel<false>, fused_sa_dense_kernel<true>, a, weights,
                biases, widths, layers, b, false, stream);
}

// As pn12_fused_sa_dense, with grid_prep's perm (B, N), offsets
// (B, g^3 + 1), qperm (B, S) and qcell (B, S), all i32.
PN12_API int pn12_fused_sa_grid(const float* xyz, const float* centers,
                                const float* w, const float* t,
                                const void* const* weights,
                                const void* const* biases, const int* widths,
                                int layers, const int* perm,
                                const int* offsets, const int* qperm,
                                const int* qcell, float* out, int b, int n,
                                int s, int k, int g, float r2, void* stream) {
  if (g <= 0) return static_cast<int>(cudaErrorInvalidValue);
  const Args a{xyz, centers, w, t, out, n, s, k, r2,
               perm, offsets, qperm, qcell, g};
  return launch(fused_sa_grid_kernel<false>, fused_sa_grid_kernel<true>, a, weights,
                biases, widths, layers, b, true, stream);
}

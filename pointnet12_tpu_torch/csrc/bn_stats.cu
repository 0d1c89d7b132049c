// Dense matmul with the BatchNorm batch statistics of its output.
//
// Replaces: pointnet12_tpu/kernels/bn_stats_fused.py::_pallas_fwd (_kernel),
// reached from dense_bn_stats, the train step's fused Dense + BN pair.
// Contract: x (R, Ci) and w (Co, Ci), both fp32 or both bf16, bias (Co) fp32;
//   y[r, c]  = round(sum_k x[r, k] w[c, k]) + round(bias[c])
//   mean[c]  = sum_r y[r, c] / R
//   var[c]   = max(sum_r y[r, c]^2 / R - mean[c]^2, 0)
// with the product accumulated in fp32, round() to y's dtype (identity for
// fp32) and the bias added in fp32 and rounded, as PyTorch adds two bf16
// tensors. The statistics are taken over the ROUNDED y, in fp32, in one
// pass: two running sums.
//
// What bounds it: over the 17 calls of a train step (R = 1024 to 524288
// rows, Ci = 32 to 768, Co = 32 to 512; 25 GFLOP) in bf16 the bytes: x, w
// and y once are ~0.46 GB, 137.6 us at 3.35 TB/s, against 25 us for the
// operations on the 989 TFLOP/s tensor cores (H100 SXM data sheet). The two
// SA1 calls (R = 524288, Ci = 32) and the three FP1 calls (R = 65536,
// 128 -> 128) are most of those bytes. In fp32 the operations bound it:
// 0.37 ms at 67 TFLOP/s outside the tensor cores.
//
// Design. The TPU kernel walked the rows in one sequential grid and carried
// the two sums in VMEM scratch. Here blocks run in no order, so the sums are
// taken in two passes, each in a fixed order, and the statistics are the
// same bits from run to run (unlike the segment sum's atomics).
//
// bf16, on the tensor cores (dense_bn_stats_mma): an item is 128 rows x BN
// columns of y (BN = 32, 64 or 128, the least that covers Co, so x is read
// once from device memory where Co <= 128; wider Co gives a row tile 2 or 4
// column tiles with consecutive item ids, whose re-reads of x hit L2). As
// many blocks of 8 warps as fit the card at once walk the items (a
// persistent grid), each item's k-tiles one step of a single stream.
//   - Loads: 32-deep tiles of x and w go into shared memory through
//     cp.async (16-byte copies, zero-filled past the edges; plain loads when
//     a row is not 16-byte aligned, Ci % 8 != 0) in a ring of 3-6 stages,
//     so the next steps, of this item or the next one, load while the
//     warps multiply and while the epilogue stores.
//   - Products: each warp owns 32 x BN/2 of the item: ldmatrix.x4
//     fragments and mma.sync m16n8k16 bf16 x bf16 -> fp32. bf16 products
//     are exact in fp32, so only the order of the sums differs from a
//     sequential sum.
//   - Epilogue: y is rounded in registers (two columns a packed
//     conversion), staged in shared memory and stored as 16-byte rows
//     (Co % 8 == 0). The statistics come from the rounded values in
//     registers in a fixed order: each thread sums its 4 rows of a column
//     (rows g, g+8, g+16, g+24 of its warp's 32, g = lane / 4), a butterfly
//     of shuffles (xor 4, 8, 16) sums the 8 lanes of a column, and the 4
//     warps along the rows add in order into one (2, BN) partial per row
//     tile (modelled in plain ops by kernels/bn_stats_cuda.py::
//     stats_in_kernel_order, which the card matches bit for bit).
//   What holds it back on the H100 (trials whose scripts are not kept): its
//   instruction stream, not the loads: blocks seldom wait for their tiles,
//   the epilogue of an item (conversions, shuffles, two barriers, the
//   stores) takes longer than its products, and more stages did not help.
// fp32, on the SIMT units (dense_bn_stats_kernel; no timed path runs it:
// the fp32 step does not fuse the statistics): a block computes a BM x BN
// tile from 16-deep shared-memory tiles, each thread a 4 x 4 register tile
// with __fmaf_rn (the build passes --fmad=false, so a * b + c would not
// fuse), the same per-row-tile partial from its epilogue. Not redesigned.
// Then dense_bn_stats_finalize: 128 lanes a column, 8 columns a block, sum
// the partials of every row tile in a fixed order (lane l the tiles l,
// l + 128, ..., 8 loads in flight; then lane 0 the 128 lane sums) and
// write mean and var.
#include <cuda_bf16.h>

#include "common.cuh"

namespace {

// the finalize pass: a block of kFinalCols columns x kFinalLanes lanes
constexpr int kFinalCols = 8;
constexpr int kFinalLanes = 128;
constexpr int kFinalBatch = 8;

// ---------------------------------------------------------------- bf16, tensor cores

constexpr int kMmaThreads = 256;  // 8 warps: 4 along the rows x 2 along the columns
constexpr int kMmaRows = 128;     // rows of a block's tile
constexpr int kTileKb = 32;       // depth of a staged tile: two k16 steps
// stages of the ring: as many as two blocks an SM can hold (of 228 KB), so
// the most tiles are in flight at small Ci, where an item is one k-tile
__host__ __device__ constexpr int mma_stages(int bn) { return bn == 32 ? 6 : bn == 64 ? 4 : 3; }
constexpr int kLdK = kTileKb + 8;  // row stride of a staged tile, bf16: 80 bytes,
                                   // so ldmatrix's 8 rows hit 8 distinct bank groups

typedef unsigned short bf16_bits;

__device__ __forceinline__ void ldmatrix_x4(unsigned (&r)[4], const bf16_bits* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(pn12::shared_addr(p)));
}

// d += a (16 x 16, row-major) * b (16 x 8, column-major), bf16 in, fp32 sum
__device__ __forceinline__ void mma_bf16(float (&d)[4], const unsigned (&a)[4],
                                         unsigned b0, unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0,%1,%2,%3}, "
      "{%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ float round_bf16(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

// Shared memory of an instance: the ring of mma_stages(BN) stages, the y tile,
// then the (4 warps, 2, BN) partials of the statistics.
__host__ __device__ constexpr size_t mma_ring_bytes(int bn) {
  return static_cast<size_t>(mma_stages(bn)) * (kMmaRows + bn) * kLdK * 2;
}
__host__ __device__ constexpr size_t mma_ytile_bytes(int bn) {
  return static_cast<size_t>(kMmaRows) * (bn + 8) * 2;
}
__host__ __device__ constexpr size_t mma_shared_bytes(int bn) {
  return mma_ring_bytes(bn) + mma_ytile_bytes(bn) + 4 * 2 * bn * 4;
}

// Stage k-tile `k0` of the block's x rows and w rows into xs / ws.
template <int BN>
__device__ __forceinline__ void load_tile(bf16_bits* xs, bf16_bits* ws,
                                          const bf16_bits* __restrict__ x,
                                          const bf16_bits* __restrict__ w,
                                          int row0, int col0, int k0, int r,
                                          int ci, int co, bool vec) {
  constexpr int kSegs = kTileKb / 8;  // 16-byte segments a row
  if (vec) {
    for (int e = threadIdx.x; e < (kMmaRows + BN) * kSegs; e += kMmaThreads) {
      const int i = e / kSegs;
      const int c = (e % kSegs) * 8;
      const int kk = k0 + c;
      const bool in_x = i < kMmaRows;
      const int row = in_x ? row0 + i : col0 + i - kMmaRows;
      const bool ok = kk < ci && row < (in_x ? r : co);  // Ci % 8 == 0
      const bf16_bits* base = in_x ? x : w;
      pn12::cp_async16((in_x ? xs + i * kLdK : ws + (i - kMmaRows) * kLdK) + c,
                       ok ? base + static_cast<size_t>(row) * ci + kk : base, ok);
    }
  } else {
    for (int e = threadIdx.x; e < (kMmaRows + BN) * kTileKb; e += kMmaThreads) {
      const int i = e / kTileKb;
      const int c = e % kTileKb;
      const int kk = k0 + c;
      const bool in_x = i < kMmaRows;
      const int row = in_x ? row0 + i : col0 + i - kMmaRows;
      const bool ok = kk < ci && row < (in_x ? r : co);
      const bf16_bits* base = in_x ? x : w;
      (in_x ? xs + i * kLdK : ws + (i - kMmaRows) * kLdK)[c] =
          ok ? base[static_cast<size_t>(row) * ci + kk] : 0;
    }
  }
}

// Round (acc0, acc1) to bf16, add the rounded bias pair in fp32 and round
// again, two columns in one packed conversion each time.
__device__ __forceinline__ __nv_bfloat162 output_pair(float acc0, float acc1,
                                                      float b0, float b1) {
  const float2 a = __bfloat1622float2(__floats2bfloat162_rn(acc0, acc1));
  return __floats2bfloat162_rn(__fadd_rn(a.x, b0), __fadd_rn(a.y, b1));
}

// A persistent block walks the items (row tile, column tile) blockIdx.x,
// blockIdx.x + gridDim.x, ..., and the k-tiles of each: one stream of
// steps through the ring, so the next item's tiles load while this one's
// epilogue runs.
template <int BN>
__global__ void __launch_bounds__(kMmaThreads, 2)
    dense_bn_stats_mma(const bf16_bits* __restrict__ x,
                       const bf16_bits* __restrict__ w,
                       const float* __restrict__ bias, bf16_bits* __restrict__ y,
                       float* __restrict__ partials, int r, int ci, int co,
                       int col_tiles, int items) {
  constexpr int WN = BN / 2;   // a warp's columns
  constexpr int NT = WN / 8;   // its n8 tiles
  constexpr int kYld = BN + 8; // row stride of the staged y tile
  constexpr int kStage = (kMmaRows + BN) * kLdK;  // bf16 a stage
  constexpr int kStages = mma_stages(BN);
  extern __shared__ __align__(16) unsigned char smem[];
  bf16_bits* ring = reinterpret_cast<bf16_bits*>(smem);
  bf16_bits* ys = reinterpret_cast<bf16_bits*>(smem + mma_ring_bytes(BN));
  float* red = reinterpret_cast<float*>(smem + mma_ring_bytes(BN) + mma_ytile_bytes(BN));

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int wm = warp >> 1;  // 0..3: rows wm * 32 ..
  const int wn = warp & 1;   // 0..1: columns wn * WN ..
  const int g = lane >> 2;
  const int t = lane & 3;
  const bool vec = ci % 8 == 0 && (reinterpret_cast<size_t>(x) & 15) == 0 &&
                   (reinterpret_cast<size_t>(w) & 15) == 0;
  const bool vec_y = co % 8 == 0 && (reinterpret_cast<size_t>(y) & 15) == 0;
  const int ktiles = (ci + kTileKb - 1) / kTileKb;
  const int steps = (items - blockIdx.x + gridDim.x - 1) / gridDim.x * ktiles;

  // step st: k-tile st % ktiles of this block's item st / ktiles, in stage
  // st % kStages
  auto load_step = [&](int st) {
    const int item = blockIdx.x + st / ktiles * gridDim.x;
    bf16_bits* xs = ring + (st % kStages) * kStage;
    load_tile<BN>(xs, xs + kMmaRows * kLdK, x, w, item / col_tiles * kMmaRows,
                  item % col_tiles * BN, st % ktiles * kTileKb, r, ci, co, vec);
  };
#pragma unroll
  for (int st = 0; st < kStages - 1; ++st) {
    if (st < steps) load_step(st);
    pn12::cp_async_commit();
  }

  float acc[2][NT][4];
  for (int st = 0; st < steps; ++st) {
    const int kt = st % ktiles;
    if (kt == 0) {
#pragma unroll
      for (int mt = 0; mt < 2; ++mt)
#pragma unroll
        for (int nt = 0; nt < NT; ++nt)
#pragma unroll
          for (int i = 0; i < 4; ++i) acc[mt][nt][i] = 0.0f;
    }
    pn12::cp_async_wait<kStages - 2>();  // step st has landed
    __syncthreads();  // ... for every thread; step st - 1's stage is consumed
    if (st + kStages - 1 < steps) load_step(st + kStages - 1);
    pn12::cp_async_commit();
    const bf16_bits* xs = ring + (st % kStages) * kStage;
    const bf16_bits* ws = xs + kMmaRows * kLdK;
#pragma unroll
    for (int ks = 0; ks < kTileKb; ks += 16) {
      unsigned a[2][4];
#pragma unroll
      for (int mt = 0; mt < 2; ++mt) {
        ldmatrix_x4(a[mt], xs + (wm * 32 + mt * 16 + (lane & 15)) * kLdK + ks +
                               (lane >> 4) * 8);
      }
#pragma unroll
      for (int p = 0; p < NT / 2; ++p) {
        // b[0], b[1]: n8 tile 2p (k 0-7, 8-15); b[2], b[3]: tile 2p + 1
        unsigned b[4];
        ldmatrix_x4(b, ws + (wn * WN + p * 16 + (lane & 7) + (lane >> 4) * 8) * kLdK +
                           ks + ((lane >> 3) & 1) * 8);
#pragma unroll
        for (int mt = 0; mt < 2; ++mt) {
          mma_bf16(acc[mt][2 * p], a[mt], b[0], b[1]);
          mma_bf16(acc[mt][2 * p + 1], a[mt], b[2], b[3]);
        }
      }
    }
    if (kt != ktiles - 1) continue;

    // epilogue of the item: round, stage y, and sum the rounded values of
    // each column (ys and red were last read before this step's barrier)
    const int item = blockIdx.x + st / ktiles * gridDim.x;
    const int tile = item / col_tiles;
    const int row0 = tile * kMmaRows;
    const int col0 = item % col_tiles * BN;
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      const int lc = wn * WN + nt * 8 + 2 * t;  // columns lc, lc + 1
      const float b0 = col0 + lc < co ? round_bf16(bias[col0 + lc]) : 0.0f;
      const float b1 = col0 + lc + 1 < co ? round_bf16(bias[col0 + lc + 1]) : 0.0f;
      float s0 = 0.0f, s1 = 0.0f, ss0 = 0.0f, ss1 = 0.0f;
#pragma unroll
      for (int mt = 0; mt < 2; ++mt) {
#pragma unroll
        for (int h = 0; h < 2; ++h) {  // rows g, then g + 8, of the m16 tile
          const int lrow = wm * 32 + mt * 16 + h * 8 + g;
          const __nv_bfloat162 v =
              output_pair(acc[mt][nt][2 * h], acc[mt][nt][2 * h + 1], b0, b1);
          *reinterpret_cast<__nv_bfloat162*>(ys + lrow * kYld + lc) = v;
          if (row0 + lrow < r) {  // columns past Co are never stored or read
            const float2 vf = __bfloat1622float2(v);
            s0 = __fadd_rn(s0, vf.x);
            ss0 = __fadd_rn(ss0, __fmul_rn(vf.x, vf.x));
            s1 = __fadd_rn(s1, vf.y);
            ss1 = __fadd_rn(ss1, __fmul_rn(vf.y, vf.y));
          }
        }
      }
#pragma unroll
      for (int off = 4; off < 32; off <<= 1) {
        s0 = __fadd_rn(s0, __shfl_xor_sync(0xffffffffu, s0, off));
        ss0 = __fadd_rn(ss0, __shfl_xor_sync(0xffffffffu, ss0, off));
        s1 = __fadd_rn(s1, __shfl_xor_sync(0xffffffffu, s1, off));
        ss1 = __fadd_rn(ss1, __shfl_xor_sync(0xffffffffu, ss1, off));
      }
      if (g == 0) {
        red[(wm * 2 + 0) * BN + lc] = s0;
        red[(wm * 2 + 0) * BN + lc + 1] = s1;
        red[(wm * 2 + 1) * BN + lc] = ss0;
        red[(wm * 2 + 1) * BN + lc + 1] = ss1;
      }
    }
    __syncthreads();

    for (int e = threadIdx.x; e < kMmaRows * (BN / 8); e += kMmaThreads) {
      const int i = e / (BN / 8);
      const int c = (e % (BN / 8)) * 8;
      const int row = row0 + i;
      const int col = col0 + c;
      if (row >= r || col >= co) continue;
      bf16_bits* dst = y + static_cast<size_t>(row) * co + col;
      const bf16_bits* src = ys + i * kYld + c;
      if (vec_y) {
        *reinterpret_cast<uint4*>(dst) = *reinterpret_cast<const uint4*>(src);
      } else {
        for (int q = 0; q < 8 && col + q < co; ++q) dst[q] = src[q];
      }
    }
    for (int e = threadIdx.x; e < 2 * BN; e += kMmaThreads) {
      const int which = e / BN;
      const int lc = e % BN;
      if (col0 + lc >= co) continue;
      float total = 0.0f;
#pragma unroll
      for (int q = 0; q < 4; ++q) total = __fadd_rn(total, red[(q * 2 + which) * BN + lc]);
      partials[(static_cast<size_t>(tile) * 2 + which) * co + col0 + lc] = total;
    }
  }
  pn12::cp_async_wait<0>();
}

// Blocks of an instance that run at once on the whole card, from its
// registers and shared memory; asked of the runtime once.
template <int BN>
cudaError_t resident_blocks(int* out) {
  static int blocks = 0;
  static cudaError_t err = [] {
    int device = 0, sms = 0, per_sm = 0;
    cudaError_t e = cudaGetDevice(&device);
    if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
    if (e == cudaSuccess) {
      e = cudaFuncSetAttribute(dense_bn_stats_mma<BN>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(mma_shared_bytes(BN)));
    }
    if (e == cudaSuccess) {
      e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &per_sm, dense_bn_stats_mma<BN>, kMmaThreads, mma_shared_bytes(BN));
    }
    blocks = sms * per_sm;
    return e;
  }();
  *out = blocks;
  return err;
}

template <int BN>
cudaError_t launch_mma(const void* x, const void* w, const float* bias, void* y,
                       float* partials, int r, int ci, int co, int tiles,
                       cudaStream_t stream) {
  const int col_tiles = (co + BN - 1) / BN;
  const long long items = static_cast<long long>(tiles) * col_tiles;
  if (items > 0x7fffffffLL) return cudaErrorInvalidValue;
  int resident = 0;
  const cudaError_t err = resident_blocks<BN>(&resident);
  if (err != cudaSuccess) return err;
  if (resident <= 0) return cudaErrorInvalidConfiguration;
  const int blocks = static_cast<int>(items < resident ? items : resident);
  dense_bn_stats_mma<BN><<<blocks, kMmaThreads, mma_shared_bytes(BN), stream>>>(
      static_cast<const bf16_bits*>(x), static_cast<const bf16_bits*>(w), bias,
      static_cast<bf16_bits*>(y), partials, r, ci, co, col_tiles,
      static_cast<int>(items));
  return cudaGetLastError();
}

// ---------------------------------------------------------------- fp32, SIMT

constexpr int kThreads = 256;
constexpr int kTileK = 16;
constexpr int kMicro = 4;  // a thread's register tile: 4 rows x 4 columns

// BN = 64 columns x BM = 64 rows, or BN = 32 x BM = 128: 4096 outputs and
// 256 threads a block either way.
template <int BN>
__global__ void __launch_bounds__(kThreads)
    dense_bn_stats_kernel(const float* __restrict__ x, const float* __restrict__ w,
                          const float* __restrict__ bias, float* __restrict__ y,
                          float* __restrict__ partials, int r, int ci,
                          int co) {
  constexpr int BM = kThreads * kMicro * kMicro / BN;
  constexpr int TX = BN / kMicro;     // threads across the columns
  constexpr int TY = kThreads / TX;   // threads across the rows
  static_assert(TY * kMicro == BM, "tile shape");
  __shared__ float xs[kTileK][BM + 4];
  __shared__ float ws[kTileK][BN + 4];
  __shared__ float red[2][TY][BN];

  const int tid = threadIdx.x;
  const int tx = tid % TX;
  const int ty = tid / TX;
  const int row0 = blockIdx.x * BM;
  const int col0 = blockIdx.y * BN;

  float acc[kMicro][kMicro];
#pragma unroll
  for (int i = 0; i < kMicro; ++i) {
#pragma unroll
    for (int j = 0; j < kMicro; ++j) acc[i][j] = 0.0f;
  }

  for (int k0 = 0; k0 < ci; k0 += kTileK) {
    // neighbouring threads read neighbouring k of one row: coalesced
    for (int e = tid; e < BM * kTileK; e += kThreads) {
      const int i = e / kTileK;
      const int k = e % kTileK;
      const int row = row0 + i;
      const int kk = k0 + k;
      xs[k][i] = (row < r && kk < ci) ? x[static_cast<size_t>(row) * ci + kk] : 0.0f;
    }
    for (int e = tid; e < BN * kTileK; e += kThreads) {
      const int j = e / kTileK;
      const int k = e % kTileK;
      const int col = col0 + j;
      const int kk = k0 + k;
      ws[k][j] = (col < co && kk < ci) ? w[static_cast<size_t>(col) * ci + kk] : 0.0f;
    }
    __syncthreads();
#pragma unroll
    for (int k = 0; k < kTileK; ++k) {
      float a[kMicro];
      float b[kMicro];
#pragma unroll
      for (int i = 0; i < kMicro; ++i) a[i] = xs[k][ty * kMicro + i];
#pragma unroll
      for (int j = 0; j < kMicro; ++j) b[j] = ws[k][tx * kMicro + j];
#pragma unroll
      for (int i = 0; i < kMicro; ++i) {
#pragma unroll
        for (int j = 0; j < kMicro; ++j) {
          acc[i][j] = __fmaf_rn(a[i], b[j], acc[i][j]);
        }
      }
    }
    __syncthreads();
  }

  // epilogue: store, and sum the stored values over this tile's rows
  float s[kMicro];
  float ss[kMicro];
#pragma unroll
  for (int j = 0; j < kMicro; ++j) {
    s[j] = 0.0f;
    ss[j] = 0.0f;
  }
#pragma unroll
  for (int j = 0; j < kMicro; ++j) {
    const int col = col0 + tx * kMicro + j;
    if (col >= co) continue;
    const float bj = bias[col];
#pragma unroll
    for (int i = 0; i < kMicro; ++i) {
      const int row = row0 + ty * kMicro + i;
      if (row >= r) continue;
      const float v = __fadd_rn(acc[i][j], bj);
      y[static_cast<size_t>(row) * co + col] = v;
      s[j] = __fadd_rn(s[j], v);
      ss[j] = __fadd_rn(ss[j], __fmul_rn(v, v));
    }
  }
#pragma unroll
  for (int j = 0; j < kMicro; ++j) {
    red[0][ty][tx * kMicro + j] = s[j];
    red[1][ty][tx * kMicro + j] = ss[j];
  }
  __syncthreads();
  for (int e = tid; e < 2 * BN; e += kThreads) {
    const int which = e / BN;
    const int j = e % BN;
    const int col = col0 + j;
    if (col >= co) continue;
    float total = 0.0f;
    for (int t = 0; t < TY; ++t) total = __fadd_rn(total, red[which][t][j]);
    partials[(static_cast<size_t>(blockIdx.x) * 2 + which) * co + col] = total;
  }
}

cudaError_t launch_simt(const void* x, const void* w, const float* bias, void* y,
                        float* partials, int r, int ci, int co, int tiles,
                        cudaStream_t stream) {
  const float* xt = static_cast<const float*>(x);
  const float* wt = static_cast<const float*>(w);
  float* yt = static_cast<float*>(y);
  if (co % 64 == 0) {
    const dim3 grid(tiles, co / 64);
    dense_bn_stats_kernel<64>
        <<<grid, kThreads, 0, stream>>>(xt, wt, bias, yt, partials, r, ci, co);
  } else {
    const dim3 grid(tiles, (co + 31) / 32);
    dense_bn_stats_kernel<32>
        <<<grid, kThreads, 0, stream>>>(xt, wt, bias, yt, partials, r, ci, co);
  }
  return cudaGetLastError();
}

// ---------------------------------------------------------------- both

// partials (tiles, 2, Co) -> mean, var (Co). Lane l of a column sums row
// tiles l, l + kFinalLanes, ... in order (kFinalBatch loads in flight
// before their adds); lane 0 then sums the lanes in order.
__global__ void __launch_bounds__(kFinalCols * kFinalLanes)
    dense_bn_stats_finalize(const float* __restrict__ partials,
                            float* __restrict__ mean, float* __restrict__ var,
                            int tiles, int r, int co) {
  __shared__ float red[2][kFinalLanes][kFinalCols];
  const int c = threadIdx.x;
  const int lane = threadIdx.y;
  const int col = blockIdx.x * kFinalCols + c;
  float s = 0.0f;
  float ss = 0.0f;
  if (col < co) {
    for (int t0 = lane; t0 < tiles; t0 += kFinalLanes * kFinalBatch) {
      float v[kFinalBatch], vv[kFinalBatch];
#pragma unroll
      for (int u = 0; u < kFinalBatch; ++u) {
        const int t = t0 + u * kFinalLanes;
        v[u] = t < tiles ? partials[(static_cast<size_t>(t) * 2) * co + col] : 0.0f;
        vv[u] = t < tiles ? partials[(static_cast<size_t>(t) * 2 + 1) * co + col] : 0.0f;
      }
#pragma unroll
      for (int u = 0; u < kFinalBatch; ++u) {
        if (t0 + u * kFinalLanes < tiles) {
          s = __fadd_rn(s, v[u]);
          ss = __fadd_rn(ss, vv[u]);
        }
      }
    }
  }
  red[0][lane][c] = s;
  red[1][lane][c] = ss;
  __syncthreads();
  if (lane != 0 || col >= co) return;
  float total = 0.0f;
  float total_sq = 0.0f;
  for (int l = 0; l < kFinalLanes; ++l) {
    total = __fadd_rn(total, red[0][l][c]);
    total_sq = __fadd_rn(total_sq, red[1][l][c]);
  }
  const float rows = static_cast<float>(r);
  const float m = __fdiv_rn(total, rows);
  mean[col] = m;
  var[col] = fmaxf(__fsub_rn(__fdiv_rn(total_sq, rows), __fmul_rn(m, m)), 0.0f);
}

}  // namespace

// x (R, Ci) and w (Co, Ci), fp32 (bf16 == 0) or bf16 (bf16 == 1); bias (Co)
// fp32; y (R, Co) in x's dtype; partials (tiles, 2, Co) fp32 scratch with
// tiles = ceil(R / BM): BM = 128 for bf16; for fp32 64 when Co % 64 == 0,
// else 128; mean, var (Co) fp32.
PN12_API int pn12_dense_bn_stats(const void* x, const void* w,
                                 const float* bias, void* y, float* partials,
                                 float* mean, float* var, int r, int ci,
                                 int co, int tiles, int bf16, void* stream) {
  const int bm = bf16 || co % 64 != 0 ? 128 : 64;
  if (r <= 0 || ci <= 0 || co <= 0 || tiles != (r + bm - 1) / bm ||
      (!bf16 && (co % 64 == 0 ? co / 64 : (co + 31) / 32) > 65535)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const cudaStream_t s = pn12::as_stream(stream);
  cudaError_t err;
  if (!bf16) {
    err = launch_simt(x, w, bias, y, partials, r, ci, co, tiles, s);
  } else if (co <= 32) {
    err = launch_mma<32>(x, w, bias, y, partials, r, ci, co, tiles, s);
  } else if (co <= 64) {
    err = launch_mma<64>(x, w, bias, y, partials, r, ci, co, tiles, s);
  } else {
    err = launch_mma<128>(x, w, bias, y, partials, r, ci, co, tiles, s);
  }
  if (err != cudaSuccess) return static_cast<int>(err);
  dense_bn_stats_finalize<<<(co + kFinalCols - 1) / kFinalCols,
                            dim3(kFinalCols, kFinalLanes), 0, s>>>(
      partials, mean, var, tiles, r, co);
  return static_cast<int>(cudaGetLastError());
}

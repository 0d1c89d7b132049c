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
// rows, Ci = 32 to 768, Co = 32 to 512; 25 GFLOP) the bytes. In bf16 x, w
// and y once are ~0.46 GB, 137.6 us at 3.35 TB/s, against 25 us for the
// operations on the 989 TFLOP/s tensor cores (H100 SXM data sheet). In fp32
// they are ~0.92 GB, ~275 us, against ~152 us for the operations as three
// TF32 products on the 495 TFLOP/s tensor cores (0.37 ms at 67 TFLOP/s
// outside them). The two SA1 calls (R = 524288, Ci = 32) and the three FP1
// calls (R = 65536, 128 -> 128) are most of those bytes.
//
// Design. The TPU kernel walked the rows in one sequential grid and carried
// the two sums in VMEM scratch. Here blocks run in no order, so the sums are
// taken in two passes, each in a fixed order, and the statistics are the
// same bits from run to run (unlike the segment sum's atomics).
//
// One kernel for both dtypes, on the tensor cores (dense_bn_stats_mma<T,
// BN>): an item is 128 rows x BN columns of y (BN = 32, 64 or 128, the least
// that covers Co, so x is read once from device memory where Co <= 128;
// wider Co gives a row tile 2 or 4 column tiles with consecutive item ids,
// whose re-reads of x hit L2). As many blocks of 8 warps as fit the card at
// once walk the items (a persistent grid), each item's k-tiles one step of a
// single stream.
//   - Loads: 32-deep tiles of x and w go into shared memory through
//     cp.async (16-byte copies, zero-filled past the edges; plain loads when
//     a row is not 16-byte aligned) in a ring of stages (bf16 3-6, fp32 3-4:
//     as many as two blocks an SM hold), so the next steps, of this item or
//     the next one, load while the warps multiply and while the epilogue
//     stores.
//   - Products: each warp owns 32 x BN/2 of the item. bf16: ldmatrix.x4
//     fragments and mma.sync m16n8k16 bf16 x bf16 -> fp32; bf16 products are
//     exact in fp32, so only the order of the sums differs from a sequential
//     sum. fp32: mma.sync m16n8k8 TF32 three times a k-step into one
//     accumulator, a_lo b_hi + a_hi b_lo, then a_hi b_hi (common.cuh's
//     split, as fused_sa.cu's chain; one-pass TF32 would keep ~3 digits),
//     each fragment split as it is read from the staged fp32 tile (row
//     stride 36 floats: a fragment's 8 rows x 4 columns on 32 banks).
//   - Epilogue: y = the accumulator plus the bias; bf16 rounds it in
//     registers (two columns a packed conversion), stages it in shared
//     memory and stores 16-byte rows (Co % 8 == 0); fp32 y is stored as it
//     stands, straight from the registers (a quad's float2 stores fill
//     whole 32-byte sectors). The statistics come from those values in
//     registers in a fixed order: each thread sums its 4 rows of a column
//     (rows g, g+8, g+16, g+24 of its warp's 32, g = lane / 4), a butterfly
//     of shuffles (xor 4, 8, 16) sums the 8 lanes of a column, and the 4
//     warps along the rows add in order into one (2, BN) partial per row
//     tile (modelled in plain ops by kernels/bn_stats_cuda.py::
//     stats_in_kernel_order, which the card matches bit for bit, both
//     dtypes).
//   What holds the bf16 route back on the H100 (trials whose scripts are not
//   kept): its instruction stream, not the loads: blocks seldom wait for
//   their tiles, the epilogue of an item (conversions, shuffles, two
//   barriers, the stores) takes longer than its products, and more stages
//   did not help. The fp32 route adds the splits (four integer and float
//   operations an operand element, a staged x element split by the 2 warps
//   that read it, a w element by 4) and three mma.sync where bf16 has one.
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

constexpr int kMmaThreads = 256;  // 8 warps: 4 along the rows x 2 along the columns
constexpr int kMmaRows = 128;     // rows of a block's tile
constexpr int kTileK = 32;        // depth of a staged tile: two bf16 k16 steps, four TF32 k8

typedef unsigned short bf16_bits;

// What differs between the two routes. Stages: as many as two blocks an SM
// can hold (of 228 KB), so the most tiles are in flight at small Ci, where
// an item is one k-tile.
template <typename T>
struct Route;
template <>
struct Route<bf16_bits> {
  static constexpr int kLd = kTileK + 8;  // 80 bytes a row: ldmatrix's 8 rows hit 8 bank groups
  static constexpr int kSeg = 8;          // elements of a 16-byte copy
  static constexpr bool kStageY = true;
  __host__ __device__ static constexpr int stages(int bn) { return bn == 32 ? 6 : bn == 64 ? 4 : 3; }
};
template <>
struct Route<float> {
  static constexpr int kLd = kTileK + 4;  // 144 bytes a row: a fragment's loads on 32 banks
  static constexpr int kSeg = 4;
  static constexpr bool kStageY = false;
  __host__ __device__ static constexpr int stages(int bn) { return bn == 128 ? 3 : 4; }
};

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

// Shared memory of an instance: the ring of stages, the bf16 y tile, then
// the (4 warps, 2, BN) partials of the statistics.
template <typename T>
__host__ __device__ constexpr size_t ring_bytes(int bn) {
  return static_cast<size_t>(Route<T>::stages(bn)) * (kMmaRows + bn) * Route<T>::kLd * sizeof(T);
}
template <typename T>
__host__ __device__ constexpr size_t ytile_bytes(int bn) {
  return Route<T>::kStageY ? static_cast<size_t>(kMmaRows) * (bn + 8) * sizeof(T) : 0;
}
template <typename T>
__host__ __device__ constexpr size_t shared_bytes(int bn) {
  return ring_bytes<T>(bn) + ytile_bytes<T>(bn) + 4 * 2 * bn * 4;
}

// Stage k-tile `k0` of the block's x rows and w rows into xs / ws.
template <typename T, int BN>
__device__ __forceinline__ void load_tile(T* xs, T* ws, const T* __restrict__ x,
                                          const T* __restrict__ w, int row0, int col0,
                                          int k0, int r, int ci, int co, bool vec) {
  constexpr int kLd = Route<T>::kLd;
  constexpr int kSeg = Route<T>::kSeg;
  constexpr int kSegs = kTileK / kSeg;  // 16-byte segments a row
  if (vec) {
    for (int e = threadIdx.x; e < (kMmaRows + BN) * kSegs; e += kMmaThreads) {
      const int i = e / kSegs;
      const int c = (e % kSegs) * kSeg;
      const int kk = k0 + c;
      const bool in_x = i < kMmaRows;
      const int row = in_x ? row0 + i : col0 + i - kMmaRows;
      const bool ok = kk < ci && row < (in_x ? r : co);  // Ci % kSeg == 0
      const T* base = in_x ? x : w;
      pn12::cp_async16((in_x ? xs + i * kLd : ws + (i - kMmaRows) * kLd) + c,
                       ok ? base + static_cast<size_t>(row) * ci + kk : base, ok);
    }
  } else {
    for (int e = threadIdx.x; e < (kMmaRows + BN) * kTileK; e += kMmaThreads) {
      const int i = e / kTileK;
      const int c = e % kTileK;
      const int kk = k0 + c;
      const bool in_x = i < kMmaRows;
      const int row = in_x ? row0 + i : col0 + i - kMmaRows;
      const bool ok = kk < ci && row < (in_x ? r : co);
      const T* base = in_x ? x : w;
      (in_x ? xs + i * kLd : ws + (i - kMmaRows) * kLd)[c] =
          ok ? base[static_cast<size_t>(row) * ci + kk] : T(0);
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

// acc += one staged k-tile's products of this warp's 32 x BN/2 (bf16).
template <int BN>
__device__ __forceinline__ void tile_products(float (&acc)[2][BN / 16][4],
                                              const bf16_bits* xs, const bf16_bits* ws,
                                              int wm, int wn, int lane) {
  constexpr int kLd = Route<bf16_bits>::kLd;
  constexpr int WN = BN / 2;
#pragma unroll
  for (int ks = 0; ks < kTileK; ks += 16) {
    unsigned a[2][4];
#pragma unroll
    for (int mt = 0; mt < 2; ++mt) {
      ldmatrix_x4(a[mt], xs + (wm * 32 + mt * 16 + (lane & 15)) * kLd + ks + (lane >> 4) * 8);
    }
#pragma unroll
    for (int p = 0; p < BN / 32; ++p) {
      // b[0], b[1]: n8 tile 2p (k 0-7, 8-15); b[2], b[3]: tile 2p + 1
      unsigned b[4];
      ldmatrix_x4(b, ws + (wn * WN + p * 16 + (lane & 7) + (lane >> 4) * 8) * kLd + ks +
                         ((lane >> 3) & 1) * 8);
#pragma unroll
      for (int mt = 0; mt < 2; ++mt) {
        mma_bf16(acc[mt][2 * p], a[mt], b[0], b[1]);
        mma_bf16(acc[mt][2 * p + 1], a[mt], b[2], b[3]);
      }
    }
  }
}

// The same for fp32 operands, as three TF32 products a k8 step.
template <int BN>
__device__ __forceinline__ void tile_products(float (&acc)[2][BN / 16][4], const float* xs,
                                              const float* ws, int wm, int wn, int lane) {
  constexpr int kLd = Route<float>::kLd;
  constexpr int WN = BN / 2;
  const int g = lane >> 2;
  const int t = lane & 3;
#pragma unroll
  for (int ks = 0; ks < kTileK; ks += 8) {
    unsigned ah[2][4], al[2][4];
#pragma unroll
    for (int mt = 0; mt < 2; ++mt) {
      const float* p = xs + (wm * 32 + mt * 16 + g) * kLd + ks + t;
      pn12::split_tf32(p[0], ah[mt][0], al[mt][0]);            // (g, t)
      pn12::split_tf32(p[8 * kLd], ah[mt][1], al[mt][1]);      // (g + 8, t)
      pn12::split_tf32(p[4], ah[mt][2], al[mt][2]);            // (g, t + 4)
      pn12::split_tf32(p[8 * kLd + 4], ah[mt][3], al[mt][3]);  // (g + 8, t + 4)
    }
#pragma unroll
    for (int nt = 0; nt < BN / 16; ++nt) {
      const float* q = ws + (wn * WN + nt * 8 + g) * kLd + ks + t;  // w is (n, k)
      unsigned bh[2], bl[2];
      pn12::split_tf32(q[0], bh[0], bl[0]);  // (k t, n g)
      pn12::split_tf32(q[4], bh[1], bl[1]);  // (k t + 4, n g)
#pragma unroll
      for (int mt = 0; mt < 2; ++mt) {
        pn12::mma_tf32(acc[mt][nt], al[mt], bh[0], bh[1]);
        pn12::mma_tf32(acc[mt][nt], ah[mt], bl[0], bl[1]);
        pn12::mma_tf32(acc[mt][nt], ah[mt], bh[0], bh[1]);
      }
    }
  }
}

// A persistent block walks the items (row tile, column tile) blockIdx.x,
// blockIdx.x + gridDim.x, ..., and the k-tiles of each: one stream of
// steps through the ring, so the next item's tiles load while this one's
// epilogue runs.
template <typename T, int BN>
__global__ void __launch_bounds__(kMmaThreads, 2)
    dense_bn_stats_mma(const T* __restrict__ x, const T* __restrict__ w,
                       const float* __restrict__ bias, T* __restrict__ y,
                       float* __restrict__ partials, int r, int ci, int co,
                       int col_tiles, int items) {
  constexpr bool kBf16 = Route<T>::kStageY;
  constexpr int kLd = Route<T>::kLd;
  constexpr int WN = BN / 2;   // a warp's columns
  constexpr int NT = WN / 8;   // its n8 tiles
  constexpr int kYld = BN + 8; // row stride of the staged bf16 y tile
  constexpr int kStage = (kMmaRows + BN) * kLd;  // elements a stage
  constexpr int kStages = Route<T>::stages(BN);
  extern __shared__ __align__(16) unsigned char smem[];
  T* ring = reinterpret_cast<T*>(smem);
  bf16_bits* ys = reinterpret_cast<bf16_bits*>(smem + ring_bytes<T>(BN));
  float* red = reinterpret_cast<float*>(smem + ring_bytes<T>(BN) + ytile_bytes<T>(BN));

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int wm = warp >> 1;  // 0..3: rows wm * 32 ..
  const int wn = warp & 1;   // 0..1: columns wn * WN ..
  const int g = lane >> 2;
  const int t = lane & 3;
  const bool vec = ci % Route<T>::kSeg == 0 && (reinterpret_cast<size_t>(x) & 15) == 0 &&
                   (reinterpret_cast<size_t>(w) & 15) == 0;
  // bf16: 16-byte rows of the staged tile; fp32: a float2 a column pair
  const bool vec_y = kBf16 ? co % 8 == 0 && (reinterpret_cast<size_t>(y) & 15) == 0
                           : co % 2 == 0 && (reinterpret_cast<size_t>(y) & 7) == 0;
  const int ktiles = (ci + kTileK - 1) / kTileK;
  const int steps = (items - blockIdx.x + gridDim.x - 1) / gridDim.x * ktiles;

  // step st: k-tile st % ktiles of this block's item st / ktiles, in stage
  // st % kStages
  auto load_step = [&](int st) {
    const int item = blockIdx.x + st / ktiles * gridDim.x;
    T* xs = ring + (st % kStages) * kStage;
    load_tile<T, BN>(xs, xs + kMmaRows * kLd, x, w, item / col_tiles * kMmaRows,
                     item % col_tiles * BN, st % ktiles * kTileK, r, ci, co, vec);
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
    const T* xs = ring + (st % kStages) * kStage;
    tile_products<BN>(acc, xs, xs + kMmaRows * kLd, wm, wn, lane);
    if (kt != ktiles - 1) continue;

    // epilogue of the item: y, stored (fp32) or staged (bf16), and the sums
    // of each column (ys and red were last read before this step's barrier)
    const int item = blockIdx.x + st / ktiles * gridDim.x;
    const int tile = item / col_tiles;
    const int row0 = tile * kMmaRows;
    const int col0 = item % col_tiles * BN;
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      const int lc = wn * WN + nt * 8 + 2 * t;  // columns lc, lc + 1
      const int col = col0 + lc;
      float b0 = col < co ? bias[col] : 0.0f;
      float b1 = col + 1 < co ? bias[col + 1] : 0.0f;
      if (kBf16) {
        b0 = round_bf16(b0);
        b1 = round_bf16(b1);
      }
      float s0 = 0.0f, s1 = 0.0f, ss0 = 0.0f, ss1 = 0.0f;
#pragma unroll
      for (int mt = 0; mt < 2; ++mt) {
#pragma unroll
        for (int h = 0; h < 2; ++h) {  // rows g, then g + 8, of the m16 tile
          const int lrow = wm * 32 + mt * 16 + h * 8 + g;
          const bool in = row0 + lrow < r;
          float2 v;
          if constexpr (kBf16) {
            const __nv_bfloat162 pair =
                output_pair(acc[mt][nt][2 * h], acc[mt][nt][2 * h + 1], b0, b1);
            *reinterpret_cast<__nv_bfloat162*>(ys + lrow * kYld + lc) = pair;
            v = __bfloat1622float2(pair);
          } else {
            v = make_float2(__fadd_rn(acc[mt][nt][2 * h], b0),
                            __fadd_rn(acc[mt][nt][2 * h + 1], b1));
            float* dst = y + static_cast<size_t>(row0 + lrow) * co + col;
            if (in && vec_y && col < co) {
              *reinterpret_cast<float2*>(dst) = v;  // Co even: col + 1 < Co too
            } else if (in) {
              if (col < co) dst[0] = v.x;
              if (col + 1 < co) dst[1] = v.y;
            }
          }
          if (in) {  // columns past Co are never stored or read
            s0 = __fadd_rn(s0, v.x);
            ss0 = __fadd_rn(ss0, __fmul_rn(v.x, v.x));
            s1 = __fadd_rn(s1, v.y);
            ss1 = __fadd_rn(ss1, __fmul_rn(v.y, v.y));
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

    if constexpr (kBf16) {
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
template <typename T, int BN>
cudaError_t resident_blocks(int* out) {
  static int blocks = 0;
  static cudaError_t err = [] {
    int device = 0, sms = 0, per_sm = 0;
    cudaError_t e = cudaGetDevice(&device);
    if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
    if (e == cudaSuccess) {
      e = cudaFuncSetAttribute(dense_bn_stats_mma<T, BN>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(shared_bytes<T>(BN)));
    }
    if (e == cudaSuccess) {
      e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &per_sm, dense_bn_stats_mma<T, BN>, kMmaThreads, shared_bytes<T>(BN));
    }
    blocks = sms * per_sm;
    return e;
  }();
  *out = blocks;
  return err;
}

template <typename T, int BN>
cudaError_t launch_mma(const void* x, const void* w, const float* bias, void* y,
                       float* partials, int r, int ci, int co, int tiles,
                       cudaStream_t stream) {
  const int col_tiles = (co + BN - 1) / BN;
  const long long items = static_cast<long long>(tiles) * col_tiles;
  if (items > 0x7fffffffLL) return cudaErrorInvalidValue;
  int resident = 0;
  const cudaError_t err = resident_blocks<T, BN>(&resident);
  if (err != cudaSuccess) return err;
  if (resident <= 0) return cudaErrorInvalidConfiguration;
  const int blocks = static_cast<int>(items < resident ? items : resident);
  dense_bn_stats_mma<T, BN><<<blocks, kMmaThreads, shared_bytes<T>(BN), stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(w), bias, static_cast<T*>(y),
      partials, r, ci, co, col_tiles, static_cast<int>(items));
  return cudaGetLastError();
}

// The instance of the least BN that covers Co.
template <typename T>
cudaError_t launch(const void* x, const void* w, const float* bias, void* y,
                   float* partials, int r, int ci, int co, int tiles, cudaStream_t s) {
  if (co <= 32) return launch_mma<T, 32>(x, w, bias, y, partials, r, ci, co, tiles, s);
  if (co <= 64) return launch_mma<T, 64>(x, w, bias, y, partials, r, ci, co, tiles, s);
  return launch_mma<T, 128>(x, w, bias, y, partials, r, ci, co, tiles, s);
}

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
// tiles = ceil(R / 128); mean, var (Co) fp32.
PN12_API int pn12_dense_bn_stats(const void* x, const void* w,
                                 const float* bias, void* y, float* partials,
                                 float* mean, float* var, int r, int ci,
                                 int co, int tiles, int bf16, void* stream) {
  if (r <= 0 || ci <= 0 || co <= 0 || tiles != (r + kMmaRows - 1) / kMmaRows) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const cudaStream_t s = pn12::as_stream(stream);
  const cudaError_t err =
      bf16 ? launch<bf16_bits>(x, w, bias, y, partials, r, ci, co, tiles, s)
           : launch<float>(x, w, bias, y, partials, r, ci, co, tiles, s);
  if (err != cudaSuccess) return static_cast<int>(err);
  dense_bn_stats_finalize<<<(co + kFinalCols - 1) / kFinalCols,
                            dim3(kFinalCols, kFinalLanes), 0, s>>>(
      partials, mean, var, tiles, r, co);
  return static_cast<int>(cudaGetLastError());
}

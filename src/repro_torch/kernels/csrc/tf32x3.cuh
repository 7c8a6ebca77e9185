// The float32-accurate distance-tile product on Hopper's tensor cores, shared
// by K4 (pairwise/csrc/pairwise.cu) and K1-K3 (fused_lp/csrc/folded_lp.cu).
//
// 3xTF32.  A TF32 product keeps 11 significant bits of each operand, so one
// TF32 x.y loses about 2^-11 of every term, and |x|^2 + |y|^2 - 2 x.y, which
// cancels, keeps only three decimal digits.  The split pass below writes each
// float32 operand as hi = tf32(x) and lo = tf32(x - hi), both rounded by
// cvt.rna.tf32.f32 (their low 13 bits zero), so x = hi + lo within 2^-22
// relative; then
//
//   x.y = hi_x.hi_y + hi_x.lo_y + lo_x.hi_y   (+ lo_x.lo_y, below 2^-22)
//
// and every product of two TF32 values is exact in the tensor cores.  What is
// left is how the float32 sums are rounded.  The tensor cores' float32
// accumulation is not IEEE round-to-nearest (studies of earlier NVIDIA parts
// found it truncates), so a single accumulator carried over d = 315 (120
// wgmma) would drift.  Each 32-wide chunk of d therefore sums its 12 products
// into a fresh accumulator, which is then added to a float32 master
// accumulator in registers with round-to-nearest.  A numpy emulation with
// truncating accumulation (tests/test_torch_tf32_split.py) puts this scheme
// within 1.5x of a float32 product's error against float64, and one TF32
// product at least 50x over it; on the card, chip_smoke.py's precision gate
// holds the kernels to 2x.
//
// Tiles.  An output tile is BM = 128 rows x BN = 128 columns: two consumer
// warpgroups of 64 rows, each issuing wgmma.m64n128k8.f32.tf32.tf32 (both
// operands K-major from shared memory, which x (M, d) and y (N, d) already
// are).  One producer warp keeps a ring of NS = 3 stages filled by TMA; a
// stage is one 32-float chunk of d: hi and lo of the 128 rows and of the 128
// columns, each 128 rows x 128 bytes with the 128-byte swizzle, 64 KB in all
// (32 KB with hi only).  The 2-D tensor maps run over (d_pad, rows) with
// boxes of 32 x 128; TMA zero-fills rows past M or N and the split pass
// zeroes the pad columns d..d_pad, so neither adds to a product.  d_pad, a
// multiple of 32, also makes the row stride a multiple of the 16 bytes TMA
// asks for (a float32 row of 315 values is 1,260 bytes).
//
// Divergence tiles.  Every Bregman divergence of the repo is a cross term
// plus a row bias and a column bias, d(a, b) = rb(a) + cb(b) + k a.g(b):
//   squared Euclidean  g(b) = b,    k = -2, rb = |a|^2,             cb = |b|^2
//   KL                 g(b) = log b, k = -1, rb = sum a log a - a, cb = sum b
//   Itakura-Saito      g(b) = 1/b,  k = +1, rb = -sum (log a + 1), cb = sum log b
// (Mahalanobis is squared Euclidean on x sqrt(m), mapped before the kernel).
// The split pass applies the operand's map g (SplitOp) to each value BEFORE
// the hi/lo split and the padding: a pad lane holds 0 whatever g is, where
// log 0 = -inf times a zero row value would put NaN into every pair's sum.
// Its third output is the operand's bias (rb or cb), not only |x|^2.
#pragma once

#include <cuda_bf16.h>

#include "sm90.cuh"

namespace tf32x3 {

constexpr int BM = 128;            // rows of an output tile (two warpgroups)
constexpr int BN = 128;            // columns of an output tile: one wgmma N
constexpr int DC = 32;             // floats of d in a stage: one 128-byte row
constexpr int NCONS = 256;         // the two consumer warpgroups
constexpr int NT = NCONS + 32;     // and the producer warp
constexpr int NS = 3;              // ring stages
constexpr int PART = BM * DC * 4;  // one part of a stage (hi or lo, rows or
                                   // columns): 16 KB
static_assert(BM == BN, "a row part and a column part share one box");

// bytes of a stage: hi and lo of both operands, or hi alone (TERMS == 1)
template <int TERMS>
__host__ __device__ constexpr int stage_bytes() {
  return (TERMS == 3 ? 4 : 2) * PART;
}

__host__ __device__ constexpr int padded_width(int d) {
  return ((d > 0 ? d : 1) + DC - 1) / DC * DC;
}

// v rounded to TF32 (nearest, ties away), its low 13 bits zero
__device__ __forceinline__ float to_tf32(float v) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(v));
  return __uint_as_float(r & 0xFFFFE000u);
}

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

// What the split pass writes for one operand of a divergence tile (see
// above): the map g applied before the split, and the bias summed over d.
enum SplitOp {
  SPLIT_SQ = 0,      // x;     |x|^2 (both operands of squared Euclidean)
  SPLIT_KL_ROW = 1,  // x;     sum x log x - x
  SPLIT_KL_COL = 2,  // log x; sum x
  SPLIT_IS_ROW = 3,  // x;     -sum (log x + 1)
  SPLIT_IS_COL = 4,  // 1/x;   sum log x
};

// The split pass: x (rows, d) -> hi, lo (rows, d_pad) float32 of g(x) and
// nrm (rows,), the bias, in float32.  One warp a row.  lo == nullptr skips
// it: a bfloat16 value is exact in TF32 (8 significant bits of 11), so its lo
// is zero.
template <typename T, int OP = SPLIT_SQ>
__global__ void __launch_bounds__(256)
split_kernel(const T* __restrict__ x, float* __restrict__ hi,
             float* __restrict__ lo, float* __restrict__ nrm, int rows, int d,
             int d_pad) {
  const int row = blockIdx.x * 8 + threadIdx.x / 32, lane = threadIdx.x % 32;
  if (row >= rows) return;  // the whole warp
  const T* xr = x + (size_t)row * d;
  const size_t o = (size_t)row * d_pad;
  float ss = 0.f;
  for (int c = lane; c < d_pad; c += 32) {
    const float v = c < d ? to_f32(xr[c]) : 0.f;
    float u = v;  // g(v); 0 in a pad lane
    if (OP == SPLIT_SQ) {
      ss = fmaf(v, v, ss);
    } else if (c < d) {
      if (OP == SPLIT_KL_ROW) {
        ss += fmaf(v, logf(v), -v);
      } else if (OP == SPLIT_KL_COL) {
        u = logf(v);
        ss += v;
      } else if (OP == SPLIT_IS_ROW) {
        ss -= logf(v) + 1.f;
      } else {  // SPLIT_IS_COL
        u = 1.f / v;
        ss += logf(v);
      }
    }
    const float h = to_tf32(u);
    hi[o + c] = h;
    if (lo != nullptr) lo[o + c] = to_tf32(u - h);
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    ss += __shfl_xor_sync(0xffffffffu, ss, off);
  if (lane == 0) nrm[row] = ss;
}

template <typename T, int OP = SPLIT_SQ>
int split(const T* x, float* hi, float* lo, float* nrm, int rows, int d,
          int d_pad, cudaStream_t stream) {
  if (rows <= 0) return 0;
  split_kernel<T, OP><<<(rows + 7) / 8, 256, 0, stream>>>(x, hi, lo, nrm, rows,
                                                           d, d_pad);
  return static_cast<int>(cudaGetLastError());
}

// The 2-D map (d_pad, rows) of a contiguous float32 (rows, d_pad) operand
// part: 32 x 128 boxes with the 128-byte swizzle; rows past `rows` read as
// zeros.
inline int encode(CUtensorMap* map, const float* ptr, int rows, int d_pad) {
  const sm90::EncodeTiled fn = sm90::encoder();
  if (fn == nullptr) return sm90::ERR_NO_ENCODER;
  const cuuint64_t dims[2] = {(cuuint64_t)d_pad, (cuuint64_t)rows};
  const cuuint64_t strides[1] = {(cuuint64_t)d_pad * 4};
  const cuuint32_t box[2] = {DC, BM};
  const cuuint32_t step[2] = {1, 1};
  const CUresult res = fn(
      map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 2, const_cast<float*>(ptr), dims,
      strides, box, step, CU_TENSOR_MAP_INTERLEAVE_NONE,
      CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
      CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return res == CUDA_SUCCESS ? 0 : sm90::ERR_ENCODE;
}

// Producer: chunk [k0, k0 + 32) of rows r0.. and columns c0.. into the stage
// at `stage`, completing `full` by its bytes.  Stage layout: row hi, column
// hi, then (TERMS == 3) row lo, column lo, 16 KB each, 1024-byte aligned.
template <int TERMS>
__device__ __forceinline__ void produce(uint32_t stage, uint32_t full,
                                        const CUtensorMap* ahi,
                                        const CUtensorMap* alo,
                                        const CUtensorMap* bhi,
                                        const CUtensorMap* blo, int r0, int c0,
                                        int k0) {
  sm90::mbar_expect_tx(full, stage_bytes<TERMS>());
  sm90::tma_load_2d(stage, ahi, full, k0, r0);
  sm90::tma_load_2d(stage + PART, bhi, full, k0, c0);
  if (TERMS == 3) {
    sm90::tma_load_2d(stage + 2 * PART, alo, full, k0, r0);
    sm90::tma_load_2d(stage + 3 * PART, blo, full, k0, c0);
  }
}

// d (+)= A B for A (64 x 8) and B (128 x 8), both K-major TF32 in shared
// memory; `accumulate` == 0 overwrites d
__device__ __forceinline__ void mma(float (&d)[64], uint64_t da, uint64_t db,
                                    int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7,"
      "%8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23,"
      "%24, %25, %26, %27, %28, %29, %30, %31,"
      "%32, %33, %34, %35, %36, %37, %38, %39,"
      "%40, %41, %42, %43, %44, %45, %46, %47,"
      "%48, %49, %50, %51, %52, %53, %54, %55,"
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(accumulate)
      : "memory");
}

// Consumer: master += (this warpgroup's 64 rows) x (the 128 columns) over
// the stage's chunk of d, as hi.hi + hi.lo + lo.hi in a fresh accumulator
// (hi.hi alone when TERMS == 1), added to master with round-to-nearest once
// the stage's wgmma have completed.  A k-step of 8 TF32 values is 32 bytes
// inside the 128-byte swizzled rows; SBO is 1024 bytes (8 rows).
template <int TERMS>
__device__ __forceinline__ void consume(float (&master)[64], uint32_t stage,
                                        int wg) {
  const uint32_t a_hi = stage + wg * (PART / 2), b_hi = stage + PART;
  const uint32_t a_lo = a_hi + 2 * PART, b_lo = b_hi + 2 * PART;
  float acc[64];
  sm90::wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < DC / 8; ++kk) {
    const uint32_t k = kk * 32;
    mma(acc, sm90::desc(a_hi + k, 16, 1024), sm90::desc(b_hi + k, 16, 1024),
        kk > 0);
    if (TERMS == 3) {
      mma(acc, sm90::desc(a_hi + k, 16, 1024), sm90::desc(b_lo + k, 16, 1024),
          1);
      mma(acc, sm90::desc(a_lo + k, 16, 1024), sm90::desc(b_hi + k, 16, 1024),
          1);
    }
  }
  sm90::wgmma_commit();
  sm90::wgmma_wait_all();
  sm90::hold(acc);
#pragma unroll
  for (int i = 0; i < 64; ++i) master[i] += acc[i];
}

// Where accumulator register i of thread t (0..127) of a warpgroup sits in
// its 64 x 128 tile: rows r and r + 8 of the warp's 16, columns c and c + 1
// of every 8-column block.
__device__ __forceinline__ int frag_row(int t, int i) {
  return (t / 32) * 16 + (t % 32) / 4 + ((i & 2) ? 8 : 0);
}
__device__ __forceinline__ int frag_col(int t, int i) {
  return (i / 4) * 8 + (t % 4) * 2 + (i & 1);
}

inline int sm_count() {
  int dev = 0, n = 0;
  if (cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev) !=
          cudaSuccess)
    return 0;
  return n;
}

}  // namespace tf32x3

// K6, float32 route: causal / sliding-window grouped-query attention with an
// online softmax on Hopper's tensor cores, float32-accurate as 3xTF32,
//
//   out[b, h, i, :] = sum_j softmax_j(mask(q_i . k_j * D^-1/2)) v[b, h / G, j, :]
//
// for float32 q (B, Hq, Sq, D) and k, v (B, Hkv, Sk, D), G = Hq / Hkv; out is
// (B, Hq, Sq, D) float32.  q is a stripe of query rows: its row i is row
// row_base + i of the keys' sequence (row_base = 0, Sq = Sk: the whole
// sequence).  A key j is masked for query i when j >= Sk, when causal and
// j > row_base + i, or when window > 0 and row_base + i - j >= window.  Per
// key tile of
// BK = 64 keys, with c = D^-1/2 log2 e and s = q . k: a masked s is -inf,
// m' = max(m, c rowmax s), alpha = 2^(m - m'), p = 2^(c s - m') (one fused
// multiply-add), l = l * alpha + sum p, acc = acc * alpha + p v; m starts at
// -1e30; the output is acc / max(l, 1e-38).  This is the recurrence of the
// bfloat16 route (flash_attention_sm90.cu) with p kept in float32, and the
// plain version (flash_attention.py) walks it.
//
// Replaces the TPU kernel repro/kernels/flash_attention/flash_attention.py::
// flash_attention_kernel (pl.pallas_call at flash_attention.py:98, body
// _kernel at :28), where the key tiles are the innermost, sequential grid
// axis and (m, s, acc) ride in VMEM scratch.  Here a block owns NWG x 64
// query rows of one (b, h), one consumer warpgroup per 64 rows (one wgmma M),
// and walks its key tiles in a loop, writing its output once.  No atomics
// and no split over keys: two launches give the same bits, and stripes
// whose row_base is a multiple of NWG x 64 give the whole launch's rows'.
//
// 3xTF32, the scheme of K1-K4 (../../csrc/tf32x3.cuh).  Every float32
// operand x is split as hi = tf32(x), lo = tf32(x - hi) (nearest, ties away,
// low 13 bits zero), and a product a.b is taken as hi.lo + lo.hi + hi.hi,
// three TF32 products that the tensor cores take exactly.  Their float32
// sums are not IEEE round-to-nearest (earlier NVIDIA parts truncate), so:
//   * S = Q K^T sums each 32-wide chunk of D into a fresh accumulator, the
//     two small products first while it is small, then hi.hi, and adds the
//     chunks in registers with round-to-nearest;
//   * O gets a fresh partial P V per key tile and 64 columns of D (32 at
//     D = 256), small products first, added as acc * alpha + partial in
//     registers.
// A numpy emulation with truncating sums (tests/test_torch_tf32_split.py)
// puts this within 1.5 x float32's error against float64, and one TF32
// product at 50 x or more; chip_smoke.py's K6 gate holds the kernel to 2 x.
// TERMS = 1 keeps hi.hi alone (a build to show that the gate sees it); the
// entry point reports TERMS through `products`.
//
// Layouts.  TF32 wgmma takes both operands K-major (its transpose bit is for
// 16-bit types only).  Q and K (rows, D) already are, for S = Q K^T.  For
// O = P V the B operand must be keys-contiguous, so the pre-pass
// (prepare_kv_kernel, one launch of the same entry point) writes, once per
// (b, kv head), the split K (khi, klo: (B Hkv, Sk, D)) and the split,
// transposed V (vthi, vtlo: (B Hkv, D, Sk_pad), Sk_pad = Sk rounded up to
// 64, zero past Sk).  P is the A operand from registers: the f32 accumulator of
// S gives a thread keys (2c, 2c + 1) of each 8-key block, where a TF32 A
// fragment wants k-columns (c, c + 4); so the pre-pass stores the keys of
// each 8-key block of V^T in the order (0, 2, 4, 6, 1, 3, 5, 7), and k-column
// kappa of the A fragment is then exactly the accumulator's key
// (kappa < 4 ? 2 kappa : 2 kappa - 7).  No shuffle, no trip through shared
// memory.  Q's split is done once per block in shared memory, in place after
// its TMA load.
//
// Design.  NWG consumer warpgroups and one producer warp, whose lane 0
// issues every TMA load into a ring of NS stages of 32 KB: one
// stage is a 64 x 64 float tile, hi then lo, each two 64-row x 128-byte
// chunks with the 128-byte swizzle.  A key tile takes D / 64 stages of K
// (64 columns of D each) and then D / 64 of V^T (64 rows of D each).  One
// mbarrier per stage says "full" (expect_tx), one "empty" (every consumer
// thread arrives once its wgmma on the stage have completed).
//   * S: per stage of K, two 32-wide chunks into fresh accumulators,
//     wgmma.m64n64k8 with A = Q (hi or lo) and B = K from shared memory.
//   * The softmax runs on the accumulator fragment, as on the bfloat16
//     route: rows r and r + 8 of a warp's 16, quad shuffles for the row max,
//     masks only on tiles that cross the diagonal, the window's edge or Sk,
//     one FFMA and one ex2.approx.ftz a score.
//   * P V: p is split into hi and lo in registers; per stage of V^T,
//     24 wgmma.m64nNk8 with A from registers into a fresh partial, N = 64
//     columns of D (two of N = 32 at D = 256).
//   * Tiles wholly masked for the block are skipped (up to the diagonal when
//     causal, from g0 - window + 1 with a window, g0 = row_base + q0 the
//     block's first global row); a tile wholly masked for
//     one warpgroup of the block leaves its rows' state as it is (alpha = 1,
//     p = 0).  Query tiles go out last-first, so long causal rows start first.
//   * Registers set the shape per head width.  Blocks of 288 threads (two
//     warpgroups) are capped at 168 registers a thread, which holds D = 64:
//     two warpgroups, both S chunks of a stage in flight.  The output
//     accumulator is D / 2 registers a thread, so D = 128 and 256 take one
//     warpgroup (up to 255 registers), and D = 256 runs its S chunks one at
//     a time and its P V partials 32 columns wide, to stay within them.
//   * Shared memory: NWG x 2 x 64 D 4 bytes of Q (hi, lo) + NS x 32 KB:
//     D = 64: 64 KB + 4 stages; D = 128: 64 KB + 4; D = 256: 128 KB + 3;
//     192, 192 and 224 KB, one block an SM, opted in above 48 KB.
//
// Bound on an H100 SXM.  Operations: at the LM path's shape (B = 4, Hq = 15,
// Hkv = 5, S = 2048, D = 64, causal) the two products over the unmasked
// pairs are 32.2 GFLOP, three TF32 products each at 495 TFLOP/s: 0.195 ms
// (the float32 CUDA cores' bound, 67 TFLOP/s, is 0.481 ms); gemma3-1b's
// local layer (4/1 heads, D = 256, window 1,024) 25.8 GFLOP, 0.156 ms.
// Bytes: q, k, v and out once, 84 / 67 MB, 0.025 / 0.020 ms.  The operand
// feed sits between: every (block, key tile) pair reads 2 D 64 8 bytes of
// split K and V^T through L2, 31,680 pairs x 64 KB = 2.1 GB at smollm's
// shape with one warpgroup a block, half that with the two it has, and
// 2.2 GB at gemma3's; L2's rate may set the time before the tensor cores
// do.  Measured (PERF.md): 0.58 of the operations bound at smollm's shape,
// 0.32 at gemma3's, where one warpgroup a block leaves the tensor cores
// idle during its softmax and ptxas spills 596 bytes.  Not attempted: splitting K and V in shared memory (half the feed),
// sharing a K/V tile between the query heads of one KV head, ping-pong
// consumers, a TMA store of the output.
#include <cuda_runtime.h>
#include <stdint.h>

#include "sm90.cuh"

namespace {

using namespace sm90;

constexpr int TERMS = 3;          // TF32 products per product: 3, or 1
constexpr int BQ = 64;            // query rows per warpgroup: one wgmma M
constexpr int BK = 64;            // keys per tile
constexpr int CHUNK = 64 * 128;   // 64 rows x 32 floats, 128-byte swizzle
constexpr int PART = 2 * CHUNK;   // a 64 x 64 float tile (hi or lo)
constexpr int STAGE = 2 * PART;   // hi and lo: 32 KB
constexpr float NEG_BIG = -1e30f;
static_assert(TERMS == 3 || TERMS == 1, "3xTF32, or one product");

// Per head width: consumer warpgroups a block, fresh S accumulators in
// flight, and the columns of D a P V partial covers; set by registers.
template <int D>
__host__ __device__ constexpr int n_wg() { return D == 64 ? 2 : 1; }
template <int D>
__host__ __device__ constexpr int s_fresh() { return D == 256 ? 1 : 2; }
template <int D>
__host__ __device__ constexpr int pv_cols() { return D == 256 ? 32 : 64; }
template <int D>
__host__ __device__ constexpr int n_threads() { return 128 * n_wg<D>() + 32; }
template <int D>
__host__ __device__ constexpr int stages() { return D == 256 ? 3 : 4; }
template <int D>
__host__ __device__ constexpr int q_bytes() { return 2 * BQ * D * 4; }  // hi, lo
template <int D>
__host__ __device__ constexpr int smem_bytes() {
  return 1024 + n_wg<D>() * q_bytes<D>() + stages<D>() * STAGE +
         (2 * stages<D>() + 1) * 8;
}

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// x rounded to TF32 (nearest, ties away from zero: cvt.rna's rounding), as
// its bits, in two integer operations; at smollm-360m's shape the kernel ran
// 4 % faster with this than with tf32x3.cuh's cvt.rna in its softmax.
__device__ __forceinline__ uint32_t tf32_bits(float x) {
  return (__float_as_uint(x) + 0x1000u) & 0xFFFFE000u;
}

__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

__device__ __forceinline__ void bar_sync(int id, int count) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(count) : "memory");
}

#define WG_D32                                                               \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "  \
  "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "   \
  "%30, %31}"
#define WG_OUT32(d)                                                          \
  "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),    \
      "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]),           \
      "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),       \
      "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]),       \
      "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),       \
      "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]),       \
      "+f"(d[31])

// d (+)= A B, A (64 x 8) and B (64 x 8, K-major) TF32 from shared memory;
// accumulate == 0 overwrites d
__device__ __forceinline__ void mma_ss(float (&d)[32], uint64_t da, uint64_t db,
                                       int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 " WG_D32
      ", %32, %33, p, 1, 1;\n}\n"
      : WG_OUT32(d)
      : "l"(da), "l"(db), "r"(accumulate)
      : "memory");
}

// d (+)= A B, A (64 x 8) TF32 from registers, B (64 x 8, K-major) from
// shared memory
__device__ __forceinline__ void mma_rs(float (&d)[32], uint32_t a0,
                                       uint32_t a1, uint32_t a2, uint32_t a3,
                                       uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 " WG_D32
      ", {%32, %33, %34, %35}, %36, p, 1, 1;\n}\n"
      : WG_OUT32(d)
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "l"(db), "r"(accumulate)
      : "memory");
}

// d (+)= A B for N = 32: A (64 x 8) TF32 from registers, B (32 x 8,
// K-major) from shared memory
__device__ __forceinline__ void mma_rs(float (&d)[16], uint32_t a0,
                                       uint32_t a1, uint32_t a2, uint32_t a3,
                                       uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15}, {%16, %17, %18, %19}, %20, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "l"(db), "r"(accumulate)
      : "memory");
}

// a 64 x 8 K-major operand at k-step kk of a 64 x 64 part (two chunks)
__device__ __forceinline__ uint64_t kdesc(uint32_t part, int kk) {
  return desc(part + (kk / 4) * CHUNK + (kk % 4) * 32, 16, 1024);
}

// S chunk (32 of D) into the fresh accumulator d: hi.lo and lo.hi first,
// then hi.hi.  qh/ql: this warpgroup's Q chunk (hi, lo); kh/kl: K's.
__device__ __forceinline__ void s_chunk(float (&d)[32], uint32_t qh,
                                        uint32_t ql, uint32_t kh,
                                        uint32_t kl) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    if (TERMS == 3) {
      mma_ss(d, desc(qh + kk * 32, 16, 1024), desc(kl + kk * 32, 16, 1024),
             kk > 0);
      mma_ss(d, desc(ql + kk * 32, 16, 1024), desc(kh + kk * 32, 16, 1024), 1);
    }
  }
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
    mma_ss(d, desc(qh + kk * 32, 16, 1024), desc(kh + kk * 32, 16, 1024),
           TERMS == 3 || kk > 0);
}

template <int D>
__global__ void __launch_bounds__(n_threads<D>(), 1)
flash_attention_tf32x3_kernel(const __grid_constant__ CUtensorMap qmap,
                              const __grid_constant__ CUtensorMap khmap,
                              const __grid_constant__ CUtensorMap klmap,
                              const __grid_constant__ CUtensorMap vhmap,
                              const __grid_constant__ CUtensorMap vlmap,
                              float* __restrict__ out, int Hq, int Hkv, int Sq,
                              int Sk, int row_base, int causal, int window,
                              float scale_log2) {
  constexpr int NWG = n_wg<D>();
  constexpr int NCONS = 128 * NWG;
  constexpr int NS = stages<D>();
  constexpr int NP = D / 64;        // stages of K (and of V^T) a key tile
  constexpr int PN = pv_cols<D>();
  extern __shared__ uint8_t smem_raw[];
  const uint32_t sq = (smem_addr(smem_raw) + 1023u) & ~1023u;  // NWG x (hi, lo)
  const uint32_t ring = sq + NWG * q_bytes<D>();
  const uint32_t full = ring + NS * STAGE;
  const uint32_t empty = full + 8 * NS;
  const uint32_t qbar = empty + 8 * NS;

  const int bh = blockIdx.x;
  const int bhk = bh / Hq * Hkv + bh % Hq / (Hq / Hkv);
  const int q0 = (gridDim.y - 1 - blockIdx.y) * (BQ * NWG);  // stripe row
  const int g0 = row_base + q0;                                 // global row
  // key tiles with an unmasked key for some row of [g0, g0 + NWG BQ)
  const int k_lo = (window > 0 ? max(0, g0 - window + 1) : 0) / BK * BK;
  const int k_hi = causal ? min(Sk, g0 + BQ * NWG) : Sk;
  const int n_tiles = (k_hi - k_lo + BK - 1) / BK;
  const int tid = threadIdx.x;

  if (tid == 0) {
    for (int s = 0; s < NS; ++s) {
      mbar_init(full + 8 * s, 1);
      mbar_init(empty + 8 * s, NCONS);
    }
    mbar_init(qbar, 1);
    mbar_init_fence();
  }
  __syncthreads();

  if (tid >= NCONS) {  // the producer warp: lane 0 issues every load
    if (tid == NCONS) {
      mbar_expect_tx(qbar, NWG * BQ * D * 4);
      for (int w = 0; w < NWG; ++w)
#pragma unroll
        for (int c = 0; c < D / 32; ++c)
          tma_load_3d(sq + w * q_bytes<D>() + c * CHUNK, &qmap, qbar, 32 * c,
                      q0 + w * BQ, bh);
      for (int it = 0; it < n_tiles * 2 * NP; ++it) {
        const int s = it % NS, j = it % (2 * NP);
        const int k0 = k_lo + it / (2 * NP) * BK;
        const uint32_t st = ring + s * STAGE;
        if (it >= NS) mbar_wait(empty + 8 * s, (it / NS - 1) & 1);
        mbar_expect_tx(full + 8 * s, TERMS == 3 ? STAGE : PART);
        if (j < NP) {  // K: keys k0.., columns 64 j..
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            tma_load_3d(st + h * CHUNK, &khmap, full + 8 * s, 64 * j + 32 * h,
                        k0, bhk);
            if (TERMS == 3)
              tma_load_3d(st + PART + h * CHUNK, &klmap, full + 8 * s,
                          64 * j + 32 * h, k0, bhk);
          }
        } else {       // V^T: rows 64 (j - NP).. of D, keys k0..
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            tma_load_3d(st + h * CHUNK, &vhmap, full + 8 * s, k0 + 32 * h,
                        64 * (j - NP), bhk);
            if (TERMS == 3)
              tma_load_3d(st + PART + h * CHUNK, &vlmap, full + 8 * s,
                          k0 + 32 * h, 64 * (j - NP), bhk);
          }
        }
      }
    }
    return;
  }

  // a consumer warpgroup: this thread holds rows r and r + 8 of its 64
  // (global rows row_base + r and row_base + r + 8), columns cl, cl + 1 of
  // every 8-column block of S and of O; gw is the warpgroup's first global
  // row
  const int wg = tid / 128, t = tid % 128;
  const int warp = t / 32, lane = t % 32;
  const int qw = q0 + wg * BQ, gw = row_base + qw;
  const int r = qw + warp * 16 + lane / 4;
  const int cl = (lane % 4) * 2;
  const uint32_t qh = sq + wg * q_bytes<D>(), ql = qh + BQ * D * 4;

  // Q's split, in place: the swizzle moves hi and lo alike
  mbar_wait(qbar, 0);
  {
    float* hi = reinterpret_cast<float*>(smem_raw + (qh - smem_addr(smem_raw)));
    float* lo = hi + BQ * D;
    for (int i = t; i < BQ * D; i += 128) {
      const float v = hi[i], h = __uint_as_float(tf32_bits(v));
      hi[i] = h;
      lo[i] = __uint_as_float(tf32_bits(v - h));
    }
  }
  fence_proxy_async();
  bar_sync(1 + wg, 128);

  float o[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) o[i] = 0.f;
  float m[2] = {NEG_BIG, NEG_BIG}, l[2] = {0.f, 0.f};

  for (int tile = 0; tile < n_tiles; ++tile) {
    const int k0 = k_lo + tile * BK;
    const int g0 = tile * 2 * NP;  // ring index of the tile's first stage

    // S = Q K^T, 32 columns of D a fresh accumulator, summed in order;
    // the two chunks of a stage in flight together, or one after the other
    float sc[32];
#pragma unroll
    for (int j = 0; j < NP; ++j) {
      const int g = g0 + j, s = g % NS;
      const uint32_t st = ring + s * STAGE;
      mbar_wait(full + 8 * s, (g / NS) & 1);
      if (s_fresh<D>() == 2) {
        float a[32], b[32];
        wgmma_fence();
        s_chunk(a, qh + 2 * j * CHUNK, ql + 2 * j * CHUNK, st, st + PART);
        s_chunk(b, qh + (2 * j + 1) * CHUNK, ql + (2 * j + 1) * CHUNK,
                st + CHUNK, st + PART + CHUNK);
        wgmma_commit();
        wgmma_wait_all();
        hold(a);
        hold(b);
#pragma unroll
        for (int i = 0; i < 32; ++i)
          sc[i] = j == 0 ? a[i] + b[i] : sc[i] + a[i] + b[i];
      } else {
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          float a[32];
          wgmma_fence();
          s_chunk(a, qh + (2 * j + h) * CHUNK, ql + (2 * j + h) * CHUNK,
                  st + h * CHUNK, st + PART + h * CHUNK);
          wgmma_commit();
          wgmma_wait_all();
          hold(a);
#pragma unroll
          for (int i = 0; i < 32; ++i)
            sc[i] = j + h == 0 ? a[i] : sc[i] + a[i];
        }
      }
      mbar_arrive(empty + 8 * s);
    }

    if (k0 + BK > Sk || (causal && k0 + BK - 1 > gw) ||
        (window > 0 && gw + BQ - 1 - k0 >= window)) {
#pragma unroll
      for (int i = 0; i < 32; ++i) {
        const int qi = row_base + r + (i & 2 ? 8 : 0);
        const int kj = k0 + (i / 4) * 8 + cl + (i & 1);
        if (kj >= Sk || (causal && kj > qi) || (window > 0 && qi - kj >= window))
          sc[i] = -INFINITY;
      }
    }
    float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int i = 0; i < 32; ++i)
      mx[(i >> 1) & 1] = fmaxf(mx[(i >> 1) & 1], sc[i]);
    float alpha[2], sum[2] = {0.f, 0.f};
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 1));
      mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 2));
      const float m_new = fmaxf(m[h], mx[h] * scale_log2);
      alpha[h] = ex2(m[h] - m_new);
      m[h] = m_new;
    }
    // p, split into TF32 hi and lo; the A fragment of k-step j (keys 8 j..
    // of V^T's permuted order) is (row r, key 2c), (r + 8, 2c), (r, 2c + 1),
    // (r + 8, 2c + 1) of the 8-key block: accumulator entries 4j + 0, 2, 1, 3
    uint32_t ph[32], pl[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      const float p = ex2(fmaf(sc[i], scale_log2, -m[(i >> 1) & 1]));
      sum[(i >> 1) & 1] += p;
      const uint32_t h = tf32_bits(p);
      const int a = (i & ~3) | ((i & 1) << 1) | ((i >> 1) & 1);
      ph[a] = h;
      pl[a] = tf32_bits(p - __uint_as_float(h));
    }
#pragma unroll
    for (int h = 0; h < 2; ++h) l[h] = l[h] * alpha[h] + sum[h];

    // O = O alpha + P V, PN columns of D a fresh partial
#pragma unroll
    for (int c = 0; c < NP; ++c) {
      const int g = g0 + NP + c, s = g % NS;
      mbar_wait(full + 8 * s, (g / NS) & 1);
#pragma unroll
      for (int n = 0; n < 64 / PN; ++n) {
        // rows 64 c + PN n.. of V^T: PN rows of 128 bytes into the chunks
        const uint32_t vh = ring + s * STAGE + n * PN * 128, vl = vh + PART;
        float pv[PN / 2];
        wgmma_fence();
        if (TERMS == 3) {
#pragma unroll
          for (int kk = 0; kk < BK / 8; ++kk)
            mma_rs(pv, ph[4 * kk], ph[4 * kk + 1], ph[4 * kk + 2],
                   ph[4 * kk + 3], kdesc(vl, kk), kk > 0);
#pragma unroll
          for (int kk = 0; kk < BK / 8; ++kk)
            mma_rs(pv, pl[4 * kk], pl[4 * kk + 1], pl[4 * kk + 2],
                   pl[4 * kk + 3], kdesc(vh, kk), 1);
        }
#pragma unroll
        for (int kk = 0; kk < BK / 8; ++kk)
          mma_rs(pv, ph[4 * kk], ph[4 * kk + 1], ph[4 * kk + 2],
                 ph[4 * kk + 3], kdesc(vh, kk), TERMS == 3 || kk > 0);
        wgmma_commit();
        wgmma_wait_all();
        hold(pv);
#pragma unroll
        for (int i = 0; i < PN / 2; ++i) {
          float& oi = o[32 * c + PN / 2 * n + i];
          oi = oi * alpha[(i >> 1) & 1] + pv[i];
        }
      }
      mbar_arrive(empty + 8 * s);
    }
    hold(ph);
    hold(pl);
  }

#pragma unroll
  for (int h = 0; h < 2; ++h) {
    l[h] += __shfl_xor_sync(0xffffffffu, l[h], 1);
    l[h] += __shfl_xor_sync(0xffffffffu, l[h], 2);
    l[h] = fmaxf(l[h], 1e-38f);
  }
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int qi = r + 8 * h;
    if (qi >= Sq) continue;
    float* row = out + ((size_t)bh * Sq + qi) * D + cl;
#pragma unroll
    for (int j = 0; j < D / 8; ++j)
      *reinterpret_cast<float2*>(row + 8 * j) =
          make_float2(o[4 * j + 2 * h] / l[h], o[4 * j + 2 * h + 1] / l[h]);
  }
}

// The pre-pass: k (heads, S, D) -> khi, klo (heads, S, D); v (heads, S, D)
// -> vthi, vtlo (heads, D, S_pad), transposed, each 8-key block in the order
// (0, 2, 4, 6, 1, 3, 5, 7), zero past S.  A block moves a 32-key x 32-column
// tile of one head through shared memory.
__global__ void __launch_bounds__(256)
prepare_kv_kernel(const float* __restrict__ k, const float* __restrict__ v,
                  float* __restrict__ khi, float* __restrict__ klo,
                  float* __restrict__ vthi, float* __restrict__ vtlo, int S,
                  int S_pad, int D) {
  __shared__ float tile[32][33];
  const int k0 = blockIdx.x * 32, d0 = blockIdx.y * 32, h = blockIdx.z;
  const int tx = threadIdx.x % 32, ty = threadIdx.x / 32;
  for (int i = ty; i < 32; i += 8) {
    const int key = k0 + i;
    float vv = 0.f;
    if (key < S) {
      const size_t at = ((size_t)h * S + key) * D + d0 + tx;
      const float kv = k[at], hk = __uint_as_float(tf32_bits(kv));
      khi[at] = hk;
      klo[at] = __uint_as_float(tf32_bits(kv - hk));
      vv = v[at];
    }
    tile[i][tx] = vv;
  }
  __syncthreads();
  const int slot = tx % 8;
  const int src = (tx & ~7) | (slot < 4 ? 2 * slot : 2 * slot - 7);
  for (int i = ty; i < 32; i += 8) {
    const float vv = tile[src][i], hv = __uint_as_float(tf32_bits(vv));
    const size_t at = ((size_t)h * D + d0 + i) * S_pad + k0 + tx;
    vthi[at] = hv;
    vtlo[at] = __uint_as_float(tf32_bits(vv - hv));
  }
}

// The 3-D map (dim0, dim1, heads) of a contiguous float32 (heads, dim1, dim0)
// tensor: 32 x 64 x 1 boxes with the 128-byte swizzle; coordinates past
// dim1 read as zeros.
int encode(CUtensorMap* map, const void* ptr, int dim0, int dim1, int heads) {
  const EncodeTiled fn = encoder();
  if (fn == nullptr) return ERR_NO_ENCODER;
  const cuuint64_t dims[3] = {(cuuint64_t)dim0, (cuuint64_t)dim1,
                              (cuuint64_t)heads};
  const cuuint64_t strides[2] = {(cuuint64_t)dim0 * 4,
                                 (cuuint64_t)dim1 * dim0 * 4};
  const cuuint32_t box[3] = {32, 64, 1};
  const cuuint32_t step[3] = {1, 1, 1};
  const CUresult res = fn(
      map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 3, const_cast<void*>(ptr), dims,
      strides, box, step, CU_TENSOR_MAP_INTERLEAVE_NONE,
      CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
      CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return res == CUDA_SUCCESS ? 0 : ERR_ENCODE;
}

template <int D>
int run(const float* q, const float* k, const float* v, float* out,
        float* khi, float* klo, float* vthi, float* vtlo, int B, int Hq,
        int Hkv, int Sq, int Sk, int row_base, int causal, int window,
        float scale_log2, cudaStream_t stream) {
  constexpr int bytes = smem_bytes<D>();
  auto kern = flash_attention_tf32x3_kernel<D>;
  static const cudaError_t opted = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (opted != cudaSuccess) return static_cast<int>(opted);
  const int s_pad = (Sk + BK - 1) / BK * BK;
  prepare_kv_kernel<<<dim3(s_pad / 32, D / 32, B * Hkv), 256, 0, stream>>>(
      k, v, khi, klo, vthi, vtlo, Sk, s_pad, D);
  int err = static_cast<int>(cudaGetLastError());
  if (err != 0) return err;
  CUtensorMap qmap, khmap, klmap, vhmap, vlmap;
  err = encode(&qmap, q, D, Sq, B * Hq);
  if (err == 0) err = encode(&khmap, khi, D, Sk, B * Hkv);
  if (err == 0) err = encode(&klmap, klo, D, Sk, B * Hkv);
  if (err == 0) err = encode(&vhmap, vthi, s_pad, D, B * Hkv);
  if (err == 0) err = encode(&vlmap, vtlo, s_pad, D, B * Hkv);
  if (err != 0) return err;
  const dim3 grid(B * Hq, (Sq + BQ * n_wg<D>() - 1) / (BQ * n_wg<D>()));
  kern<<<grid, n_threads<D>(), bytes, stream>>>(qmap, khmap, klmap, vhmap,
                                                vlmap, out, Hq, Hkv, Sq, Sk,
                                                row_base, causal, window,
                                                scale_log2);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Launches K6's float32 route on `stream` (a cudaStream_t passed as a
// pointer): the pre-pass, then the attention kernel.  Returns 0 on success,
// a cudaError_t, or ERR_NO_ENCODER / ERR_ENCODE (negative; see
// cuda_error_string), and writes to *products the TF32 products a product
// takes (TERMS).  q (B, Hq, Sq, D), k and v (B, Hkv, Sk, D), out (B, Hq, Sq,
// D): float32, row-major, contiguous, q 16-byte aligned, on the current
// device; q's rows are rows row_base .. row_base + Sq - 1 of the keys'
// sequence, row_base >= 0 and row_base + Sq <= Sk.  Scratch, allocated by
// the caller, 16-byte aligned: khi, klo (B, Hkv, Sk, D) and vthi, vtlo (B,
// Hkv, D, Sk_pad), Sk_pad = Sk rounded up to 64.  D is 64, 128 or 256; Hq is
// a multiple of Hkv; window 0 means none.  scale_log2 is D^-1/2 log2 e.
// Allocates nothing.
extern "C" int flash_attention_tf32x3(const float* q, const float* k,
                                      const float* v, float* out, float* khi,
                                      float* klo, float* vthi, float* vtlo,
                                      int B, int Hq, int Hkv, int Sq, int Sk,
                                      int row_base, int D, int causal,
                                      int window, float scale_log2,
                                      int* products, void* stream) {
  *products = TERMS;
  if (B <= 0 || Sq <= 0) return 0;
  if (Hkv <= 0 || Hq % Hkv != 0 || row_base < 0 || row_base + Sq > Sk)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 64:
      return run<64>(q, k, v, out, khi, klo, vthi, vtlo, B, Hq, Hkv, Sq,
                     Sk, row_base, causal, window, scale_log2, st);
    case 128:
      return run<128>(q, k, v, out, khi, klo, vthi, vtlo, B, Hq, Hkv, Sq,
                      Sk, row_base, causal, window, scale_log2, st);
    case 256:
      return run<256>(q, k, v, out, khi, klo, vthi, vtlo, B, Hq, Hkv, Sq,
                      Sk, row_base, causal, window, scale_log2, st);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

extern "C" const char* cuda_error_string(int code) {
  return error_string(code);
}

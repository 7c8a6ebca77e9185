// K6, bfloat16 route: causal / sliding-window grouped-query attention with an
// online softmax on Hopper's tensor cores,
//
//   out[b, h, i, :] = sum_j softmax_j(mask(q_i . k_j * D^-1/2)) v[b, h / G, j, :]
//
// for bfloat16 q (B, Hq, Sq, D) and k, v (B, Hkv, Sk, D), G = Hq / Hkv; out is
// (B, Hq, Sq, D) in bfloat16.  q is a stripe of query rows: its row i is row
// row_base + i of the keys' sequence (row_base = 0, Sq = Sk: the whole
// sequence).  A key j is masked for query i when j >= Sk, when causal and
// j > row_base + i, or when window > 0 and row_base + i - j >= window.  A
// rank of a query-sequence-sharded attention runs its stripe so.  Per key
// tile of
// BK = 64 keys, with c = D^-1/2 log2 e and s = q . k in float32: a masked s
// is -inf, m' = max(m, c rowmax s), alpha = 2^(m - m'), p = 2^(c s - m')
// (one fused multiply-add), l = l * alpha + sum p, acc = acc * alpha +
// bf16(p) v; m starts at -1e30, so a masked p is 0 and alpha is never
// 2^(inf - inf); the output is acc / max(l, 1e-38), rounded to bfloat16
// once.  m, l and acc are float32.  The float32 route is
// flash_attention_tf32x3.cu, 3xTF32 on the tensor cores.
//
// Deliberate departure from the reference's arithmetic: p is rounded to
// bfloat16 before the p v product (the tensor cores take bfloat16 operands),
// where the TPU kernel keeps p in float32.  Every tensor-core flash attention
// does this; the sum l is taken over the float32 p.  The plain version
// (flash_attention.py, its bfloat16 recurrence) rounds p the same way, and
// the reference's bfloat16 tolerance, 5e-2, holds the kernel to the oracle.
//
// Replaces the TPU kernel repro/kernels/flash_attention/flash_attention.py::
// flash_attention_kernel (pl.pallas_call at flash_attention.py:98, body
// _kernel at :28), where the key tiles are the innermost, sequential grid
// axis and (m, s, acc) ride in VMEM scratch.  Here one block owns BQ = 64
// query rows (one wgmma M) of one (b, h) and walks its key tiles in a loop,
// writing its output once.  No atomics and no split over keys: two launches
// give the same bits, and stripes whose row_base is a multiple of BQ give
// the bits of the whole launch's rows.  Keys at or past Sk are masked, the
// rule of ref.py.
//
// Design.  160 threads: one consumer warpgroup (warps 0-3) and one producer
// warp (warp 4), whose lane 0 issues every TMA load.
//   * Q goes to shared memory once; K and V tiles go into a ring of NS stages
//     by TMA (cp.async.bulk.tensor) through 3-D tensor maps (D, Sq, B Hq) and
//     (D, Sk, B Hkv), so rows past Sq or Sk of a head are zero-filled instead
//     of read from the next head.  Every tile is stored as D / 64 column chunks of 64 rows x 128
//     bytes with the 128-byte swizzle, each chunk 1024-byte aligned.  One
//     mbarrier per stage says "full" (the producer's expect_tx, completed by
//     the bytes), one says "empty" (128 consumer arrivals after the tile's
//     last wgmma has completed).
//   * S = Q K^T: D / 16 wgmma.m64n64k16 with Q and K both K-major in shared
//     memory (descriptors with the 128-byte swizzle, SBO 1024 bytes; a
//     k-step advances the start address by 32 bytes within a chunk).
//   * The softmax runs on the accumulator fragment in registers: a thread
//     holds rows r and r + 8 of its warp's 16, 16 columns each; the row max
//     meets over the 4 threads of a quad (shfl_xor 1, 2); the row sum stays
//     per thread until the epilogue (alpha is uniform over the quad).  The
//     mask is applied only on tiles that cross the diagonal, the window's
//     edge or Sk.  The scale is folded into the exponent's fused multiply-add
//     (the max of the raw scores, times c > 0, is the max of the scaled
//     ones), and 2^x is one ex2.approx.ftz, so a score costs one FFMA and
//     one MUFU op beside its max and sum.
//   * O += P V: p is packed to bfloat16 pairs in registers, where the S
//     accumulator's layout is already the A-operand layout of the next
//     wgmma.m64n{D}k16 (A from registers); V is read from shared memory as an
//     N-major B operand (the transpose bit), so it is never transposed in
//     memory: LBO is the 64-column chunk stride (BK x 128 bytes), SBO 1024
//     bytes, a k-step of 16 keys advances 2048 bytes.
//   * Tiles wholly masked for the block are skipped: up to the diagonal
//     when causal, from g0 - window + 1 with a window (g0 = row_base + q0,
//     the block's first global row); on a skipped tile a row's p would all
//     be 0, so no bit changes.
//     Query tiles go out last-first over every (b, h), so the long causal
//     rows start in the first wave.
//   * Shared memory: 64 D 2 + NS 2 (64 D 2) bytes, NS = 3 at D = 64 (56 KB,
//     3 blocks an SM), 2 at D = 128 (80 KB, 2 blocks) and D = 256 (160 KB,
//     1 block); opted in above 48 KB.  The producer is one warp, so
//     setmaxnreg (which acts on whole warpgroups) is not used; at D = 256 the
//     accumulator is 128 registers a thread, under the 255 one block an SM
//     leaves.
//   * An mbarrier wait that spins 2^26 times traps instead of hanging.
//
// Bound on an H100 SXM: operations.  At the LM path's shape (B = 4, Hq = 15,
// Hkv = 5, S = 2048, D = 64, causal) the two products over the unmasked half
// are 2 B Hq S^2 D = 32.2 GFLOP against 42 MB of q, k, v and out, so the
// bf16 tensor-core peak (989 TFLOP/s) sets the bound, 0.033 ms.  At D = 64
// the 4,096 2^x of a tile take 256 clocks of an SM's multi-function units
// (16 a clock), as long as the tile's two products at the tensor cores'
// peak, so the kernel is bound by how well the two overlap.  One warpgroup
// runs its products and its softmax in turn; the 3 blocks an SM (D = 64)
// overlap one block's softmax with another's products.  Tried and not kept:
// issuing tile i's Q K^T together with tile i - 1's P V and running tile
// i's softmax under it (FA3's in-warpgroup pipeline, two P buffers, K and V
// slots freed apart); it was no faster at D = 64 once the softmax was one
// FFMA and one ex2 a score.  Not attempted: two consumer warpgroups
// ping-ponging, and a TMA store of the output.
//
// The tensor maps are encoded on the host with libcuda's
// cuTensorMapEncodeTiled (../../csrc/sm90.cuh, which also holds the mbarrier,
// TMA and wgmma helpers) and passed to the kernel as __grid_constant__
// parameters.
#include <cuda_bf16.h>

#include "sm90.cuh"

namespace {

using namespace sm90;

constexpr int BQ = 64;           // query rows per block: one wgmma M
constexpr int BK = 64;           // keys per tile: the N of S = Q K^T
constexpr int NCONS = 128;       // the consumer warpgroup
constexpr int NT = NCONS + 32;   // and the producer warp
constexpr float NEG_BIG = -1e30f;

template <int D>
__host__ __device__ constexpr int stages() { return D == 64 ? 3 : 2; }
template <int D>
__host__ __device__ constexpr int blocks_per_sm() { return D == 64 ? 3 : D == 128 ? 2 : 1; }
template <int D>
__host__ __device__ constexpr int tile_bytes() { return BK * D * 2; }  // one K or V tile
template <int D>
__host__ __device__ constexpr int smem_bytes() {  // 1024 bytes of alignment slack, tiles, barriers
  return 1024 + BQ * D * 2 + 2 * stages<D>() * tile_bytes<D>() +
         (2 * stages<D>() + 1) * 8;
}

// 2^x, with results below 2^-126 flushed to zero
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 t = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&t);
}

// d (+)= A B, A (64 x 16) and B (64 x 16, K-major) from shared memory
__device__ __forceinline__ void wgmma_qk(float (&d)[32], uint64_t da,
                                         uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7,"
      "%8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23,"
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(accumulate)
      : "memory");
}

// d += A B, A (64 x 16) from registers, B (16 x 64, N-major) from shared memory
__device__ __forceinline__ void wgmma_pv(float (&d)[32], const uint32_t (&a)[4],
                                         uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7,"
      "%8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23,"
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1)
      : "memory");
}

// d += A B, A (64 x 16) from registers, B (16 x 128, N-major) from shared memory
__device__ __forceinline__ void wgmma_pv(float (&d)[64], const uint32_t (&a)[4],
                                         uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7,"
      "%8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23,"
      "%24, %25, %26, %27, %28, %29, %30, %31,"
      "%32, %33, %34, %35, %36, %37, %38, %39,"
      "%40, %41, %42, %43, %44, %45, %46, %47,"
      "%48, %49, %50, %51, %52, %53, %54, %55,"
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
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
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1)
      : "memory");
}

// d += A B, A (64 x 16) from registers, B (16 x 256, N-major) from shared memory
__device__ __forceinline__ void wgmma_pv(float (&d)[128], const uint32_t (&a)[4],
                                         uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %133, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7,"
      "%8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23,"
      "%24, %25, %26, %27, %28, %29, %30, %31,"
      "%32, %33, %34, %35, %36, %37, %38, %39,"
      "%40, %41, %42, %43, %44, %45, %46, %47,"
      "%48, %49, %50, %51, %52, %53, %54, %55,"
      "%56, %57, %58, %59, %60, %61, %62, %63,"
      "%64, %65, %66, %67, %68, %69, %70, %71,"
      "%72, %73, %74, %75, %76, %77, %78, %79,"
      "%80, %81, %82, %83, %84, %85, %86, %87,"
      "%88, %89, %90, %91, %92, %93, %94, %95,"
      "%96, %97, %98, %99, %100, %101, %102, %103,"
      "%104, %105, %106, %107, %108, %109, %110, %111,"
      "%112, %113, %114, %115, %116, %117, %118, %119,"
      "%120, %121, %122, %123, %124, %125, %126, %127"
      "}, {%128, %129, %130, %131}, %132, p, 1, 1, 1;\n}\n"
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
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]),
        "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]),
        "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]),
        "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]),
        "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]),
        "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]),
        "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]),
        "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]),
        "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]),
        "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]),
        "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]),
        "+f"(d[112]), "+f"(d[113]), "+f"(d[114]), "+f"(d[115]),
        "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
        "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]),
        "+f"(d[124]), "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1)
      : "memory");
}

template <int D>
__global__ void __launch_bounds__(NT, blocks_per_sm<D>())
flash_attention_sm90_kernel(const __grid_constant__ CUtensorMap qmap,
                            const __grid_constant__ CUtensorMap kmap,
                            const __grid_constant__ CUtensorMap vmap,
                            __nv_bfloat16* __restrict__ out, int Hq, int Hkv,
                            int Sq, int Sk, int row_base, int causal,
                            int window, float scale_log2) {
  constexpr int NS = stages<D>();
  constexpr int TILE = tile_bytes<D>();
  constexpr int CHUNK = BK * 128;  // one 64-column chunk of a K or V tile
  static_assert(BQ == BK, "a Q chunk and a K/V chunk share one layout");
  extern __shared__ uint8_t smem_raw[];
  const uint32_t sq = (smem_addr(smem_raw) + 1023u) & ~1023u;  // [D/64][BQ][64]
  const uint32_t sk = sq + BQ * D * 2;   // NS x [D/64][BK][64]
  const uint32_t sv = sk + NS * TILE;    // NS x [D/64][BK][64]
  const uint32_t full = sv + NS * TILE;  // NS mbarriers, then NS "empty"
  const uint32_t empty = full + 8 * NS;
  const uint32_t qbar = empty + 8 * NS;

  const int bh = blockIdx.x;
  const int bhk = bh / Hq * Hkv + bh % Hq / (Hq / Hkv);
  const int q0 = (gridDim.y - 1 - blockIdx.y) * BQ;  // the stripe's row
  const int g0 = row_base + q0;                         // the global row
  // key tiles with an unmasked key for some row of [g0, g0 + BQ)
  const int k_lo = (window > 0 ? max(0, g0 - window + 1) : 0) / BK * BK;
  const int k_hi = causal ? min(Sk, g0 + BQ) : Sk;
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
      mbar_expect_tx(qbar, BQ * D * 2);
#pragma unroll
      for (int c = 0; c < D / 64; ++c)
        tma_load_3d(sq + c * CHUNK, &qmap, qbar, 64 * c, q0, bh);
      for (int it = 0; it < n_tiles; ++it) {
        const int s = it % NS;
        if (it >= NS) mbar_wait(empty + 8 * s, (it / NS - 1) & 1);
        mbar_expect_tx(full + 8 * s, 2 * TILE);
        const int k0 = k_lo + it * BK;
#pragma unroll
        for (int c = 0; c < D / 64; ++c) {
          tma_load_3d(sk + s * TILE + c * CHUNK, &kmap, full + 8 * s, 64 * c,
                      k0, bhk);
          tma_load_3d(sv + s * TILE + c * CHUNK, &vmap, full + 8 * s, 64 * c,
                      k0, bhk);
        }
      }
    }
    return;
  }

  // the consumer warpgroup: this thread holds rows r and r + 8 of the tile
  // (global rows row_base + r and row_base + r + 8), columns cl, cl + 1 of
  // every 8-column block of S and of O
  const int warp = tid / 32, lane = tid % 32;
  const int r = q0 + warp * 16 + lane / 4;
  const int cl = (lane % 4) * 2;
  float o[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) o[i] = 0.f;
  float m[2] = {NEG_BIG, NEG_BIG}, l[2] = {0.f, 0.f};

  mbar_wait(qbar, 0);
  for (int it = 0; it < n_tiles; ++it) {
    const int s = it % NS, k0 = k_lo + it * BK;
    mbar_wait(full + 8 * s, (it / NS) & 1);

    float sc[BK / 2];
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      const uint32_t at = (kk / 4) * CHUNK + (kk % 4) * 32;
      wgmma_qk(sc, desc(sq + at, 16, 1024), desc(sk + s * TILE + at, 16, 1024),
               kk > 0);
    }
    wgmma_commit();
    wgmma_wait_all();
    hold(sc);

    if (k0 + BK > Sk || (causal && k0 + BK - 1 > g0) ||
        (window > 0 && g0 + BQ - 1 - k0 >= window)) {
#pragma unroll
      for (int i = 0; i < BK / 2; ++i) {
        const int qi = row_base + r + (i & 2 ? 8 : 0);
        const int kj = k0 + (i / 4) * 8 + cl + (i & 1);
        if (kj >= Sk || (causal && kj > qi) || (window > 0 && qi - kj >= window))
          sc[i] = -INFINITY;
      }
    }
    float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int i = 0; i < BK / 2; ++i)
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
    // p in bfloat16 pairs; the A fragment of k-step kk is pa[kk]: (row r,
    // keys 16kk + cl), (row r + 8, same), (row r, keys 16kk + 8 + cl), (row
    // r + 8, same), i.e. the S blocks 2kk and 2kk + 1 in register order
    uint32_t pa[BK / 16][4];
#pragma unroll
    for (int j = 0; j < BK / 8; ++j) {
      const float p0 = ex2(fmaf(sc[4 * j], scale_log2, -m[0]));
      const float p1 = ex2(fmaf(sc[4 * j + 1], scale_log2, -m[0]));
      const float p2 = ex2(fmaf(sc[4 * j + 2], scale_log2, -m[1]));
      const float p3 = ex2(fmaf(sc[4 * j + 3], scale_log2, -m[1]));
      sum[0] += p0 + p1;
      sum[1] += p2 + p3;
      pa[j / 2][(j % 2) * 2] = pack_bf16(p0, p1);
      pa[j / 2][(j % 2) * 2 + 1] = pack_bf16(p2, p3);
    }
#pragma unroll
    for (int h = 0; h < 2; ++h) l[h] = l[h] * alpha[h] + sum[h];
#pragma unroll
    for (int i = 0; i < D / 2; ++i) o[i] *= alpha[(i >> 1) & 1];

    hold(o);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk)
      wgmma_pv(o, pa[kk], desc(sv + s * TILE + kk * 16 * 128, CHUNK, 1024));
    wgmma_commit();
    wgmma_wait_all();
    hold(o);
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) hold(pa[kk]);
    mbar_arrive(empty + 8 * s);
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
    __nv_bfloat16* row = out + ((size_t)bh * Sq + qi) * D + cl;
#pragma unroll
    for (int j = 0; j < D / 8; ++j)
      *reinterpret_cast<__nv_bfloat162*>(row + 8 * j) = __floats2bfloat162_rn(
          o[4 * j + 2 * h] / l[h], o[4 * j + 2 * h + 1] / l[h]);
  }
}

// The 3-D map (D, S, heads) of a contiguous bfloat16 (heads, S, D) tensor:
// 64 x 64 x 1 boxes with the 128-byte swizzle; rows past S read as zeros.
// Q's map has Sq rows, K's and V's Sk.
int encode(CUtensorMap* map, const void* ptr, int D, int S, int heads) {
  const EncodeTiled fn = encoder();
  if (fn == nullptr) return ERR_NO_ENCODER;
  const cuuint64_t dims[3] = {(cuuint64_t)D, (cuuint64_t)S, (cuuint64_t)heads};
  const cuuint64_t strides[2] = {(cuuint64_t)D * 2, (cuuint64_t)S * D * 2};
  const cuuint32_t box[3] = {64, 64, 1};
  const cuuint32_t step[3] = {1, 1, 1};
  const CUresult res = fn(
      map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, const_cast<void*>(ptr), dims,
      strides, box, step, CU_TENSOR_MAP_INTERLEAVE_NONE,
      CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
      CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return res == CUDA_SUCCESS ? 0 : ERR_ENCODE;
}

template <int D>
int run(const void* q, const void* k, const void* v, void* out, int B, int Hq,
        int Hkv, int Sq, int Sk, int row_base, int causal, int window,
        float scale_log2, cudaStream_t stream) {
  constexpr int bytes = smem_bytes<D>();
  auto kern = flash_attention_sm90_kernel<D>;
  static const cudaError_t opted = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (opted != cudaSuccess) return static_cast<int>(opted);
  CUtensorMap qmap, kmap, vmap;
  int err = encode(&qmap, q, D, Sq, B * Hq);
  if (err == 0) err = encode(&kmap, k, D, Sk, B * Hkv);
  if (err == 0) err = encode(&vmap, v, D, Sk, B * Hkv);
  if (err != 0) return err;
  const dim3 grid(B * Hq, (Sq + BQ - 1) / BQ);
  kern<<<grid, NT, bytes, stream>>>(qmap, kmap, vmap,
                                    static_cast<__nv_bfloat16*>(out), Hq, Hkv,
                                    Sq, Sk, row_base, causal, window,
                                    scale_log2);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Launches K6's bfloat16 route on `stream` (a cudaStream_t passed as a
// pointer) and returns 0 on success, a cudaError_t, or ERR_NO_ENCODER /
// ERR_ENCODE (negative; see cuda_error_string).  q (B, Hq, Sq, D), k and v
// (B, Hkv, Sk, D), out (B, Hq, Sq, D): bfloat16, row-major, contiguous,
// 16-byte aligned, on the current device; q's rows are rows row_base ..
// row_base + Sq - 1 of the keys' sequence, row_base >= 0 and row_base + Sq
// <= Sk.  D is 64, 128 or 256; Hq is a multiple of Hkv; window 0 means
// none.  scale_log2 is D^-1/2 log2 e.  Allocates nothing.
extern "C" int flash_attention_sm90(const void* q, const void* k,
                                    const void* v, void* out, int B, int Hq,
                                    int Hkv, int Sq, int Sk, int row_base,
                                    int D, int causal, int window,
                                    float scale_log2, void* stream) {
  if (B <= 0 || Sq <= 0) return 0;
  if (Hkv <= 0 || Hq % Hkv != 0 || row_base < 0 || row_base + Sq > Sk)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 64:
      return run<64>(q, k, v, out, B, Hq, Hkv, Sq, Sk, row_base, causal,
                     window, scale_log2, st);
    case 128:
      return run<128>(q, k, v, out, B, Hq, Hkv, Sq, Sk, row_base, causal,
                      window, scale_log2, st);
    case 256:
      return run<256>(q, k, v, out, B, Hq, Hkv, Sq, Sk, row_base, causal,
                      window, scale_log2, st);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

extern "C" const char* cuda_error_string(int code) {
  return error_string(code);
}

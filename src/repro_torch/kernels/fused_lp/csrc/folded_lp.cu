// K1, K2 and K3: the exact transition matrix of eq. 3 applied by one fused
// pass, with P never materialized.  One kernel template serves all three; the
// epilogue and the grid's third dimension tell them apart.
//
//   K1 (MODE_FOLDED) replaces repro/kernels/fused_lp/batched.py::_folded_call
//      (pl.pallas_call at batched.py:231; body _folded_body + fused_lp.py
//      stream_tile_update): one eq.-15 step in the folded (N, K = B*C) layout,
//      per-column alpha.
//   K2 (MODE_MATVEC) replaces repro/kernels/fused_lp/fused_lp.py::
//      fused_lp_matvec_kernel (pl.pallas_call at fused_lp.py:168): P @ Y.
//   K3 (MODE_PERBATCH) replaces repro/kernels/fused_lp/batched.py::
//      fused_lp_step_batched_kernel (pl.pallas_call at batched.py:138): the
//      per-batch-recompute eq.-15 step over a (B, N, C) stack with one static
//      alpha.  Batch element b is grid dimension z, so every element derives
//      the distance tile anew: this is the A/B baseline of K1's reuse and
//      must not fold.
//
// For every row i < M and column k < K (of batch element b for K3):
//
//   logit[i, j] = -max(D(x_i, x_j), 0) * inv_two_sigma_sq
//                 (NEG_BIG = -1e30 where j == row_base + i or j >= N)
//   py[i, k]    = (sum_j exp(logit[i, j] - m_i) y[j, k]) / max(s_i, 1e-38)
//   out[i, k]   = K1: alpha[k] * py + (1 - alpha[k]) * y0[i, k]
//                 K2: py
//                 K3: alpha * py + (1 - alpha) * y0[b, i, k]
//
// with the softmax computed online (running max m, normalizer s, accumulator
// acc) over column tiles, exactly the reference's recurrence and masks.  A row
// whose every column is masked (only N = 1 has one) keeps m = NEG_BIG, so every
// column counts at weight 1, as in the reference; the reference then divides
// by its padded column count, round_up(N, 256) at its default tiles, which the
// wrapper passes as n_pad and the epilogue uses for such a row.
//
// D is the tile of a Bregman divergence (the reference's tile_fn; entry point
// argument `tile`): TILE_SQ, |x_i|^2 + |x_j|^2 - 2 x_i.x_j, the inline tile of
// the reference, which also serves divergences that are squared Euclidean
// after a point pre-map (Mahalanobis: the wrapper maps the points first, as
// the reference does outside its kernel); TILE_KL, sum x_i log x_i - x_i +
// sum x_j - x_i.log x_j (repro/core/divergence.py::_kl_pairwise); TILE_IS,
// x_i.(1/x_j) - sum log x_i + sum log x_j - d (::_is_pairwise).  Each is
// rb[i] + cb[j] + cross * x_i.g(x_j): the split pass maps the column operand
// by g (identity, log, reciprocal) before it splits and pads it, and writes
// the row and column biases in place of the norms (../../csrc/tf32x3.cuh,
// SplitOp); the kernel reads `cross` (-2, -1, +1) as an argument.  So every
// tile runs the same 3xTF32 product, masks and softmax: one template, and
// the squared-Euclidean launches compute what they did before, bit for bit.
// The reference pads rows and columns past N with the divergence's in-domain
// pad value (1.0 for KL and IS) so that its padded logits stay finite; here
// rows and columns past M or N never reach the split pass: TMA reads their
// hi and lo as zeros and the kernel takes their biases as 0, so their logits
// are finite (d = 0 or a real bias) before they are masked or not written.
//
// Design.  Each entry point runs the split pass over the row points and, when
// they are other points, the column points (../../csrc/tf32x3.cuh: hi, lo and
// |.|^2 into scratch the wrapper allocates), then the kernel.  One block owns
// a row tile of BM = 128 points and a KC-wide chunk of the K columns (grid =
// (ceil(M/128), ceil(K/KC), B), KC = 4 for K <= 4, else 16) and walks the
// column tiles of BN = 128 points in a loop, which takes the place of the
// TPU's sequential grid axis; blocks share nothing, so there are no atomics,
// no split over columns, and a step is bitwise reproducible.  288 threads:
// two consumer warpgroups of 64 rows and one producer warp.  Per column tile:
//   1. the 128 x 128 distance tile's cross term on the tensor cores as
//      3xTF32 (tf32x3.cuh): the producer's lane 0 streams 32-wide chunks of d
//      (hi and lo of the row tile and of the column tile, 64 KB) into a
//      3-stage TMA ring, which runs on across column tiles; each warpgroup
//      sums a chunk's 12 wgmma.m64n128k8 into a fresh accumulator and adds it
//      to a float32 master in registers.  The row tile is re-fed through the
//      ring from L2 with every column tile: hi and lo of 128 rows at d = 315
//      are 320 KB, more than a block's shared memory.
//   2. the logits and masks in the accumulator registers (a thread holds rows
//      r and r + 8 of its warp's 16, 32 columns each; the diagonal is masked
//      through row_base + row, columns >= N too, only on tiles that hold
//      either); the running max meets over the 4 threads of a quad (shfl_xor
//      1, 2), which share their rows; p = exp(logit - m) replaces the logit
//      in place, and the tile's sum of p stays per thread.
//   3. p @ Y_tile on FP32 FMA (2 N^2 K, 5 % of the work at K = 16; TF32
//      would lose 2^-11 relative), from the registers, with the Y tile and
//      the column biases staged in shared memory by the producer warp's 32
//      lanes (a 2-slot ring of its own, one full/empty mbarrier pair a slot).
//      Each thread sums its 32 columns' share of the tile into a fresh
//      partial, then acc = acc * exp(m_old - m_new) + partial; the quad's
//      partial sums and normalizers meet once, after the last tile.
// Ragged rows and columns are zero-filled by TMA and masked; Y rows past N
// and columns past K are staged as zeros.
//
// Bounds on an H100 SXM at N = 83,679, d = 315: the float32 CUDA-core bound is
// 2 N^2 d FLOP at 67 TFLOP/s, 66.3 ms (K = 2) or 69.2 ms with the 2 N^2 K of
// p @ Y (K = 16); this route's is 3 x 2 N^2 d at the 495 TFLOP/s TF32 rate,
// 26.7 ms, plus p @ Y at 67 TFLOP/s: 0.4 ms (K = 2), 3.4 ms (K = 16).  K3 does
// the distance work once per batch element, B times over.  Each 128 x 128
// tile pair reads 655 KB of hi and lo from L2 for 31.5 MFLOP, so, as for K4,
// the L2's bandwidth is the expected limit before the tensor cores'.
#include "tf32x3.cuh"

namespace {

using namespace tf32x3;

constexpr float NEG_BIG = -1e30f;
constexpr int TERMS = 3;  // TF32 products a k step: hi.hi + hi.lo + lo.hi

enum Mode { MODE_FOLDED = 0, MODE_MATVEC = 1, MODE_PERBATCH = 2 };

// a staged Y tile: BN rows of y_stride floats (padded so the quad's rows,
// read as float4, fall in distinct banks), then the BN column biases
template <int KC>
__host__ __device__ constexpr int y_stride() { return KC == 4 ? 4 : KC + 4; }
template <int KC>
__host__ __device__ constexpr int y_slot_floats() {
  return BN * y_stride<KC>() + BN;
}
template <int KC>
__host__ __device__ constexpr int smem_bytes() {  // slack, ring, Y slots, barriers
  return 1024 + NS * stage_bytes<TERMS>() + 2 * 4 * y_slot_floats<KC>() +
         (2 * NS + 4) * 8;
}

// y is (B, N, K), y0 and out (B, M, K); B = gridDim.z (1 for K1 and K2).
// alpha is the (K,) per-column row for K1, alpha_s the one scalar for K3;
// K2 reads neither, nor y0.  rn (M,) and cn (N,) are the split pass's biases.
template <int KC, int MODE>
__global__ void __launch_bounds__(NT, 1)
folded_lp_kernel(const __grid_constant__ CUtensorMap ahi,
                 const __grid_constant__ CUtensorMap alo,
                 const __grid_constant__ CUtensorMap bhi,
                 const __grid_constant__ CUtensorMap blo,
                 const float* __restrict__ rn, const float* __restrict__ cn,
                 const float* __restrict__ y, const float* __restrict__ y0,
                 const float* __restrict__ alpha, float alpha_s,
                 float* __restrict__ out, int M, int N, int K, int n_chunks,
                 int row_base, float inv_tss, int n_pad, float cross) {
  constexpr int STAGE = stage_bytes<TERMS>();
  constexpr int YS = y_stride<KC>();
  constexpr int YSLOT = y_slot_floats<KC>();
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = sm90::smem_addr(smem_raw);
  const uint32_t ring = (raw + 1023u) & ~1023u;
  float* ytiles = reinterpret_cast<float*>(smem_raw + (ring - raw) +
                                           NS * STAGE);  // 2 slots
  const uint32_t full = ring + NS * STAGE + 2 * 4 * YSLOT;
  const uint32_t empty = full + 8 * NS;
  const uint32_t yfull = empty + 8 * NS, yempty = yfull + 16;

  const int tid = threadIdx.x;
  const int row0 = blockIdx.x * BM;
  const int k0 = blockIdx.y * KC;
  const int n_tn = (N + BN - 1) / BN;
  y += (size_t)blockIdx.z * N * K;
  out += (size_t)blockIdx.z * M * K;
  if (MODE != MODE_MATVEC) y0 += (size_t)blockIdx.z * M * K;

  if (tid == 0) {
    for (int s = 0; s < NS; ++s) {
      sm90::mbar_init(full + 8 * s, 1);
      sm90::mbar_init(empty + 8 * s, NCONS);
    }
    for (int s = 0; s < 2; ++s) {
      sm90::mbar_init(yfull + 8 * s, 32);
      sm90::mbar_init(yempty + 8 * s, NCONS);
    }
    sm90::mbar_init_fence();
  }
  __syncthreads();

  if (tid >= NCONS) {  // the producer warp
    const int lane = tid - NCONS;
    int it = 0;
    for (int tn = 0; tn < n_tn; ++tn) {
      const int c0 = tn * BN, slot = tn & 1;
      // the Y tile and column biases, all 32 lanes, 16 loads in flight a lane
      if (tn >= 2) sm90::mbar_wait(yempty + 8 * slot, ((tn >> 1) - 1) & 1);
      float* yt = ytiles + slot * YSLOT;
      for (int e0 = 0; e0 < BN * KC; e0 += 32 * 16) {
        float v[16];
#pragma unroll
        for (int u = 0; u < 16; ++u) {
          const int e = e0 + 32 * u + lane, j = e / KC, c = e % KC;
          v[u] = e < BN * KC && c0 + j < N && k0 + c < K
                     ? y[(size_t)(c0 + j) * K + k0 + c]
                     : 0.f;
        }
#pragma unroll
        for (int u = 0; u < 16; ++u) {
          const int e = e0 + 32 * u + lane;
          if (e < BN * KC) yt[e / KC * YS + e % KC] = v[u];
        }
      }
      for (int j = lane; j < BN; j += 32)
        yt[BN * YS + j] = c0 + j < N ? cn[c0 + j] : 0.f;
      sm90::mbar_arrive(yfull + 8 * slot);
      for (int c = 0; c < n_chunks; ++c, ++it) {
        const int s = it % NS;
        if (it >= NS) sm90::mbar_wait(empty + 8 * s, (it / NS - 1) & 1);
        if (lane == 0)
          produce<TERMS>(ring + s * STAGE, full + 8 * s, &ahi, &alo, &bhi, &blo,
                     row0, c0, c * DC);
        __syncwarp();
      }
    }
    return;
  }

  // the consumer warpgroups: this thread holds rows ra and ra + 8
  const int wg = tid / 128, t = tid % 128, lane = tid % 32;
  const int ra = row0 + wg * 64 + frag_row(t, 0);
  float rnorm[2], m[2], l[2], acc[2][KC];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    rnorm[h] = ra + 8 * h < M ? rn[ra + 8 * h] : 0.f;
    m[h] = NEG_BIG;
    l[h] = 0.f;
#pragma unroll
    for (int c = 0; c < KC; ++c) acc[h][c] = 0.f;
  }
  // the block's rows meet the diagonal in column tiles [diag_lo, diag_hi)
  const int diag_lo = row_base + row0, diag_hi = diag_lo + BM;

  int it = 0;
  for (int tn = 0; tn < n_tn; ++tn) {
    const int c0 = tn * BN, slot = tn & 1;
    // ---- 1. the distance tile's cross term --------------------------------
    float sc[64];
#pragma unroll
    for (int i = 0; i < 64; ++i) sc[i] = 0.f;
    for (int c = 0; c < n_chunks; ++c, ++it) {
      const int s = it % NS;
      sm90::mbar_wait(full + 8 * s, (it / NS) & 1);
      consume<TERMS>(sc, ring + s * STAGE, wg);
      sm90::mbar_arrive(empty + 8 * s);
    }
    sm90::mbar_wait(yfull + 8 * slot, (tn >> 1) & 1);
    const float* yt = ytiles + slot * YSLOT;

    // ---- 2. masked logits and the online softmax, in registers ------------
    const bool edge = c0 + BN > N || (c0 < diag_hi && diag_lo < c0 + BN);
    float mx[2] = {NEG_BIG, NEG_BIG};
#pragma unroll
    for (int i = 0; i < 64; ++i) {
      const int h = (i >> 1) & 1, col = frag_col(t, i);
      // cross * sc is exact (cross is -2, -1 or +1), so this is
      // (rb[i] + cb[j]) + cross x_i.g(x_j) rounded once
      const float d2 = fmaf(cross, sc[i], rnorm[h] + yt[BN * YS + col]);
      float lg = -fmaxf(d2, 0.f) * inv_tss;
      if (edge && (c0 + col >= N || c0 + col == row_base + ra + 8 * h))
        lg = NEG_BIG;
      sc[i] = lg;
      mx[h] = fmaxf(mx[h], lg);
    }
    float scale[2], sum[2] = {0.f, 0.f};
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 1));
      mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 2));
      const float m_new = fmaxf(m[h], mx[h]);
      scale[h] = expf(m[h] - m_new);
      m[h] = m_new;
    }
#pragma unroll
    for (int i = 0; i < 64; ++i) {
      const int h = (i >> 1) & 1;
      sc[i] = expf(sc[i] - m[h]);
      sum[h] += sc[i];
    }

    // ---- 3. acc = acc * scale + p @ Y_tile --------------------------------
    float part[2][KC];
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
      for (int c = 0; c < KC; ++c) part[h][c] = 0.f;
#pragma unroll
    for (int i = 0; i < 64; i += 4) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const float4* yr =
            reinterpret_cast<const float4*>(yt + frag_col(t, i + e) * YS);
#pragma unroll
        for (int q = 0; q < KC / 4; ++q) {
          const float4 v = yr[q];
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const float p = sc[i + 2 * h + e];
            part[h][4 * q] = fmaf(p, v.x, part[h][4 * q]);
            part[h][4 * q + 1] = fmaf(p, v.y, part[h][4 * q + 1]);
            part[h][4 * q + 2] = fmaf(p, v.z, part[h][4 * q + 2]);
            part[h][4 * q + 3] = fmaf(p, v.w, part[h][4 * q + 3]);
          }
        }
      }
    }
    sm90::mbar_arrive(yempty + 8 * slot);
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      l[h] = fmaf(l[h], scale[h], sum[h]);
#pragma unroll
      for (int c = 0; c < KC; ++c)
        acc[h][c] = fmaf(acc[h][c], scale[h], part[h][c]);
    }
  }

  // ---- epilogue: the quad's sums meet, py = acc / s, the mode's update -----
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    l[h] += __shfl_xor_sync(0xffffffffu, l[h], 1);
    l[h] += __shfl_xor_sync(0xffffffffu, l[h], 2);
#pragma unroll
    for (int c = 0; c < KC; ++c) {
      acc[h][c] += __shfl_xor_sync(0xffffffffu, acc[h][c], 1);
      acc[h][c] += __shfl_xor_sync(0xffffffffu, acc[h][c], 2);
    }
  }
  const int q4 = lane & 3;  // this thread writes columns q4, q4 + 4, ...
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int gr = ra + 8 * h;
    if (gr >= M) continue;
    // an all-masked row normalizes over the reference's padded column count
    const float s = fmaxf(m[h] == NEG_BIG ? (float)n_pad : l[h], 1e-38f);
#pragma unroll
    for (int c4 = 0; c4 < KC; c4 += 4) {
      float a = acc[h][c4];
#pragma unroll
      for (int u = 1; u < 4; ++u)
        if (q4 == u) a = acc[h][c4 + u];
      const int gk = k0 + c4 + q4;
      if (gk >= K) continue;
      const size_t o = (size_t)gr * K + gk;
      const float py = a / s;
      if (MODE == MODE_MATVEC) {
        out[o] = py;
      } else {
        const float al = MODE == MODE_FOLDED ? alpha[gk] : alpha_s;
        out[o] = al * py + (1.f - al) * y0[o];
      }
    }
  }
}

template <int KC, int MODE>
int run(const CUtensorMap (&maps)[4], const float* rn, const float* cn,
        const float* y, const float* y0, const float* alpha, float alpha_s,
        float* out, int M, int N, int K, int B, int n_chunks, int row_base,
        float inv_tss, int n_pad, float cross, cudaStream_t stream) {
  constexpr int bytes = smem_bytes<KC>();
  auto kern = folded_lp_kernel<KC, MODE>;
  static const cudaError_t opted = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (opted != cudaSuccess) return static_cast<int>(opted);
  const dim3 grid((M + BM - 1) / BM, (K + KC - 1) / KC, B);
  kern<<<grid, NT, bytes, stream>>>(maps[0], maps[1], maps[2], maps[3], rn, cn,
                                    y, y0, alpha, alpha_s, out, M, N, K,
                                    n_chunks, row_base, inv_tss, n_pad, cross);
  return static_cast<int>(cudaGetLastError());
}

enum Tile { TILE_SQ = 0, TILE_KL = 1, TILE_IS = 2 };

// The split pass of one operand under `op` (a SplitOp).
int split_op(int op, const float* x, float* hi, float* lo, float* bias,
             int rows, int d, int d_pad, cudaStream_t st) {
  switch (op) {
    case SPLIT_SQ:
      return split<float, SPLIT_SQ>(x, hi, lo, bias, rows, d, d_pad, st);
    case SPLIT_KL_ROW:
      return split<float, SPLIT_KL_ROW>(x, hi, lo, bias, rows, d, d_pad, st);
    case SPLIT_KL_COL:
      return split<float, SPLIT_KL_COL>(x, hi, lo, bias, rows, d, d_pad, st);
    case SPLIT_IS_ROW:
      return split<float, SPLIT_IS_ROW>(x, hi, lo, bias, rows, d, d_pad, st);
    case SPLIT_IS_COL:
      return split<float, SPLIT_IS_COL>(x, hi, lo, bias, rows, d, d_pad, st);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

// The split pass over the row points xr (M, d) and, unless chi == rhi (the
// rows are the columns under the squared-Euclidean tile, whose two operands
// split alike), the column points xc (N, d), each under its op of `tile`;
// then the kernel.
template <int MODE>
int launch(const float* xr, const float* xc, const float* y, const float* y0,
           const float* alpha, float alpha_s, float* out, float* rhi,
           float* rlo, float* rn, float* chi, float* clo, float* cn, int M,
           int N, int d, int d_pad, int K, int B, int row_base, float inv_tss,
           int n_pad, int tile, int* products, void* stream) {
  *products = TERMS;
  if (M <= 0 || K <= 0 || B <= 0) return 0;
  if (d_pad != padded_width(d)) return static_cast<int>(cudaErrorInvalidValue);
  int row_op, col_op;
  float cross;
  switch (tile) {
    case TILE_SQ: row_op = col_op = SPLIT_SQ; cross = -2.f; break;
    case TILE_KL: row_op = SPLIT_KL_ROW; col_op = SPLIT_KL_COL; cross = -1.f;
      break;
    case TILE_IS: row_op = SPLIT_IS_ROW; col_op = SPLIT_IS_COL; cross = 1.f;
      break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  // only the squared-Euclidean tile may share one split between the operands
  if (chi == rhi && tile != TILE_SQ)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  int err = split_op(row_op, xr, rhi, rlo, rn, M, d, d_pad, st);
  if (err == 0 && chi != rhi)
    err = split_op(col_op, xc, chi, clo, cn, N, d, d_pad, st);
  CUtensorMap maps[4];
  if (err == 0) err = encode(&maps[0], rhi, M, d_pad);
  if (err == 0) err = encode(&maps[1], rlo, M, d_pad);
  if (N > 0) {  // with no columns nothing is loaded: the row maps stand in
    if (err == 0) err = encode(&maps[2], chi, N, d_pad);
    if (err == 0) err = encode(&maps[3], clo, N, d_pad);
  } else {
    maps[2] = maps[0];
    maps[3] = maps[1];
  }
  if (err != 0) return err;
  const int n_chunks = d_pad / DC;
  if (K <= 4)
    return run<4, MODE>(maps, rn, cn, y, y0, alpha, alpha_s, out, M, N, K, B,
                        n_chunks, row_base, inv_tss, n_pad, cross, st);
  return run<16, MODE>(maps, rn, cn, y, y0, alpha, alpha_s, out, M, N, K, B,
                       n_chunks, row_base, inv_tss, n_pad, cross, st);
}

}  // namespace

// Each entry point runs the split pass, then its kernel, on `stream` (a
// cudaStream_t passed as a pointer), and returns 0 on success, a cudaError_t,
// or a negative tensor-map error (see cuda_error_string).  All operands are
// float32, row-major, contiguous, on the current device; nothing is
// allocated.  Scratch from the caller, float32, 16-byte aligned: hi and lo
// (rows, d_pad) and the biases (rows,) of the row operand (rhi, rlo, rn) and
// of the column operand (chi, clo, cn; the row pointers again when the rows
// are the columns and tile is TILE_SQ), d_pad = round_up(d, 32) (32 when
// d = 0).  n_pad is the reference's padded column count (see above), tile a
// Tile.  *products receives the number of TF32 products a k step of the
// launched kernel takes (TERMS), which the wrapper counts as the launch's
// route.

// K1.  xr (M, d), xc (N, d), y (N, K), y0 (M, K), alpha (K,), out (M, K).
extern "C" int folded_lp_step(const float* xr, const float* xc, const float* y,
                              const float* y0, const float* alpha, float* out,
                              float* rhi, float* rlo, float* rn, float* chi,
                              float* clo, float* cn, int M, int N, int d,
                              int d_pad, int K, int row_base,
                              float inv_two_sigma_sq, int n_pad, int tile,
                              int* products, void* stream) {
  return launch<MODE_FOLDED>(xr, xc, y, y0, alpha, 0.f, out, rhi, rlo, rn, chi,
                             clo, cn, M, N, d, d_pad, K, 1, row_base,
                             inv_two_sigma_sq, n_pad, tile, products, stream);
}

// K2.  x (N, d), y (N, C), out (N, C).
extern "C" int fused_lp_matvec(const float* x, const float* y, float* out,
                               float* rhi, float* rlo, float* rn, float* chi,
                               float* clo, float* cn, int N, int d, int d_pad,
                               int C, float inv_two_sigma_sq, int n_pad,
                               int tile, int* products, void* stream) {
  return launch<MODE_MATVEC>(x, x, y, nullptr, nullptr, 0.f, out, rhi, rlo, rn,
                             chi, clo, cn, N, N, d, d_pad, C, 1, 0,
                             inv_two_sigma_sq, n_pad, tile, products, stream);
}

// K3.  x (N, d), y, y0 and out (B, N, C), one alpha for all.
extern "C" int fused_lp_step_perbatch(const float* x, const float* y,
                                      const float* y0, float* out, float* rhi,
                                      float* rlo, float* rn, float* chi,
                                      float* clo, float* cn, int B, int N,
                                      int d, int d_pad, int C, float alpha,
                                      float inv_two_sigma_sq, int n_pad,
                                      int tile, int* products, void* stream) {
  return launch<MODE_PERBATCH>(x, x, y, y0, nullptr, alpha, out, rhi, rlo, rn,
                               chi, clo, cn, N, N, d, d_pad, C, B, 0,
                               inv_two_sigma_sq, n_pad, tile, products, stream);
}

extern "C" const char* cuda_error_string(int code) {
  return sm90::error_string(code);
}

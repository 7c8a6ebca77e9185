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
//   logit[i, j] = -max(|x_i|^2 + |x_j|^2 - 2 x_i.x_j, 0) * inv_two_sigma_sq
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
// Design.  One thread block owns a BM = 64 row tile and a KC-wide chunk of the
// K columns (grid = (ceil(M/64), ceil(K/KC), B)).  A loop inside the block
// walks the column tiles of BN = 64 points, which takes the place of the
// TPU's sequential grid axis; blocks share nothing, so there are no atomics
// and a step is bitwise reproducible.  Per column tile:
//   1. the 64x64 distance tile, as a register-tiled FP32 FMA product (each of
//      the 256 threads owns 4x4 entries) over d in chunks of DK staged in
//      shared memory; the row and column norms come from the same chunks.
//      No tensor cores and no TF32: the |x|^2 + |y|^2 - 2 x.y cancellation
//      needs full float32.
//   2. masked logits into shared memory; one warp per 8 rows updates the
//      running max and normalizer with warp shuffles and turns the tile into
//      p = exp(logit - m_new).
//   3. acc = acc * exp(m_old - m_new) + p @ Y_tile, with the Y tile staged in
//      shared memory and acc in registers (4 rows x KC/16 columns a thread).
// A K wider than one chunk is served by the grid's second dimension, which
// recomputes the distance tile per chunk (KC = 16 for K <= 16, else 64).
// Ragged rows, columns and chunks are masked in the kernel; nothing is padded.
//
// Bound on an H100 SXM: 2*N^2*d FLOP of distance work (plus 2*N^2*K for
// p @ Y) at the 67 TFLOP/s float32 peak outside the tensor cores; for
// d >> K the kernel is compute-bound (N = 83,679, d = 315: about 66 ms).
// K3 does that distance work once per batch element, B times over.
// What this simple design leaves on the table: the inner product reads two
// shared-memory words per FMA pair (no float4 fragments, no 8x8 register
// tiles), the row tile is restaged for every column tile, there is no
// cp.async/TMA pipelining of the next chunk, and a split of the product
// into a TF32-safe wgmma form (e.g. 3xTF32) is not attempted.
#include <cuda_runtime.h>

namespace {

constexpr int BM = 64;
constexpr int BN = 64;
constexpr int DK = 16;
constexpr int NT = 256;
constexpr float NEG_BIG = -1e30f;

enum Mode { MODE_FOLDED = 0, MODE_MATVEC = 1, MODE_PERBATCH = 2 };

// y is (B, N, K), y0 and out (B, M, K); B = gridDim.z (1 for K1 and K2).
// alpha is the (K,) per-column row for K1, alpha_s the one scalar for K3;
// K2 reads neither, nor y0.
template <int KC, int MODE>
__global__ void __launch_bounds__(NT)
folded_lp_kernel(const float* __restrict__ xr, const float* __restrict__ xc,
                 const float* __restrict__ y, const float* __restrict__ y0,
                 const float* __restrict__ alpha, float alpha_s,
                 float* __restrict__ out, int M, int N, int d, int K,
                 int row_base, float inv_tss, int n_pad) {
  constexpr int CPT = KC / 16;  // accumulator columns per thread
  __shared__ float s_xr[DK][BM + 1];
  __shared__ float s_xc[DK][BN + 1];
  __shared__ float s_p[BM][BN + 1];
  __shared__ float s_y[BN][KC];
  __shared__ float s_rn[BM];
  __shared__ float s_cn[BN];
  __shared__ float s_m[BM];
  __shared__ float s_s[BM];
  __shared__ float s_scale[BM];

  const int t = threadIdx.x;
  const int tx = t % 16;
  const int ty = t / 16;
  const int lane = t % 32;
  const int warp = t / 32;
  const int row0 = blockIdx.x * BM;
  const int k0 = blockIdx.y * KC;
  y += (size_t)blockIdx.z * N * K;
  out += (size_t)blockIdx.z * M * K;
  if (MODE != MODE_MATVEC) y0 += (size_t)blockIdx.z * M * K;

  if (t < BM) {
    s_m[t] = NEG_BIG;
    s_s[t] = 0.f;
  }
  float acc[4][CPT];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int c = 0; c < CPT; ++c) acc[i][c] = 0.f;

  for (int col0 = 0; col0 < N; col0 += BN) {
    // ---- 1. distance tile --------------------------------------------------
    float dot[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) dot[i][j] = 0.f;
    float nrm = 0.f;  // t < BM: norm of row t; BM <= t < BM + BN: of column t - BM
    for (int kk = 0; kk < d; kk += DK) {
      for (int e = t; e < BM * DK; e += NT) {
        const int r = e / DK, k = e % DK, gk = kk + k;
        const int gr = row0 + r, gc = col0 + r;
        s_xr[k][r] = (gr < M && gk < d) ? xr[(size_t)gr * d + gk] : 0.f;
        s_xc[k][r] = (gc < N && gk < d) ? xc[(size_t)gc * d + gk] : 0.f;
      }
      __syncthreads();
      if (t < BM) {
#pragma unroll
        for (int k = 0; k < DK; ++k) nrm = fmaf(s_xr[k][t], s_xr[k][t], nrm);
      } else if (t < BM + BN) {
#pragma unroll
        for (int k = 0; k < DK; ++k)
          nrm = fmaf(s_xc[k][t - BM], s_xc[k][t - BM], nrm);
      }
#pragma unroll
      for (int k = 0; k < DK; ++k) {
        float a[4], b[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) a[i] = s_xr[k][ty + 16 * i];
#pragma unroll
        for (int j = 0; j < 4; ++j) b[j] = s_xc[k][tx + 16 * j];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) dot[i][j] = fmaf(a[i], b[j], dot[i][j]);
      }
      __syncthreads();
    }
    if (t < BM) {
      s_rn[t] = nrm;
    } else if (t < BM + BN) {
      s_cn[t - BM] = nrm;
    }
    __syncthreads();

    // ---- 2. masked logits, Y tile, online softmax ------------------------
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = ty + 16 * i;
      const int grow = row_base + row0 + r;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int c = tx + 16 * j;
        const int gc = col0 + c;
        const float d2 = s_rn[r] + s_cn[c] - 2.f * dot[i][j];
        float lg = -fmaxf(d2, 0.f) * inv_tss;
        if (gc >= N || gc == grow) lg = NEG_BIG;
        s_p[r][c] = lg;
      }
    }
    for (int e = t; e < BN * KC; e += NT) {
      const int j = e / KC, c = e % KC;
      const int gc = col0 + j, gk = k0 + c;
      s_y[j][c] = (gc < N && gk < K) ? y[(size_t)gc * K + gk] : 0.f;
    }
    __syncthreads();

    for (int rr = 0; rr < BM / (NT / 32); ++rr) {
      const int r = warp * (BM / (NT / 32)) + rr;
      const float l0 = s_p[r][lane];
      const float l1 = s_p[r][lane + 32];
      float mx = fmaxf(l0, l1);
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_prev = s_m[r];
      const float m_new = fmaxf(m_prev, mx);
      const float p0 = expf(l0 - m_new);
      const float p1 = expf(l1 - m_new);
      s_p[r][lane] = p0;
      s_p[r][lane + 32] = p1;
      float sum = p0 + p1;
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        sum += __shfl_xor_sync(0xffffffffu, sum, off);
      if (lane == 0) {
        const float sc = expf(m_prev - m_new);
        s_scale[r] = sc;
        s_s[r] = s_s[r] * sc + sum;
        s_m[r] = m_new;
      }
    }
    __syncthreads();

    // ---- 3. acc = acc * scale + p @ Y_tile --------------------------------
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float sc = s_scale[ty + 16 * i];
#pragma unroll
      for (int c = 0; c < CPT; ++c) acc[i][c] *= sc;
    }
    for (int j = 0; j < BN; ++j) {
      float pv[4], yv[CPT];
#pragma unroll
      for (int i = 0; i < 4; ++i) pv[i] = s_p[ty + 16 * i][j];
#pragma unroll
      for (int c = 0; c < CPT; ++c) yv[c] = s_y[j][tx + 16 * c];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int c = 0; c < CPT; ++c) acc[i][c] = fmaf(pv[i], yv[c], acc[i][c]);
    }
    __syncthreads();
  }

  // ---- epilogue: py = acc / s, then the mode's update ------------------------
  __syncthreads();  // s_s is complete even when the column loop did not run
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = ty + 16 * i;
    const int gr = row0 + r;
    if (gr >= M) continue;
    // an all-masked row normalizes over the reference's padded column count
    const float s = fmaxf(s_m[r] == NEG_BIG ? (float)n_pad : s_s[r], 1e-38f);
#pragma unroll
    for (int c = 0; c < CPT; ++c) {
      const int gk = k0 + tx + 16 * c;
      if (gk >= K) continue;
      const size_t o = (size_t)gr * K + gk;
      const float py = acc[i][c] / s;
      if (MODE == MODE_MATVEC) {
        out[o] = py;
      } else {
        const float al = MODE == MODE_FOLDED ? alpha[gk] : alpha_s;
        out[o] = al * py + (1.f - al) * y0[o];
      }
    }
  }
}

template <int MODE>
int launch(const float* xr, const float* xc, const float* y, const float* y0,
           const float* alpha, float alpha_s, float* out, int M, int N, int d,
           int K, int B, int row_base, float inv_tss, int n_pad, void* stream) {
  if (M <= 0 || K <= 0 || B <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const dim3 block(NT);
  if (K <= 16) {
    const dim3 grid((M + BM - 1) / BM, (K + 15) / 16, B);
    folded_lp_kernel<16, MODE><<<grid, block, 0, s>>>(
        xr, xc, y, y0, alpha, alpha_s, out, M, N, d, K, row_base, inv_tss,
        n_pad);
  } else {
    const dim3 grid((M + BM - 1) / BM, (K + 63) / 64, B);
    folded_lp_kernel<64, MODE><<<grid, block, 0, s>>>(
        xr, xc, y, y0, alpha, alpha_s, out, M, N, d, K, row_base, inv_tss,
        n_pad);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Each entry point launches its kernel on `stream` (a cudaStream_t passed as a
// pointer) and returns cudaGetLastError() as an int (0 on success).  All
// operands are float32, row-major, contiguous, on the current device; nothing
// is allocated.  n_pad is the reference's padded column count (see above).

// K1.  xr (M, d), xc (N, d), y (N, K), y0 (M, K), alpha (K,), out (M, K).
extern "C" int folded_lp_step(const float* xr, const float* xc, const float* y,
                              const float* y0, const float* alpha, float* out,
                              int M, int N, int d, int K, int row_base,
                              float inv_two_sigma_sq, int n_pad, void* stream) {
  return launch<MODE_FOLDED>(xr, xc, y, y0, alpha, 0.f, out, M, N, d, K, 1,
                             row_base, inv_two_sigma_sq, n_pad, stream);
}

// K2.  x (N, d), y (N, C), out (N, C).
extern "C" int fused_lp_matvec(const float* x, const float* y, float* out,
                               int N, int d, int C, float inv_two_sigma_sq,
                               int n_pad, void* stream) {
  return launch<MODE_MATVEC>(x, x, y, nullptr, nullptr, 0.f, out, N, N, d, C,
                             1, 0, inv_two_sigma_sq, n_pad, stream);
}

// K3.  x (N, d), y, y0 and out (B, N, C), one alpha for all.
extern "C" int fused_lp_step_perbatch(const float* x, const float* y,
                                      const float* y0, float* out, int B,
                                      int N, int d, int C, float alpha,
                                      float inv_two_sigma_sq, int n_pad,
                                      void* stream) {
  return launch<MODE_PERBATCH>(x, x, y, y0, nullptr, alpha, out, N, N, d, C,
                               B, 0, inv_two_sigma_sq, n_pad, stream);
}

extern "C" const char* cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

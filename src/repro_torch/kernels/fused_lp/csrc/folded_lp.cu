// K1: one eq.-15 label-propagation step against the exact transition matrix,
// in the folded (N, K = B*C) layout, with P never materialized.
//
// Replaces the TPU kernel repro/kernels/fused_lp/batched.py::_folded_call
// (pl.pallas_call at batched.py:231; body _folded_body + fused_lp.py
// stream_tile_update).  For every row i < M and folded column k < K:
//
//   logit[i, j] = -max(|x_i|^2 + |x_j|^2 - 2 x_i.x_j, 0) * inv_two_sigma_sq
//                 (NEG_BIG = -1e30 where j == row_base + i or j >= N)
//   out[i, k]   = alpha[k] * (sum_j softmax_j(logit[i, :]) y[j, k]) / max(s, 1e-38)
//                 + (1 - alpha[k]) * y0[i, k]
//
// with the softmax computed online (running max m, normalizer s, accumulator
// acc) over column tiles, exactly the reference's recurrence and masks.
//
// Design.  One thread block owns a BM = 64 row tile and a KC-wide chunk of the
// K folded columns (grid = (ceil(M/64), ceil(K/KC))).  A loop inside the block
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

template <int KC>
__global__ void __launch_bounds__(NT)
folded_lp_kernel(const float* __restrict__ xr, const float* __restrict__ xc,
                 const float* __restrict__ y, const float* __restrict__ y0,
                 const float* __restrict__ alpha, float* __restrict__ out,
                 int M, int N, int d, int K, int row_base, float inv_tss) {
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

  // ---- epilogue: alpha * acc / s + (1 - alpha) * y0 -------------------------
  __syncthreads();  // s_s is complete even when the column loop did not run
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = ty + 16 * i;
    const int gr = row0 + r;
    if (gr >= M) continue;
    const float s = fmaxf(s_s[r], 1e-38f);
#pragma unroll
    for (int c = 0; c < CPT; ++c) {
      const int gk = k0 + tx + 16 * c;
      if (gk >= K) continue;
      const float al = alpha[gk];
      const size_t o = (size_t)gr * K + gk;
      out[o] = al * (acc[i][c] / s) + (1.f - al) * y0[o];
    }
  }
}

}  // namespace

// Launches K1 on `stream` (a cudaStream_t passed as a pointer) and returns
// cudaGetLastError() as an int (0 on success).  Shapes: xr (M, d), xc (N, d),
// y (N, K), y0 (M, K), alpha (K,), out (M, K); all float32, row-major,
// contiguous, on the current device.  Allocates nothing.
extern "C" int folded_lp_step(const float* xr, const float* xc, const float* y,
                              const float* y0, const float* alpha, float* out,
                              int M, int N, int d, int K, int row_base,
                              float inv_two_sigma_sq, void* stream) {
  if (M <= 0 || K <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const dim3 block(NT);
  if (K <= 16) {
    const dim3 grid((M + BM - 1) / BM, (K + 15) / 16);
    folded_lp_kernel<16><<<grid, block, 0, s>>>(xr, xc, y, y0, alpha, out, M,
                                                 N, d, K, row_base,
                                                 inv_two_sigma_sq);
  } else {
    const dim3 grid((M + BM - 1) / BM, (K + 63) / 64);
    folded_lp_kernel<64><<<grid, block, 0, s>>>(xr, xc, y, y0, alpha, out, M,
                                                 N, d, K, row_base,
                                                 inv_two_sigma_sq);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* folded_lp_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// K4: tiled pairwise squared distances, D2[i, j] = max(|x_i|^2 + |y_j|^2 -
// 2 x_i.y_j, 0), for x (M, d) and y (N, d) in float32 or bfloat16; the output
// is float32 (M, N).
//
// Replaces the TPU kernel repro/kernels/pairwise/pairwise.py::
// pairwise_sq_dists_kernel (pl.pallas_call at pairwise.py:50, body _kernel),
// which upcasts its tiles to float32 and computes the cross term on the MXU.
//
// Design.  One thread block of 256 threads owns a 64 x 64 output tile
// (grid = (ceil(N/64), ceil(M/64))).  It walks d in chunks of DK = 16: the x
// and y rows of the chunk are upcast to float32 on load and staged in shared
// memory, each thread accumulates a 4 x 4 register tile of the cross term with
// FP32 FMA, and the row and column norms come from the same staged chunks.
// No tensor cores and no TF32: |x|^2 + |y|^2 - 2 x.y cancels, and TF32 keeps
// about three decimal digits.  Ragged edges of M, N and d are masked in the
// kernel; nothing is padded.
//
// Bound on an H100 SXM: 2*M*N*d FLOP at the 67 TFLOP/s float32 peak outside
// the tensor cores, or M*N*4 bytes written at 3.35 TB/s, whichever is larger;
// at the kNN block shape (2048 x 83,679, d = 315) it is compute-bound, about
// 1.6 ms.  What this simple design leaves for later: 8x8 register tiles with
// float4 shared-memory fragments, cp.async/TMA double buffering of the next
// chunk, and a 3xTF32 or bf16x3 split onto wgmma.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int BM = 64;
constexpr int BN = 64;
constexpr int DK = 16;
constexpr int NT = 256;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

template <typename T>
__global__ void __launch_bounds__(NT)
pairwise_kernel(const T* __restrict__ x, const T* __restrict__ y,
                float* __restrict__ out, int M, int N, int d) {
  __shared__ float s_x[DK][BM + 1];
  __shared__ float s_y[DK][BN + 1];
  __shared__ float s_xn[BM];
  __shared__ float s_yn[BN];

  const int t = threadIdx.x;
  const int tx = t % 16;
  const int ty = t / 16;
  const int col0 = blockIdx.x * BN;
  const int row0 = blockIdx.y * BM;

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
      s_x[k][r] = (gr < M && gk < d) ? to_f32(x[(size_t)gr * d + gk]) : 0.f;
      s_y[k][r] = (gc < N && gk < d) ? to_f32(y[(size_t)gc * d + gk]) : 0.f;
    }
    __syncthreads();
    if (t < BM) {
#pragma unroll
      for (int k = 0; k < DK; ++k) nrm = fmaf(s_x[k][t], s_x[k][t], nrm);
    } else if (t < BM + BN) {
#pragma unroll
      for (int k = 0; k < DK; ++k)
        nrm = fmaf(s_y[k][t - BM], s_y[k][t - BM], nrm);
    }
#pragma unroll
    for (int k = 0; k < DK; ++k) {
      float a[4], b[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = s_x[k][ty + 16 * i];
#pragma unroll
      for (int j = 0; j < 4; ++j) b[j] = s_y[k][tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) dot[i][j] = fmaf(a[i], b[j], dot[i][j]);
    }
    __syncthreads();
  }
  if (t < BM) {
    s_xn[t] = nrm;
  } else if (t < BM + BN) {
    s_yn[t - BM] = nrm;
  }
  __syncthreads();

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = ty + 16 * i;
    if (row0 + r >= M) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int c = tx + 16 * j;
      if (col0 + c >= N) continue;
      out[(size_t)(row0 + r) * N + col0 + c] =
          fmaxf(s_xn[r] + s_yn[c] - 2.f * dot[i][j], 0.f);
    }
  }
}

template <typename T>
int launch(const void* x, const void* y, float* out, int M, int N, int d,
           void* stream) {
  if (M <= 0 || N <= 0) return 0;
  const dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM);
  pairwise_kernel<T><<<grid, NT, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(x), static_cast<const T*>(y), out, M, N, d);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Each entry point launches K4 on `stream` (a cudaStream_t passed as a pointer)
// and returns cudaGetLastError() as an int (0 on success).  x (M, d) and y
// (N, d) row-major and contiguous in the entry point's type; out (M, N)
// float32.  Allocates nothing.
extern "C" int pairwise_sq_dists_f32(const void* x, const void* y, float* out,
                                     int M, int N, int d, void* stream) {
  return launch<float>(x, y, out, M, N, d, stream);
}

extern "C" int pairwise_sq_dists_bf16(const void* x, const void* y, float* out,
                                      int M, int N, int d, void* stream) {
  return launch<__nv_bfloat16>(x, y, out, M, N, d, stream);
}

extern "C" const char* cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

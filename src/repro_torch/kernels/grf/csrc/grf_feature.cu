// K5: the GRF walker-mean feature product,
//
//   out[s, c] = (1/m) * sum_w load[s, w] * y[pos[s, w], c]
//
// for walker positions pos (S, m) int32, loads (S, m) float32 and values
// y (N, K) float32; out is (S, K) float32.  One call reduces one step's walker
// population to its Monte-Carlo estimate of a row block of P^t @ Y.
//
// Replaces the TPU kernel repro/kernels/grf/grf.py::grf_feature_kernel
// (pl.pallas_call at grf.py:72, body _kernel).  That kernel phrases the gather
// y[pos] as a weighted one-hot matmul over column tiles of y, because TPU
// Pallas does not vectorize a dynamic gather.  On Hopper a direct gather is
// the natural form, so nothing of the selector is carried over.
//
// Design.  One warp per output row s (8 warps, 256 threads a block).  The
// lanes stride over the m walkers (lane l takes w = l, l + 32, ...), so the
// pos and load reads of a row are coalesced; each lane gathers y[pos, c] for
// a chunk of CK = 16 columns held in registers and accumulates
// load * y with FP32 FMA.  A fixed xor-shuffle tree then sums the 32 lanes and
// the result is scaled by 1/m.  There are no atomics.  Column c's sum order
// depends only on m (the lane split and the tree), never on K or on which
// chunk holds c, so a folded batch of requests reproduces each request's solo
// call bit for bit.  A K wider than one chunk loops over chunks and rereads
// the row's pos and load (from L1/L2).  Ragged m and K are masked; nothing is
// padded.  A position outside [0, N) contributes 0, as it does in the
// reference's one-hot selector, and is never read.
//
// Bound on an H100 SXM: bytes.  The kernel must read pos and load (S*m*8
// bytes) and write out (S*K*4 bytes) at 3.35 TB/s; y (N*K*4 bytes, 0.67 MB at
// N = 83,679, K = 2) stays resident in the 50 MB L2, and its gathers are not
// counted.  What this simple design leaves for later: a row of m = 64
// walkers keeps only 2 loads in flight per lane, the y gathers of K = 2 are
// 8-byte scattered reads, and K > 16 rereads pos/load per chunk; a version
// that loads pos/load as int4/float4, sorts walkers by position, or caches
// hot rows of y in shared memory is not attempted.
#include <cuda_runtime.h>

namespace {

constexpr int WARPS = 8;
constexpr int NT = 32 * WARPS;
constexpr int CK = 16;

__global__ void __launch_bounds__(NT)
grf_feature_kernel(const int* __restrict__ pos, const float* __restrict__ load,
                   const float* __restrict__ y, float* __restrict__ out, int S,
                   int m, int N, int K, float inv_m) {
  const int lane = threadIdx.x % 32;
  const int s = blockIdx.x * WARPS + threadIdx.x / 32;
  if (s >= S) return;  // whole warps leave together: s is uniform per warp
  const int* prow = pos + (size_t)s * m;
  const float* lrow = load + (size_t)s * m;
  for (int c0 = 0; c0 < K; c0 += CK) {
    float acc[CK];
#pragma unroll
    for (int c = 0; c < CK; ++c) acc[c] = 0.f;
    for (int w = lane; w < m; w += 32) {
      const int p = prow[w];
      if (p < 0 || p >= N) continue;
      const float l = lrow[w];
      const float* yr = y + (size_t)p * K + c0;
#pragma unroll
      for (int c = 0; c < CK; ++c)
        if (c0 + c < K) acc[c] = fmaf(l, yr[c], acc[c]);
    }
#pragma unroll
    for (int c = 0; c < CK; ++c) {
      float v = acc[c];
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        v += __shfl_xor_sync(0xffffffffu, v, off);
      // the butterfly leaves the same bits in every lane; lane c writes
      if (lane == c && c0 + c < K) out[(size_t)s * K + c0 + c] = v * inv_m;
    }
  }
}

}  // namespace

// Launches K5 on `stream` (a cudaStream_t passed as a pointer) and returns
// cudaGetLastError() as an int (0 on success).  pos (S, m) int32, load (S, m)
// float32, y (N, K) float32, out (S, K) float32; all row-major, contiguous,
// on the current device.  Allocates nothing.
extern "C" int grf_feature(const int* pos, const float* load, const float* y,
                           float* out, int S, int m, int N, int K, float inv_m,
                           void* stream) {
  if (S <= 0 || K <= 0) return 0;
  const dim3 grid((S + WARPS - 1) / WARPS);
  grf_feature_kernel<<<grid, NT, 0, static_cast<cudaStream_t>(stream)>>>(
      pos, load, y, out, S, m, N, K, inv_m);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

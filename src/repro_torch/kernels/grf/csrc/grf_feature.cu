// K5: the GRF walker-mean feature product,
//
//   out[s, c] = (1/m) * sum_w load[s, w] * y[pos[s, w], c]
//
// for walker positions pos (S, m) int32, loads (S, m) float32 and values
// y (N, K) float32; out is (S, K) float32.  One call reduces one step's walker
// population to its Monte-Carlo estimate of a row block of P^t @ Y.
//
// Replaces the TPU kernel repro/kernels/grf/grf.py::grf_feature_kernel
// (pl.pallas_call at grf.py:72, body _kernel at :27).  That kernel phrases
// the gather y[pos] as a weighted one-hot matmul over column tiles of y,
// because TPU Pallas does not vectorize a dynamic gather.  On Hopper a
// direct gather is the natural form, so nothing of the selector is carried
// over.
//
// Summation order, fixed by m alone.  A row's walkers go to 32 partial sums:
// partial j takes walkers j, j + 32, j + 64, ... and sums load * y in that
// order with FP32 FMA; the 32 partials then meet in a xor tree (j + (j ^ 16),
// then ^ 8, ^ 4, ^ 2, ^ 1), and the sum is scaled by 1/m.  That order does
// not depend on K or on how the partials sit on lanes, so column c of a
// folded batch of requests has the bits of each request's solo call, and two
// launches give the same bits (no atomics).  The plain version (grf.py)
// repeats it.  A position outside [0, N) adds 0 and is never read.
//
// Design.  A warp owns ROWS consecutive rows (ROWS = 1, 2 or 4, so that a
// lane has about 8 gathers in flight even at m = 64) and a pass of Q x VEC
// columns.  Lane (g, q) = (lane / Q, lane % Q) holds partials g + G i
// (G = 32 / Q, i < Q) of each of its rows, for columns VEC q .. VEC q +
// VEC - 1 of the pass.  Per batch of RB rounds of 32 walkers it first loads
// the pos and load of all its walkers (streaming loads, pos and load are read
// once), then issues all their gathers, as VEC-wide vector loads (float4 at
// K = 16: the Q = 4 lanes of a walker read its 64-byte row as one line), and
// only then the FMAs, in each partial's walker order: the dependent
// pos -> y chains of a lane overlap instead of running one at a time.  The
// tree's levels above G are register adds, those below are xor shuffles
// (lane ^ (Q * offset)).  VEC is 4, 2 or 1, the widest that divides K and
// y's alignment; Q = min(4, K / VEC) rounded up to a power of two.  A K wider
// than Q VEC columns loops over passes and reads a row's pos and load again
// from L1/L2 on each.
//
// Bound on an H100 SXM: bytes.  The kernel must read pos and load (S m 8
// bytes) and write out (S K 4 bytes) at 3.35 TB/s: 0.080 ms at S = 83,679,
// m = 400.  y (N K 4 bytes, 0.67 MB at K = 2, 5.4 MB at K = 16) stays
// resident in the 50 MB L2, so its gathers are not in that bound; they move
// one 32-byte sector per walker and 4 K bytes rounded up to sectors
// (S m ceil(4 K / 32) 32 bytes: 1.07 GB at m = 400, K = 2; 2.14 GB at K = 16)
// between L2 and the SMs, and chip_smoke.py measures the L2's rate for such
// random sectors beside the kernel's.  Measured (PERF.md): 0.69 of the bytes
// bound at m = 400, K = 2; at K = 16 the gathers run at the L2's rate for
// random 64-byte rows and set the time.  Not attempted: sorting walkers by
// position or merging the walkers of a row that share a node (the summation
// order must stay m's), caching hot rows of y in shared memory.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int WARPS = 8;          // warps a block
constexpr int NT = 32 * WARPS;
constexpr int INFLIGHT = 8;       // gathers a lane issues before its FMAs

template <int VEC>
struct Vec;
template <>
struct Vec<1> {
  using T = float;
  static __device__ __forceinline__ float get(T v, int) { return v; }
};
template <>
struct Vec<2> {
  using T = float2;
  static __device__ __forceinline__ float get(T v, int e) {
    return e == 0 ? v.x : v.y;
  }
};
template <>
struct Vec<4> {
  using T = float4;
  static __device__ __forceinline__ float get(T v, int e) {
    return e == 0 ? v.x : e == 1 ? v.y : e == 2 ? v.z : v.w;
  }
};

template <int Q, int VEC, int ROWS>
__global__ void __launch_bounds__(NT)
grf_feature_kernel(const int* __restrict__ pos, const float* __restrict__ load,
                   const float* __restrict__ y, float* __restrict__ out, int S,
                   int m, int N, int K, float inv_m) {
  using V = typename Vec<VEC>::T;
  constexpr int G = 32 / Q;                               // walker groups
  constexpr int RB = INFLIGHT / (ROWS * Q) > 0 ? INFLIGHT / (ROWS * Q) : 1;
  const int lane = threadIdx.x % 32, g = lane / Q, q = lane % Q;
  const int s0 = (blockIdx.x * WARPS + threadIdx.x / 32) * ROWS;
  if (s0 >= S) return;  // whole warps leave together
  for (int c0 = 0; c0 < K; c0 += Q * VEC) {
    const int col = c0 + q * VEC;
    const bool col_ok = col < K;  // K % VEC == 0: a vector is in or out
    float acc[ROWS][Q][VEC];
#pragma unroll
    for (int r = 0; r < ROWS; ++r)
#pragma unroll
      for (int i = 0; i < Q; ++i)
#pragma unroll
        for (int e = 0; e < VEC; ++e) acc[r][i][e] = 0.f;
    for (int w0 = 0; w0 < m; w0 += 32 * RB) {
      int p[ROWS][RB][Q];
      float l[ROWS][RB][Q];
#pragma unroll
      for (int r = 0; r < ROWS; ++r)
#pragma unroll
        for (int b = 0; b < RB; ++b)
#pragma unroll
          for (int i = 0; i < Q; ++i) {
            const int w = w0 + 32 * b + g + G * i;
            const bool ok = s0 + r < S && w < m;
            const size_t at = (size_t)(s0 + r) * m + w;
            p[r][b][i] = ok ? __ldcs(pos + at) : -1;
            l[r][b][i] = ok ? __ldcs(load + at) : 0.f;
          }
      V v[ROWS][RB][Q];
#pragma unroll
      for (int r = 0; r < ROWS; ++r)
#pragma unroll
        for (int b = 0; b < RB; ++b)
#pragma unroll
          for (int i = 0; i < Q; ++i) {
            const int pp = p[r][b][i];
            if (col_ok && pp >= 0 && pp < N) {
              v[r][b][i] = __ldg(reinterpret_cast<const V*>(
                  y + (size_t)pp * K + col));
            } else {  // adds exactly 0: a partial sum is never -0
              v[r][b][i] = V{};
              l[r][b][i] = 0.f;
            }
          }
#pragma unroll
      for (int r = 0; r < ROWS; ++r)
#pragma unroll
        for (int b = 0; b < RB; ++b)
#pragma unroll
          for (int i = 0; i < Q; ++i)
#pragma unroll
            for (int e = 0; e < VEC; ++e)
              acc[r][i][e] = fmaf(l[r][b][i], Vec<VEC>::get(v[r][b][i], e),
                                  acc[r][i][e]);
    }
#pragma unroll
    for (int r = 0; r < ROWS; ++r) {
      // the tree over j = g + G i: offsets >= G pair registers i, smaller
      // ones pair lanes; every level is symmetric, so every lane and
      // register ends with the same bits
#pragma unroll
      for (int off = 16; off >= G; off /= 2)
#pragma unroll
        for (int i = 0; i < Q; ++i)
#pragma unroll
          for (int e = 0; e < VEC; ++e)
            if (i < (i ^ (off / G)))  // each pair once, both keep the sum
              acc[r][i][e] = acc[r][i ^ (off / G)][e] =
                  acc[r][i][e] + acc[r][i ^ (off / G)][e];
#pragma unroll
      for (int off = G / 2; off > 0; off /= 2)
#pragma unroll
        for (int e = 0; e < VEC; ++e)
          acc[r][0][e] +=
              __shfl_xor_sync(0xffffffffu, acc[r][0][e], off * Q);
      if (g == 0 && col_ok && s0 + r < S) {
        float* dst = out + (size_t)(s0 + r) * K + col;
#pragma unroll
        for (int e = 0; e < VEC; ++e) dst[e] = acc[r][0][e] * inv_m;
      }
    }
  }
}

template <int Q, int VEC, int ROWS>
int launch(const int* pos, const float* load, const float* y, float* out,
           int S, int m, int N, int K, float inv_m, cudaStream_t stream) {
  const dim3 grid((S + WARPS * ROWS - 1) / (WARPS * ROWS));
  grf_feature_kernel<Q, VEC, ROWS><<<grid, NT, 0, stream>>>(pos, load, y, out,
                                                            S, m, N, K, inv_m);
  return static_cast<int>(cudaGetLastError());
}

template <int Q, int VEC>
int pick_rows(const int* pos, const float* load, const float* y, float* out,
              int S, int m, int N, int K, float inv_m, cudaStream_t stream) {
  const int per_row = Q * ((m + 31) / 32);  // a lane's gathers in one row
  if (4 * per_row <= INFLIGHT)
    return launch<Q, VEC, 4>(pos, load, y, out, S, m, N, K, inv_m, stream);
  if (2 * per_row <= INFLIGHT)
    return launch<Q, VEC, 2>(pos, load, y, out, S, m, N, K, inv_m, stream);
  return launch<Q, VEC, 1>(pos, load, y, out, S, m, N, K, inv_m, stream);
}

template <int VEC>
int pick_q(const int* pos, const float* load, const float* y, float* out,
           int S, int m, int N, int K, float inv_m, cudaStream_t stream) {
  const int groups = K / VEC;
  if (groups >= 3)
    return pick_rows<4, VEC>(pos, load, y, out, S, m, N, K, inv_m, stream);
  if (groups == 2)
    return pick_rows<2, VEC>(pos, load, y, out, S, m, N, K, inv_m, stream);
  return pick_rows<1, VEC>(pos, load, y, out, S, m, N, K, inv_m, stream);
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
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const uintptr_t at = reinterpret_cast<uintptr_t>(y);
  if (K % 4 == 0 && at % 16 == 0)
    return pick_q<4>(pos, load, y, out, S, m, N, K, inv_m, st);
  if (K % 2 == 0 && at % 8 == 0)
    return pick_q<2>(pos, load, y, out, S, m, N, K, inv_m, st);
  return pick_q<1>(pos, load, y, out, S, m, N, K, inv_m, st);
}

extern "C" const char* cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

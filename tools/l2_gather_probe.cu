// A yardstick for K5 (src/repro_torch/kernels/grf/csrc/grf_feature.cu), not a
// kernel of the port: the rate at which one H100 moves random rows of an
// array that sits in its L2 to the SMs.  K5's gathers read one row of y per
// walker, 8 bytes (K = 2) or 64 bytes (K = 16) at a random node, so they
// move 32-byte sectors between L2 and the SMs; this probe does nothing else.
//
// Rows are 32 bytes (one sector) or 64 bytes (two sectors of one 128-byte
// line).  Adjacent lanes share a row and each loads 16 bytes of it, so one
// warp instruction asks for each of its rows once, as K5's float4 gathers
// at K = 16 do.  Every lane group draws `iters` row indices from a hash of
// its index (no index array is read) and keeps INFLIGHT loads in flight;
// each thread writes one float, so that the loads are not dropped.  With
// l1 = 0 the loads are ld.global.cg, cached in L2 only: the L2's rate; with
// l1 = 1 they are ld.global.nc, as K5's are, so that L1 hits count too.
// chip_smoke.py times it with CUDA events and divides the sectors moved by
// the time.
//
// Built like the port's kernels (src/repro_torch/kernels/_build.py: nvcc
// for sm_90a into a shared library with a plain C interface).
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int INFLIGHT = 8;

__device__ __forceinline__ uint32_t mix(uint32_t x) {
  x ^= x >> 16;
  x *= 0x7feb352dU;
  x ^= x >> 15;
  x *= 0x846ca68bU;
  x ^= x >> 16;
  return x;
}

template <int LANES, bool L1>  // lanes a row (16 bytes each); cache in L1
__global__ void __launch_bounds__(256)
l2_gather_probe_kernel(const float4* __restrict__ y, uint32_t rows,
                       int iters, float* __restrict__ out) {
  const uint32_t tid = blockIdx.x * blockDim.x + threadIdx.x;
  const uint32_t group = tid / LANES, part = tid % LANES;
  float acc = 0.f;
  for (int it = 0; it < iters; it += INFLIGHT) {
    float4 v[INFLIGHT];
#pragma unroll
    for (int u = 0; u < INFLIGHT; ++u) {
      const uint32_t row = __umulhi(mix(group * 0x9E3779B9U + it + u), rows);
      const float4* at = y + (size_t)row * LANES + part;
      v[u] = L1 ? __ldg(at) : __ldcg(at);
    }
#pragma unroll
    for (int u = 0; u < INFLIGHT; ++u) acc += v[u].x + v[u].y + v[u].z + v[u].w;
  }
  out[tid] = acc;
}

template <int LANES>
void run(bool l1, const float4* y, uint32_t rows, int iters, float* out,
         int blocks, cudaStream_t st) {
  if (l1)
    l2_gather_probe_kernel<LANES, true><<<blocks, 256, 0, st>>>(y, rows, iters,
                                                                out);
  else
    l2_gather_probe_kernel<LANES, false><<<blocks, 256, 0, st>>>(y, rows,
                                                                 iters, out);
}

}  // namespace

// Launches the probe on `stream`: blocks x 256 threads gathering `iters` (a
// multiple of 8) random rows each of row_floats (8 or 16) floats from y
// (rows, row_floats), 16-byte aligned, through L2 only (l1 = 0) or L1 and L2
// (l1 = 1); out holds blocks x 256 floats.  Returns cudaGetLastError().
extern "C" int l2_gather_probe(const float* y, int rows, int row_floats,
                               int l1, int iters, float* out, int blocks,
                               void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float4* y4 = reinterpret_cast<const float4*>(y);
  if (row_floats == 8)
    run<2>(l1 != 0, y4, rows, iters, out, blocks, st);
  else if (row_floats == 16)
    run<4>(l1 != 0, y4, rows, iters, out, blocks, st);
  else
    return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

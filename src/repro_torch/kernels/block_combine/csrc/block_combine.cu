// The VDT walk's block combine (Algorithm 1's per-block step and its
// segment sum),
//
//   c_node[n, :] = sum over the blocks k of row n of q[k] * t[b[k], :]
//
// over a CSR of the active blocks sorted by their data node (row n of the
// CSR holds the blocks whose a-node is n, in slot order).  t is CollectUp's
// node sums (n_nodes, K) float32 and c_node (n_nodes, K) float32; every row
// of c_node is written, zeros where a row has no blocks.
//
// Replaces no Pallas kernel.  The reference runs this step as XLA ops
// (`take`, a product, `segment_sum` with the `sorted_blocks` hint) over all
// the partition's capacity slots; torch's counterpart, `index_select` then
// `index_add_`, gathers, scales and atomically adds every slot, inactive ones
// and capacity padding included (2.5 x the active blocks at the fit's
// capacity), and the atomics add in another order on every call.  Here the
// walk reads only the active blocks, sorted once per fitted tree, and each
// output row is summed in registers in a fixed order: two launches give the
// same bits, so a walk resumed from a carry equals the monolithic walk.
//
// Bound on an H100 SXM: bytes.  The combine must read each active block's
// row of t (4 K bytes) and its b and q (8 bytes), and write c_node (n_nodes
// 4 K bytes), at 3.35 TB/s; rows of t are read where blocks point, so
// shallow nodes, which many blocks share, come from L2 after the first read.
//
// Design.  The CSR's rows are cut into work items of at most CHUNK blocks
// (the builder's `CHUNK`, ops.py); an empty row is one item of no blocks.
// One warp sums one item over a tile of W x NV x VEC columns (blockIdx.y
// picks the tile): lane (g, c) = (lane / W, lane % W) holds NV vectors of
// VEC floats, columns VEC (n W + c) of the tile for n < NV, and takes the
// item's blocks g, g + S, g + 2 S, ... (S = 32 / W lane groups).  Per round a
// lane first loads U = 8 / NV blocks' b and q, then issues all U x NV vector
// loads of t, then the FMAs in block order, so about 8 gathers are in flight
// a lane (K5's figure).  The S group sums meet in a xor-shuffle tree (offsets
// 16, 8, ..., W), symmetric, so every lane ends with the same bits.  VEC is
// 4, 2 or 1, the widest that divides K and the operands' alignment; W is
// 32 when a row has 32 vectors or more (NV = 2 from 64: K = 256 in float4),
// else the vectors of a row rounded up to a power of two, so that small K
// splits a warp over a row's blocks.  An item that is a whole row writes its
// c_node row; the items of a longer row write partial rows, which a second,
// small pass adds in a fixed order (finish_kernel).  The summation order thus
// depends on the CSR and on K alone, never on timing.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int WARPS = 8;          // warps a block (one item each)
constexpr int NT = 32 * WARPS;
constexpr int INFLIGHT = 8;       // t vectors a lane loads before its FMAs

template <int VEC>
struct Vec;
template <>
struct Vec<1> {
  using T = float;
  static __device__ __forceinline__ float get(T v, int) { return v; }
  static __device__ __forceinline__ void set(T& v, int, float x) { v = x; }
};
template <>
struct Vec<2> {
  using T = float2;
  static __device__ __forceinline__ float get(T v, int e) {
    return e == 0 ? v.x : v.y;
  }
  static __device__ __forceinline__ void set(T& v, int e, float x) {
    (e == 0 ? v.x : v.y) = x;
  }
};
template <>
struct Vec<4> {
  using T = float4;
  static __device__ __forceinline__ float get(T v, int e) {
    return e == 0 ? v.x : e == 1 ? v.y : e == 2 ? v.z : v.w;
  }
  static __device__ __forceinline__ void set(T& v, int e, float x) {
    (e == 0 ? v.x : e == 1 ? v.y : e == 2 ? v.z : v.w) = x;
  }
};

template <int VEC, int NV>
__global__ void __launch_bounds__(NT)
combine_kernel(const int* __restrict__ item_ptr,
               const int* __restrict__ item_row,
               const int* __restrict__ item_part, const int* __restrict__ b,
               const float* __restrict__ q, const float* __restrict__ t,
               float* __restrict__ out, float* __restrict__ part,
               int n_items, int K, int W) {
  using V = typename Vec<VEC>::T;
  constexpr int U = INFLIGHT / NV;  // blocks a lane takes a round
  const int item = blockIdx.x * WARPS + threadIdx.x / 32;
  if (item >= n_items) return;  // whole warps leave together
  const int lane = threadIdx.x % 32, g = lane / W, c = lane % W;
  const int S = 32 / W;
  const int c0 = blockIdx.y * W * NV * VEC;
  const int begin = __ldg(item_ptr + item), end = __ldg(item_ptr + item + 1);
  const int p = __ldg(item_part + item), row = __ldg(item_row + item);
  float acc[NV][VEC];
#pragma unroll
  for (int n = 0; n < NV; ++n)
#pragma unroll
    for (int e = 0; e < VEC; ++e) acc[n][e] = 0.f;
  for (int j0 = begin + g; j0 < end; j0 += S * U) {
    int bb[U];
    float qq[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int j = j0 + u * S;
      const bool ok = j < end;
      bb[u] = ok ? __ldg(b + j) : -1;
      qq[u] = ok ? __ldg(q + j) : 0.f;
    }
    V v[U][NV];
#pragma unroll
    for (int u = 0; u < U; ++u)
#pragma unroll
      for (int n = 0; n < NV; ++n) {
        const int col = c0 + (n * W + c) * VEC;
        if (bb[u] >= 0 && col < K) {  // K % VEC == 0: a vector is in or out
          v[u][n] = __ldg(reinterpret_cast<const V*>(
              t + (size_t)bb[u] * K + col));
        } else {  // adds exactly 0 (qq is 0 past the item's end)
          v[u][n] = V{};
        }
      }
#pragma unroll
    for (int u = 0; u < U; ++u)
#pragma unroll
      for (int n = 0; n < NV; ++n)
#pragma unroll
        for (int e = 0; e < VEC; ++e)
          acc[n][e] = fmaf(qq[u], Vec<VEC>::get(v[u][n], e), acc[n][e]);
  }
  for (int off = 16; off >= W; off /= 2)
#pragma unroll
    for (int n = 0; n < NV; ++n)
#pragma unroll
      for (int e = 0; e < VEC; ++e)
        acc[n][e] += __shfl_xor_sync(0xffffffffu, acc[n][e], off);
  if (g != 0) return;
  float* dst = p < 0 ? out + (size_t)row * K : part + (size_t)p * K;
#pragma unroll
  for (int n = 0; n < NV; ++n) {
    const int col = c0 + (n * W + c) * VEC;
    if (col < K) {
      V w;
#pragma unroll
      for (int e = 0; e < VEC; ++e) Vec<VEC>::set(w, e, acc[n][e]);
      *reinterpret_cast<V*>(dst + col) = w;
    }
  }
}

// Row fin_row[r] of c_node from partial rows fin_ptr[r] .. fin_ptr[r + 1] - 1,
// 32 columns a block: warp w adds partials w, w + WARPS, ... in order, then
// warp 0 adds the WARPS warp sums in warp order.  A row of many chunks (a
// shallow node can hold 20,000 blocks, 600 chunks) takes 1 / WARPS of the
// sequential adds one thread a column would.
__global__ void __launch_bounds__(NT)
finish_kernel(const int* __restrict__ fin_row, const int* __restrict__ fin_ptr,
              const float* __restrict__ part, float* __restrict__ out, int K) {
  __shared__ float sums[WARPS][32];
  const int r = blockIdx.x, w = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int col = blockIdx.y * 32 + lane;
  const int p0 = __ldg(fin_ptr + r), p1 = __ldg(fin_ptr + r + 1);
  float s = 0.f;
  if (col < K)
    for (int p = p0 + w; p < p1; p += WARPS) s += part[(size_t)p * K + col];
  sums[w][lane] = s;
  __syncthreads();
  if (w != 0 || col >= K) return;
  float total = 0.f;
#pragma unroll
  for (int i = 0; i < WARPS; ++i) total += sums[i][lane];
  out[(size_t)__ldg(fin_row + r) * K + col] = total;
}

template <int VEC, int NV>
void launch(const int* item_ptr, const int* item_row, const int* item_part,
            const int* b, const float* q, const float* t, float* out,
            float* part, int n_items, int K, int W, cudaStream_t stream) {
  const int tile = W * NV * VEC;
  const dim3 grid((n_items + WARPS - 1) / WARPS, (K + tile - 1) / tile);
  combine_kernel<VEC, NV><<<grid, NT, 0, stream>>>(
      item_ptr, item_row, item_part, b, q, t, out, part, n_items, K, W);
}

template <int VEC>
void pick(const int* item_ptr, const int* item_row, const int* item_part,
          const int* b, const float* q, const float* t, float* out,
          float* part, int n_items, int K, cudaStream_t stream) {
  const int vecs = K / VEC;  // vectors a row
  if (vecs >= 64) {
    launch<VEC, 2>(item_ptr, item_row, item_part, b, q, t, out, part, n_items,
                   K, 32, stream);
    return;
  }
  int W = 1;
  while (W < vecs && W < 32) W *= 2;
  launch<VEC, 1>(item_ptr, item_row, item_part, b, q, t, out, part, n_items,
                 K, W, stream);
}

}  // namespace

// Launches the combine on `stream` (a cudaStream_t passed as a pointer) and
// returns cudaGetLastError() as an int (0 on success).  The CSR's work items:
// item_ptr (n_items + 1) block offsets, item_row and item_part (n_items; the
// partial row an item writes, or -1 for its c_node row), the rows finished
// from partials: fin_row (n_fin), fin_ptr (n_fin + 1); blocks b int32 and q
// float32; t (n_nodes, K) float32; out (n_nodes, K) float32, part
// (n_partials, K) float32 scratch.  All contiguous, on the current device.
// Allocates nothing.
extern "C" int block_combine(const int* item_ptr, const int* item_row,
                             const int* item_part, const int* fin_row,
                             const int* fin_ptr, const int* b, const float* q,
                             const float* t, float* out, float* part,
                             int n_items, int n_fin, int K, void* stream) {
  if (n_items <= 0 || K <= 0) return 0;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const uintptr_t at = reinterpret_cast<uintptr_t>(t) |
                       reinterpret_cast<uintptr_t>(out) |
                       reinterpret_cast<uintptr_t>(part);
  if (K % 4 == 0 && at % 16 == 0)
    pick<4>(item_ptr, item_row, item_part, b, q, t, out, part, n_items, K, st);
  else if (K % 2 == 0 && at % 8 == 0)
    pick<2>(item_ptr, item_row, item_part, b, q, t, out, part, n_items, K, st);
  else
    pick<1>(item_ptr, item_row, item_part, b, q, t, out, part, n_items, K, st);
  int err = static_cast<int>(cudaGetLastError());
  if (err != 0 || n_fin <= 0) return err;
  finish_kernel<<<dim3(n_fin, (K + 31) / 32), NT, 0, st>>>(fin_row, fin_ptr,
                                                          part, out, K);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

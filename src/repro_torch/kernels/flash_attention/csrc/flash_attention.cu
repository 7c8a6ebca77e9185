// K6: causal / sliding-window grouped-query attention with an online softmax,
//
//   out[b, h, i, :] = sum_j softmax_j(mask(q_i . k_j * D^-1/2)) v[b, h / G, j, :]
//
// for q (B, Hq, S, D) and k, v (B, Hkv, S, D), G = Hq / Hkv, in float32 or
// bfloat16; out is (B, Hq, S, D) in the input type.  Products, exponentials
// and sums are float32 (bfloat16 is upcast on load, the output rounded to
// nearest once at the end).  A key j is masked for query i when j >= S, when
// causal and j > i, or when window > 0 and i - j >= window; a masked logit is
// -1e30.  Per key tile: m' = max(m, rowmax), alpha = exp(m - m'),
// p = exp(logit - m'), s = s * alpha + sum p, acc = acc * alpha + p v; the
// output is acc / max(s, 1e-38).
//
// Replaces the TPU kernel repro/kernels/flash_attention/flash_attention.py::
// flash_attention_kernel (pl.pallas_call at flash_attention.py:98, body
// _kernel at :28).  There the key/value tiles are the innermost, sequential
// grid axis and (m, s, acc) ride in VMEM scratch from one grid step to the
// next.  Hopper's blocks run in no order, so here one block owns a tile of
// BQ = 64 query rows of one (b, h) and walks the key/value tiles in a loop,
// writing its output once.  There are no atomics: a launch is bitwise
// reproducible.  Unlike the TPU kernel, keys at or past S are masked (its
// zero padding joins the softmax when causal is false and S is ragged); this
// is the rule of the reference's ref.py.
//
// Skipped tiles.  A block walks only the key tiles that hold an unmasked key
// for some row of its query tile: up to the diagonal when causal, from
// q0 - window + 1 with a window.  This gives the same bits as walking every
// tile.  For a row, a wholly masked tile after one with an unmasked key
// leaves m unchanged, so alpha = 1 and every p = exp(-1e30 - m) = 0; one
// before it leaves m = -1e30, and the first unmasked logit then gives
// alpha = exp(-1e30 - m') = 0, which wipes what it added.  A causal row
// always sees its own diagonal key, so no row of a written output is all
// masked.
//
// Design.  256 threads as a 16 x 16 grid; thread (ty, tx) owns query rows
// 4 ty .. 4 ty + 3, key columns tx * BK/16 .. of each tile, and output
// columns tx * D/16 .. .  The query tile (pre-scaled) and each key tile sit in
// shared memory in float32, transposed so that a thread's 4 rows or 4 keys
// at one depth are one 16-byte load; V and the tile's probabilities likewise
// (row-major V, transposed P).  Both products are register-blocked FP32 FMA
// on the CUDA cores.  The row max and row sum meet across the 16 threads of a
// row with a xor-shuffle butterfly inside a half warp, which leaves the same
// bits in all 16.  Shared memory: (D (BQ + 4) + D (BK + 4) + BK D + BK (BQ + 4))
// floats = 69 KB at D = 64, 120 KB at D = 128 and, with BK = 32, 148 KB at
// D = 256, so each instantiation opts in to dynamic shared memory above
// 48 KB.  Query tiles are issued last-first, so the long causal rows start
// early.
//
// Bound on an H100 SXM: operations.  At the LM path's shape (B = 4, Hq = 15,
// Hkv = 5, S = 2048, D = 64, causal) the two products over the unmasked half
// are 2 B Hq S^2 D = 32.2 GFLOP against 42 MB of q, k, v and out, so the card's
// bf16 tensor-core peak (989 TFLOP/s) sets the bound, 0.033 ms.  This kernel
// runs on the FP32 CUDA cores (67 TFLOP/s peak) and its inner loops issue one
// 16-byte shared load for every 8 FMAs, so it cannot come within an order of
// magnitude of that bound.  What is not attempted: mma.sync / wgmma on bf16
// tiles, TMA loads of K/V into a multi-stage ring, and a triangular schedule
// that splits the diagonal tile.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int BQ = 64;       // query rows per block
constexpr int NT = 256;      // threads per block, 16 x 16
constexpr int PAD = 4;       // floats of padding on transposed tiles
constexpr float NEG_BIG = -1e30f;

template <int D>
__host__ __device__ constexpr int kv_tile() { return D >= 256 ? 32 : 64; }

template <int D>
__host__ __device__ constexpr int smem_floats() {
  return D * (BQ + PAD) + D * (kv_tile<D>() + PAD) + kv_tile<D>() * D +
         kv_tile<D>() * (BQ + PAD);
}

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void put(float* p, float x) { *p = x; }
__device__ __forceinline__ void put(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16_rn(x);
}

// N consecutive floats from shared memory, 16 (or 8) bytes at a time
template <int N>
__device__ __forceinline__ void lds(float (&dst)[N], const float* src) {
  if constexpr (N % 4 == 0) {
#pragma unroll
    for (int i = 0; i < N; i += 4) {
      const float4 t = *reinterpret_cast<const float4*>(src + i);
      dst[i] = t.x; dst[i + 1] = t.y; dst[i + 2] = t.z; dst[i + 3] = t.w;
    }
  } else {
    static_assert(N == 2, "lds takes 2 or a multiple of 4 floats");
    const float2 t = *reinterpret_cast<const float2*>(src);
    dst[0] = t.x; dst[1] = t.y;
  }
}

template <int D, typename T>
__global__ void __launch_bounds__(NT)
flash_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                       const T* __restrict__ v, T* __restrict__ out, int Hq,
                       int Hkv, int S, int causal, int window, float scale) {
  constexpr int BK = kv_tile<D>();
  constexpr int RQ = BQ / 16;   // query rows per thread
  constexpr int CK = BK / 16;   // keys per thread per tile
  constexpr int CD = D / 16;    // output columns per thread
  constexpr int QS = BQ + PAD;  // row stride of the transposed q and p tiles
  constexpr int KS = BK + PAD;  // row stride of the transposed k tile
  extern __shared__ __align__(16) float smem[];
  float* Qt = smem;             // [D][QS]  q^T, pre-scaled
  float* Kt = Qt + D * QS;      // [D][KS]  k^T
  float* Vs = Kt + D * KS;      // [BK][D]
  float* Pt = Vs + BK * D;      // [BK][QS] p^T

  const int tid = threadIdx.x;
  const int tx = tid % 16, ty = tid / 16;
  const int q0 = (gridDim.x - 1 - blockIdx.x) * BQ;
  const int h = blockIdx.y, b = blockIdx.z;
  const int hk = h / (Hq / Hkv);
  const T* qb = q + (size_t)(b * Hq + h) * S * D;
  const T* kb = k + (size_t)(b * Hkv + hk) * S * D;
  const T* vb = v + (size_t)(b * Hkv + hk) * S * D;

  for (int i = tid; i < BQ * D; i += NT) {
    const int r = i / D, c = i % D;
    Qt[c * QS + r] = q0 + r < S ? to_f32(qb[(size_t)(q0 + r) * D + c]) * scale
                                : 0.f;
  }

  float m[RQ], l[RQ], acc[RQ][CD];
#pragma unroll
  for (int i = 0; i < RQ; ++i) {
    m[i] = NEG_BIG;
    l[i] = 0.f;
#pragma unroll
    for (int j = 0; j < CD; ++j) acc[i][j] = 0.f;
  }

  // key tiles with an unmasked key for some row of [q0, q0 + BQ)
  const int k_end = causal ? min(S, q0 + BQ) : S;
  const int k_first = window > 0 ? max(0, q0 - window + 1) : 0;
  for (int k0 = k_first / BK * BK; k0 < k_end; k0 += BK) {
    __syncthreads();  // the previous tile's Kt, Vs and Pt are read
    for (int i = tid; i < BK * D; i += NT) {
      const int r = i / D, c = i % D;
      const bool in = k0 + r < S;
      Kt[c * KS + r] = in ? to_f32(kb[(size_t)(k0 + r) * D + c]) : 0.f;
      Vs[i] = in ? to_f32(vb[(size_t)(k0 + r) * D + c]) : 0.f;
    }
    __syncthreads();

    float sc[RQ][CK];
#pragma unroll
    for (int i = 0; i < RQ; ++i)
#pragma unroll
      for (int j = 0; j < CK; ++j) sc[i][j] = 0.f;
#pragma unroll 8
    for (int d = 0; d < D; ++d) {
      float qv[RQ], kv[CK];
      lds(qv, Qt + d * QS + ty * RQ);
      lds(kv, Kt + d * KS + tx * CK);
#pragma unroll
      for (int i = 0; i < RQ; ++i)
#pragma unroll
        for (int j = 0; j < CK; ++j) sc[i][j] = fmaf(qv[i], kv[j], sc[i][j]);
    }

#pragma unroll
    for (int i = 0; i < RQ; ++i) {
      const int qi = q0 + ty * RQ + i;
      float rmax = NEG_BIG;  // every logit is >= NEG_BIG once masked
#pragma unroll
      for (int j = 0; j < CK; ++j) {
        const int kj = k0 + tx * CK + j;
        const bool ok = kj < S && (!causal || kj <= qi) &&
                        (window <= 0 || qi - kj < window);
        sc[i][j] = ok ? sc[i][j] : NEG_BIG;
        rmax = fmaxf(rmax, sc[i][j]);
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        rmax = fmaxf(rmax, __shfl_xor_sync(0xffffffffu, rmax, off));
      const float m_new = fmaxf(m[i], rmax);
      const float alpha = expf(m[i] - m_new);
      float psum = 0.f;
#pragma unroll
      for (int j = 0; j < CK; ++j) {
        const float p = expf(sc[i][j] - m_new);
        psum += p;
        Pt[(tx * CK + j) * QS + ty * RQ + i] = p;
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        psum += __shfl_xor_sync(0xffffffffu, psum, off);
      l[i] = l[i] * alpha + psum;
      m[i] = m_new;
#pragma unroll
      for (int j = 0; j < CD; ++j) acc[i][j] *= alpha;
    }
    __syncthreads();

#pragma unroll 4
    for (int c = 0; c < BK; ++c) {
      float pv[RQ], vv[CD];
      lds(pv, Pt + c * QS + ty * RQ);
      lds(vv, Vs + c * D + tx * CD);
#pragma unroll
      for (int i = 0; i < RQ; ++i)
#pragma unroll
        for (int j = 0; j < CD; ++j) acc[i][j] = fmaf(pv[i], vv[j], acc[i][j]);
    }
  }

#pragma unroll
  for (int i = 0; i < RQ; ++i) {
    const int qi = q0 + ty * RQ + i;
    if (qi >= S) continue;
    const float den = fmaxf(l[i], 1e-38f);
    T* o = out + ((size_t)(b * Hq + h) * S + qi) * D + tx * CD;
#pragma unroll
    for (int j = 0; j < CD; ++j) put(o + j, acc[i][j] / den);
  }
}

template <int D, typename T>
int run(const void* q, const void* k, const void* v, void* out, int B, int Hq,
        int Hkv, int S, int causal, int window, float scale,
        cudaStream_t stream) {
  constexpr int bytes = smem_floats<D>() * sizeof(float);
  auto kern = flash_attention_kernel<D, T>;
  static const cudaError_t opted = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (opted != cudaSuccess) return static_cast<int>(opted);
  const dim3 grid((S + BQ - 1) / BQ, Hq, B);
  kern<<<grid, NT, bytes, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(out), Hq, Hkv, S, causal,
      window, scale);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int dispatch(const void* q, const void* k, const void* v, void* out, int B,
             int Hq, int Hkv, int S, int D, int causal, int window,
             float scale, cudaStream_t stream) {
  switch (D) {
    case 64:
      return run<64, T>(q, k, v, out, B, Hq, Hkv, S, causal, window, scale,
                        stream);
    case 128:
      return run<128, T>(q, k, v, out, B, Hq, Hkv, S, causal, window, scale,
                         stream);
    case 256:
      return run<256, T>(q, k, v, out, B, Hq, Hkv, S, causal, window, scale,
                         stream);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// Launches K6 on `stream` (a cudaStream_t passed as a pointer) and returns
// cudaGetLastError() as an int (0 on success).  q (B, Hq, S, D), k and v
// (B, Hkv, S, D), out (B, Hq, S, D): row-major, contiguous, on the current
// device, float32 (is_bf16 = 0) or bfloat16 (is_bf16 = 1) alike.  D is 64,
// 128 or 256; Hq is a multiple of Hkv; window 0 means none.  scale is
// D^-1/2.  Allocates nothing.
extern "C" int flash_attention(const void* q, const void* k, const void* v,
                               void* out, int B, int Hq, int Hkv, int S, int D,
                               int causal, int window, int is_bf16,
                               float scale, void* stream) {
  if (B <= 0 || S <= 0) return 0;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  return is_bf16 ? dispatch<__nv_bfloat16>(q, k, v, out, B, Hq, Hkv, S, D,
                                           causal, window, scale, st)
                 : dispatch<float>(q, k, v, out, B, Hq, Hkv, S, D, causal,
                                   window, scale, st);
}

extern "C" const char* cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// K4: pairwise squared distances, D2[i, j] = max(|x_i|^2 + |y_j|^2 -
// 2 x_i.y_j, 0), for x (M, d) and y (N, d) in float32 or bfloat16; the output
// is float32 (M, N).
//
// Replaces the TPU kernel repro/kernels/pairwise/pairwise.py::
// pairwise_sq_dists_kernel (pl.pallas_call at pairwise.py:50, body _kernel),
// which upcasts its tiles to float32 and computes the cross term on the MXU.
//
// Design: the cross term x.y^T on Hopper's tensor cores as 3xTF32 (see
// ../../csrc/tf32x3.cuh for the split and why it keeps float32 accuracy).
// Each entry point first runs the split pass over x and over y (hi, lo and
// |.|^2 into scratch the wrapper allocates), then one persistent kernel: a
// block per SM walks output tiles of 128 x 128 (row tiles fastest, so the
// blocks in flight share column tiles in L2), its producer warp streaming
// 32-wide chunks of d into a 3-stage TMA ring across tile boundaries, so the
// next tile's loads overlap this tile's epilogue.  Two consumer warpgroups
// each hold a 64 x 128 float32 master accumulator in registers; the epilogue
// writes max(|x|^2 + |y|^2 - 2 acc, 0) from those registers (N is odd at the
// kNN shape, so the stores are scalar, four threads of a quad covering 32
// contiguous bytes of a row).  A bfloat16 operand is exact in TF32, so its
// lo is zero: that route skips the two low products and their loads (TERMS =
// 1) rather than feeding bfloat16 wgmma.  Ragged M, N and d: TMA zero-fills
// rows past M or N, the split pass zeroes the pad columns, and the epilogue
// writes only rows < M and columns < N.
//
// Bounds on an H100 SXM at the kNN block shape (M = 2,048, N = 83,679,
// d = 315): the float32 CUDA-core bound is 2 M N d FLOP at 67 TFLOP/s,
// 1.611 ms; this route's is 3 x 2 M N d at the 495 TFLOP/s TF32 rate,
// 0.654 ms; writing the 685 MB output at 3.35 TB/s takes 0.205 ms.  Every
// tile reads 655 KB of hi and lo from L2 for 31.5 MFLOP, so at the TF32
// rate the ring would need about 10 TB/s from L2: L2 bandwidth, not the
// tensor cores, is the expected limit.
#include "tf32x3.cuh"

namespace {

using namespace tf32x3;

template <int TERMS>
__host__ __device__ constexpr int smem_bytes() {  // alignment slack, ring, barriers
  return 1024 + NS * stage_bytes<TERMS>() + 2 * NS * 8;
}

template <int TERMS>
__global__ void __launch_bounds__(NT, 1)
pairwise_kernel(const __grid_constant__ CUtensorMap ahi,
                const __grid_constant__ CUtensorMap alo,
                const __grid_constant__ CUtensorMap bhi,
                const __grid_constant__ CUtensorMap blo,
                const float* __restrict__ xn, const float* __restrict__ yn,
                float* __restrict__ out, int M, int N, int n_chunks) {
  constexpr int STAGE = stage_bytes<TERMS>();
  extern __shared__ uint8_t smem_raw[];
  const uint32_t ring = (sm90::smem_addr(smem_raw) + 1023u) & ~1023u;
  const uint32_t full = ring + NS * STAGE;  // NS mbarriers, then NS "empty"
  const uint32_t empty = full + 8 * NS;
  const int tid = threadIdx.x;
  const int n_tm = (M + BM - 1) / BM;
  const int n_tiles = n_tm * ((N + BN - 1) / BN);

  if (tid == 0) {
    for (int s = 0; s < NS; ++s) {
      sm90::mbar_init(full + 8 * s, 1);
      sm90::mbar_init(empty + 8 * s, NCONS);
    }
    sm90::mbar_init_fence();
  }
  __syncthreads();

  if (tid >= NCONS) {  // the producer warp: lane 0 issues every load
    if (tid == NCONS) {
      int it = 0;
      for (int tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
        for (int c = 0; c < n_chunks; ++c, ++it) {
          const int s = it % NS;
          if (it >= NS) sm90::mbar_wait(empty + 8 * s, (it / NS - 1) & 1);
          produce<TERMS>(ring + s * STAGE, full + 8 * s, &ahi, &alo, &bhi,
                         &blo, tile % n_tm * BM, tile / n_tm * BN, c * DC);
        }
      }
    }
    return;
  }

  const int wg = tid / 128, t = tid % 128;
  int it = 0;
  for (int tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
    float dot[64];  // this thread's share of the tile's x.y^T
#pragma unroll
    for (int i = 0; i < 64; ++i) dot[i] = 0.f;
    for (int c = 0; c < n_chunks; ++c, ++it) {
      const int s = it % NS;
      sm90::mbar_wait(full + 8 * s, (it / NS) & 1);
      consume<TERMS>(dot, ring + s * STAGE, wg);
      sm90::mbar_arrive(empty + 8 * s);
    }
    // rows ra and rb = ra + 8, columns c0 + frag_col(t, i)
    const int r0 = tile % n_tm * BM, c0 = tile / n_tm * BN;
    const int ra = r0 + wg * 64 + frag_row(t, 0), rb = ra + 8;
    const float xa = ra < M ? xn[ra] : 0.f, xb = rb < M ? xn[rb] : 0.f;
    float* oa = out + (size_t)ra * N;
    float* ob = out + (size_t)rb * N;
#pragma unroll
    for (int i = 0; i < 64; i += 4) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int col = c0 + frag_col(t, i + e);
        if (col >= N) continue;
        const float yc = yn[col];
        // 2 dot is exact, so each is (|x|^2 + |y|^2) - 2 dot rounded once
        const float v0 = fmaxf(fmaf(-2.f, dot[i + e], xa + yc), 0.f);
        const float v1 = fmaxf(fmaf(-2.f, dot[i + 2 + e], xb + yc), 0.f);
        if (ra < M) oa[col] = v0;
        if (rb < M) ob[col] = v1;
      }
    }
  }
}

template <typename T, int TERMS>
int run(const void* x, const void* y, float* xhi, float* xlo, float* xn,
        float* yhi, float* ylo, float* yn, float* out, int M, int N, int d,
        int d_pad, int* products, void* stream) {
  *products = TERMS;
  if (M <= 0 || N <= 0) return 0;
  if (d_pad != padded_width(d)) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  constexpr int bytes = smem_bytes<TERMS>();
  auto kern = pairwise_kernel<TERMS>;
  static const cudaError_t opted = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (opted != cudaSuccess) return static_cast<int>(opted);
  if (TERMS == 1) xlo = ylo = nullptr;
  int err = split(static_cast<const T*>(x), xhi, xlo, xn, M, d, d_pad, st);
  if (err == 0)
    err = split(static_cast<const T*>(y), yhi, ylo, yn, N, d, d_pad, st);
  CUtensorMap ahi, alo, bhi, blo;
  if (err == 0) err = encode(&ahi, xhi, M, d_pad);
  if (err == 0) err = encode(&alo, TERMS == 3 ? xlo : xhi, M, d_pad);
  if (err == 0) err = encode(&bhi, yhi, N, d_pad);
  if (err == 0) err = encode(&blo, TERMS == 3 ? ylo : yhi, N, d_pad);
  if (err != 0) return err;
  const int n_tiles = ((M + BM - 1) / BM) * ((N + BN - 1) / BN);
  const int sms = sm_count();
  const int grid = sms > 0 && sms < n_tiles ? sms : n_tiles;
  kern<<<grid, NT, bytes, st>>>(ahi, alo, bhi, blo, xn, yn, out, M, N,
                                d_pad / DC);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Each entry point runs the split pass over x and y, then K4, on `stream` (a
// cudaStream_t passed as a pointer), and returns 0 on success, a cudaError_t,
// or a negative tensor-map error (see cuda_error_string).  x (M, d) and y
// (N, d) row-major and contiguous in the entry point's type; out (M, N)
// float32.  Scratch, float32 and allocated by the caller: xhi, xlo (M,
// d_pad), xn (M,), yhi, ylo (N, d_pad), yn (N,), d_pad = round_up(d, 32)
// (32 when d = 0), 16-byte aligned.  The bfloat16 entry point writes and
// reads no lo (xlo and ylo may be null).  Allocates nothing.  *products
// receives the number of TF32 products a k step of the launched kernel takes
// (TERMS: 3, or 1 for bfloat16), which the wrapper counts as the route.
extern "C" int pairwise_sq_dists_f32(const void* x, const void* y, float* xhi,
                                     float* xlo, float* xn, float* yhi,
                                     float* ylo, float* yn, float* out, int M,
                                     int N, int d, int d_pad, int* products,
                                     void* stream) {
  return run<float, 3>(x, y, xhi, xlo, xn, yhi, ylo, yn, out, M, N, d, d_pad,
                       products, stream);
}

extern "C" int pairwise_sq_dists_bf16(const void* x, const void* y, float* xhi,
                                      float* xlo, float* xn, float* yhi,
                                      float* ylo, float* yn, float* out, int M,
                                      int N, int d, int d_pad, int* products,
                                      void* stream) {
  return run<__nv_bfloat16, 1>(x, y, xhi, xlo, xn, yhi, ylo, yn, out, M, N, d,
                               d_pad, products, stream);
}

extern "C" const char* cuda_error_string(int code) {
  return sm90::error_string(code);
}

// Per-example squared Frobenius norm of a unit-stride conv layer's weight gradient,
// "cat-dot" form: every kernel offset's [C, K] block from ONE product per example.
//
// Replaces data_diet_distributed_tpu/ops/pallas_kernels.py:
//   _conv_norm_catdot_kernel (:156), reached through conv_grad_norm_sq_pallas (:327)
//   with catdot=True.
//
// With Wp = Wo + kw - 1 columns of (virtually) padded input and S' = Ho * Wp positions,
//   A[(r, w), (oy, c)] = x[b, r + oy - pt, w - pl, c]     (kh row-shifted windows of x),
//   G[(r, w), (ox, k)] = g[b, r, w - ox, k]               (kw column-shifted copies of g,
//                                                          zero outside 0 <= w - ox < Wo),
// and (A^T G)[(oy, c), (ox, k)] = sum_{r, q} x[r + oy - pt, q + ox - pl, c] g[r, q, k] is
// exactly offset (oy, ox)'s block M_o of the per-example weight gradient, so
//   out[b] = || A^T G ||_F^2   (the bias term is the caller's, as on the TPU).
// The work over the direct form is the Wp / Wo padding of the contraction (~12 % at
// ResNet-18's 16 x 16 maps).
//
// Design. A and G are never built: both are index arithmetic in the loads, zero outside
// the input (virtual padding, no copies in device memory). One block owns one 64 x 64
// tile of the [kh*C, kw*K] product for one example, streams 32-position chunks of S'
// through 16 KB of shared memory, accumulates in fp32 registers (conv_norm_common.cuh)
// and writes its tile's sum of squares to a [B, P] partials buffer; the shared finalize
// pass sums each example's row in a fixed order. No float atomics: bit-identical from
// run to run and independent of the example's place in the batch.
//
// Bound on the card: operations, those of the function (2 * Ho*Wo * kh*kw * C*K FLOPs per
// example, the same as the direct form; the Wp - Wo zero columns of G are this design's
// own cost) against (H*W*C + Ho*Wo*K) elements read. On the TPU one wide dot filled the 128 x 128 MXU
// where the per-offset dots did not; on Hopper the same tiles run on the fp32 CUDA cores
// as in the direct kernel, so the gain the TPU measured does not carry over as such.
// Left for later: bf16 tensor-core tiles (wgmma), where the wide product is the shape
// that feeds them well.

#include "conv_norm_common.cuh"

namespace {

struct CatGeo {
  int B, H, W, C, Ho, Wo, K;
  int kh, kw, pt, pl;
  int Wp, qtiles, P;  // padded width, column tiles of the [kh*C, kw*K] product, tiles
};

// grid: (B, P); tile t = blockIdx.y covers rows [64 * (t / qtiles), +64) of kh*C and
// columns [64 * (t % qtiles), +64) of kw*K.
template <typename T>
__global__ void __launch_bounds__(kThreads)
catdot_kernel(const T* __restrict__ x, const T* __restrict__ gt,
              float* __restrict__ partials, CatGeo g) {
  __shared__ __align__(16) float as[kChunk * kTile];
  __shared__ __align__(16) float gs[kChunk * kTile];
  __shared__ float red[kThreads / 32];

  const int b = blockIdx.x;
  const int r0 = (blockIdx.y / g.qtiles) * kTile, q0 = (blockIdx.y % g.qtiles) * kTile;
  const int ta = threadIdx.x % 16, tb = threadIdx.x / 16;
  const int Sp = g.Ho * g.Wp, rows = g.kh * g.C, cols = g.kw * g.K;
  const T* xb = x + (size_t)b * g.H * g.W * g.C;
  const T* gb = gt + (size_t)b * g.Ho * g.Wo * g.K;

  float acc[4][4] = {};
  for (int s0 = 0; s0 < Sp; s0 += kChunk) {
    __syncthreads();  // previous chunk consumed
    for (int i = threadIdx.x; i < kChunk * kTile; i += kThreads) {
      const int s = s0 + i / kTile, j = i % kTile;
      const int r = s / g.Wp, w = s % g.Wp;
      float va = 0.f, vg = 0.f;
      if (s < Sp) {
        const int row = r0 + j;
        if (row < rows) {
          const int iy = r + row / g.C - g.pt, ix = w - g.pl;
          if (iy >= 0 && iy < g.H && ix >= 0 && ix < g.W)
            va = to_f32(xb[((size_t)iy * g.W + ix) * g.C + row % g.C]);
        }
        const int col = q0 + j;
        if (col < cols) {
          const int q = w - col / g.K;
          if (q >= 0 && q < g.Wo) vg = to_f32(gb[((size_t)r * g.Wo + q) * g.K + col % g.K]);
        }
      }
      as[i] = va;
      gs[i] = vg;
    }
    __syncthreads();
    accumulate(acc, as, gs, ta, tb);
  }
  const float part = block_sum(tile_sq(acc), red);
  if (threadIdx.x == 0) partials[(size_t)b * g.P + blockIdx.y] = part;
}

template <typename T>
cudaError_t launch(const void* x, const void* gt, float* partials, float* out,
                   const CatGeo& g, cudaStream_t stream) {
  const T* xp = static_cast<const T*>(x);
  const T* gp = static_cast<const T*>(gt);
  catdot_kernel<T><<<dim3(g.B, g.P), kThreads, 0, stream>>>(xp, gp, partials, g);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  finalize_kernel<T><<<g.B, kThreads, 0, stream>>>(partials, gp, out, g.P, g.Ho * g.Wo,
                                                     g.K, 0);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Unit-stride conv, x [B, H, W, C] and g [B, Ho, Wo, K] NHWC in one dtype (0 = float32,
// 1 = bfloat16), pt / pl the top / left padding. `partials` holds B * P floats with
// P = ceil(kh * C / 64) * ceil(kw * K / 64). Returns the launch's cudaError_t.
int ddt_conv_grad_norm_catdot(const void* x, const void* g, float* partials, float* out,
                              int dtype, int B, int H, int W, int C, int Ho, int Wo,
                              int K, int kh, int kw, int pt, int pl, int P, void* stream) {
  CatGeo geo{B, H, W, C, Ho, Wo, K, kh, kw, pt, pl, Wo + kw - 1,
             (kw * K + kTile - 1) / kTile, 0};
  geo.P = (kh * C + kTile - 1) / kTile * geo.qtiles;
  if (P != geo.P || B < 1 || geo.P > 65535) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return (int)launch<float>(x, g, partials, out, geo, s);
  if (dtype == 1) return (int)launch<__nv_bfloat16>(x, g, partials, out, geo, s);
  return (int)cudaErrorInvalidValue;
}

const char* ddt_error_string(int err) { return cudaGetErrorString((cudaError_t)err); }

}  // extern "C"

// Conv backward and weight-gradient norm in ONE launch (the "megakernel"), unit stride.
//
// Replaces data_diet_distributed_tpu/ops/pallas_kernels.py:
//   conv_bwd_grad_norm_sq_pallas (:488; body _conv_bwd_norm_kernel :423).
//
// For a unit-stride conv with input x [B, H, W, C], output cotangent g [B, Ho, Wo, K],
// weight w (read as [K, kh, kw, C]: the channels_last memory of PyTorch's [K, C, kh, kw])
// and top / left padding (pt, pl), one launch writes
//   dx[b, y, x, c] = sum_{oy, ox, k} g[b, y + pt - oy, x + pl - ox, k] * w[k, oy, ox, c]
//                    (the conv's input cotangent, zero where the g index falls outside;
//                     fp32 accumulation, stored in x's dtype), and
//   out[b] = sum_o || sum_s x[b, s + o] g[b, s] ||_F^2  (+ sum_k (sum_s g[b, s, k])^2)
//                    (the per-example weight-gradient norm, as conv_grad_norm_direct.cu).
//
// Design. The TPU kernel shares one VMEM residency of the g tile between the two halves.
// This first Hopper version instead splits the blocks of the one launch into two roles:
// blocks [0, B) each compute one example's whole norm (every offset and every 64 x 64
// C x K tile in turn, the tile machinery of conv_norm_common.cuh, summed per thread and
// then over the block in a fixed order: no partials buffer, no second pass, no atomics);
// the blocks after them each compute one 64-position x 64-channel tile of dx, contracting
// over K in 32-channel chunks for every offset, with the g window and the weight slice
// staged in shared memory. The norm blocks come first in the grid so that their long
// loops start while the short dx blocks fill the rest of the card. Sharing the staged g
// tile between the roles is left to the work that makes the kernel fast. The TPU's
// two-examples-per-dot packing at C = K = 64 only filled the 128-lane MXU and is not
// carried over. Bit-identical from run to run and independent of the example's place in
// the batch.
//
// Bound on the card: operations, twice the direct form's (2 * B * S * kh*kw * C * K
// FLOPs for each half) on the fp32 CUDA cores. Left for later: bf16 tensor-core tiles
// (wgmma) for both halves and one shared staging of g.

#include "conv_norm_common.cuh"

namespace {

// Row stride of the staged g window of a dx block ([32 k][64 positions]): a multiple of 4
// for the float4 reads, padded to spread the column-wise stores over more banks.
constexpr int kGStride = kTile + 4;

template <typename T>
__device__ void norm_role(const T* __restrict__ x, const T* __restrict__ gt,
                          float* __restrict__ out, const Geo& g, int use_bias, float* sx,
                          float* sg, float* red) {
  const int b = blockIdx.x;
  const int tc = threadIdx.x % 16, tk = threadIdx.x / 16;
  const int S = g.Ho * g.Wo;
  const T* xb = x + (size_t)b * g.H * g.W * g.C;
  const T* gb = gt + (size_t)b * S * g.K;
  float v = 0.f;
  for (int o = 0; o < g.kh * g.kw; ++o) {
    const int oy = o / g.kw, ox = o % g.kw;
    for (int ct = 0; ct < g.ctiles; ++ct) {
      for (int kt = 0; kt < g.ktiles; ++kt) {
        float acc[4][4] = {};
        for (int s0 = 0; s0 < S; s0 += kChunk) {
          __syncthreads();  // previous chunk consumed
          load_x_chunk(sx, xb, g, s0, oy, ox, ct * kTile);
          load_g_rows(sg, gb, g, s0, kChunk, kt * kTile);
          __syncthreads();
          accumulate(acc, sx, sg, tc, tk);
        }
        v += tile_sq(acc);
      }
    }
  }
  if (use_bias) v = add_bias_term_share(v, gb, S, g.K);
  const float total = block_sum(v, red);
  if (threadIdx.x == 0) out[b] = total;
}

template <typename T>
__device__ void dx_role(int tile, const T* __restrict__ gt, const float* __restrict__ w,
                        T* __restrict__ dx, const Geo& g, int ptiles, float* sg, float* sw) {
  const int HW = g.H * g.W;
  const int b = tile / (ptiles * g.ctiles), rem = tile % (ptiles * g.ctiles);
  const int p0 = (rem / g.ctiles) * kTile, c0 = (rem % g.ctiles) * kTile;
  const int tc = threadIdx.x % 16, tp = threadIdx.x / 16;
  const T* gb = gt + (size_t)b * g.Ho * g.Wo * g.K;
  float acc[4][4] = {};  // acc[i][j]: channel c0 + tc*4 + i at position p0 + tp*4 + j
  for (int o = 0; o < g.kh * g.kw; ++o) {
    const int oy = o / g.kw, ox = o % g.kw;
    for (int k0 = 0; k0 < g.K; k0 += kChunk) {
      __syncthreads();  // previous chunk consumed
      // sg[kk][pp] = g[b, y + pt - oy, x + pl - ox, k0 + kk] at position p0 + pp = y*W + x.
      for (int i = threadIdx.x; i < kChunk * kTile; i += kThreads) {
        const int kk = i % kChunk, pp = i / kChunk;
        const int p = p0 + pp, k = k0 + kk;
        float v = 0.f;
        if (p < HW && k < g.K) {
          const int r = p / g.W + g.pt - oy, q = p % g.W + g.pl - ox;
          if (r >= 0 && r < g.Ho && q >= 0 && q < g.Wo)
            v = to_f32(gb[((size_t)r * g.Wo + q) * g.K + k]);
        }
        sg[kk * kGStride + pp] = v;
      }
      // sw[kk][cc] = w[k0 + kk, oy, ox, c0 + cc].
      for (int i = threadIdx.x; i < kChunk * kTile; i += kThreads) {
        const int kk = i / kTile, cc = i % kTile;
        const int k = k0 + kk, c = c0 + cc;
        sw[i] = (k < g.K && c < g.C)
                    ? w[(((size_t)k * g.kh + oy) * g.kw + ox) * g.C + c] : 0.f;
      }
      __syncthreads();
      accumulate<kTile, kGStride>(acc, sw, sg, tc, tp);
    }
  }
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int p = p0 + tp * 4 + j;
    if (p >= HW) continue;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int c = c0 + tc * 4 + i;
      if (c < g.C) store_as(dx + ((size_t)b * HW + p) * g.C + c, acc[i][j]);
    }
  }
}

// grid: B norm blocks, then B * ptiles * ctiles dx blocks.
template <typename T>
__global__ void __launch_bounds__(kThreads)
bwd_norm_kernel(const T* __restrict__ x, const T* __restrict__ gt,
                const float* __restrict__ w, T* __restrict__ dx, float* __restrict__ out,
                Geo g, int ptiles, int use_bias) {
  __shared__ __align__(16) float sa[kChunk * kGStride];
  __shared__ __align__(16) float sb[kChunk * kTile];
  __shared__ float red[kThreads / 32];
  if ((int)blockIdx.x < g.B)
    norm_role(x, gt, out, g, use_bias, sa, sb, red);
  else
    dx_role((int)blockIdx.x - g.B, gt, w, dx, g, ptiles, sa, sb);
}

template <typename T>
cudaError_t launch(const void* x, const void* gt, const float* w, void* dx, float* out,
                   const Geo& g, int ptiles, int use_bias, cudaStream_t stream) {
  const unsigned blocks = (unsigned)g.B + (unsigned)g.B * ptiles * g.ctiles;
  bwd_norm_kernel<T><<<blocks, kThreads, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(gt), w, static_cast<T*>(dx), out, g,
      ptiles, use_bias);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Unit-stride conv: x [B, H, W, C] and g [B, Ho, Wo, K] NHWC in one dtype (0 = float32,
// 1 = bfloat16), w [K, kh, kw, C] float32, dx [B, H, W, C] in x's dtype, out [B] float32.
// Returns the launch's cudaError_t (0 = success).
int ddt_conv_bwd_grad_norm(const void* x, const void* g, const float* w, void* dx,
                           float* out, int dtype, int B, int H, int W, int C, int Ho, int Wo,
                           int K, int kh, int kw, int pt, int pl, int use_bias,
                           void* stream) {
  Geo geo{B, H, W, C, Ho, Wo, K, kh, kw, 1, 1, pt, pl,
          (C + kTile - 1) / kTile, (K + kTile - 1) / kTile, 0};
  const int ptiles = (H * W + kTile - 1) / kTile;
  const long long blocks = (long long)B * (1 + (long long)ptiles * geo.ctiles);
  if (B < 1 || kh < 1 || kw < 1 || blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return (int)launch<float>(x, g, w, dx, out, geo, ptiles, use_bias, s);
  if (dtype == 1)
    return (int)launch<__nv_bfloat16>(x, g, w, dx, out, geo, ptiles, use_bias, s);
  return (int)cudaErrorInvalidValue;
}

const char* ddt_error_string(int err) { return cudaGetErrorString((cudaError_t)err); }

}  // extern "C"

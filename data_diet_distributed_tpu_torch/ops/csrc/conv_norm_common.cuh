// Device code shared by the conv weight-gradient-norm kernels
// (conv_grad_norm_direct.cu, conv_grad_norm_catdot.cu, conv_bwd_grad_norm.cu): the fp32
// modes' CUDA-core tiles, the layer geometry and the fixed-order finalize pass that every
// mode's partials go through.
//
// A block of 256 threads owns one 64 x 64 fp32 tile of a product A^T B over a
// contraction axis that it streams through shared memory in chunks of 32 rows; each
// thread accumulates a 4 x 4 sub-tile in registers. Sums run in a fixed order and use
// no atomics, so every kernel built on this is bit-identical from run to run and gives
// an example the same result wherever it sits in the batch.

#pragma once

#include <stdint.h>

#include "common.cuh"

namespace {

constexpr int kTile = 64;          // output tile edge (both dimensions)
constexpr int kChunk = 32;         // contraction rows staged per step
constexpr int kThreads = 256;      // 16 x 16 threads, 4 x 4 outputs each

// acc[i][j] += sum_{s < kChunk} a[s][ta*4+i] * b[s][tb*4+j], with row strides kStrideA and
// kStrideB (multiples of 4: the rows are read as float4).
template <int kStrideA = kTile, int kStrideB = kTile>
__device__ __forceinline__ void accumulate(float (&acc)[4][4], const float* a, const float* b,
                                           int ta, int tb, int rows = kChunk) {
#pragma unroll 8
  for (int s = 0; s < rows; ++s) {
    const float4 u = *reinterpret_cast<const float4*>(a + s * kStrideA + ta * 4);
    const float4 w = *reinterpret_cast<const float4*>(b + s * kStrideB + tb * 4);
    const float uv[4] = {u.x, u.y, u.z, u.w};
    const float wv[4] = {w.x, w.y, w.z, w.w};
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(uv[i], wv[j], acc[i][j]);
  }
}

__device__ __forceinline__ float tile_sq(const float (&acc)[4][4]) {
  float v = 0.f;
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) v = fmaf(acc[i][j], acc[i][j], v);
  return v;
}

// Geometry of a conv layer in NHWC, with the direct form's tiling of its [C, K] blocks.
struct Geo {
  int B, H, W, C, Ho, Wo, K;
  int kh, kw, sy, sx, pt, pl;
  int ctiles, ktiles, P;
};

// xs[s][c] = x[b, pos(s0 + s, o), c0 + c], zero outside the input or past S / C
// (virtual padding: bounds checks, no padded copy; any stride).
template <typename T>
__device__ void load_x_chunk(float* xs, const T* xb, const Geo& g, int s0, int oy, int ox,
                             int c0) {
  const int S = g.Ho * g.Wo;
  for (int i = threadIdx.x; i < kChunk * kTile; i += kThreads) {
    const int s = s0 + i / kTile, c = c0 + i % kTile;
    float v = 0.f;
    if (s < S && c < g.C) {
      const int iy = (s / g.Wo) * g.sy + oy - g.pt;
      const int ix = (s % g.Wo) * g.sx + ox - g.pl;
      if (iy >= 0 && iy < g.H && ix >= 0 && ix < g.W)
        v = to_f32(xb[((size_t)iy * g.W + ix) * g.C + c]);
    }
    xs[i] = v;
  }
}

// dst[s][k] = g[b, s0 + s, k0 + k] for s < rows, zero past S / K.
template <typename T>
__device__ void load_g_rows(float* dst, const T* gb, const Geo& g, int s0, int rows, int k0) {
  const int S = g.Ho * g.Wo;
  for (int i = threadIdx.x; i < rows * kTile; i += kThreads) {
    const int s = s0 + i / kTile, k = k0 + i % kTile;
    dst[i] = (s < S && k < g.K) ? to_f32(gb[(size_t)s * g.K + k]) : 0.f;
  }
}

// v plus this thread's share of the bias-gradient term sum_k (sum_s g[b, s, k])^2 of one
// example: thread t adds the columns k = t, t + blockDim.x, ... in a fixed order.
template <typename T>
__device__ float add_bias_term_share(float v, const T* gb, int S, int K) {
  for (int k = threadIdx.x; k < K; k += blockDim.x) {
    float col = 0.f;
    for (int s = 0; s < S; ++s) col += to_f32(gb[(size_t)s * K + k]);
    v = fmaf(col, col, v);
  }
  return v;
}

// out[b] = sum_p partials[b, p] (+ the bias term of g[b] with S positions, K channels),
// fixed order.
template <typename T>
__global__ void __launch_bounds__(kThreads)
finalize_kernel(const float* __restrict__ partials, const T* __restrict__ gt,
                float* __restrict__ out, int P, int S, int K, int use_bias) {
  __shared__ float red[kThreads / 32];
  const int b = blockIdx.x;
  float v = 0.f;
  for (int p = threadIdx.x; p < P; p += kThreads) v += partials[(size_t)b * P + p];
  if (use_bias) v = add_bias_term_share(v, gt + (size_t)b * S * K, S, K);
  const float total = block_sum(v, red);
  if (threadIdx.x == 0) out[b] = total;
}

}  // namespace

// Per-example squared Frobenius norm of a conv layer's weight gradient, Gram form.
//
// Replaces data_diet_distributed_tpu/ops/pallas_kernels.py:
//   conv_grad_norm_sq_gram (:797; body _conv_gram_kernel :765).
//
// With P[b] the [S, kh*kw*C] im2col patches and G[b] the [S, K] output cotangent,
//   out[b] = sum_{s,t} (P P^T)[s, t] * (G G^T)[s, t]   (+ sum_k (sum_s g[b, s, k])^2).
// The patches are never built: (P P^T)[s, t] = sum_o XX[pos(s, o), pos(t, o)] over the
// kernel offsets o where both positions fall inside the input, with XX = X X^T the
// [H*W, H*W] Gram of the example's input pixels. That is kh*kw times fewer operations
// than the patch Gram the TPU kernel builds in VMEM, and the padding stays virtual.
//
// Design. One block per example. It stages channel chunks of x ([H*W, 32]) and of g
// ([S, 32]) in shared memory, accumulates XX and GG = G G^T there (each entry owned by
// one thread, so no races and a fixed order), then forms sum(PP^T * GG) entry by entry
// and reduces it over the block in a fixed order. No float atomics: bit-identical from
// run to run and independent of the example's place in the batch.
//
// Bound on the card: at ResNet-18 stage-4 geometry (4x4x512) the whole batch's x and g
// are 2 x 16 MB in fp32 against about 0.3 GFLOP, so bytes; in practice the 512 blocks
// are latency-bound (one block per example, dependent chunk loads). Left for later:
// several examples per block and cp.async / TMA double-buffering of the chunks.

#include <stdint.h>

#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kChunk = 32;        // channels staged per step
constexpr int kStride = kChunk + 1;  // padded row stride: conflict-free column reads

struct Geo {
  int B, H, W, C, Ho, Wo, K;
  int kh, kw, pt, pl;
};

// gram[e] += sum_c rows[p][c] * rows[q][c] for e = p * n + q, over channel chunks of
// src[n, depth] (row-major, `depth` channels per row).
template <typename T>
__device__ void accumulate_gram(float* gram, float* rows, const T* src, int n, int depth) {
  for (int c0 = 0; c0 < depth; c0 += kChunk) {
    __syncthreads();  // previous chunk consumed
    for (int i = threadIdx.x; i < n * kChunk; i += kThreads) {
      const int p = i / kChunk, c = c0 + i % kChunk;
      rows[p * kStride + i % kChunk] = c < depth ? to_f32(src[(size_t)p * depth + c]) : 0.f;
    }
    __syncthreads();
    for (int e = threadIdx.x; e < n * n; e += kThreads) {
      const float* a = rows + (e / n) * kStride;
      const float* b = rows + (e % n) * kStride;
      float acc = 0.f;
#pragma unroll 8
      for (int c = 0; c < kChunk; ++c) acc = fmaf(a[c], b[c], acc);
      gram[e] += acc;
    }
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
gram_kernel(const T* __restrict__ x, const T* __restrict__ gt, float* __restrict__ out,
            Geo g, int use_bias) {
  extern __shared__ float sm[];
  __shared__ float red[kThreads / 32];
  const int HW = g.H * g.W, S = g.Ho * g.Wo;
  float* XX = sm;              // [HW, HW]
  float* GG = XX + HW * HW;    // [S, S]
  float* rows = GG + S * S;    // [max(HW, S), kStride]
  const int b = blockIdx.x;
  const T* xb = x + (size_t)b * HW * g.C;
  const T* gb = gt + (size_t)b * S * g.K;

  for (int i = threadIdx.x; i < HW * HW + S * S; i += kThreads) sm[i] = 0.f;
  accumulate_gram(XX, rows, xb, HW, g.C);
  accumulate_gram(GG, rows, gb, S, g.K);
  __syncthreads();

  float v = 0.f;
  for (int e = threadIdx.x; e < S * S; e += kThreads) {
    const int s = e / S, t = e % S;
    const int sr = s / g.Wo, sq = s % g.Wo, tr = t / g.Wo, tq = t % g.Wo;
    float pp = 0.f;
    for (int oy = 0; oy < g.kh; ++oy) {
      const int y1 = sr + oy - g.pt, y2 = tr + oy - g.pt;
      if (y1 < 0 || y1 >= g.H || y2 < 0 || y2 >= g.H) continue;
      for (int ox = 0; ox < g.kw; ++ox) {
        const int x1 = sq + ox - g.pl, x2 = tq + ox - g.pl;
        if (x1 < 0 || x1 >= g.W || x2 < 0 || x2 >= g.W) continue;
        pp += XX[(y1 * g.W + x1) * HW + y2 * g.W + x2];
      }
    }
    v = fmaf(pp, GG[e], v);
  }
  if (use_bias) {
    for (int k = threadIdx.x; k < g.K; k += kThreads) {
      float col = 0.f;
      for (int s = 0; s < S; ++s) col += to_f32(gb[(size_t)s * g.K + k]);
      v = fmaf(col, col, v);
    }
  }
  const float total = block_sum(v, red);
  if (threadIdx.x == 0) out[b] = total;
}

size_t smem_bytes(const Geo& g) {
  const size_t HW = (size_t)g.H * g.W, S = (size_t)g.Ho * g.Wo;
  return (HW * HW + S * S + (HW > S ? HW : S) * kStride) * sizeof(float);
}

template <typename T>
cudaError_t launch(const void* x, const void* gt, float* out, const Geo& g, int use_bias,
                   cudaStream_t stream) {
  const size_t smem = smem_bytes(g);
  cudaError_t err = cudaFuncSetAttribute(
      gram_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  gram_kernel<T><<<g.B, kThreads, smem, stream>>>(static_cast<const T*>(x),
                                                   static_cast<const T*>(gt), out, g,
                                                   use_bias);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Unit-stride conv. The block's dynamic shared memory is smem_bytes() above; the
// wrapper's eligibility gate (kernels.py, _gram_smem_bytes) keeps it within the card's
// 227 KB per block; dtype: 0 = float32, 1 = bfloat16. Returns the cudaError_t.
int ddt_conv_grad_norm_gram(const void* x, const void* g, float* out, int dtype, int B,
                            int H, int W, int C, int Ho, int Wo, int K, int kh, int kw,
                            int pt, int pl, int use_bias, void* stream) {
  Geo geo{B, H, W, C, Ho, Wo, K, kh, kw, pt, pl};
  if (B < 1) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return (int)launch<float>(x, g, out, geo, use_bias, s);
  if (dtype == 1) return (int)launch<__nv_bfloat16>(x, g, out, geo, use_bias, s);
  return (int)cudaErrorInvalidValue;
}

const char* ddt_error_string(int err) { return cudaGetErrorString((cudaError_t)err); }

}  // extern "C"

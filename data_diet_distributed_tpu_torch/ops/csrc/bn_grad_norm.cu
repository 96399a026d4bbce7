// Eval-mode BatchNorm per-example squared weight-gradient norm, same-shape layers stacked.
//
// Replaces data_diet_distributed_tpu/ops/pallas_kernels.py:
//   bn_grad_norm_sq_pallas (:883; body _bn_kernel :858).
//
// For row n of the stack (layer l = n / per_layer, example r = n % per_layer) with input
// x and output cotangent g of layer l ([S, C] NHWC rows) and its statistics slab
// stats[l] = (mean[C], rstd[C]):
//   out[n] = sum_c ((sum_s g*x - mean_c * sum_s g) * rstd_c)^2   (when use_scale)
//          + sum_c (sum_s g)^2                                    (when use_bias).
//
// Stacking. The TPU concatenates the layers' activations along the batch (a copy of
// every x and g). Here the launch takes an array of per-layer base pointers instead, so
// nothing is copied: each layer's NHWC tensor is read where the model left it (the port's
// BatchNorm inputs are NCHW views of channels_last memory, i.e. NHWC rows). Up to
// kMaxLayers layers per launch; the statistics come as one [L, 2, C] fp32 slab (the
// TPU's 8-row sublane padding of it is not carried over).
//
// Bound on the card: bytes. x and g are read once and each element pair costs 3 FLOPs,
// so the kernel is a streaming reduction: what it needs is enough bytes in flight per SM
// and full 16-byte transactions. At ResNet-18's four BN shapes (batch 512, bf16) one
// layer is 134, 67, 34 and 17 MB, 40.3, 20.2, 10.1 and 5.0 us at 3.35 TB/s.
//
// Design, vector mode (C a multiple of the 16-byte vector width, at most kThreads
// vectors, 16-byte-aligned layer pointers; ResNet-18 always). One block per stacked row.
// A thread owns one vector of channels (8 bf16 or 4 fp32, one 16-byte load per tensor
// per position) and one position group: the block's threads span C / vec channel
// vectors x the remaining position groups (8 x 32 at 32x32x64, 64 x 4 at 4x4x512 in
// bf16), so every position of a row is read by exactly one thread and a warp reads 512
// contiguous bytes per load. Each thread keeps its channels' sum g*x and sum g in fp32
// registers and walks its positions kUnroll at a time, all loads of a step issued before
// any arithmetic, so 2 * kUnroll loads of 16 bytes are in flight per thread. The position
// groups' partial sums meet in shared memory and are added per channel in group order;
// then each channel's term is formed and the terms are summed per thread and over the
// block in a fixed order. No atomics: bit-identical from run to run and independent of
// the row's place in the stack or the batch.
//
// Scalar mode (any other C or alignment): one thread per channel of a 64-channel tile,
// 4 position groups, the tiles walked in series with scalar loads.

#include <stdint.h>

#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kUnroll = 4;                   // positions per thread per load step (vector)
constexpr int kCTile = 64;                   // channels per tile, one per thread (scalar)
constexpr int kGroups = kThreads / kCTile;   // position groups (scalar)
constexpr int kMaxLayers = 64;

struct Layers {
  const void* x[kMaxLayers];
  const void* g[kMaxLayers];
};

// The `i`-th channel value of a 16-byte vector of T.
__device__ __forceinline__ float lane_f32(const uint4& v, int i, float) {
  const uint32_t w[4] = {v.x, v.y, v.z, v.w};
  return __uint_as_float(w[i]);
}

__device__ __forceinline__ float lane_f32(const uint4& v, int i, __nv_bfloat16) {
  const uint32_t w[4] = {v.x, v.y, v.z, v.w};
  const uint32_t word = w[i >> 1];
  return __uint_as_float((i & 1) ? (word & 0xffff0000u) : (word << 16));
}

// The channel terms of one row from the per-(group, channel) partial sums sgx, sgs
// ([groups][C]), added in group order; the block's fixed-order sum, in thread 0.
__device__ float row_terms(const float* sgx, const float* sgs, int groups,
                           const float* mean, const float* rstd, int C, int use_scale,
                           int use_bias, float* red) {
  float v = 0.f;
  for (int c = threadIdx.x; c < C; c += kThreads) {
    float tgx = sgx[c], tgs = sgs[c];
    for (int q = 1; q < groups; ++q) {
      tgx += sgx[q * C + c];
      tgs += sgs[q * C + c];
    }
    if (use_scale) {
      const float t = (tgx - mean[c] * tgs) * rstd[c];
      v = fmaf(t, t, v);
    }
    if (use_bias) v = fmaf(tgs, tgs, v);
  }
  return block_sum(v, red);
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
bn_vector_kernel(Layers layers, const float* __restrict__ stats, float* __restrict__ out,
                 int per_layer, int S, int C, int use_scale, int use_bias) {
  constexpr int kVec = 16 / sizeof(T);       // channels per 16-byte vector
  // groups * C <= kThreads * kVec floats each (groups = kThreads / (C / kVec)).
  __shared__ __align__(16) float sgx[kThreads * kVec];
  __shared__ __align__(16) float sgs[kThreads * kVec];
  __shared__ float red[kThreads / 32];
  const int n = blockIdx.x, l = n / per_layer, r = n % per_layer;
  const int CV = C / kVec, groups = kThreads / CV;
  const int cv = threadIdx.x % CV, grp = threadIdx.x / CV;
  const uint4* xr = static_cast<const uint4*>(layers.x[l]) + (size_t)r * S * CV + cv;
  const uint4* gr = static_cast<const uint4*>(layers.g[l]) + (size_t)r * S * CV + cv;
  const float* mean = stats + (size_t)l * 2 * C;
  const float* rstd = mean + C;

  if (grp < groups) {
    float gx[kVec], gs[kVec];
#pragma unroll
    for (int i = 0; i < kVec; ++i) gx[i] = gs[i] = 0.f;
    for (int s0 = grp; s0 < S; s0 += kUnroll * groups) {
      uint4 xv[kUnroll], gv[kUnroll];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const int s = s0 + u * groups;
        if (s < S) {
          xv[u] = __ldg(xr + (size_t)s * CV);
          gv[u] = __ldg(gr + (size_t)s * CV);
        }
      }
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        if (s0 + u * groups < S) {
#pragma unroll
          for (int i = 0; i < kVec; ++i) {
            const float g = lane_f32(gv[u], i, T{});
            gx[i] = fmaf(g, lane_f32(xv[u], i, T{}), gx[i]);
            gs[i] += g;
          }
        }
      }
    }
    float4* dgx = reinterpret_cast<float4*>(sgx + grp * C + cv * kVec);
    float4* dgs = reinterpret_cast<float4*>(sgs + grp * C + cv * kVec);
#pragma unroll
    for (int i = 0; i < kVec / 4; ++i) {
      dgx[i] = make_float4(gx[4 * i], gx[4 * i + 1], gx[4 * i + 2], gx[4 * i + 3]);
      dgs[i] = make_float4(gs[4 * i], gs[4 * i + 1], gs[4 * i + 2], gs[4 * i + 3]);
    }
  }
  __syncthreads();
  const float total = row_terms(sgx, sgs, groups, mean, rstd, C, use_scale, use_bias, red);
  if (threadIdx.x == 0) out[n] = total;
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
bn_scalar_kernel(Layers layers, const float* __restrict__ stats, float* __restrict__ out,
                 int per_layer, int S, int C, int use_scale, int use_bias) {
  __shared__ float sgx[kGroups][kCTile];
  __shared__ float sgs[kGroups][kCTile];
  __shared__ float red[kThreads / 32];
  const int n = blockIdx.x, l = n / per_layer, r = n % per_layer;
  const T* xr = static_cast<const T*>(layers.x[l]) + (size_t)r * S * C;
  const T* gr = static_cast<const T*>(layers.g[l]) + (size_t)r * S * C;
  const float* mean = stats + (size_t)l * 2 * C;
  const float* rstd = mean + C;
  const int lc = threadIdx.x % kCTile, grp = threadIdx.x / kCTile;
  float v = 0.f;
  for (int c0 = 0; c0 < C; c0 += kCTile) {
    const int c = c0 + lc;
    float gx = 0.f, gs = 0.f;
    if (c < C) {
      for (int s = grp; s < S; s += kGroups) {
        const float gv = to_f32(gr[(size_t)s * C + c]);
        gx = fmaf(gv, to_f32(xr[(size_t)s * C + c]), gx);
        gs += gv;
      }
    }
    sgx[grp][lc] = gx;
    sgs[grp][lc] = gs;
    __syncthreads();
    if (grp == 0 && c < C) {
      float tgx = sgx[0][lc], tgs = sgs[0][lc];
#pragma unroll
      for (int q = 1; q < kGroups; ++q) {
        tgx += sgx[q][lc];
        tgs += sgs[q][lc];
      }
      if (use_scale) {
        const float t = (tgx - mean[c] * tgs) * rstd[c];
        v = fmaf(t, t, v);
      }
      if (use_bias) v = fmaf(tgs, tgs, v);
    }
    __syncthreads();  // the tile's partial sums consumed
  }
  const float total = block_sum(v, red);
  if (threadIdx.x == 0) out[n] = total;
}

// The vector mode's preconditions: C a multiple of the vector width with at most
// kThreads vectors, and every layer pointer 16-byte aligned.
bool vector_ok(const Layers& layers, int L, int C, int vec) {
  if (C % vec != 0 || C / vec > kThreads) return false;
  for (int l = 0; l < L; ++l)
    if (reinterpret_cast<uintptr_t>(layers.x[l]) % 16 != 0 ||
        reinterpret_cast<uintptr_t>(layers.g[l]) % 16 != 0)
      return false;
  return true;
}

template <typename T>
cudaError_t launch(const Layers& layers, const float* stats, float* out, int L, int per_layer,
                   int S, int C, int use_scale, int use_bias, int vector, cudaStream_t s) {
  const unsigned blocks = (unsigned)L * per_layer;
  if (vector) {
    if (!vector_ok(layers, L, C, 16 / sizeof(T))) return cudaErrorInvalidValue;
    bn_vector_kernel<T><<<blocks, kThreads, 0, s>>>(layers, stats, out, per_layer, S, C,
                                                    use_scale, use_bias);
  } else {
    bn_scalar_kernel<T><<<blocks, kThreads, 0, s>>>(layers, stats, out, per_layer, S, C,
                                                    use_scale, use_bias);
  }
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// xs[l], gs[l]: layer l's x and g, [per_layer, S, C] NHWC, all in one dtype
// (0 = float32, 1 = bfloat16); stats [L, 2, C] float32 (mean, rstd); out [L * per_layer]
// float32. L <= 64. mode: 1 = vector (refused unless its preconditions hold), 0 = scalar.
// Returns the launch's cudaError_t (0 = success).
int ddt_bn_grad_norm(const void* const* xs, const void* const* gs, const float* stats,
                     float* out, int dtype, int L, int per_layer, int S, int C,
                     int use_scale, int use_bias, int mode, void* stream) {
  if (L < 1 || L > kMaxLayers || per_layer < 1 || S < 1 || C < 1 || mode < 0 || mode > 1)
    return (int)cudaErrorInvalidValue;
  Layers layers{};
  for (int l = 0; l < L; ++l) {
    layers.x[l] = xs[l];
    layers.g[l] = gs[l];
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return (int)launch<float>(layers, stats, out, L, per_layer, S, C, use_scale, use_bias,
                              mode, s);
  if (dtype == 1)
    return (int)launch<__nv_bfloat16>(layers, stats, out, L, per_layer, S, C, use_scale,
                                      use_bias, mode, s);
  return (int)cudaErrorInvalidValue;
}

const char* ddt_error_string(int err) { return cudaGetErrorString((cudaError_t)err); }

}  // extern "C"

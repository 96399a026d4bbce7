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
// Design. One block per row (the stacked rows already give L x B blocks): for each tile
// of 64 channels, 4 groups of 64 threads stride over the S positions, each thread
// reducing sum_s g*x and sum_s g for one channel in fp32 straight from bf16 or fp32
// (no fp32 copies of x and g); the 4 partial sums of a channel are added in a fixed
// order, its term formed, and the per-channel terms summed per thread and then over the
// block in a fixed order. No atomics: bit-identical from run to run and independent of
// the example's place in the stack. (One block covers all channels of its row, so the
// fixed-order sum over channels needs no second pass.)
//
// Bound on the card: bytes (x and g read once, 3 FLOPs per element pair). Left for later:
// 16-byte vector loads (8 bf16 channels per thread).

#include <stdint.h>

#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kCTile = 64;                   // channels per tile, one per thread
constexpr int kGroups = kThreads / kCTile;   // position groups
constexpr int kMaxLayers = 64;

struct Layers {
  const void* x[kMaxLayers];
  const void* g[kMaxLayers];
};

template <typename T>
__global__ void __launch_bounds__(kThreads)
bn_kernel(Layers layers, const float* __restrict__ stats, float* __restrict__ out,
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

}  // namespace

extern "C" {

// xs[l], gs[l]: layer l's x and g, [per_layer, S, C] NHWC, all in one dtype
// (0 = float32, 1 = bfloat16); stats [L, 2, C] float32 (mean, rstd); out [L * per_layer]
// float32. L <= 64. Returns the launch's cudaError_t (0 = success).
int ddt_bn_grad_norm(const void* const* xs, const void* const* gs, const float* stats,
                     float* out, int dtype, int L, int per_layer, int S, int C,
                     int use_scale, int use_bias, void* stream) {
  if (L < 1 || L > kMaxLayers || per_layer < 1 || S < 1 || C < 1)
    return (int)cudaErrorInvalidValue;
  Layers layers{};
  for (int l = 0; l < L; ++l) {
    layers.x[l] = xs[l];
    layers.g[l] = gs[l];
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const unsigned blocks = (unsigned)L * per_layer;
  if (dtype == 0)
    bn_kernel<float><<<blocks, kThreads, 0, s>>>(layers, stats, out, per_layer, S, C,
                                                 use_scale, use_bias);
  else if (dtype == 1)
    bn_kernel<__nv_bfloat16><<<blocks, kThreads, 0, s>>>(layers, stats, out, per_layer, S,
                                                         C, use_scale, use_bias);
  else
    return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}

const char* ddt_error_string(int err) { return cudaGetErrorString((cudaError_t)err); }

}  // extern "C"

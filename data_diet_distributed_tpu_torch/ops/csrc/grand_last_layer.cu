// Last-layer GraNd: the classifier product and the score in one kernel.
//
// Replaces data_diet_distributed_tpu/ops/pallas_kernels.py:
//   grand_last_layer_pallas (:933; body _gll_kernel :922).
//
// For row b with features h[b] (F floats), classifier weight w [C, F] (PyTorch's
// nn.Linear layout, read as it is: no transposed copy), bias [C], label y and mask m:
//   z_j    = sum_f h[b, f] * w[j, f] + bias_j        (the logits, computed here),
//   p      = softmax(z) (max-subtracted),
//   out[b] = sqrt(||p - onehot(y)||^2 * (||h[b]||^2 + 1)) * m.
//
// Design. One warp per row. The warp stages its row of h in shared memory (and sums
// ||h||^2 on the way), then forms each logit as a lane-strided dot product over F with a
// fixed-order shuffle reduction and keeps the C logits in shared memory; the softmax
// error then follows as in el2n.cu (three strided passes, shuffle reductions). Up to 8
// rows per block, fewer when (F + C) floats per warp would not fit in shared memory.
// Bit-identical from run to run (fixed orders, no atomics).
//
// Bound on the card: at ResNet-18 geometry ([512, 512] features, 10 classes) launch
// latency dominates both bounds; at [512, 2048] -> 1000 it is operations (2 GFLOP on the
// fp32 CUDA cores, every warp re-reading w from L2). Left for later: tiles of rows per
// block sharing each staged slice of w, on the tensor cores.

#include <math.h>
#include <stdint.h>

#include "common.cuh"

namespace {

constexpr int kMaxWarps = 8;
constexpr size_t kMaxSmem = 227 * 1024;

__global__ void gll_kernel(const float* __restrict__ h, const float* __restrict__ w,
                           const float* __restrict__ bias, const int32_t* __restrict__ labels,
                           const float* __restrict__ mask, float* __restrict__ out, int B,
                           int F, int C) {
  extern __shared__ float sm[];
  const int warp = threadIdx.x / 32, lane = threadIdx.x & 31;
  const int row = blockIdx.x * (blockDim.x / 32) + warp;
  if (row >= B) return;  // whole warps leave together; only warp-level syncs follow
  float* hs = sm + (size_t)warp * (F + C);
  float* z = hs + F;
  const float* hr = h + (size_t)row * F;

  float fsq = 0.f;
  for (int f = lane; f < F; f += 32) {
    const float v = hr[f];
    hs[f] = v;
    fsq = fmaf(v, v, fsq);
  }
  fsq = warp_sum(fsq);
  __syncwarp();
  for (int j = 0; j < C; ++j) {
    const float* wj = w + (size_t)j * F;
    float d = 0.f;
    for (int f = lane; f < F; f += 32) d = fmaf(hs[f], wj[f], d);
    d = warp_sum(d);
    if (lane == 0) z[j] = d + bias[j];
  }
  __syncwarp();

  float m = -INFINITY;
  for (int j = lane; j < C; j += 32) m = fmaxf(m, z[j]);
  m = warp_max(m);
  float se = 0.f;
  for (int j = lane; j < C; j += 32) se += expf(z[j] - m);
  se = warp_sum(se);
  const int y = labels[row];
  float err = 0.f;
  for (int j = lane; j < C; j += 32) {
    const float d = expf(z[j] - m) / se - (j == y ? 1.f : 0.f);
    err = fmaf(d, d, err);
  }
  err = warp_sum(err);
  if (lane == 0) out[row] = sqrtf(err * (fsq + 1.f)) * mask[row];
}

}  // namespace

extern "C" {

// h [B, F] float32, w [C, F] float32, bias [C] float32, labels [B] int32, mask [B]
// float32, out [B] float32; (F + C) * 4 bytes must fit one block's shared memory.
// Returns the launch's cudaError_t (0 = success).
int ddt_grand_last_layer(const float* h, const float* w, const float* bias,
                         const int32_t* labels, const float* mask, float* out, int B, int F,
                         int C, void* stream) {
  const size_t per_warp = (size_t)(F + C) * sizeof(float);
  if (B < 1 || F < 1 || C < 1 || per_warp > kMaxSmem) return (int)cudaErrorInvalidValue;
  int warps = kMaxWarps;
  while (warps > 1 && warps * per_warp > kMaxSmem) --warps;
  const size_t smem = warps * per_warp;
  cudaError_t err = cudaFuncSetAttribute(
      gll_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const int blocks = (B + warps - 1) / warps;
  gll_kernel<<<blocks, warps * 32, smem, static_cast<cudaStream_t>(stream)>>>(
      h, w, bias, labels, mask, out, B, F, C);
  return (int)cudaGetLastError();
}

const char* ddt_error_string(int err) { return cudaGetErrorString((cudaError_t)err); }

}  // extern "C"

// EL2N scores: out[b] = || softmax(logits[b]) - onehot(labels[b]) ||_2 * mask[b].
//
// Replaces data_diet_distributed_tpu/ops/pallas_kernels.py:
//   el2n_pallas (:100; body _el2n_kernel :94).
//
// Design. One warp per row: a max-subtracted softmax over the row (three passes over the
// C logits, each lane striding by 32, warp-shuffle reductions), the one-hot error and
// its L2 norm, times the mask. Any C works; C up to 1000 keeps each lane at <= 32
// logits. Bit-identical from run to run (fixed reduction order, no atomics).
//
// Bound on the card: bytes, and at ResNet-18 geometry (logits [512, 10]) launch latency
// dominates both bounds by far. Left for later: fusing it behind the classifier GEMM,
// as the TPU's grand_last_layer kernel does.

#include <math.h>
#include <stdint.h>

#include "common.cuh"

namespace {

constexpr int kThreads = 256;  // 8 rows per block

__global__ void __launch_bounds__(kThreads)
el2n_kernel(const float* __restrict__ logits, const int32_t* __restrict__ labels,
            const float* __restrict__ mask, float* __restrict__ out, int B, int C) {
  const int row = (int)((blockIdx.x * (size_t)kThreads + threadIdx.x) / 32);
  const int lane = threadIdx.x & 31;
  if (row >= B) return;  // whole warps leave together
  const float* z = logits + (size_t)row * C;
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
  if (lane == 0) out[row] = sqrtf(err) * mask[row];
}

}  // namespace

extern "C" {

// logits [B, C] float32, labels [B] int32, mask [B] float32, out [B] float32.
// Returns the launch's cudaError_t (0 = success).
int ddt_el2n(const float* logits, const int32_t* labels, const float* mask, float* out,
             int B, int C, void* stream) {
  if (B < 1 || C < 1) return (int)cudaErrorInvalidValue;
  const int rows_per_block = kThreads / 32;
  const int blocks = (B + rows_per_block - 1) / rows_per_block;
  el2n_kernel<<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      logits, labels, mask, out, B, C);
  return (int)cudaGetLastError();
}

const char* ddt_error_string(int err) { return cudaGetErrorString((cudaError_t)err); }

}  // extern "C"

// EL2N scores: out[b] = || softmax(logits[b]) - onehot(labels[b]) ||_2 * mask[b].
//
// Replaces data_diet_distributed_tpu/ops/pallas_kernels.py:
//   el2n_pallas (:100; body _el2n_kernel :94).
//
// Bound on the card: bytes, and at ResNet-18 geometry (logits [512, 10]) launch latency
// dominates both bounds by far (20 KB of logits against a few microseconds of launch).
// So the design spends nothing outside the one launch: the logits are read in the
// caller's dtype (bf16 or fp32, a template parameter) and the labels as int64 or int32,
// so the wrapper casts nothing first, and each row is read once.
//
// Design. A group of G lanes owns a row (el2n_plan: G = the power of two covering C / 2,
// at most 32; 8 lanes at C = 10, so a warp takes 4 rows and 512 rows take 16 blocks).
// The row streams through the group in tiles of G * V logits (V per lane, a power of
// two, at most 32: one tile up to C = 1024), lane l holding logits l, l + G, ... of a
// tile in registers. Per tile: the group's max, then e = exp(z - max) once per logit,
// the sums S, S_ny and Q_ny of common.cuh (ErrSums) by a butterfly over the group,
// merged into the row's running sums; the error is (Q_ny + S_ny^2) / S^2. Fixed orders,
// no atomics: bit-identical from run to run and wherever the row sits in the batch.
// Left for later: fusing it behind the classifier product would score logits the model
// did not produce, so EL2N stays a kernel of its own.

#include <math.h>
#include <stdint.h>

#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kMaxValues = 32;  // logits a lane holds per tile at most

template <typename T, int V>
__global__ void __launch_bounds__(kThreads)
el2n_kernel(const T* __restrict__ logits, const void* __restrict__ labels, int labels64,
            const float* __restrict__ mask, float* __restrict__ out, int B, int C, int G) {
  const int gid = blockIdx.x * kThreads + threadIdx.x;
  const int row = gid / G, l = gid % G;
  const bool live = row < B;  // a dead group computes a live row's error and drops it,
  const int r = live ? row : B - 1;  // so every lane of the warp reaches the shuffles
  const T* z = logits + (size_t)r * C;
  const int y = label_at(labels, labels64, r);
  ErrSums acc{-INFINITY, 0.f, 0.f, 0.f};
  for (int t0 = 0; t0 < C; t0 += G * V) {
    float v[V];
    float m = -INFINITY;
#pragma unroll
    for (int i = 0; i < V; ++i) {
      const int j = t0 + i * G + l;
      v[i] = j < C ? to_f32(z[j]) : -INFINITY;
      m = fmaxf(m, v[i]);
    }
    for (int off = G >> 1; off > 0; off >>= 1) m = fmaxf(m, __shfl_xor_sync(~0u, m, off));
    float s = 0.f, sn = 0.f, q = 0.f;
#pragma unroll
    for (int i = 0; i < V; ++i) {
      const float e = expf(v[i] - m);
      s += e;
      if (t0 + i * G + l != y) {
        sn += e;
        q = fmaf(e, e, q);
      }
    }
    for (int off = G >> 1; off > 0; off >>= 1) {
      s += __shfl_xor_sync(~0u, s, off);
      sn += __shfl_xor_sync(~0u, sn, off);
      q += __shfl_xor_sync(~0u, q, off);
    }
    acc = err_merge(acc, {m, s, sn, q});
  }
  if (live && l == 0) out[row] = sqrtf(err_sq(acc)) * mask[row];
}

int pow2_at_least(int n) {
  int p = 1;
  while (p < n) p <<= 1;
  return p;
}

template <typename T>
cudaError_t launch(const void* logits, const void* labels, int labels64, const float* mask,
                   float* out, int B, int C, cudaStream_t s) {
  // el2n_plan (kernels.py) mirrors this.
  int G = pow2_at_least((C + 1) / 2);
  G = G < 32 ? G : 32;
  int V = pow2_at_least((C + G - 1) / G);
  V = V < 2 ? 2 : (V > kMaxValues ? kMaxValues : V);
  if ((long long)B * G > 0x7fffffffLL - kThreads) return cudaErrorInvalidValue;
  const int blocks = (int)(((long long)B * G + kThreads - 1) / kThreads);
  auto kernel = V == 2    ? el2n_kernel<T, 2>
                : V == 4  ? el2n_kernel<T, 4>
                : V == 8  ? el2n_kernel<T, 8>
                : V == 16 ? el2n_kernel<T, 16>
                          : el2n_kernel<T, 32>;
  kernel<<<blocks, kThreads, 0, s>>>(static_cast<const T*>(logits), labels, labels64, mask,
                                     out, B, C, G);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// logits [B, C] contiguous, dtype 0 = float32, 1 = bfloat16; labels [B] int64
// (labels64 = 1) or int32; mask [B] float32; out [B] float32.
// Returns the launch's cudaError_t (0 = success).
int ddt_el2n(const void* logits, int dtype, const void* labels, int labels64,
             const float* mask, float* out, int B, int C, void* stream) {
  if (B < 1 || C < 1) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return (int)launch<float>(logits, labels, labels64, mask, out, B, C, s);
  if (dtype == 1) return (int)launch<__nv_bfloat16>(logits, labels, labels64, mask, out, B, C, s);
  return (int)cudaErrorInvalidValue;
}

const char* ddt_error_string(int err) { return cudaGetErrorString((cudaError_t)err); }

}  // extern "C"

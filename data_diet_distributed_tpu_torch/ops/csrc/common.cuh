// Device helpers shared by the port's kernels: element conversions, labels, the softmax
// error's sums and reductions in a fixed order (no atomics), so every kernel built on
// them is bit-identical from run to run.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }

// Sum / max over the 32 lanes of a warp; every lane gets the result.
__device__ __forceinline__ float warp_sum(float v) {
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
  for (int off = 16; off > 0; off >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, off));
  return v;
}

// The label of row `row`: int64 (labels64) or int32, as the caller's tensor holds it.
__device__ __forceinline__ int label_at(const void* labels, int labels64, int row) {
  return labels64 ? (int)static_cast<const long long*>(labels)[row]
                  : static_cast<const int*>(labels)[row];
}

// The softmax error ||softmax(z) - onehot(y)||^2 of a row, kept as four sums over a
// slice of its classes with e_j = exp(z_j - m): the slice's max m, S = sum e_j,
// S_ny = sum_{j != y} e_j and Q_ny = sum_{j != y} e_j^2. Slices merge in a fixed order
// (the second after the first, both rescaled to the larger max), and the error is
// (Q_ny + S_ny^2) / S^2: every term a sum of positives, so no 1 - p_y cancellation on a
// saturated row. {-inf, 0, 0, 0} is the empty slice: merging it first leaves the next
// slice's sums bit for bit.
struct ErrSums {
  float m, s, sn, q;
};

__device__ __forceinline__ ErrSums err_merge(ErrSums a, ErrSums b) {
  const float m = fmaxf(a.m, b.m);
  const float ca = expf(a.m - m), cb = expf(b.m - m);
  return {m, a.s * ca + b.s * cb, a.sn * ca + b.sn * cb, a.q * (ca * ca) + b.q * (cb * cb)};
}

__device__ __forceinline__ float err_sq(ErrSums e) { return (e.q + e.sn * e.sn) / (e.s * e.s); }

// Sum over the block of one float per thread, in a fixed order; `red` holds one float per
// warp. Result valid in thread 0.
__device__ float block_sum(float v, float* red) {
  for (int off = 16; off > 0; off >>= 1) v += __shfl_down_sync(0xffffffffu, v, off);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  __syncthreads();
  if (lane == 0) red[warp] = v;
  __syncthreads();
  float total = 0.f;
  if (threadIdx.x == 0) {
    for (int w = 0; w < (int)(blockDim.x >> 5); ++w) total += red[w];
  }
  return total;
}

}  // namespace

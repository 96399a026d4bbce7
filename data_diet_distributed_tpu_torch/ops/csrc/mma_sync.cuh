// Tensor-core and asynchronous-copy primitives for sm_90a, as inline PTX: 16-byte
// cp.async with zero-fill, ldmatrix (plain and transposing) and mma.sync.m16n8k16 with
// bf16 operands and fp32 accumulation. Shared by every kernel that stages bf16 operands
// in shared memory for the tensor cores (conv_norm_mma.cuh and its kernels,
// conv_grad_norm_gram.cu).

#pragma once

#include <stdint.h>

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

using bf16 = __nv_bfloat16;

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

// 16-byte asynchronous copy; `valid` false zero-fills the destination (src-size 0, the
// source is not read).
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src),
               "r"(valid ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Wait until at most N committed groups are still in flight.
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// 8 bf16 at src, of which the first n are valid (the rest zero), stored to 16 bytes of
// shared memory: the staging path for a channel count that is not a multiple of 8.
__device__ __forceinline__ void store8_scalar(bf16* dst, const bf16* src, int n) {
  const unsigned short* s = reinterpret_cast<const unsigned short*>(src);
  uint32_t w[4];
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const uint32_t lo = 2 * j < n ? s[2 * j] : 0u;
    const uint32_t hi = 2 * j + 1 < n ? s[2 * j + 1] : 0u;
    w[j] = lo | (hi << 16);
  }
  *reinterpret_cast<uint4*>(dst) = make_uint4(w[0], w[1], w[2], w[3]);
}

// 8 channels from src (n of them valid) to 16 bytes of shared memory at dst: cp.async
// when `vec`, else scalar loads.
__device__ __forceinline__ void stage8(bf16* dst, const bf16* src, bool ok, int n, bool vec) {
  if (vec) {
    cp_async16(smem_addr(dst), src, ok);
  } else {
    store8_scalar(dst, src, ok ? n : 0);
  }
}

// Four 8 x 8 bf16 matrices, transposed, from the row addresses of lanes 8i..8i+7.
__device__ __forceinline__ void ldsm_x4_trans(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

// Four 8 x 8 bf16 matrices, as stored, from the row addresses of lanes 8i..8i+7.
__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

// d += a (16 x 16, bf16) * b (16 x 8, bf16), fp32 accumulation.
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

}  // namespace

// Tensor-core tile machinery of the conv weight-gradient-norm kernels: bf16 operands,
// fp32 accumulation, on Hopper's tensor cores through mma.sync (used by the bf16 mode of
// conv_grad_norm_direct.cu).
//
// One warpgroup (4 warps) computes M_o = X_o^T G for a 64 x 64 (C tile x K tile) output
// tile and kMmaOffsets kernel offsets o at once, contracted over output positions s; a
// block holds up to kMmaGroups warpgroups that share its staged operands. Both operands
// are S-major in memory (x is [S, C] with C contiguous, g is [S, K] with K contiguous), so
// both are read with the transposing ldmatrix (.trans) from shared rows of 64 channels
// padded to 72 (144 bytes: the 8 row addresses of one 8 x 8 matrix fall in 8 different
// 16-byte bank groups, so ldmatrix does not serialise).
//
// Tiling: a warpgroup's 4 warps form a 2 x 2 grid, each owning a 32 x 32 piece of the
// tile for each of its offsets (3 offsets x 2 m16 x 4 n8 fragments = 96 fp32 accumulators
// per thread). Per 16 positions a warp loads its g fragments once (2 ldmatrix.x4) and
// reuses them for every offset (2 ldmatrix.x4 and 8 mma.m16n8k16 per offset).
//
// Staging: the output map is cut into chunks of `rows` x `cols` output positions. A
// chunk stages the band of input rows and columns that every offset's window of it
// reads, (rows - 1) * sy + kh rows by (cols - 1) * sx + kw columns (only the sampled
// rows or columns along a kernel dimension of width 1), zero outside the
// input (virtual padding: cp.async with src-size 0, never a padded copy in device
// memory), and its g rows, zero past the map, K or the chunk. The window of offset
// (oy, ox) is the band shifted by oy rows and ox columns, so one staged band serves
// all the block's offsets: x is staged once per chunk instead of once per offset. The
// copies are 16-byte cp.async (8 channels of one position) into a ring of
// kMmaStages buffers, so the next chunk's copies overlap this chunk's MMAs. A C or K
// that is not a multiple of 8 (or a base pointer not 16-byte aligned) is staged by
// scalar loads instead, still for the tensor cores.

#pragma once

#include <stdint.h>

#include "common.cuh"

namespace {

constexpr int kMmaTile = 64;          // C and K tile edge of one block
constexpr int kMmaThreads = 128;      // a warpgroup: 4 warps, 2 x 2 warp tiles of 32 x 32
constexpr int kMmaOffsets = 3;        // kernel offsets one warpgroup accumulates
constexpr int kMmaGroups = 3;         // warpgroups of a block at most (9 offsets)
constexpr int kMmaChunk = 128;        // target output positions of one staged chunk
constexpr int kMmaMaxCols = 32;       // output columns of one chunk at most
constexpr int kMmaStages = 2;         // cp.async ring depth
constexpr int kRowElems = 72;         // shared row: 64 channels + 8 bf16 of padding
constexpr int kRowBytes = kRowElems * 2;
constexpr int kMmaMaxSmem = 113 * 1024;  // dynamic shared memory of a block (half an SM's)

// Staging plan of one layer: chunks of rows x cols output positions. Along a kernel
// dimension of width 1 the band holds only the input lines the stride samples (in_dy
// input rows per band row, one band row per output row); along a wider one it holds
// every input line (one input row per band row, out_dy = stride band rows per output row).
struct MmaPlan {
  int rows, cols;          // output rows and columns of one chunk
  int band_h, band_w;      // staged input band of one chunk
  int in_dy, in_dx;        // input lines per band line
  int out_dy, out_dx;      // band lines per output line
  int g_rows;              // staged cotangent rows: rows * cols rounded up to 16
  int chunks_r, chunks_q;  // chunks down and across the output map
  int stage_rows;          // shared rows of one ring buffer (band + g)
  int smem;                // dynamic shared memory bytes (ring + one zero row)
};

// The plan for an Ho x Wo output map: as close to kMmaChunk positions a chunk as fits
// kMmaMaxSmem, fewer rows first, then fewer columns. False when even one position
// per chunk does not fit (a kernel window of more than about 380 positions).
inline bool mma_plan(int Ho, int Wo, int kh, int kw, int sy, int sx, MmaPlan* p) {
  int cols = Wo < kMmaMaxCols ? Wo : kMmaMaxCols;
  int rows = kMmaChunk / cols;
  if (rows < 1) rows = 1;
  if (rows > Ho) rows = Ho;
  for (;;) {
    const long long band_h = kh == 1 ? rows : (long long)(rows - 1) * sy + kh;
    const long long band_w = kw == 1 ? cols : (long long)(cols - 1) * sx + kw;
    const long long g_rows = ((long long)rows * cols + 15) / 16 * 16;
    const int chunks_r = (Ho + rows - 1) / rows, chunks_q = (Wo + cols - 1) / cols;
    const long long stage_rows = band_h * band_w + g_rows;
    const long long smem = (kMmaStages * stage_rows + 1) * kRowBytes;
    if (smem <= kMmaMaxSmem) {
      *p = MmaPlan{rows, cols, (int)band_h, (int)band_w,
                   kh == 1 ? sy : 1, kw == 1 ? sx : 1, kh == 1 ? 1 : sy, kw == 1 ? 1 : sx,
                   (int)g_rows, chunks_r, chunks_q, (int)stage_rows, (int)smem};
      return true;
    }
    if (rows > 1) {
      --rows;
    } else if (cols > 1) {
      cols = (cols + 1) / 2;
    } else {
      return false;
    }
  }
}

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
__device__ __forceinline__ void store8_scalar(__nv_bfloat16* dst, const __nv_bfloat16* src,
                                              int n) {
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

// Four 8 x 8 bf16 matrices, transposed, from the row addresses of lanes 8i..8i+7.
__device__ __forceinline__ void ldsm_x4_trans(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
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

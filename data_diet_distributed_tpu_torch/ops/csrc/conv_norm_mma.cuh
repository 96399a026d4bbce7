// Tensor-core tile machinery of the conv weight-gradient-norm kernels: bf16 operands,
// fp32 accumulation, on Hopper's tensor cores through mma.sync. One walk of a block over
// its example's C x K tiles (mma_norm_walk) serves three kernels: the bf16 modes of
// conv_grad_norm_direct.cu and of the megakernel's norm role (conv_bwd_grad_norm.cu),
// both through DirectWalk, and of conv_grad_norm_catdot.cu through its own walk.
//
// Replaces no TPU kernel by itself; it is the inner loop of the direct form's
// replacements of data_diet_distributed_tpu/ops/pallas_kernels.py:327, :683 and :488,
// and of the cat-dot form's (:156). Bound on the card: operations (about 290 FLOP per
// byte of x and g at C = K = 64, the bf16 ridge being ~295).
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
// Staging (direct form): the output map is cut into chunks of `rows` x `cols` output
// positions. A chunk stages the band of input rows and columns that every offset's window
// of it reads, (rows - 1) * sy + kh rows by (cols - 1) * sx + kw columns (only the sampled
// rows or columns along a kernel dimension of width 1), zero outside the input (virtual
// padding: cp.async with src-size 0, never a padded copy in device memory), and its g
// rows, zero past the map, K or the chunk. The window of offset (oy, ox) is the band
// shifted by oy rows and ox columns, so one staged band serves all the block's offsets: x
// is staged once per chunk instead of once per offset. The copies are 16-byte cp.async
// (8 channels of one position) into a ring of kMmaStages buffers, so the next chunk's
// copies overlap this chunk's MMAs. A C or K that is not a multiple of 8 (or a base
// pointer not 16-byte aligned) is staged by scalar loads instead, still for the tensor
// cores.
//
// A walk (DirectWalk, or the cat-dot kernel's) tells mma_norm_walk what one block stages
// and where each lane's operand rows lie: the number of tiles and chunks, the staging of
// one chunk, and per 16 positions the row of this lane's A position (then shifted per
// offset) and of its B position, -1 for a row of zeros. Every kernel on this walk writes
// one partial per (block, tile) in a fixed order, summed per example by
// finalize_kernel: no float atomics, bitwise from run to run and on a permuted batch.
// A walk whose B rows are all staged (kBRowsStaged) never yields -1 for B.

#pragma once

#include <stdint.h>

#include "conv_norm_common.cuh"
#include "mma_sync.cuh"

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

// The direct form's launch: a layer's geometry, its plan and its blocks.
struct MmaArgs {
  Geo g;              // g.P = gblocks * ctiles * ktiles partials per example
  MmaPlan p;
  int wgroups;        // warpgroups of a block, one per offset group it owns
  int gblocks;        // blocks per example, each owning wgroups offset groups
  bool vec_x, vec_g;  // stage by 16-byte cp.async (else by scalar loads)
};

// Fill `a` for layer `geo` (its P set to the tensor-core mode's partials per example);
// false when no staging plan fits.
inline bool make_mma_args(const Geo& geo, const void* x, const void* g, MmaArgs* a) {
  if (!mma_plan(geo.Ho, geo.Wo, geo.kh, geo.kw, geo.sy, geo.sx, &a->p)) return false;
  const int groups = (geo.kh * geo.kw + kMmaOffsets - 1) / kMmaOffsets;
  a->wgroups = groups < kMmaGroups ? groups : kMmaGroups;
  a->gblocks = (groups + a->wgroups - 1) / a->wgroups;
  a->g = geo;
  a->g.P = a->gblocks * geo.ctiles * geo.ktiles;
  a->vec_x = geo.C % 8 == 0 && reinterpret_cast<uintptr_t>(x) % 16 == 0;
  a->vec_g = geo.K % 8 == 0 && reinterpret_cast<uintptr_t>(g) % 16 == 0;
  return true;
}

// Stage chunk ci of one direct-form block into the ring buffer at buf: the input band
// (band_h x band_w positions, 64 channels from c0), then the chunk's g rows (64 channels
// from k0). Thread t copies channel group t % 8 of every (blockDim / 8)-th position,
// walking the band's coordinates by increments (no division per copy).
__device__ void stage_chunk(bf16* buf, const bf16* xb, const bf16* gb, const MmaArgs& a,
                            int ci, int c0, int k0) {
  const Geo& g = a.g;
  const MmaPlan& p = a.p;
  const int r0 = (ci / p.chunks_q) * p.rows, q0 = (ci % p.chunks_q) * p.cols;
  const int lane8 = threadIdx.x & 7, step = blockDim.x >> 3;
  const int c = c0 + lane8 * 8, k = k0 + lane8 * 8;

  const int band = p.band_h * p.band_w;
  const int dy = step / p.band_w, dx = step - dy * p.band_w;
  int pos = threadIdx.x >> 3;
  int by = pos / p.band_w, bx = pos - by * p.band_w;
  for (; pos < band; pos += step) {
    const int iy = r0 * g.sy - g.pt + by * p.in_dy, ix = q0 * g.sx - g.pl + bx * p.in_dx;
    const bool ok = iy >= 0 && iy < g.H && ix >= 0 && ix < g.W && c < g.C;
    const bf16* src = xb + (ok ? ((size_t)iy * g.W + ix) * g.C + c : 0);
    stage8(buf + pos * kRowElems + lane8 * 8, src, ok, g.C - c, a.vec_x);
    by += dy;
    bx += dx;
    if (bx >= p.band_w) {
      bx -= p.band_w;
      ++by;
    }
  }

  bf16* gbuf = buf + band * kRowElems;
  const int dr = step / p.cols, dq = step - dr * p.cols;
  int row = threadIdx.x >> 3;
  int rr = row / p.cols, qq = row - rr * p.cols;
  for (; row < p.g_rows; row += step) {
    const bool ok = rr < p.rows && r0 + rr < g.Ho && q0 + qq < g.Wo && k < g.K;
    const bf16* src = gb + (ok ? ((size_t)(r0 + rr) * g.Wo + q0 + qq) * g.K + k : 0);
    stage8(gbuf + row * kRowElems + lane8 * 8, src, ok, g.K - k, a.vec_g);
    rr += dr;
    qq += dq;
    if (qq >= p.cols) {
      qq -= p.cols;
      ++rr;
    }
  }
}

// The direct form's walk for block gblk of example b: warpgroup w owns offsets
// 3 * (gblk * wgroups + w) + {0, 1, 2}; the block walks every C x K tile of the example
// (K tiles fastest), chunk by chunk through one ring. A positions step through the chunk
// as (rr, qq) output coordinates, B rows are the chunk's g rows in order.
struct DirectWalk {
  static constexpr bool kBRowsStaged = true;  // every B row is staged (zero past the map)

  const MmaArgs& a;
  const bf16* xb;
  const bf16* gb;
  int n_off, stage_rows, nch, ntiles;
  int dr, dq;                // (rr, qq) step per 16 positions
  int shift[kMmaOffsets];    // this warpgroup's offsets as shifts of the band

  struct Cursor {
    int steps, nr, nq, rr, qq, b;
  };

  __device__ DirectWalk(const MmaArgs& args, const bf16* x, const bf16* gt, int b, int gblk)
      : a(args),
        xb(x + (size_t)b * args.g.H * args.g.W * args.g.C),
        gb(gt + (size_t)b * args.g.Ho * args.g.Wo * args.g.K) {
    const Geo& g = a.g;
    const MmaPlan& p = a.p;
    // A warpgroup past the last offset computes nothing.
    const int o0 = (gblk * a.wgroups + (threadIdx.x >> 7)) * kMmaOffsets;
    n_off = min(kMmaOffsets, g.kh * g.kw - o0);
#pragma unroll
    for (int j = 0; j < kMmaOffsets; ++j) {
      const int o = min(o0 + j, g.kh * g.kw - 1);
      shift[j] = (o / g.kw) * p.band_w + o % g.kw;
    }
    stage_rows = p.stage_rows;
    nch = p.chunks_r * p.chunks_q;
    ntiles = g.ctiles * g.ktiles;
    dr = 16 / p.cols;
    dq = 16 - dr * p.cols;
  }

  __device__ void stage(bf16* buf, int ci, int tile) const {
    stage_chunk(buf, xb, gb, a, ci, tile / a.g.ktiles * kMmaTile, tile % a.g.ktiles * kMmaTile);
  }

  __device__ Cursor begin(int ci, int a_s, int b_s) const {
    const MmaPlan& p = a.p;
    Cursor c;
    c.nr = min(p.rows, a.g.Ho - ci / p.chunks_q * p.rows);
    c.nq = min(p.cols, a.g.Wo - ci % p.chunks_q * p.cols);
    c.steps = (c.nr * p.cols + 15) / 16;
    c.rr = a_s / p.cols;
    c.qq = a_s - c.rr * p.cols;
    c.b = p.band_h * p.band_w + b_s;
    return c;
  }

  // Band row of this lane's A position at offset shift 0, or -1 outside the chunk.
  __device__ int a_row(const Cursor& c) const {
    return c.rr < c.nr && c.qq < c.nq ? c.rr * a.p.out_dy * a.p.band_w + c.qq * a.p.out_dx
                                      : -1;
  }

  __device__ int b_row(const Cursor& c) const { return c.b; }

  __device__ void next(Cursor& c) const {
    c.rr += dr;
    c.qq += dq;
    if (c.qq >= a.p.cols) {
      c.qq -= a.p.cols;
      ++c.rr;
    }
    c.b += 16;
  }
};

// One block's walk over its tiles on the tensor cores: stage chunk i + 1 while chunk i
// runs through ldmatrix and mma.sync, square and reduce each finished tile in a fixed
// order, and write its partial to part_row[tile] (thread 0). `smem` holds the ring of
// kMmaStages buffers of walk.stage_rows shared rows, then one zero row.
template <class Walk>
__device__ __forceinline__ void mma_norm_walk(const Walk& wk, bf16* smem, float* red,
                                              float* part_row) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int wq = warp & 3;  // quadrant of the 64 x 64 tile

  // One row of zeros after the ring: the operand of positions outside the chunk.
  bf16* zero_row = smem + kMmaStages * wk.stage_rows * kRowElems;
  if (threadIdx.x < kRowBytes / 16)
    reinterpret_cast<uint4*>(zero_row)[threadIdx.x] = make_uint4(0u, 0u, 0u, 0u);

  // ldmatrix row addresses of this lane: lanes 8i..8i+7 address matrix i. A (x^T,
  // 16 channels x 16 positions): matrices (s 0-7, c 0-7), (s 0-7, c 8-15), (s 8-15,
  // c 0-7), (s 8-15, c 8-15). B (g, 16 positions x 16 channels = two n8 fragments):
  // (s 0-7, k 0-7), (s 8-15, k 0-7), (s 0-7, k 8-15), (s 8-15, k 8-15).
  const int mi = lane >> 3, r8 = lane & 7;
  const int a_s = (mi >> 1) * 8 + r8, a_c = (wq & 1) * 32 + (mi & 1) * 8;
  const int b_s = (mi & 1) * 8 + r8, b_k = (wq >> 1) * 32 + (mi >> 1) * 8;
  const uint32_t zero_a = smem_addr(zero_row + a_c), zero_b = smem_addr(zero_row + b_k);

  float acc[kMmaOffsets][2][4][4] = {};
  const int nch = wk.nch, nsteps = wk.ntiles * nch;
  // Step i stages chunk i % nch of tile i / nch into ring buffer i % kMmaStages.
  auto stage = [&](int i) {
    wk.stage(smem + i % kMmaStages * wk.stage_rows * kRowElems, i % nch, i / nch);
    cp_async_commit();
  };
  stage(0);
  for (int i = 0; i < nsteps; ++i) {
    const int ci = i % nch;
    if (i + 1 < nsteps) {
      stage(i + 1);
    } else {
      cp_async_commit();  // an empty group keeps the wait below uniform
    }
    cp_async_wait<1>();  // step i has landed; step i + 1 may still be in flight
    __syncthreads();
    if (wk.n_off > 0) {
      const uint32_t buf = smem_addr(smem + i % kMmaStages * wk.stage_rows * kRowElems);
      typename Walk::Cursor cur = wk.begin(ci, a_s, b_s);
      for (int t = 0; t < cur.steps; ++t) {
        uint32_t bfr[2][4];
        const int brow = wk.b_row(cur);
        const uint32_t ga = Walk::kBRowsStaged || brow >= 0
                                ? buf + (brow * kRowElems + b_k) * 2 : zero_b;
        ldsm_x4_trans(bfr[0], ga);
        ldsm_x4_trans(bfr[1], ga + 32);
        const int arow = wk.a_row(cur);
#pragma unroll
        for (int j = 0; j < kMmaOffsets; ++j) {
          if (j < wk.n_off) {
            const uint32_t aa =
                arow >= 0 ? buf + ((arow + wk.shift[j]) * kRowElems + a_c) * 2 : zero_a;
            uint32_t afr[2][4];
            ldsm_x4_trans(afr[0], aa);
            ldsm_x4_trans(afr[1], aa + 32);
#pragma unroll
            for (int mt = 0; mt < 2; ++mt)
#pragma unroll
              for (int nt = 0; nt < 4; ++nt)
                mma_bf16(acc[j][mt][nt], afr[mt], bfr[nt >> 1][(nt & 1) * 2],
                         bfr[nt >> 1][(nt & 1) * 2 + 1]);
          }
        }
        wk.next(cur);
      }
    }
    __syncthreads();  // the buffer is consumed before the next iteration refills it
    if (ci == nch - 1) {  // the tile is done: square, reduce, write, start the next
      float v = 0.f;
#pragma unroll
      for (int j = 0; j < kMmaOffsets; ++j)
#pragma unroll
        for (int mt = 0; mt < 2; ++mt)
#pragma unroll
          for (int nt = 0; nt < 4; ++nt)
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              v = fmaf(acc[j][mt][nt][e], acc[j][mt][nt][e], v);
              acc[j][mt][nt][e] = 0.f;
            }
      const float part = block_sum(v, red);
      if (threadIdx.x == 0) part_row[i / nch] = part;
    }
  }
}

}  // namespace

// Conv backward and weight-gradient norm in ONE launch (the "megakernel"), unit stride.
//
// Replaces data_diet_distributed_tpu/ops/pallas_kernels.py:
//   conv_bwd_grad_norm_sq_pallas (:488; body _conv_bwd_norm_kernel :423).
//
// For a unit-stride conv with input x [B, H, W, C], output cotangent g [B, Ho, Wo, K],
// weight w (read as [K, kh, kw, C]: the channels_last memory of PyTorch's [K, C, kh, kw])
// and top / left padding (pt, pl), one launch writes
//   dx[b, y, x, c] = sum_{oy, ox, k} g[b, y + pt - oy, x + pl - ox, k] * w[k, oy, ox, c]
//                    (the conv's input cotangent, zero where the g index falls outside;
//                     fp32 accumulation, stored in x's dtype), and
//   out[b] = sum_o || sum_s x[b, s + o] g[b, s] ||_F^2  (+ sum_k (sum_s g[b, s, k])^2)
//                    (the per-example weight-gradient norm, as conv_grad_norm_direct.cu).
//
// Bound on the card: operations, 2 * B * S * kh*kw * C * K FLOPs for each half (about
// 290 FLOP per byte of x, g and dx at C = K = 64 in bf16, near the ridge, more at wider
// layers). The TPU kernel shares one VMEM residency of the g tile between the halves;
// here the norm reduces over all positions of an example while dx tiles reduce over K,
// so the two loop orders conflict and each role reads g itself, through the 50 MB L2.
// The blocks of the one launch split into two roles, norm blocks first in the grid.
//
// Two modes, chosen by the dtype of x and g; the wrapper counts each launch under its mode.
//
// bf16: tensor cores (bwd_norm_mma_kernel, 384 threads a block).
// - Norm role: blocks [0, B * gblocks) run the direct kernel's tensor-core walk
//   (DirectWalk and mma_norm_walk in conv_norm_mma.cuh, the same code): a block per
//   (example, group of up to 3 offset groups), one staged input band per chunk shared by
//   its offsets, walking every 64 x 64 C x K tile, one partial per (block, tile) to a
//   [B, P] buffer that finalize_kernel sums per example in a fixed order (the bias term
//   last). Its norm is the direct kernel's to the bit.
// - dx role: an implicit GEMM, dx tile [positions, 64 C] = sum over (offset, K) of
//   g window [positions, K] x w[K, 64 C], on mma.sync.m16n8k16 (bf16 -> fp32). A dx block
//   holds three tiles of rows x cols input positions (64 or 128, one per warpgroup) for
//   one 64-channel C tile, and walks K in chunks of 16 through a 2-deep cp.async ring.
//   Per chunk it stages, for each warpgroup, ONE band of g with a (kh - 1, kw - 1) halo,
//   zero outside the map (virtual padding by cp.async zero-fill), so every offset's
//   window is a shift of the band, read by ldmatrix as stored; and the weight slice
//   [kh*kw offsets, 16 K, 64 C] that the three tiles share, read by ldmatrix.trans. Each
//   warp owns 32 positions x 64 channels (32 x 32 on 64-position tiles; up to 64 fp32
//   accumulators) and sums every offset and K chunk into them in one fixed order.
// - The weight stays fp32 in effect: the JAX kernel and the plain version contract the
//   bf16 g with the fp32 weight, and one bf16 pass of a rounded weight errs by about
//   2^-9 of the sum's scale per element, beyond the 1e-5 * max|dx| floor of the dx check.
//   The wrapper splits the weight once per launch (an elementwise op in PyTorch) into
//   w_hi = bf16(w) and w_lo = bf16(w - w_hi), stacked as [2, K, kh, kw, C], and the
//   kernel issues both MMAs: bf16 x bf16 products are exact in fp32 and the pair carries
//   ~16 mantissa bits (an error of ~2^-17 of the scale). The second MMA is this design's
//   own cost; the bound counts the function's FLOPs only.
//
// fp32: CUDA cores (bwd_norm_kernel, 256 threads a block; the fp32 tiles of
// conv_norm_common.cuh). Blocks [0, B) each compute one example's whole norm (every
// offset and C x K tile in turn, summed per thread and over the block in a fixed order);
// the blocks after them each compute one 64-position x 64-channel tile of dx, contracting
// over K in 32-channel chunks for every offset. fp32 stays on the CUDA cores because the
// parity mode that runs it holds the kernel within 1e-4 of an fp32 reference with TF32
// off: TF32 products keep 10 mantissa bits and would not meet that.
//
// Both modes: no float atomics and no split of a norm's S across blocks without a
// fixed-order sum, so a launch is bit-identical from run to run and an example's dx and
// norm do not depend on where it sits in the batch.

#include <limits.h>

#include "conv_norm_common.cuh"
#include "conv_norm_mma.cuh"

namespace {

// ------------------------------------------------------------------- fp32 mode

// Row stride of the staged g window of a dx block ([32 k][64 positions]): a multiple of 4
// for the float4 reads, padded to spread the column-wise stores over more banks.
constexpr int kGStride = kTile + 4;

__device__ void norm_role(const float* __restrict__ x, const float* __restrict__ gt,
                          float* __restrict__ out, const Geo& g, int use_bias, float* sx,
                          float* sg, float* red) {
  const int b = blockIdx.x;
  const int tc = threadIdx.x % 16, tk = threadIdx.x / 16;
  const int S = g.Ho * g.Wo;
  const float* xb = x + (size_t)b * g.H * g.W * g.C;
  const float* gb = gt + (size_t)b * S * g.K;
  float v = 0.f;
  for (int o = 0; o < g.kh * g.kw; ++o) {
    const int oy = o / g.kw, ox = o % g.kw;
    for (int ct = 0; ct < g.ctiles; ++ct) {
      for (int kt = 0; kt < g.ktiles; ++kt) {
        float acc[4][4] = {};
        for (int s0 = 0; s0 < S; s0 += kChunk) {
          __syncthreads();  // previous chunk consumed
          load_x_chunk(sx, xb, g, s0, oy, ox, ct * kTile);
          load_g_rows(sg, gb, g, s0, kChunk, kt * kTile);
          __syncthreads();
          accumulate(acc, sx, sg, tc, tk);
        }
        v += tile_sq(acc);
      }
    }
  }
  if (use_bias) v = add_bias_term_share(v, gb, S, g.K);
  const float total = block_sum(v, red);
  if (threadIdx.x == 0) out[b] = total;
}

__device__ void dx_role(int tile, const float* __restrict__ gt, const float* __restrict__ w,
                        float* __restrict__ dx, const Geo& g, int ptiles, float* sg, float* sw) {
  const int HW = g.H * g.W;
  const int b = tile / (ptiles * g.ctiles), rem = tile % (ptiles * g.ctiles);
  const int p0 = (rem / g.ctiles) * kTile, c0 = (rem % g.ctiles) * kTile;
  const int tc = threadIdx.x % 16, tp = threadIdx.x / 16;
  const float* gb = gt + (size_t)b * g.Ho * g.Wo * g.K;
  float acc[4][4] = {};  // acc[i][j]: channel c0 + tc*4 + i at position p0 + tp*4 + j
  for (int o = 0; o < g.kh * g.kw; ++o) {
    const int oy = o / g.kw, ox = o % g.kw;
    for (int k0 = 0; k0 < g.K; k0 += kChunk) {
      __syncthreads();  // previous chunk consumed
      // sg[kk][pp] = g[b, y + pt - oy, x + pl - ox, k0 + kk] at position p0 + pp = y*W + x.
      for (int i = threadIdx.x; i < kChunk * kTile; i += kThreads) {
        const int kk = i % kChunk, pp = i / kChunk;
        const int p = p0 + pp, k = k0 + kk;
        float v = 0.f;
        if (p < HW && k < g.K) {
          const int r = p / g.W + g.pt - oy, q = p % g.W + g.pl - ox;
          if (r >= 0 && r < g.Ho && q >= 0 && q < g.Wo)
            v = gb[((size_t)r * g.Wo + q) * g.K + k];
        }
        sg[kk * kGStride + pp] = v;
      }
      // sw[kk][cc] = w[k0 + kk, oy, ox, c0 + cc].
      for (int i = threadIdx.x; i < kChunk * kTile; i += kThreads) {
        const int kk = i / kTile, cc = i % kTile;
        const int k = k0 + kk, c = c0 + cc;
        sw[i] = (k < g.K && c < g.C)
                    ? w[(((size_t)k * g.kh + oy) * g.kw + ox) * g.C + c] : 0.f;
      }
      __syncthreads();
      accumulate<kTile, kGStride>(acc, sw, sg, tc, tp);
    }
  }
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int p = p0 + tp * 4 + j;
    if (p >= HW) continue;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int c = c0 + tc * 4 + i;
      if (c < g.C) dx[((size_t)b * HW + p) * g.C + c] = acc[i][j];
    }
  }
}

// grid: B norm blocks, then B * ptiles * ctiles dx blocks.
__global__ void __launch_bounds__(kThreads)
bwd_norm_kernel(const float* __restrict__ x, const float* __restrict__ gt,
                const float* __restrict__ w, float* __restrict__ dx, float* __restrict__ out,
                Geo g, int ptiles, int use_bias) {
  __shared__ __align__(16) float sa[kChunk * kGStride];
  __shared__ __align__(16) float sb[kChunk * kTile];
  __shared__ float red[kThreads / 32];
  if ((int)blockIdx.x < g.B)
    norm_role(x, gt, out, g, use_bias, sa, sb, red);
  else
    dx_role((int)blockIdx.x - g.B, gt, w, dx, g, ptiles, sa, sb);
}

// ------------------------------------------------------------ bf16 tensor-core mode

constexpr int kDxK = 16;              // K channels of one dx ring buffer (one k16 MMA step)
constexpr int kDxRowElems = 24;       // shared g row: 16 channels + 8 bf16 of padding (48 B)
constexpr int kDxMaxCols = 32;        // input columns of one dx tile at most
constexpr int kDxMaxSmem = 200 * 1024;  // dynamic shared memory of the dx role at most

// Tiling of the dx role: each warpgroup owns one tile of rows x cols input positions (at
// most 64 * mt) of one example and one 64-channel C tile; a block holds kMmaGroups tiles
// of one C tile. A ring buffer holds the hi/lo weight rows of one K chunk, [2][kh*kw]
// [kDxK] rows of 64 channels (kRowElems, read transposed: 144-byte rows spread the 8 row
// addresses of a matrix over all banks), then each warpgroup's g band of band_h x band_w
// positions and kDxK channels (48-byte rows: 8 consecutive ones fall in 8 different
// 16-byte bank groups).
struct DxPlan {
  int mt;              // tile positions / 64: 2 (128 positions) or 1 (64, maps of <= 64)
  int rows, cols;      // input rows and columns of one tile
  int band_h, band_w;  // staged g band of one tile: rows + kh - 1 by cols + kw - 1
  int tiles_q, ptiles; // tiles across the map, tiles per example
  int bpc;             // dx blocks per C tile
  int w_rows;          // weight rows of one ring buffer: 2 * kh * kw * kDxK
  int stage_elems;     // bf16 elements of one ring buffer
  int smem;            // dynamic shared memory bytes (ring + one zero row)
};

// The dx plan for an H x W input map: tiles of 128 positions (64 for maps of at most 64)
// as wide as kDxMaxCols, fewer rows, then fewer columns, until the ring fits kDxMaxSmem.
// False when even one position does not fit (a kernel of more than about 13 offsets) or
// the grid would outgrow CUDA's limit.
inline bool dx_plan(int B, int H, int W, int kh, int kw, DxPlan* d) {
  const int mt = (long long)H * W > 64 ? 2 : 1;
  int cols = W < kDxMaxCols ? W : kDxMaxCols;
  int rows = 64 * mt / cols;
  if (rows < 1) rows = 1;
  if (rows > H) rows = H;
  for (;;) {
    const long long band_h = rows + kh - 1, band_w = cols + kw - 1;
    const long long w_rows = 2LL * kh * kw * kDxK;
    const long long stage = w_rows * kRowElems + kMmaGroups * band_h * band_w * kDxRowElems;
    const long long smem = (kMmaStages * stage + kRowElems) * 2;
    if (smem <= kDxMaxSmem) {
      const int tiles_q = (W + cols - 1) / cols;
      const long long ptiles = (long long)((H + rows - 1) / rows) * tiles_q;
      const long long bpc = ((long long)B * ptiles + kMmaGroups - 1) / kMmaGroups;
      if ((long long)B * ptiles > INT_MAX) return false;
      *d = DxPlan{mt, rows, cols, (int)band_h, (int)band_w, tiles_q, (int)ptiles, (int)bpc,
                  (int)w_rows, (int)stage, (int)smem};
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

struct MegaArgs {
  MmaArgs n;   // the norm role: the direct form's walk at unit stride
  DxPlan d;    // the dx role
  bool vec_w;  // weights staged by 16-byte cp.async (C % 8 == 0, aligned)
};

// Stage K chunk i of a dx block into the ring buffer at buf: the hi/lo weight rows of C
// tile c0 (thread t copies channel group t % 8 of every 48th row), then this warpgroup's
// g band around its tile at (y0, x0) of example b (thread t of the warpgroup copies
// channel half t % 2 of every 64th position), zero outside the map.
__device__ void dx_stage(bf16* buf, int i, const bf16* gt, const bf16* w2, const MegaArgs& a,
                         int c0, int b, int y0, int x0, bool active) {
  const Geo& g = a.n.g;
  const DxPlan& d = a.d;
  const int kk = g.kh * g.kw, k0 = i * kDxK;
  for (int idx = threadIdx.x; idx < d.w_rows * 8; idx += blockDim.x) {
    const int r = idx >> 3, j = idx & 7;
    const int hk = r / kDxK, kr = r - hk * kDxK;  // hk = hi/lo * kk + offset
    const int h = hk / kk, o = hk - h * kk;
    const int k = k0 + kr, c = c0 + j * 8;
    const bool ok = k < g.K && c < g.C;
    const bf16* src = w2 + (ok ? (((size_t)h * g.K + k) * kk + o) * g.C + c : 0);
    stage8(buf + r * kRowElems + j * 8, src, ok, g.C - c, a.vec_w);
  }
  const int band = d.band_h * d.band_w;
  bf16* gbuf = buf + d.w_rows * kRowElems + (threadIdx.x >> 7) * band * kDxRowElems;
  const int t = threadIdx.x & (kMmaThreads - 1), half = t & 1, k = k0 + half * 8;
  const bf16* gb = gt + (size_t)b * g.Ho * g.Wo * g.K;
  for (int pos = t >> 1; pos < band; pos += kMmaThreads / 2) {
    const int by = pos / d.band_w, bx = pos - by * d.band_w;
    const int gy = y0 + g.pt - (g.kh - 1) + by, gx = x0 + g.pl - (g.kw - 1) + bx;
    const bool ok = active && gy >= 0 && gy < g.Ho && gx >= 0 && gx < g.Wo && k < g.K;
    const bf16* src = gb + (ok ? ((size_t)gy * g.Wo + gx) * g.K + k : 0);
    stage8(gbuf + pos * kDxRowElems + half * 8, src, ok, g.K - k, a.n.vec_g);
  }
}

// dx block blk: C tile blk / bpc, tiles 3 * (blk % bpc) + {0, 1, 2} of that C tile in
// example-major order, one per warpgroup (a warpgroup past the last tile stages and
// computes nothing but keeps the block's barriers).
__device__ void dx_mma_role(int blk, const bf16* __restrict__ gt, const bf16* __restrict__ w2,
                            bf16* __restrict__ dx, const MegaArgs& a, bf16* smem) {
  const Geo& g = a.n.g;
  const DxPlan& d = a.d;
  const int kk = g.kh * g.kw;
  const int c0 = blk / d.bpc * kMmaTile;
  const int unit = blk % d.bpc * kMmaGroups + (threadIdx.x >> 7);
  const bool active = unit < g.B * d.ptiles;
  const int b = active ? unit / d.ptiles : 0, tile = active ? unit - b * d.ptiles : 0;
  const int y0 = tile / d.tiles_q * d.rows, x0 = tile % d.tiles_q * d.cols;
  const int nr = min(d.rows, g.H - y0), nq = min(d.cols, g.W - x0);

  const int lane = threadIdx.x & 31, wq = (threadIdx.x >> 5) & 3;
  bf16* zero_row = smem + kMmaStages * d.stage_elems;
  if (threadIdx.x < kRowBytes / 16)
    reinterpret_cast<uint4*>(zero_row)[threadIdx.x] = make_uint4(0u, 0u, 0u, 0u);

  // Each warp owns 32 positions (2 m16 fragments): on a 128-position tile positions
  // [32 wq, +32) and all 64 channels (8 n8 fragments); on a 64-position tile positions
  // [32 (wq % 2), +32) and channels [32 (wq / 2), +32) (4 n8 fragments), so no warp
  // loads weight fragments for positions it does not have.
  const bool wide = d.mt == 2;
  const int p0 = wide ? wq * 32 : (wq & 1) * 32, n0 = wide ? 0 : (wq >> 1) * 32;
  const int nfr = wide ? 8 : 4;
  // ldmatrix row addresses of this lane: lanes 8i..8i+7 address matrix i. A (g window,
  // 16 positions x 16 K channels, as stored): matrices (s 0-7, k 0-7), (s 8-15, k 0-7),
  // (s 0-7, k 8-15), (s 8-15, k 8-15). B (weights, 16 K x 16 C, transposed): (k 0-7,
  // c 0-7), (k 8-15, c 0-7), (k 0-7, c 8-15), (k 8-15, c 8-15).
  const int mi = lane >> 3, r8 = lane & 7;
  const int a_k = (mi >> 1) * 8, w_k = (mi & 1) * 8 + r8, w_c = n0 + (mi >> 1) * 8;
  int apos[2];  // band position of this lane's A row at offset shift 0, -1 outside the tile
#pragma unroll
  for (int mt = 0; mt < 2; ++mt) {
    const int s = p0 + mt * 16 + (mi & 1) * 8 + r8;
    const int r = s / d.cols, q = s - r * d.cols;
    apos[mt] = r < nr && q < nq ? r * d.band_w + q : -1;
  }
  const uint32_t zero_addr = smem_addr(zero_row + a_k);
  const int band = d.band_h * d.band_w;

  float acc[2][8][4] = {};
  const int nsteps = (g.K + kDxK - 1) / kDxK;
  auto stage = [&](int i) {
    dx_stage(smem + i % kMmaStages * d.stage_elems, i, gt, w2, a, c0, b, y0, x0, active);
    cp_async_commit();
  };
  stage(0);
  for (int i = 0; i < nsteps; ++i) {
    if (i + 1 < nsteps) {
      stage(i + 1);
    } else {
      cp_async_commit();  // an empty group keeps the wait below uniform
    }
    cp_async_wait<1>();
    __syncthreads();
    if (active) {
      const bf16* buf = smem + i % kMmaStages * d.stage_elems;
      const uint32_t w_addr = smem_addr(buf + w_k * kRowElems + w_c);
      const uint32_t band_addr =
          smem_addr(buf + d.w_rows * kRowElems + (threadIdx.x >> 7) * band * kDxRowElems + a_k);
      for (int o = 0; o < kk; ++o) {
        const int oy = o / g.kw, ox = o - oy * g.kw;
        const int shift = (g.kh - 1 - oy) * d.band_w + (g.kw - 1 - ox);
        uint32_t afr[2][4];
#pragma unroll
        for (int mt = 0; mt < 2; ++mt)
          ldsm_x4(afr[mt], apos[mt] >= 0
                               ? band_addr + (apos[mt] + shift) * (kDxRowElems * 2)
                               : zero_addr);
#pragma unroll
        for (int h = 0; h < 2; ++h) {  // w_hi, then w_lo
          uint32_t bfr[4][4];
          const uint32_t wa = w_addr + (h * kk + o) * (kDxK * kRowBytes);
#pragma unroll
          for (int j = 0; j < 4; ++j)
            if (2 * j < nfr) ldsm_x4_trans(bfr[j], wa + j * 32);
#pragma unroll
          for (int mt = 0; mt < 2; ++mt)
#pragma unroll
            for (int nt = 0; nt < 8; ++nt)
              if (nt < nfr)
                mma_bf16(acc[mt][nt], afr[mt], bfr[nt >> 1][(nt & 1) * 2],
                         bfr[nt >> 1][(nt & 1) * 2 + 1]);
        }
      }
    }
    __syncthreads();  // the buffer is consumed before the next iteration refills it
  }
  if (!active) return;
  // Accumulator e of fragment (mt, nt): position row (lane / 4) + 8 * (e / 2), channel
  // nt * 8 + 2 * (lane % 4) + e % 2.
#pragma unroll
  for (int mt = 0; mt < 2; ++mt) {
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int s = p0 + mt * 16 + (lane >> 2) + half * 8;
      const int r = s / d.cols, q = s - r * d.cols;
      if (r >= nr || q >= nq) continue;
      bf16* row = dx + (((size_t)b * g.H + y0 + r) * g.W + x0 + q) * g.C;
#pragma unroll
      for (int nt = 0; nt < 8; ++nt) {
        if (nt >= nfr) continue;
        const int c = c0 + n0 + nt * 8 + (lane & 3) * 2;
        const float v0 = acc[mt][nt][half * 2], v1 = acc[mt][nt][half * 2 + 1];
        if (c + 1 < g.C && (g.C & 1) == 0) {
          *reinterpret_cast<__nv_bfloat162*>(row + c) = __floats2bfloat162_rn(v0, v1);
        } else {
          if (c < g.C) row[c] = __float2bfloat16(v0);
          if (c + 1 < g.C) row[c + 1] = __float2bfloat16(v1);
        }
      }
    }
  }
}

// grid: B * gblocks norm blocks (example-major), then ctiles * bpc dx blocks.
__global__ void __launch_bounds__(kMmaThreads * kMmaGroups)
bwd_norm_mma_kernel(const bf16* __restrict__ x, const bf16* __restrict__ gt,
                    const bf16* __restrict__ w2, bf16* __restrict__ dx,
                    float* __restrict__ partials, MegaArgs a) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __shared__ float red[kMmaThreads * kMmaGroups / 32];
  bf16* smem = reinterpret_cast<bf16*>(smem_raw);
  const int norm_blocks = a.n.g.B * a.n.gblocks;
  if ((int)blockIdx.x < norm_blocks) {
    const int b = blockIdx.x / a.n.gblocks, gblk = blockIdx.x % a.n.gblocks;
    const DirectWalk wk(a.n, x, gt, b, gblk);
    mma_norm_walk(wk, smem, red, partials + (size_t)b * a.n.g.P + gblk * wk.ntiles);
  } else {
    dx_mma_role((int)blockIdx.x - norm_blocks, gt, w2, dx, a, smem);
  }
}

cudaError_t launch_mma(const bf16* x, const bf16* gt, const bf16* w2, bf16* dx,
                       float* partials, float* out, const MegaArgs& a, int use_bias,
                       cudaStream_t stream) {
  const int smem = a.n.p.smem > a.d.smem ? a.n.p.smem : a.d.smem;
  cudaError_t err = cudaFuncSetAttribute(
      bwd_norm_mma_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const int blocks = a.n.g.B * a.n.gblocks + a.n.g.ctiles * a.d.bpc;
  bwd_norm_mma_kernel<<<blocks, kMmaThreads * kMmaGroups, smem, stream>>>(x, gt, w2, dx,
                                                                         partials, a);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  finalize_kernel<bf16><<<a.n.g.B, kThreads, 0, stream>>>(
      partials, gt, out, a.n.g.P, a.n.g.Ho * a.n.g.Wo, a.n.g.K, use_bias);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Unit-stride conv: x [B, H, W, C] and g [B, Ho, Wo, K] NHWC in one dtype, dx [B, H, W, C]
// in x's dtype, out [B] float32.
// dtype 0 = float32 (CUDA-core mode): w is the float32 weight [K, kh, kw, C]; partials is
//   unused and P must be 0.
// dtype 1 = bfloat16 (tensor-core mode): w is [2, K, kh, kw, C] bfloat16 (w_hi, w_lo);
//   `partials` holds B * P floats, P = ceil(G / min(G, 3)) * ceil(C / 64) * ceil(K / 64)
//   with G = ceil(kh * kw / 3) offset groups (the direct kernel's tensor-core P).
// Returns the launch's cudaError_t (0 = success).
int ddt_conv_bwd_grad_norm(const void* x, const void* g, const void* w, void* dx,
                           float* partials, float* out, int dtype, int B, int H, int W,
                           int C, int Ho, int Wo, int K, int kh, int kw, int pt, int pl,
                           int P, int use_bias, void* stream) {
  Geo geo{B, H, W, C, Ho, Wo, K, kh, kw, 1, 1, pt, pl,
          (C + kTile - 1) / kTile, (K + kTile - 1) / kTile, 0};
  if (B < 1 || H < 1 || W < 1 || C < 1 || Ho < 1 || Wo < 1 || K < 1 || kh < 1 || kw < 1)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    const int ptiles = (H * W + kTile - 1) / kTile;
    const long long blocks = (long long)B * (1 + (long long)ptiles * geo.ctiles);
    if (P != 0 || blocks > INT_MAX) return (int)cudaErrorInvalidValue;
    bwd_norm_kernel<<<(unsigned)blocks, kThreads, 0, s>>>(
        static_cast<const float*>(x), static_cast<const float*>(g),
        static_cast<const float*>(w), static_cast<float*>(dx), out, geo, ptiles, use_bias);
    return (int)cudaGetLastError();
  }
  if (dtype == 1) {
    MegaArgs a{};
    if (!make_mma_args(geo, x, g, &a.n) || !dx_plan(B, H, W, kh, kw, &a.d))
      return (int)cudaErrorInvalidValue;
    const long long blocks =
        (long long)B * a.n.gblocks + (long long)geo.ctiles * a.d.bpc;
    if (P != a.n.g.P || blocks > INT_MAX) return (int)cudaErrorInvalidValue;
    a.vec_w = C % 8 == 0 && reinterpret_cast<uintptr_t>(w) % 16 == 0;
    return (int)launch_mma(static_cast<const bf16*>(x), static_cast<const bf16*>(g),
                           static_cast<const bf16*>(w), static_cast<bf16*>(dx), partials,
                           out, a, use_bias, s);
  }
  return (int)cudaErrorInvalidValue;
}

const char* ddt_error_string(int err) { return cudaGetErrorString((cudaError_t)err); }

}  // extern "C"

// Per-example squared Frobenius norm of a unit-stride conv layer's weight gradient,
// "cat-dot" form: every kernel offset's [C, K] block from ONE product per example.
//
// Replaces data_diet_distributed_tpu/ops/pallas_kernels.py:
//   _conv_norm_catdot_kernel (:156), reached through conv_grad_norm_sq_pallas (:327)
//   with catdot=True.
//
// With Wp = Wo + kw - 1 columns of (virtually) padded input and S' = Ho * Wp positions,
//   A[(r, w), (oy, c)] = x[b, r + oy - pt, w - pl, c]     (kh row-shifted windows of x),
//   G[(r, w), (ox, k)] = g[b, r, w - ox, k]               (kw column-shifted copies of g,
//                                                          zero outside 0 <= w - ox < Wo),
// and (A^T G)[(oy, c), (ox, k)] = sum_{r, q} x[r + oy - pt, q + ox - pl, c] g[r, q, k] is
// exactly offset (oy, ox)'s block M_o of the per-example weight gradient, so
//   out[b] = || A^T G ||_F^2   (the bias term is the caller's, as on the TPU).
// A and G are never built: both are index arithmetic in the loads, zero outside the
// input (virtual padding, no copies in device memory).
//
// Bound on the card: operations, those of the function (2 * Ho*Wo * kh*kw * C*K FLOPs per
// example, the same as the direct form) against (H*W*C + Ho*Wo*K) elements read; the
// Wp - Wo zero columns of G (~12 % more work at ResNet-18's 16 x 16 maps) are this
// design's own cost. On the TPU one wide dot filled the 128 x 128 MXU where the
// per-offset dots did not; on Hopper the product's 64 x 64 tiles are what the tensor
// cores take either way.
//
// Two modes, chosen by the dtype of x and g; the wrapper counts each launch under its mode.
//
// bf16: tensor cores (catdot_mma_kernel on mma_norm_walk of conv_norm_mma.cuh, the
// direct kernel's loop). The product's 64 x 64 tile at rows (oy, C tile) and columns
// (ox, K tile) is offset (oy, ox)'s block, so a block owns one example, one warpgroup per
// column shift ox (each accumulating up to 3 row shifts oy), and walks every (C tile,
// K tile) pair through one 2-deep cp.async ring. Per chunk of rows x cols positions of the
// padded Ho x Wp grid it stages ONE x band of the rows + kh - 1 rows the row shifts read
// and ONE g band of the chunk's rows with a (kw - 1)-column halo, zero outside the maps:
// each lane addresses its shifted operand rows for ldmatrix.trans itself (a row shift of
// the x band, a column shift of the g band, a zero row where an index falls outside), so
// neither operand is restaged per offset or per tile from device memory but once per
// chunk from the 50 MB L2. One partial per (block, tile) in a fixed order, summed per
// example by finalize_kernel.
//
// fp32: CUDA cores (catdot_kernel; the fp32 tiles of conv_norm_common.cuh). One block owns
// one 64 x 64 tile of the [kh*C, kw*K] product for one example, streams 32-position
// chunks of S' through 16 KB of shared memory and writes its tile's sum of squares to the
// partials buffer. fp32 stays on the CUDA cores because the parity mode that runs it holds
// the kernel within 1e-4 of an fp32 reference with TF32 off: TF32 products keep 10
// mantissa bits and would not meet that.
//
// Both modes: no float atomics, bit-identical from run to run and independent of the
// example's place in the batch.

#include <limits.h>

#include "conv_norm_common.cuh"
#include "conv_norm_mma.cuh"

namespace {

struct CatGeo {
  int B, H, W, C, Ho, Wo, K;
  int kh, kw, pt, pl;
  int Wp, qtiles, P;  // padded width, column tiles of the [kh*C, kw*K] product, partials
};

// ------------------------------------------------------------------- fp32 mode

// grid: (B, P); tile t = blockIdx.y covers rows [64 * (t / qtiles), +64) of kh*C and
// columns [64 * (t % qtiles), +64) of kw*K.
__global__ void __launch_bounds__(kThreads)
catdot_kernel(const float* __restrict__ x, const float* __restrict__ gt,
              float* __restrict__ partials, CatGeo g) {
  __shared__ __align__(16) float as[kChunk * kTile];
  __shared__ __align__(16) float gs[kChunk * kTile];
  __shared__ float red[kThreads / 32];

  const int b = blockIdx.x;
  const int r0 = (blockIdx.y / g.qtiles) * kTile, q0 = (blockIdx.y % g.qtiles) * kTile;
  const int ta = threadIdx.x % 16, tb = threadIdx.x / 16;
  const int Sp = g.Ho * g.Wp, rows = g.kh * g.C, cols = g.kw * g.K;
  const float* xb = x + (size_t)b * g.H * g.W * g.C;
  const float* gb = gt + (size_t)b * g.Ho * g.Wo * g.K;

  float acc[4][4] = {};
  for (int s0 = 0; s0 < Sp; s0 += kChunk) {
    __syncthreads();  // previous chunk consumed
    for (int i = threadIdx.x; i < kChunk * kTile; i += kThreads) {
      const int s = s0 + i / kTile, j = i % kTile;
      const int r = s / g.Wp, w = s % g.Wp;
      float va = 0.f, vg = 0.f;
      if (s < Sp) {
        const int row = r0 + j;
        if (row < rows) {
          const int iy = r + row / g.C - g.pt, ix = w - g.pl;
          if (iy >= 0 && iy < g.H && ix >= 0 && ix < g.W)
            va = xb[((size_t)iy * g.W + ix) * g.C + row % g.C];
        }
        const int col = q0 + j;
        if (col < cols) {
          const int q = w - col / g.K;
          if (q >= 0 && q < g.Wo) vg = gb[((size_t)r * g.Wo + q) * g.K + col % g.K];
        }
      }
      as[i] = va;
      gs[i] = vg;
    }
    __syncthreads();
    accumulate(acc, as, gs, ta, tb);
  }
  const float part = block_sum(tile_sq(acc), red);
  if (threadIdx.x == 0) partials[(size_t)b * g.P + blockIdx.y] = part;
}

// ------------------------------------------------------------ bf16 tensor-core mode

// Chunks of rows x cols positions of the padded Ho x Wp grid. A ring buffer holds the x
// band ((rows + kh - 1) x cols positions), then the g band (rows x (cols + kw - 1)).
struct CatPlan {
  int rows, cols;          // rows and padded columns of one chunk
  int xband, gband_w;      // x band rows; g band row width cols + kw - 1
  int chunks_r, chunks_q;  // chunks down and across the padded grid
  int stage_rows;          // shared rows of one ring buffer (x band + g band)
  int smem;                // dynamic shared memory bytes (ring + one zero row)
};

// As close to kMmaChunk positions a chunk as fits kMmaMaxSmem (as mma_plan): fewer rows
// first, then fewer columns; false when even one position does not fit.
inline bool catdot_plan(int Ho, int Wp, int kh, int kw, CatPlan* p) {
  int cols = Wp < kMmaMaxCols ? Wp : kMmaMaxCols;
  int rows = kMmaChunk / cols;
  if (rows < 1) rows = 1;
  if (rows > Ho) rows = Ho;
  for (;;) {
    const long long xband = (long long)(rows + kh - 1) * cols;
    const long long gband_w = cols + kw - 1;
    const long long stage_rows = xband + rows * gband_w;
    const long long smem = (kMmaStages * stage_rows + 1) * kRowBytes;
    if (smem <= kMmaMaxSmem) {
      *p = CatPlan{rows, cols, (int)xband, (int)gband_w, (Ho + rows - 1) / rows,
                   (Wp + cols - 1) / cols, (int)stage_rows, (int)smem};
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

struct CatArgs {
  CatGeo g;           // g.P = gblocks * ctiles * ktiles partials per example
  CatPlan p;
  int ctiles, ktiles;
  int ohg;            // groups of up to 3 row shifts: ceil(kh / 3)
  int wgroups;        // warpgroups of a block, one per (column shift, row-shift group)
  int gblocks;        // blocks per example
  bool vec_x, vec_g;  // stage by 16-byte cp.async (else by scalar loads)
};

// Stage chunk ci of one block: the x band (64 channels from c0), then the g band (64
// channels from k0), zero outside the maps. Thread t copies channel group t % 8 of every
// (blockDim / 8)-th position.
__device__ void catdot_stage(bf16* buf, const bf16* xb, const bf16* gb, const CatArgs& a,
                             int ci, int c0, int k0) {
  const CatGeo& g = a.g;
  const CatPlan& p = a.p;
  const int r0 = (ci / p.chunks_q) * p.rows, w0 = (ci % p.chunks_q) * p.cols;
  const int lane8 = threadIdx.x & 7, step = blockDim.x >> 3;
  const int c = c0 + lane8 * 8, k = k0 + lane8 * 8;
  for (int pos = threadIdx.x >> 3; pos < p.xband; pos += step) {
    const int by = pos / p.cols, bx = pos - by * p.cols;
    const int iy = r0 + by - g.pt, ix = w0 + bx - g.pl;
    const bool ok = iy >= 0 && iy < g.H && ix >= 0 && ix < g.W && c < g.C;
    const bf16* src = xb + (ok ? ((size_t)iy * g.W + ix) * g.C + c : 0);
    stage8(buf + pos * kRowElems + lane8 * 8, src, ok, g.C - c, a.vec_x);
  }
  bf16* gbuf = buf + p.xband * kRowElems;
  const int gband = p.rows * p.gband_w;
  for (int pos = threadIdx.x >> 3; pos < gband; pos += step) {
    const int by = pos / p.gband_w, bx = pos - by * p.gband_w;
    const int gy = r0 + by, gx = w0 + bx - (g.kw - 1);
    const bool ok = gy < g.Ho && gx >= 0 && gx < g.Wo && k < g.K;
    const bf16* src = gb + (ok ? ((size_t)gy * g.Wo + gx) * g.K + k : 0);
    stage8(gbuf + pos * kRowElems + lane8 * 8, src, ok, g.K - k, a.vec_g);
  }
}

// The cat-dot walk for block gblk of example b: warpgroup w owns offset group
// G = gblk * wgroups + w, i.e. column shift ox = G / ohg and row shifts
// oy = 3 * (G % ohg) + {0, 1, 2}. Per 16 positions both operands step through the chunk
// as (rr, qq) grid coordinates: A at this lane's A position shifted down by oy rows of the
// x band, B at this lane's B position shifted left by ox columns of the g band.
struct CatWalk {
  static constexpr bool kBRowsStaged = false;  // B rows outside the chunk read the zero row

  const CatArgs& a;
  const bf16* xb;
  const bf16* gb;
  int n_off, stage_rows, nch, ntiles;
  int dr, dq;                // (rr, qq) step per 16 positions
  int bshift;                // g band column of grid column 0 at this column shift
  int shift[kMmaOffsets];    // this warpgroup's row shifts as x band rows

  struct Cursor {
    int steps, nr, nq, ra, qa, rb, qb;
  };

  __device__ CatWalk(const CatArgs& args, const bf16* x, const bf16* gt, int b, int gblk)
      : a(args),
        xb(x + (size_t)b * args.g.H * args.g.W * args.g.C),
        gb(gt + (size_t)b * args.g.Ho * args.g.Wo * args.g.K) {
    const CatGeo& g = a.g;
    const int G = gblk * a.wgroups + (threadIdx.x >> 7);
    const int ox = min(G / a.ohg, g.kw - 1), oy0 = (G % a.ohg) * kMmaOffsets;
    n_off = G < g.kw * a.ohg ? min(kMmaOffsets, g.kh - oy0) : 0;
#pragma unroll
    for (int j = 0; j < kMmaOffsets; ++j) shift[j] = min(oy0 + j, g.kh - 1) * a.p.cols;
    bshift = g.kw - 1 - ox;
    stage_rows = a.p.stage_rows;
    nch = a.p.chunks_r * a.p.chunks_q;
    ntiles = a.ctiles * a.ktiles;
    dr = 16 / a.p.cols;
    dq = 16 - dr * a.p.cols;
  }

  __device__ void stage(bf16* buf, int ci, int tile) const {
    catdot_stage(buf, xb, gb, a, ci, tile / a.ktiles * kMmaTile, tile % a.ktiles * kMmaTile);
  }

  __device__ Cursor begin(int ci, int a_s, int b_s) const {
    const CatPlan& p = a.p;
    Cursor c;
    c.nr = min(p.rows, a.g.Ho - ci / p.chunks_q * p.rows);
    c.nq = min(p.cols, a.g.Wp - ci % p.chunks_q * p.cols);
    c.steps = (c.nr * p.cols + 15) / 16;
    c.ra = a_s / p.cols;
    c.qa = a_s - c.ra * p.cols;
    c.rb = b_s / p.cols;
    c.qb = b_s - c.rb * p.cols;
    return c;
  }

  __device__ int a_row(const Cursor& c) const {
    return c.ra < c.nr && c.qa < c.nq ? c.ra * a.p.cols + c.qa : -1;
  }

  __device__ int b_row(const Cursor& c) const {
    return c.rb < c.nr && c.qb < c.nq ? a.p.xband + c.rb * a.p.gband_w + c.qb + bshift : -1;
  }

  __device__ void next(Cursor& c) const {
    c.ra += dr;
    c.qa += dq;
    if (c.qa >= a.p.cols) {
      c.qa -= a.p.cols;
      ++c.ra;
    }
    c.rb += dr;
    c.qb += dq;
    if (c.qb >= a.p.cols) {
      c.qb -= a.p.cols;
      ++c.rb;
    }
  }
};

// grid: B * gblocks blocks, example-major; 128 threads per offset group of the block.
__global__ void __launch_bounds__(kMmaThreads * kMmaGroups)
catdot_mma_kernel(const bf16* __restrict__ x, const bf16* __restrict__ gt,
                  float* __restrict__ partials, CatArgs a) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __shared__ float red[kMmaThreads * kMmaGroups / 32];
  const int b = blockIdx.x / a.gblocks, gblk = blockIdx.x % a.gblocks;
  const CatWalk wk(a, x, gt, b, gblk);
  mma_norm_walk(wk, reinterpret_cast<bf16*>(smem_raw), red,
                partials + (size_t)b * a.g.P + gblk * wk.ntiles);
}

}  // namespace

extern "C" {

// Unit-stride conv, x [B, H, W, C] and g [B, Ho, Wo, K] NHWC in one dtype (0 = float32,
// CUDA-core mode; 1 = bfloat16, tensor-core mode), pt / pl the top / left padding.
// `partials` holds B * P floats: P = ceil(kh * C / 64) * ceil(kw * K / 64) in fp32 mode,
// ceil(G / min(G, 3)) * ceil(C / 64) * ceil(K / 64) in tensor-core mode, with
// G = kw * ceil(kh / 3) offset groups. Returns the launch's cudaError_t.
int ddt_conv_grad_norm_catdot(const void* x, const void* g, float* partials, float* out,
                              int dtype, int B, int H, int W, int C, int Ho, int Wo,
                              int K, int kh, int kw, int pt, int pl, int P, void* stream) {
  CatGeo geo{B, H, W, C, Ho, Wo, K, kh, kw, pt, pl, Wo + kw - 1,
             (kw * K + kTile - 1) / kTile, 0};
  if (B < 1 || H < 1 || W < 1 || C < 1 || Ho < 1 || Wo < 1 || K < 1 || kh < 1 || kw < 1)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    geo.P = (kh * C + kTile - 1) / kTile * geo.qtiles;
    if (P != geo.P || geo.P > 65535) return (int)cudaErrorInvalidValue;
    catdot_kernel<<<dim3(B, geo.P), kThreads, 0, s>>>(static_cast<const float*>(x),
                                                       static_cast<const float*>(g),
                                                       partials, geo);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    finalize_kernel<float><<<B, kThreads, 0, s>>>(partials, static_cast<const float*>(g),
                                                  out, geo.P, Ho * Wo, K, 0);
    return (int)cudaGetLastError();
  }
  if (dtype == 1) {
    CatArgs a{};
    if (!catdot_plan(Ho, geo.Wp, kh, kw, &a.p)) return (int)cudaErrorInvalidValue;
    a.ctiles = (C + kMmaTile - 1) / kMmaTile;
    a.ktiles = (K + kMmaTile - 1) / kMmaTile;
    a.ohg = (kh + kMmaOffsets - 1) / kMmaOffsets;
    const int groups = kw * a.ohg;
    a.wgroups = groups < kMmaGroups ? groups : kMmaGroups;
    a.gblocks = (groups + a.wgroups - 1) / a.wgroups;
    a.g = geo;
    a.g.P = a.gblocks * a.ctiles * a.ktiles;
    if (P != a.g.P || (long long)B * a.gblocks > INT_MAX) return (int)cudaErrorInvalidValue;
    a.vec_x = C % 8 == 0 && reinterpret_cast<uintptr_t>(x) % 16 == 0;
    a.vec_g = K % 8 == 0 && reinterpret_cast<uintptr_t>(g) % 16 == 0;
    cudaError_t err = cudaFuncSetAttribute(
        catdot_mma_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, a.p.smem);
    if (err != cudaSuccess) return (int)err;
    catdot_mma_kernel<<<B * a.gblocks, kMmaThreads * a.wgroups, a.p.smem, s>>>(
        static_cast<const bf16*>(x), static_cast<const bf16*>(g), partials, a);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    finalize_kernel<bf16><<<B, kThreads, 0, s>>>(partials, static_cast<const bf16*>(g), out,
                                                 a.g.P, Ho * Wo, K, 0);
    return (int)cudaGetLastError();
  }
  return (int)cudaErrorInvalidValue;
}

const char* ddt_error_string(int err) { return cudaGetErrorString((cudaError_t)err); }

}  // extern "C"

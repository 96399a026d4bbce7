// Per-example squared Frobenius norm of a conv layer's weight gradient, direct form.
//
// Replaces data_diet_distributed_tpu/ops/pallas_kernels.py:
//   conv_grad_norm_sq_pallas (v1, :327; body _conv_norm_kernel :137) and
//   conv_grad_norm_sq_v2     (v2, :683; body _conv_v2_kernel   :650).
//
// For example b with conv input x[b] (NHWC) and output cotangent g[b] ([Ho, Wo, K]),
//   out[b] = sum over kernel offsets o=(oy,ox) of || M_o ||_F^2,
//   M_o[c, k] = sum_s x[b, r(s)*sy + oy - pt, q(s)*sx + ox - pl, c] * g[b, s, k],
// with s = r*Wo + q running over output positions, zero outside the input (virtual
// padding: no padded copy), and the stride handled by index arithmetic (no phase split
// as on the TPU). With use_bias the bias-gradient term sum_k (sum_s g[b, s, k])^2 is
// added.
//
// Two modes, chosen by the inputs' dtype; the wrapper counts each launch under its mode.
//
// bf16: tensor cores (direct_mma_kernel; tiling and staging in conv_norm_mma.cuh). As
// the TPU kernels do on the MXU, bf16 x bf16 products are exact in fp32 and the sums
// accumulate in fp32. A block owns one example and up to 9 kernel offsets (all of a 3x3
// conv), one warpgroup of 4 warps per 3 offsets (a kernel row), and walks every 64 x 64
// (C x K) tile of the example in turn. For each tile it streams the output map in chunks
// of about 128 positions through a 2-deep cp.async ring; one staged input band per chunk
// serves every offset of the block as shifted windows (x is staged once per tile, not
// once per offset), read by ldmatrix.trans into mma.sync.m16n8k16 (bf16 -> fp32). Both
// entries run this kernel at any stride (the band's steps are the strides; a kernel
// dimension of width 1 stages only the lines its stride samples); the v2 entry's S limit
// is the fp32 mode's. The grid is one-dimensional and example-major, and a block reads
// its example's x and g again only per tile, from the 50 MB L2.
//
// fp32: CUDA cores (direct_kernel; the fp32 tiles of conv_norm_common.cuh, shared with
// the cat-dot kernel and the megakernel). A block computes one 64x64 tile of M_o from
// 32-position chunks staged as float, each of 256 threads holding a 4x4 sub-tile: a
// streaming mode (v1 entry; grid over offsets, x and g read per offset) and a
// g-resident mode (v2 entry; S <= 256, the [S, 64] g tile read once and kept in shared
// memory across offsets). fp32 stays on the CUDA cores because the parity mode that runs
// it holds the kernel within 1e-4 of an fp32 reference with TF32 off: TF32 products
// keep 10 mantissa bits and would not meet that.
//
// Both modes reduce each C x K tile of a block to ONE partial in a fixed order into a
// [B, P] buffer, which finalize_kernel sums per example in a fixed order (the bias term
// last). No float atomics and no split of S across blocks: a launch is bit-identical from
// run to run and an example's result does not depend on where it sits in the batch, which
// the serving engine's request-vs-resident guarantee and batch-concatenated conv groups
// need.
//
// Bound on the card: operations, just. A 3x3 conv at ResNet-18 geometry does
// 2*9*S*C*K FLOPs per example against x and g read once, ~290 FLOP per byte at
// C = K = 64 (the bf16 ridge is ~295) and more at wider layers. What holds the tensor-core
// mode back on an H100 SXM (tools/direct_kernel_variants.py times it with parts knocked
// out): the staging alone, with its copies, waits and barriers but no ldmatrix or
// mma.sync, takes about 70% of the kernel's time, and the MMA loop alone about 80%; the
// two overlap only in part at 12 warps per SM (146 registers a thread, 96 of them
// accumulators). Left for later: a producer warp feeding a deeper ring by TMA, so staging
// leaves the compute warps, then wgmma (the only way to the full 989 TFLOP/s), and the
// fp32 mode's tiles.

#include <limits.h>

#include "conv_norm_common.cuh"
#include "conv_norm_mma.cuh"

namespace {

constexpr int kMaxResidentS = 256;  // fp32 g-resident mode: [S, 64] fp32 tile <= 64 KB

// ------------------------------------------------------------------- fp32 mode

// grid: (B, offsets handled by separate blocks ? kh*kw : 1, ctiles*ktiles)
template <bool kResident>
__global__ void __launch_bounds__(kThreads)
direct_kernel(const float* __restrict__ x, const float* __restrict__ gt,
              float* __restrict__ partials, Geo g) {
  __shared__ __align__(16) float xs[kChunk * kTile];
  __shared__ __align__(16) float gs[kResident ? 4 : kChunk * kTile];
  __shared__ float red[kThreads / 32];
  extern __shared__ __align__(16) float gres[];  // g-resident mode: [S, kTile]

  const int b = blockIdx.x;
  const int ct = blockIdx.z / g.ktiles, kt = blockIdx.z % g.ktiles;
  const int c0 = ct * kTile, k0 = kt * kTile;
  const int tc = threadIdx.x % 16, tk = threadIdx.x / 16;
  const int S = g.Ho * g.Wo;
  const float* xb = x + (size_t)b * g.H * g.W * g.C;
  const float* gb = gt + (size_t)b * S * g.K;

  if constexpr (kResident) load_g_rows(gres, gb, g, 0, S, k0);

  const int o_begin = kResident ? 0 : blockIdx.y;
  const int o_end = kResident ? g.kh * g.kw : blockIdx.y + 1;
  for (int o = o_begin; o < o_end; ++o) {
    const int oy = o / g.kw, ox = o % g.kw;
    float acc[4][4] = {};
    for (int s0 = 0; s0 < S; s0 += kChunk) {
      __syncthreads();  // previous chunk (and the resident g load) consumed / done
      load_x_chunk(xs, xb, g, s0, oy, ox, c0);
      if constexpr (!kResident) load_g_rows(gs, gb, g, s0, kChunk, k0);
      __syncthreads();
      if constexpr (kResident) {
        if (s0 + kChunk <= S) {
          accumulate(acc, xs, gres + s0 * kTile, tc, tk);
        } else {
          // Ragged tail of the resident tile: x rows past S are zero, so reading
          // g rows past S would only multiply zeros, but they lie outside gres.
          accumulate(acc, xs, gres + s0 * kTile, tc, tk, S - s0);
        }
      } else {
        accumulate(acc, xs, gs, tc, tk);
      }
    }
    const float part = block_sum(tile_sq(acc), red);
    if (threadIdx.x == 0)
      partials[(size_t)b * g.P + ((size_t)o * g.ctiles + ct) * g.ktiles + kt] = part;
  }
}

cudaError_t launch_fp32(const float* x, const float* gt, float* partials, float* out,
                        const Geo& g, int use_bias, bool resident, cudaStream_t stream) {
  const int S = g.Ho * g.Wo;
  if (resident) {
    const size_t smem = (size_t)S * kTile * sizeof(float);
    cudaError_t err = cudaFuncSetAttribute(
        direct_kernel<true>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
    dim3 grid(g.B, 1, g.ctiles * g.ktiles);
    direct_kernel<true><<<grid, kThreads, smem, stream>>>(x, gt, partials, g);
  } else {
    dim3 grid(g.B, g.kh * g.kw, g.ctiles * g.ktiles);
    direct_kernel<false><<<grid, kThreads, 0, stream>>>(x, gt, partials, g);
  }
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  finalize_kernel<float><<<g.B, kThreads, 0, stream>>>(partials, gt, out, g.P, S, g.K,
                                                       use_bias);
  return cudaGetLastError();
}

// ------------------------------------------------------------ bf16 tensor-core mode

struct MmaArgs {
  Geo g;              // g.P = gblocks * ctiles * ktiles partials per example
  MmaPlan p;
  int wgroups;        // warpgroups of a block, one per offset group it owns
  int gblocks;        // blocks per example, each owning wgroups offset groups
  bool vec_x, vec_g;  // stage by 16-byte cp.async (else by scalar loads)
};

using bf16 = __nv_bfloat16;

// Stage chunk ci of one block into the ring buffer at buf: the input band (band_h x
// band_w positions, 64 channels from c0), then the chunk's g rows (64 channels from k0).
// Thread t copies channel group t % 8 of every (blockDim / 8)-th position, walking the
// band's coordinates by increments (no division per copy).
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
    bf16* dst = buf + pos * kRowElems + lane8 * 8;
    if (a.vec_x) {
      cp_async16(smem_addr(dst), src, ok);
    } else {
      store8_scalar(dst, src, ok ? g.C - c : 0);
    }
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
    bf16* dst = gbuf + row * kRowElems + lane8 * 8;
    if (a.vec_g) {
      cp_async16(smem_addr(dst), src, ok);
    } else {
      store8_scalar(dst, src, ok ? g.K - k : 0);
    }
    rr += dr;
    qq += dq;
    if (qq >= p.cols) {
      qq -= p.cols;
      ++rr;
    }
  }
}

// grid: B * gblocks blocks, example-major. Block (b, gblk) has one warpgroup (4 warps)
// per offset group: warpgroup w owns offsets 3 * (gblk * wgroups + w) + {0, 1, 2}. It
// walks every C x K tile of example b in turn (K tiles fastest), chunk by chunk through
// one ring, so the copies of the next tile's first chunk overlap this tile's last, and
// writes one partial per tile.
__global__ void __launch_bounds__(kMmaThreads * kMmaGroups)
direct_mma_kernel(const bf16* __restrict__ x, const bf16* __restrict__ gt,
                  float* __restrict__ partials, MmaArgs a) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __shared__ float red[kMmaThreads * kMmaGroups / 32];
  bf16* smem = reinterpret_cast<bf16*>(smem_raw);
  const Geo& g = a.g;
  const MmaPlan& p = a.p;

  const int b = blockIdx.x / a.gblocks, gblk = blockIdx.x % a.gblocks;
  const int ntiles = g.ctiles * g.ktiles;
  const bf16* xb = x + (size_t)b * g.H * g.W * g.C;
  const bf16* gb = gt + (size_t)b * g.Ho * g.Wo * g.K;

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int wq = warp & 3;  // quadrant of the 64 x 64 tile

  // This warpgroup's offsets as shifts of the staged band (in band positions); a
  // warpgroup past the last offset computes nothing.
  const int o0 = (gblk * a.wgroups + (warp >> 2)) * kMmaOffsets;
  const int n_off = min(kMmaOffsets, g.kh * g.kw - o0);
  int shift[kMmaOffsets];
#pragma unroll
  for (int j = 0; j < kMmaOffsets; ++j) {
    const int o = min(o0 + j, g.kh * g.kw - 1);
    shift[j] = (o / g.kw) * p.band_w + o % g.kw;
  }

  // One row of zeros after the ring: the x operand of positions outside the chunk.
  bf16* zero_row = smem + kMmaStages * p.stage_rows * kRowElems;
  if (threadIdx.x < kRowBytes / 16)
    reinterpret_cast<uint4*>(zero_row)[threadIdx.x] = make_uint4(0u, 0u, 0u, 0u);

  // ldmatrix row addresses of this lane: lanes 8i..8i+7 address matrix i. A (x^T,
  // 16 channels x 16 positions): matrices (s 0-7, c 0-7), (s 0-7, c 8-15), (s 8-15,
  // c 0-7), (s 8-15, c 8-15). B (g, 16 positions x 16 channels = two n8 fragments):
  // (s 0-7, k 0-7), (s 8-15, k 0-7), (s 0-7, k 8-15), (s 8-15, k 8-15).
  const int mi = lane >> 3, r8 = lane & 7;
  const int a_s = (mi >> 1) * 8 + r8, a_c = (wq & 1) * 32 + (mi & 1) * 8;
  const int b_s = (mi & 1) * 8 + r8, b_k = (wq >> 1) * 32 + (mi >> 1) * 8;
  const uint32_t zero_addr = smem_addr(zero_row + a_c);
  const int dr = 16 / p.cols, dq = 16 - dr * p.cols;  // per 16 positions

  float acc[kMmaOffsets][2][4][4] = {};
  const int nch = p.chunks_r * p.chunks_q, nsteps = ntiles * nch;
  // Step i stages chunk i % nch of tile i / nch into ring buffer i % kMmaStages.
  auto stage = [&](int i) {
    const int tile = i / nch;
    stage_chunk(smem + i % kMmaStages * p.stage_rows * kRowElems, xb, gb, a, i % nch,
                tile / g.ktiles * kMmaTile, tile % g.ktiles * kMmaTile);
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
    if (n_off > 0) {
      const bf16* band = smem + i % kMmaStages * p.stage_rows * kRowElems;
      const uint32_t band_addr = smem_addr(band);
      const uint32_t g_addr = smem_addr(band + p.band_h * p.band_w * kRowElems);
      const int nr = min(p.rows, g.Ho - ci / p.chunks_q * p.rows);
      const int nq = min(p.cols, g.Wo - ci % p.chunks_q * p.cols);
      const int steps = (nr * p.cols + 15) / 16;
      int rr = a_s / p.cols, qq = a_s - rr * p.cols;  // this lane's A position
      for (int t = 0; t < steps; ++t) {
        uint32_t bfr[2][4];
        const uint32_t ga = g_addr + ((t * 16 + b_s) * kRowElems + b_k) * 2;
        ldsm_x4_trans(bfr[0], ga);
        ldsm_x4_trans(bfr[1], ga + 32);
        const bool ok = rr < nr && qq < nq;
        const int pos = rr * p.out_dy * p.band_w + qq * p.out_dx;
#pragma unroll
        for (int j = 0; j < kMmaOffsets; ++j) {
          if (j < n_off) {
            const uint32_t aa =
                ok ? band_addr + ((pos + shift[j]) * kRowElems + a_c) * 2 : zero_addr;
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
        rr += dr;
        qq += dq;
        if (qq >= p.cols) {
          qq -= p.cols;
          ++rr;
        }
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
      if (threadIdx.x == 0) partials[(size_t)b * g.P + gblk * ntiles + i / nch] = part;
    }
  }
}

cudaError_t launch_mma(const bf16* x, const bf16* gt, float* partials, float* out,
                       const MmaArgs& a, int use_bias, cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(
      direct_mma_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, a.p.smem);
  if (err != cudaSuccess) return err;
  direct_mma_kernel<<<a.g.B * a.gblocks, kMmaThreads * a.wgroups, a.p.smem, stream>>>(
      x, gt, partials, a);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  finalize_kernel<bf16><<<a.g.B, kThreads, 0, stream>>>(partials, gt, out, a.g.P,
                                                        a.g.Ho * a.g.Wo, a.g.K, use_bias);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// dtype: 0 = float32 (CUDA-core mode), 1 = bfloat16 (tensor-core mode), x and g alike.
// `partials` holds B * P floats: P = kh * kw * ceil(C / 64) * ceil(K / 64) in fp32 mode,
// ceil(G / min(G, 3)) * ceil(C / 64) * ceil(K / 64) in tensor-core mode, with
// G = ceil(kh * kw / 3) offset groups. `resident`
// selects the fp32 mode's g-resident form (S = Ho * Wo <= 256); the tensor-core mode
// takes any S and ignores it. Returns the launch's cudaError_t (0 = success).
int ddt_conv_grad_norm_direct(const void* x, const void* g, float* partials, float* out,
                              int dtype, int B, int H, int W, int C, int Ho, int Wo,
                              int K, int kh, int kw, int sy, int sx, int pt, int pl,
                              int P, int use_bias, int resident, void* stream) {
  Geo geo{B, H, W, C, Ho, Wo, K, kh, kw, sy, sx, pt, pl,
          (C + kTile - 1) / kTile, (K + kTile - 1) / kTile, 0};
  if (B < 1 || Ho < 1 || Wo < 1 || C < 1 || K < 1 || kh < 1 || kw < 1)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    geo.P = kh * kw * geo.ctiles * geo.ktiles;
    if (P != geo.P || (resident && Ho * Wo > kMaxResidentS) ||
        geo.ctiles * geo.ktiles > 65535 || kh * kw > 65535)
      return (int)cudaErrorInvalidValue;
    return (int)launch_fp32(static_cast<const float*>(x), static_cast<const float*>(g),
                            partials, out, geo, use_bias, resident, s);
  }
  if (dtype == 1) {
    MmaArgs a{};
    if (!mma_plan(Ho, Wo, kh, kw, sy, sx, &a.p)) return (int)cudaErrorInvalidValue;
    const int groups = (kh * kw + kMmaOffsets - 1) / kMmaOffsets;
    a.wgroups = groups < kMmaGroups ? groups : kMmaGroups;
    a.gblocks = (groups + a.wgroups - 1) / a.wgroups;
    geo.P = a.gblocks * geo.ctiles * geo.ktiles;
    if (P != geo.P || (long long)B * a.gblocks > INT_MAX) return (int)cudaErrorInvalidValue;
    a.g = geo;
    a.vec_x = C % 8 == 0 && reinterpret_cast<uintptr_t>(x) % 16 == 0;
    a.vec_g = K % 8 == 0 && reinterpret_cast<uintptr_t>(g) % 16 == 0;
    return (int)launch_mma(static_cast<const bf16*>(x), static_cast<const bf16*>(g),
                           partials, out, a, use_bias, s);
  }
  return (int)cudaErrorInvalidValue;
}

const char* ddt_error_string(int err) { return cudaGetErrorString((cudaError_t)err); }

}  // extern "C"

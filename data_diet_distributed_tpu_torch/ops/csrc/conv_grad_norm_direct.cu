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
// bf16: tensor cores (direct_mma_kernel; the loop is DirectWalk and mma_norm_walk of
// conv_norm_mma.cuh, which the megakernel's norm role runs too). As the TPU kernels do on
// the MXU, bf16 x bf16 products are exact in fp32 and the sums accumulate in fp32. A
// block owns one example and up to 9 kernel offsets (all of a 3x3 conv), one warpgroup of
// 4 warps per 3 offsets (a kernel row), and walks every 64 x 64 (C x K) tile of the
// example in turn. For each tile it streams the output map in chunks of about 128
// positions through a 2-deep cp.async ring; one staged input band per chunk serves every
// offset of the block as shifted windows (x is staged once per tile, not once per
// offset), read by ldmatrix.trans into mma.sync.m16n8k16 (bf16 -> fp32). Both entries run
// this kernel at any stride (the band's steps are the strides; a kernel dimension of
// width 1 stages only the lines its stride samples); the v2 entry's S limit is the fp32
// mode's. The grid is one-dimensional and example-major, and a block reads its example's
// x and g again only per tile, from the 50 MB L2.
//
// fp32: CUDA cores (direct_kernel; the fp32 tiles of conv_norm_common.cuh, shared with
// the fp32 modes of the cat-dot kernel and the megakernel). A block computes one 64x64 tile of M_o from
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

// grid: B * gblocks blocks, example-major. Block (b, gblk) has one warpgroup (4 warps)
// per offset group and walks every C x K tile of example b (DirectWalk and
// mma_norm_walk in conv_norm_mma.cuh), writing one partial per tile.
__global__ void __launch_bounds__(kMmaThreads * kMmaGroups)
direct_mma_kernel(const bf16* __restrict__ x, const bf16* __restrict__ gt,
                  float* __restrict__ partials, MmaArgs a) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __shared__ float red[kMmaThreads * kMmaGroups / 32];
  const int b = blockIdx.x / a.gblocks, gblk = blockIdx.x % a.gblocks;
  const DirectWalk wk(a, x, gt, b, gblk);
  mma_norm_walk(wk, reinterpret_cast<bf16*>(smem_raw), red,
                partials + (size_t)b * a.g.P + gblk * wk.ntiles);
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
    if (!make_mma_args(geo, x, g, &a)) return (int)cudaErrorInvalidValue;
    if (P != a.g.P || (long long)B * a.gblocks > INT_MAX) return (int)cudaErrorInvalidValue;
    return (int)launch_mma(static_cast<const bf16*>(x), static_cast<const bf16*>(g),
                           partials, out, a, use_bias, s);
  }
  return (int)cudaErrorInvalidValue;
}

const char* ddt_error_string(int err) { return cudaGetErrorString((cudaError_t)err); }

}  // extern "C"

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
// padding: bounds checks, no padded copy), and the stride handled by index arithmetic
// (no phase split as on the TPU). With use_bias the bias-gradient term
// sum_k (sum_s g[b, s, k])^2 is added.
//
// Design. One block computes one 64x64 tile of M_o (C tile x K tile) for one example:
// it stages 32-position chunks of the x and g rows in shared memory as float, each of
// the 256 threads accumulates a 4x4 sub-tile in fp32 registers, and the block squares
// and reduces its tile to ONE partial in a fixed order. Partials land in a [B, P]
// scratch buffer and a second kernel sums each example's row in a fixed order (the
// bias term is its last addend). No float atomics: a launch is bit-identical from run
// to run and independent of where the example sits in the batch, which the serving
// engine's request-vs-resident guarantee needs.
//
// Two modes of the same kernel: streaming (v1 entry; grid over offsets, x and g chunks
// both read per offset) and g-resident (v2 entry; S <= 256 output positions, so the
// block's whole [S, 64] g tile fits in 64 KB of shared memory, is read once and is
// reused for every kernel offset). The tile machinery, the loaders and the finalize
// pass live in conv_norm_common.cuh, shared with the cat-dot kernel and the megakernel.
//
// Bound on the card: operations. At ResNet-18 stage-1 geometry the tile does 16 FMAs
// for every two 16-byte shared-memory loads, on the fp32 CUDA cores. What the simple
// design leaves for later: bf16 operands on the tensor cores (mma / wgmma with the x
// chunk as the transposed A operand), TMA staging of the chunks, and reuse of each
// staged x chunk across the kh*kw offsets it serves.

#include "conv_norm_common.cuh"

namespace {

constexpr int kMaxResidentS = 256; // g-resident mode: [S, 64] fp32 tile <= 64 KB

// grid: (B, offsets handled by separate blocks ? kh*kw : 1, ctiles*ktiles)
template <typename T, bool kResident>
__global__ void __launch_bounds__(kThreads)
direct_kernel(const T* __restrict__ x, const T* __restrict__ gt,
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
  const T* xb = x + (size_t)b * g.H * g.W * g.C;
  const T* gb = gt + (size_t)b * S * g.K;

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

template <typename T>
cudaError_t launch(const void* x, const void* gt, float* partials, float* out,
                   const Geo& g, int use_bias, bool resident, cudaStream_t stream) {
  const T* xp = static_cast<const T*>(x);
  const T* gp = static_cast<const T*>(gt);
  const int S = g.Ho * g.Wo;
  if (resident) {
    const size_t smem = (size_t)S * kTile * sizeof(float);
    cudaError_t err = cudaFuncSetAttribute(
        direct_kernel<T, true>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
    dim3 grid(g.B, 1, g.ctiles * g.ktiles);
    direct_kernel<T, true><<<grid, kThreads, smem, stream>>>(xp, gp, partials, g);
  } else {
    dim3 grid(g.B, g.kh * g.kw, g.ctiles * g.ktiles);
    direct_kernel<T, false><<<grid, kThreads, 0, stream>>>(xp, gp, partials, g);
  }
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  finalize_kernel<T><<<g.B, kThreads, 0, stream>>>(partials, gp, out, g.P, S, g.K,
                                                     use_bias);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16 (x and g alike). `partials` holds B * P floats with
// P = kh * kw * ceil(C / 64) * ceil(K / 64); `resident` selects the g-resident mode
// (S = Ho * Wo <= 256). Returns the launch's cudaError_t (0 = success).
int ddt_conv_grad_norm_direct(const void* x, const void* g, float* partials, float* out,
                              int dtype, int B, int H, int W, int C, int Ho, int Wo,
                              int K, int kh, int kw, int sy, int sx, int pt, int pl,
                              int P, int use_bias, int resident, void* stream) {
  Geo geo{B, H, W, C, Ho, Wo, K, kh, kw, sy, sx, pt, pl,
          (C + kTile - 1) / kTile, (K + kTile - 1) / kTile, 0};
  geo.P = kh * kw * geo.ctiles * geo.ktiles;
  if (P != geo.P || B < 1 || (resident && Ho * Wo > kMaxResidentS) ||
      geo.ctiles * geo.ktiles > 65535 || kh * kw > 65535)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return (int)launch<float>(x, g, partials, out, geo, use_bias, resident, s);
  if (dtype == 1)
    return (int)launch<__nv_bfloat16>(x, g, partials, out, geo, use_bias, resident, s);
  return (int)cudaErrorInvalidValue;
}

const char* ddt_error_string(int err) { return cudaGetErrorString((cudaError_t)err); }

}  // extern "C"

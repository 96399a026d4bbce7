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
// reused for every kernel offset).
//
// Bound on the card: operations. At ResNet-18 stage-1 geometry the tile does 16 FMAs
// for every two 16-byte shared-memory loads, on the fp32 CUDA cores. What the simple
// design leaves for later: bf16 operands on the tensor cores (mma / wgmma with the x
// chunk as the transposed A operand), TMA staging of the chunks, and reuse of each
// staged x chunk across the kh*kw offsets it serves.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kTile = 64;          // C and K tile edge
constexpr int kChunk = 32;         // output positions staged per step
constexpr int kThreads = 256;      // 16 x 16 threads, 4 x 4 outputs each
constexpr int kMaxResidentS = 256; // g-resident mode: [S, 64] fp32 tile <= 64 KB

struct Geo {
  int B, H, W, C, Ho, Wo, K;
  int kh, kw, sy, sx, pt, pl;
  int ctiles, ktiles, P;
};

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }

// Sum over the block of one float per thread, in a fixed order. Result valid in thread 0.
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

// xs[s][c] = x[b, pos(s0 + s, o), c0 + c], zero outside the input or past S / C.
template <typename T>
__device__ void load_x_chunk(float* xs, const T* xb, const Geo& g, int s0, int oy,
                             int ox, int c0) {
  const int S = g.Ho * g.Wo;
  for (int i = threadIdx.x; i < kChunk * kTile; i += kThreads) {
    const int s = s0 + i / kTile, c = c0 + i % kTile;
    float v = 0.f;
    if (s < S && c < g.C) {
      const int iy = (s / g.Wo) * g.sy + oy - g.pt;
      const int ix = (s % g.Wo) * g.sx + ox - g.pl;
      if (iy >= 0 && iy < g.H && ix >= 0 && ix < g.W)
        v = to_f32(xb[((size_t)iy * g.W + ix) * g.C + c]);
    }
    xs[i] = v;
  }
}

// dst[s][k] = g[b, s0 + s, k0 + k] for s < rows, zero past S / K.
template <typename T>
__device__ void load_g_rows(float* dst, const T* gb, const Geo& g, int s0, int rows,
                            int k0) {
  const int S = g.Ho * g.Wo;
  for (int i = threadIdx.x; i < rows * kTile; i += kThreads) {
    const int s = s0 + i / kTile, k = k0 + i % kTile;
    dst[i] = (s < S && k < g.K) ? to_f32(gb[(size_t)s * g.K + k]) : 0.f;
  }
}

// acc[i][j] += sum_{s < kChunk} xs[s][tc*4+i] * gs[s][tk*4+j]
__device__ __forceinline__ void accumulate(float (&acc)[4][4], const float* xs,
                                           const float* gs, int tc, int tk) {
#pragma unroll 8
  for (int s = 0; s < kChunk; ++s) {
    const float4 a = *reinterpret_cast<const float4*>(xs + s * kTile + tc * 4);
    const float4 w = *reinterpret_cast<const float4*>(gs + s * kTile + tk * 4);
    const float av[4] = {a.x, a.y, a.z, a.w};
    const float wv[4] = {w.x, w.y, w.z, w.w};
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(av[i], wv[j], acc[i][j]);
  }
}

__device__ __forceinline__ float tile_sq(const float (&acc)[4][4]) {
  float v = 0.f;
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) v = fmaf(acc[i][j], acc[i][j], v);
  return v;
}

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
          for (int s = 0; s < S - s0; ++s) {
            const float4 a = *reinterpret_cast<const float4*>(xs + s * kTile + tc * 4);
            const float4 w =
                *reinterpret_cast<const float4*>(gres + (s0 + s) * kTile + tk * 4);
            const float av[4] = {a.x, a.y, a.z, a.w};
            const float wv[4] = {w.x, w.y, w.z, w.w};
            for (int i = 0; i < 4; ++i)
              for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(av[i], wv[j], acc[i][j]);
          }
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

// out[b] = sum_p partials[b, p] (+ sum_k (sum_s g[b, s, k])^2), fixed order.
template <typename T>
__global__ void __launch_bounds__(kThreads)
finalize_kernel(const float* __restrict__ partials, const T* __restrict__ gt,
                float* __restrict__ out, Geo g, int use_bias) {
  __shared__ float red[kThreads / 32];
  const int b = blockIdx.x;
  float v = 0.f;
  for (int p = threadIdx.x; p < g.P; p += kThreads) v += partials[(size_t)b * g.P + p];
  if (use_bias) {
    const int S = g.Ho * g.Wo;
    const T* gb = gt + (size_t)b * S * g.K;
    for (int k = threadIdx.x; k < g.K; k += kThreads) {
      float col = 0.f;
      for (int s = 0; s < S; ++s) col += to_f32(gb[(size_t)s * g.K + k]);
      v = fmaf(col, col, v);
    }
  }
  const float total = block_sum(v, red);
  if (threadIdx.x == 0) out[b] = total;
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
  finalize_kernel<T><<<g.B, kThreads, 0, stream>>>(partials, gp, out, g, use_bias);
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

// Per-example squared Frobenius norm of a conv layer's weight gradient, Gram form.
//
// Replaces data_diet_distributed_tpu/ops/pallas_kernels.py:
//   conv_grad_norm_sq_gram (:797; body _conv_gram_kernel :765).
//
// With P[b] the [S, kh*kw*C] im2col patches and G[b] the [S, K] output cotangent,
//   out[b] = sum_{s,t} (P P^T)[s, t] * (G G^T)[s, t]   (+ sum_k (sum_s g[b, s, k])^2).
// The patches are never built: (P P^T)[s, t] = sum_o XX[pos(s, o), pos(t, o)] over the
// kernel offsets o where both positions fall inside the input, with XX = X X^T the
// [H*W, H*W] Gram of the example's input pixels. That is kh*kw times fewer operations
// than the patch Gram the TPU kernel builds in VMEM, and the padding stays virtual.
//
// Bound on the card: bytes. At ResNet-18's stage-4 geometry (4x4x512, batch 512, bf16)
// a launch reads 16.8 MB of x and g (5.0 us at 3.35 TB/s) for 0.27 GFLOP; both Grams
// are [16, 512] x [512, 16] products per example, exactly the shape of
// mma.sync.m16n8k16. What holds such a kernel back is latency: one example's work is
// small, so many examples' loads must be in flight at once.
//
// Design. A block takes `E` examples (up to kGramExamples) and one warp per (example,
// Gram): warp 2e forms XX of example e from x, warp 2e + 1 forms GG from g. The block
// stages every example's x and g rows with 16-byte cp.async copies, `chunk` channels of
// a row at a time, and the plan (gram_plan) makes the chunk as wide as shared memory
// allows beside two examples: at ResNet-18's stage 4 in bf16 a chunk is the whole row
// (512 channels), so a block issues all its loads at once and waits once, and several
// blocks' loads are in flight on each SM. Where a whole row does not fit (fp32 there),
// the chunks stream through a ring of up to kGramStages buffers (kGramStages - 1 in
// flight while one is consumed). Each chunk costs a wait, two barriers and a dependent
// run of MMAs, so fewer, wider chunks are faster. A staged row is padded by kGramRowPad
// bytes (an odd number of 16-byte units per row: ldmatrix's 8 row addresses fall in 8
// different bank groups); H*W and S are padded to multiples of 16 with zero rows, and
// channels past C or K are zero-filled lanes (cp.async with src-size 0), so the padding
// adds nothing. A C or K that is not a multiple of the 16-byte vector (or a base pointer
// not 16-byte aligned) is staged by scalar loads instead, into the same layout.
//
// Tensor-core mode (bf16): X is row-major [H*W, C], so one plain ldmatrix.x4 of 16 rows
// x 16 channels is both the A operand (X) and, read as two n8 halves, the B operand
// (X^T in column-major) of mma.sync.m16n8k16 bf16 -> fp32. A 16 x 16 tile of the Gram
// runs a chunk's k-steps in registers, alternating two accumulator sets (half the
// dependent chain), and adds them into its fp32 tile in shared memory once per chunk,
// in a fixed order whatever the Gram's size. bf16 x bf16 products are exact in fp32.
//
// fp32 mode: the same staging, and each lane of the warp owns Gram entries and
// accumulates them with fp32 FMAs on the CUDA cores. TF32 (the tensor cores' fp32
// input) keeps 10 mantissa bits and misses the parity mode's 1e-4, so fp32 stays there.
//
// The rest runs on the CUDA cores in both modes: the bias term from the staged g chunks
// (each lane sums its channels' columns in position order), then, per example, its two
// warps gather P P^T from XX over the kernel offsets and dot it with GG entry by entry,
// and the two warps' sums meet in a fixed order. No atomics: bit-identical from run to
// run and independent of the example's place in the batch or the block.

#include <stdint.h>

#include "common.cuh"
#include "mma_sync.cuh"

namespace {

constexpr int kGramExamples = 4;           // examples per block at most (two warps each)
constexpr int kGramStages = 4;             // ring depth at most, in chunks
constexpr int kGramUnitBytes = 128;        // the narrowest chunk: 128 bytes of channels
constexpr int kGramRowPad = 16;            // bytes of padding after each staged row
constexpr int kGramBlockSmem = 113 * 1024;  // a block's target: two blocks per SM
constexpr int kGramMaxSmem = 226 * 1024;   // a block at most (one example, narrowest chunk)

struct GramArgs {
  int B, H, W, C, Ho, Wo, K, kh, kw, pt, pl;
  int HW, S;        // input and output positions
  int hwp, sp;      // both padded to a multiple of 16
  int rows;         // staged rows of one example: hwp + sp
  int E;            // examples per block
  int chunk;        // channels of a row staged per step
  int row_elems;    // staged row stride in elements: chunk + kGramRowPad / itemsize
  int nsteps;       // chunks of the deeper of x and g
  int stages;       // ring buffers: min(kGramStages, nsteps)
  int smem;         // dynamic shared memory bytes
  bool vec_x, vec_g;  // stage by 16-byte cp.async (else by scalar loads)
};

inline long long gram_smem(const GramArgs& a, int e, int chunk, int stages, int itemsize) {
  return (long long)stages * e * a.rows * (chunk * itemsize + kGramRowPad) +
         (long long)e * ((long long)a.hwp * a.hwp + (long long)a.sp * a.sp) * 4;
}

// The block layout for H*W input and S output positions, C and K channels of
// `itemsize` bytes: the widest chunk (the whole row first, then halves, in units of
// kGramUnitBytes) with the most examples (4, 2) within kGramBlockSmem; at the narrowest
// chunk also one example, within kGramBlockSmem or else kGramMaxSmem. A block keeps
// two examples where it can, because one example's two warps leave an SM short of
// warps (fp32 at ResNet-18's stage 4). False when nothing fits.
inline bool gram_plan(GramArgs* a, int itemsize) {
  a->hwp = (a->HW + 15) / 16 * 16;
  a->sp = (a->S + 15) / 16 * 16;
  a->rows = a->hwp + a->sp;
  const int unit = kGramUnitBytes / itemsize;
  const int depth = ((a->C > a->K ? a->C : a->K) + unit - 1) / unit * unit;
  for (int chunk = depth;; chunk = ((chunk / 2 + unit - 1) / unit) * unit) {
    const int nsteps = (depth + chunk - 1) / chunk;
    const int stages = nsteps < kGramStages ? nsteps : kGramStages;
    const bool last = chunk == unit;
    for (int e = kGramExamples; e >= 1; e /= 2) {
      const long long bytes = gram_smem(*a, e, chunk, stages, itemsize);
      if ((bytes <= kGramBlockSmem && (e > 1 || last)) ||
          (last && e == 1 && bytes <= kGramMaxSmem)) {
        a->E = e;
        a->chunk = chunk;
        a->row_elems = chunk + kGramRowPad / itemsize;
        a->nsteps = nsteps;
        a->stages = stages;
        a->smem = (int)bytes;
        return true;
      }
    }
    if (last) return false;
  }
}

// 16 bytes of channels from src (n of them valid) to dst in shared memory: cp.async when
// `vec`, else scalar loads (the rest zero).
__device__ __forceinline__ void stage16(bf16* dst, const bf16* src, bool ok, int n, bool vec) {
  stage8(dst, src, ok, n, vec);
}

__device__ __forceinline__ void stage16(float* dst, const float* src, bool ok, int n,
                                        bool vec) {
  if (vec) {
    cp_async16(smem_addr(dst), src, ok);
  } else {
    const int m = ok ? n : 0;
    *reinterpret_cast<float4*>(dst) = make_float4(m > 0 ? src[0] : 0.f, m > 1 ? src[1] : 0.f,
                                                  m > 2 ? src[2] : 0.f, m > 3 ? src[3] : 0.f);
  }
}

// Wait until at most n (0-3) committed cp.async groups are still in flight.
__device__ __forceinline__ void cp_async_wait_upto(int n) {
  switch (n) {
    case 0: cp_async_wait<0>(); break;
    case 1: cp_async_wait<1>(); break;
    case 2: cp_async_wait<2>(); break;
    default: cp_async_wait<3>(); break;
  }
}

// gram[n x n] += rows[0:n] rows[0:n]^T over one staged chunk of `chunk` bf16 channels
// (row stride `stride` elements), on the tensor cores: per 16 x 16 tile, the chunk's
// k-steps in two alternating register accumulator sets, then both added to the tile in
// shared memory.
__device__ __forceinline__ void gram_chunk(float* gram, const bf16* rows, int n, int chunk,
                                           int stride, int lane) {
  const int g8 = lane >> 2, t2 = (lane & 3) * 2;
  const uint32_t base = smem_addr(rows) + ((lane & 15) * stride + (lane >> 4) * 8) * 2;
  for (int mi = 0; mi < n / 16; ++mi) {
    for (int ni = 0; ni < n / 16; ++ni) {
      float acc[2][2][4] = {};   // [set][n8 half][fragment]
      for (int k0 = 0; k0 < chunk; k0 += 32) {
#pragma unroll
        for (int set = 0; set < 2; ++set) {
          const int kk = k0 + set * 16;
          if (kk < chunk) {
            // Matrices: (rows 0-7, k 0-7), (rows 8-15, k 0-7), (rows 0-7, k 8-15),
            // (rows 8-15, k 8-15): A as it stands; B of columns 0-7 is {0, 2}, of
            // columns 8-15 {1, 3}.
            uint32_t af[4], bfr[4];
            ldsm_x4(af, base + (mi * 16 * stride + kk) * 2);
            if (ni == mi) {
#pragma unroll
              for (int j = 0; j < 4; ++j) bfr[j] = af[j];
            } else {
              ldsm_x4(bfr, base + (ni * 16 * stride + kk) * 2);
            }
            mma_bf16(acc[set][0], af, bfr[0], bfr[2]);
            mma_bf16(acc[set][1], af, bfr[1], bfr[3]);
          }
        }
      }
      float* t0 = gram + (mi * 16 + g8) * n + ni * 16 + t2;
#pragma unroll
      for (int nt = 0; nt < 2; ++nt) {
        t0[nt * 8] += acc[0][nt][0] + acc[1][nt][0];
        t0[nt * 8 + 1] += acc[0][nt][1] + acc[1][nt][1];
        t0[8 * n + nt * 8] += acc[0][nt][2] + acc[1][nt][2];
        t0[8 * n + nt * 8 + 1] += acc[0][nt][3] + acc[1][nt][3];
      }
    }
  }
}

// The same over one staged chunk of fp32 channels, on the CUDA cores: lane l owns
// entries l, l + 32, ... and adds the chunk's products to each in channel order.
__device__ __forceinline__ void gram_chunk(float* gram, const float* rows, int n, int chunk,
                                           int stride, int lane) {
  for (int e = lane; e < n * n; e += 32) {
    const int p = e / n, q = e - p * n;
    const float4* ra = reinterpret_cast<const float4*>(rows + p * stride);
    const float4* rb = reinterpret_cast<const float4*>(rows + q * stride);
    float acc = gram[e];
    for (int j = 0; j < chunk / 4; ++j) {
      const float4 u = ra[j], w = rb[j];
      acc = fmaf(u.x, w.x, acc);
      acc = fmaf(u.y, w.y, acc);
      acc = fmaf(u.z, w.z, acc);
      acc = fmaf(u.w, w.w, acc);
    }
    gram[e] = acc;
  }
}

// Step i: stage chunk i of x and of g (where the tensor has one) of the block's nb
// examples into ring buffer i % stages: row p < hwp of example e is x position p (zero
// past H*W), row hwp + q its g position q (zero past S). Thread t copies the 16-byte
// vectors t, t + blockDim, ... of the step, walking (example, row, vector) by
// increments, then commits one cp.async group.
template <typename T>
__device__ __forceinline__ void stage_step(T* ring, const T* __restrict__ x,
                                           const T* __restrict__ gt, const GramArgs& a, int i,
                                           int b0, int nb) {
  constexpr int kVec = 16 / sizeof(T);
  T* buf = ring + (i % a.stages) * a.E * a.rows * a.row_elems;
  const int c0 = i * a.chunk;
  const bool sx = c0 < a.C, sg = c0 < a.K;
  const int vpr = a.chunk / kVec;  // vectors per staged row
  const int drow = blockDim.x / vpr, dv = blockDim.x - drow * vpr;
  int row = threadIdx.x / vpr, vi = threadIdx.x - row * vpr;
  int e = row / a.rows, p = row - e * a.rows;
  while (e < nb) {
    const int c = c0 + vi * kVec;
    T* dst = buf + (e * a.rows + p) * a.row_elems + vi * kVec;
    if (p < a.hwp) {
      if (sx) {
        const bool ok = p < a.HW && c < a.C;
        stage16(dst, x + (ok ? ((size_t)(b0 + e) * a.HW + p) * a.C + c : 0), ok, a.C - c,
                a.vec_x);
      }
    } else if (sg) {
      const int q = p - a.hwp;
      const bool ok = q < a.S && c < a.K;
      stage16(dst, gt + (ok ? ((size_t)(b0 + e) * a.S + q) * a.K + c : 0), ok, a.K - c,
              a.vec_g);
    }
    vi += dv;
    p += drow;
    if (vi >= vpr) {
      vi -= vpr;
      ++p;
    }
    while (p >= a.rows) {
      p -= a.rows;
      ++e;
    }
  }
  cp_async_commit();
}

template <typename T>
__global__ void __launch_bounds__(kGramExamples * 64)
gram_kernel(const T* __restrict__ x, const T* __restrict__ gt, float* __restrict__ out,
            GramArgs a, int use_bias) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __shared__ float red[2 * kGramExamples];
  T* ring = reinterpret_cast<T*>(smem_raw);
  const int stage_elems = a.E * a.rows * a.row_elems;
  float* grams = reinterpret_cast<float*>(ring + (size_t)a.stages * stage_elems);
  const int gram_floats = a.hwp * a.hwp + a.sp * a.sp;

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int slot = warp >> 1, which = warp & 1;  // example slot; 0: XX from x, 1: GG from g
  const int b0 = blockIdx.x * a.E;
  const int nb = min(a.E, a.B - b0);
  const int n = which ? a.sp : a.hwp;
  const int nchx = (a.C + a.chunk - 1) / a.chunk, nchk = (a.K + a.chunk - 1) / a.chunk;
  const int nch = which ? nchk : nchx;
  float* gram = grams + slot * gram_floats + (which ? a.hwp * a.hwp : 0);

  for (int i = threadIdx.x; i < a.E * gram_floats; i += blockDim.x) grams[i] = 0.f;

  for (int i = 0; i + 1 < a.stages; ++i) stage_step(ring, x, gt, a, i, b0, nb);
  float v = 0.f;  // this lane's share of its example's sum (bias term first, GG warps)
  for (int i = 0; i < a.nsteps; ++i) {
    if (i + a.stages - 1 < a.nsteps) {
      stage_step(ring, x, gt, a, i + a.stages - 1, b0, nb);
    } else {
      cp_async_commit();  // empty groups keep the wait below uniform
    }
    cp_async_wait_upto(a.stages - 1);  // step i has landed
    __syncthreads();
    if (slot < nb && i < nch) {
      const T* rows = ring + (i % a.stages) * stage_elems +
                      (slot * a.rows + (which ? a.hwp : 0)) * a.row_elems;
      gram_chunk(gram, rows, n, a.chunk, a.row_elems, lane);
      if (which && use_bias) {
        for (int k = lane; k < a.chunk; k += 32) {
          float col = 0.f;
          for (int s = 0; s < a.S; ++s) col += to_f32(rows[s * a.row_elems + k]);
          v = fmaf(col, col, v);
        }
      }
    }
    __syncthreads();  // the buffer is consumed before a later step refills it
  }

  if (slot < nb) {
    const float* XX = grams + slot * gram_floats;
    const float* GG = XX + a.hwp * a.hwp;
    for (int e = which * 32 + lane; e < a.S * a.S; e += 64) {
      const int s = e / a.S, t = e - s * a.S;
      const int sr = s / a.Wo, sq = s - sr * a.Wo, tr = t / a.Wo, tq = t - tr * a.Wo;
      // Every offset's load is issued unconditionally (an offset outside the input
      // reads entry 0 and adds zero), so the loads do not wait on one another.
      float pp = 0.f;
      for (int oy = 0; oy < a.kh; ++oy) {
        const int y1 = sr + oy - a.pt, y2 = tr + oy - a.pt;
        const bool oky = (unsigned)y1 < (unsigned)a.H && (unsigned)y2 < (unsigned)a.H;
#pragma unroll 3
        for (int ox = 0; ox < a.kw; ++ox) {
          const int x1 = sq + ox - a.pl, x2 = tq + ox - a.pl;
          const bool ok = oky && (unsigned)x1 < (unsigned)a.W && (unsigned)x2 < (unsigned)a.W;
          const float xx = XX[ok ? (y1 * a.W + x1) * a.hwp + y2 * a.W + x2 : 0];
          pp += ok ? xx : 0.f;
        }
      }
      v = fmaf(pp, GG[s * a.sp + t], v);
    }
  }
  v = warp_sum(v);
  if (lane == 0) red[warp] = v;
  __syncthreads();
  if (threadIdx.x < nb) out[b0 + threadIdx.x] = red[2 * threadIdx.x] + red[2 * threadIdx.x + 1];
}

template <typename T>
cudaError_t launch(const void* x, const void* gt, float* out, GramArgs a, int use_bias,
                   cudaStream_t stream) {
  constexpr int kVec = 16 / sizeof(T);
  if (!gram_plan(&a, sizeof(T))) return cudaErrorInvalidValue;
  a.vec_x = a.C % kVec == 0 && reinterpret_cast<uintptr_t>(x) % 16 == 0;
  a.vec_g = a.K % kVec == 0 && reinterpret_cast<uintptr_t>(gt) % 16 == 0;
  cudaError_t err = cudaFuncSetAttribute(
      gram_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, a.smem);
  if (err != cudaSuccess) return err;
  const unsigned blocks = (unsigned)((a.B + a.E - 1) / a.E);
  gram_kernel<T><<<blocks, a.E * 64, a.smem, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(gt), out, a, use_bias);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Unit-stride conv; x [B, H, W, C] and g [B, Ho, Wo, K] NHWC, contiguous, one dtype:
// 0 = float32 (fp32 mode), 1 = bfloat16 (tensor-core mode). The block layout follows
// gram_plan above; the wrapper's eligibility gate (kernels.py, gram_plan) mirrors it.
// Returns the cudaError_t (cudaErrorInvalidValue where no plan fits).
int ddt_conv_grad_norm_gram(const void* x, const void* g, float* out, int dtype, int B,
                            int H, int W, int C, int Ho, int Wo, int K, int kh, int kw,
                            int pt, int pl, int use_bias, void* stream) {
  GramArgs a{};
  a.B = B, a.H = H, a.W = W, a.C = C, a.Ho = Ho, a.Wo = Wo, a.K = K;
  a.kh = kh, a.kw = kw, a.pt = pt, a.pl = pl;
  a.HW = H * W, a.S = Ho * Wo;
  if (B < 1 || C < 1 || K < 1) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return (int)launch<float>(x, g, out, a, use_bias, s);
  if (dtype == 1) return (int)launch<__nv_bfloat16>(x, g, out, a, use_bias, s);
  return (int)cudaErrorInvalidValue;
}

const char* ddt_error_string(int err) { return cudaGetErrorString((cudaError_t)err); }

}  // extern "C"

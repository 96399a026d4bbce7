// Last-layer GraNd: the classifier product and the score in one kernel.
//
// Replaces data_diet_distributed_tpu/ops/pallas_kernels.py:
//   grand_last_layer_pallas (:933; body _gll_kernel :922).
//
// For row b with features h[b] (F values), classifier weight w [C, F] (PyTorch's
// nn.Linear layout, read as it is: no transposed copy), bias [C], label y and mask m:
//   z_j    = sum_f h[b, f] * w[j, f] + bias_j        (the logits, in fp32, computed here),
//   out[b] = sqrt(||softmax(z) - onehot(y)||^2 * (||h[b]||^2 + 1)) * m.
//
// Bound on the card: at a wide head ([512, 2048] -> 1000, a ResNet-50's) the product is
// 2.1 GFLOP (2.1 us at the bf16 tensor-core rate) against 10.3 MB of bf16 features and
// fp32 weight (3.1 us at 3.35 TB/s): bytes, barely; at ResNet-18's head ([512, 512] ->
// 10) launch latency dominates both bounds.
//
// Design (gll_plan, mirrored in kernels.py, depends on C and the features' dtype only, so
// a row's arithmetic never depends on the batch). A block owns a tile of kGllRows rows
// and one split of the classes (`classes` = 32 or 64 of them). It walks F in chunks of
// kGllChunk features through a ring of kGllStages cp.async buffers (16-byte copies,
// zero-filled past B, C or F; scalar loads where F or a base pointer is off the 16-byte
// grid), two chunks in flight. Each staged chunk of w serves every row of the tile, so
// w is read once per row tile, not once per row. A landed chunk is split into one of two
// operand buffers while the MMAs read the other: one barrier a chunk. Its eight warps
// are four rows of 16 by two halves of the split (2 or 4 n8 tiles each).
//
// The product runs on the tensor cores (mma.sync.m16n8k16, bf16 operands, fp32
// accumulation): the staged fp32 chunk of w is split once per block, so no launch before
// the kernel makes a copy, into three bf16 parts w1 = bf16(w), w2 = bf16(w - w1),
// w3 = bf16(w - w1 - w2), whose sum holds w to about 2^-24 (the megakernel's dx keeps
// two; two here leave logits of |z| ~ 200, a saturated softmax, 1e-3 off, so scores
// 4e-5 off an fp32 product). bf16 features are exact in bf16 and take three products,
// h * w1 + h * w2 + h * w3; fp32 features are split alike and take the six above
// 2^-24, h1 w1 + (h1 w2 + h2 w1 + h1 w3 + h2 w2 + h3 w1). h1 w1 accumulates apart from
// the small terms, which meet it once at the end. TF32 keeps 10 bits and misses the
// parity mode's 1e-4. ||h||^2 is summed in fp32 from the features as staged.
//
// Epilogue: each warp holds its 16 rows' logits of its half of the split in registers;
// per row the half's max m, S = sum e, S_ny and Q_ny (common.cuh, ErrSums) in a fixed
// order over the lane's classes and then its quad, the two halves merged in order. With
// one split the block writes the score; with several (C > 64) each block writes its
// rows' sums to a scratch row, and the last block of a row tile to arrive (an integer
// ticket per tile, reset by that block) merges them in split order and writes the score.
// No float atomics: bit-identical from run to run and wherever the row sits in the
// batch. Left for later: fewer products (the MMAs are a third of the time at the wide
// head, at mma.sync's rate), a producer warp with TMA, and wgmma.

#include <math.h>
#include <stdint.h>

#include <type_traits>

#include "common.cuh"
#include "mma_sync.cuh"

namespace {

constexpr int kGllRows = 64;       // rows of a block's tile: four warp rows of 16
constexpr int kGllThreads = 256;   // eight warps: four rows of 16 x two halves of the split
constexpr int kGllChunk = 64;      // features per staged chunk: four k-steps of 16
constexpr int kGllStages = 3;      // cp.async ring depth, in chunks
constexpr int kGllMaxClasses = 64;  // classes of one split at most: 4 n8 tiles per warp
constexpr int kGllRowBytes = 144;  // a bf16 row of one chunk (128 bytes), padded for ldmatrix

// Bytes of a staged row of one chunk: bf16 rows padded for ldmatrix, fp32 rows (read
// only by the split pass, 16 bytes a lane along the row) not.
template <typename T>
__host__ __device__ constexpr int ring_row_bytes() {
  return sizeof(T) == 2 ? kGllRowBytes : 4 * kGllChunk;
}

// One ring buffer: the tile's rows of h, then the split's rows of w (fp32).
template <typename T>
__host__ __device__ constexpr int stage_bytes(int classes) {
  return kGllRows * ring_row_bytes<T>() + classes * 4 * kGllChunk;
}

// One buffer of split operands: the three bf16 parts of a chunk's w, then those of its
// fp32 features or its bf16 features as they are (so the ring buffer is free as soon as
// the chunk is split).
template <typename T>
__host__ __device__ constexpr int parts_bytes(int classes) {
  return 3 * classes * kGllRowBytes + (sizeof(T) == 4 ? 3 : 1) * kGllRows * kGllRowBytes;
}

// Dynamic shared memory: the ring, two buffers of split operands (one read by the
// MMAs while the next chunk is split into the other), ||h||^2 of the tile's rows and
// the two class halves' sums of each row.
template <typename T>
__host__ __device__ constexpr int smem_bytes(int classes) {
  return kGllStages * stage_bytes<T>(classes) + 2 * parts_bytes<T>(classes) + 4 * kGllRows +
         2 * 16 * kGllRows;
}

// v1 = bf16(v), v2 = bf16(v - v1), v3 = bf16(v - v1 - v2) of four floats, each as four
// packed bf16, stored 8 bytes each at p1, p2, p3 (the differences are exact in fp32).
__device__ __forceinline__ void split4(float4 v, unsigned char* p1, unsigned char* p2,
                                       unsigned char* p3) {
  float r[4] = {v.x, v.y, v.z, v.w};
  unsigned char* dst[3] = {p1, p2, p3};
#pragma unroll
  for (int part = 0; part < 3; ++part) {
    const __nv_bfloat162 a = __floats2bfloat162_rn(r[0], r[1]);
    const __nv_bfloat162 b = __floats2bfloat162_rn(r[2], r[3]);
    *reinterpret_cast<uint2*>(dst[part]) = make_uint2(
        *reinterpret_cast<const uint32_t*>(&a), *reinterpret_cast<const uint32_t*>(&b));
    const float2 fa = __bfloat1622float2(a), fb = __bfloat1622float2(b);
    r[0] -= fa.x, r[1] -= fa.y, r[2] -= fb.x, r[3] -= fb.y;
  }
}

// 16 bytes of a row at element offset f (n elements of it valid) into shared memory:
// cp.async when `vec` (then the unit is all valid or, with n = 0, zero-filled), else
// scalar loads.
template <typename Bits>
__device__ __forceinline__ void stage16(unsigned char* dst, const Bits* src, const Bits* base,
                                        int n, bool vec) {
  constexpr int kEl = 16 / sizeof(Bits);
  if (vec) {
    cp_async16(smem_addr(dst), n > 0 ? src : base, n > 0);
    return;
  }
  union {
    uint4 v;
    Bits e[kEl];
  } u;
#pragma unroll
  for (int e = 0; e < kEl; ++e) u.e[e] = e < n ? src[e] : Bits(0);
  *reinterpret_cast<uint4*>(dst) = u.v;
}

// A thread's share of staging a chunk, fixed for the whole walk over F: for each of its
// 16-byte units of h (the tile's rows) and of w (the split's classes), the row's
// address at the unit's first feature of chunk 0, the unit's offset in a ring buffer
// and in the chunk, and whether the row exists (past B or C the unit is zero-filled).
template <typename T, int kClasses>
struct Stager {
  using Bits = typename std::conditional<sizeof(T) == 4, uint32_t, uint16_t>::type;
  static constexpr int kEl = 16 / sizeof(T);        // elements of h in a unit
  static constexpr int kHUnits = kGllChunk / kEl;   // units of a row of h
  static constexpr int kHN = kGllRows * kHUnits / kGllThreads;
  static constexpr int kWN = kClasses * 16 / kGllThreads;
  const Bits* h_at[kHN];
  const uint32_t* w_at[kWN];
  int h_sm[kHN], w_sm[kWN], h_f[kHN], w_f[kWN];
  bool h_ok[kHN], w_ok[kWN];

  __device__ __forceinline__ Stager(const T* h, const float* w, int row0, int cls0, int B,
                                    int F, int C) {
#pragma unroll
    for (int i = 0; i < kHN; ++i) {
      const int u = threadIdx.x + i * kGllThreads, r = u / kHUnits, row = row0 + r;
      h_ok[i] = row < B;
      h_f[i] = (u % kHUnits) * kEl;
      h_at[i] = reinterpret_cast<const Bits*>(h) + (size_t)(h_ok[i] ? row : 0) * F + h_f[i];
      h_sm[i] = r * ring_row_bytes<T>() + (u % kHUnits) * 16;
    }
#pragma unroll
    for (int i = 0; i < kWN; ++i) {
      const int u = threadIdx.x + i * kGllThreads, c = cls0 + (u >> 4);
      w_ok[i] = c < C;
      w_f[i] = (u & 15) * 4;
      w_at[i] = reinterpret_cast<const uint32_t*>(w) + (size_t)(w_ok[i] ? c : 0) * F + w_f[i];
      w_sm[i] = kGllRows * ring_row_bytes<T>() + (u >> 4) * 4 * kGllChunk + (u & 15) * 16;
    }
  }

  // Start the copies of the chunk at feature f0 into ring buffer st.
  __device__ __forceinline__ void stage(unsigned char* st, int f0, int F, bool vec_h,
                                        bool vec_w) const {
#pragma unroll
    for (int i = 0; i < kHN; ++i) {
      const int n = h_ok[i] ? max(0, min(kEl, F - f0 - h_f[i])) : 0;
      stage16<Bits>(st + h_sm[i], h_at[i] + f0, h_at[i], n, vec_h);
    }
#pragma unroll
    for (int i = 0; i < kWN; ++i) {
      const int n = w_ok[i] ? max(0, min(4, F - f0 - w_f[i])) : 0;
      stage16<uint32_t>(st + w_sm[i], w_at[i] + f0, w_at[i], n, vec_w);
    }
  }
};

// The split pass over a landed chunk: w into its parts at wp (three buffers of
// kClasses rows); fp32 features into theirs at hp (three of kGllRows rows), bf16 ones
// copied there as they are; ||h||^2 accumulated per thread (fsq[i] for row
// (threadIdx.x + i * kGllThreads) / units), in a fixed order. Each loop makes all its
// shared loads before the arithmetic.
template <typename T, int kClasses, int kFsq>
__device__ __forceinline__ void split_chunk(const unsigned char* st, unsigned char* wp,
                                            unsigned char* hp, float (&fsq)[kFsq]) {
  constexpr int kWPart = kClasses * kGllRowBytes, kHPart = kGllRows * kGllRowBytes;
  constexpr int kWN = kClasses * 16 / kGllThreads;
  const unsigned char* ws = st + kGllRows * ring_row_bytes<T>();
  float4 wv[kWN];
#pragma unroll
  for (int i = 0; i < kWN; ++i) {
    const int u = threadIdx.x + i * kGllThreads;
    wv[i] = *reinterpret_cast<const float4*>(ws + (u >> 4) * 4 * kGllChunk + (u & 15) * 16);
  }
#pragma unroll
  for (int i = 0; i < kWN; ++i) {
    const int u = threadIdx.x + i * kGllThreads;
    unsigned char* d = wp + (u >> 4) * kGllRowBytes + (u & 15) * 8;
    split4(wv[i], d, d + kWPart, d + 2 * kWPart);
  }
  constexpr int kUnits = kGllChunk * (int)sizeof(T) / 16;
  uint4 hv[kFsq];
#pragma unroll
  for (int i = 0; i < kFsq; ++i) {
    const int u = threadIdx.x + i * kGllThreads;
    hv[i] = *reinterpret_cast<const uint4*>(st + u / kUnits * ring_row_bytes<T>() +
                                            u % kUnits * 16);
  }
#pragma unroll
  for (int i = 0; i < kFsq; ++i) {
    const int u = threadIdx.x + i * kGllThreads, r = u / kUnits, q = u % kUnits;
    if constexpr (sizeof(T) == 4) {
      const float4 v = *reinterpret_cast<const float4*>(&hv[i]);
      fsq[i] = fmaf(v.x, v.x, fsq[i]);
      fsq[i] = fmaf(v.y, v.y, fsq[i]);
      fsq[i] = fmaf(v.z, v.z, fsq[i]);
      fsq[i] = fmaf(v.w, v.w, fsq[i]);
      unsigned char* d = hp + r * kGllRowBytes + q * 8;
      split4(v, d, d + kHPart, d + 2 * kHPart);
    } else {
      *reinterpret_cast<uint4*>(hp + r * kGllRowBytes + q * 16) = hv[i];
      const uint32_t words[4] = {hv[i].x, hv[i].y, hv[i].z, hv[i].w};
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const float e0 = __uint_as_float(words[k] << 16);
        const float e1 = __uint_as_float(words[k] & 0xffff0000u);
        fsq[i] = fmaf(e0, e0, fsq[i]);
        fsq[i] = fmaf(e1, e1, fsq[i]);
      }
    }
  }
}

// The chunk's four k-steps for one warp: its 16 rows against its NT n8 tiles of the
// split. h1 w1 into `big`; into `small`, in this order, h1 w2, h1 w3 (bf16 features) or
// h1 w2, h2 w1, h1 w3, h2 w2, h3 w1 (fp32). a / b are this lane's ldmatrix addresses in
// the first part at the chunk's first k-step; the parts lie a_part / b_part bytes apart.
template <bool kF32, int NT>
__device__ __forceinline__ void mma_chunk(float (&big)[NT][4], float (&small)[NT][4],
                                          uint32_t a, uint32_t a_part, uint32_t b,
                                          uint32_t b_part) {
#pragma unroll
  for (int ks = 0; ks < kGllChunk / 16; ++ks) {
    uint32_t a1[4], a2[4], a3[4];
    ldsm_x4(a1, a + ks * 32);
    if constexpr (kF32) {
      ldsm_x4(a2, a + a_part + ks * 32);
      ldsm_x4(a3, a + 2 * a_part + ks * 32);
    }
#pragma unroll
    for (int jp = 0; jp < NT / 2; ++jp) {
      const uint32_t bj = b + jp * 16 * kGllRowBytes + ks * 32;
      uint32_t b1[4], b2[4], b3[4];
      ldsm_x4(b1, bj);
      ldsm_x4(b2, bj + b_part);
      ldsm_x4(b3, bj + 2 * b_part);
#pragma unroll
      for (int k = 0; k < 2; ++k) {
        const int j = 2 * jp + k;
        mma_bf16(big[j], a1, b1[2 * k], b1[2 * k + 1]);
        mma_bf16(small[j], a1, b2[2 * k], b2[2 * k + 1]);
        if constexpr (kF32) mma_bf16(small[j], a2, b1[2 * k], b1[2 * k + 1]);
        mma_bf16(small[j], a1, b3[2 * k], b3[2 * k + 1]);
        if constexpr (kF32) {
          mma_bf16(small[j], a2, b2[2 * k], b2[2 * k + 1]);
          mma_bf16(small[j], a3, b1[2 * k], b1[2 * k + 1]);
        }
      }
    }
  }
}

__device__ __forceinline__ float score(ErrSums e, float fsq, float mask) {
  return sqrtf(err_sq(e) * (fsq + 1.f)) * mask;
}

template <typename T, int NT>
__global__ void __launch_bounds__(kGllThreads, 1)
gll_kernel(const T* __restrict__ h, const float* __restrict__ w,
           const float* __restrict__ bias, const void* __restrict__ labels, int labels64,
           const float* __restrict__ mask, float* __restrict__ out,
           float4* __restrict__ partials, int* __restrict__ tickets, int B, int F, int C,
           int splits, int vec_h, int vec_w) {
  constexpr bool kF32 = sizeof(T) == 4;
  constexpr int kClasses = 16 * NT;  // NT n8 tiles for each of the two warp columns
  constexpr int kStage = stage_bytes<T>(kClasses), kParts = parts_bytes<T>(kClasses);
  constexpr int kWPart = kClasses * kGllRowBytes, kHPart = kGllRows * kGllRowBytes;
  constexpr int kUnits = kGllChunk * (int)sizeof(T) / 16;  // 16-byte units of a row of h
  constexpr int kFsq = kGllRows * kUnits / kGllThreads;
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ int last_block;
  unsigned char* const parts = smem + kGllStages * kStage;  // two of: w1..w3, h1..h3
  float* const fsq_rows = reinterpret_cast<float*>(parts + 2 * kParts);
  float4* const half_sums = reinterpret_cast<float4*>(fsq_rows + kGllRows);  // [2][rows]

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int wr = warp & 3, wc = warp >> 2;  // warp row (16 rows), warp column (NT tiles)
  const int split = blockIdx.x % splits, tile = blockIdx.x / splits;
  const int row0 = tile * kGllRows, cls0 = split * kClasses;
  const int nchunks = (F + kGllChunk - 1) / kGllChunk;

  // ldmatrix row addresses: A rows wr*16 + (lane & 15), k half lane >> 4; B (w rows,
  // i.e. classes) wc*8*NT + (lane & 7) + 8 * (lane >> 4), k half (lane >> 3) & 1.
  const uint32_t a_lane = (wr * 16 + (lane & 15)) * kGllRowBytes + (lane >> 4) * 16;
  const uint32_t b_lane = (wc * 8 * NT + (lane & 7) + ((lane >> 4) << 3)) * kGllRowBytes +
                          ((lane >> 3) & 1) * 16;

  float big[NT][4] = {}, small[NT][4] = {};
  float fsq[kFsq] = {};
  const Stager<T, kClasses> stager(h, w, row0, cls0, B, F, C);
  // Chunks 0 .. kGllStages - 1 in flight; split chunk 0 as soon as it lands.
#pragma unroll
  for (int c = 0; c < kGllStages; ++c) {
    if (c < nchunks) stager.stage(smem + c * kStage, c * kGllChunk, F, vec_h, vec_w);
    cp_async_commit();
  }
  cp_async_wait<kGllStages - 1>();
  __syncthreads();
  split_chunk<T, kClasses, kFsq>(smem, parts, parts + 3 * kWPart, fsq);
  // Iteration c: the MMAs of chunk c (split into parts[c % 2]) while chunk c + 1 is split
  // into the other buffer; one barrier an iteration.
  for (int c = 0; c < nchunks; ++c) {
    cp_async_wait<kGllStages - 2>();  // chunk c + 1 has landed
    __syncthreads();  // parts[c % 2] is complete; iteration c - 1 is done everywhere
    const int next = c + kGllStages;  // into the buffer chunk c was split from
    if (next < nchunks)
      stager.stage(smem + (next % kGllStages) * kStage, next * kGllChunk, F, vec_h, vec_w);
    cp_async_commit();
    unsigned char* const cur = parts + (c & 1) * kParts;
    mma_chunk<kF32, NT>(big, small, smem_addr(cur + 3 * kWPart) + a_lane, kHPart,
                        smem_addr(cur) + b_lane, kWPart);
    if (c + 1 < nchunks) {
      unsigned char* const nxt = parts + ((c + 1) & 1) * kParts;
      split_chunk<T, kClasses, kFsq>(smem + ((c + 1) % kGllStages) * kStage, nxt,
                                     nxt + 3 * kWPart, fsq);
    }
  }
  cp_async_wait<0>();

  // ||h||^2 per row: the lanes that share a row meet in a fixed butterfly.
#pragma unroll
  for (int i = 0; i < kFsq; ++i) {
    for (int off = kUnits / 2; off > 0; off >>= 1)
      fsq[i] += __shfl_xor_sync(~0u, fsq[i], off);
    if (tid % kUnits == 0) fsq_rows[(tid + i * kGllThreads) / kUnits] = fsq[i];
  }

  // Lane (g, t) holds rows g and g + 8 of the warp's 16, classes 8j + 2t and 8j + 2t + 1
  // of its column's NT tiles; each warp sums its half of the split per row.
  const int g = lane >> 2, t = lane & 3;
  const int ccol = cls0 + wc * 8 * NT;
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int rl = wr * 16 + g + 8 * half, row = row0 + rl;
    const int y = row < B ? label_at(labels, labels64, row) : -1;
    float z[NT][2];
    float m = -INFINITY;
#pragma unroll
    for (int j = 0; j < NT; ++j) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int c = ccol + 8 * j + 2 * t + e, k = 2 * half + e;
        z[j][e] = c < C ? (big[j][k] + small[j][k]) + __ldg(bias + c) : -INFINITY;
        m = fmaxf(m, z[j][e]);
      }
    }
    m = fmaxf(m, __shfl_xor_sync(~0u, m, 1));
    m = fmaxf(m, __shfl_xor_sync(~0u, m, 2));
    float s = 0.f, sn = 0.f, q = 0.f;
#pragma unroll
    for (int j = 0; j < NT; ++j) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const float ex = expf(z[j][e] - m);  // 0 past C (z = -inf; m finite or -inf)
        s += ex;
        if (ccol + 8 * j + 2 * t + e != y) {
          sn += ex;
          q = fmaf(ex, ex, q);
        }
      }
    }
#pragma unroll
    for (int off = 1; off < 4; off <<= 1) {
      s += __shfl_xor_sync(~0u, s, off);
      sn += __shfl_xor_sync(~0u, sn, off);
      q += __shfl_xor_sync(~0u, q, off);
    }
    if (t == 0) half_sums[wc * kGllRows + rl] = make_float4(m, s, sn, q);
  }
  __syncthreads();
  // The split's sums per row: the two halves merged in order (a half past C is empty).
  if (tid < kGllRows && row0 + tid < B) {
    const int row = row0 + tid;
    const float4 a = half_sums[tid], b = half_sums[kGllRows + tid];
    const ErrSums e = b.x == -INFINITY ? ErrSums{a.x, a.y, a.z, a.w}
                                       : err_merge({a.x, a.y, a.z, a.w}, {b.x, b.y, b.z, b.w});
    if (splits == 1)
      out[row] = score(e, fsq_rows[tid], mask[row]);
    else
      partials[(size_t)row * splits + split] = make_float4(e.m, e.s, e.sn, e.q);
  }
  if (splits == 1) return;

  // The last block of the row tile merges the splits' sums in split order.
  __threadfence();
  __syncthreads();
  if (tid == 0) last_block = atomicAdd(tickets + tile, 1) == splits - 1;
  __syncthreads();
  if (!last_block) return;
  __threadfence();
  if (tid < kGllRows && row0 + tid < B) {
    const int row = row0 + tid;
    const float4* p = partials + (size_t)row * splits;
    float4 v = __ldcg(p);
    ErrSums e{v.x, v.y, v.z, v.w};
    for (int sp = 1; sp < splits; ++sp) {
      v = __ldcg(p + sp);
      e = err_merge(e, {v.x, v.y, v.z, v.w});
    }
    out[row] = score(e, fsq_rows[tid], mask[row]);
  }
  if (tid == 0) tickets[tile] = 0;  // ready for the next launch on this stream
}

// gll_plan (kernels.py) mirrors this: the split's classes from C alone.
int plan_classes(int C) { return C <= 32 ? 32 : kGllMaxClasses; }

template <typename T, int NT>
cudaError_t launch_nt(const void* h, const float* w, const float* bias, const void* labels,
                      int labels64, const float* mask, float* out, void* partials,
                      int* tickets, int B, int F, int C, cudaStream_t s) {
  constexpr int kClasses = 16 * NT;
  constexpr int kSmem = smem_bytes<T>(kClasses);
  const int splits = (C + kClasses - 1) / kClasses;
  const long long blocks = (long long)((B + kGllRows - 1) / kGllRows) * splits;
  if (blocks > 0x7fffffffLL || (splits > 1 && (partials == nullptr || tickets == nullptr)))
    return cudaErrorInvalidValue;
  const bool vec_h = F % (16 / (int)sizeof(T)) == 0 && (uintptr_t)h % 16 == 0;
  const bool vec_w = F % 4 == 0 && (uintptr_t)w % 16 == 0;
  cudaError_t err =
      cudaFuncSetAttribute(gll_kernel<T, NT>, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmem);
  if (err != cudaSuccess) return err;
  gll_kernel<T, NT><<<(int)blocks, kGllThreads, kSmem, s>>>(
      static_cast<const T*>(h), w, bias, labels, labels64, mask, out,
      static_cast<float4*>(partials), tickets, B, F, C, splits, vec_h, vec_w);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch(const void* h, const float* w, const float* bias, const void* labels,
                   int labels64, const float* mask, float* out, void* partials, int* tickets,
                   int B, int F, int C, cudaStream_t s) {
  if (plan_classes(C) == 32)
    return launch_nt<T, 2>(h, w, bias, labels, labels64, mask, out, partials, tickets, B, F,
                           C, s);
  return launch_nt<T, 4>(h, w, bias, labels, labels64, mask, out, partials, tickets, B, F, C,
                         s);
}

}  // namespace

extern "C" {

// h [B, F] contiguous, dtype 0 = float32, 1 = bfloat16; w [C, F] float32 (nn.Linear's
// layout); bias [C] float32; labels [B] int64 (labels64 = 1) or int32; mask [B] float32;
// out [B] float32. With more than one split (gll_plan: C > 64), partials [B, splits, 4]
// float32 scratch and tickets [ceil(B / 64)] int32, zero before the launch and zero again
// after it (launches that share tickets must not overlap). Returns the launch's
// cudaError_t (0 = success).
int ddt_grand_last_layer(const void* h, int dtype, const float* w, const float* bias,
                         const void* labels, int labels64, const float* mask, float* out,
                         void* partials, int* tickets, int B, int F, int C, void* stream) {
  if (B < 1 || F < 1 || C < 1) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return (int)launch<float>(h, w, bias, labels, labels64, mask, out, partials, tickets, B,
                              F, C, s);
  if (dtype == 1)
    return (int)launch<__nv_bfloat16>(h, w, bias, labels, labels64, mask, out, partials,
                                      tickets, B, F, C, s);
  return (int)cudaErrorInvalidValue;
}

const char* ddt_error_string(int err) { return cudaGetErrorString((cudaError_t)err); }

}  // extern "C"

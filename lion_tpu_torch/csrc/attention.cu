// Softmax attention over tokens, fused, forward and backward, in exact fp32
// FFMA (DiT-3D's blocks, lion_tpu_torch/ops/attention.py). It replaces no
// TPU kernel: the JAX package has no softmax attention over tokens.
//
//   o = softmax(q k^T * scale) v,  q (N, H, L, d), k, v (N, H, Lk, d)
//
// Bound: at DiT-XL/2's 4096 tokens a cloud the FLOPs (4 L Lk d forward,
// 8 L Lk d backward) against the 67 TFLOP/s of fp32 FMA; the 64-token
// windows are small and closer to their bytes. No L x Lk matrix reaches
// device memory: the forward keeps the running max and sum of the online
// softmax and writes o and each row's logsumexp; the backward recomputes
// the probabilities from q, k and the logsumexp.
//
// Design. A block is 4 warps and one 64-row tile of one (item, head); it
// walks the 64-row tiles of the other side through shared memory. Every
// product is `tile_mma`: a warp owns 16 rows of a 64-row output, a lane
// rows r, r + 4, r + 8, r + 12 (r = lane / 8) and the columns 4c..4c+3 of
// each 32-column group plus c + 8t of the rest (c = lane % 8), so a step
// of the depth loop reads 4 broadcast scalars of A and one float4 a group
// of B (one shared-memory wavefront each) for 4 x (d / 8) or 4 x 8 FFMAs.
// Rows of 76 (d-wide) and 68 (64-wide) floats keep both free of bank
// conflicts. Sums run in a fixed order (no atomics): the kernels repeat
// bit for bit.
//
//   dit_attn_fwd<D>       S = Q K^T, the online softmax (row max and sum by
//                         xor shuffles over the row's 8 lanes), O += P V
//   dit_attn_bwd_delta<D> delta = rowsum(dO * O)
//   dit_attn_bwd_dkdv<D>  a 64-key block walks the query tiles: S and dP =
//                         dO V^T with queries as rows, P and dS = P (dP -
//                         delta) to shared memory, dV += P^T dO, dK += dS^T Q
//   dit_attn_bwd_dq<D>    a 64-query block walks the key tiles: dQ += dS K
//
// With `tf32` every operand is rounded to TF32 (cvt.rna) before its
// products, as TF32 tensor cores take them: the check's control.
#include <math.h>
#include <stdint.h>

#include "common.cuh"

namespace {

constexpr int kRows = 64;       // rows of a tile
constexpr int kThreads = 128;   // 4 warps
constexpr int kS64 = 68;        // shared row stride of a 64-wide tile
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

template <int D>
struct Dims {
  static_assert(D % 8 == 0 && D <= 128, "head dim: a multiple of 8, <= 128");
  static constexpr int NV4 = D / 32;          // float4 groups of a lane
  static constexpr int REM = (D % 32) / 8;    // scalar columns of a lane
  static constexpr int NJ = D / 8;            // columns of a lane
  static constexpr int SD = D + 4;            // shared row stride (mod 32:
                                              // 4, 12, 20 or 28)
};

__device__ __forceinline__ float tf32_round(float x) {
  uint32_t u;
  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(u) : "f"(x));
  return __uint_as_float(u);
}

template <bool TF32>
__device__ __forceinline__ float4 operand(float4 v) {
  if (TF32) {
    v.x = tf32_round(v.x); v.y = tf32_round(v.y);
    v.z = tf32_round(v.z); v.w = tf32_round(v.w);
  }
  return v;
}

template <bool TF32>
__device__ __forceinline__ float operand(float v) {
  return TF32 ? tf32_round(v) : v;
}

// acc[i][j] += sum_k A[row(i)][k] B[k][col(j)], k < K. A is read as
// A[row * ARS + k * AKS] (either layout), B as B[k * BRS + col]; row(i) =
// row0 + 4 i; col(j) = 32 g + 4 c + e for j = 4 g + e < 4 NV4, else
// 32 NV4 + 8 t + c for j = 4 NV4 + t.
template <int K, int NV4, int REM, int ARS, int AKS, int BRS>
__device__ __forceinline__ void tile_mma(float (&acc)[4][4 * NV4 + REM],
                                         const float* __restrict__ A,
                                         const float* __restrict__ B,
                                         int row0, int c) {
#pragma unroll 4
  for (int k = 0; k < K; ++k) {
    float a[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) a[i] = A[(row0 + 4 * i) * ARS + k * AKS];
    float b[4 * NV4 + REM];
#pragma unroll
    for (int g = 0; g < NV4; ++g) {
      const float4 v =
          *reinterpret_cast<const float4*>(B + k * BRS + 32 * g + 4 * c);
      b[4 * g] = v.x; b[4 * g + 1] = v.y;
      b[4 * g + 2] = v.z; b[4 * g + 3] = v.w;
    }
#pragma unroll
    for (int t = 0; t < REM; ++t)
      b[4 * NV4 + t] = B[k * BRS + 32 * NV4 + 8 * t + c];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4 * NV4 + REM; ++j)
        acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
  }
}

// A 64 x D tile of rows `src + row * s_row` into shared rows of SD floats
// (row-major), or transposed into dst[d * kS64 + row] (`Trans`).
template <int D, bool Trans, bool TF32>
__device__ __forceinline__ void load_tile(float* dst,
                                          const float* __restrict__ src,
                                          int s_row) {
  constexpr int C4 = D / 4;
  for (int idx = threadIdx.x; idx < kRows * C4; idx += kThreads) {
    // transposed: consecutive threads take consecutive rows (conflict-free
    // scalar stores); row-major: consecutive float4s of a row
    const int row = Trans ? idx % kRows : idx / C4;
    const int c4 = Trans ? idx / kRows : idx % C4;
    const float4 v = operand<TF32>(__ldg(reinterpret_cast<const float4*>(
        src + static_cast<int64_t>(row) * s_row + 4 * c4)));
    if (Trans) {
      dst[(4 * c4) * kS64 + row] = v.x;
      dst[(4 * c4 + 1) * kS64 + row] = v.y;
      dst[(4 * c4 + 2) * kS64 + row] = v.z;
      dst[(4 * c4 + 3) * kS64 + row] = v.w;
    } else {
      *reinterpret_cast<float4*>(dst + row * Dims<D>::SD + 4 * c4) = v;
    }
  }
}

// Store a lane's 4 x NJ tile (rows row0 + 4 i of a 64-row tile at `dst`,
// row stride s_row) times `mul`.
template <int D>
__device__ __forceinline__ void store_rows(float* __restrict__ dst, int s_row,
                                           const float (&acc)[4][Dims<D>::NJ],
                                           int row0, int c, float mul) {
  using Dm = Dims<D>;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    float* p = dst + static_cast<int64_t>(row0 + 4 * i) * s_row;
#pragma unroll
    for (int g = 0; g < Dm::NV4; ++g)
      *reinterpret_cast<float4*>(p + 32 * g + 4 * c) =
          make_float4(acc[i][4 * g] * mul, acc[i][4 * g + 1] * mul,
                      acc[i][4 * g + 2] * mul, acc[i][4 * g + 3] * mul);
#pragma unroll
    for (int t = 0; t < Dm::REM; ++t)
      p[32 * Dm::NV4 + 8 * t + c] = acc[i][4 * Dm::NV4 + t] * mul;
  }
}

struct Strides {
  int n, h, l;
};

__device__ __forceinline__ const float* base(const float* p, Strides s, int b,
                                             int h, int row) {
  return p + static_cast<int64_t>(b) * s.n + static_cast<int64_t>(h) * s.h +
         static_cast<int64_t>(row) * s.l;
}

__device__ __forceinline__ float* base(float* p, Strides s, int b, int h,
                                       int row) {
  return p + static_cast<int64_t>(b) * s.n + static_cast<int64_t>(h) * s.h +
         static_cast<int64_t>(row) * s.l;
}

template <int D>
constexpr int fwd_smem_floats() {
  return 2 * kRows * Dims<D>::SD + D * kS64 + kRows * kS64;
}

template <int D, bool TF32>
__global__ void __launch_bounds__(kThreads, 2)
    dit_attn_fwd(const float* __restrict__ q, const float* __restrict__ k,
                 const float* __restrict__ v, float* __restrict__ o,
                 float* __restrict__ lse, Strides sq, Strides sk, Strides sv,
                 Strides so, int heads, int len, int len_k, float scale_log2) {
  using Dm = Dims<D>;
  extern __shared__ float4 smem4[];
  float* Qs = reinterpret_cast<float*>(smem4);   // [q][d]
  float* Vs = Qs + kRows * Dm::SD;               // [key][d]
  float* Kt = Vs + kRows * Dm::SD;               // [d][key]
  float* Ps = Kt + D * kS64;                     // [q][key]
  const int nh = blockIdx.y, b = nh / heads, h = nh % heads;
  const int q0 = blockIdx.x * kRows;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int row0 = 16 * warp + lane / 8, c = lane % 8;
  load_tile<D, false, TF32>(Qs, base(q, sq, b, h, q0), sq.l);
  float m[4], l[4], acc[4][Dm::NJ];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = -INFINITY;
    l[i] = 0.f;
#pragma unroll
    for (int j = 0; j < Dm::NJ; ++j) acc[i][j] = 0.f;
  }
  for (int k0 = 0; k0 < len_k; k0 += kRows) {
    __syncthreads();   // the previous tile's readers are done
    load_tile<D, true, TF32>(Kt, base(k, sk, b, h, k0), sk.l);
    load_tile<D, false, TF32>(Vs, base(v, sv, b, h, k0), sv.l);
    __syncthreads();
    float s[4][8];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) s[i][j] = 0.f;
    tile_mma<D, 2, 0, Dm::SD, 1, kS64>(s, Qs, Kt, row0, c);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      float mx = -INFINITY;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        s[i][j] *= scale_log2;
        mx = fmaxf(mx, s[i][j]);
      }
#pragma unroll
      for (int x = 1; x < 8; x <<= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, x));
      const float m_new = fmaxf(m[i], mx);
      const float alpha = exp2f(m[i] - m_new);
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        s[i][j] = exp2f(s[i][j] - m_new);
        sum += s[i][j];
      }
#pragma unroll
      for (int x = 1; x < 8; x <<= 1)
        sum += __shfl_xor_sync(0xffffffffu, sum, x);
      l[i] = l[i] * alpha + sum;
      m[i] = m_new;
#pragma unroll
      for (int j = 0; j < Dm::NJ; ++j) acc[i][j] *= alpha;
      float* prow = Ps + (row0 + 4 * i) * kS64;
#pragma unroll
      for (int g = 0; g < 2; ++g)
        *reinterpret_cast<float4*>(prow + 32 * g + 4 * c) = operand<TF32>(
            make_float4(s[i][4 * g], s[i][4 * g + 1], s[i][4 * g + 2],
                        s[i][4 * g + 3]));
    }
    __syncwarp();   // a warp reads back only its own rows of P
    tile_mma<kRows, Dm::NV4, Dm::REM, kS64, 1, Dm::SD>(acc, Ps, Vs, row0, c);
  }
  float inv[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) inv[i] = 1.f / l[i];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < Dm::NJ; ++j) acc[i][j] *= inv[i];
  store_rows<D>(base(o, so, b, h, q0), so.l, acc, row0, c, 1.f);
  if (c == 0) {
#pragma unroll
    for (int i = 0; i < 4; ++i)
      lse[static_cast<int64_t>(nh) * len + q0 + row0 + 4 * i] =
          (m[i] + log2f(l[i])) * kLn2;
  }
}

template <int D>
__global__ void __launch_bounds__(256)
    dit_attn_bwd_delta(const float* __restrict__ o,
                       const float* __restrict__ g, float* __restrict__ delta,
                       Strides so, Strides sg, int heads, int len, int rows) {
  const int idx = blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= rows) return;
  const int nh = idx / len, row = idx % len;
  const int b = nh / heads, h = nh % heads;
  const float4* po = reinterpret_cast<const float4*>(base(o, so, b, h, row));
  const float4* pg = reinterpret_cast<const float4*>(base(g, sg, b, h, row));
  float sum = 0.f;
#pragma unroll
  for (int c4 = 0; c4 < D / 4; ++c4) {
    const float4 a = __ldg(po + c4), e = __ldg(pg + c4);
    sum = fmaf(a.x, e.x, sum);
    sum = fmaf(a.y, e.y, sum);
    sum = fmaf(a.z, e.z, sum);
    sum = fmaf(a.w, e.w, sum);
  }
  delta[idx] = sum;
}

template <int D>
constexpr int dkdv_smem_floats() {
  return 2 * kRows * Dims<D>::SD + 2 * D * kS64 + 2 * kRows * kS64 + 2 * kRows;
}

template <int D, bool TF32>
__global__ void __launch_bounds__(kThreads, 2)
    dit_attn_bwd_dkdv(const float* __restrict__ q, const float* __restrict__ k,
                      const float* __restrict__ v, const float* __restrict__ g,
                      const float* __restrict__ lse,
                      const float* __restrict__ delta, float* __restrict__ dk,
                      float* __restrict__ dv, Strides sq, Strides sk,
                      Strides sv, Strides sg, Strides sdk, int heads, int len,
                      int len_k, float scale_log2, float scale) {
  using Dm = Dims<D>;
  extern __shared__ float4 smem4[];
  float* Qs = reinterpret_cast<float*>(smem4);   // [q][d]
  float* Gs = Qs + kRows * Dm::SD;               // dO [q][d]
  float* Kt = Gs + kRows * Dm::SD;               // [d][key]
  float* Vt = Kt + D * kS64;                     // [d][key]
  float* Ps = Vt + D * kS64;                     // P [q][key]
  float* DSs = Ps + kRows * kS64;                // dS [q][key]
  float* lse_s = DSs + kRows * kS64;             // [q], base 2
  float* del_s = lse_s + kRows;                  // [q]
  const int nh = blockIdx.y, b = nh / heads, h = nh % heads;
  const int k0 = blockIdx.x * kRows;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int row0 = 16 * warp + lane / 8, c = lane % 8;
  load_tile<D, true, TF32>(Kt, base(k, sk, b, h, k0), sk.l);
  load_tile<D, true, TF32>(Vt, base(v, sv, b, h, k0), sv.l);
  float acc_k[4][Dm::NJ], acc_v[4][Dm::NJ];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < Dm::NJ; ++j) acc_k[i][j] = acc_v[i][j] = 0.f;
  for (int q0 = 0; q0 < len; q0 += kRows) {
    __syncthreads();
    load_tile<D, false, TF32>(Qs, base(q, sq, b, h, q0), sq.l);
    load_tile<D, false, TF32>(Gs, base(g, sg, b, h, q0), sg.l);
    if (threadIdx.x < kRows) {
      const int64_t at = static_cast<int64_t>(nh) * len + q0 + threadIdx.x;
      lse_s[threadIdx.x] = lse[at] * kLog2e;
      del_s[threadIdx.x] = delta[at];
    }
    __syncthreads();
    // queries as rows: S = Q K^T, dP = dO V^T
    float s[4][8], dp[4][8];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) s[i][j] = dp[i][j] = 0.f;
    tile_mma<D, 2, 0, Dm::SD, 1, kS64>(s, Qs, Kt, row0, c);
    tile_mma<D, 2, 0, Dm::SD, 1, kS64>(dp, Gs, Vt, row0, c);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = row0 + 4 * i;
      const float lr = lse_s[row], dr = del_s[row];
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const float p = exp2f(s[i][j] * scale_log2 - lr);
        s[i][j] = p;
        dp[i][j] = p * (dp[i][j] - dr);
      }
#pragma unroll
      for (int gq = 0; gq < 2; ++gq) {
        *reinterpret_cast<float4*>(Ps + row * kS64 + 32 * gq + 4 * c) =
            operand<TF32>(make_float4(s[i][4 * gq], s[i][4 * gq + 1],
                                      s[i][4 * gq + 2], s[i][4 * gq + 3]));
        *reinterpret_cast<float4*>(DSs + row * kS64 + 32 * gq + 4 * c) =
            operand<TF32>(make_float4(dp[i][4 * gq], dp[i][4 * gq + 1],
                                      dp[i][4 * gq + 2], dp[i][4 * gq + 3]));
      }
    }
    __syncthreads();
    // keys as rows: dV += P^T dO, dK += dS^T Q (A read down the columns)
    tile_mma<kRows, Dm::NV4, Dm::REM, 1, kS64, Dm::SD>(acc_v, Ps, Gs, row0, c);
    tile_mma<kRows, Dm::NV4, Dm::REM, 1, kS64, Dm::SD>(acc_k, DSs, Qs, row0,
                                                        c);
  }
  store_rows<D>(base(dk, sdk, b, h, k0), sdk.l, acc_k, row0, c, scale);
  store_rows<D>(base(dv, sdk, b, h, k0), sdk.l, acc_v, row0, c, 1.f);
}

template <int D>
constexpr int dq_smem_floats() {
  return 3 * kRows * Dims<D>::SD + 2 * D * kS64 + kRows * kS64;
}

template <int D, bool TF32>
__global__ void __launch_bounds__(kThreads, 2)
    dit_attn_bwd_dq(const float* __restrict__ q, const float* __restrict__ k,
                    const float* __restrict__ v, const float* __restrict__ g,
                    const float* __restrict__ lse,
                    const float* __restrict__ delta, float* __restrict__ dq,
                    Strides sq, Strides sk, Strides sv, Strides sg,
                    Strides sdq, int heads, int len, int len_k,
                    float scale_log2, float scale) {
  using Dm = Dims<D>;
  extern __shared__ float4 smem4[];
  float* Qs = reinterpret_cast<float*>(smem4);   // [q][d]
  float* Gs = Qs + kRows * Dm::SD;               // dO [q][d]
  float* Ks = Gs + kRows * Dm::SD;               // [key][d]
  float* Kt = Ks + kRows * Dm::SD;               // [d][key]
  float* Vt = Kt + D * kS64;                     // [d][key]
  float* DSs = Vt + D * kS64;                    // dS [q][key]
  const int nh = blockIdx.y, b = nh / heads, h = nh % heads;
  const int q0 = blockIdx.x * kRows;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int row0 = 16 * warp + lane / 8, c = lane % 8;
  load_tile<D, false, TF32>(Qs, base(q, sq, b, h, q0), sq.l);
  load_tile<D, false, TF32>(Gs, base(g, sg, b, h, q0), sg.l);
  float lr[4], dr[4], acc[4][Dm::NJ];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int64_t at = static_cast<int64_t>(nh) * len + q0 + row0 + 4 * i;
    lr[i] = lse[at] * kLog2e;
    dr[i] = delta[at];
#pragma unroll
    for (int j = 0; j < Dm::NJ; ++j) acc[i][j] = 0.f;
  }
  for (int k0 = 0; k0 < len_k; k0 += kRows) {
    __syncthreads();
    const float* kb = base(k, sk, b, h, k0);
    load_tile<D, false, TF32>(Ks, kb, sk.l);
    load_tile<D, true, TF32>(Kt, kb, sk.l);
    load_tile<D, true, TF32>(Vt, base(v, sv, b, h, k0), sv.l);
    __syncthreads();
    float s[4][8], dp[4][8];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) s[i][j] = dp[i][j] = 0.f;
    tile_mma<D, 2, 0, Dm::SD, 1, kS64>(s, Qs, Kt, row0, c);
    tile_mma<D, 2, 0, Dm::SD, 1, kS64>(dp, Gs, Vt, row0, c);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      float* row = DSs + (row0 + 4 * i) * kS64;
#pragma unroll
      for (int j = 0; j < 8; ++j)
        dp[i][j] = exp2f(s[i][j] * scale_log2 - lr[i]) * (dp[i][j] - dr[i]);
#pragma unroll
      for (int gq = 0; gq < 2; ++gq)
        *reinterpret_cast<float4*>(row + 32 * gq + 4 * c) =
            operand<TF32>(make_float4(dp[i][4 * gq], dp[i][4 * gq + 1],
                                      dp[i][4 * gq + 2], dp[i][4 * gq + 3]));
    }
    __syncwarp();   // a warp reads back only its own rows of dS
    tile_mma<kRows, Dm::NV4, Dm::REM, kS64, 1, Dm::SD>(acc, DSs, Ks, row0, c);
  }
  store_rows<D>(base(dq, sdq, b, h, q0), sdq.l, acc, row0, c, scale);
}

template <typename K>
cudaError_t allow_smem(K kernel, int bytes) {
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              bytes);
}

template <int D, bool TF32>
int launch_fwd(const float* q, const float* k, const float* v, float* o,
               float* lse, Strides sq, Strides sk, Strides sv, Strides so,
               int n, int heads, int len, int len_k, float scale,
               cudaStream_t stream) {
  const int bytes = 4 * fwd_smem_floats<D>();
  cudaError_t err = allow_smem(dit_attn_fwd<D, TF32>, bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  dit_attn_fwd<D, TF32><<<dim3(len / kRows, n * heads), kThreads, bytes,
                          stream>>>(q, k, v, o, lse, sq, sk, sv, so, heads,
                                    len, len_k, scale * kLog2e);
  return static_cast<int>(cudaGetLastError());
}

template <int D, bool TF32>
int launch_bwd(const float* q, const float* k, const float* v,
               const float* o, const float* g, const float* lse, float* delta,
               float* dq, float* dk, float* dv, Strides sq, Strides sk,
               Strides sv, Strides so, Strides sg, Strides sdq, Strides sdk,
               int n, int heads, int len, int len_k, float scale,
               cudaStream_t stream) {
  const int rows = n * heads * len;
  dit_attn_bwd_delta<D><<<(rows + 255) / 256, 256, 0, stream>>>(
      o, g, delta, so, sg, heads, len, rows);
  const int b_kv = 4 * dkdv_smem_floats<D>(), b_q = 4 * dq_smem_floats<D>();
  cudaError_t err = allow_smem(dit_attn_bwd_dkdv<D, TF32>, b_kv);
  if (err == cudaSuccess) err = allow_smem(dit_attn_bwd_dq<D, TF32>, b_q);
  if (err != cudaSuccess) return static_cast<int>(err);
  dit_attn_bwd_dkdv<D, TF32><<<dim3(len_k / kRows, n * heads), kThreads, b_kv,
                               stream>>>(q, k, v, g, lse, delta, dk, dv, sq,
                                         sk, sv, sg, sdk, heads, len, len_k,
                                         scale * kLog2e, scale);
  dit_attn_bwd_dq<D, TF32><<<dim3(len / kRows, n * heads), kThreads, b_q,
                             stream>>>(q, k, v, g, lse, delta, dq, sq, sk, sv,
                                       sg, sdq, heads, len, len_k,
                                       scale * kLog2e, scale);
  return static_cast<int>(cudaGetLastError());
}

Strides strides_at(const int* s) { return Strides{s[0], s[1], s[2]}; }

}  // namespace

// q, k, v, o: (n, heads, len or len_k, d) float32 with rows contiguous and
// 16-byte aligned; strides[4][3] their (item, head, row) strides in floats.
// lse (n * heads, len). d is 72 (DiT-XL's head); len and len_k multiples
// of 64.
LION_EXPORT int lion_dit_attention_fwd(const void* q, const void* k,
                                       const void* v, void* o, void* lse,
                                       const void* strides, int n, int heads,
                                       int len, int len_k, int d, float scale,
                                       int tf32, void* stream) {
  const int* s = static_cast<const int*>(strides);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (len % kRows || len_k % kRows) return cudaErrorInvalidValue;
  const float *fq = static_cast<const float*>(q),
              *fk = static_cast<const float*>(k),
              *fv = static_cast<const float*>(v);
  float *fo = static_cast<float*>(o), *fl = static_cast<float*>(lse);
  if (d != 72) return cudaErrorInvalidValue;
  const auto run = tf32 ? launch_fwd<72, true> : launch_fwd<72, false>;
  return run(fq, fk, fv, fo, fl, strides_at(s), strides_at(s + 3),
             strides_at(s + 6), strides_at(s + 9), n, heads, len, len_k,
             scale, st);
}

// strides[7][3]: q, k, v, o, dO, dq, and dk = dv (one layout).
// delta (n * heads, len) scratch.
LION_EXPORT int lion_dit_attention_bwd(const void* q, const void* k,
                                       const void* v, const void* o,
                                       const void* g, const void* lse,
                                       void* delta, void* dq, void* dk,
                                       void* dv, const void* strides, int n,
                                       int heads, int len, int len_k, int d,
                                       float scale, int tf32, void* stream) {
  const int* s = static_cast<const int*>(strides);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (len % kRows || len_k % kRows) return cudaErrorInvalidValue;
  const float *fq = static_cast<const float*>(q),
              *fk = static_cast<const float*>(k),
              *fv = static_cast<const float*>(v),
              *fo = static_cast<const float*>(o),
              *fg = static_cast<const float*>(g),
              *fl = static_cast<const float*>(lse);
  float *fd = static_cast<float*>(delta), *fdq = static_cast<float*>(dq),
        *fdk = static_cast<float*>(dk), *fdv = static_cast<float*>(dv);
  if (d != 72) return cudaErrorInvalidValue;
  const auto run = tf32 ? launch_bwd<72, true> : launch_bwd<72, false>;
  return run(fq, fk, fv, fo, fg, fl, fd, fdq, fdk, fdv, strides_at(s),
             strides_at(s + 3), strides_at(s + 6), strides_at(s + 9),
             strides_at(s + 12), strides_at(s + 15), strides_at(s + 18), n,
             heads, len, len_k, scale, st);
}

// K12: approximate-EMD cost of a list of (sample, ref) cloud pairs.
//
// Replaces lion_tpu/ops/pallas/emd.py: _emd_cost_pallas (_emd_kernel),
// reached through emd_approx_pallas by the evaluation metrics.
//
// Semantics (lion_tpu/ops/emd.py:31-71, the auction of PyTorchEMD's
// approxmatch): ten levels, level = -(4^j) for j = 7..-1, then 0. With
// k = exp(level * d2) and d2 the matmul-form squared distance clamped at 0:
//   ratio_l = remain_l / (1e-9 + k @ remain_r)
//   sumr    = (k^T @ ratio_l) * remain_r
//   ratio_r = min(remain_r / (sumr + 1e-9), 1) * remain_r
//   remain_r = max(0, remain_r - sumr)
//   w = k * ratio_l * ratio_r;  remain_l = max(0, remain_l - rowsum(w))
//   cost += sum(w * d2)
// and the pair's cost is the sum over levels divided by N. remain_l and
// remain_r start at multi_l = max(M / N, 1) and multi_r = max(N / M, 1)
// (integer division). No gradient: the metrics only read the cost.
//
// Bound on the H100: arithmetic. Each level touches all N * M entries with
// one exp (the special-function units: 16 results per SM per clock) and
// about ten fp32 operations; the clouds are 24 KB each.
// Design: the TPU kernel keeps the whole (N, M) d2 in VMEM, 16 MB per pair
// at 2048 points, far above an SM's 227 KB of shared memory. Here one CTA
// owns one pair and keeps only the two clouds (x, y, z, |p|^2) and the four
// marginal vectors in shared memory (24 bytes per point: 96 KB at
// 2048 + 2048, so two CTAs fit on one SM); d2 and exp(level * d2) are
// recomputed on the fly in each of the level's three sweeps:
//   1. rows:    suml, then ratio_l;
//   2. columns: sumr, then ratio_r and remain_r;
//   3. rows:    sum_m k * ratio_r (gives remain_l) and sum_m k * d2 *
//               ratio_r (gives the cost).
// A thread owns kRows rows (or columns) and walks the other cloud in index
// order, so every lane of a warp reads the same shared word (a broadcast)
// and every sum is taken in a fixed order: the result is deterministic,
// with no atomics. The inner loop is short, since it runs 30 * N * M times
// per pair: d2 = max(fma(-2px, qx, fma(-2py, qy, fma(-2pz, qz, |p|^2 +
// |q|^2))), 0), the same value whichever cloud is the row (the products
// are the same exact numbers), and k = 2^(level * log2(e) * d2) by the
// special-function unit's `ex2.approx` (the `__expf` form, relative error
// ~2^-22 plus the argument's rounding) rather than `expf`, whose range
// reduction costs several instructions more. The d2 rounding then differs
// from the plain version's by a few fp32 ulps of |p|^2, as the TPU
// kernel's hi/lo bf16 products differ from its XLA form; both are held to
// the JAX package's gate of rtol 2e-3 on the cost.
#include <math.h>

#include "common.cuh"

namespace {

constexpr int kThreads = 512;
constexpr int kRows = 4;  // rows (columns) per thread per pass
constexpr int kWarps = kThreads / 32;

__device__ __forceinline__ float ex2_approx(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ float4 load_point(const float* __restrict__ c,
                                             int i) {
  const float x = c[3 * i], y = c[3 * i + 1], z = c[3 * i + 2];
  return make_float4(x, y, z,
                     __fadd_rn(__fadd_rn(__fmul_rn(x, x), __fmul_rn(y, y)),
                               __fmul_rn(z, z)));
}

// For each of this thread's rows i (of `own`, count n_own) the sums over
// all points j of `other` (count n_other), in index order, of
// k(i, j) * a[j] and, with kCost, of k(i, j) * d2(i, j) * a[j], with
// k = 2^(lvl2 * d2).
template <bool kCost>
__device__ __forceinline__ void sweep(const float4* own, int n_own,
                                      const float4* other, int n_other,
                                      const float* a, float lvl2, int base,
                                      float (&sum)[kRows],
                                      float (&cost)[kRows]) {
  float4 p[kRows];  // (-2x, -2y, -2z, |p|^2)
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    const int i = base + r * kThreads + threadIdx.x;
    const float4 v = i < n_own ? own[i] : make_float4(0.f, 0.f, 0.f, 0.f);
    p[r] = make_float4(-2.0f * v.x, -2.0f * v.y, -2.0f * v.z, v.w);
    sum[r] = 0.0f;
    cost[r] = 0.0f;
  }
  for (int j = 0; j < n_other; ++j) {
    const float4 q = other[j];
    const float aj = a[j];
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      const float d2 = fmaxf(
          fmaf(p[r].x, q.x, fmaf(p[r].y, q.y,
                                 fmaf(p[r].z, q.z, p[r].w + q.w))),
          0.0f);
      const float ka = ex2_approx(lvl2 * d2) * aj;
      sum[r] += ka;
      if (kCost) cost[r] = fmaf(ka, d2, cost[r]);
    }
  }
}

__global__ void __launch_bounds__(kThreads, 2)
emd_kernel(const float* __restrict__ sample, const float* __restrict__ ref,
           const int* __restrict__ pairs, int s_count, int r_count, int n,
           int m, float multi_l, float multi_r, float* __restrict__ out) {
  extern __shared__ float4 smem[];
  float4* xs = smem;                                   // n
  float4* ys = xs + n;                                 // m
  float* remain_l = reinterpret_cast<float*>(ys + m);  // n
  float* ratio_l = remain_l + n;                       // n
  float* remain_r = ratio_l + n;                       // m
  float* ratio_r = remain_r + m;                       // m
  __shared__ float partial[kWarps];

  const int pair = blockIdx.x;
  const int si = pairs[2 * pair], ri = pairs[2 * pair + 1];
  if (si < 0 || si >= s_count || ri < 0 || ri >= r_count) {
    if (threadIdx.x == 0) out[pair] = NAN;  // block-uniform exit
    return;
  }
  const float* xc = sample + static_cast<size_t>(si) * n * 3;
  const float* yc = ref + static_cast<size_t>(ri) * m * 3;
  for (int i = threadIdx.x; i < n; i += kThreads) {
    xs[i] = load_point(xc, i);
    remain_l[i] = multi_l;
  }
  for (int j = threadIdx.x; j < m; j += kThreads) {
    ys[j] = load_point(yc, j);
    remain_r[j] = multi_r;
  }
  __syncthreads();

  float cost = 0.0f;
  float sum[kRows], wd[kRows];
  for (int lv = 0; lv < 10; ++lv) {
    // -(4^7), ..., -(4^-1), then 0, times log2(e) for ex2
    const float lvl2 = lv < 9 ? -exp2f(static_cast<float>(14 - 2 * lv)) *
                                    1.44269504088896341f
                              : 0.0f;
    // 1. rows: ratio_l = remain_l / (1e-9 + k @ remain_r)
    for (int base = 0; base < n; base += kThreads * kRows) {
      sweep<false>(xs, n, ys, m, remain_r, lvl2, base, sum, wd);
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        const int i = base + r * kThreads + threadIdx.x;
        if (i < n) ratio_l[i] = __fdiv_rn(remain_l[i], __fadd_rn(1e-9f, sum[r]));
      }
    }
    __syncthreads();
    // 2. columns: sumr, ratio_r, remain_r
    for (int base = 0; base < m; base += kThreads * kRows) {
      sweep<false>(ys, m, xs, n, ratio_l, lvl2, base, sum, wd);
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        const int j = base + r * kThreads + threadIdx.x;
        if (j < m) {
          const float rr = remain_r[j];
          const float sumr = __fmul_rn(sum[r], rr);
          ratio_r[j] = __fmul_rn(
              fminf(__fdiv_rn(rr, __fadd_rn(sumr, 1e-9f)), 1.0f), rr);
          remain_r[j] = fmaxf(0.0f, __fsub_rn(rr, sumr));
        }
      }
    }
    __syncthreads();
    // 3. rows: remain_l -= ratio_l * (k @ ratio_r); the cost
    for (int base = 0; base < n; base += kThreads * kRows) {
      sweep<true>(xs, n, ys, m, ratio_r, lvl2, base, sum, wd);
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        const int i = base + r * kThreads + threadIdx.x;
        if (i < n) {
          const float rl = ratio_l[i];
          remain_l[i] = fmaxf(0.0f, __fsub_rn(remain_l[i], __fmul_rn(rl, sum[r])));
          cost = __fadd_rn(cost, __fmul_rn(rl, wd[r]));
        }
      }
    }
    __syncthreads();
  }

  // fixed-order block sum: lanes by shuffles, then warps in order
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    cost = __fadd_rn(cost, __shfl_down_sync(0xffffffffu, cost, off));
  if ((threadIdx.x & 31) == 0) partial[threadIdx.x >> 5] = cost;
  __syncthreads();
  if (threadIdx.x == 0) {
    float total = 0.0f;
    for (int w = 0; w < kWarps; ++w) total = __fadd_rn(total, partial[w]);
    out[pair] = __fdiv_rn(total, static_cast<float>(n));
  }
}

}  // namespace

// sample (S, N, 3), ref (R, M, 3) f32, pairs (P, 2) int32 of (sample, ref)
// indices -> out (P,) f32 costs divided by N; NaN for a pair whose indices
// fall outside [0, S) x [0, R). The caller keeps 24 * (N + M) bytes within
// the 227 KB of shared memory a CTA may hold.
LION_EXPORT int lion_emd_cost(const void* sample, const void* ref,
                              const void* pairs, void* out, int p, int s,
                              int r, int n, int m, void* stream) {
  const size_t smem = 24 * (static_cast<size_t>(n) + m);
  cudaError_t err = cudaFuncSetAttribute(
      emd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const float multi_l = n >= m ? 1.0f : static_cast<float>(m / n);
  const float multi_r = n >= m ? static_cast<float>(n / m) : 1.0f;
  emd_kernel<<<p, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(sample), static_cast<const float*>(ref),
      static_cast<const int*>(pairs), s, r, n, m, multi_l, multi_r,
      static_cast<float*>(out));
  return static_cast<int>(cudaGetLastError());
}

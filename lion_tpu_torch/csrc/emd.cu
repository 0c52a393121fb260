// K12: approximate-EMD cost of a list of (sample, ref) cloud pairs.
//
// Replaces lion_tpu/ops/pallas/emd.py: _emd_cost_pallas (_emd_kernel),
// reached through emd_approx_pallas by the evaluation metrics.
//
// Semantics (lion_tpu/ops/emd.py:31-71, the auction of PyTorchEMD's
// approxmatch): ten levels, level = -(4^j) for j = 7..-1, then 0. With
// k = exp(level * d2) and d2 the matmul-form squared distance:
//   ratio_l = remain_l / (1e-9 + k @ remain_r)
//   sumr    = (k^T @ ratio_l) * remain_r
//   ratio_r = min(remain_r / (sumr + 1e-9), 1) * remain_r
//   remain_r = max(0, remain_r - sumr)
//   w = k * ratio_l * ratio_r;  remain_l = max(0, remain_l - rowsum(w))
//   cost += sum(w * d2)
// and the pair's cost is the sum over levels divided by N. remain_l and
// remain_r start at multi_l = max(M / N, 1) and multi_r = max(N / M, 1)
// (integer division). d2 is not clamped at 0, as in the TPU kernel (the
// XLA form clamps; a rounding below 0 only occurs between near-duplicate
// points, where it moves k by ~2^-20 and the cost by ~1e-7 of a point).
// No gradient: the metrics only read the cost.
//
// Bound on the H100: the instructions issued per matrix entry (four
// schedulers of one fp32 instruction a clock an SM); the exps (the
// special-function units' 16 an SM a clock) run beside them, and the clouds
// are 24 KB each.
// Design: the TPU kernel keeps the whole (N, M) d2 in VMEM, 16 MB per pair
// at 2048 points, far above an SM's 227 KB of shared memory. Here one CTA
// owns one pair and keeps only the two clouds and the four marginal
// vectors in shared memory (24 bytes per point: 96 KB at 2048 + 2048, so
// two CTAs fit on one SM); d2 and k are recomputed on the fly in walks over
// the matrix, 20 for the ten levels and 19 exps an entry:
//   * the first row walk: level 0's k @ remain_r, then ratio_l;
//   * per level L = 0..8 a column walk: k^T @ ratio_l, then ratio_r and
//     remain_r;
//   * per level L = 0..7 one fused row walk: level L's row sums of
//     k_L * ratio_r and k_L * d2 * ratio_r (remain_l and the cost) and
//     level L+1's k_{L+1} @ remain_r (its ratio_l). remain_r is final after
//     L's column walk, and the thread that owns a row finishes its
//     remain_l before it forms the next ratio_l. Since t_L = 4 t_{L+1}
//     exactly (below), one exp gives both kernels: k_L = (k_{L+1}^2)^2;
//   * level 8's last row walk (level 9 has k = 1);
//   * level 9 (k = 1): its row sums are one block sum of remain_r, its
//     column sums one block sum of ratio_l, and only its cost
//     sum ratio_l ratio_r d2 walks the matrix, with no exp.
// A thread owns kRows rows (or columns) and walks the other cloud in index
// order, so every lane of a warp reads the same shared word (a broadcast)
// and every sum is taken in a fixed order (the block sums: lanes by
// shuffles, then the warps in order): the result is deterministic, with no
// atomics.
// The entry's arithmetic is what bounds the kernel, so it is kept to four
// fp32 instructions before the exp. The clouds are stored scaled by
// sqrt(log2 e), so their matmul-form squared distance is D = log2(e) d2
// and k = 2^(level D). A walk prescales the point it owns by the level's
// power of two, -level_scale * (-2X, -2Y, -2Z, W), so t = level * D is
// four fmas, fma(., X_q, fma(., Y_q, fma(., Z_q, fma(s, W_q, .)))): exactly
// the level times the unscaled chain, and the same value whichever cloud is
// the row (the products are the same numbers and the sum commutes). So
// every walk weighs an entry with the same k up to the exp's rounding, as
// the plain version's one k, and t_L = 4 t_{L+1} bit for bit. (Folding the
// level's
// log2 e into the point a walk owns instead would not be exact, and the
// row and column walks' k would then differ; the auction carries that
// mismatch past the gate for clouds away from the origin.) The cost sums
// D and is scaled by ln 2 once. k = 2^t by the special-function unit's
// `ex2.approx` (relative error ~2^-22 plus the argument's rounding); the
// squarings add ~4 x 2^-22. The rounding of D differs from the plain
// version's d2 by a few fp32 ulps of |p|^2, as the TPU kernel's hi/lo bf16
// products differ from its XLA form; both are held to the JAX package's
// gate of rtol 2e-3 on the cost.
#include <math.h>

#include "common.cuh"

namespace {

constexpr int kThreads = 512;
constexpr int kRows = 4;  // rows (columns) per thread per walk
constexpr int kWarps = kThreads / 32;
constexpr int kLevels = 10;
// the clouds are stored scaled by sqrt(log2(e)), so that their matmul-form
// squared distance D is log2(e) * d2 and exp(level * d2) = 2^(level * D)
constexpr float kSqrtLog2e = 1.20112240878644983f;
constexpr float kLn2 = 0.693147180559945309f;

// -level of level lv: 4^(7 - lv) for lv < 9 (the last level, 0, has k = 1
// and no walk with an exp). A power of two, so t = -level_scale(lv) * D is
// exact given D, and t_lv == 4 t_(lv+1).
__device__ __forceinline__ float level_scale(int lv) {
  return ldexpf(1.0f, 14 - 2 * lv);
}

__device__ __forceinline__ float ex2_approx(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// Point i of a cloud as (X, Y, Z, X^2 + Y^2 + Z^2), X = x * sqrt(log2 e).
__device__ __forceinline__ float4 load_point(const float* __restrict__ c,
                                             int i) {
  const float x = __fmul_rn(c[3 * i], kSqrtLog2e);
  const float y = __fmul_rn(c[3 * i + 1], kSqrtLog2e);
  const float z = __fmul_rn(c[3 * i + 2], kSqrtLog2e);
  return make_float4(x, y, z,
                     __fadd_rn(__fadd_rn(__fmul_rn(x, x), __fmul_rn(y, y)),
                               __fmul_rn(z, z)));
}

// This thread's kRows points of `own` (count n_own) from row `base`, as
// s * (-2X, -2Y, -2Z, W) for a power of two s; zeros past the end.
__device__ __forceinline__ void own_points(const float4* own, int n_own,
                                           int base, float s,
                                           float4 (&p)[kRows]) {
  const float s2 = -2.0f * s;
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    const int i = base + r * kThreads + threadIdx.x;
    const float4 v = i < n_own ? own[i] : make_float4(0.f, 0.f, 0.f, 0.f);
    p[r] = make_float4(s2 * v.x, s2 * v.y, s2 * v.z, s * v.w);
  }
}

// s * D(p, q) from own_points' p (prescaled by s): fma(-2s X_p, X_q,
// fma(-2s Y_p, Y_q, fma(-2s Z_p, Z_q, fma(s, W_q, s W_p)))), exactly s
// times the same chain at s = 1, and the same value whichever cloud is the
// row (the products are the same numbers and the sum commutes).
__device__ __forceinline__ float scaled_dist(const float4& p, const float4& q,
                                             float s) {
  return fmaf(p.x, q.x, fmaf(p.y, q.y, fmaf(p.z, q.z, fmaf(s, q.w, p.w))));
}

// For each of this thread's rows (own_points at s = -level_scale) the sum
// over the points j of `other`, in index order, of 2^t(i, j) * a[2 j],
// t = s * D; `a` strides over the float2 state of the other side.
__device__ __forceinline__ void exp_sums(const float4 (&p)[kRows],
                                         const float4* other, int n_other,
                                         const float* a, float s,
                                         float (&sum)[kRows]) {
#pragma unroll
  for (int r = 0; r < kRows; ++r) sum[r] = 0.0f;
#pragma unroll 4
  for (int j = 0; j < n_other; ++j) {
    const float4 q = other[j];
    const float aj = a[2 * j];
#pragma unroll
    for (int r = 0; r < kRows; ++r)
      sum[r] = fmaf(ex2_approx(scaled_dist(p[r], q, s)), aj, sum[r]);
  }
}

// A row walk that ends level L (its remain_l and cost) and, when kNext, is
// also level L+1's first: over the columns j in index order, with
// st[j] = (ratio_r, remain_r), p prescaled by s = -level_scale of the
// walk's level (L+1 when kNext, else L), t = s * D and k = 2^t:
//   kNext:  k_L = (k^2)^2, next += k * remain_r
//   else:   k_L = k
//   mass += k_L * ratio_r,  wd += k_L * ratio_r * t
// and wd / s at the end: the sum of k_L * ratio_r * D bit for bit, since s
// is a power of two.
template <bool kNext>
__device__ __forceinline__ void row_walk(const float4 (&p)[kRows],
                                         const float4* ys, const float2* st,
                                         int m, float s,
                                         float (&mass)[kRows],
                                         float (&wd)[kRows],
                                         float (&next)[kRows]) {
#pragma unroll
  for (int r = 0; r < kRows; ++r) mass[r] = wd[r] = next[r] = 0.0f;
#pragma unroll 4
  for (int j = 0; j < m; ++j) {
    const float4 q = ys[j];
    const float2 c = st[j];
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      const float t = scaled_dist(p[r], q, s);
      float k = ex2_approx(t);
      if (kNext) {
        next[r] = fmaf(k, c.y, next[r]);
        k *= k;
        k *= k;
      }
      const float a = k * c.x;
      mass[r] += a;
      wd[r] = fmaf(a, t, wd[r]);
    }
  }
  const float inv = 1.0f / s;
#pragma unroll
  for (int r = 0; r < kRows; ++r) wd[r] *= inv;
}

// The sum over i < count of v[2 i], thread t taking i = t, t + kThreads,
// ... in order, then the lanes by shuffles and the warps in order; every
// thread returns the same value.
__device__ __forceinline__ float block_sum(const float* v, int count,
                                           float* partial) {
  float s = 0.0f;
  for (int i = threadIdx.x; i < count; i += kThreads) s += v[2 * i];
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    s = __fadd_rn(s, __shfl_xor_sync(0xffffffffu, s, off));
  if ((threadIdx.x & 31) == 0) partial[threadIdx.x >> 5] = s;
  __syncthreads();
  float total = 0.0f;
  for (int w = 0; w < kWarps; ++w) total = __fadd_rn(total, partial[w]);
  __syncthreads();  // partial is free again
  return total;
}

// ratio_r and remain_r of column j from its column sum of k^T @ ratio_l.
__device__ __forceinline__ float2 column_update(float2 s, float colsum) {
  const float rr = s.y;
  const float sumr = __fmul_rn(colsum, rr);
  return make_float2(
      __fmul_rn(fminf(__fdiv_rn(rr, __fadd_rn(sumr, 1e-9f)), 1.0f), rr),
      fmaxf(0.0f, __fsub_rn(rr, sumr)));
}

__global__ void __launch_bounds__(kThreads, 2)
emd_kernel(const float* __restrict__ sample, const float* __restrict__ ref,
           const int* __restrict__ pairs, int s_count, int r_count, int n,
           int m, float multi_l, float multi_r, float* __restrict__ out) {
  extern __shared__ float4 smem[];
  float4* xs = smem;                                  // n
  float4* ys = xs + n;                                // m
  float2* ls = reinterpret_cast<float2*>(ys + m);     // n: ratio_l, remain_l
  float2* rs = ls + n;                                // m: ratio_r, remain_r
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
    ls[i] = make_float2(0.0f, multi_l);
  }
  for (int j = threadIdx.x; j < m; j += kThreads) {
    ys[j] = load_point(yc, j);
    rs[j] = make_float2(0.0f, multi_r);
  }
  __syncthreads();

  float4 p[kRows];
  float sum[kRows], wd[kRows], next[kRows];
  float cost = 0.0f;
  // level 0's first row walk: ratio_l = remain_l / (1e-9 + k @ remain_r)
  for (int base = 0; base < n; base += kThreads * kRows) {
    own_points(xs, n, base, -level_scale(0), p);
    exp_sums(p, ys, m, &rs[0].y, -level_scale(0), sum);
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      const int i = base + r * kThreads + threadIdx.x;
      if (i < n) ls[i].x = __fdiv_rn(ls[i].y, __fadd_rn(1e-9f, sum[r]));
    }
  }
  __syncthreads();
  for (int lv = 0; lv < kLevels - 1; ++lv) {
    // t = -level_scale * D: this level's in the column walk, the next
    // level's in a fused row walk
    const float sc = -level_scale(lv);
    // columns: sumr = (k^T @ ratio_l) * remain_r, ratio_r, remain_r
    for (int base = 0; base < m; base += kThreads * kRows) {
      own_points(ys, m, base, sc, p);
      exp_sums(p, xs, n, &ls[0].x, sc, sum);
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        const int j = base + r * kThreads + threadIdx.x;
        if (j < m) rs[j] = column_update(rs[j], sum[r]);
      }
    }
    __syncthreads();
    // rows: remain_l -= ratio_l * (k @ ratio_r) and the cost of level lv;
    // below level 8 also the next level's ratio_l
    const bool fused = lv < kLevels - 2;
    for (int base = 0; base < n; base += kThreads * kRows) {
      const float sr = fused ? -level_scale(lv + 1) : sc;
      own_points(xs, n, base, sr, p);
      if (fused) {
        row_walk<true>(p, ys, rs, m, sr, sum, wd, next);
      } else {
        row_walk<false>(p, ys, rs, m, sr, sum, wd, next);
      }
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        const int i = base + r * kThreads + threadIdx.x;
        if (i < n) {
          const float2 st = ls[i];
          const float rem =
              fmaxf(0.0f, __fsub_rn(st.y, __fmul_rn(st.x, sum[r])));
          cost = __fadd_rn(cost, __fmul_rn(st.x, wd[r]));
          ls[i] = make_float2(
              fused ? __fdiv_rn(rem, __fadd_rn(1e-9f, next[r])) : st.x, rem);
        }
      }
    }
    __syncthreads();
  }
  // level 9, k = 1: ratio_l = remain_l / (1e-9 + sum(remain_r)), the
  // column sums are sum(ratio_l), and only the cost walks the matrix
  const float suml = __fadd_rn(1e-9f, block_sum(&rs[0].y, m, partial));
  for (int i = threadIdx.x; i < n; i += kThreads)
    ls[i].x = __fdiv_rn(ls[i].y, suml);
  __syncthreads();
  const float colsum = block_sum(&ls[0].x, n, partial);
  for (int j = threadIdx.x; j < m; j += kThreads)
    rs[j] = column_update(rs[j], colsum);
  __syncthreads();
  for (int base = 0; base < n; base += kThreads * kRows) {
    own_points(xs, n, base, 1.0f, p);
#pragma unroll
    for (int r = 0; r < kRows; ++r) wd[r] = 0.0f;
#pragma unroll 4
    for (int j = 0; j < m; ++j) {
      const float4 q = ys[j];
      const float rr = rs[j].x;
#pragma unroll
      for (int r = 0; r < kRows; ++r)
        wd[r] = fmaf(rr, scaled_dist(p[r], q, 1.0f), wd[r]);
    }
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      const int i = base + r * kThreads + threadIdx.x;
      if (i < n) cost = __fadd_rn(cost, __fmul_rn(ls[i].x, wd[r]));
    }
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
    // the walks summed D = log2(e) * d2
    out[pair] = __fdiv_rn(__fmul_rn(total, kLn2), static_cast<float>(n));
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

// Device code shared by the bf16 3x3x3 convolutions of K8 (conv3d_pair.cu)
// and K9 (pvblock.cu). A new 3x3x3 conv starts from the halo-brick design
// of conv_brick.cuh (K4 and K10: the brick staged once per chunk of
// channels, the taps as address offsets, wgmma from shared memory); this
// file's per-tap gather is the older design, 4-8x slower than cuDNN.
//
// conv_tile_mma computes one BM x BN tile of y = conv3d_SAME(pro(x), w) of
// one item as an implicit GEMM over (voxels) x (Co) x (27 taps * Ci) on the
// tensor cores: WMMA bf16 16x16x16 fragments with float32 accumulation. The
// block has WM x WN warps, each owning a 32 x 32 piece of the tile (2 x 2
// fragments). Each K-step gathers a BM x 32 input tile of one tap into shared
// memory (the prologue pro(ch, v) runs in float32 on in-grid values and is
// rounded to bf16; the zero halo and channels past Ci load 0) and a 32 x BN
// weight tile, then every warp runs its fragments. The float32 tile ends in
// shared memory (Smem::c) for the caller's epilogue.
#pragma once

#include <mma.h>

#include "common.cuh"

namespace lion {

__device__ __forceinline__ float swish(float v) {
  return v / (1.0f + expf(-v));
}

template <int WM, int WN>
struct ConvTile {
  static constexpr int kBM = 32 * WM;  // voxels
  static constexpr int kBN = 32 * WN;  // output channels
  static constexpr int kBK = 32;       // input channels per K-step
  static constexpr int kThreads = 32 * WM * WN;
  // padded leading dimensions (multiples of 8 bf16 / 4 floats, as WMMA
  // needs; every fragment pointer lands on 32 bytes)
  static constexpr int kLdA = kBK + 8;
  static constexpr int kLdB = kBN + 8;
  static constexpr int kLdC = kBN + 4;
  union Smem {
    struct {
      bf16 a[kBM * kLdA];
      bf16 b[kBK * kLdB];
    } in;
    float c[kBM * kLdC];
  };
};

// The prologue of a conv that reads its input as it is.
struct NoPrologue {
  __device__ float operator()(int, float v) const { return v; }
};

// swish?(v * scale[ch] + shift[ch]) (scale == nullptr: no affine).
template <bool kSwish>
struct AffinePrologue {
  const float* scale;
  const float* shift;
  __device__ float operator()(int ch, float v) const {
    if (scale != nullptr) v = v * scale[ch] + shift[ch];
    return kSwish ? swish(v) : v;
  }
};

__device__ __forceinline__ uint4 load16(const bf16* p, bool l2_only) {
  const uint4* q = reinterpret_cast<const uint4*>(p);
  return l2_only ? __ldcg(q) : *q;
}

__device__ __forceinline__ float load1(const bf16* p, bool l2_only) {
  if (!l2_only) return __bfloat162float(*p);
  return __bfloat162float(
      __ushort_as_bfloat16(__ldcg(reinterpret_cast<const unsigned short*>(p))));
}

// x: the item's grid (r^3, ci) bf16; w: (27, ci, co) bf16. The tile covers
// voxels [v0, v0 + BM) and output channels [n0, n0 + BN). kL2Only reads x
// through L2 only (__ldcg), for a grid written earlier by the same launch.
// Ends with a barrier; the result is in sm.c (row = voxel, col = channel).
template <int WM, int WN, bool kL2Only, class Pro>
__device__ void conv_tile_mma(const bf16* x, const bf16* w, int r, int ci,
                              int co, int v0, int n0, const Pro& pro,
                              typename ConvTile<WM, WN>::Smem& sm) {
  using T = ConvTile<WM, WN>;
  namespace wmma = nvcuda::wmma;
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int wm = warp / WN, wn = warp % WN;
  const int r3 = r * r * r;
  const bool xvec = (ci % 8) == 0;
  const bool wvec = (co % 8) == 0;

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[2][2];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j) wmma::fill_fragment(acc[i][j], 0.0f);

  for (int tap = 0; tap < 27; ++tap) {
    const int kd = tap / 9 - 1, kh = (tap / 3) % 3 - 1, kw = tap % 3 - 1;
    const bf16* wt = w + static_cast<size_t>(tap) * ci * co;
    for (int c0 = 0; c0 < ci; c0 += T::kBK) {
      // input tile: 8 channels of one voxel per item of work
      for (int e = tid; e < T::kBM * (T::kBK / 8); e += T::kThreads) {
        const int row = e / (T::kBK / 8);
        const int ch = c0 + (e % (T::kBK / 8)) * 8;
        const int v = v0 + row;
        float vals[8];
#pragma unroll
        for (int q = 0; q < 8; ++q) vals[q] = 0.0f;
        if (v < r3) {
          const int dd = v / (r * r) + kd, hh = (v / r) % r + kh,
                    ww = v % r + kw;
          if (dd >= 0 && dd < r && hh >= 0 && hh < r && ww >= 0 && ww < r) {
            const bf16* src =
                x + static_cast<size_t>((dd * r + hh) * r + ww) * ci + ch;
            if (xvec && ch + 8 <= ci) {
              const uint4 raw = load16(src, kL2Only);
              const bf16* e8 = reinterpret_cast<const bf16*>(&raw);
#pragma unroll
              for (int q = 0; q < 8; ++q)
                vals[q] = pro(ch + q, __bfloat162float(e8[q]));
            } else {
              for (int q = 0; q < 8 && ch + q < ci; ++q)
                vals[q] = pro(ch + q, load1(src + q, kL2Only));
            }
          }
        }
        uint4 packed;
        bf16* p8 = reinterpret_cast<bf16*>(&packed);
#pragma unroll
        for (int q = 0; q < 8; ++q) p8[q] = __float2bfloat16_rn(vals[q]);
        *reinterpret_cast<uint4*>(sm.in.a + row * T::kLdA + (ch - c0)) =
            packed;
      }
      // weight tile: 8 output channels of one input channel per item
      for (int e = tid; e < T::kBK * (T::kBN / 8); e += T::kThreads) {
        const int k = e / (T::kBN / 8);
        const int n8 = (e % (T::kBN / 8)) * 8;
        const int wc = c0 + k, wo = n0 + n8;
        uint4 packed = make_uint4(0u, 0u, 0u, 0u);
        if (wc < ci) {
          const bf16* src = wt + static_cast<size_t>(wc) * co + wo;
          if (wvec && wo + 8 <= co) {
            packed = *reinterpret_cast<const uint4*>(src);
          } else {
            bf16* p8 = reinterpret_cast<bf16*>(&packed);
            for (int q = 0; q < 8 && wo + q < co; ++q) p8[q] = src[q];
          }
        }
        *reinterpret_cast<uint4*>(sm.in.b + k * T::kLdB + n8) = packed;
      }
      __syncthreads();
#pragma unroll
      for (int kk = 0; kk < T::kBK; kk += 16) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major>
            fa[2];
        wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major>
            fb[2];
#pragma unroll
        for (int i = 0; i < 2; ++i)
          wmma::load_matrix_sync(
              fa[i], sm.in.a + (wm * 32 + 16 * i) * T::kLdA + kk, T::kLdA);
#pragma unroll
        for (int j = 0; j < 2; ++j)
          wmma::load_matrix_sync(
              fb[j], sm.in.b + kk * T::kLdB + wn * 32 + 16 * j, T::kLdB);
#pragma unroll
        for (int i = 0; i < 2; ++i)
#pragma unroll
          for (int j = 0; j < 2; ++j)
            wmma::mma_sync(acc[i][j], fa[i], fb[j], acc[i][j]);
      }
      __syncthreads();
    }
  }
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j)
      wmma::store_matrix_sync(
          sm.c + (wm * 32 + 16 * i) * T::kLdC + wn * 32 + 16 * j, acc[i][j],
          T::kLdC, wmma::mem_row_major);
  __syncthreads();
}

// Round the tile in sm.c to bf16, store its in-range rows into y (the item's
// (r3, co) output) and add the (sum, sumsq) of the ROUNDED values of each
// column to st_sum[ch] / st_sq[ch] (global or shared memory, atomics).
template <int WM, int WN>
__device__ void conv_tile_store(const typename ConvTile<WM, WN>::Smem& sm,
                                bf16* y, int r3, int co, int v0, int n0,
                                float* st_sum, float* st_sq) {
  using T = ConvTile<WM, WN>;
  constexpr int kParts = T::kThreads / T::kBN;
  const int col = threadIdx.x % T::kBN;
  const int part = threadIdx.x / T::kBN;
  const int oc = n0 + col;
  if (oc >= co) return;
  float s = 0.0f, q = 0.0f;
  for (int i = part; i < T::kBM && v0 + i < r3; i += kParts) {
    const bf16 h = __float2bfloat16_rn(sm.c[i * T::kLdC + col]);
    y[static_cast<size_t>(v0 + i) * co + oc] = h;
    const float f = __bfloat162float(h);
    s += f;
    q += f * f;
  }
  atomicAdd(st_sum + oc, s);
  atomicAdd(st_sq + oc, q);
}

// The GroupNorm fold of the TPU conv pair (conv3d_packed.py:537-562), by
// the whole block: from the (sum, sumsq) s1/s2 of conv0's rounded output
// over `count` voxels, with conv0's bias b0 added before the norm and the
// post-norm channel affine (ca, cb), the per-channel (sc, bi) with which
// conv1 reads swish(y0 * sc + bi). Groups of 8, var = E[x^2] - mean^2
// clamped at 0, eps 1e-5. tmp holds 2 * c floats of shared memory. Ends
// with a barrier.
__device__ inline void fold_gn(const float* s1, const float* s2,
                               const float* b0, const float* ca,
                               const float* cb, int c, float count, float* sc,
                               float* bi, float* tmp) {
  for (int ch = threadIdx.x; ch < c; ch += blockDim.x) {
    const float m1 = s1[ch] / count;
    tmp[ch] = m1 + b0[ch];
    tmp[c + ch] = s2[ch] / count + 2.0f * b0[ch] * m1 + b0[ch] * b0[ch];
  }
  __syncthreads();
  const int cg = c / 8;
  for (int ch = threadIdx.x; ch < c; ch += blockDim.x) {
    const int g0 = (ch / cg) * cg;
    float mu = 0.0f, ex2 = 0.0f;
    for (int j = 0; j < cg; ++j) {
      mu += tmp[g0 + j];
      ex2 += tmp[c + g0 + j];
    }
    mu /= cg;
    ex2 /= cg;
    const float rs = __frsqrt_rn(fmaxf(ex2 - mu * mu, 0.0f) + 1e-5f);
    sc[ch] = rs * ca[ch];
    bi[ch] = (b0[ch] - mu) * rs * ca[ch] + cb[ch];
  }
  __syncthreads();
}

// swish(v * sc[ch] + bi[ch]): conv1's prologue after fold_gn.
struct FoldPrologue {
  const float* sc;
  const float* bi;
  __device__ float operator()(int ch, float v) const {
    return swish(v * sc[ch] + bi[ch]);
  }
};

}  // namespace lion

// K8: the conv pair of a PVConv whose input width equals its output width:
// conv0 -> GroupNorm fold -> swish -> conv1, bf16.
//
// Replaces lion_tpu/ops/pallas/conv3d_packed.py: conv3d_packed_pair
// (_conv_kernel_pair). The packed (B, R^2, R*C) layout was the TPU's; the
// grid here is channels-last (B, R, R, R, C).
//
// Semantics: y0 = bf16(conv0(x)) without bias; st0 = (sum, sumsq) of the
// rounded y0; (sc, bi) = the fold of _conv_kernel_pair (conv3d_packed.py:
// 537-562) with the conv bias b0 as a pre-bias, groups of 8,
// var = E[x^2] - mean^2 clamped at 0, eps 1e-5, sc = rs * ca,
// bi = (b0 - mu) * rs * ca + cb; y1 = bf16(conv1(bf16(swish(y0 * sc + bi))))
// and st1 = (sum, sumsq) of the rounded y1.
//
// Bound on the H100: the two convs (2 * 27 * C^2 flops per voxel each) on
// the tensor cores. conv1 needs the whole of conv0's statistics, which no
// block has until every block of conv0 is done, so the pair is two launches
// on one stream: conv0 (as K4's bf16 kernel), then conv1, whose every block
// first folds st0 into (sc, bi) in shared memory and applies the fold and
// swish as the prologue of its input tile. Both convs share K4's tile code
// (conv_tile.cuh).
#include "common.cuh"
#include "conv_tile.cuh"

namespace {

using Tile = lion::ConvTile<2, 2>;
constexpr int kMaxC = 256;

// conv without prologue (conv0), or with the fold + swish prologue (conv1,
// st_in != nullptr).
__global__ void __launch_bounds__(Tile::kThreads)
pair_conv_kernel(const lion::bf16* __restrict__ x,
                 const lion::bf16* __restrict__ w,
                 const float* __restrict__ st_in,
                 const float* __restrict__ b0, const float* __restrict__ ca,
                 const float* __restrict__ cb, int r, int c,
                 lion::bf16* __restrict__ y, float* __restrict__ st_out) {
  __shared__ __align__(128) Tile::Smem sm;
  __shared__ float sc[kMaxC], bi[kMaxC], tmp[2 * kMaxC];
  const int b = blockIdx.z;
  const int r3 = r * r * r;
  const int v0 = blockIdx.x * Tile::kBM;
  const int n0 = blockIdx.y * Tile::kBN;
  const lion::bf16* xb = x + static_cast<size_t>(b) * r3 * c;
  if (st_in == nullptr) {
    lion::conv_tile_mma<2, 2, false>(xb, w, r, c, c, v0, n0,
                                     lion::NoPrologue{}, sm);
  } else {
    const float* s = st_in + static_cast<size_t>(b) * 2 * c;
    lion::fold_gn(s, s + c, b0, ca + static_cast<size_t>(b) * c,
                  cb + static_cast<size_t>(b) * c, c, static_cast<float>(r3),
                  sc, bi, tmp);
    lion::conv_tile_mma<2, 2, false>(xb, w, r, c, c, v0, n0,
                                     lion::FoldPrologue{sc, bi}, sm);
  }
  float* st = st_out + static_cast<size_t>(b) * 2 * c;
  lion::conv_tile_store<2, 2>(sm, y + static_cast<size_t>(b) * r3 * c, r3, c,
                              v0, n0, st, st + c);
}

}  // namespace

// x (B, r, r, r, C) bf16, w0/w1 (3, 3, 3, C, C) bf16, b0 (C,) f32, ca/cb
// (B, C) f32 -> y0 (scratch) and y1 (B, r, r, r, C) bf16, st0 and st1
// (B, 2, C) f32 (zeroed by the caller). C <= 256.
LION_EXPORT int lion_conv3d_pair(const void* x, const void* w0,
                                 const void* b0, const void* ca,
                                 const void* cb, const void* w1, void* y0,
                                 void* st0, void* y1, void* st1, int b, int r,
                                 int c, void* stream) {
  if (c > kMaxC) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid(lion::ceil_div(static_cast<long long>(r) * r * r,
                                 Tile::kBM),
                  lion::ceil_div(c, Tile::kBN), b);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const auto* f0 = static_cast<const float*>(b0);
  const auto* fa = static_cast<const float*>(ca);
  const auto* fb = static_cast<const float*>(cb);
  pair_conv_kernel<<<grid, Tile::kThreads, 0, s>>>(
      static_cast<const lion::bf16*>(x), static_cast<const lion::bf16*>(w0),
      nullptr, f0, fa, fb, r, c, static_cast<lion::bf16*>(y0),
      static_cast<float*>(st0));
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  pair_conv_kernel<<<grid, Tile::kThreads, 0, s>>>(
      static_cast<const lion::bf16*>(y0), static_cast<const lion::bf16*>(w1),
      static_cast<const float*>(st0), f0, fa, fb, r, c,
      static_cast<lion::bf16*>(y1), static_cast<float*>(st1));
  return static_cast<int>(cudaGetLastError());
}

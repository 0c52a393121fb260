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
// the tensor cores. Design: both convs are K4's bf16 brick kernel
// (conv_brick.cuh: brick_conv_bf16, wgmma on a halo brick staged once per
// chunk of channels) on conv_plan's plan for (b, r, C, C, bf16), under
// names of their own. conv1 needs the whole of conv0's statistics, which no
// block has until every block of conv0 is done, so the pair is three
// launches on one stream: conv0 with its statistics; a one-block-per-item
// kernel that folds st0 into (sc, bi) (fold_gn) in global memory; conv1,
// which applies the fold and swish as the prologue of its halo brick.
#include "conv_brick.cuh"

namespace {

using lion::BrickConv;

template <int PD, int kMinBlocks>
__global__ void __launch_bounds__(256, kMinBlocks)
pair_conv0_brick(const BrickConv p) {
  extern __shared__ __align__(128) unsigned char smem[];
  lion::brick_conv_bf16<PD>(p, lion::BrickPrologue{nullptr, nullptr, false},
                            smem);
}

// p.scale / p.shift: the fold (B, C) that pair_fold_kernel wrote.
template <int PD, int kMinBlocks>
__global__ void __launch_bounds__(256, kMinBlocks)
pair_conv1_brick(const BrickConv p) {
  extern __shared__ __align__(128) unsigned char smem[];
  const size_t o = static_cast<size_t>(blockIdx.z) * p.ci;
  lion::brick_conv_bf16<PD>(
      p, lion::BrickPrologue{p.scale + o, p.shift + o, true}, smem);
}

// One block per item: st0 -> (scale, shift) (B, C) in global memory.
__global__ void pair_fold_kernel(const float* __restrict__ st0,
                                 const float* __restrict__ b0,
                                 const float* __restrict__ ca,
                                 const float* __restrict__ cb, int c,
                                 float count, float* __restrict__ scale,
                                 float* __restrict__ shift) {
  const size_t o = static_cast<size_t>(blockIdx.x) * c;
  lion::fold_gn(st0 + 2 * o, st0 + 2 * o + c, b0, ca + o, cb + o, c, count,
                scale + o, shift + o);
}

}  // namespace

// x (B, r, r, r, C) bf16, w0/w1 (3, 3, 3, C, C) bf16, b0 (C,) f32, ca/cb
// (B, C) f32 -> y0 (scratch) and y1 (B, r, r, r, C) bf16, st0 and st1
// (B, 2, C) f32; fold (2, B, C) f32, part (B, bricks, 2, C) f32 scratch
// (the two convs' partial statistics, one after the other) and tickets
// (B, ceil(C / 64)) int32, zero, left zero. C a multiple of 8. The rest is conv_plan's plan for (b, r, C, C, bf16): the
// brick, the tile and blocks per SM, kc, taps, pitches, shared memory.
LION_EXPORT int lion_conv3d_pair(const void* x, const void* w0,
                                 const void* b0, const void* ca,
                                 const void* cb, const void* w1, void* y0,
                                 void* st0, void* y1, void* st1, void* fold,
                                 void* part, void* tickets, int b, int r, int c, int bd, int bh, int bw,
                                 int tile, int min_blocks, int kc, int taps,
                                 int hpitch, int wpitch, int smem,
                                 void* stream) {
  if (c % 8) return static_cast<int>(cudaErrorInvalidValue);
  const int nbd = lion::ceil_div(r, bd), nbh = lion::ceil_div(r, bh),
            nbw = lion::ceil_div(r, bw);
  const dim3 grid(nbd * nbh * nbw, lion::ceil_div(c, 64), b);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* scale = static_cast<float*>(fold);
  float* shift = scale + static_cast<size_t>(b) * c;
  const BrickConv p0{x,    w0,     nullptr, nullptr, y0,
                     static_cast<float*>(st0), static_cast<float*>(part),
                     static_cast<int*>(tickets),
                     r,    c,      c,       c,       bd, bh, bw, nbh, nbw, kc,
                     taps, hpitch, wpitch,  0};
  BrickConv p1 = p0;
  p1.x = y0;
  p1.w = w1;
  p1.y = y1;
  p1.stats = static_cast<float*>(st1);
  p1.scale = scale;
  p1.shift = shift;
  p1.swish = 1;
  return lion::dispatch_bf16(64, tile, min_blocks, [&](auto pd, auto mb) {
    constexpr int PD = decltype(pd)::value, MB = decltype(mb)::value;
    int err = lion::launch_smem(pair_conv0_brick<PD, MB>, grid, 256, smem,
                                s, p0);
    if (err != 0) return err;
    pair_fold_kernel<<<b, 256, 0, s>>>(
        static_cast<const float*>(st0), static_cast<const float*>(b0),
        static_cast<const float*>(ca), static_cast<const float*>(cb), c,
        static_cast<float>(r) * r * r, scale, shift);
    err = static_cast<int>(cudaGetLastError());
    if (err != 0) return err;
    return lion::launch_smem(pair_conv1_brick<PD, MB>, grid, 256, smem, s,
                             p1);
  });
}

// K4: fused eval-path 3x3x3 SAME convolution with input prologue and
// output statistics, in fp32 and bf16; K10: the training conv.
//
// Replaces lion_tpu/ops/pallas/conv3d.py: conv3d_3x3_fused
// (_conv_kernel_planes_fused, _conv_kernel_zblock_fused) and
// lion_tpu/ops/pallas/conv3d_packed.py: conv3d_packed_fused
// (_packed_item_call / _conv_kernel_item, _conv_kernel_packed,
// _packed_small_call / _conv_kernel_packed_small). The packed (B, R^2, R*C)
// layout existed for the TPU's matrix unit and is not carried over.
//
// Semantics: y = conv3d_SAME(pro(x), w) with no bias, where
// pro(x) = x * scale[b, ci] + shift[b, ci], optionally followed by swish,
// applies to in-grid inputs only: the halo is 0 after the prologue. x is
// NDHWC (B, R, R, R, Ci), w is (3, 3, 3, Ci, Co), y is (B, R, R, R, Co).
// stats[b, 0, co] = sum of y, stats[b, 1, co] = sum of y^2 over all R^3
// voxels, summed in a fixed order (conv_brick.cuh: flush_stats), so two runs
// on the same inputs give the same bits. In bf16 the prologue runs in float32
// and is rounded to bf16 before the products (ops/pallas/conv3d.py:460-468),
// the products are summed in float32, y is rounded to bf16 once and the
// statistics are those of the rounded y (conv3d_packed.py:466-472).
//
// K10: y = conv3d_SAME(x, w) in fp32 or bf16 with no bias, no prologue and
// no statistics. Replaces lion_tpu/ops/pallas/conv3d.py: conv3d_3x3_same
// (_conv3d_pallas_fwd, _conv3d_pallas_planes); its custom VJP runs the same
// kernel again for dL/dx with flipped, channel-transposed weights
// (ops/conv3d.py). It is K4's kernel with the statistics compiled out: fp32
// exact FFMA, or bf16 on wgmma with the products summed in fp32 and y
// rounded once (the JAX form's preferred_element_type, conv3d.py:575-579).
// Narrow convs (Co = 4, Ci = 4 or 3) run the same 64-channel tile: the
// weights' columns past Co are zero (ldw pads Co to 16 bytes), the halo's
// channels past Ci are zero-filled, and the store keeps channels < Co.
//
// Bound on the H100: operations. 2 * 27 * Ci * Co per voxel against
// (Ci + Co) elements moved: at r32 C64 fp32 116 GFLOP over 67 TFLOP/s; at r16
// C128->128 bf16 58 GFLOP over 989 TFLOP/s. Design (conv_brick.cuh): a block
// stages its brick's input with the halo once per chunk of channels, runs
// the prologue once per element, and reads every tap as an address offset
// into the brick; the weights stream in double-buffered stages. bf16:
// wgmma with both operands read from shared memory through descriptors
// (output channels as M, 64 voxels of a plane as N), a weight stage's
// products issued back to back. fp32: exact FFMA on an 8-voxel x 8-channel
// register tile per thread whose voxel rows serve the three kw taps. The
// brick, the tile, the chunk and the shared memory come from the plan in
// ops/conv3d.py (conv_plan), which the CPU tests check.
#include "conv_brick.cuh"

namespace {

using lion::bf16;
using lion::BrickConv;

__device__ lion::BrickPrologue prologue_of(const BrickConv& p, int b) {
  const size_t o = static_cast<size_t>(b) * p.ci;
  return {p.scale ? p.scale + o : nullptr, p.shift ? p.shift + o : nullptr,
          p.swish != 0};
}

// bf16: two warpgroups over a brick of 2 PD x 8 x 8 voxels by 64 channels;
// registers for kMinBlocks blocks per SM (2: a block's staging overlaps
// another's products where a block has one chunk only). kStats false is
// K10 (p.stats is null): the same body, a distinct instance so that a
// profile tells K10 from K4.
template <int PD, int kMinBlocks, bool kStats>
__global__ void __launch_bounds__(256, kMinBlocks)
conv3d_brick_bf16(const BrickConv p) {
  extern __shared__ __align__(128) unsigned char smem[];
  lion::brick_conv_bf16<PD>(p, prologue_of(p, blockIdx.z), smem);
}

// fp32: 256 threads, 2048 TV / BN voxels x BN channels; kStats false is K10.
template <int BN, int TV, bool kStats>
__global__ void __launch_bounds__(256) conv3d_brick_f32(const BrickConv p) {
  extern __shared__ __align__(128) unsigned char smem[];
  using Tile = lion::BrickTileF32<BN, TV>;
  float* const buf = reinterpret_cast<float*>(smem);
  const lion::Brick k(p, BN);
  Tile tile(p, k);
  lion::brick_pipeline(
      p, k, BN, prologue_of(p, k.b), buf,
      [&](const float* h, const float* w, int tap0) {
        tile.step(p, k, h, w, tap0);
      });
  tile.store(p, k, buf, kStats);
  if (kStats) lion::flush_stats(p, k, BN, buf, Tile::kSlots);
}

template <bool kStats>
int launch_f32(const BrickConv& p, dim3 grid, int bn, int tile, int smem,
               cudaStream_t s) {
  switch (bn * 16 + tile) {
    case 64 * 16 + 2:
      return lion::launch_smem(conv3d_brick_f32<64, 2, kStats>, grid, 256,
                               smem, s, p);
    case 32 * 16 + 8:
      return lion::launch_smem(conv3d_brick_f32<32, 8, kStats>, grid, 256,
                               smem, s, p);
    case 32 * 16 + 4:
      return lion::launch_smem(conv3d_brick_f32<32, 4, kStats>, grid, 256,
                               smem, s, p);
    case 32 * 16 + 2:
      return lion::launch_smem(conv3d_brick_f32<32, 2, kStats>, grid, 256,
                               smem, s, p);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// x (B, r, r, r, ci), w (27, ci, ldw) (ldw >= co, a multiple of 16 bytes,
// columns past co zero), scale/shift (B, ci) f32 or null -> y (B, r, r, r,
// co), stats (B, 2, co) f32 or null; fp32 or bf16 (is_bf16). With stats:
// part (B, bricks, 2, co) f32 scratch and tickets (B, ceil(co / bn)) int32,
// zero, left zero. The rest is the plan (ops/conv3d.py: conv_plan): the brick
// (bd, bh, bw), bn output channels and the tile per block, the blocks per
// SM the bf16 kernel keeps registers for, kc channels per chunk, taps per
// weight stage, the shared-memory pitches and bytes.
LION_EXPORT int lion_conv3d_brick(const void* x, const void* w,
                                  const void* scale, const void* shift,
                                  void* y, void* stats, void* part,
                                  void* tickets, int b, int r, int ci,
                                  int co, int ldw, int is_bf16, int pre_swish,
                                  int bd, int bh, int bw, int bn, int tile,
                                  int min_blocks, int kc, int taps,
                                  int hpitch, int wpitch, int smem,
                                  void* stream) {
  const int nbd = lion::ceil_div(r, bd), nbh = lion::ceil_div(r, bh),
            nbw = lion::ceil_div(r, bw);
  const BrickConv p{x,  w,  static_cast<const float*>(scale),
                    static_cast<const float*>(shift),
                    y,  static_cast<float*>(stats), static_cast<float*>(part),
                    static_cast<int*>(tickets),
                    r,  ci, co, ldw, bd, bh, bw, nbh, nbw, kc, taps, hpitch,
                    wpitch, pre_swish};
  const dim3 grid(nbd * nbh * nbw, lion::ceil_div(co, bn), b);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_bf16)
    return lion::dispatch_bf16(bn, tile, min_blocks, [&](auto pd, auto mb) {
      constexpr int PD = decltype(pd)::value, MB = decltype(mb)::value;
      return stats ? lion::launch_smem(conv3d_brick_bf16<PD, MB, true>, grid,
                                       256, smem, s, p)
                   : lion::launch_smem(conv3d_brick_bf16<PD, MB, false>,
                                       grid, 256, smem, s, p);
    });
  return stats ? launch_f32<true>(p, grid, bn, tile, smem, s)
               : launch_f32<false>(p, grid, bn, tile, smem, s);
}

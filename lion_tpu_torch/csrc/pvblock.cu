// K9: the whole voxel branch of a PVConv at r = 8, C = 128 in one launch:
// voxelize -> conv0 -> GroupNorm fold -> swish -> conv1 -> devoxelize, bf16.
//
// Replaces lion_tpu/ops/pallas/pvblock.py: pvconv_block_pair
// (_block_kernel).
//
// Semantics: those of the K3 -> K8 -> K5 chain in bf16 (see
// ops/pvblock.py): grid = bf16(float32 mean of the features per cell);
// y0 = bf16(conv0(grid)); the fold of st0 (conv_brick.cuh: fold_gn);
// y1 = bf16(conv1(bf16(swish(y0 * sc + bi)))); st1 = (sum, sumsq) of the
// rounded y1; points = bf16(sum over the 8 corners of y1 * bf16(weight)).
//
// Bound on the H100: the two convs, 2 * 27 * 128^2 flops per voxel each
// (0.45 GFLOP per item and conv at r = 8), on the tensor cores, and the
// latency of the five dependent stages. An item is 8^3 x 128 bf16 (128 KB);
// the zero-padded 10^3 grid would be 256 KB, more than one block's shared
// memory.
// Design: one thread-block cluster of 8 blocks per item, one launch. Block
// `rank` = 2 pp + half owns output planes d in [2 pp, 2 pp + 2) and output
// channels [64 half, 64 half + 64): the brick of K4's bf16 tile
// (BrickTileWgmma<1>, two warpgroups of one 8 x 8 plane by 64 channels),
// with conv_plan's brick, tiles and chunk for (b, 8, 128, 128, bf16)
// (ops/conv3d.py): the 8 blocks are its grid of 4 bricks x 2 channel
// tiles. A weight stage holds 3 taps, not the plan's 9, so that two blocks
// fit an SM (79 KB of shared memory each) and a batch of 16 clusters fits
// the card at once. The block voxelizes its 128 cells x 64 channels, stages
// each conv's (2+2) x 10 x 10 halo brick from the item's grid with
// cp.async.cg (through L2, which holds what the other blocks wrote once
// they passed a fence and a cluster barrier), runs the wgmma products over
// 4 chunks of 32 channels x 9 stages of 3 taps, stores its piece of y0 / y1
// and keeps its partial statistics in shared memory, and devoxelizes N / 8
// of the points. The grids (grid, y0, y1) live in a
// global scratch that stays in L2. Each block folds the item's st0 from the
// 8 partials, read through distributed shared memory and summed in rank
// order, so the statistics do not depend on the order of the blocks. The
// voxelize sums each cell's features in point order, from a stable cell
// order of the points that the block builds as K3 does (csrc/voxelize.cu:
// integer counts, their scan, ranks within a warp by __match_any_sync, the
// warps taking turns), so it equals K3 and the plain version bit for bit.
// No float is added with atomics: the kernel repeats bit for bit.
#include <cooperative_groups.h>

#include "conv_brick.cuh"

namespace cg = cooperative_groups;

namespace {

using lion::bf16;

constexpr int kR = 8;
constexpr int kC = 128;
constexpr int kR3 = kR * kR * kR;
constexpr int kCluster = 8;
constexpr int kMaxN = 4096;
constexpr int kPlanes = 2;                // output planes per block
constexpr int kBn = 64;                   // output channels per block
constexpr int kCells = kPlanes * kR * kR;  // output cells a block owns
constexpr int kKc = 32;                   // input channels per chunk
constexpr int kTaps = 3;                  // taps per weight stage
constexpr int kHalo = (kPlanes + 2) * (kR + 2) * (kR + 2);
// two blocks per SM: 16 clusters of 8 fit the H100 at once (at one
// block per SM its GPCs hold 14, and batch 16 takes two waves)
constexpr int kBlocksPerSm = 2;
constexpr int kTilePd = kPlanes / 2;      // planes per warpgroup
static_assert(lion::BrickTileWgmma<kTilePd>::kBn == kBn &&
                  (kR / kPlanes) * (kC / kBn) == kCluster,
              "the cluster is the plan's grid of one item");

// brick_pipeline's buffers: two halo chunks, two weight stages, the cells
struct ConvSmem {
  bf16 halo[2][kHalo * kKc];
  bf16 w[2][kTaps * kKc * kBn];
  int cell[kHalo];
};

// the voxelize's stable order: each owned cell's first slot in `order`
// (the exclusive scan of the counts, start[kCells] = the points owned), the
// cursors that place the points, each point's owned cell or -1, and the
// owned points listed cell by cell in ascending point order
struct VoxSmem {
  int start[kCells + 1];
  int cursor[kCells];
  int cell[kMaxN];
  int order[kMaxN];
};

constexpr int kSmem = sizeof(ConvSmem) > sizeof(VoxSmem) ? sizeof(ConvSmem)
                                                         : sizeof(VoxSmem);

__device__ __forceinline__ void cluster_barrier(cg::cluster_group& cluster) {
  __threadfence();  // this block's global writes, visible to the cluster
  cluster.sync();
}

__device__ __forceinline__ float load_l2(const bf16* p) {
  return __bfloat162float(__ushort_as_bfloat16(
      __ldcg(reinterpret_cast<const unsigned short*>(p))));
}

// The sum over the 4 plane pairs of channel half `half`'s partial (sum,
// sumsq) i (i < 2 kBn), in rank order.
__device__ __forceinline__ float cluster_sum(cg::cluster_group& cluster,
                                             float* part, int half, int i) {
  float s = 0.0f;
  for (int pp = 0; pp < kCluster / 2; ++pp)
    s += cluster.map_shared_rank(part, 2 * pp + half)[i];
  return s;
}

__global__ void __cluster_dims__(kCluster, 1, 1)
    __launch_bounds__(256, kBlocksPerSm)
    pvblock_brick(const bf16* __restrict__ feats,
                  const int* __restrict__ vox,
                  const float* __restrict__ coords,
                  const bf16* __restrict__ w0, const float* __restrict__ b0,
                  const float* __restrict__ ca, const float* __restrict__ cb,
                  const bf16* __restrict__ w1, int n, bf16* scratch,
                  bf16* __restrict__ out, float* __restrict__ st1_out) {
  extern __shared__ __align__(128) unsigned char smem[];
  // statistics (sum, sumsq) of this block's channels (the tile's slots
  // summed in order), the item's st0 and the fold
  __shared__ float st0[2 * kBn], st1[2 * kBn], tot[2 * kC], sc[kC], bi[kC];
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = static_cast<int>(cluster.block_rank());
  const int pp = rank >> 1, half = rank & 1;
  const int b = blockIdx.y;
  const int tid = threadIdx.x, nt = blockDim.x;
  // scratch (2, B, r^3, C): the grids, then y0; y1 goes over the grid,
  // which is dead once conv0 is done
  bf16* grids = scratch;
  bf16* y0s = scratch + static_cast<size_t>(gridDim.y) * kR3 * kC;
  bf16* grid = grids + static_cast<size_t>(b) * kR3 * kC;

  // ---- voxelize this block's cells and channels ----
  {
    VoxSmem& vs = *reinterpret_cast<VoxSmem*>(smem);
    const int* vb = vox + static_cast<size_t>(b) * n * 3;
    const int cell0 = pp * kCells;
    const int lane = tid & 31, warp = tid >> 5;
    for (int i = tid; i < kCells; i += nt) vs.cursor[i] = 0;
    for (int p = tid; p < n; p += nt) {
      const int x = vb[3 * p], y = vb[3 * p + 1], z = vb[3 * p + 2];
      const bool in = x >= 0 && x < kR && y >= 0 && y < kR && z >= 0 &&
                      z < kR;
      const int c = in ? (x * kR + y) * kR + z - cell0 : -1;
      vs.cell[p] = (c >= 0 && c < kCells) ? c : -1;
    }
    __syncthreads();
    // the counts (integer atomics: their sum does not depend on the order)
    for (int p = tid; p < n; p += nt)
      if (vs.cell[p] >= 0) atomicAdd(&vs.cursor[vs.cell[p]], 1);
    __syncthreads();
    if (warp == 0) {  // exclusive scan: lane l owns cells [4 l, 4 l + 4)
      static_assert(kCells == 4 * 32, "four cells a lane");
      int cnt[4], total = 0;
#pragma unroll
      for (int j = 0; j < 4; ++j) total += cnt[j] = vs.cursor[4 * lane + j];
      int inc = total;
#pragma unroll
      for (int d = 1; d < 32; d <<= 1) {
        const int v = __shfl_up_sync(0xffffffffu, inc, d);
        if (lane >= d) inc += v;
      }
      int at = inc - total;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        vs.start[4 * lane + j] = vs.cursor[4 * lane + j] = at;
        at += cnt[j];
      }
      if (lane == 31) vs.start[kCells] = inc;
    }
    __syncthreads();
    // stable placement, nt points a round: a point goes to its cell's
    // cursor plus its rank among its warp's lanes in the same cell; the
    // warps take turns in warp order to read and move the cursors
    for (int i0 = 0; i0 < n; i0 += nt) {
      const int i = i0 + tid;
      const int c = i < n ? vs.cell[i] : -1;
      const unsigned peers = __match_any_sync(0xffffffffu, c);
      const int rank = __popc(peers & ((1u << lane) - 1u));
      int at = 0;
      for (int w = 0; w < nt / 32; ++w) {
        if (warp == w) {
          if (c >= 0) at = vs.cursor[c];
          __syncwarp();
          if (c >= 0 && rank == 0) vs.cursor[c] = at + __popc(peers);
        }
        __syncthreads();
      }
      if (c >= 0) vs.order[at + rank] = i;
    }
    __syncthreads();
    // each (cell, channel): the float32 sum of its points in point order
    // over the count, rounded once (K3's mean)
    const bf16* fb = feats + static_cast<size_t>(b) * n * kC + half * kBn;
    for (int e = tid; e < kCells * kBn; e += nt) {
      const int c = e / kBn, ch = e % kBn;
      const int s0 = vs.start[c], s1 = vs.start[c + 1];
      float acc = 0.0f;
      for (int j = s0; j < s1; ++j)
        acc = __fadd_rn(acc, __bfloat162float(
                                 fb[static_cast<size_t>(vs.order[j]) * kC +
                                    ch]));
      grid[static_cast<size_t>(cell0 + c) * kC + half * kBn + ch] =
          __float2bfloat16_rn(
              s1 > s0 ? __fdiv_rn(acc, static_cast<float>(s1 - s0)) : 0.0f);
    }
  }
  cluster_barrier(cluster);

  // ---- conv0 of this block's brick ----
  lion::BrickConv p{grids, w0,      nullptr, nullptr, y0s,   nullptr,
                    nullptr, nullptr, kR,    kC,      kC,    kC,
                    kPlanes, kR,      kR,    1,       1,     kKc,
                    kTaps,   kKc,     kBn,   0};
  const lion::Brick k(p, pp, half * kBn, b);
  bf16* const buf = reinterpret_cast<bf16*>(smem);
  const float* slots = reinterpret_cast<const float*>(smem);
  constexpr int kSlots = lion::BrickTileWgmma<kTilePd>::kSlots;
  lion::brick_conv_block<kTilePd>(
      p, k, lion::BrickPrologue{nullptr, nullptr, false}, buf, true);
  __syncthreads();
  for (int i = tid; i < 2 * kBn; i += nt)
    st0[i] = lion::slot_sum(slots, kSlots, 2 * kBn, i);
  cluster_barrier(cluster);

  // ---- fold: the item's st0 is the sum of the 4 plane pairs' ----
  for (int i = tid; i < 2 * kC; i += nt) {
    const int c = i % kC;
    tot[i] = cluster_sum(cluster, st0, c / kBn, (i / kC) * kBn + c % kBn);
  }
  __syncthreads();
  const size_t o = static_cast<size_t>(b) * kC;
  lion::fold_gn(tot, tot + kC, b0, ca + o, cb + o, kC,
                static_cast<float>(kR3), sc, bi);

  // ---- conv1 of this block's brick (the pipeline's first barrier
  // publishes sc / bi) ----
  p.x = y0s;
  p.w = w1;
  p.y = grids;
  lion::brick_conv_block<kTilePd>(p, k, lion::BrickPrologue{sc, bi, true},
                                  buf, true);
  __syncthreads();
  for (int i = tid; i < 2 * kBn; i += nt)
    st1[i] = lion::slot_sum(slots, kSlots, 2 * kBn, i);
  cluster_barrier(cluster);

  if (pp == 0) {  // one block per channel half writes the item's st1
    for (int i = tid; i < 2 * kBn; i += nt)
      st1_out[o * 2 + (i / kBn) * kC + half * kBn + i % kBn] =
          cluster_sum(cluster, st1, half, i);
  }

  // ---- devoxelize this block's share of the points ----
  const int per = n / kCluster;
  const float* cb3 = coords + (static_cast<size_t>(b) * n + rank * per) * 3;
  bf16* ob = out + (static_cast<size_t>(b) * n + rank * per) * kC;
  for (int e = tid; e < per * kC; e += nt) {
    const bf16* g = grid + e % kC;
    ob[e] = __float2bfloat16_rn(lion::trilinear<bf16>(
        cb3 + (e / kC) * 3, kR,
        [&](size_t cell) { return load_l2(g + cell * kC); }));
  }
  // no block may leave while another reads its shared memory
  cluster.sync();
}

}  // namespace

// feats (B, N, 128) bf16, vox (B, N, 3) i32, coords (B, N, 3) f32 in [0, 7];
// w0/w1 (3, 3, 3, 128, 128) bf16; b0 (128,) f32; ca/cb (B, 128) f32;
// scratch (2, B, 512, 128) bf16 -> out (B, N, 128) bf16, st1 (B, 2, 128)
// f32. r must be 8, C 128, N a multiple of 8 and at most 4096.
LION_EXPORT int lion_pvconv_block_pair(const void* feats, const void* vox,
                                       const void* coords, const void* w0,
                                       const void* b0, const void* ca,
                                       const void* cb, const void* w1,
                                       void* scratch, void* out, void* st1,
                                       int b, int n, int c, int r,
                                       void* stream) {
  if (r != kR || c != kC || n % kCluster || n > kMaxN)
    return static_cast<int>(cudaErrorInvalidValue);
  return lion::launch_smem(
      pvblock_brick, dim3(kCluster, b), 256, kSmem,
      static_cast<cudaStream_t>(stream), static_cast<const bf16*>(feats),
      static_cast<const int*>(vox), static_cast<const float*>(coords),
      static_cast<const bf16*>(w0), static_cast<const float*>(b0),
      static_cast<const float*>(ca), static_cast<const float*>(cb),
      static_cast<const bf16*>(w1), n, static_cast<bf16*>(scratch),
      static_cast<bf16*>(out), static_cast<float*>(st1));
}

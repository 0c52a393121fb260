// K9: the whole voxel branch of a PVConv at r = 8, C = 128 in one launch:
// voxelize -> conv0 -> GroupNorm fold -> swish -> conv1 -> devoxelize, bf16.
//
// Replaces lion_tpu/ops/pallas/pvblock.py: pvconv_block_pair
// (_block_kernel).
//
// Semantics: those of the K3 -> K8 -> K5 chain in bf16 (see
// ops/pvblock.py): grid = bf16(float32 mean of the features per cell);
// y0 = bf16(conv0(grid)); the fold of st0 (conv_tile.cuh fold_gn);
// y1 = bf16(conv1(bf16(swish(y0 * sc + bi)))); st1 = (sum, sumsq) of the
// rounded y1; points = bf16(sum over the 8 corners of y1 * bf16(weight)).
//
// Bound on the H100: the two convs, 2 * 27 * 128^2 flops per voxel each
// (0.45 GFLOP per item and conv at r = 8), on the tensor cores, and the
// latency of the five dependent stages. An item is 8^3 x 128 bf16 (128 KB);
// the zero-padded 10^3 grid would be 256 KB, more than one block's shared
// memory.
// Design: one thread-block cluster of 8 blocks per item, one launch. Block
// `rank` owns the 64 cells [64 rank, 64 rank + 64): it voxelizes them
// (scatter-adds in shared memory), computes their rows of conv0 and conv1
// (conv_tile.cuh, 8 warps, 64 x 128 tiles) and devoxelizes N / 8 of the
// points. The grids (grid, y0, y1) live in a per-item global scratch that
// stays in L2 and is read with __ldcg; each stage ends with a fence and a
// cluster barrier. The statistics of each block stay in its shared memory;
// the fold sums the 8 blocks' partial statistics through distributed
// shared memory.
#include <cooperative_groups.h>

#include "common.cuh"
#include "conv_tile.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kR = 8;
constexpr int kC = 128;
constexpr int kR3 = kR * kR * kR;
constexpr int kCluster = 8;
constexpr int kCells = kR3 / kCluster;  // cells per block, = Tile::kBM
constexpr int kMaxN = 4096;
using Tile = lion::ConvTile<2, 4>;      // 64 voxels x 128 channels
static_assert(kCells == Tile::kBM && kC == Tile::kBN, "one tile per block");

struct VoxSmem {
  float sums[kCells * kC];
  int count[kCells];
  int cell[kMaxN];
};

struct ConvSmem {
  Tile::Smem tile;
  float st0[2 * kC];
  float st1[2 * kC];
  float tot[2 * kC];
  float sc[kC];
  float bi[kC];
  float tmp[2 * kC];
};

union BlockSmem {
  VoxSmem vox;
  ConvSmem conv;
};

__device__ __forceinline__ void cluster_barrier(cg::cluster_group& cluster) {
  __threadfence();  // this block's global writes, visible to the cluster
  cluster.sync();
}

__global__ void __cluster_dims__(kCluster, 1, 1) __launch_bounds__(
    Tile::kThreads)
pvblock_kernel(const lion::bf16* __restrict__ feats,
               const int* __restrict__ vox, const float* __restrict__ coords,
               const lion::bf16* __restrict__ w0,
               const float* __restrict__ b0, const float* __restrict__ ca,
               const float* __restrict__ cb,
               const lion::bf16* __restrict__ w1, int n,
               lion::bf16* scratch, lion::bf16* __restrict__ out,
               float* __restrict__ st1_out) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  BlockSmem& sm = *reinterpret_cast<BlockSmem*>(smem_raw);
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = static_cast<int>(cluster.block_rank());
  const int b = blockIdx.y;
  const int tid = threadIdx.x;
  const int nt = blockDim.x;
  const int v0 = rank * kCells;
  lion::bf16* grid = scratch + static_cast<size_t>(b) * 2 * kR3 * kC;
  lion::bf16* y0 = grid + kR3 * kC;
  lion::bf16* y1 = grid;  // the grid is dead once conv0 is done

  // ---- voxelize this block's cells ----
  {
    VoxSmem& vs = sm.vox;
    const int* vb = vox + static_cast<size_t>(b) * n * 3;
    for (int i = tid; i < kCells * kC; i += nt) vs.sums[i] = 0.0f;
    for (int i = tid; i < kCells; i += nt) vs.count[i] = 0;
    for (int p = tid; p < n; p += nt) {
      const int x = vb[3 * p], y = vb[3 * p + 1], z = vb[3 * p + 2];
      const bool in = x >= 0 && x < kR && y >= 0 && y < kR && z >= 0 &&
                      z < kR;
      const int c = in ? (x * kR + y) * kR + z - v0 : -1;
      vs.cell[p] = (c >= 0 && c < kCells) ? c : -1;
    }
    __syncthreads();
    for (int p = tid; p < n; p += nt)
      if (vs.cell[p] >= 0) atomicAdd(&vs.count[vs.cell[p]], 1);
    const lion::bf16* fb = feats + static_cast<size_t>(b) * n * kC;
    for (int e = tid; e < n * kC; e += nt) {
      const int c = vs.cell[e / kC];
      if (c >= 0)
        atomicAdd(&vs.sums[c * kC + e % kC], __bfloat162float(fb[e]));
    }
    __syncthreads();
    for (int i = tid; i < kCells * kC; i += nt) {
      const int k = vs.count[i / kC];
      grid[static_cast<size_t>(v0) * kC + i] =
          __float2bfloat16_rn(k > 0 ? vs.sums[i] / static_cast<float>(k)
                                    : 0.0f);
    }
  }
  cluster_barrier(cluster);

  // ---- conv0 of this block's cells ----
  ConvSmem& cs = sm.conv;
  for (int i = tid; i < 2 * kC; i += nt) {
    cs.st0[i] = 0.0f;
    cs.st1[i] = 0.0f;
  }
  __syncthreads();
  lion::conv_tile_mma<2, 4, true>(grid, w0, kR, kC, kC, v0, 0,
                                  lion::NoPrologue{}, cs.tile);
  lion::conv_tile_store<2, 4>(cs.tile, y0, kR3, kC, v0, 0, cs.st0,
                              cs.st0 + kC);
  cluster_barrier(cluster);

  // ---- fold: the item's st0 is the sum of the 8 blocks' ----
  for (int i = tid; i < 2 * kC; i += nt) {
    float s = 0.0f;
    for (int q = 0; q < kCluster; ++q)
      s += cluster.map_shared_rank(cs.st0, q)[i];
    cs.tot[i] = s;
  }
  __syncthreads();
  lion::fold_gn(cs.tot, cs.tot + kC, b0, ca + static_cast<size_t>(b) * kC,
                cb + static_cast<size_t>(b) * kC, kC,
                static_cast<float>(kR3), cs.sc, cs.bi, cs.tmp);

  // ---- conv1 of this block's cells ----
  lion::conv_tile_mma<2, 4, true>(y0, w1, kR, kC, kC, v0, 0,
                                  lion::FoldPrologue{cs.sc, cs.bi}, cs.tile);
  lion::conv_tile_store<2, 4>(cs.tile, y1, kR3, kC, v0, 0, cs.st1,
                              cs.st1 + kC);
  cluster_barrier(cluster);

  if (rank == 0) {
    for (int i = tid; i < 2 * kC; i += nt) {
      float s = 0.0f;
      for (int q = 0; q < kCluster; ++q)
        s += cluster.map_shared_rank(cs.st1, q)[i];
      st1_out[static_cast<size_t>(b) * 2 * kC + i] = s;
    }
  }
  // no block may leave while rank 0 reads its shared memory
  cluster.sync();

  // ---- devoxelize this block's share of the points ----
  const int per = n / kCluster;
  const float* cb3 = coords + (static_cast<size_t>(b) * n + rank * per) * 3;
  lion::bf16* ob = out + (static_cast<size_t>(b) * n + rank * per) * kC;
  for (int e = tid; e < per * kC; e += nt) {
    const lion::bf16* g = y1 + e % kC;
    ob[e] = __float2bfloat16_rn(lion::trilinear<lion::bf16>(
        cb3 + (e / kC) * 3, kR,
        [&](size_t cell) { return lion::load1(g + cell * kC, true); }));
  }
}

}  // namespace

// feats (B, N, 128) bf16, vox (B, N, 3) i32, coords (B, N, 3) f32 in [0, 7];
// w0/w1 (3, 3, 3, 128, 128) bf16; b0 (128,) f32; ca/cb (B, 128) f32;
// scratch (B, 2, 512, 128) bf16 -> out (B, N, 128) bf16, st1 (B, 2, 128)
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
  const int smem = static_cast<int>(sizeof(BlockSmem));
  cudaError_t err = cudaFuncSetAttribute(
      pvblock_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  pvblock_kernel<<<dim3(kCluster, b), Tile::kThreads, smem,
                   static_cast<cudaStream_t>(stream)>>>(
      static_cast<const lion::bf16*>(feats), static_cast<const int*>(vox),
      static_cast<const float*>(coords), static_cast<const lion::bf16*>(w0),
      static_cast<const float*>(b0), static_cast<const float*>(ca),
      static_cast<const float*>(cb), static_cast<const lion::bf16*>(w1), n,
      static_cast<lion::bf16*>(scratch), static_cast<lion::bf16*>(out),
      static_cast<float*>(st1));
  return static_cast<int>(cudaGetLastError());
}

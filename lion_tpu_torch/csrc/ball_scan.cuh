// The ball scan shared by the three ball queries: K2 (ball_query_group.cu),
// K11 (ball_query.cu) and K13 (ball_query_group_cf.cu). Each adds its own
// epilogue.
//
// A ball is the first K point indices, in index order, whose squared
// distance to the center (lion::sq_dist) is strictly below r^2. A block
// stages the item's cloud in shared memory as (x, y, z, 0), one 16-byte
// load a point, in tiles of up to kTileN points (any N), each padded to
// whole rounds with points at infinity (in no ball). A warp scans two
// centers at a time, each point it loads from shared memory tested against
// both: kChunks 32-point chunks a round, each lane testing one point of
// each, so a round holds 2 kChunks independent tests. Most balls hold a
// few of the cloud's points, so most rounds find no hit: one vote skips
// them; otherwise one ballot a chunk and center assigns the slots by
// prefix popcounts in index order. The scan stops after the round in which
// both centers have K hits (the slots are set by then). The hit counts
// carry from tile to tile in shared memory.
#pragma once

#include <cmath>

#include "common.cuh"

namespace lion {

constexpr int kTileN = 2048;          // cloud points a shared-memory tile
constexpr int kChunks = 4;            // 32-point chunks a warp tests a round
constexpr int kRound = 32 * kChunks;  // points a warp tests a round

// One chunk of a center's scan: the lanes' hits take the next slots in
// index order (prefix popcounts); hits past K are counted, not kept. Most
// chunks of a round with a hit hold none for this center: they stop at
// the ballot.
__device__ __forceinline__ void take(bool hit, int j, unsigned below, int k,
                                     int* count, int* sel) {
  const unsigned mask = __ballot_sync(0xffffffffu, hit);
  if (mask == 0u) return;
  const int slot = *count + __popc(mask & below);
  if (hit && slot < k) sel[slot] = j;
  *count += __popc(mask);
}

// A warp's scan of the staged points scloud[0, cnt) (global index t0 + j)
// for centers ca and cc (the same when the pair has one center, whose
// twin counts as full); the slots of center c are ssel[c K, c K + K).
__device__ __forceinline__ void scan_pair(const float4* scloud, int cnt,
                                          int t0, const float* cb, int ca,
                                          int cc, int k, float r2,
                                          int* ssel, int* scount) {
  const int lane = threadIdx.x & 31;
  const unsigned below = (1u << lane) - 1u;
  const float ax = cb[3 * ca], ay = cb[3 * ca + 1], az = cb[3 * ca + 2];
  const float bx = cb[3 * cc], by = cb[3 * cc + 1], bz = cb[3 * cc + 2];
  int count_a = scount[ca];                        // warp-uniform
  int count_b = cc != ca ? scount[cc] : k;
  for (int j0 = 0; j0 < cnt && (count_a < k || count_b < k);
       j0 += kRound) {
    bool hit_a[kChunks], hit_b[kChunks], any = false;
#pragma unroll
    for (int u = 0; u < kChunks; ++u) {
      const float4 p = scloud[j0 + 32 * u + lane];
      hit_a[u] = sq_dist(ax, ay, az, p.x, p.y, p.z) < r2;
      hit_b[u] = sq_dist(bx, by, bz, p.x, p.y, p.z) < r2;
      any = any || hit_a[u] || hit_b[u];
    }
    if (!__any_sync(0xffffffffu, any)) continue;   // most rounds
#pragma unroll
    for (int u = 0; u < kChunks; ++u) {
      const int j = t0 + j0 + 32 * u + lane;
      take(hit_a[u], j, below, k, &count_a, ssel + ca * k);
      take(hit_b[u], j, below, k, &count_b, ssel + cc * k);
    }
  }
  __syncwarp();
  if (lane == 0) {
    scount[ca] = count_a;
    if (cc != ca) scount[cc] = count_b;
  }
  __syncwarp();
}

// The balls of a block's ncent centers cb[0, ncent) in the cloud pts
// (n, 3), into ssel (K slots a center) and scount (the hit counts, which
// the caller zeroes before the call). The block stages the cloud `tile`
// points at a time into scloud (tile + kRound float4); warp w scans the
// pairs of centers (2w, 2w + 1), (2w + 2 warps, ...) on each tile. Right
// after a pair's scan of the last tile its warp calls done(ca, nc), the
// pair being centers ca, ca + nc - 1, whose slots and counts are then
// final and visible to the warp. No barrier follows the last scan, so one
// warp's epilogue can overlap another's scan.
template <class Done>
__device__ __forceinline__ void scan_block(float4* scloud, const float* pts,
                                           int n, int tile, const float* cb,
                                           int ncent, int k, float r2,
                                           int* ssel, int* scount,
                                           Done&& done) {
  const int t = threadIdx.x, warp = t >> 5, warps = blockDim.x >> 5;
  for (int t0 = 0; t0 < n; t0 += tile) {
    const int cnt = min(tile, n - t0);
    __syncthreads();   // the counts are set; the last tile is scanned
    const int padded = (cnt + kRound - 1) / kRound * kRound;
    for (int j = t; j < padded; j += blockDim.x) {
      float4 v = make_float4(INFINITY, INFINITY, INFINITY, 0.0f);
      if (j < cnt) {
        const float* p = pts + 3 * static_cast<size_t>(t0 + j);
        v = make_float4(p[0], p[1], p[2], 0.0f);
      }
      scloud[j] = v;
    }
    __syncthreads();
    const bool last = t0 + tile >= n;
    for (int ca = 2 * warp; ca < ncent; ca += 2 * warps) {
      const int nc = min(2, ncent - ca);
      scan_pair(scloud, cnt, t0, cb, ca, ca + nc - 1, k, r2, ssel, scount);
      if (last) done(ca, nc);
    }
  }
}

// Slot s of a center whose scan found `count` hits into sel: slots past
// the hit count copy slot 0; an empty ball takes point 0.
__device__ __forceinline__ int ball_slot(const int* sel, int count, int k,
                                         int s) {
  const int found = min(count, k);
  return s < found ? sel[s] : (found > 0 ? sel[0] : 0);
}

}  // namespace lion

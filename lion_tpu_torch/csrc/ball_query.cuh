// Device code shared by K2 (ball_query_group.cu) and K11 (ball_query.cu):
// one warp finds the ball of one center.
#pragma once

#include "common.cuh"

namespace lion {

// The first k point indices, in index order, whose squared distance to the
// center (cx, cy, cz) is strictly below r2, written to sel[0..k) by the 32
// lanes of one warp. Slots past the hit count copy slot 0; an empty ball
// takes point 0 in every slot. The warp scans the cloud 32 points at a time;
// __ballot_sync/__popc assign hit slots in index order with no sort, and the
// scan stops once k hits are found. pts is (n, 3).
__device__ __forceinline__ void warp_ball_query(float cx, float cy, float cz,
                                                const float* __restrict__ pts,
                                                int n, int k, float r2,
                                                int* sel) {
  const int lane = threadIdx.x & 31;
  int count = 0;  // identical in every lane
  for (int base = 0; base < n && count < k; base += 32) {
    const int j = base + lane;
    bool hit = false;
    if (j < n) {
      hit = sq_dist(cx, cy, cz, pts[3 * j], pts[3 * j + 1], pts[3 * j + 2]) <
            r2;
    }
    const unsigned mask = __ballot_sync(0xffffffffu, hit);
    if (hit) {
      const int slot = count + __popc(mask & ((1u << lane) - 1u));
      if (slot < k) sel[slot] = j;
    }
    count += __popc(mask);
  }
  __syncwarp();
  const int found = count < k ? count : k;
  const int first = found > 0 ? sel[0] : 0;
  __syncwarp();
  for (int s = found + lane; s < k; s += 32) sel[s] = first;
  __syncwarp();
}

}  // namespace lion

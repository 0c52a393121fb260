// K2: fused ball query + grouping.
//
// Replaces lion_tpu/ops/pallas/ball_query_group.py: ball_query_group_pallas
// (_bqg_kernel).
//
// Semantics: for each center, the first K points (in index order) whose
// squared distance is strictly below r^2. Slots past the hit count copy
// slot 0; an empty ball takes point 0 in every slot. Each slot emits the
// row [point - center (3), point features (C)] in fp32.
//
// Bound on the H100: device-memory bandwidth on the output, which is
// K * (3 + C) floats per center (K = 32), against N * 12 bytes of coords
// read per center (L1/L2 resident).
// Design: one warp per center scans the cloud 32 points at a time;
// __ballot_sync/__popc assign hit slots in index order with no sort, the
// scan stops once K hits are found, and the rows are written with lanes
// over channels so each store is contiguous.
#include "common.cuh"

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;

__global__ void __launch_bounds__(kThreads)
bqg_kernel(const float* __restrict__ points, const float* __restrict__ ctrs,
           const float* __restrict__ feats, int n, int m, int c, int k,
           float r2, float* __restrict__ out) {
  extern __shared__ int slots[];  // kWarps * k point indices
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int b = blockIdx.y;
  const int center = blockIdx.x * kWarps + warp;
  if (center >= m) return;  // warp-uniform; no block barrier below

  int* sel = slots + warp * k;
  const float* ctr = ctrs + (static_cast<size_t>(b) * m + center) * 3;
  const float cx = ctr[0], cy = ctr[1], cz = ctr[2];
  const float* pts = points + static_cast<size_t>(b) * n * 3;

  int count = 0;  // identical in every lane
  for (int base = 0; base < n && count < k; base += 32) {
    const int j = base + lane;
    bool hit = false;
    if (j < n) {
      hit = lion::sq_dist(cx, cy, cz, pts[3 * j], pts[3 * j + 1],
                          pts[3 * j + 2]) < r2;
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

  const int width = 3 + c;
  float* o = out + (static_cast<size_t>(b) * m + center) * k * width;
  const float* f = feats + static_cast<size_t>(b) * n * c;
  for (int s = 0; s < k; ++s) {
    const int p = sel[s];
    float* row = o + static_cast<size_t>(s) * width;
    for (int ch = lane; ch < width; ch += 32) {
      row[ch] = ch < 3 ? __fsub_rn(pts[3 * p + ch], ctr[ch])
                       : f[static_cast<size_t>(p) * c + (ch - 3)];
    }
  }
}

}  // namespace

// points (B, N, 3), centers (B, M, 3), feats (B, N, C) f32
// -> out (B, M, K, 3 + C) f32. r2 is the squared radius in fp32.
LION_EXPORT int lion_ball_query_group(const void* points, const void* centers,
                                      const void* feats, void* out, int b,
                                      int n, int m, int c, int k,
                                      float r2, void* stream) {
  const dim3 grid(lion::ceil_div(m, kWarps), b);
  const size_t smem = static_cast<size_t>(kWarps) * k * sizeof(int);
  bqg_kernel<<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(points), static_cast<const float*>(centers),
      static_cast<const float*>(feats), n, m, c, k, r2,
      static_cast<float*>(out));
  return static_cast<int>(cudaGetLastError());
}

// K11: index-only ball query.
//
// Replaces lion_tpu/ops/pallas/ball_query.py: ball_query_pallas
// (_bq_kernel). The JAX package reaches it from the backward replay of
// ball_query_group (lion_tpu/ops/points.py:241-254 -> ball_query,
// :135-137); the port's backward of ball_query_group calls it the same way.
//
// Semantics: for each center, the first K point indices (index order)
// whose squared distance ((dx*dx + dy*dy) + dz*dz, each operation rounded
// on its own) is strictly below r^2, as int32. Slots past the hit count
// copy slot 0; an empty ball is all 0 (ball_query.py:83-87).
//
// Bound on the H100: the distance scan, 8 fp32 operations per (center,
// point) pair up to the K-th hit, against K * 4 bytes written per center;
// at B16 M1024 N2048 r0.1 it is a few microseconds either way, so the
// kernel is bounded by its latency.
// Design: one warp per center (ball_query.cuh, shared with K2): the warp
// scans the cloud 32 points at a time and stops at the K-th hit; the slots
// go out with lanes over K.
#include "ball_query.cuh"
#include "common.cuh"

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;

__global__ void __launch_bounds__(kThreads)
bq_kernel(const float* __restrict__ points, const float* __restrict__ ctrs,
          int n, int m, int k, float r2, int* __restrict__ out) {
  extern __shared__ int slots[];  // kWarps * k point indices
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int b = blockIdx.y;
  const int center = blockIdx.x * kWarps + warp;
  if (center >= m) return;  // warp-uniform; no block barrier below

  int* sel = slots + warp * k;
  const float* ctr = ctrs + (static_cast<size_t>(b) * m + center) * 3;
  lion::warp_ball_query(ctr[0], ctr[1], ctr[2],
                        points + static_cast<size_t>(b) * n * 3, n, k, r2,
                        sel);
  int* o = out + (static_cast<size_t>(b) * m + center) * k;
  for (int s = lane; s < k; s += 32) o[s] = sel[s];
}

}  // namespace

// centers (B, M, 3), points (B, N, 3) f32 -> out (B, M, K) int32. r2 is the
// squared radius in fp32.
LION_EXPORT int lion_ball_query(const void* centers, const void* points,
                                void* out, int b, int n, int m, int k,
                                float r2, void* stream) {
  const dim3 grid(lion::ceil_div(m, kWarps), b);
  const size_t smem = static_cast<size_t>(kWarps) * k * sizeof(int);
  bq_kernel<<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(points), static_cast<const float*>(centers),
      n, m, k, r2, static_cast<int*>(out));
  return static_cast<int>(cudaGetLastError());
}

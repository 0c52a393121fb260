// K1: furthest point sampling.
//
// Replaces lion_tpu/ops/pallas/fps.py: furthest_point_sample_pallas
// (_fps_kernel) and furthest_point_sample_idx_pallas.
//
// Semantics: index 0 seeds the chain; each next pick is the argmax of the
// running minimum squared distance to the picks so far, ties going to the
// lowest index. Emits the indices (B, M) and the picked coords (B, M, 3),
// copied bit for bit from the input.
//
// Bound on the H100: latency. The M picks form a serial chain, so each
// cloud is one block and a pick costs one pass over N points plus a block
// argmax (two barriers). Only B of the 132 SMs work.
// Design: one block per cloud keeps the coords and the running min-distance
// in shared memory (16 bytes a point, 32 KB at N = 2048), so the chain never
// touches device memory except to write its picks.
#include <cmath>

#include "common.cuh"

namespace {

constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;

// Keep (v, i) if it beats (bv, bi): larger value, or equal value and
// lower index.
__device__ __forceinline__ void keep_better(float& bv, int& bi, float v,
                                            int i) {
  if (v > bv || (v == bv && i < bi)) {
    bv = v;
    bi = i;
  }
}

__device__ __forceinline__ void warp_argmax(float& bv, int& bi) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    const float v = __shfl_down_sync(0xffffffffu, bv, off);
    const int i = __shfl_down_sync(0xffffffffu, bi, off);
    keep_better(bv, bi, v, i);
  }
}

__global__ void __launch_bounds__(kThreads)
fps_kernel(const float* __restrict__ xyz, int n, int m,
           int* __restrict__ idx, float* __restrict__ centers) {
  extern __shared__ float smem[];
  float* sx = smem;
  float* sy = sx + n;
  float* sz = sy + n;
  float* sd = sz + n;
  __shared__ float red_v[kWarps];
  __shared__ int red_i[kWarps];
  __shared__ int s_pick;

  const int b = blockIdx.x;
  const float* p = xyz + static_cast<size_t>(b) * n * 3;
  int* out_idx = idx + static_cast<size_t>(b) * m;
  float* out_c = centers + static_cast<size_t>(b) * m * 3;
  for (int j = threadIdx.x; j < n; j += kThreads) {
    sx[j] = p[3 * j];
    sy[j] = p[3 * j + 1];
    sz[j] = p[3 * j + 2];
    sd[j] = INFINITY;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    out_idx[0] = 0;
    out_c[0] = sx[0];
    out_c[1] = sy[0];
    out_c[2] = sz[0];
  }

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  int last = 0;
  for (int s = 1; s < m; ++s) {
    const float cx = sx[last], cy = sy[last], cz = sz[last];
    float bv = -INFINITY;
    int bi = n;
    for (int j = threadIdx.x; j < n; j += kThreads) {
      const float d = fminf(sd[j], lion::sq_dist(sx[j], sy[j], sz[j],
                                                 cx, cy, cz));
      sd[j] = d;
      keep_better(bv, bi, d, j);
    }
    warp_argmax(bv, bi);
    if (lane == 0) {
      red_v[warp] = bv;
      red_i[warp] = bi;
    }
    __syncthreads();
    if (warp == 0) {
      bv = lane < kWarps ? red_v[lane] : -INFINITY;
      bi = lane < kWarps ? red_i[lane] : n;
      warp_argmax(bv, bi);
      if (lane == 0) {
        s_pick = bi;
        out_idx[s] = bi;
        out_c[3 * s] = sx[bi];
        out_c[3 * s + 1] = sy[bi];
        out_c[3 * s + 2] = sz[bi];
      }
    }
    __syncthreads();
    last = s_pick;
  }
}

}  // namespace

// xyz (B, N, 3) f32 -> idx (B, M) i32, centers (B, M, 3) f32.
LION_EXPORT int lion_fps(const void* xyz, void* idx, void* centers, int b,
                         int n, int m, void* stream) {
  const size_t smem = static_cast<size_t>(n) * 4 * sizeof(float);
  if (smem > 48 * 1024) {
    cudaFuncSetAttribute(fps_kernel,
                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                         static_cast<int>(smem));
  }
  fps_kernel<<<b, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(xyz), n, m, static_cast<int*>(idx),
      static_cast<float*>(centers));
  return static_cast<int>(cudaGetLastError());
}

LION_EXPORT const char* lion_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// K3: average voxelization (scatter-mean of point features into r^3 cells).
//
// Replaces lion_tpu/ops/pallas/voxelize.py: avg_voxelize_pallas
// (_vox_kernel) and lion_tpu/ops/pallas/voxelize_binned.py:
// avg_voxelize_binned (_vox_binned_kernel). The TPU needed a dense and a
// point-binned variant to feed its matrix unit; one scatter serves here.
//
// Semantics: cell index x*r^2 + y*r + z; each cell holds the mean of the
// features of the points that fall in it; empty cells hold 0. Features are
// float32 or bfloat16; sums are taken in float32 and the mean is rounded
// once to the features' dtype (lion_tpu/ops/voxel.py:61,92).
//
// Bound on the H100: device-memory bandwidth and atomic throughput. The
// scatter moves N*C floats in and the divide pass touches the whole
// (B, r^3, C) grid once (134 MB at B = 16, r = 32, C = 64).
// Design: one thread per (point, channel) atomically adds into a grid the
// caller zeroed, so neighbouring threads hit neighbouring addresses of one
// cell row; channel 0 also counts the point. A second pass divides by the
// count. Atomic order varies from run to run, so sums agree with a serial
// sum to fp32 rounding, not bit for bit.
#include "common.cuh"

namespace {

constexpr int kThreads = 256;

template <typename T>
__global__ void vox_scatter_kernel(const T* __restrict__ feats,
                                   const int* __restrict__ vox, int b, int n,
                                   int c, int r, float* __restrict__ grid,
                                   float* __restrict__ count) {
  const size_t t = static_cast<size_t>(blockIdx.x) * kThreads + threadIdx.x;
  if (t >= static_cast<size_t>(b) * n * c) return;
  const int ch = static_cast<int>(t % c);
  const size_t pt = t / c;  // b * n + i
  const int* v = vox + pt * 3;
  const int x = v[0], y = v[1], z = v[2];
  if (x < 0 || x >= r || y < 0 || y >= r || z < 0 || z >= r) return;
  const size_t r3 = static_cast<size_t>(r) * r * r;
  const size_t cell = (pt / n) * r3 + (static_cast<size_t>(x) * r + y) * r + z;
  atomicAdd(grid + cell * c + ch, lion::to_float(feats[t]));
  if (ch == 0) atomicAdd(count + cell, 1.0f);
}

// out may alias grid (float32): each thread reads and writes one element.
template <typename T>
__global__ void vox_divide_kernel(const float* grid,
                                  const float* __restrict__ count,
                                  size_t total, int c, T* out) {
  const size_t t = static_cast<size_t>(blockIdx.x) * kThreads + threadIdx.x;
  if (t >= total) return;
  const float k = count[t / c];
  lion::store(out + t, k > 0.0f ? grid[t] / k : grid[t]);
}

template <typename T>
int launch(const void* feats, const void* vox, void* grid, void* count,
           void* out, int b, int n, int c, int r, cudaStream_t s) {
  const long long points = static_cast<long long>(b) * n * c;
  if (points > 0) {
    vox_scatter_kernel<T><<<lion::ceil_div(points, kThreads), kThreads, 0,
                            s>>>(
        static_cast<const T*>(feats), static_cast<const int*>(vox), b, n, c,
        r, static_cast<float*>(grid), static_cast<float*>(count));
  }
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long cells = static_cast<long long>(b) * r * r * r * c;
  vox_divide_kernel<T><<<lion::ceil_div(cells, kThreads), kThreads, 0, s>>>(
      static_cast<const float*>(grid), static_cast<const float*>(count),
      static_cast<size_t>(cells), c, static_cast<T*>(out));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// feats (B, N, C) f32 or bf16 (bf16 != 0), vox (B, N, 3) i32 -> out
// (B, r^3, C) of the features' dtype. grid (B, r^3, C) f32 and count
// (B, r^3) f32 are scratch zeroed by the caller; for f32 out may be grid.
LION_EXPORT int lion_avg_voxelize(const void* feats, const void* vox,
                                  void* grid, void* count, void* out, int b,
                                  int n, int c, int r, int bf16,
                                  void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return bf16 ? launch<__nv_bfloat16>(feats, vox, grid, count, out, b, n, c,
                                      r, s)
              : launch<float>(feats, vox, grid, count, out, b, n, c, r, s);
}

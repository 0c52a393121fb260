// K5: trilinear devoxelization (8-corner gather from an r^3 grid).
//
// Replaces lion_tpu/ops/pallas/devox.py: trilinear_devoxelize_pallas
// (_devox_kernel) and lion_tpu/ops/pallas/devox_binned.py:
// trilinear_devoxelize_binned (_devox_binned_kernel).
//
// Semantics (common.cuh trilinear): lo = floor(p), frac = p - lo,
// hi = lo + (frac > 0), so the hi corner collapses onto lo when frac is
// exactly 0 and no index leaves the grid. out = sum over the 8 corners of
// grid[corner] * wx * wy * wz, taken in the order (dx, dy, dz) = (0,0,0),
// (0,0,1), ..., (1,1,1). The grid is float32 or bfloat16: with bf16 each
// corner weight is rounded to bf16 (the JAX form casts its weights to the
// grid's dtype, lion_tpu/ops/voxel.py:249), the products are summed in
// float32 and the sum is rounded once.
//
// Bound on the H100: device-memory bandwidth, 8 gathered rows of C floats
// per point (random rows of the grid, mostly L2 hits at r <= 32).
// Design: one thread per (point, channel): a warp reads whole contiguous
// cell rows, and the per-point corner arithmetic is recomputed per channel
// rather than staged, which costs a few ALU operations and no barrier.
#include "common.cuh"

namespace {

constexpr int kThreads = 256;

template <typename T>
__global__ void devox_kernel(const T* __restrict__ grid,
                             const float* __restrict__ coords, int b, int n,
                             int c, int r, T* __restrict__ out) {
  const size_t t = static_cast<size_t>(blockIdx.x) * kThreads + threadIdx.x;
  if (t >= static_cast<size_t>(b) * n * c) return;
  const int ch = static_cast<int>(t % c);
  const size_t pt = t / c;
  const size_t r3 = static_cast<size_t>(r) * r * r;
  const T* g = grid + (pt / n) * r3 * c + ch;
  const float v = lion::trilinear<T>(
      coords + pt * 3, r,
      [&](size_t cell) { return lion::to_float(g[cell * c]); });
  lion::store(out + t, v);
}

template <typename T>
void launch(const void* grid, const void* coords, void* out, int b, int n,
            int c, int r, cudaStream_t s) {
  const long long total = static_cast<long long>(b) * n * c;
  if (total > 0) {
    devox_kernel<T><<<lion::ceil_div(total, kThreads), kThreads, 0, s>>>(
        static_cast<const T*>(grid), static_cast<const float*>(coords), b, n,
        c, r, static_cast<T*>(out));
  }
}

}  // namespace

// grid (B, r^3, C) f32 or bf16 (bf16 != 0), coords (B, N, 3) f32 in
// [0, r-1] -> out (B, N, C) of the grid's dtype.
LION_EXPORT int lion_trilinear_devoxelize(const void* grid, const void* coords,
                                          void* out, int b, int n, int c,
                                          int r, int bf16, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bf16) {
    launch<__nv_bfloat16>(grid, coords, out, b, n, c, r, s);
  } else {
    launch<float>(grid, coords, out, b, n, c, r, s);
  }
  return static_cast<int>(cudaGetLastError());
}

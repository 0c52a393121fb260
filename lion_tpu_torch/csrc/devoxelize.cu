// K5: trilinear devoxelization (8-corner gather from an r^3 grid).
//
// Replaces lion_tpu/ops/pallas/devox.py: trilinear_devoxelize_pallas
// (_devox_kernel) and lion_tpu/ops/pallas/devox_binned.py:
// trilinear_devoxelize_binned (_devox_binned_kernel).
//
// Semantics: lo = floor(p), frac = p - lo, hi = lo + (frac > 0), so the hi
// corner collapses onto lo when frac is exactly 0 and no index leaves the
// grid. out = sum over the 8 corners of grid[corner] * wx * wy * wz, taken
// in the order (dx, dy, dz) = (0,0,0), (0,0,1), ..., (1,1,1).
//
// Bound on the H100: device-memory bandwidth, 8 gathered rows of C floats
// per point (random rows of the grid, mostly L2 hits at r <= 32).
// Design: one thread per (point, channel): a warp reads whole contiguous
// cell rows, and the per-point corner arithmetic is recomputed per channel
// rather than staged, which costs a few ALU operations and no barrier.
#include "common.cuh"

namespace {

constexpr int kThreads = 256;

__global__ void devox_kernel(const float* __restrict__ grid,
                             const float* __restrict__ coords, int b, int n,
                             int c, int r, float* __restrict__ out) {
  const size_t t = static_cast<size_t>(blockIdx.x) * kThreads + threadIdx.x;
  if (t >= static_cast<size_t>(b) * n * c) return;
  const int ch = static_cast<int>(t % c);
  const size_t pt = t / c;
  const float* p = coords + pt * 3;
  int lo[3], hi[3];
  float w1[3], w0[3];
#pragma unroll
  for (int a = 0; a < 3; ++a) {
    const float l = floorf(p[a]);
    const float f = __fsub_rn(p[a], l);
    const int li = min(max(static_cast<int>(l), 0), r - 1);
    lo[a] = li;
    hi[a] = min(li + (f > 0.0f ? 1 : 0), r - 1);
    w1[a] = f;
    w0[a] = __fsub_rn(1.0f, f);
  }
  const size_t r3 = static_cast<size_t>(r) * r * r;
  const float* g = grid + (pt / n) * r3 * c + ch;
  float acc = 0.0f;
#pragma unroll
  for (int dx = 0; dx < 2; ++dx) {
#pragma unroll
    for (int dy = 0; dy < 2; ++dy) {
#pragma unroll
      for (int dz = 0; dz < 2; ++dz) {
        const int ix = dx ? hi[0] : lo[0];
        const int iy = dy ? hi[1] : lo[1];
        const int iz = dz ? hi[2] : lo[2];
        const float w = __fmul_rn(__fmul_rn(dx ? w1[0] : w0[0],
                                            dy ? w1[1] : w0[1]),
                                  dz ? w1[2] : w0[2]);
        const size_t cell = (static_cast<size_t>(ix) * r + iy) * r + iz;
        acc = __fadd_rn(acc, __fmul_rn(g[cell * c], w));
      }
    }
  }
  out[t] = acc;
}

}  // namespace

// grid (B, r^3, C) f32, coords (B, N, 3) f32 in [0, r-1] -> out (B, N, C).
LION_EXPORT int lion_trilinear_devoxelize(const void* grid, const void* coords,
                                          void* out, int b, int n, int c,
                                          int r, void* stream) {
  const long long total = static_cast<long long>(b) * n * c;
  if (total > 0) {
    devox_kernel<<<lion::ceil_div(total, kThreads), kThreads, 0,
                   static_cast<cudaStream_t>(stream)>>>(
        static_cast<const float*>(grid), static_cast<const float*>(coords), b,
        n, c, r, static_cast<float*>(out));
  }
  return static_cast<int>(cudaGetLastError());
}

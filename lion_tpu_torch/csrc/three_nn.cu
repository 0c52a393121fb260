// K6: exact 3-nearest-neighbour inverse-distance interpolation.
//
// Replaces lion_tpu/ops/pallas/three_nn.py: three_nn_interpolate_pallas
// (_three_nn_kernel).
//
// Semantics: d2 = max((|p|^2 + |c|^2) - 2 p.c, 0) as in the JAX forms; the
// three smallest d2 with strict '<' in index order (ties go to the lowest
// index); d2 clamped to [1e-10, 1e10]; weights w_i = prod_{j!=i} d_j /
// sum_k prod_{j!=k} d_j; out = (f0*w0 + f1*w1) + f2*w2. With fewer than 3
// centers the empty slots keep index 0 and d2 = 1e10. Unlike the TPU
// kernel, which rounds features and weights to bf16 for its one-hot matmul,
// everything stays fp32.
//
// Bound on the H100: arithmetic on the N*M distance scan (2048 x 1024 per
// cloud at the FP3 stage), then device-memory bandwidth on the N*C output.
// Design: one thread per point scans the centers from shared memory (tiles
// of 1024 with precomputed |c|^2) keeping the best three in registers; the
// block then stages its indices and weights in shared memory and writes
// the output rows with threads over channels, so reads and writes of
// features are contiguous.
#include <cmath>

#include "common.cuh"

namespace {

constexpr int kPoints = 128;  // points (and threads) per block
constexpr int kTile = 1024;   // centers per shared-memory tile

__global__ void __launch_bounds__(kPoints)
three_nn_kernel(const float* __restrict__ points,
                const float* __restrict__ centers,
                const float* __restrict__ feats, int n, int m, int c,
                float* __restrict__ out) {
  __shared__ float scx[kTile], scy[kTile], scz[kTile], sc2[kTile];
  __shared__ int sidx[3][kPoints];
  __shared__ float sw[3][kPoints];

  const int b = blockIdx.y;
  const int base = blockIdx.x * kPoints;
  const int i = base + threadIdx.x;
  const bool valid = i < n;
  float px = 0.0f, py = 0.0f, pz = 0.0f;
  if (valid) {
    const float* p = points + (static_cast<size_t>(b) * n + i) * 3;
    px = p[0];
    py = p[1];
    pz = p[2];
  }
  const float p2 = lion::dot3(px, py, pz, px, py, pz);
  float d0 = INFINITY, d1 = INFINITY, d2 = INFINITY;
  int i0 = 0, i1 = 0, i2 = 0;
  const float* cb = centers + static_cast<size_t>(b) * m * 3;

  for (int t0 = 0; t0 < m; t0 += kTile) {
    const int cnt = min(kTile, m - t0);
    __syncthreads();
    for (int j = threadIdx.x; j < cnt; j += kPoints) {
      const float x = cb[3 * (t0 + j)];
      const float y = cb[3 * (t0 + j) + 1];
      const float z = cb[3 * (t0 + j) + 2];
      scx[j] = x;
      scy[j] = y;
      scz[j] = z;
      sc2[j] = lion::dot3(x, y, z, x, y, z);
    }
    __syncthreads();
    if (valid) {
      for (int j = 0; j < cnt; ++j) {
        const float dot = lion::dot3(px, py, pz, scx[j], scy[j], scz[j]);
        const float d = fmaxf(
            __fsub_rn(__fadd_rn(p2, sc2[j]), __fmul_rn(2.0f, dot)), 0.0f);
        if (d < d2) {
          const int jj = t0 + j;
          if (d < d1) {
            d2 = d1;
            i2 = i1;
            if (d < d0) {
              d1 = d0;
              i1 = i0;
              d0 = d;
              i0 = jj;
            } else {
              d1 = d;
              i1 = jj;
            }
          } else {
            d2 = d;
            i2 = jj;
          }
        }
      }
    }
  }

  d0 = fminf(fmaxf(d0, 1e-10f), 1e10f);
  d1 = fminf(fmaxf(d1, 1e-10f), 1e10f);
  d2 = fminf(fmaxf(d2, 1e-10f), 1e10f);
  const float d0d1 = __fmul_rn(d0, d1);
  const float d0d2 = __fmul_rn(d0, d2);
  const float d1d2 = __fmul_rn(d1, d2);
  const float inv = __fdiv_rn(1.0f, __fadd_rn(__fadd_rn(d0d1, d0d2), d1d2));
  sidx[0][threadIdx.x] = i0;
  sidx[1][threadIdx.x] = i1;
  sidx[2][threadIdx.x] = i2;
  sw[0][threadIdx.x] = __fmul_rn(d1d2, inv);
  sw[1][threadIdx.x] = __fmul_rn(d0d2, inv);
  sw[2][threadIdx.x] = __fmul_rn(d0d1, inv);
  __syncthreads();

  const int npts = min(kPoints, n - base);
  const float* fb = feats + static_cast<size_t>(b) * m * c;
  float* ob = out + (static_cast<size_t>(b) * n + base) * c;
  for (int e = threadIdx.x; e < npts * c; e += kPoints) {
    const int q = e / c;
    const int ch = e - q * c;
    const float f0 = fb[static_cast<size_t>(sidx[0][q]) * c + ch];
    const float f1 = fb[static_cast<size_t>(sidx[1][q]) * c + ch];
    const float f2 = fb[static_cast<size_t>(sidx[2][q]) * c + ch];
    ob[e] = __fadd_rn(__fadd_rn(__fmul_rn(f0, sw[0][q]),
                                __fmul_rn(f1, sw[1][q])),
                      __fmul_rn(f2, sw[2][q]));
  }
}

}  // namespace

// points (B, N, 3), centers (B, M, 3), feats (B, M, C) f32 -> out (B, N, C).
LION_EXPORT int lion_three_nn_interpolate(const void* points,
                                          const void* centers,
                                          const void* feats, void* out, int b,
                                          int n, int m, int c, void* stream) {
  const dim3 grid(lion::ceil_div(n, kPoints), b);
  three_nn_kernel<<<grid, kPoints, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(points), static_cast<const float*>(centers),
      static_cast<const float*>(feats), n, m, c, static_cast<float*>(out));
  return static_cast<int>(cudaGetLastError());
}

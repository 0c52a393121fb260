// K4: fused eval-path 3x3x3 SAME convolution with input prologue and
// output statistics.
//
// Replaces lion_tpu/ops/pallas/conv3d.py: conv3d_3x3_fused
// (_conv_kernel_planes_fused, _conv_kernel_zblock_fused) and
// lion_tpu/ops/pallas/conv3d_packed.py: conv3d_packed_fused
// (_packed_item_call / _conv_kernel_item, _conv_kernel_packed,
// _packed_small_call / _conv_kernel_packed_small). The packed (B, R^2, R*C)
// layout existed for the TPU's matrix unit and is not carried over.
//
// Semantics: y = conv3d_SAME(pro(x), w) with no bias, where
// pro(x) = x * scale[b, ci] + shift[b, ci], optionally followed by swish,
// applies to in-grid inputs only: the halo is 0 after the prologue. x is
// NDHWC (B, R, R, R, Ci), w is (3, 3, 3, Ci, Co), y is (B, R, R, R, Co).
// stats[b, 0, co] += sum of y, stats[b, 1, co] += sum of y^2 over all R^3
// voxels (the caller zeroes stats).
//
// Bound on the H100: fp32 arithmetic, 2 * 27 * Ci * Co flops per voxel
// (116 GFLOP at B = 16, r = 32, Ci = Co = 64) against 4 * (Ci + Co) bytes of
// activations per voxel, so well above the fp32 ridge point; this simple
// kernel is bounded by shared-memory traffic in its inner product.
// Design: an implicit GEMM over (voxels) x (Co) x (27 taps * Ci). A block
// of 256 threads owns 64 voxels of one item by 64 output channels; each
// K-step gathers a 64 x 16 input tile for one tap (prologue and zero halo
// applied on the way into shared memory) and a 16 x 64 weight tile, then
// each thread accumulates a 4 x 4 register tile in fp32 (no tensor cores,
// no TF32). The epilogue stores y and reduces (sum, sumsq) per channel in
// shared memory, then one atomicAdd per channel per block.
#include <cmath>

#include "common.cuh"

namespace {

constexpr int kBM = 64;  // voxels per block
constexpr int kBN = 64;  // output channels per block
constexpr int kBK = 16;  // input channels per K-step
constexpr int kThreads = 256;

template <bool kAffine, bool kSwish>
__global__ void __launch_bounds__(kThreads)
conv3d_kernel(const float* __restrict__ x, const float* __restrict__ w,
              const float* __restrict__ scale, const float* __restrict__ shift,
              int r, int ci, int co, float* __restrict__ y,
              float* __restrict__ stats) {
  __shared__ float as[kBK][kBM + 1];
  __shared__ float bs[kBK][kBN];
  __shared__ float ssum[kBN], ssq[kBN];

  const int tid = threadIdx.x;
  const int tx = tid & 15;   // output-channel lane
  const int ty = tid >> 4;   // voxel lane
  const int b = blockIdx.z;
  const int r3 = r * r * r;
  const int v0 = blockIdx.x * kBM;
  const int co0 = blockIdx.y * kBN;
  const float* xb = x + static_cast<size_t>(b) * r3 * ci;
  const float* sb = kAffine ? scale + static_cast<size_t>(b) * ci : nullptr;
  const float* hb = kAffine ? shift + static_cast<size_t>(b) * ci : nullptr;

  if (tid < kBN) {
    ssum[tid] = 0.0f;
    ssq[tid] = 0.0f;
  }

  // The four voxels this thread gathers: local index ty + 16 * p.
  int vd[4], vh[4], vw[4];
  bool vin[4];
#pragma unroll
  for (int p = 0; p < 4; ++p) {
    const int v = v0 + ty + 16 * p;
    vin[p] = v < r3;
    vd[p] = v / (r * r);
    vh[p] = (v / r) % r;
    vw[p] = v % r;
  }

  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.0f;

  for (int tap = 0; tap < 27; ++tap) {
    const int kd = tap / 9 - 1, kh = (tap / 3) % 3 - 1, kw = tap % 3 - 1;
    const float* wt = w + static_cast<size_t>(tap) * ci * co;
    for (int c0 = 0; c0 < ci; c0 += kBK) {
      // input tile: as[k][v] = pro(x[voxel v shifted by the tap, c0 + k])
      const int ch = c0 + tx;
#pragma unroll
      for (int p = 0; p < 4; ++p) {
        const int dd = vd[p] + kd, hh = vh[p] + kh, ww = vw[p] + kw;
        float val = 0.0f;
        if (vin[p] && ch < ci && dd >= 0 && dd < r && hh >= 0 && hh < r &&
            ww >= 0 && ww < r) {
          val = xb[(static_cast<size_t>(dd * r + hh) * r + ww) * ci + ch];
          if (kAffine) val = val * sb[ch] + hb[ch];
          if (kSwish) val = val / (1.0f + expf(-val));
        }
        as[tx][ty + 16 * p] = val;
      }
      // weight tile: bs[k][n] = w[tap, c0 + k, co0 + n]
#pragma unroll
      for (int p = 0; p < 4; ++p) {
        const int k = (tid >> 6) + 4 * p;
        const int n = tid & 63;
        const int wc = c0 + k, wo = co0 + n;
        bs[k][n] = (wc < ci && wo < co)
                       ? wt[static_cast<size_t>(wc) * co + wo]
                       : 0.0f;
      }
      __syncthreads();
#pragma unroll
      for (int k = 0; k < kBK; ++k) {
        float a[4], bv[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) a[i] = as[k][ty + 16 * i];
#pragma unroll
        for (int j = 0; j < 4; ++j) bv[j] = bs[k][tx + 16 * j];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(a[i], bv[j], acc[i][j]);
      }
      __syncthreads();
    }
  }

  float* yb = y + static_cast<size_t>(b) * r3 * co;
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int oc = co0 + tx + 16 * j;
    float s = 0.0f, q = 0.0f;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int v = v0 + ty + 16 * i;
      if (v < r3 && oc < co) {
        yb[static_cast<size_t>(v) * co + oc] = acc[i][j];
        s += acc[i][j];
        q += acc[i][j] * acc[i][j];
      }
    }
    atomicAdd(&ssum[tx + 16 * j], s);
    atomicAdd(&ssq[tx + 16 * j], q);
  }
  __syncthreads();
  if (tid < kBN && co0 + tid < co) {
    atomicAdd(stats + (static_cast<size_t>(b) * 2) * co + co0 + tid,
              ssum[tid]);
    atomicAdd(stats + (static_cast<size_t>(b) * 2 + 1) * co + co0 + tid,
              ssq[tid]);
  }
}

template <bool kAffine, bool kSwish>
void launch(const float* x, const float* w, const float* scale,
            const float* shift, float* y, float* stats, int b, int r, int ci,
            int co, cudaStream_t s) {
  const dim3 grid(lion::ceil_div(static_cast<long long>(r) * r * r, kBM),
                  lion::ceil_div(co, kBN), b);
  conv3d_kernel<kAffine, kSwish><<<grid, kThreads, 0, s>>>(
      x, w, scale, shift, r, ci, co, y, stats);
}

}  // namespace

// x (B, r, r, r, Ci), w (3, 3, 3, Ci, Co), scale/shift (B, Ci) or null
// -> y (B, r, r, r, Co), stats (B, 2, Co) (zeroed by the caller).
LION_EXPORT int lion_conv3d_3x3_fused(const void* x, const void* w,
                                      const void* scale, const void* shift,
                                      void* y, void* stats, int b, int r,
                                      int ci, int co, int pre_swish,
                                      void* stream) {
  const float* xf = static_cast<const float*>(x);
  const float* wf = static_cast<const float*>(w);
  const float* sf = static_cast<const float*>(scale);
  const float* hf = static_cast<const float*>(shift);
  float* yf = static_cast<float*>(y);
  float* st = static_cast<float*>(stats);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool affine = scale != nullptr;
  if (affine && pre_swish) {
    launch<true, true>(xf, wf, sf, hf, yf, st, b, r, ci, co, s);
  } else if (affine) {
    launch<true, false>(xf, wf, sf, hf, yf, st, b, r, ci, co, s);
  } else if (pre_swish) {
    launch<false, true>(xf, wf, sf, hf, yf, st, b, r, ci, co, s);
  } else {
    launch<false, false>(xf, wf, sf, hf, yf, st, b, r, ci, co, s);
  }
  return static_cast<int>(cudaGetLastError());
}

// Shared helpers for the port's hand-written Hopper kernels.
//
// Every kernel library entry point has a plain C interface (pointers as
// void*, sizes as int, the stream as void*) so Python binds it with ctypes,
// launches on the caller's stream, allocates nothing, and returns
// cudaGetLastError() so a refused launch surfaces at the call site.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#define LION_EXPORT extern "C" __attribute__((visibility("default")))

namespace lion {

using bf16 = __nv_bfloat16;

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(bf16 v) {
  return __bfloat162float(v);
}

// Store a float as float, or rounded to nearest even as bf16.
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(bf16* p, float v) {
  *p = __float2bfloat16_rn(v);
}

// v rounded to the precision of T, returned as float.
template <typename T>
__device__ __forceinline__ float round_to(float v);
template <>
__device__ __forceinline__ float round_to<float>(float v) {
  return v;
}
template <>
__device__ __forceinline__ float round_to<bf16>(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

// Squared distance summed as ((dx*dx + dy*dy) + dz*dz) with every operation
// rounded on its own (no fused multiply-add), so the result is bit-identical
// to the same expression evaluated op by op in PyTorch.
__device__ __forceinline__ float sq_dist(float ax, float ay, float az,
                                         float bx, float by, float bz) {
  const float dx = __fsub_rn(ax, bx);
  const float dy = __fsub_rn(ay, by);
  const float dz = __fsub_rn(az, bz);
  return __fadd_rn(__fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy)),
                   __fmul_rn(dz, dz));
}

// Dot product of two 3-vectors, ((a0*b0 + a1*b1) + a2*b2), unfused.
__device__ __forceinline__ float dot3(float ax, float ay, float az,
                                      float bx, float by, float bz) {
  return __fadd_rn(__fadd_rn(__fmul_rn(ax, bx), __fmul_rn(ay, by)),
                   __fmul_rn(az, bz));
}

// The 8 trilinear corners of continuous voxel coords p[0..2] in [0, r-1]:
// flat cells (x * r + y) * r + z and weights, in the order (dx, dy, dz) =
// (0,0,0), (0,0,1), ..., (1,1,1). lo = floor(p), frac = p - lo,
// hi = lo + (frac > 0), so the hi corner collapses onto lo when frac is
// exactly 0 and no index leaves the grid; each weight (wx * wy) * wz is
// rounded to the precision of T, unfused in float32.
template <typename T>
__device__ __forceinline__ void trilinear_corners(const float* p, int r,
                                                  size_t (&cell)[8],
                                                  float (&w)[8]) {
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
#pragma unroll
  for (int k = 0; k < 8; ++k) {
    const int dx = k >> 2, dy = (k >> 1) & 1, dz = k & 1;
    w[k] = round_to<T>(
        __fmul_rn(__fmul_rn(dx ? w1[0] : w0[0], dy ? w1[1] : w0[1]),
                  dz ? w1[2] : w0[2]));
    cell[k] = (static_cast<size_t>(dx ? hi[0] : lo[0]) * r +
               (dy ? hi[1] : lo[1])) * r + (dz ? hi[2] : lo[2]);
  }
}

// Trilinear interpolation of the values load(cell) at p (trilinear_corners):
// the 8 products summed in the corners' order, unfused in float32.
template <typename T, class Load>
__device__ __forceinline__ float trilinear(const float* p, int r,
                                           const Load& load) {
  size_t cell[8];
  float w[8];
  trilinear_corners<T>(p, r, cell, w);
  float acc = 0.0f;
#pragma unroll
  for (int k = 0; k < 8; ++k) acc = __fadd_rn(acc, __fmul_rn(load(cell[k]), w[k]));
  return acc;
}

// Raise a kernel's dynamic shared-memory limit to `bytes`, and ask for the
// largest shared-memory carveout (so that as many blocks as the shared
// memory allows share an SM), once per device and process (the attributes
// persist); `done` is the caller's static bit mask of the devices already
// set.
inline cudaError_t set_smem_once(const void* fn, int bytes, unsigned* done) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  const unsigned bit = 1u << (dev & 31);
  if (*done & bit) return cudaSuccess;
  err = cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             bytes);
  if (err == cudaSuccess) {
    err = cudaFuncSetAttribute(fn,
                               cudaFuncAttributePreferredSharedMemoryCarveout,
                               cudaSharedmemCarveoutMaxShared);
  }
  if (err == cudaSuccess) *done |= bit;
  return err;
}

inline int ceil_div(long long a, long long b) {
  return static_cast<int>((a + b - 1) / b);
}

}  // namespace lion

LION_EXPORT const char* lion_error_string(int err);

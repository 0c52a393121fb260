// Shared helpers for the port's hand-written Hopper kernels.
//
// Every kernel library entry point has a plain C interface (pointers as
// void*, sizes as int, the stream as void*) so Python binds it with ctypes,
// launches on the caller's stream, allocates nothing, and returns
// cudaGetLastError() so a refused launch surfaces at the call site.
#pragma once

#include <cuda_runtime.h>

#define LION_EXPORT extern "C" __attribute__((visibility("default")))

namespace lion {

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

inline int ceil_div(long long a, long long b) {
  return static_cast<int>((a + b - 1) / b);
}

}  // namespace lion

LION_EXPORT const char* lion_error_string(int err);

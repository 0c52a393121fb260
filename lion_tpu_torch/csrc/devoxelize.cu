// K5: trilinear devoxelization (8-corner gather from an r^3 grid), with
// an optional per-(item, channel) affine in the epilogue.
//
// Replaces lion_tpu/ops/pallas/devox.py: trilinear_devoxelize_pallas
// (_devox_kernel) and lion_tpu/ops/pallas/devox_binned.py:
// trilinear_devoxelize_binned (_devox_binned_kernel).
//
// Semantics (common.cuh trilinear_corners): lo = floor(p), frac = p - lo,
// hi = lo + (frac > 0), so the hi corner collapses onto lo when frac is
// exactly 0 and no index leaves the grid. out = sum over the 8 corners of
// grid[corner] * wx * wy * wz, taken in the order (dx, dy, dz) = (0,0,0),
// (0,0,1), ..., (1,1,1). The grid is float32 or bfloat16: with bf16 each
// corner weight is rounded to bf16 (the JAX form casts its weights to the
// grid's dtype, lion_tpu/ops/voxel.py:249), the products are summed in
// float32 and the sum is rounded once. With `scale` and `bias` (B, C)
// float32 the sum becomes sum * scale + bias (two rounded float32
// operations) before that one rounding: PVConv's folded norm and SE gate,
// which commute with devoxelization.
//
// Bound on the H100: device-memory bandwidth, 8 gathered rows of C values
// per point (rows of the grid near the points, mostly L2 hits at r <= 32)
// and one output row.
// Design: a group of `lanes` threads (a power of two, at most a warp) takes
// one point. Each lane computes the point's corners and weights itself (a
// few dozen ALU operations and no shuffle), then sums 16 bytes of channels
// (4 fp32 or 8 bf16) a step over the 8 corner rows, each a 16-byte load,
// and writes them with one 16-byte store; a channel count whose rows are
// not a multiple of 16 bytes takes one channel a step. The host's plan
// (ops/voxel.py devox_plan) picks the lanes from C and the threads a block
// so that every level of the U-Net launches at least one block per SM.
#include "common.cuh"

namespace {

constexpr int kMaxThreads = 256;

// V channels at p as float: one 16-byte load for V = 16 / sizeof(T) (a
// bf16 is the high half of a float's bits), else V scalar loads.
template <int V>
__device__ __forceinline__ void load_chunk(const float* p, float (&x)[V]) {
  if constexpr (V == 4) {
    const float4 f = __ldg(reinterpret_cast<const float4*>(p));
    x[0] = f.x, x[1] = f.y, x[2] = f.z, x[3] = f.w;
  } else {
#pragma unroll
    for (int v = 0; v < V; ++v) x[v] = __ldg(p + v);
  }
}

template <int V>
__device__ __forceinline__ void load_chunk(const lion::bf16* p,
                                           float (&x)[V]) {
  if constexpr (V == 8) {
    const uint4 u = __ldg(reinterpret_cast<const uint4*>(p));
    const unsigned words[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      x[2 * i] = __uint_as_float(words[i] << 16);
      x[2 * i + 1] = __uint_as_float(words[i] & 0xffff0000u);
    }
  } else {
#pragma unroll
    for (int v = 0; v < V; ++v) x[v] = lion::to_float(p[v]);
  }
}

// V channels rounded to T at p: one 16-byte store for V = 16 / sizeof(T).
template <int V>
__device__ __forceinline__ void store_chunk(float* p, const float (&x)[V]) {
  if constexpr (V == 4) {
    *reinterpret_cast<float4*>(p) = make_float4(x[0], x[1], x[2], x[3]);
  } else {
#pragma unroll
    for (int v = 0; v < V; ++v) p[v] = x[v];
  }
}

template <int V>
__device__ __forceinline__ void store_chunk(lion::bf16* p,
                                            const float (&x)[V]) {
  if constexpr (V == 8) {
    unsigned words[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      words[i] = static_cast<unsigned>(__bfloat16_as_ushort(
                     __float2bfloat16_rn(x[2 * i]))) |
                 (static_cast<unsigned>(__bfloat16_as_ushort(
                      __float2bfloat16_rn(x[2 * i + 1]))) << 16);
    }
    *reinterpret_cast<uint4*>(p) =
        make_uint4(words[0], words[1], words[2], words[3]);
  } else {
#pragma unroll
    for (int v = 0; v < V; ++v) lion::store(p + v, x[v]);
  }
}

template <typename T, int V>
__global__ void __launch_bounds__(kMaxThreads)
devox_kernel(const T* __restrict__ grid, const float* __restrict__ coords,
             const float* __restrict__ scale, const float* __restrict__ bias,
             long long points, int n, int c, int r, int lanes_log2,
             T* __restrict__ out) {
  const long long g = static_cast<long long>(blockIdx.x) * blockDim.x +
                      threadIdx.x;
  const long long pt = g >> lanes_log2;
  if (pt >= points) return;
  const int lanes = 1 << lanes_log2;
  const int lane = static_cast<int>(g) & (lanes - 1);
  const long long item = pt / n;
  size_t cell[8];
  float w[8];
  lion::trilinear_corners<T>(coords + pt * 3, r, cell, w);
  const T* gi = grid + static_cast<size_t>(item) * r * r * r * c;
  T* o = out + static_cast<size_t>(pt) * c;
  for (int ch = lane * V; ch < c; ch += lanes * V) {
    float acc[V];
#pragma unroll
    for (int v = 0; v < V; ++v) acc[v] = 0.0f;
#pragma unroll
    for (int k = 0; k < 8; ++k) {
      float x[V];
      load_chunk<V>(gi + cell[k] * c + ch, x);
#pragma unroll
      for (int v = 0; v < V; ++v)
        acc[v] = __fadd_rn(acc[v], __fmul_rn(x[v], w[k]));
    }
    if (scale != nullptr) {
      const long long e = item * c + ch;
#pragma unroll
      for (int v = 0; v < V; ++v)
        acc[v] = __fadd_rn(__fmul_rn(acc[v], __ldg(scale + e + v)),
                           __ldg(bias + e + v));
    }
    store_chunk<V>(o + ch, acc);
  }
}

template <typename T>
void launch(const void* grid, const void* coords, const void* scale,
            const void* bias, void* out, int b, int n, int c, int r,
            int threads, int lanes_log2, cudaStream_t s) {
  constexpr int kVec = 16 / sizeof(T);
  const long long points = static_cast<long long>(b) * n;
  if (points == 0 || c == 0) return;
  const int blocks = lion::ceil_div(points << lanes_log2, threads);
  auto go = [&](auto kernel) {
    kernel<<<blocks, threads, 0, s>>>(
        static_cast<const T*>(grid), static_cast<const float*>(coords),
        static_cast<const float*>(scale), static_cast<const float*>(bias),
        points, n, c, r, lanes_log2, static_cast<T*>(out));
  };
  if (c % kVec == 0) {
    go(devox_kernel<T, kVec>);
  } else {
    go(devox_kernel<T, 1>);
  }
}

}  // namespace

// grid (B, r^3, C) f32 or bf16 (bf16 != 0), coords (B, N, 3) f32 in
// [0, r-1], scale and bias (B, C) f32 or both NULL -> out (B, N, C) of the
// grid's dtype. The plan: 2^lanes_log2 lanes a point (at most 32) and
// `threads` a block (a multiple of the lanes, at most 256).
LION_EXPORT int lion_trilinear_devoxelize(const void* grid, const void* coords,
                                          const void* scale, const void* bias,
                                          void* out, int b, int n, int c,
                                          int r, int bf16, int threads,
                                          int lanes_log2, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (threads < 32 || threads > kMaxThreads || threads % 32 != 0 ||
      lanes_log2 < 0 || lanes_log2 > 5) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (bf16) {
    launch<__nv_bfloat16>(grid, coords, scale, bias, out, b, n, c, r, threads,
                          lanes_log2, s);
  } else {
    launch<float>(grid, coords, scale, bias, out, b, n, c, r, threads,
                  lanes_log2, s);
  }
  return static_cast<int>(cudaGetLastError());
}

// K1: furthest point sampling.
//
// Replaces lion_tpu/ops/pallas/fps.py: furthest_point_sample_pallas
// (_fps_kernel) and furthest_point_sample_idx_pallas.
//
// Semantics: index 0 seeds the chain; each next pick is the argmax of the
// running minimum squared distance to the picks so far (lion::sq_dist, no
// fused multiply-add), ties going to the lowest index. Emits the indices
// (B, M) and the picked coords (B, M, 3), copied bit for bit from the input.
//
// Bound on the H100: latency. The M picks form a serial chain, so a cloud is
// one block, and a pick costs an update of the running minimum over the N
// points, an argmax over the block and a broadcast of the winner. Only B of
// the 132 SMs work.
// Design: the block's T threads own P points each, strided (point i T + t
// for thread t), and keep their three coordinates and running minimum in
// registers for the whole chain; a read-only shared copy of the cloud (12
// bytes a point, written once) serves only to broadcast the last pick's
// coordinates. Distances are >= +0, so their float bits order like unsigned
// integers: a warp's argmax is two integer reductions, __reduce_max_sync on
// the bits, then __reduce_min_sync on the index over the lanes that hold
// the maximum (the lowest-index rule; a thread keeps its first maximum).
// A block of several warps takes one barrier per pick: lane 0 of each warp
// writes (bits, index) to its slot of a pair of slot rows used by the
// picks' parity, and after the barrier every warp folds all the slots with
// the same two reductions, so every thread knows the pick without a second
// barrier (a warp can be one pick ahead and write the other row, never two).
// A level of at most kWarpMaxN points runs on one warp: no barrier at all.
// Thread 0 writes each pick (index and coordinates) and does not wait for
// the writes. Points past N hold distance +0 and an index >= N, so they
// lose every tie. The plan (threads, P) follows N (fps_plan, mirrored by
// ops/points.py: fps_plan); P is a compile-time count, so the points stay in
// registers; at P = 16 (N > 8192, beyond every main-path level) the
// compiler spills part of them to local memory.
#include <cmath>

#include "common.cuh"

namespace {

constexpr int kMaxThreads = 1024;
constexpr int kWarpMaxN = 256;   // one warp serves N up to here (P <= 8)
constexpr int kBlockP = 2;       // the least P of a block of several warps
constexpr int kMaxP = 16;

// The phase stamps of one pick, compiled out: the production kernels take
// NoStamp; a probe that splits a pick's time passes its own (the phases:
// 0 pick start, 1 update done, 2 warp argmax done, 3 barrier passed, 4
// fold done, 5 the chain's end; `dep` is a value the phase produced).
struct NoStamp {
  __device__ __forceinline__ void operator()(int, unsigned) {}
};

// P points per thread; blockDim.x threads (a multiple of 32, at most 1024).
template <int P, class Stamp>
__global__ void __launch_bounds__(kMaxThreads)
fps_kernel(const float* __restrict__ xyz, int n, int m,
           int* __restrict__ idx, float* __restrict__ centers, Stamp stamp) {
  extern __shared__ float scloud[];        // (N, 3), read-only after fill
  __shared__ uint2 slot[2][kMaxThreads / 32];
  const int b = blockIdx.x;
  const int t = threadIdx.x, nt = blockDim.x;
  const int lane = t & 31, warp = t >> 5, warps = nt >> 5;
  const float* p = xyz + static_cast<size_t>(b) * n * 3;
  int* out_idx = idx + static_cast<size_t>(b) * m;
  float* out_c = centers + static_cast<size_t>(b) * m * 3;

  float px[P], py[P], pz[P], pd[P];
#pragma unroll
  for (int i = 0; i < P; ++i) {
    const int j = i * nt + t;
    const bool in = j < n;
    px[i] = in ? p[3 * j] : 0.0f;
    py[i] = in ? p[3 * j + 1] : 0.0f;
    pz[i] = in ? p[3 * j + 2] : 0.0f;
    pd[i] = in ? INFINITY : 0.0f;          // +0: never beats a point
    if (in) {
      scloud[3 * j] = px[i];
      scloud[3 * j + 1] = py[i];
      scloud[3 * j + 2] = pz[i];
    }
  }
  __syncthreads();
  float cx = scloud[0], cy = scloud[1], cz = scloud[2];
  if (t == 0) {
    out_idx[0] = 0;
    out_c[0] = cx;
    out_c[1] = cy;
    out_c[2] = cz;
  }

  for (int s = 1; s < m; ++s) {
    stamp(0, 0u);
    // this thread's first maximum of the updated minimum distances
    unsigned key = 0u, best = 0u;
#pragma unroll
    for (int i = 0; i < P; ++i) {
      const float d = fminf(pd[i], lion::sq_dist(px[i], py[i], pz[i],
                                                 cx, cy, cz));
      pd[i] = d;
      const unsigned bits = __float_as_uint(d);
      if (i == 0 || bits > key) {
        key = bits;
        best = static_cast<unsigned>(i * nt + t);
      }
    }
    stamp(1, key);
    const unsigned wkey = __reduce_max_sync(0xffffffffu, key);
    unsigned last =
        __reduce_min_sync(0xffffffffu, key == wkey ? best : 0xffffffffu);
    key = wkey;
    stamp(2, last);
    if (warps > 1) {
      if (lane == 0) slot[s & 1][warp] = make_uint2(key, last);
      __syncthreads();
      stamp(3, 0u);
      const uint2 v = lane < warps ? slot[s & 1][lane]
                                   : make_uint2(0u, 0xffffffffu);
      key = __reduce_max_sync(0xffffffffu, v.x);
      last = __reduce_min_sync(0xffffffffu,
                               v.x == key ? v.y : 0xffffffffu);
    }
    stamp(4, last);
    cx = scloud[3 * last];
    cy = scloud[3 * last + 1];
    cz = scloud[3 * last + 2];
    if (t == 0) {
      out_idx[s] = static_cast<int>(last);
      out_c[3 * s] = cx;
      out_c[3 * s + 1] = cy;
      out_c[3 * s + 2] = cz;
    }
  }
  stamp(5, 0u);
}

// The plan for N points: one warp up to kWarpMaxN (P the least power of two
// with 32 P >= N); above, the least P from kBlockP up (powers of two) with
// kMaxThreads P >= N, and the fewest warps that cover N. 0: N too large.
int fps_plan(int n, int* threads) {
  int p = 1;
  if (n <= kWarpMaxN) {
    while (32 * p < n) p *= 2;
    *threads = 32;
    return p;
  }
  p = kBlockP;
  while (kMaxThreads * p < n) p *= 2;
  if (p > kMaxP) return 0;
  *threads = 32 * lion::ceil_div(n, 32 * p);
  return p;
}

// Launch the kernel with P points per thread on `threads` threads.
template <int P, class Stamp>
int launch_p(const void* xyz, void* idx, void* centers, int b, int n, int m,
             int threads, Stamp stamp, cudaStream_t s) {
  const int smem = 12 * n;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        fps_kernel<P, Stamp>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        smem);
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  fps_kernel<P, Stamp><<<b, threads, smem, s>>>(
      static_cast<const float*>(xyz), n, m, static_cast<int*>(idx),
      static_cast<float*>(centers), stamp);
  return static_cast<int>(cudaGetLastError());
}

// Dispatch a plan (threads, P) with the given stamp.
template <class Stamp>
int launch_plan(const void* xyz, void* idx, void* centers, int b, int n,
                int m, int threads, int p, Stamp stamp, cudaStream_t s) {
  if (threads % 32 || threads < 32 || threads > kMaxThreads ||
      threads * p < n)
    return static_cast<int>(cudaErrorInvalidValue);
  switch (p) {
    case 1: return launch_p<1>(xyz, idx, centers, b, n, m, threads, stamp, s);
    case 2: return launch_p<2>(xyz, idx, centers, b, n, m, threads, stamp, s);
    case 4: return launch_p<4>(xyz, idx, centers, b, n, m, threads, stamp, s);
    case 8: return launch_p<8>(xyz, idx, centers, b, n, m, threads, stamp, s);
    case 16:
      return launch_p<16>(xyz, idx, centers, b, n, m, threads, stamp, s);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// xyz (B, N, 3) f32 -> idx (B, M) i32, centers (B, M, 3) f32; one block per
// cloud on fps_plan's threads; 1 <= M <= N <= kMaxThreads * kMaxP.
LION_EXPORT int lion_fps(const void* xyz, void* idx, void* centers, int b,
                         int n, int m, void* stream) {
  int threads = 0;
  const int p = n >= 1 ? fps_plan(n, &threads) : 0;
  if (p == 0 || m < 1 || m > n) return static_cast<int>(cudaErrorInvalidValue);
  if (b == 0) return static_cast<int>(cudaSuccess);
  return launch_plan(xyz, idx, centers, b, n, m, threads, p, NoStamp{},
                     static_cast<cudaStream_t>(stream));
}

LION_EXPORT const char* lion_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// K11: index-only ball query.
//
// Replaces lion_tpu/ops/pallas/ball_query.py: ball_query_pallas
// (_bq_kernel). The JAX package reaches it from the backward replay of
// ball_query_group (lion_tpu/ops/points.py:241-254 -> ball_query,
// :135-137); the port's backward of ball_query_group calls it the same way.
//
// Semantics: for each center, the first K point indices (index order)
// whose squared distance ((dx*dx + dy*dy) + dz*dz, each operation rounded
// on its own) is strictly below r^2, as int32. Slots past the hit count
// copy slot 0; an empty ball is all 0 (ball_query.py:83-87).
//
// Bound on the H100: the distance scan, 8 fp32 operations per (center,
// point) pair up to the K-th hit, against K * 4 bytes written per center;
// at B16 M1024 N2048 r0.1 a few microseconds either way, so the kernel is
// bounded by how fast it issues the scan.
// Design: K2's scan (ball_scan.cuh: the cloud staged in shared memory as
// float4 tiles, two centers a warp, four 32-point chunks a round, one vote
// that skips the rounds without a hit, slots by prefix popcounts in index
// order), so K2's balls are K11's by construction. A block takes `cpb`
// consecutive centers of one item, whose slots form one contiguous span
// of the output. Right after a pair's scan the warp writes the pair's 2 K
// slots at once, lane l taking 16-byte chunks l, l + 32, ... (single ints
// when K is not a multiple of 4), the fill past the hit count and the
// empty ball in registers. The caller's plan (ops/points.py: bq_plan,
// within the limits below) picks cpb, the threads (the most: the warps
// without a pair help stage the cloud) and the tile from (B, N, M, K) so
// that every level fills the card.
#include "ball_scan.cuh"
#include "common.cuh"

namespace {

using lion::kRound;
using lion::kTileN;

constexpr int kMaxThreads = 256;     // threads a block, at most
constexpr int kMaxCenters = 32;      // centers a block, at most
constexpr int kSmemMax = 232448;     // a block's shared memory on the H100

// Dynamic shared memory: the cloud tile padded to whole rounds as float4,
// then the slots' point indices and the hit counts.
long long smem_bytes(int cpb, int k, int tile) {
  return 16LL * (tile + kRound) + 4LL * cpb * k + 4LL * cpb;
}

// The slots of the scanned pair ca, ca + nc - 1 (nc K ints from o, the
// output of center ca), written by its warp: lane l takes the V-int chunks
// l, l + 32, ...; a chunk lies in one center's slots (V divides K).
template <int V>
__device__ __forceinline__ void write_slots(const int* ssel,
                                            const int* scount, int ca,
                                            int nc, int k,
                                            int* __restrict__ o) {
  const int lane = threadIdx.x & 31;
  for (int e = V * lane; e < nc * k; e += 32 * V) {
    const int cc = e >= k ? 1 : 0, s = e - cc * k;
    const int* sel = ssel + (ca + cc) * k;
    const int count = scount[ca + cc];
    int v[V];
#pragma unroll
    for (int u = 0; u < V; ++u) v[u] = lion::ball_slot(sel, count, k, s + u);
    if constexpr (V == 4) {
      *reinterpret_cast<int4*>(o + e) = make_int4(v[0], v[1], v[2], v[3]);
    } else {
      o[e] = v[0];
    }
  }
}

// grid (ceil(M / cpb), B); V ints a chunk of the write (4 when K is a
// multiple of 4).
template <int V>
__global__ void __launch_bounds__(kMaxThreads)
bq_kernel(const float* __restrict__ points, const float* __restrict__ ctrs,
          int n, int m, int k, float r2, int cpb, int tile,
          int* __restrict__ out) {
  extern __shared__ float4 smem[];
  const int t = threadIdx.x;
  float4* scloud = smem;                                 // tile points
  int* ssel = reinterpret_cast<int*>(scloud + tile + kRound);  // cpb K
  int* scount = ssel + cpb * k;                          // cpb hit counts

  const int b = blockIdx.y, m0 = blockIdx.x * cpb;
  const int ncent = min(cpb, m - m0);
  const float* pts = points + static_cast<size_t>(b) * n * 3;
  const float* cb = ctrs + (static_cast<size_t>(b) * m + m0) * 3;
  int* ob = out + (static_cast<size_t>(b) * m + m0) * k;
  if (t < ncent) scount[t] = 0;
  lion::scan_block(scloud, pts, n, tile, cb, ncent, k, r2, ssel, scount,
                   [&](int ca, int nc) {
    write_slots<V>(ssel, scount, ca, nc, k, ob + ca * k);
  });
}

template <int V>
int launch(const void* centers, const void* points, void* out, int b, int n,
           int m, int k, float r2, int cpb, int threads, int tile, int smem,
           cudaStream_t s) {
  static unsigned done = 0;
  const cudaError_t e = lion::set_smem_once(
      reinterpret_cast<const void*>(bq_kernel<V>), kSmemMax, &done);
  if (e != cudaSuccess) return static_cast<int>(e);
  const dim3 grid(lion::ceil_div(m, cpb), b);
  bq_kernel<V><<<grid, threads, smem, s>>>(
      static_cast<const float*>(points), static_cast<const float*>(centers),
      n, m, k, r2, cpb, tile, static_cast<int*>(out));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// centers (B, M, 3), points (B, N, 3) f32 -> out (B, M, K) int32. r2 is the
// squared radius in fp32. (cpb, threads, tile) is the plan (ops/points.py:
// bq_plan): blocks of `threads` threads taking `cpb` centers each and the
// cloud `tile` points at a time; every pointer 16-byte aligned.
LION_EXPORT int lion_ball_query(const void* centers, const void* points,
                                void* out, int b, int n, int m, int k,
                                float r2, int cpb, int threads, int tile,
                                void* stream) {
  const long long smem = smem_bytes(cpb, k, tile);
  if (n < 1 || k < 1 || threads < 32 || threads > kMaxThreads ||
      threads % 32 != 0 || cpb < 1 || cpb > kMaxCenters || tile < 1 ||
      tile > kTileN || smem > kSmemMax)
    return static_cast<int>(cudaErrorInvalidValue);
  if (b == 0 || m == 0) return static_cast<int>(cudaSuccess);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (k % 4 == 0) {
    return launch<4>(centers, points, out, b, n, m, k, r2, cpb, threads,
                     tile, static_cast<int>(smem), s);
  }
  return launch<1>(centers, points, out, b, n, m, k, r2, cpb, threads, tile,
                   static_cast<int>(smem), s);
}

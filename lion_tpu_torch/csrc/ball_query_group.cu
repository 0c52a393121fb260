// K2: fused ball query + grouping.
//
// Replaces lion_tpu/ops/pallas/ball_query_group.py: ball_query_group_pallas
// (_bqg_kernel).
//
// Semantics: for each center, the first K points (in index order) whose
// squared distance (lion::sq_dist) is strictly below r^2. Slots past the
// hit count copy slot 0; an empty ball takes point 0 in every slot. Each
// slot emits the row [point - center (3), point features (C)] in the
// features' dtype, fp32 or bf16: the relative coordinates are computed in
// fp32 and rounded once, the features copied exactly
// (ball_query_group.py:299-310).
// The balls are K11's (csrc/ball_query.cu), which K2's backward replays.
//
// Bound on the H100: device-memory bandwidth on the output, K (3 + C)
// values a center (0.0233 ms at B16 N2048 M1024 K32 C32 fp32), beside the
// B M N distance tests of the scan (a sparse ball scans the whole cloud),
// which take about as long as the writes at the top level.
// Design: a block takes `cpb` consecutive centers of one item, whose
// output tiles form one contiguous span, and finds their balls by the
// shared scan (ball_scan.cuh: the cloud staged in shared memory as float4
// tiles, two centers a warp, four 32-point chunks a round, one vote that
// skips the rounds without a hit, slots by prefix popcounts in index
// order). The pair's output tiles are one contiguous span: right after a
// warp's pair is scanned, its rows' point indices and point - center go
// to shared memory, and the warp writes the span flat at once, lane l
// taking 16-byte chunks l, l + 32, ... (4 floats or 8 bf16, or single
// values when K (3 + C) is not a multiple of those), the (row, channel) of
// each stepped
// without a divide, the features gathered from the point's row; then its
// next pair. No barrier follows the staging, so one warp's writes can
// overlap another's scan. A block of a single pair (the small levels)
// writes it with all its threads. The caller's plan (ops/points.py:
// bqg_plan, within the limits below) picks cpb, the threads and the tile
// from (B, N, M, C, K) so that the small levels fill the card.
#include <climits>

#include "ball_scan.cuh"
#include "common.cuh"

namespace {

using lion::kRound;
using lion::kTileN;

constexpr int kMaxThreads = 256;     // threads a block, at most
constexpr int kMaxCenters = 32;      // centers a block, at most
constexpr int kSmemMax = 232448;     // a block's shared memory on the H100

// Dynamic shared memory: the cloud tile padded to whole rounds (points at
// infinity, in no ball) and each warp's 2 K rows (x, y, z, point index) as
// float4, then the slots' point indices and the hit counts. (A block of
// one pair writes it from warp 0's rows.)
long long smem_bytes(int cpb, int k, int tile, int threads) {
  return 16LL * (tile + kRound) + 16LL * (threads / 32) * 2 * k +
         4LL * cpb * k + 4LL * cpb;
}

// The team's barrier: the block's, or the warp's.
__device__ __forceinline__ void team_sync(bool block) {
  if (block) {
    __syncthreads();
  } else {
    __syncwarp();
  }
}

// A pair of scanned centers ca, ca + nc - 1 of the block, written by a
// team (a warp, or the whole block when it holds one pair): their rows (a
// slot past the hit count copies slot 0, an empty ball takes point 0;
// point - center in fp32) into `rows`, then the pair's span of the output,
// nc K (3 + C) values of T, flat: team thread l takes the V-value chunks l,
// l + size, ..., the (row, channel) of each stepped without a divide, the
// features gathered from the row's point, point - center rounded to T.
template <typename T, int V>
__device__ __forceinline__ void write_pair(
    const float* pts, const float* cb, const T* __restrict__ fb, int ca,
    int nc, int k, int c, const int* ssel, const int* scount, float4* rows,
    T* __restrict__ ob, int l, int size, bool block) {
  for (int r = l; r < nc * k; r += size) {
    const int cc = ca + (r >= k ? 1 : 0), s = r >= k ? r - k : r;
    const int p = lion::ball_slot(ssel + cc * k, scount[cc], k, s);
    const float* pp = pts + 3 * static_cast<size_t>(p);
    rows[r] = make_float4(__fsub_rn(pp[0], cb[3 * cc]),
                          __fsub_rn(pp[1], cb[3 * cc + 1]),
                          __fsub_rn(pp[2], cb[3 * cc + 2]),
                          __int_as_float(p));
  }
  team_sync(block);
  const int w = 3 + c;
  const int span = nc * k * w;
  const int drow = size * V / w, dch = size * V - drow * w;
  int row = V * l / w, ch = V * l - row * w;
  for (int e = V * l; e < span; e += size * V) {
    alignas(16) T v[V];
    int rr = row, cch = ch;
#pragma unroll
    for (int u = 0; u < V; ++u) {
      const float4 rw = rows[rr];
      const int p = __float_as_int(rw.w);
      if (cch >= 3) {
        v[u] = __ldg(fb + static_cast<size_t>(p) * c + (cch - 3));
      } else {
        lion::store(v + u, cch == 0 ? rw.x : (cch == 1 ? rw.y : rw.z));
      }
      if (++cch == w) {
        cch = 0;
        ++rr;
      }
    }
    if constexpr (V * sizeof(T) == 16) {
      *reinterpret_cast<uint4*>(ob + e) = *reinterpret_cast<const uint4*>(v);
    } else {
      ob[e] = v[0];
    }
    row += drow;
    ch += dch;
    if (ch >= w) {
      ch -= w;
      ++row;
    }
  }
  team_sync(block);   // the rows are free for the team's next pair
}

// grid (ceil(M / cpb), B); V values of T a chunk of the flat write (16
// bytes when K (3 + C) is a multiple of V). The block finds its balls by
// lion::scan_block; a warp writes each of its pairs right after the
// pair's scan of the last tile. A block of one pair (cpb <= 2) writes it
// with all its threads after warp 0's scan.
template <typename T, int V>
__global__ void __launch_bounds__(kMaxThreads)
bqg_kernel(const float* __restrict__ points, const float* __restrict__ ctrs,
           const T* __restrict__ feats, int n, int m, int c, int k,
           float r2, int cpb, int tile, T* __restrict__ out) {
  extern __shared__ float4 smem[];
  const int t = threadIdx.x, warp = t >> 5, warps = blockDim.x >> 5;
  const int lane = t & 31;
  float4* scloud = smem;                               // tile points
  float4* rows = scloud + tile + kRound;               // 2 K rows a warp
  int* ssel = reinterpret_cast<int*>(rows + warps * 2 * k);  // cpb K slots
  int* scount = ssel + cpb * k;                        // cpb hit counts

  const int b = blockIdx.y, m0 = blockIdx.x * cpb;
  const int ncent = min(cpb, m - m0);
  const float* pts = points + static_cast<size_t>(b) * n * 3;
  const float* cb = ctrs + (static_cast<size_t>(b) * m + m0) * 3;
  const T* fb = feats + static_cast<size_t>(b) * n * c;
  const size_t row_vals = static_cast<size_t>(k) * (3 + c);
  T* ob = out + (static_cast<size_t>(b) * m + m0) * row_vals;
  const bool block = cpb <= 2;      // one pair: the block writes it
  if (t < ncent) scount[t] = 0;

  lion::scan_block(scloud, pts, n, tile, cb, ncent, k, r2, ssel, scount,
                   [&](int ca, int nc) {
    if (!block) {
      write_pair<T, V>(pts, cb, fb, ca, nc, k, c, ssel, scount,
                       rows + warp * 2 * k, ob + ca * row_vals, lane, 32,
                       false);
    }
  });
  if (block) {
    __syncthreads();
    write_pair<T, V>(pts, cb, fb, 0, ncent, k, c, ssel, scount, rows, ob,
                     t, blockDim.x, true);
  }
}

template <typename T, int V>
int launch(const void* points, const void* centers, const void* feats,
           void* out, int b, int n, int m, int c, int k, float r2, int cpb,
           int threads, int tile, int smem, cudaStream_t s) {
  static unsigned done = 0;
  const cudaError_t e = lion::set_smem_once(
      reinterpret_cast<const void*>(bqg_kernel<T, V>), kSmemMax, &done);
  if (e != cudaSuccess) return static_cast<int>(e);
  const dim3 grid(lion::ceil_div(m, cpb), b);
  bqg_kernel<T, V><<<grid, threads, smem, s>>>(
      static_cast<const float*>(points), static_cast<const float*>(centers),
      static_cast<const T*>(feats), n, m, c, k, r2, cpb, tile,
      static_cast<T*>(out));
  return static_cast<int>(cudaGetLastError());
}

// The flat write's chunk: 16 bytes of T where K (3 + C) is a multiple of
// them, else single values.
template <typename T>
int launch_dtype(const void* points, const void* centers, const void* feats,
                 void* out, int b, int n, int m, int c, int k, float r2,
                 int cpb, int threads, int tile, int smem, cudaStream_t s) {
  constexpr int kVec = 16 / sizeof(T);
  if (static_cast<long long>(k) * (3 + c) % kVec == 0)
    return launch<T, kVec>(points, centers, feats, out, b, n, m, c, k, r2,
                           cpb, threads, tile, smem, s);
  return launch<T, 1>(points, centers, feats, out, b, n, m, c, k, r2, cpb,
                      threads, tile, smem, s);
}

}  // namespace

// points (B, N, 3), centers (B, M, 3) f32, feats (B, N, C) f32 or bf16
// (is_bf16) -> out (B, M, K, 3 + C) of the features' dtype. r2 is the
// squared radius in fp32.
// (cpb, threads, tile) is the plan (ops/points.py: bqg_plan): blocks of
// `threads` threads taking `cpb` centers each and the cloud `tile` points
// at a time; every pointer 16-byte aligned.
LION_EXPORT int lion_ball_query_group(const void* points, const void* centers,
                                      const void* feats, void* out, int b,
                                      int n, int m, int c, int k, float r2,
                                      int is_bf16, int cpb, int threads,
                                      int tile, void* stream) {
  const long long smem = smem_bytes(cpb, k, tile, threads);
  if (n < 1 || k < 1 || c < 0 || threads < 32 || threads > kMaxThreads ||
      threads % 32 != 0 || cpb < 1 || cpb > kMaxCenters || tile < 1 ||
      tile > kTileN || smem > kSmemMax ||
      static_cast<long long>(cpb) * k * (3 + c) > INT_MAX)
    return static_cast<int>(cudaErrorInvalidValue);
  if (b == 0 || m == 0) return static_cast<int>(cudaSuccess);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_bf16)
    return launch_dtype<lion::bf16>(points, centers, feats, out, b, n, m, c,
                                    k, r2, cpb, threads, tile,
                                    static_cast<int>(smem), s);
  return launch_dtype<float>(points, centers, feats, out, b, n, m, c, k, r2,
                             cpb, threads, tile, static_cast<int>(smem), s);
}

// K13: fused ball query + grouping, channel-first output.
//
// Replaces lion_tpu/ops/pallas/ball_query_group.py:
// ball_query_group_cf_pallas (_bqg_cf_kernel).
//
// Semantics: those of K2 (ball_query_group.cu) transposed to
// (B, K, 3 + C, M): for each center the first K points (index order) whose
// squared distance is strictly below r^2, slots past the hit count copying
// slot 0 and an empty ball taking point 0; row (k, ch) of center m holds
// the slot's point minus the center (ch < 3) or its feature ch - 3. The
// output takes the features' dtype (fp32 or bf16): the coordinates are
// subtracted in fp32 and rounded once, the features copied as they are.
// The TPU kernel gathers through a bf16 hi/lo one-hot matmul, which rounds
// fp32 features to bf16 and the coordinates to about 16 bits; this kernel
// gathers exactly, as the XLA form of the JAX op does.
//
// Bound on the H100: device-memory bandwidth on the output, K (3 + C)
// values a center (0.0233 ms fp32 at B16 N2048 M1024 K32 C32), beside the
// B M N distance tests of the scan.
// Design: a block takes `cpb` consecutive centers of one item and a group
// of `ks` consecutive slots. It finds the balls' first slots up to its
// group's last by K2's scan (ball_scan.cuh: the cloud staged in shared
// memory as float4 tiles, two centers a warp, four 32-point chunks a round,
// one vote that skips the rounds without a hit, slots by prefix popcounts
// in index order) and writes the group's filled slots slot-major to shared
// memory. Then its warps share out the units of work, a unit being a
// slot's feature rows ch0, ch0 + 1, ... (and its 3 coordinate rows with
// the first), with no block barrier. The coordinate rows go out from lane
// j = center j. The feature rows go out as 4 x 4 tiles (4 centers, 4
// channels) where 4 divides C, M and cpb (the main path's shapes): a lane
// loads a tile's 4 feature rows with one load each (16 bytes fp32, 8
// bf16), transposes the tile in registers and stores its 4 columns with
// one store each, so a tile moves with 8 memory instructions and no
// shared memory; a warp's stores of one channel cover the block's row
// segment. (Tiles of 8 x 8 bf16 halve the instructions but take 80
// registers a thread, three blocks an SM: slower at SA0.) Elsewhere the
// rows are staged: each warp gathers kRows channels of every center into
// its own shared transpose buffer, lanes along the channels, and writes
// the buffer with lanes along the centers. The transpose buffers take the
// cloud tile's place once the scan is done. The caller's
// plan (ops/points.py: bqg_cf_plan, within the limits below) picks cpb (a
// power of two, at least 16 where M allows, for long row segments), the
// slot groups (whose blocks scan their centers again), the threads and
// the tile from (B, N, M, C, K) so that every level fills the card.
#include <type_traits>

#include "ball_scan.cuh"
#include "common.cuh"

namespace {

using lion::kRound;
using lion::kTileN;

constexpr int kMaxThreads = 256;     // threads a block, at most
constexpr int kMaxCenters = 32;      // centers a block, at most
constexpr int kSmemMax = 232448;     // a block's shared memory on the H100
constexpr int kRows = 32;            // feature rows a staged unit, one a lane
constexpr int kTile = 4;             // centers and channels a tile
constexpr int kQuads = 8;            // channel tiles a tiled unit

// Dynamic shared memory: the cloud tile padded to whole rounds as float4,
// and in its place after the scan each warp's transpose buffer (kRows
// rows of cpb + 1 values: an odd stride, so the lanes' stores meet
// distinct banks), then the scan's slots and hit counts and the group's
// filled slots, slot-major.
long long scan_area(int cpb, int tile, int threads, int size) {
  const long long bufs = (threads / 32) * kRows * (cpb + 1LL) * size;
  const long long cloud = 16LL * (tile + kRound);
  return cloud > bufs ? cloud : (bufs + 15) / 16 * 16;
}

long long smem_bytes(int cpb, int k, int tile, int threads, int size) {
  return scan_area(cpb, tile, threads, size) + 8LL * cpb * k + 4LL * cpb;
}

// The feature rows of a tiled unit: the slot's channels [ch0, ch0 +
// kQuads Q) of the block's centers, as Q x Q tiles (center group, channel
// quad) t = lane, lane + 32, ..., the group t mod (cpb / Q) and the quad
// t / (cpb / Q). st: the slot's point of each center; oc: row 3 + ch0 of
// the slot at the block's first center.
template <typename T>
__device__ __forceinline__ void write_tiles(const T* __restrict__ fb,
                                            const int* st, int ncent,
                                            int cpb, int c, int m, int ch0,
                                            T* __restrict__ oc) {
  constexpr int Q = kTile;
  using Vec = typename std::conditional<sizeof(T) == 4, uint4, uint2>::type;
  const int lane = threadIdx.x & 31, groups = cpb / Q;
  for (int t = lane; t < groups * kQuads; t += 32) {
    const int j0 = (t % groups) * Q, c0 = ch0 + (t / groups) * Q;
    if (j0 >= ncent || c0 >= c) continue;   // whole tiles: Q | M, Q | C
    Vec r[Q];   // row e: Q channels of center j0 + e
#pragma unroll
    for (int e = 0; e < Q; ++e) {
      r[e] = *reinterpret_cast<const Vec*>(
          fb + static_cast<size_t>(st[j0 + e]) * c + c0);
    }
    T* o = oc + static_cast<size_t>(c0 - ch0) * m + j0;
#pragma unroll
    for (int e = 0; e < Q; ++e) {   // column e: channel c0 + e of each row
      if constexpr (sizeof(T) == 4) {
        *reinterpret_cast<uint4*>(o + static_cast<size_t>(e) * m) =
            make_uint4((&r[0].x)[e], (&r[1].x)[e], (&r[2].x)[e],
                       (&r[3].x)[e]);
      } else {   // half e of rows 2i and 2i + 1 make word i
        const unsigned sel = (e & 1) ? 0x7632u : 0x5410u;
        *reinterpret_cast<uint2*>(o + static_cast<size_t>(e) * m) =
            make_uint2(
                __byte_perm((&r[0].x)[e >> 1], (&r[1].x)[e >> 1], sel),
                __byte_perm((&r[2].x)[e >> 1], (&r[3].x)[e >> 1], sel));
      }
    }
  }
}

// grid (ceil(M / cpb), B, ceil(K / ks)). Block (x, b, g) takes centers
// x cpb, ... and slots g ks, ..., g ks + ks - 1 (up to K); cpb is a power
// of two. kTiled: the feature rows as register tiles (kTile divides C, M
// and cpb); else staged.
template <typename T, bool kTiled>
__global__ void __launch_bounds__(kMaxThreads)
bqg_cf_kernel(const float* __restrict__ points, const float* __restrict__ ctrs,
              const T* __restrict__ feats, int n, int m, int c, int k,
              float r2, int cpb, int ks, int tile, int area,
              T* __restrict__ out) {
  extern __shared__ float4 smem[];
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  const int warps = blockDim.x >> 5, w = 3 + c;
  float4* scloud = smem;                                  // tile points
  int* ssel = reinterpret_cast<int*>(
      reinterpret_cast<char*>(smem) + area);              // cpb s1 slots
  int* scount = ssel + cpb * k;                           // cpb hit counts
  int* sfill = scount + cpb;                              // ks cpb, filled

  const int s0 = blockIdx.z * ks, s1 = min(k, s0 + ks);
  const int b = blockIdx.y, m0 = blockIdx.x * cpb;
  const int ncent = min(cpb, m - m0);
  const float* pts = points + static_cast<size_t>(b) * n * 3;
  const float* cb = ctrs + (static_cast<size_t>(b) * m + m0) * 3;
  const T* fb = feats + static_cast<size_t>(b) * n * c;
  // row (s, ch) of item b starts at ((b K + s) w + ch) M
  T* ob = out + static_cast<size_t>(b) * k * w * m + m0;
  if (t < ncent) scount[t] = 0;

  // the first s1 slots of every ball (s1 slots a center), then the
  // group's slots filled, slot-major: sfill[(s - s0) cpb + j]
  lion::scan_block(scloud, pts, n, tile, cb, ncent, s1, r2, ssel, scount,
                   [](int, int) {});
  __syncthreads();
  for (int i = t; i < ncent * (s1 - s0); i += blockDim.x) {
    const int j = i / (s1 - s0), s = i - j * (s1 - s0);
    sfill[s * cpb + j] = lion::ball_slot(ssel + j * s1, scount[j], s1,
                                         s0 + s);
  }
  __syncthreads();   // the slots are set; the cloud tile is free

  // units: per slot, the feature rows in chunks of `rows` (at least one
  // unit, which also writes the coordinate rows)
  const int rows = kTiled ? kQuads * kTile : kRows;
  const int per_slot = max(1, (c + rows - 1) / rows);
  const int units = (s1 - s0) * per_slot;
  float cl[3] = {0.0f, 0.0f, 0.0f};   // center lane's coordinates
  if (lane < ncent) {
#pragma unroll
    for (int d = 0; d < 3; ++d) cl[d] = cb[3 * lane + d];
  }
  // the coordinate rows of slot s: lane j writes center j's
  auto coords = [&](int s) {
    if (lane < ncent) {
      const size_t p = sfill[(s - s0) * cpb + lane];
      T* os = ob + static_cast<size_t>(s) * w * m + lane;
#pragma unroll
      for (int d = 0; d < 3; ++d) {
        lion::store(os + static_cast<size_t>(d) * m,
                    __fsub_rn(pts[3 * p + d], cl[d]));
      }
    }
  };
  if constexpr (kTiled) {
    for (int u = warp; u < units; u += warps) {
      const int s = s0 + u / per_slot;
      const int ch0 = (u - (s - s0) * per_slot) * rows;
      if (ch0 == 0) coords(s);
      write_tiles<T>(fb, sfill + (s - s0) * cpb, ncent, cpb, c, m, ch0,
                     ob + (static_cast<size_t>(s) * w + 3 + ch0) * m);
    }
  } else {
    // staged: lane l gathers channel ch0 + l of every center into the
    // warp's buffer, then the warp writes it, lanes along (row, center)
    const int stride = cpb + 1;
    T* buf = reinterpret_cast<T*>(smem) + warp * kRows * stride;
    const int shift = __ffs(cpb) - 1;
    for (int u = warp; u < units; u += warps) {
      const int s = s0 + u / per_slot;
      const int ch0 = (u - (s - s0) * per_slot) * kRows;
      const int nr = max(0, min(kRows, c - ch0));
      const int* st = sfill + (s - s0) * cpb;
      if (ch0 == 0) coords(s);
      if (lane < nr) {
        T v[kMaxCenters];   // all the lane's loads in flight at once
#pragma unroll
        for (int j = 0; j < kMaxCenters; ++j) {
          if (j < ncent) {
            v[j] = fb[static_cast<size_t>(st[j]) * c + ch0 + lane];
          }
        }
#pragma unroll
        for (int j = 0; j < kMaxCenters; ++j) {
          if (j < ncent) buf[lane * stride + j] = v[j];
        }
      }
      __syncwarp();
      T* oc = ob + (static_cast<size_t>(s) * w + 3 + ch0) * m;
      for (int i = lane; i < nr * cpb; i += 32) {
        const int r = i >> shift, j = i & (cpb - 1);
        if (j < ncent) {
          oc[static_cast<size_t>(r) * m + j] = buf[r * stride + j];
        }
      }
      __syncwarp();   // the buffer is free for the warp's next unit
    }
  }
}

template <typename T, bool kTiled>
int launch(const void* points, const void* centers, const void* feats,
           void* out, int b, int n, int m, int c, int k, float r2, int cpb,
           int groups, int threads, int tile, cudaStream_t s) {
  static unsigned done = 0;
  const cudaError_t e = lion::set_smem_once(
      reinterpret_cast<const void*>(bqg_cf_kernel<T, kTiled>), kSmemMax,
      &done);
  if (e != cudaSuccess) return static_cast<int>(e);
  const int ks = lion::ceil_div(k, groups);   // slots a group, none empty
  const int size = static_cast<int>(sizeof(T));
  const dim3 grid(lion::ceil_div(m, cpb), b, lion::ceil_div(k, ks));
  bqg_cf_kernel<T, kTiled><<<grid, threads,
                             smem_bytes(cpb, k, tile, threads, size), s>>>(
      static_cast<const float*>(points), static_cast<const float*>(centers),
      static_cast<const T*>(feats), n, m, c, k, r2, cpb, ks, tile,
      static_cast<int>(scan_area(cpb, tile, threads, size)),
      static_cast<T*>(out));
  return static_cast<int>(cudaGetLastError());
}

// The feature rows tiled where kTile divides C, M and cpb, else staged.
template <typename T>
int dispatch(const void* points, const void* centers, const void* feats,
             void* out, int b, int n, int m, int c, int k, float r2, int cpb,
             int groups, int threads, int tile, cudaStream_t s) {
  if (c % kTile == 0 && m % kTile == 0 && cpb % kTile == 0) {
    return launch<T, true>(points, centers, feats, out, b, n, m, c, k, r2,
                           cpb, groups, threads, tile, s);
  }
  return launch<T, false>(points, centers, feats, out, b, n, m, c, k, r2,
                          cpb, groups, threads, tile, s);
}

}  // namespace

// points (B, N, 3), centers (B, M, 3) f32, feats (B, N, C) f32 or bf16
// (is_bf16) -> out (B, K, 3 + C, M) of the features' dtype. r2 is the
// squared radius in fp32. (cpb, groups, threads, tile) is the plan
// (ops/points.py: bqg_cf_plan): blocks of `threads` threads taking `cpb`
// centers (a power of two) and ceil(K / groups) slots each, the cloud
// `tile` points at a time; every pointer 16-byte aligned.
LION_EXPORT int lion_ball_query_group_cf(const void* points,
                                         const void* centers,
                                         const void* feats, void* out, int b,
                                         int n, int m, int c, int k, float r2,
                                         int is_bf16, int cpb, int groups,
                                         int threads, int tile,
                                         void* stream) {
  const long long smem = smem_bytes(cpb, k, tile, threads, is_bf16 ? 2 : 4);
  if (n < 1 || k < 1 || c < 0 || threads < 32 || threads > kMaxThreads ||
      threads % 32 != 0 || cpb < 1 || cpb > kMaxCenters ||
      (cpb & (cpb - 1)) != 0 || groups < 1 || groups > k || tile < 1 ||
      tile > kTileN || smem > kSmemMax)
    return static_cast<int>(cudaErrorInvalidValue);
  if (b == 0 || m == 0) return static_cast<int>(cudaSuccess);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_bf16) {
    return dispatch<lion::bf16>(points, centers, feats, out, b, n, m, c, k,
                                r2, cpb, groups, threads, tile, s);
  }
  return dispatch<float>(points, centers, feats, out, b, n, m, c, k, r2, cpb,
                         groups, threads, tile, s);
}

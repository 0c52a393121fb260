// K6: exact 3-nearest-neighbour inverse-distance interpolation.
//
// Replaces lion_tpu/ops/pallas/three_nn.py: three_nn_interpolate_pallas
// (_three_nn_kernel).
//
// Semantics: d2 = max((|p|^2 + |c|^2) - 2 p.c, 0) as in the JAX forms; the
// three smallest d2 with strict '<' in index order (ties go to the lowest
// index), which are the three smallest under the order (d2, index); d2
// clamped to [1e-10, 1e10]; weights w_i = prod_{j!=i} d_j /
// sum_k prod_{j!=k} d_j; out = (f0*w0 + f1*w1) + f2*w2. With fewer than 3
// centers the empty slots keep index 0 and d2 = 1e10. Features are float32
// or bfloat16: with bf16 the three weights are rounded to bf16, as the JAX
// form casts them (lion_tpu/ops/interpolate.py:98), and the weighted sum is
// taken in float32 and rounded once; with float32 everything stays fp32.
// Optionally the kernel also writes each point's three neighbour indices
// (int32) and weights (as used, float32): the backward of the
// interpolation is a scatter-add of g * w into the centers' features and
// needs no distance matrix (ops/interpolate.py).
//
// Bound on the H100: device-memory bandwidth on the N*C output (0.0114 ms
// at B16 N2048 C192 fp32); the N*M distance scan beside it is what binds
// at the top level, its top-3 bookkeeping about half of it. The U-Net's
// four levels have (N, M) = (2048, 1024), (1024, 256), (256, 64) and
// (64, 16), so three launches of four are small.
// Design: L lanes share a point (L a power of two up to a warp), each
// scanning a strided share of the centers (center j goes to lane j mod L)
// from shared memory, one 16-byte load per center staged once a block as
// (x, y, z, |c|^2), kGroup centers a step, the step's least inserted
// without a branch, keeping its own best three in registers. The lanes'
// triples merge in log2 L shuffle rounds under the order (d2, index): the
// partner's three are inserted into one's own, so every lane ends with the
// serial scan's three. Each warp then writes its own 32 / L points' rows,
// with no barrier after the staging, so one warp's writes can overlap
// another's scan: with C a multiple of 16 bytes' worth of channels each
// lane takes (row, 16-byte chunk) pairs, stepping without a divide, with
// kUnroll chunks (three 16-byte neighbour loads each) in flight before
// their 16-byte stores; otherwise the lanes take a row's channels. The
// caller's plan (ops/interpolate.py: three_nn_plan, within the limits
// below) picks the threads and L from (B, N) so that every level fills
// the card.
#include <cmath>

#include "common.cuh"

namespace {

constexpr int kMaxThreads = 256;   // threads a block, at most
constexpr int kMaxLanes = 32;      // lanes a point, at most
constexpr int kTile = 1024;        // centers a shared-memory tile
constexpr int kGroup = 4;          // centers a lane takes a step
constexpr int kUnroll = 2;         // output chunks in flight a thread

// The best three (d2, index) of a point, sorted under that order.
struct Best3 {
  float d0, d1, d2;
  int i0, i1, i2;
};

// The scan's insertion, without branches: the centers come in index order,
// so a strict '<' on d2 places a new center after every kept one with the
// same d2; a no-op unless d beats the third best.
__device__ __forceinline__ void insert_one(Best3& b, float d, int i) {
  const bool c0 = d < b.d0, c1 = d < b.d1, c2 = d < b.d2;
  const float d2 = c1 ? b.d1 : (c2 ? d : b.d2);
  const int i2 = c1 ? b.i1 : (c2 ? i : b.i2);
  const float d1 = c0 ? b.d0 : (c1 ? d : b.d1);
  const int i1 = c0 ? b.i0 : (c1 ? i : b.i1);
  b.d0 = c0 ? d : b.d0;
  b.i0 = c0 ? i : b.i0;
  b.d1 = d1;
  b.i1 = i1;
  b.d2 = d2;
  b.i2 = i2;
}

__device__ __forceinline__ bool before(float da, int ia, float db, int ib) {
  return da < db || (da == db && ia < ib);
}

// The lanes' merge: the insertion under the order (d2, index), without
// branches, the two triples coming from disjoint centers. A center at d2 =
// inf is never kept, so an empty slot (d2 = inf, index 0) loses to every
// center that is.
__device__ __forceinline__ void insert_lex(Best3& b, float d, int i) {
  const bool c0 = before(d, i, b.d0, b.i0), c1 = before(d, i, b.d1, b.i1);
  const bool c2 = before(d, i, b.d2, b.i2);
  const float d2 = c1 ? b.d1 : (c2 ? d : b.d2);
  const int i2 = c1 ? b.i1 : (c2 ? i : b.i2);
  const float d1 = c0 ? b.d0 : (c1 ? d : b.d1);
  const int i1 = c0 ? b.i0 : (c1 ? i : b.i1);
  b.d0 = c0 ? d : b.d0;
  b.i0 = c0 ? i : b.i0;
  b.d1 = d1;
  b.i1 = i1;
  b.d2 = d2;
  b.i2 = i2;
}

__device__ __forceinline__ float mix(float f0, float f1, float f2,
                                     const float4& w) {
  return __fadd_rn(__fadd_rn(__fmul_rn(f0, w.x), __fmul_rn(f1, w.y)),
                   __fmul_rn(f2, w.z));
}

// 16 bytes of the three neighbours' features -> 16 bytes of output.
__device__ __forceinline__ float4 blend(const float4& a, const float4& b,
                                        const float4& c, const float4& w) {
  return make_float4(mix(a.x, b.x, c.x, w), mix(a.y, b.y, c.y, w),
                     mix(a.z, b.z, c.z, w), mix(a.w, b.w, c.w, w));
}

__device__ __forceinline__ float lo(unsigned v) {
  return __uint_as_float(v << 16);
}
__device__ __forceinline__ float hi(unsigned v) {
  return __uint_as_float(v & 0xffff0000u);
}

// Two bf16 of each neighbour (low half first) -> two bf16, each rounded
// once to nearest even.
__device__ __forceinline__ unsigned blend2(unsigned a, unsigned b, unsigned c,
                                           const float4& w) {
  const __nv_bfloat162 r = __floats2bfloat162_rn(
      mix(lo(a), lo(b), lo(c), w), mix(hi(a), hi(b), hi(c), w));
  return *reinterpret_cast<const unsigned*>(&r);
}

__device__ __forceinline__ uint4 blend(const uint4& a, const uint4& b,
                                       const uint4& c, const float4& w) {
  return make_uint4(blend2(a.x, b.x, c.x, w), blend2(a.y, b.y, c.y, w),
                    blend2(a.z, b.z, c.z, w), blend2(a.w, b.w, c.w, w));
}

// 16 bytes of T.
template <typename T>
struct Chunk;
template <>
struct Chunk<float> {
  using type = float4;
};
template <>
struct Chunk<lion::bf16> {
  using type = uint4;
};

// One lane's scan of the staged centers sc[0, cnt) (global index t0 + j):
// centers g, g + L, g + 2L, g + 3L a step, kGroup independent distances.
// The step's least (the first of equals) is inserted without a branch;
// only when another of the step's centers also beats the new third best
// (rare once the scan is under way) are the others inserted, in index
// order. Inserting the least first keeps the order (d2, index): a center
// before it in the step is strictly farther, one after it no nearer.
// (p2 + c2) - 2 dot is one fma of the exact 2 dot: the unfused result
// unless 2 dot overflows.
__device__ __forceinline__ void scan_tile(const float4* sc, int cnt, int t0,
                                          int sub, int lanes, float px,
                                          float py, float pz, float p2,
                                          Best3& best) {
  for (int g = sub; g < cnt; g += kGroup * lanes) {
    float d[kGroup];
#pragma unroll
    for (int u = 0; u < kGroup; ++u) {
      const float4 ctr = sc[g + u * lanes];
      const float dot = lion::dot3(px, py, pz, ctr.x, ctr.y, ctr.z);
      d[u] = fmaxf(__fmaf_rn(-2.0f, dot, __fadd_rn(p2, ctr.w)), 0.0f);
    }
    float least = d[0];
    int at = 0;
#pragma unroll
    for (int u = 1; u < kGroup; ++u) {
      at = d[u] < least ? u : at;
      least = fminf(least, d[u]);
    }
    insert_one(best, least, t0 + g + at * lanes);
    bool more = false;
#pragma unroll
    for (int u = 0; u < kGroup; ++u) more |= u != at && d[u] < best.d2;
    if (more) {
#pragma unroll
      for (int u = 0; u < kGroup; ++u) {
        if (u != at) insert_one(best, d[u], t0 + g + u * lanes);
      }
    }
  }
}

// Stage centers [t0, t0 + cnt) as (x, y, z, |c|^2) and pad them to whole
// steps of the lanes with centers no point takes (d2 = inf).
__device__ __forceinline__ void stage(const float* cb, int t0, int cnt,
                                      int step, float4* sc) {
  const int padded = (cnt + step - 1) / step * step;
  for (int j = threadIdx.x; j < padded; j += blockDim.x) {
    float4 v = make_float4(0.0f, 0.0f, 0.0f, INFINITY);
    if (j < cnt) {
      const float x = cb[3 * (t0 + j)];
      const float y = cb[3 * (t0 + j) + 1];
      const float z = cb[3 * (t0 + j) + 2];
      v = make_float4(x, y, z, lion::dot3(x, y, z, x, y, z));
    }
    sc[j] = v;
  }
}

// The lanes of a point merge their triples (a butterfly: every lane ends
// with the same three).
__device__ __forceinline__ void merge_lanes(Best3& best, int lanes) {
  for (int o = 1; o < lanes; o <<= 1) {
    const float e0 = __shfl_xor_sync(0xffffffffu, best.d0, o);
    const float e1 = __shfl_xor_sync(0xffffffffu, best.d1, o);
    const float e2 = __shfl_xor_sync(0xffffffffu, best.d2, o);
    const int j0 = __shfl_xor_sync(0xffffffffu, best.i0, o);
    const int j1 = __shfl_xor_sync(0xffffffffu, best.i1, o);
    const int j2 = __shfl_xor_sync(0xffffffffu, best.i2, o);
    insert_lex(best, e0, j0);
    insert_lex(best, e1, j1);
    insert_lex(best, e2, j2);
  }
}

// A warp's Q = 32 / L points from point q0 (of N) of item b: the weights,
// the optional (idx, w), then their rows of the output, written by the
// warp alone. sidx / sw are the warp's Q slots.
template <typename T>
__device__ __forceinline__ void write_points(
    const Best3& best, int q0, int n, int m, int c, int b, int log2_lanes,
    const T* __restrict__ feats, T* __restrict__ out, int* __restrict__ idx_out,
    float* __restrict__ w_out, int4* sidx, float4* sw) {
  const int lane = threadIdx.x & 31, sub = lane & ((1 << log2_lanes) - 1);
  const int local = lane >> log2_lanes, i = q0 + local;
  if (sub == 0) {
    const float d0 = fminf(fmaxf(best.d0, 1e-10f), 1e10f);
    const float d1 = fminf(fmaxf(best.d1, 1e-10f), 1e10f);
    const float d2 = fminf(fmaxf(best.d2, 1e-10f), 1e10f);
    const float d0d1 = __fmul_rn(d0, d1);
    const float d0d2 = __fmul_rn(d0, d2);
    const float d1d2 = __fmul_rn(d1, d2);
    const float inv =
        __fdiv_rn(1.0f, __fadd_rn(__fadd_rn(d0d1, d0d2), d1d2));
    const float4 w = make_float4(lion::round_to<T>(__fmul_rn(d1d2, inv)),
                                 lion::round_to<T>(__fmul_rn(d0d2, inv)),
                                 lion::round_to<T>(__fmul_rn(d0d1, inv)),
                                 0.0f);
    sidx[local] = make_int4(best.i0, best.i1, best.i2, 0);
    sw[local] = w;
    if (idx_out != nullptr && i < n) {
      const size_t o = (static_cast<size_t>(b) * n + i) * 3;
      idx_out[o] = best.i0;
      idx_out[o + 1] = best.i1;
      idx_out[o + 2] = best.i2;
      w_out[o] = w.x;
      w_out[o + 1] = w.y;
      w_out[o + 2] = w.z;
    }
  }
  __syncwarp();
  const int rows = min(32 >> log2_lanes, n - q0);
  const T* fb = feats + static_cast<size_t>(b) * m * c;
  T* ob = out + (static_cast<size_t>(b) * n + q0) * c;
  using V = typename Chunk<T>::type;
  constexpr int kPer = 16 / sizeof(T);         // channels a chunk
  if (c % kPer == 0) {
    // lane l takes chunks e = l, l + 32, ... of the rows x cv grid; (r, ch)
    // follows e by steps of (dr, dk) with one carry, no divide
    const int cv = c / kPer;
    const int total = rows * cv;
    const int dr = 32 / cv, dk = 32 - dr * cv;
    int r = lane / cv, ch = lane - r * cv;
    const V* fv = reinterpret_cast<const V*>(fb);
    V* ov = reinterpret_cast<V*>(ob);
    for (int e = lane; e < total; e += kUnroll * 32) {
      V f0[kUnroll], f1[kUnroll], f2[kUnroll];
      float4 w[kUnroll];
      int at[kUnroll];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        at[u] = -1;
        if (e + u * 32 < total) {
          const int4 ix = sidx[r];
          w[u] = sw[r];
          f0[u] = __ldg(fv + static_cast<size_t>(ix.x) * cv + ch);
          f1[u] = __ldg(fv + static_cast<size_t>(ix.y) * cv + ch);
          f2[u] = __ldg(fv + static_cast<size_t>(ix.z) * cv + ch);
          at[u] = r * cv + ch;
        }
        r += dr;
        ch += dk;
        if (ch >= cv) {
          ch -= cv;
          ++r;
        }
      }
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        if (at[u] >= 0) ov[at[u]] = blend(f0[u], f1[u], f2[u], w[u]);
      }
    }
  } else {
    // any C, rows at any alignment: lanes over a row's channels
    for (int r = 0; r < rows; ++r) {
      const int4 ix = sidx[r];
      const float4 w = sw[r];
      const T* r0 = fb + static_cast<size_t>(ix.x) * c;
      const T* r1 = fb + static_cast<size_t>(ix.y) * c;
      const T* r2 = fb + static_cast<size_t>(ix.z) * c;
      T* o = ob + static_cast<size_t>(r) * c;
      for (int ch = lane; ch < c; ch += 32) {
        lion::store(o + ch, mix(lion::to_float(r0[ch]),
                                lion::to_float(r1[ch]),
                                lion::to_float(r2[ch]), w));
      }
    }
  }
}

// grid (ceil(N / P), B), blockDim.x threads, P = threads / L points a
// block, Q = 32 / L points a warp (lanes q L .. q L + L - 1 serving point
// q). With M <= kTile the block stages the centers once and every warp then
// runs on its own (scan, merge, write); with more centers the block stages
// them tile by tile.
template <typename T>
__global__ void __launch_bounds__(kMaxThreads)
three_nn_kernel(const float* __restrict__ points,
                const float* __restrict__ centers,
                const T* __restrict__ feats, int n, int m, int c,
                int log2_lanes, T* __restrict__ out,
                int* __restrict__ idx_out, float* __restrict__ w_out) {
  __shared__ float4 sc[kTile + kGroup * kMaxLanes];
  __shared__ int4 sidx[kMaxThreads];           // a warp's Q slots each
  __shared__ float4 sw[kMaxThreads];

  const int lanes = 1 << log2_lanes, q_warp = 32 >> log2_lanes;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int sub = lane & (lanes - 1);
  const int b = blockIdx.y;
  const int q0 = (blockIdx.x * (blockDim.x >> 5) + warp) * q_warp;
  const float* cb = centers + static_cast<size_t>(b) * m * 3;

  if (m <= kTile) {                // the centers once
    stage(cb, 0, m, kGroup * lanes, sc);
    __syncthreads();
    if (q0 >= n) return;           // warp-uniform; no barrier follows
  }
  const int i = q0 + (lane >> log2_lanes);
  float px = 0.0f, py = 0.0f, pz = 0.0f;
  if (i < n) {
    const float* p = points + (static_cast<size_t>(b) * n + i) * 3;
    px = p[0];
    py = p[1];
    pz = p[2];
  }
  const float p2 = lion::dot3(px, py, pz, px, py, pz);
  Best3 best{INFINITY, INFINITY, INFINITY, 0, 0, 0};
  if (m <= kTile) {
    scan_tile(sc, m, 0, sub, lanes, px, py, pz, p2, best);
  } else {                         // every warp takes part in the staging
    for (int t0 = 0; t0 < m; t0 += kTile) {
      const int cnt = min(kTile, m - t0);
      __syncthreads();
      stage(cb, t0, cnt, kGroup * lanes, sc);
      __syncthreads();
      scan_tile(sc, cnt, t0, sub, lanes, px, py, pz, p2, best);
    }
  }
  merge_lanes(best, lanes);
  if (q0 < n) {
    write_points(best, q0, n, m, c, b, log2_lanes, feats, out, idx_out,
                w_out, sidx + warp * q_warp, sw + warp * q_warp);
  }
}

// A plan is valid if its threads are whole warps, at most kMaxThreads, and
// its lanes a power of two up to a warp.
int log2_of_plan(int threads, int lanes) {
  if (threads < 32 || threads > kMaxThreads || threads % 32 != 0 ||
      lanes < 1 || lanes > kMaxLanes || (lanes & (lanes - 1)) != 0)
    return -1;
  int l = 0;
  while ((1 << l) < lanes) ++l;
  return l;
}

}  // namespace

// points (B, N, 3), centers (B, M, 3) f32, feats (B, M, C) f32 or bf16
// (bf16 != 0) -> out (B, N, C) of the features' dtype, and, unless null,
// idx (B, N, 3) int32 and w (B, N, 3) f32. (threads, lanes) is the plan
// (ops/interpolate.py: three_nn_plan): blocks of `threads` threads,
// `lanes` of them a point; every pointer 16-byte aligned.
LION_EXPORT int lion_three_nn_interpolate(const void* points,
                                          const void* centers,
                                          const void* feats, void* out,
                                          void* idx, void* w, int b, int n,
                                          int m, int c, int bf16, int threads,
                                          int lanes, void* stream) {
  const int log2_lanes = log2_of_plan(threads, lanes);
  if (log2_lanes < 0 || m < 1) return static_cast<int>(cudaErrorInvalidValue);
  if (b == 0 || n == 0) return static_cast<int>(cudaSuccess);
  const dim3 grid(lion::ceil_div(n, threads / lanes), b);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* p = static_cast<const float*>(points);
  const float* ctr = static_cast<const float*>(centers);
  if (bf16) {
    three_nn_kernel<lion::bf16><<<grid, threads, 0, s>>>(
        p, ctr, static_cast<const lion::bf16*>(feats), n, m, c, log2_lanes,
        static_cast<lion::bf16*>(out), static_cast<int*>(idx),
        static_cast<float*>(w));
  } else {
    three_nn_kernel<float><<<grid, threads, 0, s>>>(
        p, ctr, static_cast<const float*>(feats), n, m, c, log2_lanes,
        static_cast<float*>(out), static_cast<int*>(idx),
        static_cast<float*>(w));
  }
  return static_cast<int>(cudaGetLastError());
}

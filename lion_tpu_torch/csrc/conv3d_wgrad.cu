// K10's weight gradient: dw[a, ci, co] = sum over the items b and the output
// voxels p of x[b, p + a - 1, ci] * g[b, p, co], a = (kd, kh, kw) over the
// 3x3x3 taps of the SAME-padded grid (x is 0 outside it), in fp32 or bf16.
//
// Replaces no TPU kernel: the JAX package's VJP of conv3d_3x3_same leaves dw
// to XLA (lion_tpu/ops/pallas/conv3d.py:594-600, lax.conv_general_dilated).
// It was added so that the training steps' largest device share runs on a
// kernel of this repository, in full float32 and in a fixed order: exact
// FFMA with float32 sums (no TF32), bf16 x and g widened in registers (the
// same products as float32 copies), and no float atomics, so dw repeats bit
// for bit from call to call and from stream to stream.
//
// Bound on the H100: operations. A GEMM of M = 27 Ci, N = Co over K = B R^3
// voxels, 2 * 27 * Ci * Co * B * R^3 FLOPs (as many as one K10 pass) at
// 67 TFLOP/s: at B32 r32 C64->64 232 GFLOP, 3.46 ms.
//
// Design. The long K is split into slabs: a fixed partition of the (item,
// brick) pairs, item-major, into equal runs that depends on the shape alone
// (ops/conv3d.py: wgrad_plan). A block owns one slab and one tile of KC
// input by BN output channels (grid: tiles, slabs) and walks the slab's
// bricks of 4 x 4 x 8 voxels: the brick's x with its one-voxel halo (KC
// channels) and its g (BN channels) land in shared memory by 16-byte
// cp.async copies (zeros outside the grid and past Ci / Co), double-buffered
// behind the previous brick's products. A thread owns one input channel by
// 4 output channels for all 27 taps (108 accumulators) and walks runs of 8
// voxels along w: per voxel it loads the 9 (kd, kh) rows' next x cell (the
// kw taps slide along the run, as K10's fp32 tile does) and one 4-channel
// piece of g, for 108 FFMAs. The lanes of a warp share a voxel: the x loads
// are KC consecutive floats, the g loads broadcast. Where KC * BN / 4 is
// under 256, the block's warps split the brick's runs into streams whose
// sums merge in stream order through shared memory. Each block writes its
// partial of its slab to a scratch (slabs, 27, Ci, Co) that the wrapper
// allocates; a second kernel sums the slabs in a fixed order and rounds once
// to dw's dtype.
#include "conv_brick.cuh"

namespace {

using lion::bf16;

// The brick (ops/conv3d.py: WGRAD_BRICK), its halo and its runs along w.
constexpr int kBd = 4, kBh = 4, kBw = 8;
constexpr int kHh = kBh + 2, kHw = kBw + 2;
constexpr int kCells = (kBd + 2) * kHh * kHw;
constexpr int kVox = kBd * kBh * kBw;
constexpr int kRuns = kBd * kBh;
constexpr int kTaps = 27;
constexpr int kThreads = 256;
// the sum kernel: 32 elements a block, each summed by kGroups warps over
// every kGroups-th slab, then the groups in order
constexpr int kGroups = kThreads / 32;

struct Wgrad {
  const void* x;   // (B, r, r, r, ci)
  const void* g;   // (B, r, r, r, co)
  float* part;     // (slabs, 27, ci, co): each slab's partial
  int r, ci, co;
  int nbh, nbw, bricks;  // bricks along h and w, and per item
  int pairs, per_slab;   // (item, brick) pairs in all and per slab
  int nci;               // input-channel tiles (the grid's x: nci * nco)
};

__device__ __forceinline__ float ld1(const float* p) { return *p; }
__device__ __forceinline__ float ld1(const bf16* p) {
  return __bfloat162float(*p);
}
__device__ __forceinline__ float4 ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}
__device__ __forceinline__ float4 ld4(const bf16* p) {
  const uint2 u = *reinterpret_cast<const uint2*>(p);
  return make_float4(__uint_as_float(u.x << 16),
                     __uint_as_float(u.x & 0xffff0000u),
                     __uint_as_float(u.y << 16),
                     __uint_as_float(u.y & 0xffff0000u));
}

// Stage (item, brick) pair q: x's halo cells, channels [c0, c0 + KC), as
// rows of KC into xs, and g's voxels, channels [n0, n0 + BN), as rows of BN
// into gs; 16-byte cp.async pieces where the rows allow, elements otherwise.
template <int KC, int BN, typename T>
__device__ void stage(const Wgrad& p, int q, int c0, int n0, T* xs, T* gs) {
  constexpr int V = 16 / sizeof(T);
  const int b = q / p.bricks, bx = q % p.bricks;
  const int d0 = bx / (p.nbh * p.nbw) * kBd;
  const int h0 = bx / p.nbw % p.nbh * kBh;
  const int w0 = bx % p.nbw * kBw;
  const size_t r3 = static_cast<size_t>(p.r) * p.r * p.r;
  const T* x = static_cast<const T*>(p.x) + b * r3 * p.ci + c0;
  const T* g = static_cast<const T*>(p.g) + b * r3 * p.co + n0;
  // the grid voxel of halo cell i (origin one voxel before the brick's) or
  // of brick voxel i (halo 0), -1 outside the grid
  auto voxel = [&](int i, int halo) {
    const int wd = kBw + 2 * halo, hd = kBh + 2 * halo;
    const int gw = w0 - halo + i % wd;
    const int gh = h0 - halo + i / wd % hd;
    const int gd = d0 - halo + i / (wd * hd);
    const unsigned r = p.r;
    return static_cast<unsigned>(gd) < r && static_cast<unsigned>(gh) < r &&
                   static_cast<unsigned>(gw) < r
               ? (gd * p.r + gh) * p.r + gw
               : -1;
  };
  // n rows of `width` channels from src (rows of ld, `avail` channels left
  // from the tile's first) into dst
  auto rows = [&](const T* src, int ld, int avail, int width, int n,
                  int halo, T* dst) {
    if (width % V == 0 && ld % V == 0) {
      const int per = width / V;
      for (int e = threadIdx.x; e < n * per; e += kThreads) {
        const int i = e / per, c = e % per * V;
        const int vox = voxel(i, halo);
        const bool in = vox >= 0 && c < avail;
        lion::cp_async16(dst + i * width + c,
                         in ? src + static_cast<size_t>(vox) * ld + c : src,
                         in);
      }
    } else {
      for (int e = threadIdx.x; e < n * width; e += kThreads) {
        const int i = e / width, c = e % width;
        const int vox = voxel(i, halo);
        lion::store(dst + e, vox >= 0 && c < avail
                                 ? lion::to_float(
                                       src[static_cast<size_t>(vox) * ld + c])
                                 : 0.0f);
      }
    }
  };
  rows(x, p.ci, p.ci - c0, KC, kCells, 1, xs);
  rows(g, p.co, p.co - n0, BN, kVox, 0, gs);
}

// The products of one run of kBw voxels along w: xr is the run's first halo
// cell (tap (0, 0, 0) of its first voxel) at this thread's channel, gr its
// first voxel's g at this thread's 4 output channels.
template <int KC, int BN, typename T>
__device__ __forceinline__ void run_products(const T* xr, const T* gr,
                                             float (&acc)[kTaps][4]) {
  float win[9][3];  // the (kd, kh) rows' x cells of the kw taps
#pragma unroll
  for (int t = 0; t < 9; ++t) {
    const T* row = xr + ((t / 3) * kHh + t % 3) * kHw * KC;
    win[t][0] = ld1(row);
    win[t][1] = ld1(row + KC);
  }
#pragma unroll
  for (int w = 0; w < kBw; ++w) {
#pragma unroll
    for (int t = 0; t < 9; ++t)
      win[t][(w + 2) % 3] =
          ld1(xr + (((t / 3) * kHh + t % 3) * kHw + w + 2) * KC);
    const float4 gv = ld4(gr + w * BN);
#pragma unroll
    for (int t = 0; t < 9; ++t) {
#pragma unroll
      for (int kw = 0; kw < 3; ++kw) {
        const float a = win[t][(w + kw) % 3];
        float* o = acc[3 * t + kw];
        o[0] = fmaf(a, gv.x, o[0]);
        o[1] = fmaf(a, gv.y, o[1]);
        o[2] = fmaf(a, gv.z, o[2]);
        o[3] = fmaf(a, gv.w, o[3]);
      }
    }
  }
}

// Grid (nci * nco channel tiles, slabs), 256 threads: thread (channel cl,
// output quad q, stream v). One register set per SM (108 accumulators).
template <int KC, int BN, typename T>
__global__ void __launch_bounds__(kThreads, 1)
k10_wgrad_tile(const Wgrad p) {
  constexpr int kQ = BN / 4;
  constexpr int kLanes = KC * kQ;  // threads of one stream
  constexpr int kStreams = kThreads / kLanes;
  static_assert(kLanes % 32 == 0 && kThreads % kLanes == 0, "whole warps");
  constexpr int kXs = kCells * KC, kGs = kVox * BN;
  extern __shared__ __align__(128) unsigned char smem[];
  T* const xs = reinterpret_cast<T*>(smem);
  T* const gs = xs + 2 * kXs;
  const int cl = threadIdx.x % KC;
  const int q = threadIdx.x / KC % kQ;
  const int v = threadIdx.x / kLanes;
  const int c0 = blockIdx.x % p.nci * KC, n0 = blockIdx.x / p.nci * BN;
  const int first = blockIdx.y * p.per_slab;
  const int count = min(p.per_slab, p.pairs - first);

  float acc[kTaps][4];
#pragma unroll
  for (int t = 0; t < kTaps; ++t)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[t][e] = 0.0f;

  stage<KC, BN>(p, first, c0, n0, xs, gs);
  lion::cp_async_commit();
  for (int i = 0; i < count; ++i) {
    lion::cp_async_wait_all();
    __syncthreads();  // brick i landed; brick i - 1's products are done
    if (i + 1 < count)
      stage<KC, BN>(p, first + i + 1, c0, n0, xs + ((i + 1) & 1) * kXs,
                    gs + ((i + 1) & 1) * kGs);
    lion::cp_async_commit();
    const T* xb = xs + (i & 1) * kXs + cl;
    const T* gb = gs + (i & 1) * kGs + 4 * q;
#pragma unroll 1
    for (int run = v; run < kRuns; run += kStreams)
      run_products<KC, BN>(xb + (run / kBh * kHh + run % kBh) * kHw * KC,
                           gb + run * kBw * BN, acc);
  }

  if constexpr (kStreams > 1) {
    // the streams' sums in stream order, through the staging buffers
    lion::cp_async_wait_all();
    __syncthreads();
    float* red = reinterpret_cast<float*>(smem) + threadIdx.x % kLanes;
    if (v > 0) {
#pragma unroll
      for (int k = 0; k < 4 * kTaps; ++k)
        red[((v - 1) * 4 * kTaps + k) * kLanes] = acc[k / 4][k % 4];
    }
    __syncthreads();
    if (v > 0) return;
    for (int s = 1; s < kStreams; ++s) {
#pragma unroll
      for (int k = 0; k < 4 * kTaps; ++k)
        acc[k / 4][k % 4] += red[((s - 1) * 4 * kTaps + k) * kLanes];
    }
  }

  const int c = c0 + cl, n = n0 + 4 * q;
  if (c >= p.ci || n >= p.co) return;
  const size_t tap = static_cast<size_t>(p.ci) * p.co;
  float* dst = p.part + (blockIdx.y * kTaps) * tap +
               static_cast<size_t>(c) * p.co + n;
#pragma unroll
  for (int t = 0; t < kTaps; ++t) {
    float* o = dst + t * tap;
    if (p.co % 4 == 0) {
      *reinterpret_cast<float4*>(o) =
          make_float4(acc[t][0], acc[t][1], acc[t][2], acc[t][3]);
    } else {
#pragma unroll
      for (int e = 0; e < 4; ++e)
        if (n + e < p.co) o[e] = acc[t][e];
    }
  }
}

// dw[e] = the slabs' partials summed in a fixed order, rounded once to T:
// warp j sums slabs j, j + kGroups, ... in order, then warp 0 sums the
// warps' sums in warp order. Grid: ceil(n / 32), 256 threads.
template <typename T>
__global__ void __launch_bounds__(kThreads)
k10_wgrad_sum(const float* __restrict__ part, int slabs, int n,
              T* __restrict__ dw) {
  __shared__ float sums[kGroups][32];
  const int lane = threadIdx.x % 32, j = threadIdx.x / 32;
  const int e = blockIdx.x * 32 + lane;
  float v = 0.0f;
  if (e < n) {
#pragma unroll 4
    for (int s = j; s < slabs; s += kGroups)
      v += __ldcg(part + static_cast<size_t>(s) * n + e);
  }
  sums[j][lane] = v;
  __syncthreads();
  if (j > 0 || e >= n) return;
  float t = sums[0][lane];
#pragma unroll
  for (int k = 1; k < kGroups; ++k) t += sums[k][lane];
  lion::store(dw + e, t);
}

// go(Int<KC>, Int<BN>) for the plan's tile (ops/conv3d.py: _WGRAD_TILES).
template <class Go>
int dispatch_tile(int kc, int bn, Go&& go) {
  using lion::Int;
  switch (kc * 1024 + bn) {
    case 16 * 1024 + 64: return go(Int<16>{}, Int<64>{});
    case 32 * 1024 + 32: return go(Int<32>{}, Int<32>{});
    case 8 * 1024 + 32: return go(Int<8>{}, Int<32>{});
    case 4 * 1024 + 32: return go(Int<4>{}, Int<32>{});
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

template <typename T>
int launch_wgrad(const Wgrad& p, int kc, int bn, int slabs, int smem,
                 T* dw, cudaStream_t s) {
  const int tiles = p.nci * lion::ceil_div(p.co, bn);
  const int err = dispatch_tile(kc, bn, [&](auto k, auto n) {
    constexpr int KC = decltype(k)::value, BN = decltype(n)::value;
    return lion::launch_smem(k10_wgrad_tile<KC, BN, T>, dim3(tiles, slabs),
                             kThreads, smem, s, p);
  });
  if (err != 0) return err;
  const int total = kTaps * p.ci * p.co;
  k10_wgrad_sum<T><<<lion::ceil_div(total, 32), kThreads, 0, s>>>(
      p.part, slabs, total, dw);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// x (B, r, r, r, ci), g (B, r, r, r, co) of one dtype (fp32, or bf16 when
// is_bf16) -> dw (27, ci, co) of that dtype; part (slabs, 27, ci, co) f32
// scratch, every element written. The rest is the plan (ops/conv3d.py:
// wgrad_plan): the channel tile (kc, bn), the slabs and their (item, brick)
// pairs, the dynamic shared memory.
LION_EXPORT int lion_conv3d_wgrad(const void* x, const void* g, void* part,
                                  void* dw, int b, int r, int ci, int co,
                                  int is_bf16, int kc, int bn, int slabs,
                                  int per_slab, int smem, void* stream) {
  const int nbd = lion::ceil_div(r, kBd), nbh = lion::ceil_div(r, kBh),
            nbw = lion::ceil_div(r, kBw);
  const Wgrad p{x,   g,   static_cast<float*>(part),
                r,   ci,  co,
                nbh, nbw, nbd * nbh * nbw,
                b * nbd * nbh * nbw, per_slab, lion::ceil_div(ci, kc)};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return is_bf16 ? launch_wgrad(p, kc, bn, slabs, smem, static_cast<bf16*>(dw),
                                s)
                 : launch_wgrad(p, kc, bn, slabs, smem,
                                static_cast<float*>(dw), s);
}

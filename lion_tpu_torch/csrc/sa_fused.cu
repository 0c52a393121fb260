// K7: fused PointNet++ set abstraction, bf16 (the sampling path's SA
// blocks).
//
// Replaces lion_tpu/ops/pallas/sa_fused.py: pointnet_sa_fused_pallas
// (_sa_kernel).
//
// Semantics (ops/sa_fused.py has the plain version):
//   ball query: the first K points with d2 < r^2 in index order (d2 summed
//   as in common.cuh sq_dist); slots past the hit count copy slot 0, an empty
//   ball takes point 0; hits are counted in integers (the TPU kernel counts
//   in bf16, sa_fused.py:156). z1[m, j] = bf16(A[p(m, j)] + bc[m]).
//   Per layer: GroupNorm(8) statistics per (item, group) over all M*K slots
//   (miss slots included) and the group's channels, of the rounded z, with
//   the centered variance and eps 1e-5; h = bf16(swish(z * sc + sh)) with
//   sc = rs * ca, sh = cb - mu * sc; the next z = bf16(h @ W + b), float32
//   sums. Output: the max of the last h over the K slots, (B, M, C_L) bf16.
//
// Bound on the H100: the ball query's distance tests and the dense layers
// (2 * C_in * C_out flops per slot) on the tensor cores; the function reads
// the cloud, A and bc once and writes (B, M, C_L).
// Design: an index-and-recompute walk. No grouped (B, M, K, C) tensor
// exists anywhere: the statistics span the whole item, so every layer takes
// one pass over the item's slot rows, and each pass recomputes the rows
// from the stored ball-query indices. One C entry makes L + 1 launches of
// one kernel on one stream (after a memset of B ints), with no PyTorch op
// between them:
//   pass 1: ball query (the item's cloud staged in shared memory when it
//     fits) -> the (B, M, K) int32 slot indices; z1 -> layer 1's statistics.
//   pass l = 2..L: z1 from the indices -> [normalize, swish, dense] through
//     layers 1..l-1 -> layer l's statistics.
//   pass L + 1: the same through layer L -> normalize, swish, max over K.
// Blocks of 256 threads walk tiles of tm centers (128 slot rows, or 64
// where the layers are wide; two bf16 row buffers in shared memory) of one
// item, tile = blockIdx.x, + gridDim.x, ...; each kind of pass (query,
// statistics, max) is compiled on its own, the query pass with four blocks
// an SM, the others with two. A tile's layer-1 rows are in flight while
// the previous tile is computed. The dense layers run on mma.sync m16n8k16
// (bf16, float32 sums) with the epilogue in registers; a layer that the
// pass normalizes is normalized where its rows are formed (the gather or
// the epilogue); the weights stay in shared memory for the whole pass when
// they fit in 24 KB.
// Statistics: a thread sums d = z - shift and d * d in float32 over its
// rows of the block's tiles, the shift being the block's first row (so d is
// of the order of the spread and the centered M2 needs no second pass); the
// block folds its threads' sums in a fixed order in float64 into one
// partial (count, mean, centered M2); the item's last block to finish (an
// integer ticket) merges the G partials by Chan's rule in a fixed tree
// (strided slices of blocks, then the slices in order), folds GroupNorm and
// (ca, cb) into (sc, sh) for the next pass, and resets the ticket. No
// float atomics: the result is bit-reproducible.
//
// Invariant: every pass forms a layer's rows with the same device functions
// (Gather, dense, and the normalize they apply), in the same order of
// operations, from the same indices: a layer's z is rounded to bf16 before
// anything reads it, so the rows whose statistics pass l takes are
// bit-identical to the rows that pass l + 1 normalizes.
#include <cmath>

#include "common.cuh"

namespace {

using lion::bf16;

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxC = 256;
static_assert(kMaxC <= kThreads, "a thread per channel in the merges");
constexpr int kMaxLayers = 32;
constexpr int kChunk = 64;            // output channels per weight stage
constexpr int kLdW = kChunk + 8;
constexpr int kRed = 2560;            // floats of the statistics' reduction
constexpr int kResident = 24576;      // weight bytes kept for a whole pass
// dynamic shared memory a block may take (the H100's 227 KB less 1 KB of
// static shared memory)
constexpr int kSmemDyn = 232448 - 1024;

struct Layers {
  const bf16* w[kMaxLayers];      // dense l -> l + 1: (C_l, C_{l+1}) bf16
  const float* bias[kMaxLayers];  // (C_{l+1},) f32
  int width[kMaxLayers];          // C_1 .. C_L
  int coff[kMaxLayers];           // layer l's channels in sc / sh
  int woff[kMaxLayers];           // dense l's stages in the resident weights
};

struct Pass {
  const float* points;   // (B, N, 3)
  const float* centers;  // (B, M, 3)
  const float* a;        // (B, N, C_1)
  const float* bc;       // (B, M, C_1)
  const float* ca;       // (B, C_t): the statistics pass's affine
  const float* cb;
  int* idx;              // (B, M, K) slot indices
  double* part;          // (B, G, 2, C_t): per-block mean and M2
  float* sc;             // (B, csum); sh follows at + B * csum
  int* tickets;          // (B,)
  bf16* out;             // (B, M, C_L)
  int n, m, k, tm, tiles, csum, ld;
  int target;            // the layer whose rows the pass forms (1-based)
  int kshift;            // log2(K)
  int staged, resident;
  float r2;
};

// swish with the fast exponential and division (a few ulp from the exact
// form; every pass evaluates this same function)
__device__ __forceinline__ float swishf(float v) {
  return __fdividef(v, 1.0f + __expf(-v));
}

__device__ __forceinline__ int pad16(int c) { return (c + 15) / 16 * 16; }

// Stages of 64 output channels of dense l.
__device__ __forceinline__ int chunks(int cout) {
  return (cout + kChunk - 1) / kChunk;
}

// Two centers' ball queries by one warp (the second may be absent:
// ctr1 == nullptr), 64 points a round (two ballots per center, so a
// round's loads and tests are in flight together), into sel0 / sel1 (K
// slots each, global memory); the cloud is read from shared memory (SoA)
// when staged, else from global memory (interleaved xyz).
template <bool kStaged>
__device__ void ball_query(const Pass& p, const float* __restrict__ pts,
                           const float* ctr0, const float* ctr1, int* sel0,
                           int* sel1) {
  const int lane = threadIdx.x & 31;
  const float* ctr[2] = {ctr0, ctr1 != nullptr ? ctr1 : ctr0};
  int* sel[2] = {sel0, sel1};
  float cx[2], cy[2], cz[2];
#pragma unroll
  for (int c = 0; c < 2; ++c) {
    cx[c] = ctr[c][0];
    cy[c] = ctr[c][1];
    cz[c] = ctr[c][2];
  }
  int count[2] = {0, ctr1 != nullptr ? 0 : p.k};  // identical in every lane
  for (int base = 0; base < p.n && (count[0] < p.k || count[1] < p.k);
       base += 64) {
    bool hit[2][2];
#pragma unroll
    for (int u = 0; u < 2; ++u) {
      const int j = base + 32 * u + lane;
      float px = 0.0f, py = 0.0f, pz = 0.0f;
      if (j < p.n) {
        px = kStaged ? pts[j] : __ldg(pts + 3 * j);
        py = kStaged ? pts[p.n + j] : __ldg(pts + 3 * j + 1);
        pz = kStaged ? pts[2 * p.n + j] : __ldg(pts + 3 * j + 2);
      }
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        hit[c][u] = j < p.n &&
                    lion::sq_dist(cx[c], cy[c], cz[c], px, py, pz) < p.r2;
      }
    }
#pragma unroll
    for (int c = 0; c < 2; ++c) {
#pragma unroll
      for (int u = 0; u < 2; ++u) {
        const unsigned mask = __ballot_sync(0xffffffffu, hit[c][u]);
        if (hit[c][u] && count[c] < p.k) {
          const int s = count[c] + __popc(mask & ((1u << lane) - 1u));
          if (s < p.k) sel[c][s] = base + 32 * u + lane;
        }
        count[c] += __popc(mask);
      }
    }
  }
  __syncwarp();
#pragma unroll
  for (int c = 0; c < 2; ++c) {
    if (c == 1 && ctr1 == nullptr) break;
    const int found = count[c] < p.k ? count[c] : p.k;
    const int first = found > 0 ? sel[c][0] : 0;
    __syncwarp();
    for (int s = found + lane; s < p.k; s += 32) sel[c][s] = first;
  }
  __syncwarp();
}

// Eight floats rounded to bf16 (16 bytes) and back.
__device__ __forceinline__ uint4 pack8(const float* f) {
  uint4 u;
  __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&u);
#pragma unroll
  for (int i = 0; i < 4; ++i) h[i] = __floats2bfloat162_rn(f[2 * i], f[2 * i + 1]);
  return u;
}

__device__ __forceinline__ void unpack8(const uint4& u, float* f) {
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 t = __bfloat1622float2(h[i]);
    f[2 * i] = t.x;
    f[2 * i + 1] = t.y;
  }
}

// Round z to bf16 and, when sc is given, normalize the rounded values:
// h = bf16(swish(z * sc + sh)). n values.
template <int n>
__device__ __forceinline__ void round_norm(float* v, const float* sc,
                                           const float* sh) {
#pragma unroll
  for (int i = 0; i < n; ++i) {
    v[i] = __bfloat162float(__float2bfloat16_rn(v[i]));
    if (sc != nullptr) v[i] = swishf(v[i] * sc[i] + sh[i]);
  }
}

// The gather of layer 1's rows, z1 = bf16(A[idx] + bc), normalized when
// sc is given. A thread keeps four channels (4j..4j+3) of the rows
// r0 + u * step of a tile; the first kPre of them are software-pipelined
// across the block's tiles: their rows of A and bc are loaded while the
// previous tile is computed, and their indices one tile earlier still.
// Rows past those (wide first layers) are gathered when they are stored.
constexpr int kPre = 4;

struct Gather {
  int q, step, j, r0, c1;
  bool active, live;
  int idx[kPre];                  // the indices of a coming tile's rows
  float4 a[kPre], bc[kPre];       // the rows of the tile to be formed

  __device__ void init(int width) {
    c1 = width;
    q = pad16(c1) / 4;
    step = kThreads / q;
    j = threadIdx.x % q;
    r0 = threadIdx.x / q;
    active = r0 < step;
    live = active && 4 * j < c1;
  }

  // The indices of tile's first kPre row slots (plain loads: pass 1 wrote
  // them in this kernel).
  __device__ void load_idx(const Pass& p, int b, int tile, int rows) {
    const int* gidx = p.idx + (static_cast<size_t>(b) * p.m + tile * p.tm) * p.k;
#pragma unroll
    for (int u = 0; u < kPre; ++u) {
      const int row = r0 + u * step;
      idx[u] = live && row < rows ? gidx[row] : 0;
    }
  }

  // Start the loads of tile's rows of A and bc for the indices held.
  __device__ void load_rows(const Pass& p, int b, int tile, int rows) {
    const float* ab = p.a + static_cast<size_t>(b) * p.n * c1 + 4 * j;
    const float* bcb =
        p.bc + (static_cast<size_t>(b) * p.m + tile * p.tm) * c1 + 4 * j;
#pragma unroll
    for (int u = 0; u < kPre; ++u) {
      const int row = r0 + u * step;
      if (live && row < rows) {
        a[u] = __ldg(reinterpret_cast<const float4*>(
            ab + static_cast<size_t>(idx[u]) * c1));
        bc[u] = __ldg(reinterpret_cast<const float4*>(
            bcb + (row >> p.kshift) * c1));
      }
    }
  }

  __device__ void put(const Pass& p, int row, float4 av, float4 bv,
                      const float* s4, const float* t4, bf16* buf) const {
    float v[4] = {0.0f, 0.0f, 0.0f, 0.0f};
    if (live) {
      v[0] = av.x + bv.x;
      v[1] = av.y + bv.y;
      v[2] = av.z + bv.z;
      v[3] = av.w + bv.w;
      round_norm<4>(v, s4, t4);
    }
    uint2 out;
    __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&out);
    h[0] = __floats2bfloat162_rn(v[0], v[1]);
    h[1] = __floats2bfloat162_rn(v[2], v[3]);
    *reinterpret_cast<uint2*>(buf + row * p.ld + 4 * j) = out;
  }

  // The tile's rows into buf (row stride ld); the columns up to pad16(C_1)
  // become 0.
  __device__ void store(const Pass& p, int b, int tile, int rows,
                        const float* sc, const float* sh, bf16* buf) {
    if (!active) return;
    float s4[4] = {0.0f, 0.0f, 0.0f, 0.0f}, t4[4] = {0.0f, 0.0f, 0.0f, 0.0f};
    if (live && sc != nullptr) {
      *reinterpret_cast<float4*>(s4) =
          *reinterpret_cast<const float4*>(sc + 4 * j);
      *reinterpret_cast<float4*>(t4) =
          *reinterpret_cast<const float4*>(sh + 4 * j);
    }
    const float* s = sc == nullptr ? nullptr : s4;
#pragma unroll
    for (int u = 0; u < kPre; ++u) {
      const int row = r0 + u * step;
      if (row < rows) put(p, row, a[u], bc[u], s, t4, buf);
    }
    const int* gidx = p.idx + (static_cast<size_t>(b) * p.m + tile * p.tm) * p.k;
    const float* ab = p.a + static_cast<size_t>(b) * p.n * c1 + 4 * j;
    const float* bcb =
        p.bc + (static_cast<size_t>(b) * p.m + tile * p.tm) * c1 + 4 * j;
    for (int row = r0 + kPre * step; row < rows; row += step) {
      float4 av = make_float4(0.0f, 0.0f, 0.0f, 0.0f), bv = av;
      if (live) {
        av = __ldg(reinterpret_cast<const float4*>(
            ab + static_cast<size_t>(gidx[row]) * c1));
        bv = __ldg(reinterpret_cast<const float4*>(
            bcb + (row >> p.kshift) * c1));
      }
      put(p, row, av, bv, s, t4, buf);
    }
  }
};

// One stage of dense l's weights (64 output channels from n0, all padded
// input rows) into wt, in 16-byte pieces (widths are multiples of 8).
__device__ void load_stage(const Layers& L, int l, int n0, bf16* wt) {
  const int cin = L.width[l], cout = L.width[l + 1], cinp = pad16(cin);
  for (int e = threadIdx.x; e < cinp * (kChunk / 8); e += kThreads) {
    const int kk = e / (kChunk / 8), nn = 8 * (e - kk * (kChunk / 8));
    uint4 v = make_uint4(0u, 0u, 0u, 0u);
    if (kk < cin && n0 + nn < cout) {
      v = __ldg(reinterpret_cast<const uint4*>(
          L.w[l] + static_cast<size_t>(kk) * cout + n0 + nn));
    }
    *reinterpret_cast<uint4*>(wt + kk * kLdW + nn) = v;
  }
}

// ldmatrix / mma.sync (PTX ISA 7.8; m16n8k16, bf16 in, f32 sums).
__device__ __forceinline__ void ldsm_x4(unsigned* r, const void* ptr) {
  const unsigned a = static_cast<unsigned>(__cvta_generic_to_shared(ptr));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(a));
}

__device__ __forceinline__ void ldsm_x4_trans(unsigned* r, const void* ptr) {
  const unsigned a = static_cast<unsigned>(__cvta_generic_to_shared(ptr));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(a));
}

__device__ __forceinline__ void mma16816(float* d, const unsigned* a,
                                         const unsigned* b) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// zout = bf16(h @ W_l + bias) for the tile's rows, normalized when sc is
// given; the columns up to pad16(C_{l+1}) become 0. Per 64-column weight
// stage (resident, or loaded stage by stage) a warp takes 16 rows and 64 or
// 32 columns (rows = 128 or 64): A from ldmatrix, B from ldmatrix.trans of
// the row-major stage, m16n8k16 products summed over k in order, and the
// epilogue on the accumulators in registers (a lane holds rows g and g + 8,
// columns 2q and 2q + 1 of each 8-column tile). Ends with a barrier.
__device__ void dense(const Pass& p, const Layers& L, int l, int rows,
                      const float* __restrict__ bias, const float* sc,
                      const float* sh, const bf16* __restrict__ h,
                      bf16* __restrict__ zout, bf16* __restrict__ wt) {
  const int cin = L.width[l], cout = L.width[l + 1];
  const int cinp = pad16(cin), coutp = pad16(cout), ld = p.ld;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int rtiles = rows / 16, nsplit = kWarps / rtiles;
  const int r0 = (warp % rtiles) * 16, ntn = 8 / nsplit;
  const int nt0 = (warp / rtiles) * ntn;   // this warp's first 8-col tile
  const int g = lane >> 2, tq = lane & 3;
  for (int n0 = 0; n0 < coutp; n0 += kChunk) {
    const bf16* stage = wt;
    if (p.resident) {
      stage = wt + L.woff[l] + (n0 / kChunk) * cinp * kLdW;
    } else {
      load_stage(L, l, n0, wt);
      __syncthreads();
    }
    float acc[8][4];
#pragma unroll
    for (int i = 0; i < 8; ++i) acc[i][0] = acc[i][1] = acc[i][2] = acc[i][3] = 0.0f;
    for (int kk = 0; kk < cinp; kk += 16) {
      unsigned a[4];
      ldsm_x4(a, h + (r0 + (lane & 15)) * ld + kk + (lane >> 4) * 8);
#pragma unroll
      for (int i = 0; i < 8; i += 2) {
        const int nt = nt0 + i;
        if (i < ntn && n0 + nt * 8 < cout) {
          unsigned bf[4];
          ldsm_x4_trans(bf, stage + (kk + (lane & 15)) * kLdW +
                                (nt + (lane >> 4)) * 8);
          mma16816(acc[i], a, bf);
          mma16816(acc[i + 1], a, bf + 2);
        }
      }
    }
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int c0 = n0 + (nt0 + i) * 8;
      if (i < ntn && c0 < coutp) {
        const int col = c0 + 2 * tq;
        float v[4] = {0.0f, 0.0f, 0.0f, 0.0f};
        if (c0 < cout) {
          const float2 bb = *reinterpret_cast<const float2*>(bias + col);
          v[0] = acc[i][0] + bb.x;
          v[1] = acc[i][1] + bb.y;
          v[2] = acc[i][2] + bb.x;
          v[3] = acc[i][3] + bb.y;
#pragma unroll
          for (int e = 0; e < 4; ++e) v[e] = __bfloat162float(__float2bfloat16_rn(v[e]));
          if (sc != nullptr) {
            const float2 s2 = *reinterpret_cast<const float2*>(sc + col);
            const float2 t2 = *reinterpret_cast<const float2*>(sh + col);
            v[0] = swishf(v[0] * s2.x + t2.x);
            v[1] = swishf(v[1] * s2.y + t2.y);
            v[2] = swishf(v[2] * s2.x + t2.x);
            v[3] = swishf(v[3] * s2.y + t2.y);
          }
        }
        *reinterpret_cast<__nv_bfloat162*>(zout + (r0 + g) * ld + col) =
            __floats2bfloat162_rn(v[0], v[1]);
        *reinterpret_cast<__nv_bfloat162*>(zout + (r0 + g + 8) * ld + col) =
            __floats2bfloat162_rn(v[2], v[3]);
      }
    }
    __syncthreads();
  }
}

// Chan's rule: fold (nb, mean_b, m2_b) into (n, mean, m2), float64.
__device__ __forceinline__ void chan(double& n, double& mean, double& m2,
                                     double nb, double mean_b, double m2_b) {
  if (nb == 0.0) return;
  const double nn = n + nb, d = mean_b - mean, w = nb / nn;
  mean += d * w;
  m2 += m2_b + d * d * n * w;
  n = nn;
}

// A thread's share of the statistics of a pass: four channels (4j..4j+3)
// of the rows r = sl (mod slices) of every tile the block walks, as sums
// of d = z - shift and d * d in float32, where the shift is the block's
// first row (so that d is of the order of the spread, not of the mean:
// the centered M2 follows without a second pass over the rows).
struct Stats {
  float shift[4], s1[4], s2[4];
  int n;
};

__device__ __forceinline__ void stats_map(int c, int& j, int& sl,
                                          int& slices) {
  const int q = c / 4;
  j = threadIdx.x % q;
  sl = threadIdx.x / q;
  slices = kThreads / q;
}

// The tile's rows of z (c channels) into the thread's sums.
__device__ void tile_stats(const bf16* __restrict__ z, int ld, int rows,
                           int c, bool first, Stats& st) {
  int j, sl, slices;
  stats_map(c, j, sl, slices);
  if (sl >= slices) return;
  if (first) {
    const uint2 u = *reinterpret_cast<const uint2*>(z + 4 * j);
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
    st.shift[0] = __low2float(h[0]);
    st.shift[1] = __high2float(h[0]);
    st.shift[2] = __low2float(h[1]);
    st.shift[3] = __high2float(h[1]);
  }
  for (int r = sl; r < rows; r += slices) {
    const uint2 u = *reinterpret_cast<const uint2*>(z + r * ld + 4 * j);
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
    const float v[4] = {__low2float(h[0]), __high2float(h[0]),
                        __low2float(h[1]), __high2float(h[1])};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float d = v[i] - st.shift[i];
      st.s1[i] += d;
      st.s2[i] += d * d;
    }
    ++st.n;
  }
}

// The block's partial (mean, M2) per channel from its threads' sums, folded
// over the slices in order in float64 (red: 2 * kThreads * 4 floats and
// kThreads ints of shared memory).
__device__ void block_stats(const Stats& st, int c, float* red, int* cnt,
                            double* mean_out, double* m2_out) {
  int j, sl, slices;
  stats_map(c, j, sl, slices);
  if (sl < slices) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      red[sl * c + 4 * j + i] = st.s1[i];
      red[kThreads * 4 + sl * c + 4 * j + i] = st.s2[i];
    }
    if (j == 0) cnt[sl] = st.n;
    if (sl == 0) {
#pragma unroll
      for (int i = 0; i < 4; ++i) red[kThreads * 8 + 4 * j + i] = st.shift[i];
    }
  }
  __syncthreads();
  for (int ch = threadIdx.x; ch < c; ch += kThreads) {
    double n = 0.0, s1 = 0.0, s2 = 0.0;
    for (int k = 0; k < slices; ++k) {
      n += cnt[k];
      s1 += red[k * c + ch];
      s2 += red[kThreads * 4 + k * c + ch];
    }
    const double d = s1 / n;
    mean_out[ch] = red[kThreads * 8 + ch] + d;
    m2_out[ch] = s2 - s1 * d;
  }
}

// The passes' kinds: each is compiled on its own, so that the ball query's
// pass keeps few registers and four blocks an SM, and the passes with dense
// layers keep their fragments in registers (two blocks an SM).
enum Kind { kQuery = 0, kStats = 1, kMax = 2 };
constexpr int kBlocksSm[3] = {4, 2, 2};

// Grid (G, B), kThreads threads. One pass of the walk (see the header).
template <int kKind>
__global__ void __launch_bounds__(kThreads, kBlocksSm[kKind])
sa_pass_kernel(const Pass p, const Layers L) {
  constexpr bool query = kKind == kQuery, is_max = kKind == kMax;
  extern __shared__ __align__(128) unsigned char smem[];
  __shared__ int s_last;
  const int rows = p.tm * p.k;
  const size_t buf_bytes = static_cast<size_t>(rows) * p.ld * 2;
  bf16* buf0 = reinterpret_cast<bf16*>(smem);
  float* scr = reinterpret_cast<float*>(smem + buf_bytes);  // kRed floats
  // the pass's sc, sh and biases of every layer (biases at the output
  // layer's offset)
  float* sc_s = scr + kRed;
  float* sh_s = sc_s + p.csum;
  float* bias_s = sh_s + p.csum;
  unsigned char* tail = reinterpret_cast<unsigned char*>(bias_s + p.csum);
  bf16* buf1 = reinterpret_cast<bf16*>(tail);
  bf16* wt = reinterpret_cast<bf16*>(tail + buf_bytes);
  float* xs = reinterpret_cast<float*>(tail);  // the staged cloud (pass 1)

  const int b = blockIdx.y, g = blockIdx.x, blocks = gridDim.x;
  const int warp = threadIdx.x >> 5;
  const int t = p.target - 1;          // 0-based layer
  const int c = L.width[t];
  if (query && p.staged) {
    const float* pts = p.points + static_cast<size_t>(b) * p.n * 3;
    for (int j = threadIdx.x; j < p.n; j += kThreads) {
      xs[j] = pts[3 * j];
      xs[p.n + j] = pts[3 * j + 1];
      xs[2 * p.n + j] = pts[3 * j + 2];
    }
  }
  for (int i = threadIdx.x; i < p.csum; i += kThreads) {
    sc_s[i] = p.sc[static_cast<size_t>(b) * p.csum + i];
    sh_s[i] = p.sc[(static_cast<size_t>(gridDim.y) + b) * p.csum + i];
  }
  for (int l = 0; l < t; ++l) {
    for (int i = threadIdx.x; i < L.width[l + 1]; i += kThreads)
      bias_s[L.coff[l + 1] + i] = L.bias[l][i];
    if (p.resident) {
      const int stage = pad16(L.width[l]) * kLdW;
      for (int ch = 0; ch < chunks(L.width[l + 1]); ++ch)
        load_stage(L, l, ch * kChunk, wt + L.woff[l] + ch * stage);
    }
  }
  __syncthreads();
  if (query) {  // every center of the block's tiles, a warp each
    const int centers = (p.tiles - g + blocks - 1) / blocks * p.tm;
    const float* pts =
        p.staged ? xs : p.points + static_cast<size_t>(b) * p.n * 3;
    // the indices are read back by this block's own threads (plain loads,
    // not the read-only path) after the barrier below
    auto center = [&](int cc) -> size_t {
      return static_cast<size_t>(b) * p.m + (g + cc / p.tm * blocks) * p.tm +
             cc % p.tm;
    };
    for (int cc = 2 * warp; cc < centers; cc += 2 * kWarps) {
      const size_t m0 = center(cc);
      const bool two = cc + 1 < centers;
      const size_t m1 = two ? center(cc + 1) : m0;
      const float* c1 = two ? p.centers + m1 * 3 : nullptr;
      if (p.staged) {
        ball_query<true>(p, pts, p.centers + m0 * 3, c1, p.idx + m0 * p.k,
                         p.idx + m1 * p.k);
      } else {
        ball_query<false>(p, pts, p.centers + m0 * 3, c1, p.idx + m0 * p.k,
                          p.idx + m1 * p.k);
      }
    }
    __syncthreads();
  }

  // layer l is normalized in this pass when the pass reads past it
  auto norm_sc = [&](int l) -> const float* {
    return (l < t || (is_max && l == t)) ? sc_s + L.coff[l] : nullptr;
  };
  Stats st{};
  Gather ga;
  ga.init(L.width[0]);
  if (ga.active && g < p.tiles) {
    ga.load_idx(p, b, g, rows);
    ga.load_rows(p, b, g, rows);
    if (g + blocks < p.tiles) ga.load_idx(p, b, g + blocks, rows);
  }
  const float* s0 = norm_sc(0);
  for (int tile = g; tile < p.tiles; tile += blocks) {
    const int m0 = tile * p.tm;
    bf16* x = buf0;
    bf16* y = buf1;
    ga.store(p, b, tile, rows, s0, s0 == nullptr ? nullptr : sh_s + L.coff[0],
             x);
    __syncthreads();
    // the next tile's rows (and the one after's indices) while this one is
    // computed
    if (ga.active && tile + blocks < p.tiles) {
      ga.load_rows(p, b, tile + blocks, rows);
      if (tile + 2 * blocks < p.tiles)
        ga.load_idx(p, b, tile + 2 * blocks, rows);
    }
    for (int l = 0; l < (query ? 0 : t); ++l) {
      const float* s1 = norm_sc(l + 1);
      dense(p, L, l, rows, bias_s + L.coff[l + 1], s1,
            s1 == nullptr ? nullptr : sh_s + L.coff[l + 1], x, y, wt);
      bf16* s = x;
      x = y;
      y = s;
    }
    if constexpr (is_max) {
      const int q = c / 8;
      for (int e = threadIdx.x; e < p.tm * q; e += kThreads) {
        const int mi = e / q, j = e - mi * q;
        const bf16* col = x + mi * p.k * p.ld + 8 * j;
        float best[8], f[8];
#pragma unroll
        for (int v = 0; v < 8; ++v) best[v] = -INFINITY;
#pragma unroll 4
        for (int r = 0; r < p.k; ++r) {
          unpack8(*reinterpret_cast<const uint4*>(col + r * p.ld), f);
#pragma unroll
          for (int v = 0; v < 8; ++v) best[v] = fmaxf(best[v], f[v]);
        }
        *reinterpret_cast<uint4*>(
            p.out + (static_cast<size_t>(b) * p.m + m0 + mi) * c + 8 * j) =
            pack8(best);
      }
    } else {
      tile_stats(x, p.ld, rows, c, tile == g, st);
    }
    __syncthreads();
  }
  if constexpr (is_max) return;

  // this block's partial, then the item's ticket
  double* part = p.part + static_cast<size_t>(b) * blocks * 2 * c;
  block_stats(st, c, scr, reinterpret_cast<int*>(scr + kThreads * 8 + kMaxC),
              part + static_cast<size_t>(g) * 2 * c,
              part + static_cast<size_t>(g) * 2 * c + c);
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0)
    s_last = atomicAdd(p.tickets + b, 1) == blocks - 1;
  __syncthreads();
  if (!s_last) return;
  __threadfence();

  // the last block: merge the G partials, fold GroupNorm(8) and (ca, cb)
  // into (sc, sh). Thread (channel, slice) merges the partials j = slice,
  // slice + slices, ... in order; then the slices merge in order: a fixed
  // tree, so the result does not depend on which block came last.
  double* mean_c = reinterpret_cast<double*>(smem);
  double* m2_c = mean_c + kMaxC;
  double* sl_n = m2_c + kMaxC;             // kThreads entries each
  double* sl_mean = sl_n + kThreads;
  double* sl_m2 = sl_mean + kThreads;
  const double rows_d = rows;
  {
    const int slices = kThreads / c;   // c <= kMaxC = kThreads
    const int ch = threadIdx.x % c, sl = threadIdx.x / c;
    if (sl < slices) {
      double n = 0.0, mean = 0.0, m2 = 0.0;
      for (int j = sl; j < blocks; j += slices) {
        const double nb = ((p.tiles - j + blocks - 1) / blocks) * rows_d;
        chan(n, mean, m2, nb,
             __ldcg(part + static_cast<size_t>(j) * 2 * c + ch),
             __ldcg(part + static_cast<size_t>(j) * 2 * c + c + ch));
      }
      sl_n[threadIdx.x] = n;
      sl_mean[threadIdx.x] = mean;
      sl_m2[threadIdx.x] = m2;
    }
    __syncthreads();
    if (threadIdx.x < c) {
      double n = 0.0, mean = 0.0, m2 = 0.0;
      for (int k = 0; k < slices; ++k) {
        const int i = k * c + threadIdx.x;
        chan(n, mean, m2, sl_n[i], sl_mean[i], sl_m2[i]);
      }
      mean_c[threadIdx.x] = mean;
      m2_c[threadIdx.x] = m2;
    }
  }
  __syncthreads();
  const double nc = static_cast<double>(p.m) * p.k;
  const int cg = c / 8;
  for (int ch = threadIdx.x; ch < c; ch += kThreads) {
    const int g0 = (ch / cg) * cg;
    double mg = 0.0;
    for (int j = 0; j < cg; ++j) mg += mean_c[g0 + j];
    mg /= cg;
    double m2g = 0.0;
    for (int j = 0; j < cg; ++j) {
      const double d = mean_c[g0 + j] - mg;
      m2g += m2_c[g0 + j] + nc * d * d;
    }
    const float rs = static_cast<float>(1.0 / sqrt(m2g / (nc * cg) + 1e-5));
    const float s = rs * p.ca[static_cast<size_t>(b) * c + ch];
    float* sc = p.sc + static_cast<size_t>(b) * p.csum + L.coff[t];
    sc[ch] = s;
    sc[static_cast<size_t>(gridDim.y) * p.csum + ch] =
        p.cb[static_cast<size_t>(b) * c + ch] - static_cast<float>(mg) * s;
  }
  if (threadIdx.x == 0) p.tickets[b] = 0;
}

}  // namespace

// Shared memory of one pass: the head (row buffer, the statistics'
// reduction, the layers' sc, sh and biases) and, for pass 1, the staged cloud
// (or nothing when it does not fit) or, for the later passes of a block
// with dense layers, the second row buffer and the weights: all of them
// when they fit in kResident bytes, else one stage. ops/sa_fused.py:
// sa_plan mirrors this; the entry refuses a plan whose numbers differ.
static void sa_smem(int n, int k, int tm, int ld, int wrows, int wres,
                    int nlayers, int csum, int* query, int* pass,
                    int* staged) {
  const int rows = tm * k;
  const int buf = rows * ld * 2;
  const int head = buf + kRed * 4 + 3 * csum * 4;
  *staged = head + n * 12 <= kSmemDyn;
  *query = head + (*staged ? n * 12 : 0);
  const int wt = wres <= kResident ? wres : wrows * kLdW * 2;
  *pass = head + (nlayers > 1 ? buf + wt : 0);
}

// points (B, N, 3), centers (B, M, 3), a (B, N, C1), bc (B, M, C1) f32.
// Host arrays of L - 1 pointers: ws, the bf16 (C_l, C_{l+1}) kernels, and
// bs, their f32 biases; of L pointers: cas, cbs, the (B, C_l) f32 affines;
// widths, the L widths. Scratch (none zeroed): idx (B, M, K) int32, part
// (B * max(G, G1) * 2 * Cmax) f64, scsh (2 * B * (C_1 + ... + C_L)) f32,
// tickets (B) int32. out (B, M, C_L) bf16. The plan: tm centers per tile,
// G blocks per item (G1 in pass 1), the passes' shared memory (sa_smem).
LION_EXPORT int lion_sa_fused(const void* points, const void* centers,
                              const void* a, const void* bc,
                              const void* const* ws, const void* const* bs,
                              const void* const* cas, const void* const* cbs,
                              const int* widths, int nlayers, void* idx,
                              void* part, void* scsh, void* tickets,
                              void* out, int b, int n, int m, int k, int tm,
                              int blocks, int blocks_query, int smem_query,
                              int smem_pass, float r2, void* stream) {
  if (nlayers < 1 || nlayers > kMaxLayers || tm < 1 || m % tm ||
      k < 1 || (k & (k - 1)) ||
      (tm * k != 64 && tm * k != 128) || blocks < 1 ||
      blocks > m / tm ||
      blocks_query < 1 || blocks_query > m / tm)
    return static_cast<int>(cudaErrorInvalidValue);
  Layers L{};
  int csum = 0, cmax = 0, wrows = 0, wres = 0;
  for (int l = 0; l < nlayers; ++l) {
    const int c = widths[l];
    if (c < 8 || c % 8 || c > kMaxC)
      return static_cast<int>(cudaErrorInvalidValue);
    L.width[l] = c;
    L.coff[l] = csum;
    csum += c;
    cmax = c > cmax ? c : cmax;
  }
  for (int l = 0; l + 1 < nlayers; ++l) {
    const int cinp = (widths[l] + 15) / 16 * 16;
    L.w[l] = static_cast<const bf16*>(ws[l]);
    L.bias[l] = static_cast<const float*>(bs[l]);
    L.woff[l] = wres / 2;
    wres += cinp * kLdW * 2 * ((widths[l + 1] + kChunk - 1) / kChunk);
    wrows = cinp > wrows ? cinp : wrows;
  }
  const int ld = (cmax + 15) / 16 * 16 + 8;
  int want_query = 0, want_pass = 0, staged = 0;
  sa_smem(n, k, tm, ld, wrows, wres, nlayers, csum, &want_query, &want_pass,
          &staged);
  if (want_query != smem_query || want_pass != smem_pass ||
      smem_pass > kSmemDyn || smem_query > kSmemDyn)
    return static_cast<int>(cudaErrorInvalidValue);
  static unsigned attr_done[3] = {0, 0, 0};  // per device, once per process
  const void* kernels[3] = {
      reinterpret_cast<const void*>(sa_pass_kernel<kQuery>),
      reinterpret_cast<const void*>(sa_pass_kernel<kStats>),
      reinterpret_cast<const void*>(sa_pass_kernel<kMax>)};
  cudaError_t err = cudaSuccess;
  for (int i = 0; i < 3 && err == cudaSuccess; ++i)
    err = lion::set_smem_once(kernels[i], kSmemDyn, &attr_done[i]);
  if (err != cudaSuccess) return static_cast<int>(err);

  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  err = cudaMemsetAsync(tickets, 0, sizeof(int) * b, s);
  if (err != cudaSuccess) return static_cast<int>(err);
  Pass p{};
  p.points = static_cast<const float*>(points);
  p.centers = static_cast<const float*>(centers);
  p.a = static_cast<const float*>(a);
  p.bc = static_cast<const float*>(bc);
  p.idx = static_cast<int*>(idx);
  p.part = static_cast<double*>(part);
  p.sc = static_cast<float*>(scsh);
  p.tickets = static_cast<int*>(tickets);
  p.out = static_cast<bf16*>(out);
  p.n = n;
  p.m = m;
  p.k = k;
  p.kshift = __builtin_ctz(static_cast<unsigned>(k));
  p.tm = tm;
  p.tiles = m / tm;
  p.csum = csum;
  p.ld = ld;
  p.r2 = r2;
  p.staged = staged;
  p.resident = wres <= kResident;
  for (int pass = 1; pass <= nlayers + 1; ++pass) {
    p.target = pass <= nlayers ? pass : nlayers;
    const bool query = pass == 1, is_max = pass == nlayers + 1;
    p.ca = static_cast<const float*>(cas[p.target - 1]);
    p.cb = static_cast<const float*>(cbs[p.target - 1]);
    const dim3 grid(query ? blocks_query : blocks, b);
    if (query) {
      sa_pass_kernel<kQuery><<<grid, kThreads, smem_query, s>>>(p, L);
    } else if (is_max) {
      sa_pass_kernel<kMax><<<grid, kThreads, smem_pass, s>>>(p, L);
    } else {
      sa_pass_kernel<kStats><<<grid, kThreads, smem_pass, s>>>(p, L);
    }
    if ((err = cudaGetLastError()) != cudaSuccess)
      return static_cast<int>(err);
  }
  return static_cast<int>(cudaSuccess);
}

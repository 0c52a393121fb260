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
// Bound on the H100: device-memory traffic of the grouped activations (the
// rows of z, M*K*C bf16 per item and layer: 4 MB per item at SA0) and the
// dense layers (2 * C_in * C_out flops per slot) on the tensor cores.
// Design: the statistics span the whole item, so no block can normalize
// before every block has produced its rows: one C entry makes 2L + 1
// launches on one stream, with no PyTorch op between them.
//   1. sa_first: one block per 128 slot rows (128 / K centers). A warp per
//      center runs the ball query (__ballot_sync, no sort), then the block
//      gathers z1 rows, stores them bf16, and writes each channel's partial
//      statistics: the sum and the sum of squared deviations about the
//      block's own mean.
//   2. per layer, sa_stats: one block per item merges the partials (Chan's
//      parallel form, in float64), so the variance is the centered one
//      without a second pass over z, and folds (ca, cb) into (sc, sh).
//   3. sa_dense (layers 1..L-1): normalize + swish the block's rows into a
//      bf16 tile in shared memory, multiply by the next kernel in 64-column
//      chunks with WMMA bf16 fragments (float32 accumulation), add the bias,
//      store bf16 and write the partial statistics of the new rows.
//   4. sa_max (layer L): normalize + swish and reduce the max over K.
#include <mma.h>

#include <cmath>

#include "common.cuh"

namespace {

namespace wmma = nvcuda::wmma;

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxRows = 128;
constexpr int kMaxC = 256;
constexpr int kChunk = 64;  // output channels per dense pass
constexpr int kLdW = kChunk + 8;
constexpr int kLdS = kChunk + 4;

__device__ __forceinline__ float swishf(float v) {
  return v / (1.0f + expf(-v));
}

__device__ __forceinline__ float rounded(float v) {
  return lion::round_to<lion::bf16>(v);
}

// Per channel of vals (rows x c, row stride ld): the sum and the sum of
// squared deviations about the rows' own mean.
__device__ void tile_stats(const float* vals, int rows, int ld, int c,
                           float* part_sum, float* part_m2) {
  for (int ch = threadIdx.x; ch < c; ch += blockDim.x) {
    float s = 0.0f;
    for (int i = 0; i < rows; ++i) s += vals[i * ld + ch];
    const float mean = s / static_cast<float>(rows);
    float m2 = 0.0f;
    for (int i = 0; i < rows; ++i) {
      const float d = vals[i * ld + ch] - mean;
      m2 += d * d;
    }
    part_sum[ch] = s;
    part_m2[ch] = m2;
  }
}

// Grid (tiles, B). part: (B, tiles, 2, c1).
__global__ void __launch_bounds__(kThreads)
sa_first_kernel(const float* __restrict__ points,
                const float* __restrict__ centers,
                const float* __restrict__ a, const float* __restrict__ bc,
                int n, int m, int k, int tm, int c1, float r2,
                lion::bf16* __restrict__ z, float* __restrict__ part) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int rows = tm * k;
  float* vals = reinterpret_cast<float*>(smem);        // rows x c1
  int* slot = reinterpret_cast<int*>(vals + rows * c1);  // tm x k
  const int b = blockIdx.y, tile = blockIdx.x, tiles = gridDim.x;
  const int m0 = tile * tm;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const float* pts = points + static_cast<size_t>(b) * n * 3;

  for (int mi = warp; mi < tm; mi += kWarps) {
    const float* ctr = centers + (static_cast<size_t>(b) * m + m0 + mi) * 3;
    const float cx = ctr[0], cy = ctr[1], cz = ctr[2];
    int* sel = slot + mi * k;
    int count = 0;  // identical in every lane
    for (int base = 0; base < n && count < k; base += 32) {
      const int j = base + lane;
      bool hit = false;
      if (j < n) {
        hit = lion::sq_dist(cx, cy, cz, pts[3 * j], pts[3 * j + 1],
                            pts[3 * j + 2]) < r2;
      }
      const unsigned mask = __ballot_sync(0xffffffffu, hit);
      if (hit) {
        const int s = count + __popc(mask & ((1u << lane) - 1u));
        if (s < k) sel[s] = j;
      }
      count += __popc(mask);
    }
    __syncwarp();
    const int found = count < k ? count : k;
    const int first = found > 0 ? sel[0] : 0;
    __syncwarp();
    for (int s = found + lane; s < k; s += 32) sel[s] = first;
    __syncwarp();
  }
  __syncthreads();

  const float* ab = a + static_cast<size_t>(b) * n * c1;
  const float* bcb = bc + (static_cast<size_t>(b) * m + m0) * c1;
  lion::bf16* zb = z + (static_cast<size_t>(b) * m + m0) * k * c1;
  for (int e = threadIdx.x; e < rows * c1; e += kThreads) {
    const int row = e / c1, ch = e - row * c1;
    const float v = rounded(ab[static_cast<size_t>(slot[row]) * c1 + ch] +
                            bcb[(row / k) * c1 + ch]);
    zb[e] = __float2bfloat16_rn(v);
    vals[e] = v;
  }
  __syncthreads();
  float* pb = part + (static_cast<size_t>(b) * tiles + tile) * 2 * c1;
  tile_stats(vals, rows, c1, c1, pb, pb + c1);
}

// Grid (B). Merges the (B, tiles, 2, c) partials of `rows` rows each into
// GroupNorm(8) per item and folds the channel affine (ca, cb) (row stride
// ld): sc = rs * ca, sh = cb - mu * sc, both (B, c).
__global__ void sa_stats_kernel(const float* __restrict__ part,
                                const float* __restrict__ ca,
                                const float* __restrict__ cb, int ld, int c,
                                int tiles, int rows, float* __restrict__ sc,
                                float* __restrict__ sh) {
  __shared__ double mean_c[kMaxC], m2_c[kMaxC];
  const int b = blockIdx.x;
  const float* pb = part + static_cast<size_t>(b) * tiles * 2 * c;
  const double nt = rows;
  const double nc = nt * tiles;
  for (int ch = threadIdx.x; ch < c; ch += blockDim.x) {
    double s = 0.0;
    for (int t = 0; t < tiles; ++t)
      s += pb[static_cast<size_t>(t) * 2 * c + ch];
    const double mean = s / nc;
    double m2 = 0.0;
    for (int t = 0; t < tiles; ++t) {
      const float* pt = pb + static_cast<size_t>(t) * 2 * c;
      const double d = pt[ch] / nt - mean;
      m2 += pt[c + ch] + nt * d * d;
    }
    mean_c[ch] = mean;
    m2_c[ch] = m2;
  }
  __syncthreads();
  const int cg = c / 8;
  for (int ch = threadIdx.x; ch < c; ch += blockDim.x) {
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
    const float s = rs * ca[static_cast<size_t>(b) * ld + ch];
    sc[static_cast<size_t>(b) * c + ch] = s;
    sh[static_cast<size_t>(b) * c + ch] =
        cb[static_cast<size_t>(b) * ld + ch] - static_cast<float>(mg) * s;
  }
}

// Grid (tiles, B). zin (B, M*K, cin) -> zout (B, M*K, cout) through
// normalize + swish and the dense layer w (cin, cout) bf16, bias (cout,).
// part: (B, tiles, 2, cout).
__global__ void __launch_bounds__(kThreads)
sa_dense_kernel(const lion::bf16* __restrict__ zin,
                const float* __restrict__ sc, const float* __restrict__ sh,
                const lion::bf16* __restrict__ w,
                const float* __restrict__ bias, int m, int k, int tm,
                int cin, int cout, lion::bf16* __restrict__ zout,
                float* __restrict__ part) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int cinp = (cin + 15) / 16 * 16;
  const int ldh = cinp + 8;
  const int rows = tm * k;
  lion::bf16* h = reinterpret_cast<lion::bf16*>(smem);      // rows x ldh
  lion::bf16* wt = h + rows * ldh;                          // cinp x kLdW
  float* stage = reinterpret_cast<float*>(wt + cinp * kLdW);  // rows x kLdS
  const int b = blockIdx.y, tile = blockIdx.x, tiles = gridDim.x;
  const size_t row0 = (static_cast<size_t>(b) * m +
                       static_cast<size_t>(tile) * tm) * k;
  const float* scb = sc + static_cast<size_t>(b) * cin;
  const float* shb = sh + static_cast<size_t>(b) * cin;
  for (int e = threadIdx.x; e < rows * cinp; e += kThreads) {
    const int row = e / cinp, ch = e - row * cinp;
    float v = 0.0f;
    if (ch < cin) {
      v = swishf(__bfloat162float(zin[(row0 + row) * cin + ch]) * scb[ch] +
                 shb[ch]);
    }
    h[row * ldh + ch] = __float2bfloat16_rn(v);
  }
  float* pb = part + (static_cast<size_t>(b) * tiles + tile) * 2 * cout;
  const int warp = threadIdx.x >> 5;
  for (int n0 = 0; n0 < cout; n0 += kChunk) {
    for (int e = threadIdx.x; e < cinp * kChunk; e += kThreads) {
      const int kk = e / kChunk, nn = e - kk * kChunk;
      wt[kk * kLdW + nn] = (kk < cin && n0 + nn < cout)
                               ? w[static_cast<size_t>(kk) * cout + n0 + nn]
                               : __float2bfloat16_rn(0.0f);
    }
    __syncthreads();
    const int frags = (rows / 16) * (kChunk / 16);
    for (int f = warp; f < frags; f += kWarps) {
      const int fi = f / (kChunk / 16), fj = f % (kChunk / 16);
      wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc;
      wmma::fill_fragment(acc, 0.0f);
      for (int kk = 0; kk < cinp; kk += 16) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, lion::bf16,
                       wmma::row_major> fa;
        wmma::fragment<wmma::matrix_b, 16, 16, 16, lion::bf16,
                       wmma::row_major> fb;
        wmma::load_matrix_sync(fa, h + fi * 16 * ldh + kk, ldh);
        wmma::load_matrix_sync(fb, wt + kk * kLdW + fj * 16, kLdW);
        wmma::mma_sync(acc, fa, fb, acc);
      }
      wmma::store_matrix_sync(stage + fi * 16 * kLdS + fj * 16, acc, kLdS,
                              wmma::mem_row_major);
    }
    __syncthreads();
    const int cw = min(kChunk, cout - n0);
    for (int e = threadIdx.x; e < rows * kChunk; e += kThreads) {
      const int row = e / kChunk, nn = e - row * kChunk;
      if (nn < cw) {
        const float v = rounded(stage[row * kLdS + nn] + bias[n0 + nn]);
        stage[row * kLdS + nn] = v;
        zout[(row0 + row) * cout + n0 + nn] = __float2bfloat16_rn(v);
      }
    }
    __syncthreads();
    tile_stats(stage, rows, kLdS, cw, pb + n0, pb + cout + n0);
    __syncthreads();
  }
}

// Grid (tiles, B). out (B, M, c) = max over the K slots of
// bf16(swish(z * sc + sh)).
__global__ void __launch_bounds__(kThreads)
sa_max_kernel(const lion::bf16* __restrict__ z,
              const float* __restrict__ sc, const float* __restrict__ sh,
              int m, int k, int tm, int c, lion::bf16* __restrict__ out) {
  const int b = blockIdx.y, tile = blockIdx.x;
  const size_t m0 = static_cast<size_t>(b) * m +
                    static_cast<size_t>(tile) * tm;
  for (int e = threadIdx.x; e < tm * c; e += kThreads) {
    const int mi = e / c, ch = e - mi * c;
    const float s = sc[static_cast<size_t>(b) * c + ch];
    const float t = sh[static_cast<size_t>(b) * c + ch];
    const lion::bf16* zr = z + (m0 + mi) * k * c + ch;
    float best = -INFINITY;
    for (int j = 0; j < k; ++j) {
      best = fmaxf(best, rounded(swishf(
                             __bfloat162float(zr[static_cast<size_t>(j) * c]) *
                                 s + t)));
    }
    out[(m0 + mi) * c + ch] = __float2bfloat16_rn(best);
  }
}

cudaError_t set_smem(const void* fn, size_t bytes) {
  return cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(bytes));
}

}  // namespace

// points (B, N, 3), centers (B, M, 3), a (B, N, C1), bc (B, M, C1) f32;
// w: the bf16 kernels of layers 2..L, (C_{l-1}, C_l) each, back to back;
// bias: their f32 biases back to back; ca/cb (B, C_1 + ... + C_L) f32;
// widths: host array of the L widths. Scratch: z0/z1 (B*M*K*Cmax) bf16,
// part (B * M/tm * 2 * Cmax) f32, scsh (2 * B * Cmax) f32. out (B, M, C_L)
// bf16. tm centers per block (tm * K <= 128 slot rows, a multiple of 16).
LION_EXPORT int lion_sa_fused(const void* points, const void* centers,
                              const void* a, const void* bc, const void* w,
                              const void* bias, const void* ca,
                              const void* cb, const void* widths_ptr,
                              int nlayers, void* z0, void* z1, void* part,
                              void* scsh, void* out, int b, int n, int m,
                              int k, int tm, float r2, void* stream) {
  const int* widths = static_cast<const int*>(widths_ptr);
  int csum = 0, cmax = 0;
  for (int l = 0; l < nlayers; ++l) {
    csum += widths[l];
    cmax = widths[l] > cmax ? widths[l] : cmax;
  }
  const int rows = tm * k;
  if (nlayers < 1 || cmax > kMaxC || rows > kMaxRows || rows % 16 ||
      m % tm)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int tiles = m / tm;
  const dim3 grid(tiles, b);
  float* sc = static_cast<float*>(scsh);
  float* sh = sc + static_cast<size_t>(b) * cmax;
  float* pf = static_cast<float*>(part);
  const auto* caf = static_cast<const float*>(ca);
  const auto* cbf = static_cast<const float*>(cb);

  const size_t smem1 = (static_cast<size_t>(rows) * widths[0] + rows) * 4;
  cudaError_t err = set_smem(reinterpret_cast<const void*>(sa_first_kernel),
                             smem1);
  if (err != cudaSuccess) return static_cast<int>(err);
  sa_first_kernel<<<grid, kThreads, smem1, s>>>(
      static_cast<const float*>(points), static_cast<const float*>(centers),
      static_cast<const float*>(a), static_cast<const float*>(bc), n, m, k,
      tm, widths[0], r2, static_cast<lion::bf16*>(z0), pf);
  if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);

  const lion::bf16* wl = static_cast<const lion::bf16*>(w);
  const float* bl = static_cast<const float*>(bias);
  lion::bf16* zin = static_cast<lion::bf16*>(z0);
  lion::bf16* zout = static_cast<lion::bf16*>(z1);
  int coff = 0;
  for (int l = 0; l < nlayers; ++l) {
    const int c = widths[l];
    sa_stats_kernel<<<b, 256, 0, s>>>(pf, caf + coff, cbf + coff, csum, c,
                                      tiles, rows, sc, sh);
    if ((err = cudaGetLastError()) != cudaSuccess)
      return static_cast<int>(err);
    if (l + 1 < nlayers) {
      const int co = widths[l + 1];
      const int cinp = (c + 15) / 16 * 16;
      const size_t smem = static_cast<size_t>(rows) * (cinp + 8) * 2 +
                          static_cast<size_t>(cinp) * kLdW * 2 +
                          static_cast<size_t>(rows) * kLdS * 4;
      err = set_smem(reinterpret_cast<const void*>(sa_dense_kernel), smem);
      if (err != cudaSuccess) return static_cast<int>(err);
      sa_dense_kernel<<<grid, kThreads, smem, s>>>(zin, sc, sh, wl, bl, m, k,
                                                   tm, c, co, zout, pf);
      if ((err = cudaGetLastError()) != cudaSuccess)
        return static_cast<int>(err);
      lion::bf16* t = zin;
      zin = zout;
      zout = t;
      wl += static_cast<size_t>(c) * co;
      bl += co;
    } else {
      sa_max_kernel<<<grid, kThreads, 0, s>>>(zin, sc, sh, m, k, tm, c,
                                              static_cast<lion::bf16*>(out));
    }
    coff += c;
  }
  return static_cast<int>(cudaGetLastError());
}

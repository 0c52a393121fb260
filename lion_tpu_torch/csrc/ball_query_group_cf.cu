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
// Bound on the H100: device-memory bandwidth on the output, K * (3 + C)
// values per center (K = 32), against N * 12 bytes of coords read per
// center (L1/L2 resident).
// Design: a block owns a tile of 32 centers of one item. Its 8 warps find
// the 32 balls (the warp ball query of ball_query.cuh, shared with K2 and
// K11) into shared memory; then each warp writes whole (k, ch) rows of the
// tile with its 32 lanes along the centers, so every store of a row segment
// is contiguous.
#include "ball_query.cuh"
#include "common.cuh"

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kTile = 32;  // centers per block, one per lane when writing

template <typename T>
__global__ void __launch_bounds__(kThreads)
bqg_cf_kernel(const float* __restrict__ points, const float* __restrict__ ctrs,
              const T* __restrict__ feats, int n, int m, int c, int k,
              float r2, T* __restrict__ out) {
  // kTile rows of k point indices, `stride` = k | 1 apart: an odd stride
  // puts the 32 lanes' reads of one slot in 32 different banks
  extern __shared__ int slots[];
  const int stride = k | 1;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int b = blockIdx.y;
  const int m0 = blockIdx.x * kTile;
  const float* pts = points + static_cast<size_t>(b) * n * 3;

  for (int t = warp; t < kTile && m0 + t < m; t += kWarps) {
    const float* ctr = ctrs + (static_cast<size_t>(b) * m + m0 + t) * 3;
    lion::warp_ball_query(ctr[0], ctr[1], ctr[2], pts, n, k, r2,
                          slots + t * stride);
  }
  __syncthreads();

  const int center = m0 + lane;
  if (center >= m) return;  // no barrier below
  const float* ctr = ctrs + (static_cast<size_t>(b) * m + center) * 3;
  const T* f = feats + static_cast<size_t>(b) * n * c;
  const int width = 3 + c;
  const int* sel = slots + lane * stride;
  // row (s, ch) of item b starts at ((b * K + s) * width + ch) * M
  T* o = out + static_cast<size_t>(b) * k * width * m + center;
  for (int row = warp; row < k * width; row += kWarps) {
    const int s = row / width;
    const int ch = row - s * width;
    const int p = sel[s];
    const float v = ch < 3 ? __fsub_rn(pts[3 * p + ch], ctr[ch])
                           : lion::to_float(f[static_cast<size_t>(p) * c +
                                               (ch - 3)]);
    lion::store(o + static_cast<size_t>(row) * m, v);
  }
}

}  // namespace

// points (B, N, 3), centers (B, M, 3) f32, feats (B, N, C) f32 or bf16
// (is_bf16) -> out (B, K, 3 + C, M) of the features' dtype. r2 is the
// squared radius in fp32. The caller keeps 32 * (K | 1) * 4 bytes of slots
// within 48 KB.
LION_EXPORT int lion_ball_query_group_cf(const void* points,
                                         const void* centers,
                                         const void* feats, void* out, int b,
                                         int n, int m, int c, int k, float r2,
                                         int is_bf16, void* stream) {
  const dim3 grid(lion::ceil_div(m, kTile), b);
  const size_t smem = static_cast<size_t>(kTile) * (k | 1) * sizeof(int);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* p = static_cast<const float*>(points);
  const float* ctr = static_cast<const float*>(centers);
  if (is_bf16) {
    bqg_cf_kernel<lion::bf16><<<grid, kThreads, smem, st>>>(
        p, ctr, static_cast<const lion::bf16*>(feats), n, m, c, k, r2,
        static_cast<lion::bf16*>(out));
  } else {
    bqg_cf_kernel<float><<<grid, kThreads, smem, st>>>(
        p, ctr, static_cast<const float*>(feats), n, m, c, k, r2,
        static_cast<float*>(out));
  }
  return static_cast<int>(cudaGetLastError());
}

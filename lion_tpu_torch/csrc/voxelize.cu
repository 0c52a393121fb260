// K3: average voxelization (scatter-mean of point features into r^3 cells).
//
// Replaces lion_tpu/ops/pallas/voxelize.py: avg_voxelize_pallas
// (_vox_kernel) and lion_tpu/ops/pallas/voxelize_binned.py:
// avg_voxelize_binned (_vox_binned_kernel). The TPU needed a dense and a
// point-binned variant to feed its matrix unit; one cell-ordered gather
// serves here.
//
// Semantics: cell index x*r^2 + y*r + z; each cell holds the mean of the
// features of the points that fall in it; empty cells hold 0; a point
// outside the grid is dropped. Features are float32 or bfloat16; sums are
// taken in float32 and the mean is rounded once to the features' dtype
// (lion_tpu/ops/voxel.py:61,92). The result is deterministic: each cell's
// sum runs over its points in ascending point order, starting from 0, and
// is divided by the count in IEEE float32, so it equals bit for bit a
// float32 sum in point order (np.add.at) divided by the count.
//
// Bound on the H100: device-memory bandwidth of the one write of the
// (B, r^3, C) output (134 MB at B = 16, r = 32, C = 64 in float32).
// Design: two launches, no zero fill, no float atomics.
//   1. vox_order: one block per item builds a stable cell order of its
//      points (stable_order.cuh: integer counts, their scan as the cells'
//      offsets (B, r^3 + 1), each warp's peers by __match_any_sync), so
//      each cell's slice of the (B, N) order lists its points in
//      ascending order.
//   2. vox_mean: a thread per (cell, group of V neighbouring channels; V = 4
//      fp32 or 8 bf16 values, 16 bytes) sums the cell's rows in that order,
//      divides and stores once; empty cells store 0. Neighbouring threads take neighbouring channels, so
//      the stores (every output element exactly once) are coalesced.
#include "common.cuh"
#include "stable_order.cuh"

namespace {

constexpr int kMeanThreads = 256;
constexpr int kSmemMax = 232448;  // a block's shared memory on the H100
using lion::kOrderThreads;

__device__ __forceinline__ int cell_of(const int* v, int r) {
  const int x = v[0], y = v[1], z = v[2];
  if (x < 0 || x >= r || y < 0 || y >= r || z < 0 || z >= r) return -1;
  return (x * r + y) * r + z;
}

// Grid (B), kOrderThreads threads: the stable cell order of each item's
// points (stable_order.cuh). The counts and the N cells live in shared
// memory (shared != 0) or in the global scratch (B, order_words) int32.
__global__ void __launch_bounds__(kOrderThreads)
vox_order_kernel(const int* __restrict__ vox, int n, int r, int shared,
                 int* __restrict__ scratch, int* __restrict__ offsets,
                 int* __restrict__ order) {
  extern __shared__ __align__(16) int smem[];
  const int b = blockIdx.x;
  const int r3 = r * r * r;
  int* cnt = shared ? smem
                    : scratch + static_cast<size_t>(b) *
                                    lion::order_words(n, r3);
  const int* vb = vox + static_cast<size_t>(b) * n * 3;
  lion::stable_order([&](int i) { return cell_of(vb + 3 * i, r); }, n, r3,
                     cnt, offsets + static_cast<size_t>(b) * (r3 + 1),
                     order + static_cast<size_t>(b) * n);
}

template <typename T, int V>
struct Vec;
template <>
struct Vec<float, 4> {
  using type = float4;
};
template <>
struct Vec<lion::bf16, 8> {
  using type = uint4;
};

// Grid (ceil(r^3 / blockDim.y), B), block (gx, gy): threadIdx.y picks the
// cell, threadIdx.x walks its channel groups of V neighbouring channels, so
// neighbouring threads store neighbouring channels.
template <typename T, int V>
__global__ void __launch_bounds__(kMeanThreads)
vox_mean_kernel(const T* __restrict__ feats, const int* __restrict__ offsets,
                const int* __restrict__ order, int n, int c, int r3,
                T* __restrict__ out) {
  const int cell = blockIdx.x * blockDim.y + threadIdx.y;
  const int b = blockIdx.y;
  if (cell >= r3) return;
  const int* off = offsets + static_cast<size_t>(b) * (r3 + 1) + cell;
  const int s = off[0], e = off[1];
  const int* ord = order + static_cast<size_t>(b) * n;
  const T* fb = feats + static_cast<size_t>(b) * n * c;
  T* dst = out + (static_cast<size_t>(b) * r3 + cell) * c;
  const float k = static_cast<float>(e - s);
  for (int g = threadIdx.x * V; g < c; g += blockDim.x * V) {
    float acc[V];
#pragma unroll
    for (int v = 0; v < V; ++v) acc[v] = 0.0f;
    for (int j = s; j < e; ++j) {
      const T* row = fb + static_cast<size_t>(ord[j]) * c + g;
      if constexpr (V == 1) {
        acc[0] = __fadd_rn(acc[0], lion::to_float(row[0]));
      } else {
        const typename Vec<T, V>::type raw =
            *reinterpret_cast<const typename Vec<T, V>::type*>(row);
        const T* x = reinterpret_cast<const T*>(&raw);
#pragma unroll
        for (int v = 0; v < V; ++v)
          acc[v] = __fadd_rn(acc[v], lion::to_float(x[v]));
      }
    }
    alignas(16) T res[V];
#pragma unroll
    for (int v = 0; v < V; ++v)
      lion::store(res + v, e > s ? __fdiv_rn(acc[v], k) : 0.0f);
    if constexpr (V == 1) {
      dst[g] = res[0];
    } else {  // streaming store: the grid is written once, read later
      __stcs(reinterpret_cast<typename Vec<T, V>::type*>(dst + g),
             *reinterpret_cast<const typename Vec<T, V>::type*>(res));
    }
  }
}

template <typename T, int V>
cudaError_t launch_mean(const void* feats, const int* offsets,
                        const int* order, int b, int n, int c, int r3,
                        void* out, cudaStream_t s) {
  const int gx = min(c / V, kMeanThreads);
  const int gy = max(1, kMeanThreads / gx);
  if (b > 0 && r3 > 0) {
    vox_mean_kernel<T, V><<<dim3((r3 + gy - 1) / gy, b), dim3(gx, gy), 0,
                            s>>>(static_cast<const T*>(feats), offsets,
                                 order, n, c, r3, static_cast<T*>(out));
  }
  return cudaGetLastError();
}

}  // namespace

// Shared memory of vox_order for N points at resolution r, or 0 when its
// words do not fit (they then live in the global scratch). ops/voxel.py:
// vox_order_smem mirrors this.
static int vox_order_smem(int n, int r) {
  return lion::order_smem(n, r * r * r, kSmemMax);
}

// feats (B, N, C) f32 or bf16 (bf16 != 0), vox (B, N, 3) i32 -> out
// (B, r^3, C) of the features' dtype. Scratch, none zeroed: offsets
// (B, r^3 + 1) and order (B, N) int32; scratch (B, r^3 + r^3 / 32 + 1 + N)
// int32, used
// (and may be NULL otherwise) when vox_order_smem(N, r) is 0.
LION_EXPORT int lion_avg_voxelize(const void* feats, const void* vox,
                                  void* offsets, void* order, void* scratch,
                                  void* out, int b, int n, int c, int r,
                                  int bf16, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int r3 = r * r * r;
  const int smem = vox_order_smem(n, r);
  if (r < 1 || n < 0 || c < 1 || (smem == 0 && scratch == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  static unsigned attr_done = 0;  // per device, once per process
  cudaError_t err = lion::set_smem_once(
      reinterpret_cast<const void*>(vox_order_kernel),
      kSmemMax - 4 * (kOrderThreads / 32), &attr_done);
  if (err != cudaSuccess) return static_cast<int>(err);
  int* off = static_cast<int*>(offsets);
  int* ord = static_cast<int*>(order);
  if (b > 0) {
    vox_order_kernel<<<b, kOrderThreads, smem, s>>>(
        static_cast<const int*>(vox), n, r, smem != 0,
        static_cast<int*>(scratch), off, ord);
  }
  if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);
  if (bf16) {
    err = c % 8 == 0
              ? launch_mean<lion::bf16, 8>(feats, off, ord, b, n, c, r3, out, s)
              : launch_mean<lion::bf16, 1>(feats, off, ord, b, n, c, r3, out,
                                           s);
  } else {
    err = c % 4 == 0
              ? launch_mean<float, 4>(feats, off, ord, b, n, c, r3, out, s)
              : launch_mean<float, 1>(feats, off, ord, b, n, c, r3, out, s);
  }
  return static_cast<int>(err);
}

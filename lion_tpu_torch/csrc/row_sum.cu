// The ordered row sum: out[b, idx[b, r]] += rows[b, r], each output row
// the sum of its rows in ascending r, in float32.
//
// Replaces no TPU kernel. It is the transpose of the backwards' row
// gathers (K2's and K13's grouping, K5's eight corners, K6's three
// neighbours, K3's cell gather under a second derivative), which the JAX
// package leaves to XLA's scatter-add (e.g. lion_tpu/ops/points.py:
// 241-258). A float scatter-add with atomics adds in an order that changes
// from call to call, so a training step would not repeat bit for bit; here
// every output element is written once, from a sum in a fixed order, and
// equals a float32 scatter-add on the CPU (which adds in ascending r) bit
// for bit.
//
// Bound on the H100: device-memory bandwidth: the rows read once (B R C
// values) and the output written once (B n C floats).
// Design: two launches, no zero fill, no float atomics (K3's design,
// csrc/voxelize.cu).
//   1. row_order: one block per item builds the inverse index, a stable
//      counting sort of its R indices into n buckets (stable_order.cuh):
//      offsets (B, n + 1) and the rows in bucket order (B, R).
//   2. row_sum: a thread per (output row, group of V neighbouring
//      channels; 16 bytes of rows) walks its row's slice of the order,
//      sums in float32 and stores once; an output row that no index names
//      stores 0.
#include "common.cuh"
#include "stable_order.cuh"

namespace {

constexpr int kSumThreads = 256;
constexpr int kSmemMax = 232448;  // a block's shared memory on the H100
using lion::kOrderThreads;

// Grid (B), kOrderThreads threads. An index outside [0, n) is dropped.
__global__ void __launch_bounds__(kOrderThreads)
row_order_kernel(const int* __restrict__ idx, int r, int n, int shared,
                 int* __restrict__ scratch, int* __restrict__ offsets,
                 int* __restrict__ order) {
  extern __shared__ __align__(16) int smem[];
  const int b = blockIdx.x;
  int* cnt = shared ? smem
                    : scratch + static_cast<size_t>(b) *
                                    lion::order_words(r, n);
  const int* ib = idx + static_cast<size_t>(b) * r;
  lion::stable_order(
      [&](int i) {
        const int k = ib[i];
        return k >= 0 && k < n ? k : -1;
      },
      r, n, cnt, offsets + static_cast<size_t>(b) * (n + 1),
      order + static_cast<size_t>(b) * r);
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

// Grid (ceil(n / blockDim.y), B), block (gx, gy): threadIdx.y picks the
// output row, threadIdx.x walks its groups of V neighbouring channels.
template <typename T, int V>
__global__ void __launch_bounds__(kSumThreads)
row_sum_kernel(const T* __restrict__ rows, const int* __restrict__ offsets,
               const int* __restrict__ order, int r, int n, int c,
               float* __restrict__ out) {
  const int row = blockIdx.x * blockDim.y + threadIdx.y;
  const int b = blockIdx.y;
  if (row >= n) return;
  const int* off = offsets + static_cast<size_t>(b) * (n + 1) + row;
  const int s = off[0], e = off[1];
  const int* ord = order + static_cast<size_t>(b) * r;
  const T* rb = rows + static_cast<size_t>(b) * r * c;
  float* dst = out + (static_cast<size_t>(b) * n + row) * c;
  for (int g = threadIdx.x * V; g < c; g += blockDim.x * V) {
    float acc[V];
#pragma unroll
    for (int v = 0; v < V; ++v) acc[v] = 0.0f;
    for (int j = s; j < e; ++j) {
      const T* src = rb + static_cast<size_t>(ord[j]) * c + g;
      if constexpr (V == 1) {
        acc[0] = __fadd_rn(acc[0], lion::to_float(src[0]));
      } else {
        const typename Vec<T, V>::type raw =
            *reinterpret_cast<const typename Vec<T, V>::type*>(src);
        const T* x = reinterpret_cast<const T*>(&raw);
#pragma unroll
        for (int v = 0; v < V; ++v)
          acc[v] = __fadd_rn(acc[v], lion::to_float(x[v]));
      }
    }
    if constexpr (V == 1) {
      dst[g] = acc[0];
    } else {
#pragma unroll
      for (int v = 0; v < V; v += 4)
        *reinterpret_cast<float4*>(dst + g + v) =
            make_float4(acc[v], acc[v + 1], acc[v + 2], acc[v + 3]);
    }
  }
}

template <typename T, int V>
cudaError_t launch_sum(const void* rows, const int* offsets, const int* order,
                       int b, int r, int n, int c, void* out,
                       cudaStream_t s) {
  const int gx = min(max(c / V, 1), kSumThreads);
  const int gy = max(1, kSumThreads / gx);
  if (b > 0 && n > 0) {
    row_sum_kernel<T, V><<<dim3((n + gy - 1) / gy, b), dim3(gx, gy), 0, s>>>(
        static_cast<const T*>(rows), offsets, order, r, n, c,
        static_cast<float*>(out));
  }
  return cudaGetLastError();
}

}  // namespace

// idx (B, R) int32, rows (B, R, C) f32 or bf16 (bf16 != 0) -> out (B, n, C)
// f32. Scratch, none zeroed: offsets (B, n + 1) and order (B, R) int32;
// scratch (B, order_words(R, n)) int32, used (and may be NULL otherwise)
// when lion_row_order_smem(R, n) is 0. Every pointer 16-byte aligned.
LION_EXPORT int lion_row_sum(const void* idx, const void* rows, void* offsets,
                             void* order, void* scratch, void* out, int b,
                             int r, int n, int c, int bf16, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int smem = lion::order_smem(r, n, kSmemMax);
  if (r < 0 || n < 1 || c < 1 || (smem == 0 && scratch == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  static unsigned attr_done = 0;  // per device, once per process
  cudaError_t err = lion::set_smem_once(
      reinterpret_cast<const void*>(row_order_kernel),
      kSmemMax - 4 * (kOrderThreads / 32), &attr_done);
  if (err != cudaSuccess) return static_cast<int>(err);
  int* off = static_cast<int*>(offsets);
  int* ord = static_cast<int*>(order);
  if (b > 0) {
    row_order_kernel<<<b, kOrderThreads, smem, s>>>(
        static_cast<const int*>(idx), r, n, smem != 0,
        static_cast<int*>(scratch), off, ord);
  }
  if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);
  if (bf16) {
    err = c % 8 == 0
              ? launch_sum<lion::bf16, 8>(rows, off, ord, b, r, n, c, out, s)
              : launch_sum<lion::bf16, 1>(rows, off, ord, b, r, n, c, out, s);
  } else {
    err = c % 4 == 0
              ? launch_sum<float, 4>(rows, off, ord, b, r, n, c, out, s)
              : launch_sum<float, 1>(rows, off, ord, b, r, n, c, out, s);
  }
  return static_cast<int>(err);
}

// A stable counting sort of one item's N keys into `nkeys` buckets by one
// block of kOrderThreads threads: the inverse index (CSR) that K3
// (csrc/voxelize.cu) and the ordered row sum (csrc/row_sum.cu) walk.
//
// The block counts the keys of each bucket with integer atomics (an
// integer sum does not depend on order), takes the exclusive scan as the
// buckets' offsets (nkeys + 1), and places the elements kOrderThreads at a
// time: an element goes to its bucket's running cursor plus its rank among
// the lanes of its warp with the same key (__match_any_sync), the warps
// taking turns in order, so each bucket's slice of the order lists its
// elements in ascending index. A key of -1 (or any negative key) is
// dropped. No float is added anywhere, so the order is the same on every
// run.
#pragma once

#include "common.cuh"

namespace lion {

constexpr int kOrderThreads = 1024;

// The counts' layout: one pad word after every 32 buckets, so a lane that
// walks its own run of 32 buckets meets no bank conflict.
__device__ __forceinline__ int padded(int key) { return key + (key >> 5); }

// int32 words of the counts (padded nkeys + 1) and the N keys.
__host__ __device__ inline long long order_words(int n, int nkeys) {
  return static_cast<long long>(nkeys) + (nkeys >> 5) + 1 + n;
}

// Shared memory for order_words, or 0 when they do not fit beside the
// block's own kOrderThreads / 32 words (they then live in global scratch).
inline int order_smem(int n, int nkeys, int smem_max) {
  const long long bytes = order_words(n, nkeys) * 4;
  return bytes + 4 * (kOrderThreads / 32) <= smem_max
             ? static_cast<int>(bytes) : 0;
}

// The stable order of one item: key(i) in [0, nkeys) or negative (dropped)
// for i < n. `cnt` holds order_words(n, nkeys) int32 (shared or global);
// off (nkeys + 1) receives the buckets' offsets, ord (n) the elements in
// bucket order. Called by all kOrderThreads threads of the block.
template <class Key>
__device__ void stable_order(Key key, int n, int nkeys, int* cnt,
                             int* __restrict__ off, int* __restrict__ ord) {
  __shared__ int warp_total[kOrderThreads / 32];
  const int np = padded(nkeys) + 1;
  int* keys = cnt + np;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  constexpr int kWarps = kOrderThreads / 32;

  for (int i = threadIdx.x; i < np; i += kOrderThreads) cnt[i] = 0;
  __syncthreads();
  for (int i = threadIdx.x; i < n; i += kOrderThreads) {
    const int k = key(i);
    keys[i] = k;
    if (k >= 0) atomicAdd(cnt + padded(k), 1);
  }
  __syncthreads();

  // exclusive scan: thread t owns the run [t * per, (t + 1) * per)
  const int per = (nkeys + kOrderThreads - 1) / kOrderThreads;
  const int lo = min(threadIdx.x * per, nkeys), hi = min(lo + per, nkeys);
  int total = 0;
  for (int i = lo; i < hi; ++i) total += cnt[padded(i)];
  int inc = total;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const int v = __shfl_up_sync(0xffffffffu, inc, d);
    if (lane >= d) inc += v;
  }
  if (lane == 31) warp_total[warp] = inc;
  __syncthreads();
  int base = inc - total;
  for (int w = 0; w < warp; ++w) base += warp_total[w];
  for (int i = lo; i < hi; ++i) {  // the cursor starts at the offset
    const int v = cnt[padded(i)];
    cnt[padded(i)] = base;
    base += v;
  }
  __syncthreads();
  for (int i = threadIdx.x; i < nkeys; i += kOrderThreads)
    off[i] = cnt[padded(i)];
  if (threadIdx.x == 0) {
    int all = 0;
    for (int w = 0; w < kWarps; ++w) all += warp_total[w];
    off[nkeys] = all;
  }
  __syncthreads();

  // stable placement in index order, kOrderThreads elements a round: every
  // warp finds its lanes' peers (__match_any_sync) at once, then the warps
  // take turns in warp order to read and move their buckets' cursors
  for (int i0 = 0; i0 < n; i0 += kOrderThreads) {
    const int i = i0 + threadIdx.x;
    const int k = i < n ? keys[i] : -1;
    const unsigned peers = __match_any_sync(0xffffffffu, k);
    const int rank = __popc(peers & ((1u << lane) - 1u));
    int at = 0;
    for (int w = 0; w < kWarps; ++w) {
      if (warp == w) {
        if (k >= 0) at = cnt[padded(k)];
        __syncwarp();
        if (k >= 0 && rank == 0) cnt[padded(k)] = at + __popc(peers);
      }
      __syncthreads();
    }
    if (k >= 0) ord[at + rank] = i;
  }
}

}  // namespace lion

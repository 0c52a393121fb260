// A probe of K1 (csrc/fps.cu) for `python -m lion_tpu_torch.profile_step
// --fps-clock`: built on its own into a separate library, never into the
// kernels' library.
//
// lion_fps_on_plan runs K1's kernel on a given plan (threads, P), and
// lion_fps_probe the same with a stamp that sums, in registers, the clock
// cycles from each phase of a pick to the next (the phases of fps_kernel:
// the pick's start, the update done, the warp argmax done, the barrier
// passed, the fold done) over the picks, written once by block 0's thread
// 0 at the end. lion_fps_empty_rounds runs the chain's floor: rounds of one
// shared store, one barrier, one shared load and two redux.sync, each round
// depending on the last, with the cycles of block 0's rounds.
// lion_fps_latency times chains of one primitive: dependent redux.sync,
// dependent shared loads, barriers. lion_fps_plan gives K1's own plan.
#include "../fps.cu"

namespace {

// Every thread sums the cycles since its previous stamp by the phase that
// ends them (sum[0]: the broadcast of the last pick and the loop, from the
// second pick on; sum[1]: the update; sum[2]: the warp argmax; sum[3]: the
// barrier; sum[4]: the fold); at the end block 0's thread 0 writes
// out[0..4] and out[5] = the picks, and its last warp's lane 0 the same to
// out[6..11]. 32-bit clock differences, in registers: nothing is stored
// during the chain.
struct ClockStamp {
  unsigned* out;
  unsigned sum[5], prev, picks;
  __device__ __forceinline__ void operator()(int phase, unsigned dep) {
    asm volatile("" ::"r"(dep));  // the phase's result is ready
    const unsigned now = static_cast<unsigned>(clock());
    if (phase == 5) {
      const unsigned lastwarp = blockDim.x - 32;
      if (blockIdx.x == 0 && (threadIdx.x == 0 || threadIdx.x == lastwarp)) {
        unsigned* o = out + (threadIdx.x == lastwarp ? 6 : 0);
#pragma unroll
        for (int k = 0; k < 5; ++k) o[k] = sum[k];
        o[5] = picks;
      }
      return;
    }
    if (phase != 0 || picks > 0) sum[phase] += now - prev;
    if (phase == 0) ++picks;
    prev = now;
  }
};

// Chains of one primitive, `rounds` long, each step depending on the last;
// block 0's thread 0 writes the cycles. kind 0: __reduce_max_sync; 1: a
// shared load whose address is the last load's value; 2: __syncthreads.
__global__ void latency_kernel(int kind, int rounds, unsigned* out,
                               long long* cycles) {
  __shared__ unsigned chase[kMaxThreads];
  chase[threadIdx.x] = (threadIdx.x + 1) % blockDim.x;
  __syncthreads();
  unsigned v = threadIdx.x;
  const long long t0 = clock64();
  for (int s = 0; s < rounds; ++s) {
    if (kind == 0) {
      v = __reduce_max_sync(0xffffffffu, v) + s;
    } else if (kind == 1) {
      v = chase[v];
    } else {
      __syncthreads();
      v += s;
    }
  }
  const long long t1 = clock64();
  out[blockIdx.x * blockDim.x + threadIdx.x] = v;
  if (threadIdx.x == 0 && blockIdx.x == 0) cycles[0] = t1 - t0;
}

__global__ void empty_rounds_kernel(int m, unsigned* out,
                                    long long* cycles) {
  __shared__ uint2 slot[2][kMaxThreads / 32];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int warps = blockDim.x >> 5;
  unsigned last = threadIdx.x;
  const long long t0 = clock64();
  for (int s = 1; s < m; ++s) {
    if (lane == 0) slot[s & 1][warp] = make_uint2(last, last + s);
    __syncthreads();
    const uint2 v = slot[s & 1][lane < warps ? lane : 0];
    const unsigned key = __reduce_max_sync(0xffffffffu, v.x);
    last = __reduce_min_sync(0xffffffffu, v.x == key ? v.y : 0xffffffffu);
  }
  const long long t1 = clock64();
  if (threadIdx.x == 0) {
    out[blockIdx.x] = last;
    if (blockIdx.x == 0) cycles[0] = t1 - t0;
  }
}

}  // namespace

// K1 on plan (threads, p) with block 0's phase sums written to stamps (12
// u32: thread 0's cycles of the tail, update, warp argmax, barrier and fold
// over the picks, then the picks; the same for the last warp's lane 0; the
// barrier's sum is 0 on one warp).
LION_EXPORT int lion_fps_probe(const void* xyz, void* idx, void* centers,
                               int b, int n, int m, int threads, int p,
                               void* stamps, void* stream) {
  return launch_plan(xyz, idx, centers, b, n, m, threads, p,
                     ClockStamp{static_cast<unsigned*>(stamps), {}, 0u, 0u},
                     static_cast<cudaStream_t>(stream));
}

// B blocks of `threads` threads run a chain of `rounds` steps of primitive
// `kind` (latency_kernel); out (B * threads) u32, cycles (1) int64.
LION_EXPORT int lion_fps_latency(int kind, int b, int threads, int rounds,
                                 void* out, void* cycles, void* stream) {
  latency_kernel<<<b, threads, 0, static_cast<cudaStream_t>(stream)>>>(
      kind, rounds, static_cast<unsigned*>(out),
      static_cast<long long*>(cycles));
  return static_cast<int>(cudaGetLastError());
}

// K1 on plan (threads, p) without stamps: the plan's own time.
LION_EXPORT int lion_fps_on_plan(const void* xyz, void* idx, void* centers,
                                 int b, int n, int m, int threads, int p,
                                 void* stream) {
  return launch_plan(xyz, idx, centers, b, n, m, threads, p, NoStamp{},
                     static_cast<cudaStream_t>(stream));
}

// B blocks of `threads` threads run M - 1 empty rounds; out (B) u32, cycles
// (1) int64: block 0's cycles over its rounds.
LION_EXPORT int lion_fps_empty_rounds(int b, int threads, int m, void* out,
                                      void* cycles, void* stream) {
  empty_rounds_kernel<<<b, threads, 0, static_cast<cudaStream_t>(stream)>>>(
      m, static_cast<unsigned*>(out), static_cast<long long*>(cycles));
  return static_cast<int>(cudaGetLastError());
}

// K1's plan for N points: returns P and sets *threads (0: N too large).
LION_EXPORT int lion_fps_plan(int n, int* threads) {
  return fps_plan(n, threads);
}

// Device code of the halo-brick 3x3x3 convolutions: K4 (fp32 and bf16) and
// K10 (csrc/conv3d.cu), K8 (csrc/conv3d_pair.cu) and K9 (csrc/pvblock.cu),
// the port's only 3x3x3 conv design. The bf16 tile (BrickTileWgmma) takes a
// prologue (BrickPrologue, applied as the brick lands; its scale and shift
// may lie in global or shared memory) and hands its accumulators to a store
// that takes the statistics; fold_gn turns a conv's statistics into the
// next conv's prologue (K8, K9).
//
// The statistics are summed in a fixed order, so a conv repeats bit for bit:
// each warp (or warpgroup) writes its channels' partial (sum, sumsq) to its
// own slot, the block sums the slots in slot order into its partial in a
// global scratch, and the last block of each (item, channel tile), found by
// an integer ticket, sums the bricks' partials in a fixed tree into stats
// and resets the ticket (flush_stats). No float is added with atomics.
//
// A block owns a brick of BD x BH x BW output voxels of one item and BN
// output channels. For each chunk of KC input channels it stages the brick's
// input with its one-voxel halo, (BD+2) x (BH+2) x (BW+2) cells of KC
// channels, into shared memory once: 16-byte cp.async copies whose source
// size is 0 outside the grid fill the halo (and channels past Ci) with zeros,
// then one pass applies the prologue to the in-grid cells only (pro(0) is
// not 0, so the halo is masked by coordinate, not by value). Rows whose
// channel count is not a multiple of 16 bytes are staged element by element
// with the prologue applied on the way. The 27 taps are then address offsets
// into the brick: a tap moves every voxel row by the same number of cells.
// The weights of TAPS taps x KC channels x BN outputs are staged per step,
// double-buffered behind the current step's products, and the next chunk's
// halo brick lands in a second buffer behind the current chunk's 27 taps.
//
// fp32 shared-memory rows are padded to an odd number of 16-byte units, so
// 8 rows that are consecutive voxels fall on 8 different bank groups; the
// bf16 operands lie in 8 x 8 core matrices of 128 contiguous bytes, the
// layout wgmma reads without conflicts.
#pragma once

#include <type_traits>

#include "common.cuh"



namespace lion {

// What the C entry passes by value: the operands, the sizes and the plan
// (ops/conv3d.py: conv_plan).
struct BrickConv {
  const void* x;        // (B, r, r, r, ci), T
  const void* w;        // (27, ci, ldw), T, columns past co zero
  const float* scale;   // (B, ci) or null: no affine prologue
  const float* shift;
  void* y;              // (B, r, r, r, co), T
  float* stats;         // (B, 2, co) or null: written by flush_stats
  float* part;          // (B, bricks, 2, co): the blocks' partials
  int* tickets;         // (B, channel tiles), zero between launches
  int r, ci, co, ldw;
  int bd, bh, bw;       // the brick
  int nbh, nbw;         // bricks along h and w
  int kc, taps;         // channels per chunk, taps per weight stage
  int hpitch, wpitch;   // shared-memory row pitches in elements
  int swish;
};

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// 16-byte asynchronous copy; invalid: 16 zero bytes, nothing read.
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(valid ? 16 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}
// Make this thread's shared-memory writes visible to wgmma's operand reads.
__device__ __forceinline__ void fence_async_proxy() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// swish?(v * scale[ch] + shift[ch]) (scale == nullptr: no affine), swish
// by the fast exp and divide (a few ulp of float32; v / inf gives 0).
// scale and shift are generic pointers: global (K4, K8's fold) or shared
// (K9's fold).
struct BrickPrologue {
  const float* scale;
  const float* shift;
  bool swish;
  __device__ bool active() const { return scale != nullptr || swish; }
  __device__ float operator()(int ch, float v) const {
    if (scale != nullptr) v = v * scale[ch] + shift[ch];
    return swish ? __fdividef(v, 1.0f + __expf(-v)) : v;
  }
};

// The GroupNorm fold of the TPU conv pair (conv3d_packed.py:537-562), the
// same as ops/conv3d.py: gn_affine_from_stats: from the (sum, sumsq) s1/s2
// of conv0's rounded output over `count` voxels, with conv0's bias b0 added
// before the norm and the post-norm channel affine (ca, cb), the
// per-channel (sc, bi) with which conv1 reads swish(y0 * sc + bi). Groups of
// 8, var = E[x^2] - mean^2 clamped at 0, eps 1e-5. Each thread folds its
// channels on its own (no shared scratch); the caller publishes sc / bi
// with a barrier.
__device__ __forceinline__ void fold_gn(const float* s1, const float* s2,
                                        const float* b0, const float* ca,
                                        const float* cb, int c, float count,
                                        float* sc, float* bi) {
  const int cg = c / 8;
  for (int ch = threadIdx.x; ch < c; ch += blockDim.x) {
    const int g0 = (ch / cg) * cg;
    float mu = 0.0f, ex2 = 0.0f;
    for (int j = g0; j < g0 + cg; ++j) {
      const float m1 = s1[j] / count;
      mu += m1 + b0[j];
      ex2 += s2[j] / count + 2.0f * b0[j] * m1 + b0[j] * b0[j];
    }
    mu /= cg;
    ex2 /= cg;
    const float rs = __frsqrt_rn(fmaxf(ex2 - mu * mu, 0.0f) + 1e-5f);
    sc[ch] = rs * ca[ch];
    bi[ch] = (b0[ch] - mu) * rs * ca[ch] + cb[ch];
  }
}

// The block's brick: its item, origin and first output channel.
struct Brick {
  int b, d0, h0, w0, n0;
  int hh, hw, cells;  // halo extents along h and w, halo cells
  // brick `bx` (d-major) of item `item`, output channels from n0
  __device__ Brick(const BrickConv& p, int bx, int n0_, int item) {
    const int iw = bx % p.nbw;
    bx /= p.nbw;
    const int ih = bx % p.nbh;
    const int id = bx / p.nbh;
    b = item;
    d0 = id * p.bd;
    h0 = ih * p.bh;
    w0 = iw * p.bw;
    n0 = n0_;
    hh = p.bh + 2;
    hw = p.bw + 2;
    cells = (p.bd + 2) * hh * hw;
  }
  // the grid's block: (bricks, output-channel tiles of bn, items)
  __device__ Brick(const BrickConv& p, int bn)
      : Brick(p, blockIdx.x, blockIdx.y * bn, blockIdx.z) {}
  // grid coordinates of halo cell `cell`; true if inside the grid
  __device__ bool cell_in_grid(int cell, int r, int& gd, int& gh,
                               int& gw) const {
    const int cw = cell % hw;
    const int t = cell / hw;
    gd = d0 - 1 + t / hh;
    gh = h0 - 1 + t % hh;
    gw = w0 - 1 + cw;
    return static_cast<unsigned>(gd) < static_cast<unsigned>(r) &&
           static_cast<unsigned>(gh) < static_cast<unsigned>(r) &&
           static_cast<unsigned>(gw) < static_cast<unsigned>(r);
  }
  // the halo cell of brick voxel v with the tap (-1, -1, -1)
  __device__ int row_of(const BrickConv& p, int v) const {
    const int vw = v % p.bw;
    const int t = v / p.bw;
    return ((t / p.bh) * hh + t % p.bh) * hw + vw;
  }
  __device__ bool voxel_in_grid(const BrickConv& p, int v, size_t& idx) const {
    const int gw = w0 + v % p.bw;
    const int t = v / p.bw;
    const int gh = h0 + t % p.bh, gd = d0 + t / p.bh;
    idx = (static_cast<size_t>(gd) * p.r + gh) * p.r + gw;
    return gd < p.r && gh < p.r && gw < p.r;
  }
};

// log2 of a power of two
__device__ __forceinline__ int log2i(int n) { return __ffs(n) - 1; }

// Where channel c (of the chunk) of halo cell i lies in a staged chunk: rows
// of hpitch (kCore false), or blocks of 8 channels, each block the cells'
// 16-byte rows one after another (kCore true: 8 consecutive cells are one
// 8 x 8 core matrix of a K-major wgmma operand).
template <bool kCore>
__device__ __forceinline__ int halo_at(const BrickConv& p, const Brick& k,
                                       int i, int c) {
  return kCore ? (c >> 3) * k.cells * 8 + i * 8 + (c & 7) : i * p.hpitch + c;
}

// Stage channels [c0, c0 + kc) of the halo brick into dst (halo_at).
// cell[i] is halo cell i's voxel in the item's grid, or -1 outside it. The
// 16-byte path leaves the prologue to prologue_pass; the element path
// applies it here.
template <bool kCore, typename T>
__device__ void stage_halo(const BrickConv& p, const Brick& k, const int* cell,
                           int c0, T* dst, const BrickPrologue& pro) {
  constexpr int V = 16 / sizeof(T);
  const size_t r3 = static_cast<size_t>(p.r) * p.r * p.r;
  const T* x = static_cast<const T*>(p.x) + k.b * r3 * p.ci;
  const bool vec = p.ci % V == 0;
  const int per = vec ? p.kc / V : p.kc;  // items per cell, a power of two
  const int lg = log2i(per);
  for (int e = threadIdx.x; e < k.cells * per; e += blockDim.x) {
    const int i = e >> lg;
    const int c = c0 + (e & (per - 1)) * (vec ? V : 1);
    const int vox = cell[i];
    const bool in = vox >= 0 && c < p.ci;
    const T* src = x + (in ? static_cast<size_t>(vox) * p.ci + c : 0);
    T* at = dst + halo_at<kCore>(p, k, i, c - c0);
    if (vec) {
      cp_async16(at, src, in);
    } else {
      store(at, in ? pro(c, to_float(*src)) : 0.0f);
    }
  }
}

// The prologue over the in-grid cells of a staged chunk, in place, rounded
// to T (the halo and the channels past ci stay 0).
template <bool kCore, typename T>
__device__ void prologue_pass(const BrickConv& p, const Brick& k,
                              const int* cell, int c0, T* buf,
                              const BrickPrologue& pro) {
  constexpr int V = 16 / sizeof(T);
  const int per = p.kc / V;
  const int lg = log2i(per);
  for (int e = threadIdx.x; e < k.cells * per; e += blockDim.x) {
    const int i = e >> lg;
    const int c = c0 + (e & (per - 1)) * V;
    if (cell[i] < 0 || c >= p.ci) continue;
    uint4* q =
        reinterpret_cast<uint4*>(buf + halo_at<kCore>(p, k, i, c - c0));
    uint4 raw = *q;
    T* v = reinterpret_cast<T*>(&raw);
#pragma unroll
    for (int j = 0; j < V; ++j) store(v + j, pro(c + j, to_float(v[j])));
    *q = raw;
  }
}

// Stage the weights of taps [tap0, tap0 + taps) x channels [c0, c0 + kc) x
// outputs [n0, n0 + bn) into dst: rows of wpitch (kCore false), or 8 x 8
// core matrices of 128 contiguous bytes, (k / 8, n / 8) at ((k / 8) * bn / 8
// + n / 8) * 128 bytes, as wgmma reads an MN-major operand without swizzle
// (kCore true). A thread keeps one 16-byte column and walks the rows
// blockDim / (bn / V) at a time.
template <bool kCore = false, typename T>
__device__ void stage_weights(const BrickConv& p, const Brick& k, int bn,
                              int c0, int tap0, T* dst) {
  constexpr int V = 16 / sizeof(T);
  const T* w = static_cast<const T*>(p.w);
  const int pieces = bn / V;
  const int step = blockDim.x / pieces;  // rows per pass
  const int col = (threadIdx.x % pieces) * V;
  const int n = k.n0 + col;
  const int rows = p.taps * p.kc;
  int row = threadIdx.x / pieces;
  int t = row / p.kc, kk = row - t * p.kc;  // row = t * kc + kk
  const int dt = step / p.kc, dk = step - dt * p.kc;
  for (; row < rows; row += step) {
    const int c = c0 + kk;
    const bool valid = c < p.ci && n < p.ldw;
    const T* src =
        w + (valid ? (static_cast<size_t>(tap0 + t) * p.ci + c) * p.ldw + n
                   : 0);
    const int at = kCore ? ((row >> 3) * (bn >> 3) + col / 8) * 64 +
                               (row & 7) * 8
                         : row * p.wpitch + col;
    cp_async16(dst + at, src, valid);
    t += dt;
    kk += dk;
    if (kk >= p.kc) {
      kk -= p.kc;
      ++t;
    }
  }
}

// The staging pipeline of one block over its chunks and weight steps.
// step(halo, weights, tap0) runs the products of taps [tap0, tap0 + taps)
// of one chunk; smem holds min(2, chunks) halo buffers, min(2, steps)
// weight buffers and the halo cells' voxel table. One barrier per step (two
// at a chunk's first step when the prologue pass runs).
template <bool kCore = false, typename T, class Step>
__device__ __forceinline__ void brick_pipeline(const BrickConv& p,
                                               const Brick& k, int bn,
                                               const BrickPrologue& pro,
                                               T* smem, Step&& step) {
  constexpr int V = 16 / sizeof(T);
  const int chunks = (p.ci + p.kc - 1) / p.kc;
  const int per_chunk = 27 / p.taps;
  const int total = chunks * per_chunk;
  const bool pass = p.ci % V == 0 && pro.active();
  const int hsize = k.cells * p.hpitch;
  const int wsize = p.taps * p.kc * p.wpitch;
  T* const wbase = smem + (chunks > 1 ? 2 : 1) * hsize;
  int* const cell =
      reinterpret_cast<int*>(wbase + (total > 1 ? 2 : 1) * wsize);
  // buffer i of each ring (pointer arithmetic, not an indexed array,
  // keeps them in registers)
  auto hbuf = [&](int i) { return smem + (i & 1) * hsize; };
  auto wbuf = [&](int i) { return wbase + (i & 1) * wsize; };

  for (int i = threadIdx.x; i < k.cells; i += blockDim.x) {
    int gd, gh, gw;
    cell[i] = k.cell_in_grid(i, p.r, gd, gh, gw) ? (gd * p.r + gh) * p.r + gw
                                                 : -1;
  }
  __syncthreads();
  stage_halo<kCore>(p, k, cell, 0, hbuf(0), pro);
  stage_weights<kCore>(p, k, bn, 0, 0, wbuf(0));
  cp_async_commit();
  for (int s = 0; s < total; ++s) {
    const int c = s / per_chunk;
    const int t = s - c * per_chunk;
    cp_async_wait_all();
    if (kCore) fence_async_proxy();
    __syncthreads();  // this step's data landed; step s - 1 is done
    if (t == 0 && pass) {
      prologue_pass<kCore>(p, k, cell, c * p.kc, hbuf(c), pro);
      if (kCore) fence_async_proxy();
      __syncthreads();
    }
    if (s + 1 < total) {
      const int cn = (s + 1) / per_chunk;
      stage_weights<kCore>(p, k, bn, cn * p.kc,
                           (s + 1 - cn * per_chunk) * p.taps, wbuf(s + 1));
    }
    if (t == 0 && c + 1 < chunks)
      stage_halo<kCore>(p, k, cell, (c + 1) * p.kc, hbuf(c + 1), pro);
    cp_async_commit();
    step(hbuf(c), wbuf(s), t * p.taps);
  }
}

// The halo-cell offset of tap (kd, kh, kw), tap = 9 kd + 3 kh + kw.
__device__ __forceinline__ int tap_offset(const Brick& k, int tap) {
  return ((tap / 9) * k.hh + (tap / 3) % 3) * k.hw + tap % 3;
}

// ------------------------------------------------------------------ bf16
// Hopper's warpgroup MMA with both operands read from shared memory through
// descriptors, the output channels as M and the voxels as N: y^T (BN x
// voxels) = w^T (BN x K) * x (K x voxels). A = the staged weights in 8 x 8
// core matrices, MN-major (stage_weights<true>); B = the halo brick in
// K-major core matrices (halo_at<true>): 8 consecutive cells along w are
// one core matrix, and the brick's h rows, hw cells apart, are the next 8
// voxels of N. A tap is then a start address 16 * (tap offset) bytes
// further into the brick: no fragment is loaded into registers, and a
// weight stage's wgmmas (taps x kc / 16 slices x planes x m64 tiles) issue
// back to back with one commit and one wait.

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

// Descriptor of a no-swizzle operand in shared memory: its start address,
// the byte step between core matrices along K and along M or N.
__device__ __forceinline__ unsigned long long wgmma_desc(unsigned addr,
                                                         unsigned k_step,
                                                         unsigned mn_step) {
  return static_cast<unsigned long long>((addr & 0x3FFFF) >> 4) |
         static_cast<unsigned long long>(k_step >> 4) << 16 |
         static_cast<unsigned long long>(mn_step >> 4) << 32;
}

// d (64 x 64 f32, this thread's 32) += A (64 x 16, MN-major: transposed) *
// B (16 x 64, K-major).
__device__ __forceinline__ void wgmma_m64n64(float (&d)[32],
                                             unsigned long long a,
                                             unsigned long long b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, 1, 0;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "l"(a), "l"(b), "r"(1));
}

// A block of two warpgroups over a brick of 2 PD planes (d) of 8 x 8 voxels
// (h, w) by 64 output channels (one m64 tile): warpgroup g owns planes
// [g PD, g PD + PD), each plane one m64n64 accumulator. acc[pd][4 j + e]
// holds channel 16 (warp % 4) + lane / 4 + 8 (e / 2) of voxel (h = j,
// w = 2 (lane % 4) + e % 2).
template <int PD>
struct BrickTileWgmma {
  static constexpr int kBn = 64;
  float acc[PD][32];

  __device__ BrickTileWgmma() {
#pragma unroll
    for (int pd = 0; pd < PD; ++pd)
#pragma unroll
      for (int e = 0; e < 32; ++e) acc[pd][e] = 0.0f;
  }

  // The wgmmas of one weight stage.
  __device__ __forceinline__ void step(const BrickConv& p, const Brick& k,
                                       const bf16* h, const bf16* w,
                                       int tap0) {
    const unsigned hb = smem_addr(h), wb = smem_addr(w);
    const unsigned hk = k.cells * 16;  // halo bytes per 8 channels
    constexpr unsigned kWk = kBn / 8 * 128;  // weight bytes per 8 rows
    const int plane0 = (threadIdx.x >> 7) * PD;
    const int ks = p.kc >> 4;
    wgmma_fence();
    for (int tt = 0; tt < p.taps; ++tt) {
      const int off = tap_offset(k, tap0 + tt);
      for (int kk = 0; kk < ks; ++kk) {
        const unsigned long long a =
            wgmma_desc(wb + (tt * ks + kk) * 2 * kWk, kWk, 128);
#pragma unroll
        for (int pd = 0; pd < PD; ++pd) {
          const int cell = (plane0 + pd) * k.hh * k.hw + off;
          const unsigned long long b =
              wgmma_desc(hb + kk * 2 * hk + cell * 16, hk, k.hw * 16);
          wgmma_m64n64(acc[pd], a, b);
        }
      }
    }
    wgmma_commit();
    wgmma_wait_all();  // the buffers are free for the next stage
  }

  // Slots of the statistics: one per warpgroup. Each of its 4 warps owns
  // 16 of the 64 channels, and one lane of the warp each channel's sums.
  static constexpr int kSlots = 2;

  // Round to bf16 and store the in-grid voxels' channels < co of y; if
  // `stats`, write each channel's (sum, sumsq) of the rounded values over
  // this warpgroup's planes to slots[warpgroup] (2 kBn floats: sums, then
  // sumsqs). The slots reuse the staging buffers: the call waits for every
  // warp to leave them.
  __device__ __forceinline__ void store(const BrickConv& p, const Brick& k,
                                        float* slots, bool stats) const {
    const int lane = threadIdx.x & 31;
    const int m0 = 16 * ((threadIdx.x >> 5) & 3) + (lane >> 2);
    const int plane0 = (threadIdx.x >> 7) * PD;
    bf16* y = static_cast<bf16*>(p.y) +
              static_cast<size_t>(k.b) * p.r * p.r * p.r * p.co;
    float s[2] = {0.0f, 0.0f}, sq[2] = {0.0f, 0.0f};
#pragma unroll
    for (int pd = 0; pd < PD; ++pd) {
      const int gd = k.d0 + plane0 + pd;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int gh = k.h0 + j;
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int gw = k.w0 + 2 * (lane & 3) + (e & 1);
          const int ch = k.n0 + m0 + 8 * (e >> 1);
          const bf16 hv = __float2bfloat16_rn(acc[pd][4 * j + e]);
          if (gd < p.r && gh < p.r && gw < p.r && ch < p.co) {
            y[((static_cast<size_t>(gd) * p.r + gh) * p.r + gw) * p.co +
              ch] = hv;
            const float f = __bfloat162float(hv);
            s[e >> 1] += f;
            sq[e >> 1] += f * f;
          }
        }
      }
    }
    if (!stats) return;
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
#pragma unroll
      for (int m = 1; m < 4; m <<= 1) {
        s[hf] += __shfl_xor_sync(0xffffffffu, s[hf], m);
        sq[hf] += __shfl_xor_sync(0xffffffffu, sq[hf], m);
      }
    }
    __syncthreads();  // no warp reads the staged buffers any more
    float* slot = slots + (threadIdx.x >> 7) * 2 * kBn;
    if ((lane & 3) == 0) {
#pragma unroll
      for (int hf = 0; hf < 2; ++hf) {
        slot[m0 + 8 * hf] = s[hf];
        slot[kBn + m0 + 8 * hf] = sq[hf];
      }
    }
  }
};

// Value i of the block's statistics: the slots' values i summed in slot
// order (each slot `stride` floats), after a barrier that follows the
// slots' writes.
__device__ __forceinline__ float slot_sum(const float* slots, int nslots,
                                          int stride, int i) {
  float v = 0.0f;
  for (int j = 0; j < nslots; ++j) v += slots[j * stride + i];
  return v;
}

// The block's (sum, sumsq) of its bn channels from `nslots` slots of
// 2 bn floats (the tile's store wrote them) into stats[b], in a fixed order
// whichever block comes last. The block writes the slots' sum in slot order
// to its partial part[b][brick]; the item's channel tile takes a ticket per
// block, and the block that takes the last one sums the tile's partials:
// thread (value, slice) sums bricks slice, slice + slices, ... in order, then
// the slices are summed in order. It writes stats[b] and resets the ticket,
// so the tickets are zero again when the launch ends (K7's merge,
// csrc/sa_fused.cu). Grid: (bricks, channel tiles, items). The slots are
// the merge's scratch afterwards (they hold blockDim floats at least).
__device__ __forceinline__ void flush_stats(const BrickConv& p,
                                            const Brick& k, int bn,
                                            float* slots, int nslots) {
  __shared__ int s_last;
  const int vals = 2 * bn;
  const int bricks = gridDim.x;
  const int nch = min(bn, p.co - k.n0);
  const size_t row = 2 * static_cast<size_t>(p.co);  // a partial's floats
  float* part = p.part + static_cast<size_t>(k.b) * bricks * row + k.n0;
  __syncthreads();  // the slots are written
  for (int i = threadIdx.x; i < vals; i += blockDim.x)
    if (i % bn < nch)
      part[blockIdx.x * row + (i / bn) * p.co + i % bn] =
          slot_sum(slots, nslots, vals, i);
  __threadfence();
  __syncthreads();
  int* ticket = p.tickets + k.b * gridDim.y + blockIdx.y;
  if (threadIdx.x == 0) s_last = atomicAdd(ticket, 1) == bricks - 1;
  __syncthreads();
  if (!s_last) return;
  __threadfence();
  const int slices = blockDim.x / vals;
  const int i = threadIdx.x % vals, sl = threadIdx.x / vals;
  const bool mine = i % bn < nch;
  if (sl < slices && mine) {
    const float* src = part + (i / bn) * p.co + i % bn;
    float v = 0.0f;
    // unrolled: eight loads from L2 in flight, the adds still in order
#pragma unroll 8
    for (int j = sl; j < bricks; j += slices) v += __ldcg(src + j * row);
    slots[threadIdx.x] = v;
  }
  __syncthreads();
  if (sl == 0 && mine) {
    p.stats[static_cast<size_t>(k.b) * row + (i / bn) * p.co + k.n0 +
            i % bn] = slot_sum(slots, slices, vals, i);
  }
  if (threadIdx.x == 0) *ticket = 0;
}

// One bf16 block of a brick conv: stage, multiply, store y and, if
// `stats`, write each warpgroup's (sum, sumsq) per channel of the rounded y
// to its slot, at the start of smem (BrickTileWgmma::store). The core of
// K4's and K8's kernels (brick_conv_bf16) and of K9's two convs.
template <int PD>
__device__ __forceinline__ void brick_conv_block(const BrickConv& p,
                                                 const Brick& k,
                                                 const BrickPrologue& pro,
                                                 bf16* smem, bool stats) {
  BrickTileWgmma<PD> tile;
  brick_pipeline<true>(p, k, BrickTileWgmma<PD>::kBn, pro, smem,
                       [&](const bf16* h, const bf16* w, int tap0) {
                         tile.step(p, k, h, w, tap0);
                       });
  tile.store(p, k, reinterpret_cast<float*>(smem), stats);
}

// One bf16 block of a brick conv on the grid (bricks, channel tiles,
// items): brick_conv_block, then the statistics into p.stats (if not
// null). The body of K4's bf16 kernel and of K8's two.
template <int PD>
__device__ __forceinline__ void brick_conv_bf16(const BrickConv& p,
                                                const BrickPrologue& pro,
                                                void* smem) {
  using Tile = BrickTileWgmma<PD>;
  const Brick k(p, Tile::kBn);
  brick_conv_block<PD>(p, k, pro, static_cast<bf16*>(smem),
                       p.stats != nullptr);
  if (p.stats != nullptr)
    flush_stats(p, k, Tile::kBn, static_cast<float*>(smem), Tile::kSlots);
}

// Launch `kernel` with `smem` bytes of dynamic shared memory.
template <class Kernel, class... Args>
int launch_smem(Kernel kernel, dim3 grid, int threads, int smem,
                cudaStream_t s, const Args&... args) {
  const cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  kernel<<<grid, threads, smem, s>>>(args...);
  return static_cast<int>(cudaGetLastError());
}

template <int N>
using Int = std::integral_constant<int, N>;

// go(Int<PD>, Int<min blocks per SM>) for the plan's bf16 tile (the
// compiled pairs of ops/conv3d.py: _BF16_TILES; two blocks per SM only
// where the accumulators, 32 PD a thread, fit in 128 registers).
template <class Go>
int dispatch_bf16(int bn, int tile, int min_blocks, Go&& go) {
  if (bn != 64) return static_cast<int>(cudaErrorInvalidValue);
  switch (tile * 4 + min_blocks) {
    case 4 * 4 + 1: return go(Int<4>{}, Int<1>{});
    case 2 * 4 + 1: return go(Int<2>{}, Int<1>{});
    case 2 * 4 + 2: return go(Int<2>{}, Int<2>{});
    case 1 * 4 + 1: return go(Int<1>{}, Int<1>{});
    case 1 * 4 + 2: return go(Int<1>{}, Int<2>{});
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

// ------------------------------------------------------------------ fp32
// Exact fp32 FFMA. 256 threads: BN / 8 along the channels, 2048 / BN along
// the voxels. A thread owns a run of TV voxels consecutive along w (the
// plan keeps TV | BW) by 8 channels (two runs of 4, BN / 2 apart). The
// three taps that differ only in kw read the run's rows shifted by one
// cell, so per 4 input channels a thread loads TV + 2 row float4s and
// 2 x 3 x 4 weight float4s for 3 x TV x 8 x 4 FMAs (at TV = 8, 768 FMAs
// per 34 16-byte loads). Lanes of one run share its row loads (broadcast);
// the lanes of one voxel read 8 consecutive 16-byte pieces of a weight row.
template <int BN, int TV>
struct BrickTileF32 {
  static constexpr int kTn = BN / 8;
  static constexpr int kTv = 256 / kTn;
  float acc[TV][8];
  int row0;  // the halo cell of the run's first voxel
  int tn, tv;

  __device__ BrickTileF32(const BrickConv& p, const Brick& k) {
    tn = threadIdx.x % kTn;
    tv = threadIdx.x / kTn;
    row0 = k.row_of(p, tv * TV);
#pragma unroll
    for (int j = 0; j < TV; ++j)
#pragma unroll
      for (int e = 0; e < 8; ++e) acc[j][e] = 0.0f;
  }

  __device__ __forceinline__ void step(const BrickConv& p, const Brick& k,
                                       const float* h, const float* w,
                                       int tap0) {
    for (int g = 0; g < p.taps; g += 3) {  // taps (kd, kh, 0..2)
      const float* ht = h + (row0 + tap_offset(k, tap0 + g)) * p.hpitch;
      const float* wt = w + g * p.kc * p.wpitch + 4 * tn;
      for (int c = 0; c < p.kc; c += 4) {
        float4 a[TV + 2];
#pragma unroll
        for (int j = 0; j < TV + 2; ++j)
          a[j] = *reinterpret_cast<const float4*>(ht + j * p.hpitch + c);
#pragma unroll
        for (int kw = 0; kw < 3; ++kw) {
#pragma unroll
          for (int kk = 0; kk < 4; ++kk) {
            const float* wr = wt + (kw * p.kc + c + kk) * p.wpitch;
            const float4 b0 = *reinterpret_cast<const float4*>(wr);
            const float4 b1 = *reinterpret_cast<const float4*>(wr + BN / 2);
#pragma unroll
            for (int j = 0; j < TV; ++j) {
              const float4& aj = a[j + kw];
              const float av = kk == 0   ? aj.x
                               : kk == 1 ? aj.y
                               : kk == 2 ? aj.z
                                         : aj.w;
              acc[j][0] = fmaf(av, b0.x, acc[j][0]);
              acc[j][1] = fmaf(av, b0.y, acc[j][1]);
              acc[j][2] = fmaf(av, b0.z, acc[j][2]);
              acc[j][3] = fmaf(av, b0.w, acc[j][3]);
              acc[j][4] = fmaf(av, b1.x, acc[j][4]);
              acc[j][5] = fmaf(av, b1.y, acc[j][5]);
              acc[j][6] = fmaf(av, b1.z, acc[j][6]);
              acc[j][7] = fmaf(av, b1.w, acc[j][7]);
            }
          }
        }
      }
    }
  }

  // Slots of the statistics: one per warp (each warp covers all BN
  // channels).
  static constexpr int kSlots = 8;

  // Store the in-grid voxels' channels < co of y (float4 where co % 4 ==
  // 0) and, if `stats`, write each channel's (sum, sumsq) over this warp's
  // voxels to slots[warp] (2 BN floats: sums, then sumsqs). The slots
  // reuse the staging buffers: the call waits for every warp to leave them.
  __device__ __forceinline__ void store(const BrickConv& p, const Brick& k,
                                        float* slots, bool stats) const {
    float* y = static_cast<float*>(p.y) +
               static_cast<size_t>(k.b) * p.r * p.r * p.r * p.co;
    const bool vec = p.co % 4 == 0;
    float s[8] = {}, sq[8] = {};
#pragma unroll
    for (int j = 0; j < TV; ++j) {
      size_t idx;
      if (!k.voxel_in_grid(p, tv * TV + j, idx)) continue;
      float* yr = y + idx * p.co;
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int ch = k.n0 + half * (BN / 2) + 4 * tn;
        const float* v = acc[j] + 4 * half;
        if (vec && ch < p.co) {
          *reinterpret_cast<float4*>(yr + ch) =
              make_float4(v[0], v[1], v[2], v[3]);
        } else {
#pragma unroll
          for (int e = 0; e < 4; ++e)
            if (ch + e < p.co) yr[ch + e] = v[e];
        }
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          s[4 * half + e] += v[e];
          sq[4 * half + e] += v[e] * v[e];
        }
      }
    }
    if (!stats) return;
    const int lane = threadIdx.x & 31;
#pragma unroll
    for (int e = 0; e < 8; ++e) {
#pragma unroll
      for (int m = kTn; m < 32; m <<= 1) {
        s[e] += __shfl_xor_sync(0xffffffffu, s[e], m);
        sq[e] += __shfl_xor_sync(0xffffffffu, sq[e], m);
      }
    }
    static_assert(256 / 32 == kSlots, "one slot per warp");
    __syncthreads();  // no warp reads the staged buffers any more
    float* slot = slots + (threadIdx.x >> 5) * 2 * BN;
    if (lane < kTn) {
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        const int c = (e / 4) * (BN / 2) + 4 * tn + e % 4;
        slot[c] = s[e];
        slot[BN + c] = sq[e];
      }
    }
  }
};

}  // namespace lion

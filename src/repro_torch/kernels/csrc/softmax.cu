// Whole-row CORDIC softmax and log-softmax on Hopper.
//
// Replaces softmax_2d of repro/kernels/softmax_cordic.py (:161; _rowwise_call
// :138, pallas_call :150, body _softmax_kernel :57): masked row max, dyadic
// reduction u = k ln2 + r, Q2.14 cosh+sinh rotation for e^r, row sum,
// exponent-field frexp of the sum, R2-LVC normalisation; lanes more than
// e^-20 below the row max are exactly 0.
//
// The row sum takes jitted XLA:CPU's order over the row padded to cols_p =
// max(128, ceil(cols / 128) * 128) lanes, as the JAX kernel sums it
// (softmax_cordic._xla_row_sum): windows of 32 lanes summed left to right,
// then windows of 32 window sums with floor(p/2) zeros in front, until at
// most 32 remain, summed left to right. Padded lanes add exact zeros, so
// only the real lanes are computed. Kernel, plain version and JAX kernel
// agree bit for bit.
//
// What bounds it: integer operations. In a 16-bit format (kTab) the e^r
// stage is one load from the card's exp-code table (code_tables.py, read
// through L1) and each lane keeps its codes (eq, k, dead) from the sum pass
// for the normalisation, so a lane costs its boundary ops and the 14-stage
// LVC divide (two operands, on the pipeline), ~130 INT32 operations, against
// 8 bytes; a dead lane (a masked tail, most of a long causal row) skips the
// divide, whose result it would discard. Wider formats rotate a lane twice,
// once per pass, as the TPU kernel does.
//
// Design, by row width, each kernel persistent (a CTA loops over rows):
// softmax_kernel_rows takes a row per warp (up to kWarpCols lanes, at most
// 32 windows): lane l computes the lanes 32 j + l, their e^u into one 32 x
// 33 tile in shared memory and their codes into another, so lane w sums
// window w left to right with one load and one add a lane (the window sum is
// the function's one serial chain), and a shuffle chain adds the window sums
// left to right. (A row per lane, for rows of one window, ran 1.7x slower
// than this: 8192 threads leave the card's latency exposed.)
// softmax_kernel_wide takes a row per CTA: each warp sums the windows of its
// 1024-lane chunks the same way, then one warp runs the later levels; the
// lanes' packed codes wait in the output row until the normalisation
// overwrites them.
//
// cordic_log_softmax_2d replaces log_softmax_2d of the same file (:171; body
// _log_softmax_kernel :93): the same max and exp sweeps and the same row-sum
// order, then ln S of the row sum by the hyperbolic-vectoring log leg (once
// per row), and y = (x - max) - ln S; lanes masked with -1e30 keep their
// huge negative value. What bounds it: HBM bytes on the table route (a
// live lane costs ~16 INT32 operations, the e^r stage one load from the
// exp-code table, against 8 bytes: one read, one write), the rotation's
// ~190 operations a lane in wider formats.
//
// log_softmax_cluster_kernel splits a row over a thread-block cluster (the
// split is log_softmax_plan in softmax_cordic.py): CTA r of the cluster
// takes the whole 32-lane windows [r W, r W + W) of the row, loads them
// into shared memory once (cp.async), and the max, exp and output passes
// read them there; a row too wide for the cluster's shared memory reads its
// slices from global memory (L2) in each pass instead. Shared memory
// keeps window w's eight 16-byte chunks in one 128-byte row, chunk j at
// j ^ (w & 7), so a thread that sums window w (one 16-byte load a chunk)
// and a quarter-warp that reads 8 neighbouring chunks both hit 8 distinct
// bank groups. Across the cluster (distributed shared memory): each CTA's
// max is read by every CTA (exact in any order); each CTA writes its window
// sums (each window left to right, as window_sums) into rank 0's array;
// rank 0's first warp runs the later levels (xla_tree_sum) and log_q once
// and writes ln S into every CTA. Three cluster barriers; no CTA touches
// another's shared memory after the last. (Neither the later levels by
// rank 0's whole CTA nor every CTA running them itself, its sums broadcast
// and one barrier fewer, was faster on the card.) The e^r lookups need the
// table in L1, so the launch asks for a shared-memory carveout that leaves
// L1 room for it (kLsCarveout).
//
// The split form (softmax_cordic.softmax_split_*; kv_shard="seq_model",
// a row's positions cut into spans across ranks, each span whole 32-lane
// windows) replaces no TPU kernel of its own: it is softmax_2d's function
// taken apart at its two row reductions, so that a rank holds only its
// span. Three launches a rank, a row per CTA each, built from this file's
// device functions: softmax_split_max_kernel (block_row_max), then, given
// the row max the ranks reduced, softmax_split_windows_kernel (the span's
// e^u window sums by window_sums: level 1 of the row sum starts at the
// span's first lane, a window edge of the row, so they are the whole row's
// window sums), then, given every span's window sums, padded with zero
// windows to the padded row's n1, softmax_split_probs_kernel
// (xla_tree_sum and the span's normalisation). Bit for bit the whole
// row's softmax_2d. What bounds it: integer operations, as softmax_2d (a
// live lane rotates twice, once a launch, on either route); the window
// sums add 1/32 of the scores' bytes.
#include <cooperative_groups.h>

#include <algorithm>

#include "cordic.cuh"

namespace {

constexpr int kWideThreads = 256;
constexpr int kWideWarps = kWideThreads / 32;
constexpr int kRowWarps = 8;
constexpr int kWarpCols = 1024;
constexpr int kTile = 32 * 33;  // a warp's 32 x 32 lanes, rows padded to 33 words
constexpr unsigned kFull = 0xffffffffu;

// A lane's codes packed in one word (a 16-bit format): eq in bits 0-15, the
// exponent k in [-30, 0] in bits 16-23, dead in bit 31.
__device__ __forceinline__ int pack_codes(int eq, int ki, bool dead) {
  return (eq & 0xffff) | ((ki & 0xff) << 16) | (dead ? (int)0x80000000u : 0);
}

__device__ __forceinline__ void unpack_codes(int w, int& eq, int& ki, bool& dead) {
  eq = (int)(short)(w & 0xffff);
  ki = (int)(signed char)((w >> 16) & 0xff);
  dead = w < 0;
}

// The stage set of the route: the exp-code table t (kTab) or the rotation.
template <bool kTab>
struct RouteStages;

template <>
struct RouteStages<false> {
  __device__ __forceinline__ static PipelineStages make(const CordicParams& p, const short*,
                                                        int) {
    return PipelineStages{p};
  }
};

template <>
struct RouteStages<true> {
  __device__ __forceinline__ static TableStages make(const CordicParams&, const short* t,
                                                     int half) {
    return TableStages{nullptr, t, half};
  }
};

// Row max over a block of NT threads (exact in any order).
template <int NT>
__device__ __forceinline__ float block_row_max(const float* xr, int cols,
                                               float* warp_max) {
  const int tid = threadIdx.x;
  float m = -INFINITY;
  for (int c = tid; c < cols; c += NT) m = fmaxf(m, xr[c]);
  for (int off = 16; off > 0; off >>= 1) m = fmaxf(m, __shfl_xor_sync(kFull, m, off));
  if ((tid & 31) == 0) warp_max[tid >> 5] = m;
  __syncthreads();
  m = warp_max[0];
  for (int w = 1; w < NT / 32; ++w) m = fmaxf(m, warp_max[w]);
  return m;
}

__host__ __device__ __forceinline__ int cols_padded(int cols) {
  const int c = (cols + 127) / 128 * 128;
  return c > 128 ? c : 128;
}

// Level 1 of the row sum, by every warp of the block: warp k takes the
// 1024-lane chunks k, k + warps, ...; lane_value(c) gives lane c's e^u
// (c < cols); the tile turns lanes 32 i + l so lane w adds window w's 32
// lanes left to right into part[window], for the n1 = cols_p / 32 windows
// (the chunks cover them; those past the row sum to 0).
template <class LaneValue>
__device__ __forceinline__ void window_sums(int cols, int n1, float* tile, float* part,
                                            int warps, LaneValue lane_value) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int chunks = (cols + kWarpCols - 1) / kWarpCols;
  for (int ch = warp; ch < chunks; ch += warps) {
    for (int i = 0; i < 32; ++i) {
      const int c = ch * kWarpCols + 32 * i + lane;
      tile[i * 33 + lane] = c < cols ? lane_value(c) : 0.0f;
    }
    __syncwarp();
    float s = 0.0f;
    for (int i = 0; i < 32; ++i) s = s + tile[lane * 33 + i];
    if (ch * 32 + lane < n1) part[ch * 32 + lane] = s;
    __syncwarp();
  }
}

// The later levels of XLA:CPU's order over the n window sums in a[], by one
// warp: while more than 32 remain, windows of 32 with floor(p/2) zeros in
// front (p the padding to a whole window), each summed left to right into
// b[]; then the last at most 32, left to right. a and b swap each level.
__device__ __forceinline__ float xla_tree_sum(float* a, float* b, int n) {
  const int lane = threadIdx.x & 31;
  while (n > 32) {
    const int w = (n + 31) / 32, front = (w * 32 - n) / 2;
    for (int j = lane; j < w; j += 32) {
      float s = 0.0f;
      for (int i = 0; i < 32; ++i) {
        const int k = 32 * j - front + i;
        if (k >= 0 && k < n) s = s + a[k];
      }
      b[j] = s;
    }
    __syncwarp();
    float* t = a;
    a = b;
    b = t;
    n = w;
  }
  float s = 0.0f;
  for (int k = 0; k < n; ++k) s = s + a[k];
  return s;
}

// A row per warp, rows up to kWarpCols lanes: cols_p <= 1024, so the window
// sums are the last level.
template <bool kTab>
__global__ void __launch_bounds__(kRowWarps * 32)
    softmax_kernel_rows(const float* __restrict__ x, float* __restrict__ y, int rows,
                        int cols, const CordicParams p, const short* __restrict__ tab,
                        int half) {
  // the warps' e^u tiles, then (kTab) their code tiles: a row of 33 words
  // per window, so a narrow row leaves room for more warps on an SM
  extern __shared__ __align__(16) float f[];
  const auto st = RouteStages<kTab>::make(p, tab, half);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int groups = (cols + 31) / 32;  // group j: lanes 32 j .. 32 j + 31 = window j
  const int tile_words = groups * 33;
  float* etile = f + warp * tile_words;
  int* ctile = reinterpret_cast<int*>(f + kRowWarps * tile_words) + warp * tile_words;
  for (int row = blockIdx.x * kRowWarps + warp; row < rows; row += gridDim.x * kRowWarps) {
    const float* xr = x + (long long)row * cols;
    float* yr = y + (long long)row * cols;
    float m = -INFINITY;
    for (int j = 0; j < groups; ++j) {
      const int c = 32 * j + lane;
      if (c < cols) m = fmaxf(m, xr[c]);
    }
    for (int off = 16; off > 0; off >>= 1) m = fmaxf(m, __shfl_xor_sync(kFull, m, off));
    // the lanes' e^u (0 past the row) and, on the table route, codes
    for (int j = 0; j < groups; ++j) {
      const int c = 32 * j + lane;
      float e = 0.0f;
      int w = pack_codes(0, 0, true);
      if (c < cols) {
        int eq, ki;
        bool dead;
        exp_codes(xr[c] - m, p, st, eq, ki, dead);
        e = exp_value(eq, ki, dead, p);
        w = pack_codes(eq, ki, dead);
      }
      etile[j * 33 + lane] = e;
      if constexpr (kTab) ctile[j * 33 + lane] = w;
    }
    __syncwarp();
    float part = 0.0f;
    if (lane < groups)
      for (int i = 0; i < 32; ++i) part = part + etile[lane * 33 + i];
    // the window sums left to right (those past the row are 0)
    float ssum = 0.0f;
    for (int i = 0; i < groups; ++i) ssum = ssum + __shfl_sync(kFull, part, i);
    const RowSum rs = row_sum_frexp(ssum, p);
    for (int j = 0; j < groups; ++j) {
      const int c = 32 * j + lane;
      if (c >= cols) continue;
      if constexpr (kTab) {
        int eq, ki;
        bool dead;
        unpack_codes(ctile[j * 33 + lane], eq, ki, dead);
        yr[c] = dead ? 0.0f : prob_codes(eq, ki, dead, rs, p);
      } else {
        yr[c] = lane_prob(xr[c] - m, rs, p);
      }
    }
    __syncwarp();  // the tiles are the next row's
  }
}

// The shared memory of softmax_kernel_wide:
// kWideWarps tiles, the window sums (n1), the next
// level's (n1 / 32 + 1), the warps' maxima and the row sum.
__host__ __device__ __forceinline__ int wide_floats(int n1) {
  return kWideWarps * kTile + n1 + n1 / 32 + 1 + kWideWarps + 1;
}

// A row per CTA (rows wider than kWarpCols). On the table route the lanes'
// packed codes wait in the output row between the passes.
template <bool kTab>
__global__ void __launch_bounds__(kWideThreads)
    softmax_kernel_wide(const float* __restrict__ x, float* __restrict__ y, int rows,
                        int cols, const CordicParams p, const short* __restrict__ tab,
                        int half) {
  extern __shared__ __align__(16) float f[];
  const auto st = RouteStages<kTab>::make(p, tab, half);
  const int n1 = cols_padded(cols) / 32;
  float* tile = f + (threadIdx.x >> 5) * kTile;
  float* part = f + kWideWarps * kTile;
  float* part2 = part + n1;
  float* warp_max = part2 + n1 / 32 + 1;
  float* row_sum = warp_max + kWideWarps;
  for (int row = blockIdx.x; row < rows; row += gridDim.x) {
    const float* xr = x + (long long)row * cols;
    float* yr = y + (long long)row * cols;
    const float m = block_row_max<kWideThreads>(xr, cols, warp_max);
    window_sums(cols, n1, tile, part, kWideWarps, [&](int c) {
      int eq, ki;
      bool dead;
      exp_codes(xr[c] - m, p, st, eq, ki, dead);
      if constexpr (kTab) yr[c] = __int_as_float(pack_codes(eq, ki, dead));
      return exp_value(eq, ki, dead, p);
    });
    __syncthreads();
    if (threadIdx.x < 32) {
      const float s = xla_tree_sum(part, part2, n1);
      if (threadIdx.x == 0) *row_sum = s;
    }
    __syncthreads();
    const RowSum rs = row_sum_frexp(*row_sum, p);
    for (int c = threadIdx.x; c < cols; c += kWideThreads) {
      if constexpr (kTab) {
        int eq, ki;
        bool dead;
        unpack_codes(__float_as_int(yr[c]), eq, ki, dead);
        yr[c] = dead ? 0.0f : prob_codes(eq, ki, dead, rs, p);
      } else {
        yr[c] = lane_prob(xr[c] - m, rs, p);
      }
    }
    __syncthreads();  // shared memory is the next row's
  }
}

// The CTA of a cluster: kLsThreads threads.
constexpr int kLsThreads = 256;
constexpr int kLsWarps = kLsThreads / 32;
constexpr int kLsMaxCluster = 8;  // the largest portable cluster

// A CTA's shared memory, in floats from its start: [the slice, staged
// only: wpc windows x 32 lanes] [the row's window sums: n1] [the next
// level: n1 / 32 + 1] [the warps' maxima: kLsWarps] [this CTA's max, ln S].
// log_softmax_plan sizes the same layout; the launch refuses another size.
struct LsLayout {
  int part, part2, warp_max, slots, floats;
};

__host__ __device__ __forceinline__ LsLayout ls_layout(int n1, int wpc, bool staged) {
  LsLayout o;
  o.part = staged ? 32 * wpc : 0;
  o.part2 = o.part + n1;
  o.warp_max = o.part2 + n1 / 32 + 1;
  o.slots = o.warp_max + kLsWarps;
  o.floats = o.slots + 2;
  return o;
}
// shared memory an SM keeps for CTAs, in percent of the most it can (228
// KB): 70% rounds to 164 KB, four CTAs of a 64,000-lane row's plan, and
// leaves L1 92 KB (a CTA that needs more gets more)
constexpr int kLsCarveout = 70;
// registers for four CTAs an SM (64 a thread; 79 without the bound left
// three)
constexpr int kLsCtasPerSm = 4;

// cp.async of 4 or 16 bytes into shared memory (cached at L1: .ca; 16
// bytes may bypass it: .cg); one wait for all of a thread's copies.
__device__ __forceinline__ void copy_async4(float* dst, const float* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(
                   (unsigned)__cvta_generic_to_shared(dst)),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void copy_async16(float* dst, const float* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                   (unsigned)__cvta_generic_to_shared(dst)),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void copy_async_wait() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// Word of slice lane l (window l / 32) in the swizzled layout.
__device__ __forceinline__ int slice_word(int l) {
  const int w = l >> 5, j = (l >> 2) & 7;
  return (w << 5) | ((j ^ (w & 7)) << 2) | (l & 3);
}

template <bool kTab, bool kStaged>
__global__ void __launch_bounds__(kLsThreads, kLsCtasPerSm)
    log_softmax_cluster_kernel(const float* __restrict__ x, float* __restrict__ y, int cols,
                               int wpc, int vec, const CordicParams p,
                               const short* __restrict__ tab, int half) {
  extern __shared__ __align__(16) float f[];
  namespace cg = cooperative_groups;
  cg::cluster_group cluster = cg::this_cluster();
  const auto st = RouteStages<kTab>::make(p, tab, half);
  const int rank = (int)cluster.block_rank(), csize = (int)cluster.num_blocks();
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int n1 = cols_padded(cols) / 32;
  const int w0 = rank * wpc, nw = max(min(n1 - w0, wpc), 0);
  // the slice's real lanes: [32 w0, 32 w0 + lanes) of the row
  const int lanes = max(min(32 * (w0 + nw), cols) - 32 * w0, 0);
  const long long row = blockIdx.x / csize;
  const float* xs = x + row * cols + 32LL * w0;
  float* ys = y + row * cols + 32LL * w0;
  const LsLayout lay = ls_layout(n1, wpc, kStaged);
  float* slice = f;
  float* part = f + lay.part;
  float* part2 = f + lay.part2;
  float* warp_max = f + lay.warp_max;
  float* slots = f + lay.slots;  // [0] this CTA's max, [1] ln S
  // vec: 16-byte chunks (cols % 4 == 0 and both rows 16-byte aligned, so
  // every slice is whole chunks)
  const int nv = vec ? lanes / 4 : 0;
  if constexpr (kStaged) {
    for (int v = tid; v < nv; v += kLsThreads) copy_async16(slice + slice_word(4 * v), xs + 4 * v);
    for (int l = 4 * nv + tid; l < lanes; l += kLsThreads) copy_async4(slice + slice_word(l), xs + l);
    copy_async_wait();
    __syncthreads();
  }
  auto chunk = [&](int v) -> float4 {  // lanes 4 v .. 4 v + 3 of the slice
    if constexpr (kStaged) return reinterpret_cast<const float4*>(slice)[slice_word(4 * v) >> 2];
    return reinterpret_cast<const float4*>(xs)[v];
  };
  auto lane_x = [&](int l) -> float { return kStaged ? slice[slice_word(l)] : xs[l]; };

  // pass 1: the row max, over the cluster's CTAs
  float m = -INFINITY;
  for (int v = tid; v < nv; v += kLsThreads) {
    const float4 a = chunk(v);
    m = fmaxf(fmaxf(m, a.x), fmaxf(a.y, fmaxf(a.z, a.w)));
  }
  for (int l = 4 * nv + tid; l < lanes; l += kLsThreads) m = fmaxf(m, lane_x(l));
  for (int off = 16; off > 0; off >>= 1) m = fmaxf(m, __shfl_xor_sync(kFull, m, off));
  if (lane == 0) warp_max[warp] = m;
  __syncthreads();
  if (tid == 0) {
    for (int w = 1; w < kLsWarps; ++w) m = fmaxf(m, warp_max[w]);
    slots[0] = m;
  }
  cluster.sync();  // every CTA has started and holds its max
  m = -INFINITY;
  if (lane < csize) m = *cluster.map_shared_rank(slots, lane);
  for (int off = 16; off > 0; off >>= 1) m = fmaxf(m, __shfl_xor_sync(kFull, m, off));

  // pass 2: level 1 of the row sum, a window a thread, into rank 0's array
  float* part0 = cluster.map_shared_rank(part, 0);
  for (int wl = tid; wl < nw; wl += kLsThreads) {
    float s = 0.0f;
    // lanes 4 j .. 4 j + 3 of the window into s, left to right
    auto add_chunk = [&](int j) {
      const int l = 32 * wl + 4 * j;
      float a[4];
      if (kStaged || 4 * nv > l) {  // a whole staged chunk, or a global one
        const float4 c = kStaged ? reinterpret_cast<const float4*>(slice)[slice_word(l) >> 2]
                                 : reinterpret_cast<const float4*>(xs)[l >> 2];
        a[0] = c.x;
        a[1] = c.y;
        a[2] = c.z;
        a[3] = c.w;
      } else {
        for (int e = 0; e < 4; ++e) a[e] = l + e < lanes ? xs[l + e] : 0.0f;
      }
      // no branch before the adds, so the 32 lanes' table loads can all
      // be in flight; a lane past the row (any value: a code off the table
      // reads its edge) adds 0
      float ev[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        int eq, ki;
        bool dead;
        exp_codes(a[e] - m, p, st, eq, ki, dead);
        ev[e] = exp_value(eq, ki, dead, p);
      }
#pragma unroll
      for (int e = 0; e < 4; ++e) s = s + (l + e < lanes ? ev[e] : 0.0f);
    };
    // the table route unrolls the window (its lookups all in flight); the
    // rotation's 32 inlined copies only slowed nvcc (minutes), so the
    // pipeline route loops
    if constexpr (kTab) {
#pragma unroll
      for (int j = 0; j < 8; ++j) add_chunk(j);
    } else {
#pragma unroll 1
      for (int j = 0; j < 8; ++j) add_chunk(j);
    }
    part0[w0 + wl] = s;
  }
  cluster.sync();  // rank 0 holds every window sum

  // the later levels and ln S, once per row (rank 0's first warp), handed
  // to every CTA
  if (rank == 0 && warp == 0) {
    const float ssum = xla_tree_sum(part, part2, n1);
    if (lane < csize) *cluster.map_shared_rank(slots + 1, lane) = log_q(ssum, p);
  }
  cluster.sync();  // no CTA touches another's shared memory after this
  const float lns = slots[1];

  // pass 3: y = (x - m) - ln S
  for (int v = tid; v < nv; v += kLsThreads) {
    const float4 a = chunk(v);
    reinterpret_cast<float4*>(ys)[v] =
        make_float4((a.x - m) - lns, (a.y - m) - lns, (a.z - m) - lns, (a.w - m) - lns);
  }
  for (int l = 4 * nv + tid; l < lanes; l += kLsThreads) ys[l] = (lane_x(l) - m) - lns;
}

// The span's row max, a row per CTA.
__global__ void __launch_bounds__(kWideThreads)
    softmax_split_max_kernel(const float* __restrict__ x, float* __restrict__ m, int rows,
                             int cols) {
  __shared__ float warp_max[kWideWarps];
  for (int row = blockIdx.x; row < rows; row += gridDim.x) {
    const float v = block_row_max<kWideThreads>(x + (long long)row * cols, cols, warp_max);
    if (threadIdx.x == 0) m[row] = v;
    __syncthreads();  // warp_max is the next row's
  }
}

// The span's e^(x - m) window sums, a row per CTA: each warp sums the
// windows of its 1024-lane chunks into w (cols / 32 a row).
template <bool kTab>
__global__ void __launch_bounds__(kWideThreads)
    softmax_split_windows_kernel(const float* __restrict__ x, const float* __restrict__ m,
                                 float* __restrict__ w, int rows, int cols,
                                 const CordicParams p, const short* __restrict__ tab,
                                 int half) {
  __shared__ float tiles[kWideWarps * kTile];
  const auto st = RouteStages<kTab>::make(p, tab, half);
  float* tile = tiles + (threadIdx.x >> 5) * kTile;
  const int nw = cols / 32;
  for (int row = blockIdx.x; row < rows; row += gridDim.x) {
    const float* xr = x + (long long)row * cols;
    const float mr = m[row];
    window_sums(cols, nw, tile, w + (long long)row * nw, kWideWarps, [&](int c) {
      int eq, ki;
      bool dead;
      exp_codes(xr[c] - mr, p, st, eq, ki, dead);
      return exp_value(eq, ki, dead, p);
    });
  }
}

// The span's probabilities, a row per CTA: the row's nw window sums (every
// span's, in row order) and zero windows up to n1 into shared memory, the
// later levels by one warp, then the span's lanes normalised.
template <bool kTab>
__global__ void __launch_bounds__(kWideThreads)
    softmax_split_probs_kernel(const float* __restrict__ x, const float* __restrict__ m,
                               const float* __restrict__ w, float* __restrict__ y, int rows,
                               int cols, int nw, int n1, const CordicParams p,
                               const short* __restrict__ tab, int half) {
  extern __shared__ __align__(16) float f[];
  const auto st = RouteStages<kTab>::make(p, tab, half);
  float* part = f;
  float* part2 = part + n1;
  float* row_sum = part2 + n1 / 32 + 1;
  for (int row = blockIdx.x; row < rows; row += gridDim.x) {
    const float* wr = w + (long long)row * nw;
    for (int i = threadIdx.x; i < n1; i += kWideThreads) part[i] = i < nw ? wr[i] : 0.0f;
    __syncthreads();
    if (threadIdx.x < 32) {
      const float s = xla_tree_sum(part, part2, n1);
      if (threadIdx.x == 0) *row_sum = s;
    }
    __syncthreads();
    const RowSum rs = row_sum_frexp(*row_sum, p);
    const float mr = m[row];
    const float* xr = x + (long long)row * cols;
    float* yr = y + (long long)row * cols;
    for (int c = threadIdx.x; c < cols; c += kWideThreads) {
      int eq, ki;
      bool dead;
      exp_codes(xr[c] - mr, p, st, eq, ki, dead);
      yr[c] = prob_codes(eq, ki, dead, rs, p);
    }
    __syncthreads();  // shared memory is the next row's
  }
}

int sm_count() {
  static int sms = 0;
  if (sms == 0) {
    int dev = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  }
  return sms;
}

// Dynamic shared memory past the default 48 KB needs the kernel's opt-in.
template <class Kernel>
bool allow_smem(Kernel kern, size_t bytes, int& allowed) {
  if ((int)bytes <= allowed) return true;
  if (cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           (int)bytes) != cudaSuccess)
    return false;
  allowed = (int)bytes;
  return true;
}

// The resident CTAs of a kernel on the card (its occupancy x SMs).
template <class Kernel>
int resident_ctas(Kernel kern, int threads, size_t smem) {
  int per_sm = 0;
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kern, threads, smem);
  return (per_sm > 0 ? per_sm : 1) * sm_count();
}

template <bool kTab>
int launch_softmax(const float* x, float* y, int rows, int cols, const CordicParams& p,
                   const short* tab, int half, cudaStream_t s) {
  if (cols <= kWarpCols) {
    const int groups = (cols + 31) / 32;
    const size_t smem = (kTab ? 2 : 1) * (size_t)kRowWarps * groups * 33 * sizeof(float);
    static int allowed = 48 * 1024, resident[kWarpCols / 32 + 1] = {};
    if (!allow_smem(softmax_kernel_rows<kTab>, smem, allowed)) return (int)cudaGetLastError();
    if (resident[groups] == 0)
      resident[groups] = resident_ctas(softmax_kernel_rows<kTab>, kRowWarps * 32, smem);
    const int grid = std::min((rows + kRowWarps - 1) / kRowWarps, resident[groups]);
    softmax_kernel_rows<kTab><<<grid, kRowWarps * 32, smem, s>>>(x, y, rows, cols, p, tab,
                                                                 half);
  } else {
    const size_t smem = (size_t)wide_floats(cols_padded(cols) / 32) * sizeof(float);
    static int allowed = 48 * 1024, resident = 0;
    if (!allow_smem(softmax_kernel_wide<kTab>, smem, allowed)) return (int)cudaGetLastError();
    if (resident == 0) resident = resident_ctas(softmax_kernel_wide<kTab>, kWideThreads, smem);
    const int grid = std::min(rows, resident);
    softmax_kernel_wide<kTab><<<grid, kWideThreads, smem, s>>>(x, y, rows, cols, p, tab, half);
  }
  return (int)cudaGetLastError();
}

template <bool kTab, bool kStaged>
int launch_log_softmax(const float* x, float* y, int rows, int cols, int cluster, int wpc,
                       int smem, const CordicParams& p, const short* tab, int half,
                       cudaStream_t s) {
  auto kern = log_softmax_cluster_kernel<kTab, kStaged>;
  static int allowed = 48 * 1024;
  static bool carved = false;
  if (!allow_smem(kern, smem, allowed)) {
    const int e = (int)cudaGetLastError();
    return e != 0 ? e : (int)cudaErrorInvalidValue;
  }
  // leave L1 the room for the exp-code table (a 32 KB table whose codes
  // |z| <= 5680 are live): without the hint the slices take all but 28 KB
  // of an SM's 256 KB and every lookup went to L2
  if (!carved) {
    const cudaError_t e =
        cudaFuncSetAttribute(kern, cudaFuncAttributePreferredSharedMemoryCarveout, kLsCarveout);
    if (e != cudaSuccess) return (int)e;
    carved = true;
  }
  const int vec = (cols % 4 == 0 && ((unsigned long long)x | (unsigned long long)y) % 16 == 0);
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)cluster * (unsigned)rows, 1, 1);
  cfg.blockDim = dim3(kLsThreads, 1, 1);
  cfg.dynamicSmemBytes = (size_t)smem;
  cfg.stream = s;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = (unsigned)cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const cudaError_t e = cudaLaunchKernelEx(&cfg, kern, x, y, cols, wpc, vec, p, tab, half);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

int launch_split_max(const float* x, float* m, int rows, int cols, cudaStream_t s) {
  static int resident = 0;
  if (resident == 0) resident = resident_ctas(softmax_split_max_kernel, kWideThreads, 0);
  softmax_split_max_kernel<<<std::min(rows, resident), kWideThreads, 0, s>>>(x, m, rows, cols);
  return (int)cudaGetLastError();
}

template <bool kTab>
int launch_split_windows(const float* x, const float* m, float* w, int rows, int cols,
                         const CordicParams& p, const short* tab, int half, cudaStream_t s) {
  static int resident = 0;
  if (resident == 0)
    resident = resident_ctas(softmax_split_windows_kernel<kTab>, kWideThreads, 0);
  softmax_split_windows_kernel<kTab><<<std::min(rows, resident), kWideThreads, 0, s>>>(
      x, m, w, rows, cols, p, tab, half);
  return (int)cudaGetLastError();
}

template <bool kTab>
int launch_split_probs(const float* x, const float* m, const float* w, float* y, int rows,
                       int cols, int nw, const CordicParams& p, const short* tab, int half,
                       cudaStream_t s) {
  const int n1 = cols_padded(32 * nw) / 32;
  const size_t smem = (size_t)(n1 + n1 / 32 + 2) * sizeof(float);
  static int allowed = 48 * 1024, resident = 0;
  static size_t resident_smem = 0;
  if (!allow_smem(softmax_split_probs_kernel<kTab>, smem, allowed)) {
    const int e = (int)cudaGetLastError();
    return e != 0 ? e : (int)cudaErrorInvalidValue;
  }
  if (resident == 0 || resident_smem != smem) {
    resident = resident_ctas(softmax_split_probs_kernel<kTab>, kWideThreads, smem);
    resident_smem = smem;
  }
  softmax_split_probs_kernel<kTab><<<std::min(rows, resident), kWideThreads, smem, s>>>(
      x, m, w, y, rows, cols, nw, n1, p, tab, half);
  return (int)cudaGetLastError();
}

}  // namespace

// The split form's three launches (softmax_cordic.softmax_split_*): x a
// (rows, cols) span of float32 scores, m (rows,) its row max (the first
// launch's output, then the ranks' maximum), w the window sums: the span's
// (rows, cols / 32) from the second launch, every span's (rows, nw) into
// the third. cols must be whole windows and the spans' windows cover at
// least the span's, else the launch is refused.
extern "C" int cordic_softmax_split_max(const void* x, void* m, int rows, int cols,
                                        void* stream) {
  if (rows <= 0 || cols <= 0) return (int)cudaGetLastError();
  return launch_split_max((const float*)x, (float*)m, rows, cols, (cudaStream_t)stream);
}

extern "C" int cordic_softmax_split_windows(const void* x, const void* m, void* w, int rows,
                                            int cols, const CordicParams* p, const void* tab,
                                            int half, void* stream) {
  if (rows <= 0 || cols <= 0) return (int)cudaGetLastError();
  if (cols % 32 != 0) return (int)cudaErrorInvalidValue;
  const short* t = (const short*)tab;
  const auto launch = t ? launch_split_windows<true> : launch_split_windows<false>;
  return launch((const float*)x, (const float*)m, (float*)w, rows, cols, *p, t, half,
                (cudaStream_t)stream);
}

extern "C" int cordic_softmax_split_probs(const void* x, const void* m, const void* w, void* y,
                                          int rows, int cols, int nw, const CordicParams* p,
                                          const void* tab, int half, void* stream) {
  if (rows <= 0 || cols <= 0) return (int)cudaGetLastError();
  if (cols % 32 != 0 || 32LL * nw < cols) return (int)cudaErrorInvalidValue;
  const short* t = (const short*)tab;
  const auto launch = t ? launch_split_probs<true> : launch_split_probs<false>;
  return launch((const float*)x, (const float*)m, (const float*)w, (float*)y, rows, cols, nw,
                *p, t, half, (cudaStream_t)stream);
}

// tab: the exp-code table of a 16-bit format (null: the pipeline route),
// its codes [-half, half].
extern "C" int cordic_softmax_2d(const void* x, void* y, int rows, int cols,
                                 const CordicParams* p, const void* tab, int half,
                                 void* stream) {
  if (rows <= 0 || cols <= 0) return (int)cudaGetLastError();
  const float* xf = (const float*)x;
  float* yf = (float*)y;
  const short* t = (const short*)tab;
  cudaStream_t s = (cudaStream_t)stream;
  return t == nullptr ? launch_softmax<false>(xf, yf, rows, cols, *p, t, half, s)
                      : launch_softmax<true>(xf, yf, rows, cols, *p, t, half, s);
}

// tab: the exp-code table of a 16-bit format (null: the pipeline route),
// its codes [-half, half]. The split (cluster CTAs a row, wpc windows a
// CTA, smem bytes a CTA, staged) is softmax_cordic.log_softmax_plan's: it
// must cover the row's n1 windows, leave no CTA without one, and give
// smem the bytes of ls_layout, else the launch is refused.
extern "C" int cordic_log_softmax_2d(const void* x, void* y, int rows, int cols, int cluster,
                                     int wpc, int smem, int staged, const CordicParams* p,
                                     const void* tab, int half, void* stream) {
  if (rows <= 0 || cols <= 0) return (int)cudaGetLastError();
  const int n1 = cols_padded(cols) / 32;
  if (cluster < 1 || cluster > kLsMaxCluster || wpc < 1 || (long long)cluster * wpc < n1 ||
      (long long)(cluster - 1) * wpc >= n1 || (staged != 0 && staged != 1) ||
      (long long)smem != 4LL * ls_layout(n1, wpc, staged).floats)
    return (int)cudaErrorInvalidValue;
  const float* xf = (const float*)x;
  float* yf = (float*)y;
  const short* t = (const short*)tab;
  cudaStream_t s = (cudaStream_t)stream;
  const auto launch = staged ? (t ? launch_log_softmax<true, true> : launch_log_softmax<false, true>)
                             : (t ? launch_log_softmax<true, false>
                                  : launch_log_softmax<false, false>);
  return launch(xf, yf, rows, cols, cluster, wpc, smem, *p, t, half, s);
}

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
// huge negative value. One CTA per row (a vocabulary wide, 64,000 lanes:
// 2000 windows, then 63, then 2, then the final add). What bounds it:
// integer operations, one rotation per lane (~170 INT32 operations) against
// 8 bytes; the row is read three times (max, exp, out), the second and third
// mostly from L2 (a 64000-lane row is 256 KB).
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

// The shared memory of softmax_kernel_wide and log_softmax_rows_kernel:
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

__global__ void __launch_bounds__(kWideThreads)
    log_softmax_rows_kernel(const float* __restrict__ x, float* __restrict__ y, int cols,
                            const CordicParams p) {
  extern __shared__ __align__(16) float f[];
  const int n1 = cols_padded(cols) / 32;
  float* tile = f + (threadIdx.x >> 5) * kTile;
  float* part = f + kWideWarps * kTile;
  float* part2 = part + n1;
  float* warp_max = part2 + n1 / 32 + 1;
  float* row_sum = warp_max + kWideWarps;
  const float* xr = x + (long long)blockIdx.x * cols;
  float* yr = y + (long long)blockIdx.x * cols;

  const float m = block_row_max<kWideThreads>(xr, cols, warp_max);
  window_sums(cols, n1, tile, part, kWideWarps, [&](int c) { return lane_exp(xr[c] - m, p); });
  __syncthreads();
  if (threadIdx.x < 32) {
    const float s = xla_tree_sum(part, part2, n1);
    if (threadIdx.x == 0) *row_sum = s;
  }
  __syncthreads();
  const float lns = log_q(*row_sum, p);
  for (int c = threadIdx.x; c < cols; c += kWideThreads) yr[c] = (xr[c] - m) - lns;
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

}  // namespace

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

extern "C" int cordic_log_softmax_2d(const void* x, void* y, int rows, int cols,
                                     const CordicParams* p, void* stream) {
  if (rows > 0 && cols > 0) {
    const size_t smem = (size_t)wide_floats(cols_padded(cols) / 32) * sizeof(float);
    static int allowed = 48 * 1024;
    if (!allow_smem(log_softmax_rows_kernel, smem, allowed)) return (int)cudaGetLastError();
    log_softmax_rows_kernel<<<rows, kWideThreads, smem, (cudaStream_t)stream>>>(
        (const float*)x, (float*)y, cols, *p);
  }
  return (int)cudaGetLastError();
}

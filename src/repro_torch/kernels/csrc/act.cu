// Elementwise CORDIC activations on Hopper.
//
// Replaces the TPU kernels of repro/kernels/cordic_act.py:
//   cordic_act_2d       <- act_2d (:368, body _act_kernel :298), ops sigmoid,
//                          tanh, sigmoid_wide, silu, exp, log, softplus, elu,
//                          gelu_erf
//   cordic_silu_mul_2d  <- silu_mul_2d (:401, body _silu_mul_kernel :339),
//                          the fused SwiGLU epilogue up * g * sigmoid_wide(g)
//   cordic_act_q_2d     <- act_q_2d (:385, body _act_q_kernel :333), the
//                          paper's integer datapath: Q2.14 int16/int32 codes
//                          in, sigmoid codes of the same dtype out; the
//                          cordic_sigmoid_q stage alone, no float boundary
//
// act_kernel, the pipeline route (every op in a format wider than 16 bits,
// log in every format; silu_mul_kernel and act_q_kernel are the same
// design): each element runs the unrolled 26-stage shift-add pipeline (8
// radix-2, 4 radix-4, 14 LVC stages: at least ~310 INT32 operations) against
// 4-12 bytes of traffic, and the card has 64 INT32 lanes per SM against
// 3.35 TB/s, so the integer ALU saturates long before memory does (exp:
// ~170 per element, log: ~150, softplus both legs). One element per thread
// over a grid-stride loop, every stage in registers with its ROM entries at
// constant offsets of the parameter bank. The TPU's (rows, 1024) tiling is
// gone; the wrappers pass flat element counts.
//
// act_kernel_tab and silu_mul_kernel_tab, the table route (a 16-bit format,
// every op but log; silu_mul's sigmoid_wide): the op's one costly stage is
// a function of one code in [-2^(fb-1), 2^(fb-1)] (code_tables.py), so it
// is one load from the stage's code table, which cordic_code_tables builds
// on the card from the pipeline's own device functions: the output is the
// pipeline's bit for bit, and an element costs its float boundary ops
// (~15-30 operations) instead of ~310, which leaves HBM bytes as the bound
// for sigmoid and for silu_mul (6 bytes an element in bfloat16, against 28
// operations). Persistent CTAs (as many as fit the card at once) read the
// op's 32 KB table through L1, where it stays (a copy staged into shared
// memory per CTA lost or tied at every size measured); 16-byte loads and
// stores (4 float32 or 8 bfloat16 lanes) where every pointer allows.
// softplus takes only its exp leg from the table; its log leg (two
// operands) stays on the pipeline. sigmoid_wide's doubling loop stops at
// the lane's k (cordic.cuh), so a lane with |x| <= 1 runs no divide.
//
// act_q_kernel_tab, act_q_2d's table route (a 16-bit format): the sigmoid
// code of x is a function of z = wrap16(x >> 1) alone, and z takes 65,536
// values, so the whole function is one table (code_tables.py), which
// cordic_sigmoid_q_table builds on the card with cordic_sigmoid_q itself:
// the output is the pipeline's bit for bit. An element is then its index
// arithmetic ((x >> 1) & 0xFFFF) ^ 0x8000 and one lookup, against 4 (int16)
// or 8 (int32) bytes of traffic, so HBM bytes bound it. Persistent CTAs
// stream 16-byte vectors (8 int16 or 4 int32 codes a thread, two vectors in
// flight, evict-first), each CTA with its own copy of the table in shared
// memory: int16 codes halve into [-16384, 16383], so they need only the
// table's contiguous middle 64 KB (three CTAs an SM), int32 codes the whole
// 128 KB (one CTA of 1024 threads an SM). The lookups are random gathers
// from shared memory, so a warp's 32 lanes conflict on banks (two lanes on
// one 4-byte word share it); the two vectors in flight hide them behind HBM.
#include "cordic.cuh"

namespace {

// op codes: the order of cordic_act.OPS
enum ActOp {
  OP_SIGMOID = 0,
  OP_TANH = 1,
  OP_SIGMOID_WIDE = 2,
  OP_SILU = 3,
  OP_EXP = 4,
  OP_LOG = 5,
  OP_SOFTPLUS = 6,
  OP_ELU = 7,
  OP_GELU_ERF = 8
};

// One op's boundary code around the stage set's tanh or e^r stage.
template <int OP, class Stages>
__device__ __forceinline__ float act_op(float xf, const CordicParams& p, const Stages& st) {
  if constexpr (OP == OP_SIGMOID) {
    const int xq = quantize_f(fminf(fmaxf(xf, -1.0f), 1.0f), p.fb, p.bits);
    return dequantize_f(sigmoid_code(xq, p, st), p.fb);
  } else if constexpr (OP == OP_TANH) {
    // |z| <= 0.5 clamp: direct angle feed, as _act_kernel does
    const int zq = quantize_f(fminf(fmaxf(xf, -0.5f), 0.5f), p.fb, p.bits);
    return dequantize_f(st.tanh_code(zq), p.fb);
  } else if constexpr (OP == OP_SIGMOID_WIDE) {
    return wide_sigmoid_f(xf, p, st);
  } else if constexpr (OP == OP_SILU) {
    return xf * wide_sigmoid_f(xf, p, st);
  } else if constexpr (OP == OP_EXP) {
    return exp_q(xf, p, st);
  } else if constexpr (OP == OP_LOG) {
    return log_q(xf, p);
  } else if constexpr (OP == OP_SOFTPLUS) {
    // log(1 + e^x) = relu(x) + log(1 + e^-|x|), both CORDIC legs
    return fmaxf(xf, 0.0f) + log_q(1.0f + exp_q(-fabsf(xf), p, st), p);
  } else if constexpr (OP == OP_ELU) {
    return xf > 0.0f ? xf : exp_q(fminf(xf, 0.0f), p, st) - 1.0f;
  } else {  // OP_GELU_ERF: 0.5 x (1 + erf(x / sqrt 2))
    return 0.5f * xf * (1.0f + erf_q(xf * CORDIC_INV_SQRT2, p, st));
  }
}

__device__ __forceinline__ float act_one(float xf, int op, const CordicParams& p) {
  const PipelineStages st{p};
  switch (op) {
    case OP_SIGMOID: return act_op<OP_SIGMOID>(xf, p, st);
    case OP_TANH: return act_op<OP_TANH>(xf, p, st);
    case OP_SIGMOID_WIDE: return act_op<OP_SIGMOID_WIDE>(xf, p, st);
    case OP_SILU: return act_op<OP_SILU>(xf, p, st);
    case OP_EXP: return act_op<OP_EXP>(xf, p, st);
    case OP_LOG: return act_op<OP_LOG>(xf, p, st);
    case OP_SOFTPLUS: return act_op<OP_SOFTPLUS>(xf, p, st);
    case OP_ELU: return act_op<OP_ELU>(xf, p, st);
    default: return act_op<OP_GELU_ERF>(xf, p, st);
  }
}

template <typename T>
__global__ void act_kernel(const T* __restrict__ x, T* __restrict__ y, long long n,
                           int op, const CordicParams p) {
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += stride) {
    store_float(y, i, act_one(load_as_float(x, i), op, p));
  }
}

// 16 bytes of lanes: 4 float32 or 8 bfloat16, as float32 values.
template <typename T>
struct Lanes16;

template <>
struct Lanes16<float> {
  static constexpr int n = 4;
  __device__ __forceinline__ static void load(const float* x, long long v, float* f) {
    const float4 a = reinterpret_cast<const float4*>(x)[v];
    f[0] = a.x;
    f[1] = a.y;
    f[2] = a.z;
    f[3] = a.w;
  }
  __device__ __forceinline__ static void store(float* y, long long v, const float* f) {
    reinterpret_cast<float4*>(y)[v] = make_float4(f[0], f[1], f[2], f[3]);
  }
};

template <>
struct Lanes16<__nv_bfloat16> {
  static constexpr int n = 8;
  // a bfloat16 is the high half of its float32 value (exact)
  __device__ __forceinline__ static void load(const __nv_bfloat16* x, long long v, float* f) {
    const uint4 a = reinterpret_cast<const uint4*>(x)[v];
    const unsigned w[4] = {a.x, a.y, a.z, a.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      f[2 * i] = __uint_as_float(w[i] << 16);
      f[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
    }
  }
  __device__ __forceinline__ static void store(__nv_bfloat16* y, long long v, const float* f) {
    unsigned w[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const unsigned lo = __bfloat16_as_ushort(__float2bfloat16_rn(f[2 * i]));
      const unsigned hi = __bfloat16_as_ushort(__float2bfloat16_rn(f[2 * i + 1]));
      w[i] = lo | (hi << 16);
    }
    reinterpret_cast<uint4*>(y)[v] = make_uint4(w[0], w[1], w[2], w[3]);
  }
};

constexpr int kTabThreads = 256;

// The table route of act_2d: OP's stage from `tab` (the op's one table,
// code = tab[z + half]). vec: both pointers are 16-byte aligned, so whole
// vectors go first and the tail element by element.
template <typename T, int OP>
__global__ void __launch_bounds__(kTabThreads)
    act_kernel_tab(const T* __restrict__ x, T* __restrict__ y, long long n, int vec,
                   const CordicParams p, const short* __restrict__ tab, int half) {
  constexpr bool kTanh = OP <= OP_SILU;  // the sigmoid family reads tanh codes
  const TableStages st{kTanh ? tab : nullptr, kTanh ? nullptr : tab, half};
  using L = Lanes16<T>;
  const long long nv = vec ? n / L::n : 0;
  const long long stride = (long long)gridDim.x * blockDim.x;
  const long long gid = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  for (long long v = gid; v < nv; v += stride) {
    float f[L::n];
    L::load(x, v, f);
#pragma unroll
    for (int i = 0; i < L::n; ++i) f[i] = act_op<OP>(f[i], p, st);
    L::store(y, v, f);
  }
  for (long long i = nv * L::n + gid; i < n; i += stride)
    store_float(y, i, act_op<OP>(load_as_float(x, i), p, st));
}

// Both code tables of a 16-bit format by the pipeline's own stages: entry i
// of row 0 the tanh code of z = i - half, of row 1 the e^r code.
__global__ void code_tables_kernel(short* __restrict__ tab, int half, const CordicParams p) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  const int n = 2 * half + 1;
  if (i >= n) return;
  const PipelineStages st{p};
  tab[i] = (short)st.tanh_code(i - half);
  tab[n + i] = (short)st.exp_code(i - half);
}

template <typename T>
__global__ void silu_mul_kernel(const T* __restrict__ gate, const T* __restrict__ up,
                                T* __restrict__ y, long long n, const CordicParams p) {
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += stride) {
    const float g = load_as_float(gate, i);
    const float u = load_as_float(up, i);
    const float s = wide_sigmoid_f(g, p);
    store_float(y, i, (u * g) * s);  // left-to-right, as u * g * s in JAX
  }
}

// The table route of silu_mul_2d: sigmoid_wide's tanh stage from `tab` (the
// tanh-code table). vec: 16 bytes a thread (the three pointers are 16-byte
// aligned and the launch has the elements to fill the card that way), so
// whole vectors go first and the tail element by element; otherwise an
// element a thread.
template <typename T>
__global__ void __launch_bounds__(kTabThreads)
    silu_mul_kernel_tab(const T* __restrict__ gate, const T* __restrict__ up,
                        T* __restrict__ y, long long n, int vec, const CordicParams p,
                        const short* __restrict__ tab, int half) {
  const TableStages st{tab, nullptr, half};
  using L = Lanes16<T>;
  const long long nv = vec ? n / L::n : 0;
  const long long stride = (long long)gridDim.x * blockDim.x;
  const long long gid = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  for (long long v = gid; v < nv; v += stride) {
    float g[L::n], u[L::n], s[L::n];
    int k[L::n];
    L::load(gate, v, g);
    L::load(up, v, u);
    // every lane's table load first; then the doublings of all lanes side
    // by side, as many steps as the largest k among them (a lane keeps its
    // first k, as the reference's select does), so the lanes' divides
    // overlap; then the product
    int kmax = 0;
#pragma unroll
    for (int i = 0; i < L::n; ++i) {
      s[i] = wide_core(g[i], p, st, k[i]);
      kmax = max(kmax, k[i]);
    }
    for (int d = 0; d < kmax; ++d) {
#pragma unroll
      for (int i = 0; i < L::n; ++i) {
        const float dbl = wide_doubled(s[i]);
        s[i] = k[i] > d ? dbl : s[i];
      }
    }
#pragma unroll
    for (int i = 0; i < L::n; ++i) g[i] = (u[i] * g[i]) * s[i];
    L::store(y, v, g);
  }
  for (long long i = nv * L::n + gid; i < n; i += stride) {
    const float g = load_as_float(gate, i);
    const float u = load_as_float(up, i);
    const float s = wide_sigmoid_f(g, p, st);
    store_float(y, i, (u * g) * s);
  }
}

// Integer codes in and out: the stage of cordic.cuh with no float boundary.
// The result is already wrapped to the format's width, so the store into
// the input's dtype keeps it (as .astype(o_ref.dtype) in the reference).
template <typename T>
__global__ void act_q_kernel(const T* __restrict__ x, T* __restrict__ y, long long n,
                             const CordicParams p) {
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += stride) {
    y[i] = (T)cordic_sigmoid_q((int)x[i], p);
  }
}

// The part of the sigmoid-code table a code dtype reaches: int16 codes
// halve into [-16384, 16383], entries [16384, 49152).
template <typename T>
struct QTab {
  static constexpr int lo = sizeof(T) == 2 ? (1 << 14) : 0;
  static constexpr int len = sizeof(T) == 2 ? (1 << 15) : (1 << 16);
  static constexpr int threads = sizeof(T) == 2 ? 512 : 1024;
};

// The sigmoid code of code c from `t` (the reached part of the table).
template <typename T>
__device__ __forceinline__ int q_look(const short* t, int c) {
  return t[(((c >> 1) & 0xFFFF) ^ 0x8000) - QTab<T>::lo];
}

// 16 bytes of codes: 8 int16 or 4 int32; a code sign-extends to int and
// its sigmoid code (a 16-bit value) is stored back in the input's width.
template <typename T>
__device__ __forceinline__ uint4 q_look16(const short* t, uint4 a) {
  unsigned w[4] = {a.x, a.y, a.z, a.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    if constexpr (sizeof(T) == 2) {
      const unsigned lo = q_look<T>(t, (short)(w[i] & 0xffffu));
      const unsigned hi = q_look<T>(t, (short)(w[i] >> 16));
      w[i] = (lo & 0xffffu) | (hi << 16);
    } else {
      w[i] = (unsigned)q_look<T>(t, (int)w[i]);
    }
  }
  return make_uint4(w[0], w[1], w[2], w[3]);
}

// act_q_2d's table route. vec: both pointers are 16-byte aligned, so whole
// vectors go first and the tail element by element.
template <typename T>
__global__ void __launch_bounds__(QTab<T>::threads)
    act_q_kernel_tab(const T* __restrict__ x, T* __restrict__ y, long long n, int vec,
                     const short* __restrict__ tab) {
  extern __shared__ uint4 q_smem[];
  const uint4* src = reinterpret_cast<const uint4*>(tab + QTab<T>::lo);
  for (int i = threadIdx.x; i < QTab<T>::len / 8; i += blockDim.x) q_smem[i] = src[i];
  __syncthreads();
  const short* t = reinterpret_cast<const short*>(q_smem);
  constexpr int L = 16 / sizeof(T);
  const long long nv = vec ? n / L : 0;
  const long long stride = (long long)gridDim.x * blockDim.x;
  const long long gid = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const uint4* xv = reinterpret_cast<const uint4*>(x);
  uint4* yv = reinterpret_cast<uint4*>(y);
  long long v = gid;
  for (; v + stride < nv; v += 2 * stride) {
    const uint4 a = __ldcs(xv + v);
    const uint4 b = __ldcs(xv + v + stride);
    __stcs(yv + v, q_look16<T>(t, a));
    __stcs(yv + v + stride, q_look16<T>(t, b));
  }
  if (v < nv) __stcs(yv + v, q_look16<T>(t, __ldcs(xv + v)));
  for (long long i = nv * L + gid; i < n; i += stride)
    y[i] = (T)q_look<T>(t, (int)x[i]);
}

// The sigmoid-code table by the pipeline: entry i is the code of z =
// i - 32768, fed as the code 2z, whose halving is z.
__global__ void sigmoid_q_table_kernel(short* __restrict__ tab, const CordicParams p) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i < (1 << 16)) tab[i] = (short)cordic_sigmoid_q(2 * (i - (1 << 15)), p);
}

constexpr int kThreads = 256;

int sm_count() {
  static int sms = 0;
  if (sms == 0) {
    int dev = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  }
  return sms;
}

unsigned grid_for(long long n) {
  const long long blocks = (n + kThreads - 1) / kThreads;
  const long long cap = (long long)sm_count() * 16;
  return (unsigned)(blocks < cap ? (blocks > 0 ? blocks : 1) : cap);
}

// Persistent grid of the table route: as many CTAs as are resident on the
// card at once, fewer when the launch has less work.
template <typename T, int OP>
int launch_tab(const void* x, void* y, long long n, const CordicParams& p, const void* tab,
               int half, cudaStream_t s) {
  static int resident = 0;
  if (resident == 0) {
    int per_sm = 0;
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, act_kernel_tab<T, OP>,
                                                  kTabThreads, 0);
    resident = (per_sm > 0 ? per_sm : 1) * sm_count();
  }
  constexpr int lanes = 16 / sizeof(T);
  const int vec = ((unsigned long long)x % 16 == 0 && (unsigned long long)y % 16 == 0) ? 1 : 0;
  const long long work = vec ? (n + lanes - 1) / lanes : n;
  long long grid = (work + kTabThreads - 1) / kTabThreads;
  grid = grid < 1 ? 1 : (grid > resident ? resident : grid);
  act_kernel_tab<T, OP><<<(unsigned)grid, kTabThreads, 0, s>>>((const T*)x, (T*)y, n, vec, p,
                                                              (const short*)tab, half);
  return (int)cudaGetLastError();
}

// 16 bytes a lane group: every pointer 16-byte aligned.
bool aligned16(const void* a, const void* b, const void* c) {
  return ((unsigned long long)a | (unsigned long long)b | (unsigned long long)c) % 16 == 0;
}

template <typename T>
int launch_silu_mul_tab(const void* gate, const void* up, void* y, long long n,
                        const CordicParams& p, const void* tab, int half, cudaStream_t s) {
  static int resident = 0;
  if (resident == 0) {
    int per_sm = 0;
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, silu_mul_kernel_tab<T>,
                                                  kTabThreads, 0);
    resident = (per_sm > 0 ? per_sm : 1) * sm_count();
  }
  constexpr int lanes = 16 / sizeof(T);
  // a launch of fewer vectors than the card holds threads (a decode step's
  // 4 x 11008) takes an element a thread: 8 times the CTAs, on every SM
  const int vec = aligned16(gate, up, y) && n / lanes >= (long long)resident * kTabThreads;
  const long long work = vec ? (n + lanes - 1) / lanes : n;
  long long grid = (work + kTabThreads - 1) / kTabThreads;
  grid = grid < 1 ? 1 : (grid > resident ? resident : grid);
  silu_mul_kernel_tab<T><<<(unsigned)grid, kTabThreads, 0, s>>>(
      (const T*)gate, (const T*)up, (T*)y, n, vec, p, (const short*)tab, half);
  return (int)cudaGetLastError();
}

// Persistent grid of act_q_2d's table route: as many CTAs as are resident
// on the card at once (the table's shared-memory copy sets how many an SM
// holds), fewer when the launch has less work.
template <typename T>
int launch_act_q_tab(const void* x, void* y, long long n, const void* tab, cudaStream_t s) {
  constexpr int threads = QTab<T>::threads;
  constexpr int smem = QTab<T>::len * 2;
  static int resident = 0;
  if (resident == 0) {
    const auto kern = act_q_kernel_tab<T>;
    cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    cudaFuncSetAttribute(kern, cudaFuncAttributePreferredSharedMemoryCarveout,
                         (int)cudaSharedmemCarveoutMaxShared);
    int per_sm = 0;
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kern, threads, smem);
    resident = (per_sm > 0 ? per_sm : 1) * sm_count();
  }
  constexpr int lanes = 16 / sizeof(T);
  const int vec = ((unsigned long long)x | (unsigned long long)y) % 16 == 0 ? 1 : 0;
  const long long work = vec ? (n + 2 * lanes - 1) / (2 * lanes) : n;
  long long grid = (work + threads - 1) / threads;
  grid = grid < 1 ? 1 : (grid > resident ? resident : grid);
  act_q_kernel_tab<T><<<(unsigned)grid, threads, smem, s>>>((const T*)x, (T*)y, n, vec,
                                                            (const short*)tab);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_tab_op(int op, const void* x, void* y, long long n, const CordicParams& p,
                  const void* tab, int half, cudaStream_t s) {
  switch (op) {
    case OP_SIGMOID: return launch_tab<T, OP_SIGMOID>(x, y, n, p, tab, half, s);
    case OP_TANH: return launch_tab<T, OP_TANH>(x, y, n, p, tab, half, s);
    case OP_SIGMOID_WIDE: return launch_tab<T, OP_SIGMOID_WIDE>(x, y, n, p, tab, half, s);
    case OP_SILU: return launch_tab<T, OP_SILU>(x, y, n, p, tab, half, s);
    case OP_EXP: return launch_tab<T, OP_EXP>(x, y, n, p, tab, half, s);
    case OP_SOFTPLUS: return launch_tab<T, OP_SOFTPLUS>(x, y, n, p, tab, half, s);
    case OP_ELU: return launch_tab<T, OP_ELU>(x, y, n, p, tab, half, s);
    case OP_GELU_ERF: return launch_tab<T, OP_GELU_ERF>(x, y, n, p, tab, half, s);
    default: return (int)cudaErrorInvalidValue;  // log has no table stage
  }
}

}  // namespace

// tab: the op's code table (null: the pipeline route), its codes
// [-half, half].
extern "C" int cordic_act_2d(const void* x, void* y, long long n, int op, int dtype,
                             const CordicParams* p, const void* tab, int half, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (n <= 0) return (int)cudaGetLastError();
  if (tab != nullptr)
    return dtype == 0 ? launch_tab_op<float>(op, x, y, n, *p, tab, half, s)
                      : launch_tab_op<__nv_bfloat16>(op, x, y, n, *p, tab, half, s);
  const unsigned grid = grid_for(n);
  if (dtype == 0)
    act_kernel<float><<<grid, kThreads, 0, s>>>((const float*)x, (float*)y, n, op, *p);
  else
    act_kernel<__nv_bfloat16><<<grid, kThreads, 0, s>>>(
        (const __nv_bfloat16*)x, (__nv_bfloat16*)y, n, op, *p);
  return (int)cudaGetLastError();
}

// tab: a (2, 2 half + 1) int16 buffer; row 0 gets the tanh codes, row 1
// the e^r codes of [-half, half].
extern "C" int cordic_code_tables(void* tab, int half, const CordicParams* p, void* stream) {
  const int n = 2 * half + 1;
  code_tables_kernel<<<(n + kThreads - 1) / kThreads, kThreads, 0, (cudaStream_t)stream>>>(
      (short*)tab, half, *p);
  return (int)cudaGetLastError();
}

// tab: the tanh-code table (null: the pipeline route), its codes
// [-half, half].
extern "C" int cordic_silu_mul_2d(const void* gate, const void* up, void* y, long long n,
                                  int dtype, const CordicParams* p, const void* tab,
                                  int half, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (n > 0 && tab != nullptr)
    return dtype == 0 ? launch_silu_mul_tab<float>(gate, up, y, n, *p, tab, half, s)
                      : launch_silu_mul_tab<__nv_bfloat16>(gate, up, y, n, *p, tab, half, s);
  if (n > 0) {
    const unsigned grid = grid_for(n);
    if (dtype == 0)
      silu_mul_kernel<float><<<grid, kThreads, 0, s>>>(
          (const float*)gate, (const float*)up, (float*)y, n, *p);
    else
      silu_mul_kernel<__nv_bfloat16><<<grid, kThreads, 0, s>>>(
          (const __nv_bfloat16*)gate, (const __nv_bfloat16*)up, (__nv_bfloat16*)y, n,
          *p);
  }
  return (int)cudaGetLastError();
}

// dtype: 0 int16, 1 int32. tab: the sigmoid-code table (null: the
// pipeline route).
extern "C" int cordic_act_q_2d(const void* x, void* y, long long n, int dtype,
                               const CordicParams* p, const void* tab, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (n > 0 && tab != nullptr)
    return dtype == 0 ? launch_act_q_tab<short>(x, y, n, tab, s)
                      : launch_act_q_tab<int>(x, y, n, tab, s);
  if (n > 0) {
    const unsigned grid = grid_for(n);
    if (dtype == 0)
      act_q_kernel<short><<<grid, kThreads, 0, s>>>((const short*)x, (short*)y, n, *p);
    else
      act_q_kernel<int><<<grid, kThreads, 0, s>>>((const int*)x, (int*)y, n, *p);
  }
  return (int)cudaGetLastError();
}

// tab: 65,536 int16 entries, the sigmoid code of every z in [-32768, 32767].
extern "C" int cordic_sigmoid_q_table(void* tab, const CordicParams* p, void* stream) {
  sigmoid_q_table_kernel<<<(1 << 16) / kThreads, kThreads, 0, (cudaStream_t)stream>>>(
      (short*)tab, *p);
  return (int)cudaGetLastError();
}

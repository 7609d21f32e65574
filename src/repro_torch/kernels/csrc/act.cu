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
// What bounds it here: integer operations. Each element runs the unrolled
// 26-stage shift-add pipeline (8 radix-2, 4 radix-4, 14 LVC stages: at
// least ~310 INT32 operations) against 4-12 bytes of traffic, and the card
// has 64 INT32 lanes per SM against 3.35 TB/s, so the integer ALU saturates
// long before memory does (exp: ~170 per element, log: ~150, softplus
// both legs). The design is one element per thread over a
// grid-stride loop: no shared memory, no synchronisation, every stage in
// registers with its ROM entries at constant offsets of the parameter bank.
// The TPU's (rows, 1024) tiling is gone; the wrappers pass flat element
// counts.
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

__device__ __forceinline__ float act_one(float xf, int op, const CordicParams& p) {
  switch (op) {
    case OP_SIGMOID: {
      const int xq = quantize_f(fminf(fmaxf(xf, -1.0f), 1.0f), p.fb, p.bits);
      return dequantize_f(cordic_sigmoid_q(xq, p), p.fb);
    }
    case OP_TANH: {
      // |z| <= 0.5 clamp: direct angle feed, as _act_kernel does
      const int zq = quantize_f(fminf(fmaxf(xf, -0.5f), 0.5f), p.fb, p.bits);
      return dequantize_f(cordic_tanh_q(zq, p), p.fb);
    }
    case OP_SIGMOID_WIDE:
      return wide_sigmoid_f(xf, p);
    case OP_SILU:
      return xf * wide_sigmoid_f(xf, p);
    case OP_EXP:
      return exp_q(xf, p);
    case OP_LOG:
      return log_q(xf, p);
    case OP_SOFTPLUS:
      // log(1 + e^x) = relu(x) + log(1 + e^-|x|), both CORDIC legs
      return fmaxf(xf, 0.0f) + log_q(1.0f + exp_q(-fabsf(xf), p), p);
    case OP_ELU:
      return xf > 0.0f ? xf : exp_q(fminf(xf, 0.0f), p) - 1.0f;
    default:  // OP_GELU_ERF: 0.5 x (1 + erf(x / sqrt 2))
      return 0.5f * xf * (1.0f + erf_q(xf * CORDIC_INV_SQRT2, p));
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

constexpr int kThreads = 256;

unsigned grid_for(long long n) {
  static int sms = 0;
  if (sms == 0) {
    int dev = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  }
  const long long blocks = (n + kThreads - 1) / kThreads;
  const long long cap = (long long)sms * 16;
  return (unsigned)(blocks < cap ? (blocks > 0 ? blocks : 1) : cap);
}

}  // namespace

extern "C" int cordic_act_2d(const void* x, void* y, long long n, int op, int dtype,
                             const CordicParams* p, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (n > 0) {
    const unsigned grid = grid_for(n);
    if (dtype == 0)
      act_kernel<float><<<grid, kThreads, 0, s>>>((const float*)x, (float*)y, n, op, *p);
    else
      act_kernel<__nv_bfloat16><<<grid, kThreads, 0, s>>>(
          (const __nv_bfloat16*)x, (__nv_bfloat16*)y, n, op, *p);
  }
  return (int)cudaGetLastError();
}

extern "C" int cordic_silu_mul_2d(const void* gate, const void* up, void* y, long long n,
                                  int dtype, const CordicParams* p, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
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

// dtype: 0 int16, 1 int32.
extern "C" int cordic_act_q_2d(const void* x, void* y, long long n, int dtype,
                               const CordicParams* p, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (n > 0) {
    const unsigned grid = grid_for(n);
    if (dtype == 0)
      act_q_kernel<short><<<grid, kThreads, 0, s>>>((const short*)x, (short*)y, n, *p);
    else
      act_q_kernel<int><<<grid, kThreads, 0, s>>>((const int*)x, (int*)y, n, *p);
  }
  return (int)cudaGetLastError();
}

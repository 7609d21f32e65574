// Whole-row CORDIC softmax and log-softmax on Hopper.
//
// Replaces softmax_2d of repro/kernels/softmax_cordic.py (:161; _rowwise_call
// :138, pallas_call :150, body _softmax_kernel :57): masked row max, dyadic
// reduction u = k ln2 + r, Q2.14 cosh+sinh rotation for e^r, row sum,
// exponent-field frexp of the sum, R2-LVC normalisation; lanes more than
// e^-20 below the row max are exactly 0.
//
// What bounds it here: integer operations. Every lane runs the rotation
// twice (once for the sum, once for the normalisation, instead of keeping
// the codes of a whole row) plus the 14-stage LVC divide, at least ~500
// INT32 operations against 8 bytes of traffic.
//
// Design: one block per row, three sweeps over the row (max, sum,
// normalise), which replaces the TPU's whole-row VMEM block. The TPU pads
// columns to 128 lanes and masks on n_valid; here each thread masks on the
// row length. The row sum is taken left to right, one chunk of blockDim lanes
// at a time, by one thread: the same order as the plain PyTorch version, so
// the two agree bit for bit. XLA reduces in another order, so against the
// JAX kernel a lane can move by one Q2.14 code step when the sum lands on a
// rounding edge of its Q2.14 mantissa.
//
// cordic_log_softmax_2d replaces log_softmax_2d of the same file (:171; body
// _log_softmax_kernel :93): the same max and exp sweeps, then ln S of the
// row sum by the hyperbolic-vectoring log leg (once per row), and
// y = (x - max) - ln S; lanes masked with -1e30 keep their huge negative
// value. Its rows are a vocabulary wide (64000 lanes), so one thread cannot
// sum them: thread t of kLogThreads sums lanes t, t + T, ... in order, and a
// fixed pairwise tree adds the T partials. log_softmax_2d_plain replays that
// order (softmax_cordic._block_sum), so the two agree bit for bit. What bounds
// it: integer operations again, one rotation per lane (~170 INT32
// operations) against 8 bytes; the row is read three times (max, exp, out),
// the second and third reads mostly from L2 (a 64000-lane row is 256 KB).
#include "cordic.cuh"

namespace {

constexpr int kThreads = 128;
// threads per row of the log-softmax: LOG_SOFTMAX_T in softmax_cordic.py
constexpr int kLogThreads = 256;

// Row max over a block of NT threads (exact in any order).
template <int NT>
__device__ __forceinline__ float block_row_max(const float* xr, int cols,
                                               float* warp_max) {
  const int tid = threadIdx.x;
  float m = -INFINITY;
  for (int c = tid; c < cols; c += NT) m = fmaxf(m, xr[c]);
  for (int off = 16; off > 0; off >>= 1) m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, off));
  if ((tid & 31) == 0) warp_max[tid >> 5] = m;
  __syncthreads();
  m = warp_max[0];
  for (int w = 1; w < NT / 32; ++w) m = fmaxf(m, warp_max[w]);
  return m;
}

__global__ void softmax_kernel(const float* __restrict__ x, float* __restrict__ y,
                               int cols, const CordicParams p) {
  __shared__ float chunk[kThreads];
  __shared__ float warp_max[kThreads / 32];
  __shared__ float row_sum;
  const int tid = threadIdx.x;
  const float* xr = x + (long long)blockIdx.x * cols;
  float* yr = y + (long long)blockIdx.x * cols;

  // sweep 1: row max
  const float m = block_row_max<kThreads>(xr, cols, warp_max);

  // sweep 2: CORDIC e^u per lane, summed left to right
  float ssum = 0.0f;
  for (int base = 0; base < cols; base += kThreads) {
    const int c = base + tid;
    chunk[tid] = c < cols ? lane_exp(xr[c] - m, p) : 0.0f;
    __syncthreads();
    if (tid == 0) {
      const int n = min(kThreads, cols - base);
      for (int i = 0; i < n; ++i) ssum = ssum + chunk[i];
    }
    __syncthreads();
  }
  if (tid == 0) row_sum = ssum;
  __syncthreads();

  // sweep 3: R2-LVC normalisation against the row sum
  const RowSum rs = row_sum_frexp(row_sum, p);
  for (int c = tid; c < cols; c += kThreads) yr[c] = lane_prob(xr[c] - m, rs, p);
}

__global__ void log_softmax_rows_kernel(const float* __restrict__ x, float* __restrict__ y,
                                   int cols, const CordicParams p) {
  __shared__ float part[kLogThreads];
  __shared__ float warp_max[kLogThreads / 32];
  const int tid = threadIdx.x;
  const float* xr = x + (long long)blockIdx.x * cols;
  float* yr = y + (long long)blockIdx.x * cols;

  // sweep 1: row max
  const float m = block_row_max<kLogThreads>(xr, cols, warp_max);

  // sweep 2: CORDIC e^u, strided per-thread sums, then the pairwise tree
  float acc = 0.0f;
  for (int c = tid; c < cols; c += kLogThreads) acc = acc + lane_exp(xr[c] - m, p);
  part[tid] = acc;
  __syncthreads();
  for (int s = kLogThreads / 2; s > 0; s >>= 1) {
    if (tid < s) part[tid] = part[tid] + part[tid + s];
    __syncthreads();
  }

  // sweep 3: y = u - ln S
  const float lns = log_q(part[0], p);
  for (int c = tid; c < cols; c += kLogThreads) yr[c] = (xr[c] - m) - lns;
}

}  // namespace

extern "C" int cordic_softmax_2d(const void* x, void* y, int rows, int cols,
                                 const CordicParams* p, void* stream) {
  if (rows > 0 && cols > 0)
    softmax_kernel<<<rows, kThreads, 0, (cudaStream_t)stream>>>(
        (const float*)x, (float*)y, cols, *p);
  return (int)cudaGetLastError();
}

extern "C" int cordic_log_softmax_2d(const void* x, void* y, int rows, int cols,
                                     const CordicParams* p, void* stream) {
  if (rows > 0 && cols > 0)
    log_softmax_rows_kernel<<<rows, kLogThreads, 0, (cudaStream_t)stream>>>(
        (const float*)x, (float*)y, cols, *p);
  return (int)cudaGetLastError();
}

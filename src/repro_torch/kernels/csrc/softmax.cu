// Whole-row CORDIC softmax on Hopper.
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
#include "cordic.cuh"

namespace {

constexpr int kThreads = 128;

__global__ void softmax_kernel(const float* __restrict__ x, float* __restrict__ y,
                               int cols, const CordicParams p) {
  __shared__ float chunk[kThreads];
  __shared__ float warp_max[kThreads / 32];
  __shared__ float row_sum;
  const int tid = threadIdx.x;
  const float* xr = x + (long long)blockIdx.x * cols;
  float* yr = y + (long long)blockIdx.x * cols;

  // sweep 1: row max (exact in any order)
  float m = -INFINITY;
  for (int c = tid; c < cols; c += kThreads) m = fmaxf(m, xr[c]);
  for (int off = 16; off > 0; off >>= 1) m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, off));
  if ((tid & 31) == 0) warp_max[tid >> 5] = m;
  __syncthreads();
  m = warp_max[0];
  for (int w = 1; w < kThreads / 32; ++w) m = fmaxf(m, warp_max[w]);

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

}  // namespace

extern "C" int cordic_softmax_2d(const void* x, void* y, int rows, int cols,
                                 const CordicParams* p, void* stream) {
  if (rows > 0 && cols > 0)
    softmax_kernel<<<rows, kThreads, 0, (cudaStream_t)stream>>>(
        (const float*)x, (float*)y, cols, *p);
  return (int)cudaGetLastError();
}

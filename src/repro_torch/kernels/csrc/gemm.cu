// Row-count-invariant matrix products on Hopper: the float32 route.
//
// Replaces no TPU kernel: the JAX package leaves these products to XLA.
// They are the paged prefill's (models/common.py ``INVARIANT``, ROADMAP
// B.10). cuBLAS picks its GEMM kernel, tiling and reduction split by the
// problem's shape, so on the card an output element's sum order, and so
// its bits, follow the launch's row count (ROADMAP F6): a position's K, V
// and logits would depend on how many rows and how wide a row its prefill
// dispatch held, and a prefix-cache hit would not read the bytes its own
// prefill would have written.
//
// Two routes share that contract, chosen by dtype alone (kernels/gemm.py
// ``gemm_route``): two bf16 operands take gemm_tc.cu (wgmma on the tensor
// cores, one instruction shape, one CTA tile and one k-walk for every
// launch; held by invariance and a bound against float64), and any float32
// operand takes this kernel: TF32 would drop 13 of a float32 operand's
// mantissa bits, so a float32 product never reaches the tensor cores. On
// the paged prefill's path that is the attention's scores and P.V
// (models/attention.py ``_scores``, ``_pv``: float32 under the default
// score dtype).
//
// invariant_gemm: C[b] = A[b] (M x K) . B[b] (K x N), a float32 operand
// and a float32 or bf16 one, float32 accumulation, one rounding to the output's dtype. An
// output element is ONE chain over k = 0 .. K-1 in order: acc starts at
// 0, then acc = acc + a*b with the product rounded to float32 first
// (__fmul_rn / __fadd_rn: never a fused multiply-add; a bf16 product is
// exact in float32). Nothing of that depends on M, the batch count, the
// element's place or the launch's tiling, which is chosen by the shape
// (F7). kernels/gemm.py ``gemm_plain`` replays it in K vectorized steps, so
// kernel and plain agree bit for bit.
//
// What bounds it: float32 instructions outside the tensor cores, a product
// and an add an element and k (2MNK against the card's 67 TFLOP/s float32
// peak). Design: a CTA of 256
// threads computes a BM x BN tile, each thread a TM x TN micro-tile in
// registers (TM x TN independent chains, so one chain an element costs no
// parallelism); the operands' BK-deep slices are staged in shared memory as
// float32 (bf16 converted on load, exactly), the next slice loaded into
// registers while the current one is used. Two tilings, by shape: 128 x 128
// (8 x 8 a thread) when the output fills the card's SMs, 32 x 64 (2 x 4 a
// thread) when it does not (a prefill of a few short rows).

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kBK = 16;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ void put(float* p, float v) { *p = v; }
__device__ __forceinline__ void put(__nv_bfloat16* p, float v) { *p = __float2bfloat16_rn(v); }

// C (batch, M, N) contiguous; A element (z, m, k) at z*sab + m*sam + k*sak,
// B element (z, k, n) at z*sbb + k*sbk + n*sbn (element strides).
template <typename TA, typename TB, typename TC, int BM, int BN, int TM, int TN>
__global__ void __launch_bounds__(kThreads)
gemm_kernel(const TA* __restrict__ A, long long sab, long long sam, long long sak,
            const TB* __restrict__ B, long long sbb, long long sbk, long long sbn,
            TC* __restrict__ C, int M, int N, int K) {
  static_assert((BM / TM) * (BN / TN) == kThreads, "one micro-tile a thread");
  constexpr int A_PER = BM * kBK / kThreads;
  constexpr int B_PER = kBK * BN / kThreads;
  // +4: column loads stay 16-byte aligned, slice stores spread over banks
  __shared__ __align__(16) float As[kBK][BM + 4];
  __shared__ __align__(16) float Bs[kBK][BN + 4];

  const int tid = threadIdx.x;
  const long long z = blockIdx.z;
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  A += z * sab;
  B += z * sbb;
  C += z * (long long)M * N;
  // the load order follows the unit stride, so neighbouring threads read
  // neighbouring addresses
  const bool a_kfast = sak == 1, b_nfast = sbn == 1;
  float ra[A_PER], rb[B_PER];

  auto a_at = [&](int e, int& mm, int& kk) {
    if (a_kfast) { kk = e % kBK; mm = e / kBK; } else { mm = e % BM; kk = e / BM; }
  };
  auto b_at = [&](int e, int& kk, int& nn) {
    if (b_nfast) { nn = e % BN; kk = e / BN; } else { kk = e % kBK; nn = e / kBK; }
  };
  auto load = [&](int k0) {
#pragma unroll
    for (int i = 0; i < A_PER; ++i) {
      int mm, kk;
      a_at(tid + i * kThreads, mm, kk);
      const int gm = m0 + mm, gk = k0 + kk;
      ra[i] = (gm < M && gk < K) ? to_f32(A[gm * sam + gk * sak]) : 0.f;
    }
#pragma unroll
    for (int i = 0; i < B_PER; ++i) {
      int kk, nn;
      b_at(tid + i * kThreads, kk, nn);
      const int gk = k0 + kk, gn = n0 + nn;
      rb[i] = (gk < K && gn < N) ? to_f32(B[gk * sbk + gn * sbn]) : 0.f;
    }
  };
  auto stash = [&]() {
#pragma unroll
    for (int i = 0; i < A_PER; ++i) {
      int mm, kk;
      a_at(tid + i * kThreads, mm, kk);
      As[kk][mm] = ra[i];
    }
#pragma unroll
    for (int i = 0; i < B_PER; ++i) {
      int kk, nn;
      b_at(tid + i * kThreads, kk, nn);
      Bs[kk][nn] = rb[i];
    }
  };

  const int tx = tid % (BN / TN), ty = tid / (BN / TN);
  float acc[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0.f;

  auto step = [&](int kk) {
    float a[TM], b[TN];
#pragma unroll
    for (int i = 0; i < TM; ++i) a[i] = As[kk][ty * TM + i];
#pragma unroll
    for (int j = 0; j < TN; ++j) b[j] = Bs[kk][tx * TN + j];
#pragma unroll
    for (int i = 0; i < TM; ++i)
#pragma unroll
      for (int j = 0; j < TN; ++j) acc[i][j] = __fadd_rn(acc[i][j], __fmul_rn(a[i], b[j]));
  };

  load(0);
  for (int k0 = 0; k0 < K; k0 += kBK) {
    __syncthreads();  // the previous slice's readers are done
    stash();
    __syncthreads();
    if (k0 + kBK < K) load(k0 + kBK);
    if (k0 + kBK <= K) {
#pragma unroll
      for (int kk = 0; kk < kBK; ++kk) step(kk);
    } else {
      // the last slice: only the real k, so no element adds a term past K
      for (int kk = 0; kk < K - k0; ++kk) step(kk);
    }
  }
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int gm = m0 + ty * TM + i;
    if (gm >= M) continue;
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const int gn = n0 + tx * TN + j;
      if (gn < N) put(C + (long long)gm * N + gn, acc[i][j]);
    }
  }
}

template <typename TA, typename TB, typename TC>
int launch_gemm(const void* a, long long sab, long long sam, long long sak, const void* b,
                long long sbb, long long sbk, long long sbn, void* c, int batch, int M,
                int N, int K, int wide, cudaStream_t s) {
  const TA* A = (const TA*)a;
  const TB* B = (const TB*)b;
  TC* C = (TC*)c;
  if (wide) {
    dim3 grid((N + 127) / 128, (M + 127) / 128, batch);
    gemm_kernel<TA, TB, TC, 128, 128, 8, 8>
        <<<grid, kThreads, 0, s>>>(A, sab, sam, sak, B, sbb, sbk, sbn, C, M, N, K);
  } else {
    dim3 grid((N + 63) / 64, (M + 31) / 32, batch);
    gemm_kernel<TA, TB, TC, 32, 64, 2, 4>
        <<<grid, kThreads, 0, s>>>(A, sab, sam, sak, B, sbb, sbk, sbn, C, M, N, K);
  }
  return (int)cudaGetLastError();
}

template <typename TA, typename TB>
int launch_out(int c_dtype, const void* a, long long sab, long long sam, long long sak,
               const void* b, long long sbb, long long sbk, long long sbn, void* c, int batch,
               int M, int N, int K, int wide, cudaStream_t s) {
  return c_dtype == 0
             ? launch_gemm<TA, TB, float>(a, sab, sam, sak, b, sbb, sbk, sbn, c, batch, M, N, K,
                                          wide, s)
             : launch_gemm<TA, TB, __nv_bfloat16>(a, sab, sam, sak, b, sbb, sbk, sbn, c, batch,
                                                  M, N, K, wide, s);
}

}  // namespace

// dtype codes: 0 float32, 1 bfloat16 (build.DTYPE_CODE); at least one
// operand float32 (two bf16 operands are gemm_tc.cu's). ``wide`` picks the
// 128 x 128 tiling (kernels/gemm.py ``wide_tiles``); either gives the same
// bits.
extern "C" int invariant_gemm(const void* a, int a_dtype, long long sab, long long sam,
                              long long sak, const void* b, int b_dtype, long long sbb,
                              long long sbk, long long sbn, void* c, int c_dtype, int batch,
                              int M, int N, int K, int wide, void* stream) {
  if (batch <= 0 || M <= 0 || N <= 0 || K <= 0) return (int)cudaGetLastError();
  if (batch > 65535 || (a_dtype | b_dtype | c_dtype) & ~1 || (a_dtype & b_dtype))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (a_dtype == 0 && b_dtype == 0)
    return launch_out<float, float>(c_dtype, a, sab, sam, sak, b, sbb, sbk, sbn, c, batch, M, N,
                                    K, wide, s);
  if (a_dtype == 0)
    return launch_out<float, __nv_bfloat16>(c_dtype, a, sab, sam, sak, b, sbb, sbk, sbn, c, batch,
                                            M, N, K, wide, s);
  return launch_out<__nv_bfloat16, float>(c_dtype, a, sab, sam, sak, b, sbb, sbk, sbn, c, batch, M,
                                          N, K, wide, s);
}

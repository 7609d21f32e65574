// Paged GQA decode attention on Hopper.
//
// Replaces gqa_decode of repro/kernels/paged_attention.py (:291; pallas_call
// :373, body _gqa_kernel :240, _pass_update :197, _exp_codes :139,
// _lane_exp :155, _lane_probs :172). One query row per slot walks that
// slot's block table up to k_len and attends its K/V blocks in place; no
// max_len-sized gather is materialised.
//
// softmax impls:
//   exact          one sweep over the live blocks with the online
//                  (flash-decoding) rescaling recurrence, expf
//   cordic_pallas  three sweeps (row max, CORDIC e^u row sum, lane-exact
//                  R2-LVC probabilities), so the probabilities equal the
//                  CORDIC softmax kernel's lane for lane
//
// What bounds it here: at serving shapes, neither rate. A decode step reads
// a few live blocks per (slot, kv-head) (tens of KB in all), so the kernel
// is a latency chain: load a block, score it, reduce, accumulate. The
// design keeps that chain short and simple: the grid is (slot, kv-head),
// each block reads its own block-table row and loops only over the live
// blocks (c * L < k_len), which replaces the TPU's scalar-prefetched
// BlockSpec walk; a block's K/V tile sits in shared memory; all G query
// rows of the kv-head share it.
//
// Summation orders are fixed and shared with the plain PyTorch version:
// a score is a left-to-right sum over head_dim of q*k products, then times
// the scale; block sums and P.V sums run left to right over the block's
// lanes. Compiled with -fmad=false, so kernel and plain agree bit for bit
// on the CORDIC path; XLA's dot orders differ, hence the reference's own
// f32 tolerance against the JAX kernel.
#include "cordic.cuh"

namespace {

constexpr int kThreads = 128;
constexpr float kNegInf = -1e30f;  // NEG_INF of the reference

template <typename T>
__device__ __forceinline__ float kv_round(float v);
template <>
__device__ __forceinline__ float kv_round<float>(float v) { return v; }
template <>
__device__ __forceinline__ float kv_round<__nv_bfloat16>(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

// TQ: query dtype; TKV: the kv_dtype cast replayed per block; CORDIC: impl.
template <typename TQ, typename TKV, bool CORDIC>
__global__ void gqa_decode_kernel(const TQ* __restrict__ q, const float* __restrict__ k_pool,
                                  const float* __restrict__ v_pool,
                                  const int* __restrict__ tables,
                                  const int* __restrict__ k_len, float* __restrict__ out,
                                  int KH, int G, int hd, int L, int M, float scale,
                                  const CordicParams p) {
  extern __shared__ float smem[];
  float* qs = smem;            // (G, hd)
  float* ks = qs + G * hd;     // (L, hd)
  float* vs = ks + L * hd;     // (L, hd)
  float* sc = vs + L * hd;     // (G, L) scores, then lane weights
  float* acc = sc + G * L;     // (G, hd)
  float* mrow = acc + G * hd;  // (G,) running max
  float* lrow = mrow + G;      // (G,) running sum
  float* alpha = lrow + G;     // (G,) online rescale factor (exact)

  const int b = blockIdx.x, h = blockIdx.y, tid = threadIdx.x;
  const int klen = k_len[b];
  const int* trow = tables + (long long)b * M;
  const long long qoff = ((long long)b * KH + h) * G * hd;

  for (int i = tid; i < G * hd; i += kThreads) {
    qs[i] = load_as_float(q, qoff + i);
    acc[i] = 0.0f;
  }
  for (int g = tid; g < G; g += kThreads) {
    mrow[g] = kNegInf;
    lrow[g] = 0.0f;
  }
  __syncthreads();

  const int live = min(M, (klen + L - 1) / L);  // blocks with c * L < k_len
  const int passes = CORDIC ? 3 : 1;
  for (int pass = 0; pass < passes; ++pass) {
    const bool need_v = !CORDIC || pass == 2;
    for (int c = 0; c < live; ++c) {
      const long long blk = trow[c];
      const int base = c * L;
      for (int i = tid; i < L * hd; i += kThreads) {
        const int l = i / hd, d = i - l * hd;
        const long long off = ((blk * L + l) * KH + h) * hd + d;
        ks[i] = kv_round<TKV>(k_pool[off]);
        if (need_v) vs[i] = kv_round<TKV>(v_pool[off]);
      }
      __syncthreads();
      for (int i = tid; i < G * L; i += kThreads) {
        const int g = i / L, l = i - g * L;
        const float* qr = qs + g * hd;
        const float* kr = ks + l * hd;
        float s = 0.0f;
        for (int d = 0; d < hd; ++d) s = s + qr[d] * kr[d];
        s = s * scale;
        sc[i] = (base + l < klen) ? s : kNegInf;
      }
      __syncthreads();

      if (!CORDIC) {
        for (int g = tid; g < G; g += kThreads) {
          float mx = sc[g * L];
          for (int l = 1; l < L; ++l) mx = fmaxf(mx, sc[g * L + l]);
          const float m_old = mrow[g];
          const float m_new = fmaxf(m_old, mx);
          alpha[g] = expf(m_old - m_new);
          mrow[g] = m_new;
        }
        __syncthreads();
        for (int i = tid; i < G * L; i += kThreads) sc[i] = expf(sc[i] - mrow[i / L]);
        __syncthreads();
        for (int g = tid; g < G; g += kThreads) {
          float bs = 0.0f;
          for (int l = 0; l < L; ++l) bs = bs + sc[g * L + l];
          lrow[g] = lrow[g] * alpha[g] + bs;
        }
        for (int i = tid; i < G * hd; i += kThreads) {
          const int g = i / hd, d = i - g * hd;
          float pv = 0.0f;
          for (int l = 0; l < L; ++l) pv = pv + sc[g * L + l] * vs[l * hd + d];
          acc[i] = acc[i] * alpha[g] + pv;
        }
      } else if (pass == 0) {
        for (int g = tid; g < G; g += kThreads) {
          float mx = sc[g * L];
          for (int l = 1; l < L; ++l) mx = fmaxf(mx, sc[g * L + l]);
          mrow[g] = fmaxf(mrow[g], mx);
        }
      } else if (pass == 1) {
        for (int i = tid; i < G * L; i += kThreads) sc[i] = lane_exp(sc[i] - mrow[i / L], p);
        __syncthreads();
        for (int g = tid; g < G; g += kThreads) {
          float bs = 0.0f;
          for (int l = 0; l < L; ++l) bs = bs + sc[g * L + l];
          lrow[g] = lrow[g] + bs;
        }
      } else {
        for (int i = tid; i < G * L; i += kThreads) {
          const int g = i / L;
          sc[i] = lane_prob(sc[i] - mrow[g], row_sum_frexp(lrow[g], p), p);
        }
        __syncthreads();
        for (int i = tid; i < G * hd; i += kThreads) {
          const int g = i / hd, d = i - g * hd;
          float pv = 0.0f;
          for (int l = 0; l < L; ++l) pv = pv + sc[g * L + l] * vs[l * hd + d];
          acc[i] = acc[i] + pv;
        }
      }
      __syncthreads();
    }
  }

  for (int i = tid; i < G * hd; i += kThreads)
    out[qoff + i] = CORDIC ? acc[i] : acc[i] / lrow[i / hd];
}

template <typename TQ, typename TKV, bool CORDIC>
int launch(const void* q, const void* k_pool, const void* v_pool, const void* tables,
           const void* k_len, void* out, int B, int KH, int G, int hd, int L, int M,
           float scale, const CordicParams& p, cudaStream_t s) {
  auto kern = gqa_decode_kernel<TQ, TKV, CORDIC>;
  const size_t bytes = sizeof(float) * (2 * G * hd + 2 * L * hd + G * L + 3 * G);
  if (bytes > 48 * 1024) {
    const cudaError_t e =
        cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
    if (e != cudaSuccess) return (int)e;
  }
  kern<<<dim3(B, KH), kThreads, bytes, s>>>(
      (const TQ*)q, (const float*)k_pool, (const float*)v_pool, (const int*)tables,
      (const int*)k_len, (float*)out, KH, G, hd, L, M, scale, p);
  return (int)cudaGetLastError();
}

template <typename TQ, typename TKV>
int launch_impl(int impl, const void* q, const void* kp, const void* vp, const void* t,
                const void* kl, void* o, int B, int KH, int G, int hd, int L, int M,
                float scale, const CordicParams& p, cudaStream_t s) {
  return impl ? launch<TQ, TKV, true>(q, kp, vp, t, kl, o, B, KH, G, hd, L, M, scale, p, s)
              : launch<TQ, TKV, false>(q, kp, vp, t, kl, o, B, KH, G, hd, L, M, scale, p, s);
}

}  // namespace

// impl: 0 exact, 1 cordic_pallas. q_dtype / kv_dtype: 0 float32, 1 bfloat16.
extern "C" int paged_gqa_decode(const void* q, int q_dtype, const void* k_pool,
                                const void* v_pool, const void* tables, const void* k_len,
                                void* out, int B, int KH, int G, int hd, int L, int M,
                                float scale, int impl, int kv_dtype, const CordicParams* p,
                                void* stream) {
  if (B == 0) return (int)cudaGetLastError();
  cudaStream_t s = (cudaStream_t)stream;
  const CordicParams& pp = *p;
  if (q_dtype == 0)
    return kv_dtype == 0
               ? launch_impl<float, float>(impl, q, k_pool, v_pool, tables, k_len, out, B,
                                           KH, G, hd, L, M, scale, pp, s)
               : launch_impl<float, __nv_bfloat16>(impl, q, k_pool, v_pool, tables, k_len,
                                                   out, B, KH, G, hd, L, M, scale, pp, s);
  return kv_dtype == 0
             ? launch_impl<__nv_bfloat16, float>(impl, q, k_pool, v_pool, tables, k_len,
                                                 out, B, KH, G, hd, L, M, scale, pp, s)
             : launch_impl<__nv_bfloat16, __nv_bfloat16>(impl, q, k_pool, v_pool, tables,
                                                         k_len, out, B, KH, G, hd, L, M,
                                                         scale, pp, s);
}

// Paged decode attention on Hopper: GQA (paged_gqa_decode) and absorbed-form
// MLA (paged_mla_decode, after the GQA kernel below).
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
//   cordic_fixed   the same three sweeps with the function library's lanes
//                  (lane_exp_fixed, lane_prob_fixed): functions.exp_fixed in
//                  the sum, divide_fixed(exp_fixed(u), S) in the probabilities,
//                  so they equal functions.softmax_fixed's; masked lanes of a
//                  live block clip at e^-80 instead of flushing to 0
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
// Quantized pools (kv_quant, _gqa_kernel :260-275 with the scale-pool
// operands :347-353): the pool type TP is int8_t or int16_t codes, and each
// live block's two per-head scales (k_scale[blk * KH + h], v_scale[...]) are
// read once per block; every staged element is
// kv_round<TKV>(lin_multiply_float(code * code_res, scale)), the CORDIC
// linear-rotation dequant of core/kv_quant.dequantize. The CORDIC impls
// stage K in each of their three passes, so K is dequantized three times:
// a right and simple first kernel; keeping the dequantized block (or the
// scores) across passes is the first thing a redesign removes.
//
// Summation orders are fixed and shared with the plain PyTorch version:
// a score is a left-to-right sum over head_dim of q*k products, then times
// the scale; block sums and P.V sums run left to right over the block's
// lanes. Compiled with -fmad=false, so kernel and plain agree bit for bit
// on the CORDIC path; XLA's dot orders differ, hence the reference's own
// f32 tolerance against the JAX kernel.
#include <cstdint>
#include <type_traits>

#include "cordic.cuh"

namespace {

constexpr int kThreads = 128;
constexpr float kNegInf = -1e30f;  // NEG_INF of the reference

// softmax impl codes: the order of paged_attention.IMPLS
constexpr int kExact = 0, kCordicPallas = 1, kCordicFixed = 2;

// pass 1 and pass 2 lanes of the two CORDIC impls
template <int IMPL>
__device__ __forceinline__ float pass_exp(float u, const CordicParams& p) {
  return IMPL == kCordicFixed ? lane_exp_fixed(u, p) : lane_exp(u, p);
}

template <int IMPL>
__device__ __forceinline__ float pass_prob(float u, float ssum, const CordicParams& p) {
  return IMPL == kCordicFixed ? lane_prob_fixed(u, ssum, p)
                              : lane_prob(u, row_sum_frexp(ssum, p), p);
}

template <typename T>
__device__ __forceinline__ float kv_round(float v);
template <>
__device__ __forceinline__ float kv_round<float>(float v) { return v; }
template <>
__device__ __forceinline__ float kv_round<__nv_bfloat16>(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

// A pool element as float: a float32 pool's value, or a code dequantized
// against its block's scale.
template <typename TP>
__device__ __forceinline__ float pool_value(TP v, float scale, float code_res,
                                            const CordicParams& p) {
  return lin_multiply_float((float)v * code_res, scale, p);
}
template <>
__device__ __forceinline__ float pool_value<float>(float v, float, float,
                                                   const CordicParams&) {
  return v;
}

// TQ: query dtype; TKV: the kv_dtype cast replayed per block; TP: the pool's
// storage (float, or int8_t/int16_t codes with per-block scales); IMPL:
// softmax.
template <typename TQ, typename TKV, typename TP, int IMPL>
__global__ void gqa_decode_kernel(const TQ* __restrict__ q, const TP* __restrict__ k_pool,
                                  const TP* __restrict__ v_pool,
                                  const float* __restrict__ k_scale,
                                  const float* __restrict__ v_scale, float code_res,
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
  constexpr bool CORDIC = IMPL != kExact;
  const int passes = CORDIC ? 3 : 1;
  for (int pass = 0; pass < passes; ++pass) {
    const bool need_v = !CORDIC || pass == 2;
    for (int c = 0; c < live; ++c) {
      const long long blk = trow[c];
      const int base = c * L;
      constexpr bool QUANT = !std::is_same<TP, float>::value;
      const float ksc = QUANT ? k_scale[blk * KH + h] : 1.0f;
      const float vsc = QUANT && need_v ? v_scale[blk * KH + h] : 1.0f;
      for (int i = tid; i < L * hd; i += kThreads) {
        const int l = i / hd, d = i - l * hd;
        const long long off = ((blk * L + l) * KH + h) * hd + d;
        ks[i] = kv_round<TKV>(pool_value<TP>(k_pool[off], ksc, code_res, p));
        if (need_v) vs[i] = kv_round<TKV>(pool_value<TP>(v_pool[off], vsc, code_res, p));
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
        for (int i = tid; i < G * L; i += kThreads)
          sc[i] = pass_exp<IMPL>(sc[i] - mrow[i / L], p);
        __syncthreads();
        for (int g = tid; g < G; g += kThreads) {
          float bs = 0.0f;
          for (int l = 0; l < L; ++l) bs = bs + sc[g * L + l];
          lrow[g] = lrow[g] + bs;
        }
      } else {
        for (int i = tid; i < G * L; i += kThreads) {
          const int g = i / L;
          sc[i] = pass_prob<IMPL>(sc[i] - mrow[g], lrow[g], p);
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

// The arguments of one GQA decode launch.
struct GqaArgs {
  const void *q, *k_pool, *v_pool;
  const float *k_scale, *v_scale;
  float code_res;
  const int *tables, *k_len;
  float* out;
  int B, KH, G, hd, L, M;
  float scale;
};

template <typename TQ, typename TKV, typename TP, int IMPL>
int launch(const GqaArgs& a, const CordicParams& p, cudaStream_t s) {
  auto kern = gqa_decode_kernel<TQ, TKV, TP, IMPL>;
  const int G = a.G, hd = a.hd, L = a.L;
  const size_t bytes = sizeof(float) * (2 * G * hd + 2 * L * hd + G * L + 3 * G);
  if (bytes > 48 * 1024) {
    const cudaError_t e =
        cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
    if (e != cudaSuccess) return (int)e;
  }
  kern<<<dim3(a.B, a.KH), kThreads, bytes, s>>>(
      (const TQ*)a.q, (const TP*)a.k_pool, (const TP*)a.v_pool, a.k_scale, a.v_scale,
      a.code_res, a.tables, a.k_len, a.out, a.KH, G, hd, L, a.M, a.scale, p);
  return (int)cudaGetLastError();
}

template <typename TQ, typename TKV, typename TP>
int launch_impl(int impl, const GqaArgs& a, const CordicParams& p, cudaStream_t s) {
  switch (impl) {
    case kExact:
      return launch<TQ, TKV, TP, kExact>(a, p, s);
    case kCordicPallas:
      return launch<TQ, TKV, TP, kCordicPallas>(a, p, s);
    case kCordicFixed:
      return launch<TQ, TKV, TP, kCordicFixed>(a, p, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

// Integer pools are instantiated for matched q / kv_dtype pairs only (the
// engine passes kv_dtype = the query dtype); float pools for all four pairs.
template <typename TQ, typename TKV>
int launch_pool(int pool_dtype, int impl, const GqaArgs& a, const CordicParams& p,
                cudaStream_t s) {
  if (pool_dtype == 0) return launch_impl<TQ, TKV, float>(impl, a, p, s);
  if constexpr (std::is_same<TQ, TKV>::value) {
    if (pool_dtype == 1) return launch_impl<TQ, TKV, int8_t>(impl, a, p, s);
    if (pool_dtype == 2) return launch_impl<TQ, TKV, int16_t>(impl, a, p, s);
  }
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// impl: 0 exact, 1 cordic_pallas, 2 cordic_fixed. q_dtype / kv_dtype: 0 float32,
// 1 bfloat16. pool_dtype: 0 float32 pools (k_scale / v_scale unused), 1 int8
// codes, 2 int16 codes, each dequantized as code * code_res times its block's
// per-head scale (k_scale / v_scale: (N, 1, KH, 1) float32).
extern "C" int paged_gqa_decode(const void* q, int q_dtype, const void* k_pool,
                                const void* v_pool, int pool_dtype, const void* k_scale,
                                const void* v_scale, float code_res, const void* tables,
                                const void* k_len, void* out, int B, int KH, int G, int hd,
                                int L, int M, float scale, int impl, int kv_dtype,
                                const CordicParams* p, void* stream) {
  if (B == 0) return (int)cudaGetLastError();
  if (pool_dtype != 0 && (k_scale == nullptr || v_scale == nullptr))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  const GqaArgs a{q, k_pool, v_pool, (const float*)k_scale, (const float*)v_scale,
                  code_res, (const int*)tables, (const int*)k_len, (float*)out,
                  B, KH, G, hd, L, M, scale};
  const CordicParams& pp = *p;
  if (q_dtype == 0)
    return kv_dtype == 0 ? launch_pool<float, float>(pool_dtype, impl, a, pp, s)
                         : launch_pool<float, __nv_bfloat16>(pool_dtype, impl, a, pp, s);
  return kv_dtype == 0 ? launch_pool<__nv_bfloat16, float>(pool_dtype, impl, a, pp, s)
                       : launch_pool<__nv_bfloat16, __nv_bfloat16>(pool_dtype, impl, a, pp, s);
}

// ---------------------------------------------------------------------------
// Paged MLA decode, absorbed form.
//
// Replaces mla_decode of repro/kernels/paged_attention.py (:421; pallas_call
// :460, body _mla_kernel :384, shared _pass_update :197). Each slot scores
// q_eff . c + q_rope . r against its live blocks of the compressed-latent
// pool (N, L, R) and the shared rope-key pool (N, L, P) and accumulates the
// probabilities against the latent rows themselves: the output is the
// (H, R) latent, projected by wv_b outside.
//
// What bounds it here: as for GQA, neither rate at serving shapes. A step
// reads each live block of (L, R + P) floats once per pass (36 KB at
// L 16, R 512, P 64), so the kernel is again a latency chain. Unlike GQA
// the pools have no head axis: one staged block serves every head, so the
// grid is (slot, head group) with heads_per_cta heads per block (B x H/4 =
// 16 blocks at 4 slots and 16 heads), each block walking its own table row
// over the live blocks only. A score sums R + P products: 16 threads share
// it (strided partials, gathered by shuffles), so a block's heads x lanes
// scores take a few rounds rather than one 576-long chain per thread. The
// latent accumulator is (heads, R) in shared memory, one thread per column
// and head, summing the block's lanes left to right.
//
// Order, shared with mla_decode_plain: partial t of a score sums elements
// t, t + 16, ... left to right; lane 0 adds the 16 partials left to right,
// the latent sum and the rope sum separately; score = (sum_R + sum_P) *
// scale, as _mla_kernel writes it. Block and latent sums run left to right
// over the lanes.
namespace {

constexpr int kMlaThreads = 256;
constexpr int kSplit = 16;  // MLA_SPLIT: threads (strided partials) per score

// A dot product of n floats in the fixed order above, on a 16-lane group
// whose lane t is `t`; the result is exact on lane 0 of the group. Every
// lane of the warp must call it (the partials are gathered by shuffles).
__device__ __forceinline__ float split_dot(const float* a, const float* b, int n, int t) {
  float part = 0.0f;
  for (int i = t; i < n; i += kSplit) part = part + a[i] * b[i];
  float s = __shfl_sync(0xffffffffu, part, 0, kSplit);
  for (int k = 1; k < kSplit; ++k) s = s + __shfl_sync(0xffffffffu, part, k, kSplit);
  return s;
}

template <typename TQ, int IMPL>
__global__ void mla_decode_kernel(const TQ* __restrict__ q_eff, const TQ* __restrict__ q_rope,
                                  const float* __restrict__ c_pool,
                                  const float* __restrict__ r_pool,
                                  const int* __restrict__ tables,
                                  const int* __restrict__ k_len, float* __restrict__ out,
                                  int H, int R, int P, int L, int M, int HG, float scale,
                                  const CordicParams p) {
  extern __shared__ float smem[];
  float* cs = smem;            // (L, R) latent block
  float* rs = cs + L * R;      // (L, P) rope-key block
  float* qe = rs + L * P;      // (HG, R)
  float* qr = qe + HG * R;     // (HG, P)
  float* sc = qr + HG * P;     // (HG, L) scores, then lane weights
  float* acc = sc + HG * L;    // (HG, R) latent accumulator
  float* mrow = acc + HG * R;  // (HG,) running max
  float* lrow = mrow + HG;     // (HG,) running sum
  float* alpha = lrow + HG;    // (HG,) online rescale factor (exact)

  const int b = blockIdx.x, h0 = blockIdx.y * HG, tid = threadIdx.x;
  const int hg = min(HG, H - h0);
  const int klen = k_len[b];
  const int* trow = tables + (long long)b * M;
  const long long qoff = ((long long)b * H + h0) * R;
  const long long roff = ((long long)b * H + h0) * P;

  for (int i = tid; i < hg * R; i += kMlaThreads) {
    qe[i] = load_as_float(q_eff, qoff + i);
    acc[i] = 0.0f;
  }
  for (int i = tid; i < hg * P; i += kMlaThreads) qr[i] = load_as_float(q_rope, roff + i);
  for (int h = tid; h < hg; h += kMlaThreads) {
    mrow[h] = kNegInf;
    lrow[h] = 0.0f;
  }
  __syncthreads();

  const int grp = tid / kSplit, lane = tid - grp * kSplit;
  constexpr int kGroups = kMlaThreads / kSplit;
  const int nsc = hg * L;
  const int live = min(M, (klen + L - 1) / L);  // blocks with c * L < k_len
  constexpr bool CORDIC = IMPL != kExact;
  const int passes = CORDIC ? 3 : 1;
  for (int pass = 0; pass < passes; ++pass) {
    for (int c = 0; c < live; ++c) {
      const long long blk = trow[c];
      const int base = c * L;
      for (int i = tid; i < L * R; i += kMlaThreads) cs[i] = c_pool[blk * L * R + i];
      for (int i = tid; i < L * P; i += kMlaThreads) rs[i] = r_pool[blk * L * P + i];
      __syncthreads();
      // uniform trip count across the warp: every lane reaches the shuffles
      for (int s0 = 0; s0 < nsc; s0 += kGroups) {
        const int si = s0 + grp;
        const bool on = si < nsc;
        const int h = on ? si / L : 0;
        const int l = on ? si - h * L : 0;
        const float sr = split_dot(qe + h * R, cs + l * R, R, lane);
        const float sp = split_dot(qr + h * P, rs + l * P, P, lane);
        if (on && lane == 0) {
          const float s = (sr + sp) * scale;
          sc[si] = (base + l < klen) ? s : kNegInf;
        }
      }
      __syncthreads();

      if (!CORDIC) {
        for (int g = tid; g < hg; g += kMlaThreads) {
          float mx = sc[g * L];
          for (int l = 1; l < L; ++l) mx = fmaxf(mx, sc[g * L + l]);
          const float m_old = mrow[g];
          const float m_new = fmaxf(m_old, mx);
          alpha[g] = expf(m_old - m_new);
          mrow[g] = m_new;
        }
        __syncthreads();
        for (int i = tid; i < nsc; i += kMlaThreads) sc[i] = expf(sc[i] - mrow[i / L]);
        __syncthreads();
        for (int g = tid; g < hg; g += kMlaThreads) {
          float bs = 0.0f;
          for (int l = 0; l < L; ++l) bs = bs + sc[g * L + l];
          lrow[g] = lrow[g] * alpha[g] + bs;
        }
        for (int i = tid; i < hg * R; i += kMlaThreads) {
          const int g = i / R, r = i - g * R;
          float pv = 0.0f;
          for (int l = 0; l < L; ++l) pv = pv + sc[g * L + l] * cs[l * R + r];
          acc[i] = acc[i] * alpha[g] + pv;
        }
      } else if (pass == 0) {
        for (int g = tid; g < hg; g += kMlaThreads) {
          float mx = sc[g * L];
          for (int l = 1; l < L; ++l) mx = fmaxf(mx, sc[g * L + l]);
          mrow[g] = fmaxf(mrow[g], mx);
        }
      } else if (pass == 1) {
        for (int i = tid; i < nsc; i += kMlaThreads)
          sc[i] = pass_exp<IMPL>(sc[i] - mrow[i / L], p);
        __syncthreads();
        for (int g = tid; g < hg; g += kMlaThreads) {
          float bs = 0.0f;
          for (int l = 0; l < L; ++l) bs = bs + sc[g * L + l];
          lrow[g] = lrow[g] + bs;
        }
      } else {
        for (int i = tid; i < nsc; i += kMlaThreads) {
          const int g = i / L;
          sc[i] = pass_prob<IMPL>(sc[i] - mrow[g], lrow[g], p);
        }
        __syncthreads();
        for (int i = tid; i < hg * R; i += kMlaThreads) {
          const int g = i / R, r = i - g * R;
          float pv = 0.0f;
          for (int l = 0; l < L; ++l) pv = pv + sc[g * L + l] * cs[l * R + r];
          acc[i] = acc[i] + pv;
        }
      }
      __syncthreads();
    }
  }

  for (int i = tid; i < hg * R; i += kMlaThreads)
    out[qoff + i] = CORDIC ? acc[i] : acc[i] / lrow[i / R];
}

template <typename TQ, int IMPL>
int launch_mla(const void* q_eff, const void* q_rope, const void* c_pool, const void* r_pool,
               const void* tables, const void* k_len, void* out, int B, int H, int R, int P,
               int L, int M, int HG, float scale, const CordicParams& p, cudaStream_t s) {
  auto kern = mla_decode_kernel<TQ, IMPL>;
  const size_t bytes =
      sizeof(float) * ((size_t)L * R + (size_t)L * P + 2 * (size_t)HG * R +
                       (size_t)HG * P + (size_t)HG * L + 3 * (size_t)HG);
  if (bytes > 48 * 1024) {
    const cudaError_t e =
        cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
    if (e != cudaSuccess) return (int)e;
  }
  kern<<<dim3(B, (H + HG - 1) / HG), kMlaThreads, bytes, s>>>(
      (const TQ*)q_eff, (const TQ*)q_rope, (const float*)c_pool, (const float*)r_pool,
      (const int*)tables, (const int*)k_len, (float*)out, H, R, P, L, M, HG, scale, p);
  return (int)cudaGetLastError();
}

template <typename TQ>
int launch_mla_impl(int impl, const void* qe, const void* qr, const void* cp, const void* rp,
                    const void* t, const void* kl, void* o, int B, int H, int R, int P, int L,
                    int M, int HG, float scale, const CordicParams& p, cudaStream_t s) {
  switch (impl) {
    case kExact:
      return launch_mla<TQ, kExact>(qe, qr, cp, rp, t, kl, o, B, H, R, P, L, M, HG, scale, p,
                                    s);
    case kCordicPallas:
      return launch_mla<TQ, kCordicPallas>(qe, qr, cp, rp, t, kl, o, B, H, R, P, L, M, HG,
                                           scale, p, s);
    case kCordicFixed:
      return launch_mla<TQ, kCordicFixed>(qe, qr, cp, rp, t, kl, o, B, H, R, P, L, M, HG,
                                          scale, p, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// impl: 0 exact, 1 cordic_pallas, 2 cordic_fixed. q_dtype: 0 float32, 1 bfloat16 (q_eff and
// q_rope alike). heads_per_cta: heads of one block (grid y = ceil(H / it)).
extern "C" int paged_mla_decode(const void* q_eff, const void* q_rope, int q_dtype,
                                const void* c_pool, const void* r_pool, const void* tables,
                                const void* k_len, void* out, int B, int H, int R, int P,
                                int L, int M, int heads_per_cta, float scale, int impl,
                                const CordicParams* p, void* stream) {
  if (B == 0 || H == 0) return (int)cudaGetLastError();
  if (heads_per_cta < 1) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  const int HG = heads_per_cta < H ? heads_per_cta : H;
  return q_dtype == 0
             ? launch_mla_impl<float>(impl, q_eff, q_rope, c_pool, r_pool, tables, k_len, out,
                                      B, H, R, P, L, M, HG, scale, *p, s)
             : launch_mla_impl<__nv_bfloat16>(impl, q_eff, q_rope, c_pool, r_pool, tables,
                                              k_len, out, B, H, R, P, L, M, HG, scale, *p, s);
}

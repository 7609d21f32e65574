// Shared in-kernel stages of the Q2.14 MR-HRC + R2-LVC pipeline, one
// __device__ function per stage of repro/kernels/cordic_act.py (:60-292).
// act.cu, softmax.cu and paged_decode.cu all include this header, the way
// softmax_cordic.py:36 and paged_attention.py:80 import those stages.
//
// The stage loops unroll over the ROM's maximum size with a guard on the
// schedule's length, so every ROM entry is read at a constant offset of the
// kernel's by-value parameter (the constant bank), never through a local
// copy.
//
// Bit-exactness rules (the JAX reference is the oracle):
//  * every integer op wraps to the register width (wrap_bits); `>>` on int
//    is an arithmetic shift;
//  * float boundary ops round the way jitted XLA does: round half to even
//    (rintf), IEEE division, and the three multiply-adds that XLA:CPU
//    contracts into FMAs are written as explicit fmaf calls. The sources
//    are compiled with -fmad=false so no other multiply and add fuse.
//  * schedule constants (atanh ROM, radix-4 thresholds, x0) are computed in
//    Python exactly as the JAX kernel computes them and arrive by value in
//    CordicParams (kernels/build.py), so the kernels stay parametric in
//    MRSchedule / FixedConfig.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#define CORDIC_MAX_R2 32
#define CORDIC_MAX_R4 16
#define CORDIC_MAX_LVC 32
#define CORDIC_MAX_HV 32

// Layout mirrored by kernels/build.py:_CordicParams (all 32-bit ints).
struct CordicParams {
  int bits, fb, zbits, zfb, z_guard, x0;
  int n_r2;
  int r2_j[CORDIC_MAX_R2];
  int r2_a[CORDIC_MAX_R2];
  int n_r4;
  int r4_j[CORDIC_MAX_R4];
  int r4_t05[CORDIC_MAX_R4];
  int r4_t15[CORDIC_MAX_R4];
  int r4_a1[CORDIC_MAX_R4];
  int r4_a2[CORDIC_MAX_R4];
  int n_lvc;
  int lvc_j[CORDIC_MAX_LVC];
  int lvc_step[CORDIC_MAX_LVC];
  int max_doublings;
  int n_hv;  // hyperbolic vectoring of the log leg (_HYP_VEC_JS)
  int hv_j[CORDIC_MAX_HV];
  int hv_a[CORDIC_MAX_HV];
};

// np.float32(log 2), np.float32(1 / log 2), np.float32(1e-12) bit for bit.
#define CORDIC_LN2 __int_as_float(0x3f317218)
#define CORDIC_INV_LN2 __int_as_float(0x3fb8aa3b)
#define CORDIC_DIV_FLOOR __int_as_float(0x2b8cbccc)
// lanes more than e^-20 below the row max flush to 0; 2^k floor of -30
#define CORDIC_DEAD_CUTOFF (-20.0f)
#define CORDIC_MIN_K (-30.0f)
// exp clamp (_EXP_CLIP) and the log leg's floor, np.float32(1e-30)
#define CORDIC_EXP_CLIP 80.0f
#define CORDIC_LOG_FLOOR 1e-30f
// erf's prefactor: np.float32(0.147), np.float32(4 / pi); np.float32(1/sqrt 2)
#define CORDIC_ERF_A __int_as_float(0x3e16872b)
#define CORDIC_FOUR_PI __int_as_float(0x3fa2f983)
#define CORDIC_INV_SQRT2 __int_as_float(0x3f3504f3)
// log 2 in double
#define CORDIC_LN2_D __longlong_as_double(0x3fe62e42fefa39efLL)

// _wrap16: ((v + half) & mask) - half, in unsigned arithmetic (no UB).
__device__ __forceinline__ int wrap_bits(int v, int bits) {
  const unsigned mask = (bits >= 32) ? 0xffffffffu : ((1u << bits) - 1u);
  const unsigned half = 1u << (bits - 1);
  return (int)((((unsigned)v + half) & mask) - half);
}

// _shr: arithmetic right shift with truncation, re-wrapped.
__device__ __forceinline__ int shr_bits(int v, int s, int bits) {
  return s <= 0 ? v : wrap_bits(v >> s, bits);
}

// _coshsinh_q: radix-2 then radix-4 (SRT digits {-2..2}) hyperbolic
// rotation of angle codes zq; returns (cosh, sinh) codes in fmt.
__device__ __forceinline__ void coshsinh_q(int zq, const CordicParams& p,
                                           int& xo, int& yo) {
  const int bits = p.bits, zbits = p.zbits;
  int z = zq;
  if (p.z_guard) z = wrap_bits((int)((unsigned)z << p.z_guard), zbits);
  int x = p.x0, y = 0;
#pragma unroll
  for (int i = 0; i < CORDIC_MAX_R2; ++i) {
    if (i >= p.n_r2) break;
    const int j = p.r2_j[i], a = p.r2_a[i];
    const bool pos = z >= 0;
    const int xs = shr_bits(x, j, bits), ys = shr_bits(y, j, bits);
    const int xn = pos ? wrap_bits(x + ys, bits) : wrap_bits(x - ys, bits);
    const int yn = pos ? wrap_bits(y + xs, bits) : wrap_bits(y - xs, bits);
    z = pos ? wrap_bits(z - a, zbits) : wrap_bits(z + a, zbits);
    x = xn;
    y = yn;
  }
#pragma unroll
  for (int i = 0; i < CORDIC_MAX_R4; ++i) {
    if (i >= p.n_r4) break;
    const int j = p.r4_j[i];
    const int t05 = p.r4_t05[i], t15 = p.r4_t15[i];
    const bool pos = z >= 0;
    const bool mag2 = (z >= t15) || (z < -t15);
    const bool mag0 = (z < t05) && (z >= -t05);
    const int xs1 = shr_bits(x, 2 * j, bits), ys1 = shr_bits(y, 2 * j, bits);
    const int xs2 = shr_bits(x, 2 * j - 1, bits);
    const int ys2 = shr_bits(y, 2 * j - 1, bits);
    const int dx = mag0 ? 0 : (mag2 ? ys2 : ys1);
    const int dy = mag0 ? 0 : (mag2 ? xs2 : xs1);
    const int da = mag0 ? 0 : (mag2 ? p.r4_a2[i] : p.r4_a1[i]);
    x = pos ? wrap_bits(x + dx, bits) : wrap_bits(x - dx, bits);
    y = pos ? wrap_bits(y + dy, bits) : wrap_bits(y - dy, bits);
    z = pos ? wrap_bits(z - da, zbits) : wrap_bits(z + da, zbits);
  }
  xo = x;
  yo = y;
}

// _lvc_div_q: radix-2 linear vectoring, y/x in zfmt codes.
__device__ __forceinline__ int lvc_div_q(int x, int y, const CordicParams& p) {
  int t = 0;
#pragma unroll
  for (int i = 0; i < CORDIC_MAX_LVC; ++i) {
    if (i >= p.n_lvc) break;
    const bool pos = y >= 0;
    const int xs = shr_bits(x, p.lvc_j[i], p.bits);
    const int step = p.lvc_step[i];
    y = pos ? wrap_bits(y - xs, p.bits) : wrap_bits(y + xs, p.bits);
    t = pos ? wrap_bits(t + step, p.zbits) : wrap_bits(t - step, p.zbits);
  }
  return t;
}

// _guard_drop: zfmt -> fmt with round-to-nearest on the guard bits.
__device__ __forceinline__ int guard_drop(int t, const CordicParams& p) {
  if (p.z_guard) t = wrap_bits((t + (1 << (p.z_guard - 1))) >> p.z_guard, p.bits);
  return t;
}

__device__ __forceinline__ int cordic_tanh_q(int zq, const CordicParams& p) {
  int x, y;
  coshsinh_q(zq, p, x, y);
  return guard_drop(lvc_div_q(x, y, p), p);
}

// _cordic_sigmoid_q: input halving, tanh core, 1/2 + t/2 output stage.
__device__ __forceinline__ int cordic_sigmoid_q(int xq, const CordicParams& p) {
  const int t = cordic_tanh_q(shr_bits(xq, 1, p.bits), p);
  const int half = 1 << (p.fb - 1);
  const int t2 = wrap_bits((t + 1) >> 1, p.bits);
  return wrap_bits(half + t2, p.bits);
}

// _quantize_f: float -> Q codes, round half to even, saturating.
__device__ __forceinline__ int quantize_f(float xf, int fb, int bits) {
  const float lim = (float)((1 << (bits - 1)) - 1);
  float r = rintf(xf * (float)(1 << fb));
  r = fminf(fmaxf(r, -lim - 1.0f), lim);
  return (int)r;
}

__device__ __forceinline__ float dequantize_f(int q, int fb) {
  return (float)q * (1.0f / (float)(1 << fb));
}

// _exp2_i32: 2^k through the f32 exponent field.
__device__ __forceinline__ float exp2_i32(int k) {
  return __int_as_float((k + 127) << 23);
}

// _wide_sigmoid_f: dyadic range extension around the Q2.14 core.
__device__ __forceinline__ float wide_sigmoid_f(float xf, const CordicParams& p) {
  const float ax = fabsf(xf);
  int k = 0;
  for (int i = 0; i < p.max_doublings; ++i) k += (ax > (float)(1 << i)) ? 1 : 0;
  const float xs = fminf(fmaxf(xf * exp2_i32(-k), -1.0f), 1.0f);
  float s = dequantize_f(cordic_sigmoid_q(quantize_f(xs, p.fb, p.bits), p), p.fb);
  for (int i = 0; i < p.max_doublings; ++i) {
    const float s2 = s * s;
    const float t = 1.0f - s;
    // XLA:CPU contracts `s2 + (1 - s) * (1 - s)` into fma(1-s, 1-s, s2):
    // s2 is rounded once, as a value of its own (it is the numerator too)
    const float denom = fmaf(t, t, s2);
    const float doubled = s2 / fmaxf(denom, CORDIC_DIV_FLOOR);
    s = (k > i) ? doubled : s;
  }
  return s;
}

// _hyp_vector_q: radix-2 hyperbolic vectoring, drives y to 0 and returns
// atanh(y0/x0) codes in zfmt.
__device__ __forceinline__ int hyp_vector_q(int x, int y, const CordicParams& p) {
  const int bits = p.bits, zbits = p.zbits;
  int z = 0;
#pragma unroll
  for (int i = 0; i < CORDIC_MAX_HV; ++i) {
    if (i >= p.n_hv) break;
    const int j = p.hv_j[i], a = p.hv_a[i];
    const bool plus = y < 0;
    const int xs = shr_bits(x, j, bits), ys = shr_bits(y, j, bits);
    const int xn = plus ? wrap_bits(x + ys, bits) : wrap_bits(x - ys, bits);
    const int yn = plus ? wrap_bits(y + xs, bits) : wrap_bits(y - xs, bits);
    z = plus ? wrap_bits(z - a, zbits) : wrap_bits(z + a, zbits);
    x = xn;
    y = yn;
  }
  return z;
}

// _exp_q: e^x over (-80, 80). k = rint(x / ln2) is a plain multiply and a
// round; r = x - k ln2 is the fused form jitted XLA computes.
__device__ __forceinline__ float exp_q(float xf, const CordicParams& p) {
  const float x = fminf(fmaxf(xf, -CORDIC_EXP_CLIP), CORDIC_EXP_CLIP);
  const float k = rintf(x * CORDIC_INV_LN2);
  const float r = fmaf(-k, CORDIC_LN2, x);
  int c, s;
  coshsinh_q(quantize_f(r, p.fb, p.bits), p, c, s);
  return dequantize_f(wrap_bits(c + s, p.bits), p.fb) * exp2_i32((int)k);
}

// _log_q: ln v = 2 atanh((m-1)/(m+1)) + p ln2 with v = m 2^p, m in [0.5, 1)
// by an exponent-field frexp (_frexp_f). The tail rounds the same whether
// or not its multiply-add is fused, so it is written in two steps.
__device__ __forceinline__ float log_q(float v, const CordicParams& p) {
  v = fmaxf(v, CORDIC_LOG_FLOOR);
  const int e = (__float_as_int(v) >> 23) - 127;
  const float m = v * exp2_i32(-e) * 0.5f;
  const int num = quantize_f(m - 1.0f, p.fb, p.bits);
  const int den = quantize_f(m + 1.0f, p.fb, p.bits);
  const float at = dequantize_f(hyp_vector_q(den, num, p), p.zfb);
  return 2.0f * at + (float)(e + 1) * CORDIC_LN2;
}

// _erf_q: erf(u)^2 ~ 1 - exp(-u^2 (4/pi + a u^2) / (1 + a u^2)) over the
// exp_q stage; jitted XLA rounds the prefactor's products (no FMA; with
// -fmad=false none forms here), the sqrt is IEEE (no fast-math).
__device__ __forceinline__ float erf_q(float u, const CordicParams& p) {
  const float u2 = u * u;
  const float g = u2 * (CORDIC_FOUR_PI + CORDIC_ERF_A * u2) / (1.0f + CORDIC_ERF_A * u2);
  const float sg = u > 0.0f ? 1.0f : (u < 0.0f ? -1.0f : 0.0f);
  return sg * sqrtf(fmaxf(1.0f - exp_q(-g, p), 0.0f));
}

// jnp.exp2 of an integer-valued k as jitted XLA:CPU computes it: exp(f32(k
// log2)), whose range reduction leaves r = f32(k log2) - k ln2, so the
// result is 2^k * f32(1 + r) (exact only for small |k|), and values below
// the normal range flush to 0. The functions.exp_fixed/divide_fixed lanes
// use it; the kernels' own exp stages scale by exact powers (exp2_i32).
__device__ __forceinline__ float xla_exp2(float k) {
  const double kd = (double)k;
  const double x = (double)(float)(kd * (double)CORDIC_LN2);
  const double m = (double)(float)(1.0 + (x - kd * CORDIC_LN2_D));
  const float out = (float)(m * ldexp(1.0, (int)kd));
  return fabsf(out) < 1.17549435e-38f ? 0.0f : out;
}

// functions.exp_fixed: e^x over (-80, 80), k = round(x / ln2) half to even
// (not the floor of the softmax stages), r = x - k ln2 with the product
// rounded (jitted XLA does not fuse this one), the rotation, then the
// jnp.exp2 scale. No lane is flushed: a masked score clips at
// e^-80 and enters the row sum and the P.V sum.
__device__ __forceinline__ float lane_exp_fixed(float u, const CordicParams& p) {
  const float x = fminf(fmaxf(u, -CORDIC_EXP_CLIP), CORDIC_EXP_CLIP);
  const float k = rintf(x * CORDIC_INV_LN2);
  const float r = x - k * CORDIC_LN2;
  int c, s;
  coshsinh_q(quantize_f(r, p.fb, p.bits), p, c, s);
  return dequantize_f(wrap_bits(c + s, p.bits), p.fb) * xla_exp2(k);
}

__device__ __forceinline__ float sign_f(float v) {
  return v > 0.0f ? 1.0f : (v < 0.0f ? -1.0f : 0.0f);
}

// functions.divide_fixed(e, S) with e = exp_fixed(u): frexp of both
// operands, the numerator halved when m_e >= m_S, the R2-LVC division of
// the Q-format mantissas (vector_q with LIN_VECTORING is lvc_div_q: the same
// stage list, the same where/add/sub structure), the quotient read in zfmt,
// the 2^(p_e - p_S + h) scale and the sign.
__device__ __forceinline__ float lane_prob_fixed(float u, float ssum, const CordicParams& p) {
  const float e = lane_exp_fixed(u, p);
  int py, px;
  const float my = frexpf(fabsf(e), &py);
  const float mx = frexpf(fabsf(ssum), &px);
  const int h = my >= mx ? 1 : 0;
  const int num = quantize_f(h ? my * 0.5f : my, p.fb, p.bits);
  const int den = quantize_f(fmaxf(mx, 0.5f), p.fb, p.bits);
  const float q = dequantize_f(lvc_div_q(den, num, p), p.zfb);
  return sign_f(e) * sign_f(ssum) * q * xla_exp2((float)(py - px + h));
}

// The exp stage of the CORDIC softmax (softmax_cordic._softmax_kernel and
// paged_attention._exp_codes): u = k ln2 + r, e^r = cosh r + sinh r codes,
// the dyadic exponent k, and the dead-lane flag (u < -20).
__device__ __forceinline__ void exp_codes(float u, const CordicParams& p,
                                          int& eq, int& ki, bool& dead) {
  dead = u < CORDIC_DEAD_CUTOFF;
  // fma(u, 1/ln2, 0.5) and fma(-k, ln2, u): the forms jitted XLA computes
  const float k = fmaxf(floorf(fmaf(u, CORDIC_INV_LN2, 0.5f)), CORDIC_MIN_K);
  const float r = dead ? 0.0f : fmaf(-k, CORDIC_LN2, u);
  int c, s;
  coshsinh_q(quantize_f(r, p.fb, p.bits), p, c, s);
  eq = wrap_bits(c + s, p.bits);
  ki = (int)k;
}

// _lane_exp (cordic_pallas): e^u with dead lanes flushed to 0.
__device__ __forceinline__ float lane_exp(float u, const CordicParams& p) {
  int eq, ki;
  bool dead;
  exp_codes(u, p, eq, ki, dead);
  return dead ? 0.0f : dequantize_f(eq, p.fb) * exp2_i32(ki);
}

// Normalization stage given the row sum: exponent-field frexp of S, Q-format
// mantissa, R2-LVC division, 2^(k - p + 1) scale, dead lanes exactly 0.
struct RowSum {
  int pe;  // S = m * 2^pe, m in [1, 2)
  int mq;  // Q codes of m
};

__device__ __forceinline__ RowSum row_sum_frexp(float ssum, const CordicParams& p) {
  RowSum r;
  r.pe = (__float_as_int(ssum) >> 23) - 127;
  r.mq = quantize_f(ssum * exp2_i32(-r.pe), p.fb, p.bits);
  return r;
}

__device__ __forceinline__ float lane_prob(float u, RowSum rs, const CordicParams& p) {
  int eq, ki;
  bool dead;
  exp_codes(u, p, eq, ki, dead);
  const int t = lvc_div_q(rs.mq, shr_bits(eq, 1, p.bits), p);
  const float tf = dequantize_f(guard_drop(t, p), p.fb);
  const float out = tf * exp2_i32(ki - rs.pe + 1);
  return dead ? 0.0f : out;
}

template <typename T>
__device__ __forceinline__ float load_as_float(const T* p, long long i);

template <>
__device__ __forceinline__ float load_as_float<float>(const float* p, long long i) {
  return p[i];
}

template <>
__device__ __forceinline__ float load_as_float<__nv_bfloat16>(const __nv_bfloat16* p,
                                                              long long i) {
  return __bfloat162float(p[i]);
}

__device__ __forceinline__ void store_float(float* p, long long i, float v) { p[i] = v; }

__device__ __forceinline__ void store_float(__nv_bfloat16* p, long long i, float v) {
  p[i] = __float2bfloat16_rn(v);
}

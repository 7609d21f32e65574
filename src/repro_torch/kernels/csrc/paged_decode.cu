// Paged decode attention on Hopper: GQA (paged_gqa_decode) and absorbed-form
// MLA (paged_mla_decode).
//
// Replaces gqa_decode and mla_decode of repro/kernels/paged_attention.py
// (:291 and :421; pallas_call :373 and :460, bodies _gqa_kernel :240 and
// _mla_kernel :384, the shared block update _pass_update :197, the lanes
// _exp_codes :139, _lane_exp :155, _lane_probs :172). One query row per slot
// attends that slot's live blocks (c * L < k_len) in place, through its own
// block-table row; no max_len-sized gather is materialised.
//
// softmax impls:
//   exact          the online (flash-decoding) rescaling recurrence, expf
//   cordic_pallas  row max, CORDIC e^u row sum, lane-exact R2-LVC
//                  probabilities, so they equal the CORDIC softmax kernel's
//                  lane for lane
//   cordic_fixed   the same with the function library's lanes
//                  (lane_exp_fixed, prob_fixed): functions.exp_fixed in the
//                  sum, divide_fixed(exp_fixed(u), S) in the probabilities, as
//                  functions.softmax_fixed; masked lanes of a live block clip
//                  at e^-80 instead of flushing to 0
//
// What bounds it: at serving shapes neither rate. A decode step reads a few
// live blocks per (slot, kv-head), so the work is a chain of dependent
// loads; at long contexts (thousands of keys a slot) it is the K/V bytes
// and, on the CORDIC impls, the integer work of one rotation per lane. The
// TPU kernel walks a row's blocks in sequence, once per softmax pass (three
// for CORDIC). Here only the folds run in sequence; everything that feeds
// them runs in parallel over rows, blocks and value columns, in four
// launches on the caller's stream that share a workspace (no host read of
// k_len, no host synchronisation, no atomics; a CTA past a slot's live
// blocks exits at once):
//
//   score    grid (ceil(M / chunk), KH, B), all G query rows of a kv-head a
//            CTA: stages (and dequantizes) K of `chunk` blocks once, writes
//            the masked, scaled scores of each row's live lanes
//   softmax  grid (KH * G, B), one row a CTA, its lanes in shared memory
//            (`tile` blocks at a time: a longer row passes through in
//            tiles, once per pass): the row max; every lane's e^u
//            (cordic_pallas keeps the codes, cordic_fixed e) and each
//            block's sum, in parallel; the row sum folded over the blocks
//            in table order; the probabilities from the kept e^u. exact: the
//            running max and rescale factor of each block, the lanes'
//            e^(s - m_c), the row sum l = l * alpha_c + bs_c
//   pv       grid (ceil(M / chunk), KH, B): stages (and dequantizes) V of
//            `chunk` blocks once and writes each block's P.V sums for all G
//            rows, a thread per (half of the rows, value column), in the
//            launch's P.V order
//   fold     grid (KH * G * ceil(hd / 128), B): each output column's
//            accumulator over the blocks' P.V sums, in table order
//
// MLA runs the same four phases (its kernels follow the GQA ones).
//
// Summation orders are fixed and shared with the plain PyTorch versions
// (kernels/paged_attention.py), and they are the TPU kernel's walk per
// output row in jitted XLA:CPU's arithmetic (ROADMAP C.4): a score's dot
// runs in XLA's order for the JAX kernel's einsum at this geometry
// (paged_attention.dot_order, passed as the launch's `order` = 2 * partials
// + halve: one fmaf chain, or 2, 4 or 8 strided fmaf partials combined as a
// tree or by halves), then times the scale, then the mask; a block's P.V
// sums run in XLA's order for the second einsum (paged_attention.pv_order,
// the launch's `pv_order` and `pv_chunk`: an fmaf chain over the block's
// lanes, in pieces of pv_chunk lanes added left to right where XLA hands the
// product to Eigen's blocked kernel, or 4 strided fmaf partials as a tree;
// a pv kernel instantiation each); block sums run left to right over a
// block's lanes; the row sum and the accumulator fold block by block in
// table order (exact: l = fmaf(l, alpha, bs), acc = fmaf(acc, alpha, pv),
// as XLA fuses them; the CORDIC impls acc = acc + pv). The row max and the
// running maxima are order-free. Compiled with -fmad=false, so kernel and
// plain agree bit for bit on every impl and on quantized pools; where both
// orders are mapped the CORDIC impls' outputs equal the JAX kernel's bit
// for bit, and exact's differ by its exponential alone (expf against XLA's
// exp).
//
// Quantized pools (kv_quant, _gqa_kernel :260-275 with the scale-pool
// operands :347-353): the pool type TP is int8_t or int16_t codes, and each
// live block's per-head scales are k_scale[blk * KH + h], v_scale[...];
// every staged element is kv_round<TKV>(lin_multiply_float(code *
// code_res, scale)), the CORDIC linear-rotation dequant of
// core/kv_quant.dequantize. The score and pv phases stage K and V once, so
// each element is dequantized once.
#include <climits>
#include <cstdint>
#include <type_traits>

#include "cordic.cuh"

namespace {

constexpr float kNegInf = -1e30f;  // NEG_INF of the reference

// softmax impl codes: the order of paged_attention.IMPLS
constexpr int kExact = 0, kCordicPallas = 1, kCordicFixed = 2;

constexpr int kScoreThreads = 256;
constexpr int kSoftmaxThreads = 512;
// value columns of a pv CTA (two threads each, splitting the rows); threads
// of a fold CTA at most
constexpr int kPvCols = 128;
constexpr int kPvThreads = 2 * kPvCols;
constexpr int kFoldThreads = 128;  // and columns of a fold CTA
// blocks of one score or pv CTA (each thread keeps that many sums in flight)
constexpr int kMaxChunk = 4;
// query rows whose P.V sums one pv thread forms at once
constexpr int kPvRows = 4;
// loads of a fold thread in flight at once
constexpr int kFoldBatch = 32;
// loads a thread keeps in flight while staging
constexpr int kUnroll = 8;
// ka[] marks a lane below the dead cutoff (probability exactly 0)
constexpr int kDead = INT_MIN;
// A launch's score-dot order (paged_attention.DotOrder.code: 2 * partials
// + halve) is one the kernels instantiate: a chain, 2 or 4 partials as a
// tree, 8 as a tree or by halves.
__host__ __device__ __forceinline__ bool order_ok(int code) {
  return code == 2 || code == 4 || code == 8 || code == 16 || code == 17;
}

// A launch's P.V order (paged_attention.pv_order): a chain (code 2) in
// pieces of pv_chunk lanes (0: one piece), or 4 partials as a tree (code 8)
// in one piece. Each is its own instantiation of the pv sums: GQA switches
// uniformly over them inside one pv kernel (with_pv_order), MLA launches a
// pv kernel an order.
__host__ __forceinline__ bool pv_order_ok(int code, int pv_chunk) {
  return pv_chunk >= 0 && (code == 2 || (code == 8 && pv_chunk == 0));
}

// The dot of order ORDER (2 * partials + halve) from its partials p[0..
// partials): a tree adds neighbours, ((p0 + p1) + (p2 + p3)) + ..., halving
// adds the upper half onto the lower, ((p0 + p4) + (p2 + p6)) + ((p1 + p5)
// + (p3 + p7)). P: a register array or a pointer into shared memory.
template <int ORDER, typename P>
__device__ __forceinline__ float combine_parts(const P& p) {
  constexpr int kParts = ORDER >> 1;
  if constexpr (kParts == 1) {
    return p[0];
  } else if constexpr (kParts == 2) {
    return p[0] + p[1];
  } else if constexpr (kParts == 4) {
    return (p[0] + p[1]) + (p[2] + p[3]);
  } else if constexpr (ORDER & 1) {
    return ((p[0] + p[4]) + (p[2] + p[6])) + ((p[1] + p[5]) + (p[3] + p[7]));
  } else {
    return ((p[0] + p[1]) + (p[2] + p[3])) + ((p[4] + p[5]) + (p[6] + p[7]));
  }
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

// Four pool elements in one load: a pool row is a multiple of 4 elements
// and 16-byte aligned (the wrappers check both).
template <typename T>
struct Quad;
template <>
struct Quad<float> {
  using type = float4;
};
template <>
struct Quad<int16_t> {
  using type = short4;
};
template <>
struct Quad<int8_t> {
  using type = char4;
};

template <typename T>
__device__ __forceinline__ typename Quad<T>::type load_quad(const T* base, long long elem) {
  return reinterpret_cast<const typename Quad<T>::type*>(base)[elem >> 2];
}

// dst[0..3] = the kv_dtype-rounded values of a quad of pool elements.
template <typename TKV, typename TP, typename V>
__device__ __forceinline__ void put_quad(float* dst, const V& v, float scale, float code_res,
                                         const CordicParams& p) {
  dst[0] = kv_round<TKV>(pool_value<TP>(v.x, scale, code_res, p));
  dst[1] = kv_round<TKV>(pool_value<TP>(v.y, scale, code_res, p));
  dst[2] = kv_round<TKV>(pool_value<TP>(v.z, scale, code_res, p));
  dst[3] = kv_round<TKV>(pool_value<TP>(v.w, scale, code_res, p));
}

// store(i, load(i)) for i in [0, n) over the CTA, each thread's kUnroll
// loads issued before the first store.
template <typename Load, typename Store>
__device__ __forceinline__ void stage(int n, Load load, Store store) {
  using V = decltype(load(0));
  for (int i0 = threadIdx.x; i0 < n; i0 += kUnroll * blockDim.x) {
    V v[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int i = i0 + u * blockDim.x;
      if (i < n) v[u] = load(i);
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int i = i0 + u * blockDim.x;
      if (i < n) store(i, v[u]);
    }
  }
}

__device__ __forceinline__ int live_blocks(int klen, int L, int M) {
  return min(M, (klen + L - 1) / L);  // blocks with c * L < k_len
}

// The workspace of one call, for `rows` query rows of M * L lanes each and
// outputs `width` wide (workspace_floats; paged_attention.gqa_plan /
// mla_plan compute the same size, and the entry points refuse a smaller
// one):
//   sc  (rows, M*L)     float  scores; after the softmax phase the lane
//                              weights (probabilities, or exact's e^(s - m_c));
//                              cordic_fixed keeps a long row's e^u here
//                              between its passes
//   ea  (rows, M*L)     int    pass-1 e^r codes (cordic_pallas)
//   ka  (rows, M*L)     int    pass-1 exponents k, kDead on a dead lane
//   al  (rows, M)       float  exact: each block's rescale factor alpha
//   lr  (rows,)         float  exact: the row sum
//   pv  (rows, M, width) float each block's P.V sums
struct Workspace {
  float* sc;
  int* ea;
  int* ka;
  float* al;
  float* lr;
  float* pv;
};

__host__ __device__ __forceinline__ long long workspace_floats(long long rows, int M, int L,
                                                               int width) {
  return rows * (3LL * M * L + M + 1 + (long long)M * width);
}

__device__ __forceinline__ Workspace carve(float* ws, long long rows, int M, int L) {
  const long long ml = rows * M * L;
  Workspace w;
  w.sc = ws;
  w.ea = reinterpret_cast<int*>(ws + ml);
  w.ka = reinterpret_cast<int*>(ws + 2 * ml);
  w.al = ws + 3 * ml;
  w.lr = w.al + rows * M;
  w.pv = w.lr + rows;
  return w;
}

// Max over the CTA (order-free); every thread gets the result.
__device__ __forceinline__ float cta_max(float v, float* red) {
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  if (lane == 0) red[warp] = v;
  __syncthreads();
  if (warp == 0) {
    v = lane < (int)(blockDim.x / 32) ? red[lane] : kNegInf;
    for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
    if (lane == 0) red[0] = v;
  }
  __syncthreads();
  return red[0];
}

// The softmax phase of one row (blockIdx.x: the row within its slot,
// blockIdx.y: the slot). The row's lanes pass through shared memory `tile`
// blocks at a time: a row of at most `tile` blocks is staged once and kept
// there through every pass; a longer one is staged again in each pass,
// tile by tile (the order of every sum is the same either way: a block
// never straddles two tiles, and the folds run over the blocks' sums).
// Shared by GQA and MLA.
template <int IMPL>
__device__ __forceinline__ void softmax_row(float* ws, long long rows, int rows_per_slot,
                                            const int* k_len, int L, int M, int tile,
                                            const CordicParams& p) {
  extern __shared__ float smem[];
  const int tl = min(tile, M) * L;  // lanes of a tile
  float* e = smem;                  // (tl) a tile's scores, then its lanes' e^u
  float* bs = e + tl;               // (M) block sums
  float* bm = bs + M;               // (M) exact: running max at each block
  float* am = bm + M;               // (M) exact: rescale factor of each block
  __shared__ float red[32];
  __shared__ float total;
  const Workspace w = carve(ws, rows, M, L);
  const int b = blockIdx.y, tid = threadIdx.x;
  const long long row = (long long)b * rows_per_slot + blockIdx.x;
  const int live = live_blocks(k_len[b], L, M);
  const int n = live * L;
  const bool one = n <= tl;  // uniform over the CTA
  const long long off = row * M * L;
  float* s = w.sc + off;
  // lanes [t0, t0 + tn) into e
  auto load = [&](int t0, int tn) {
    __syncthreads();
    stage(tn, [&](int i) { return s[t0 + i]; }, [&](int i, float v) { e[i] = v; });
    __syncthreads();
  };
  if (one) load(0, n);

  if (IMPL == kExact) {
    for (int t0 = 0; t0 < n; t0 += tl) {
      const int tn = min(tl, n - t0);
      if (!one) load(t0, tn);
      for (int c = tid; c < tn / L; c += kSoftmaxThreads) {
        float mx = e[c * L];
        for (int l = 1; l < L; ++l) mx = fmaxf(mx, e[c * L + l]);
        bm[t0 / L + c] = mx;
      }
    }
    __syncthreads();
    if (tid == 0)  // the running max m_c = max(m_{c-1}, block max), in table order
      for (int c = 1; c < live; ++c) bm[c] = fmaxf(bm[c - 1], bm[c]);
    __syncthreads();
    for (int c = tid; c < live; c += kSoftmaxThreads) {  // alpha_c = e^(m_{c-1} - m_c)
      am[c] = expf((c ? bm[c - 1] : kNegInf) - bm[c]);
      w.al[row * M + c] = am[c];
    }
    for (int t0 = 0; t0 < n; t0 += tl) {
      const int tn = min(tl, n - t0);
      if (!one) load(t0, tn);
      for (int i = tid; i < tn; i += kSoftmaxThreads) {
        const float v = expf(e[i] - bm[(t0 + i) / L]);
        e[i] = v;
        s[t0 + i] = v;
      }
      __syncthreads();
      for (int c = tid; c < tn / L; c += kSoftmaxThreads) {
        float t = 0.0f;
        for (int l = 0; l < L; ++l) t = t + e[c * L + l];
        bs[t0 / L + c] = t;
      }
    }
    __syncthreads();
    if (tid == 0) {
      float l = 0.0f;
      for (int c = 0; c < live; ++c) l = fmaf(l, am[c], bs[c]);  // XLA fuses the fold
      w.lr[row] = l;
    }
    return;
  }

  float mx = kNegInf;
  for (int t0 = 0; t0 < n; t0 += tl) {
    const int tn = min(tl, n - t0);
    if (!one) load(t0, tn);
    for (int i = tid; i < tn; i += kSoftmaxThreads) mx = fmaxf(mx, e[i]);
  }
  mx = cta_max(mx, red);
  int* ea = w.ea + off;
  int* ka = w.ka + off;
  // pass 1: every lane's e^u and each block's sum; cordic_pallas keeps the
  // lanes' codes for pass 2, cordic_fixed a long row's e^u
  for (int t0 = 0; t0 < n; t0 += tl) {
    const int tn = min(tl, n - t0);
    if (!one) load(t0, tn);
    for (int i = tid; i < tn; i += kSoftmaxThreads) {
      const float u = e[i] - mx;
      if (IMPL == kCordicFixed) {
        e[i] = lane_exp_fixed(u, p);
        if (!one) s[t0 + i] = e[i];
      } else {
        int eq, ki;
        bool dead;
        exp_codes(u, p, eq, ki, dead);
        ea[t0 + i] = eq;
        ka[t0 + i] = dead ? kDead : ki;
        e[i] = dead ? 0.0f : dequantize_f(eq, p.fb) * exp2_i32(ki);  // lane_exp
      }
    }
    __syncthreads();
    for (int c = tid; c < tn / L; c += kSoftmaxThreads) {
      float t = 0.0f;
      for (int l = 0; l < L; ++l) t = t + e[c * L + l];
      bs[t0 / L + c] = t;
    }
  }
  __syncthreads();
  if (tid == 0) {  // the row sum, folded in table order
    float t = 0.0f;
    for (int c = 0; c < live; ++c) t = t + bs[c];
    total = t;
  }
  __syncthreads();
  const float ssum = total;
  const RowSum rsum = row_sum_frexp(ssum, p);
  // pass 2: the probabilities from the kept e^u
  for (int i = tid; i < n; i += kSoftmaxThreads) {
    if (IMPL == kCordicFixed) {
      s[i] = prob_fixed(one ? e[i] : s[i], ssum, p);
    } else {
      const int ki = ka[i];
      s[i] = prob_codes(ea[i], ki, ki == kDead, rsum, p);
    }
  }
}

// A pv thread takes value column `cc` of the staged tile vs (nc, L, vcols)
// and forms, for every row r in [r_lo, r_hi) and block j < nc, the P.V sum
// over the block's lanes of ps[r][j * L + l] * vs[j][l][cc] (ps: (rows, nc *
// L)) in the launch's P.V order (paged_attention.pv_order): PARTS strided
// fmaf partials over the lanes (PARTS 1: one chain) combined as a tree;
// with PIECES, the lanes in pieces of `piece` from lane 0, each summed so,
// the pieces' sums added left to right. dst(r, j, sum) keeps it. Rows go
// kPvRows at a time, so each staged value is read once per kPvRows rows.
template <int PARTS, bool PIECES, typename Dst>
__device__ __forceinline__ void pv_sums(const float* ps, const float* vs, int r_lo, int r_hi,
                                        int nc, int L, int piece, int vcols, int cc, Dst dst) {
  const int ncl = nc * L;
  const int nrows = r_hi;
  // lanes [l0, l1) into the partials part[r][j][t]
  auto lanes = [&](int r0, int l0, int l1, float (&part)[kPvRows][kMaxChunk][PARTS]) {
#pragma unroll
    for (int r = 0; r < kPvRows; ++r)
#pragma unroll
      for (int j = 0; j < kMaxChunk; ++j)
#pragma unroll
        for (int t = 0; t < PARTS; ++t) part[r][j][t] = 0.0f;
    for (int l = l0; l < l1; l += PARTS) {
#pragma unroll
      for (int t = 0; t < PARTS; ++t) {
        if (PARTS == 1 || l + t < l1) {
#pragma unroll
          for (int j = 0; j < kMaxChunk; ++j) {
            if (j < nc) {
              const float v = vs[(j * L + l + t) * vcols + cc];
#pragma unroll
              for (int r = 0; r < kPvRows; ++r)
                if (r0 + r < nrows)
                  part[r][j][t] = fmaf(ps[(r0 + r) * ncl + j * L + l + t], v, part[r][j][t]);
            }
          }
        }
      }
    }
  };
  for (int r0 = r_lo; r0 < r_hi; r0 += kPvRows) {
    float part[kPvRows][kMaxChunk][PARTS];
    float pv[kPvRows][kMaxChunk];
    if constexpr (PIECES) {
#pragma unroll
      for (int r = 0; r < kPvRows; ++r)
#pragma unroll
        for (int j = 0; j < kMaxChunk; ++j) pv[r][j] = 0.0f;
      for (int l0 = 0; l0 < L; l0 += piece) {
        lanes(r0, l0, min(L, l0 + piece), part);
#pragma unroll
        for (int r = 0; r < kPvRows; ++r)
#pragma unroll
          for (int j = 0; j < kMaxChunk; ++j)
            pv[r][j] = pv[r][j] + combine_parts<2 * PARTS>(part[r][j]);
      }
    } else {
      lanes(r0, 0, L, part);
#pragma unroll
      for (int r = 0; r < kPvRows; ++r)
#pragma unroll
        for (int j = 0; j < kMaxChunk; ++j) pv[r][j] = combine_parts<2 * PARTS>(part[r][j]);
    }
#pragma unroll
    for (int r = 0; r < kPvRows; ++r)
#pragma unroll
      for (int j = 0; j < kMaxChunk; ++j)
        if (r0 + r < nrows && j < nc) dst(r0 + r, j, pv[r][j]);
  }
}

// f(std::integral_constant<int, PARTS>, std::bool_constant<PIECES>) for a
// launch's P.V order: 4 partials in one piece, or a chain, in pieces when
// `piece` is shorter than the block. A uniform switch inside GQA's pv
// kernel, so its staging (and a quantized pool's dequant) compiles once for
// every order.
template <typename F>
__device__ __forceinline__ void with_pv_order(int parts, int piece, int L, F f) {
  if (parts == 4)
    f(std::integral_constant<int, 4>{}, std::false_type{});
  else if (piece < L)
    f(std::integral_constant<int, 1>{}, std::true_type{});
  else
    f(std::integral_constant<int, 1>{}, std::false_type{});
}

// Stage the lane weights of `nrows` rows (row0 + r) over the table columns
// [c0, c0 + nc) into ps (nrows, nc * L).
__device__ __forceinline__ void stage_weights(float* ps, const Workspace& w, long long row0,
                                              int nrows, int c0, int nc, int L, int M) {
  const int ncl = nc * L;
  const long long ml = (long long)M * L;
  stage(nrows * ncl,
        [&](int i) {
          const int r = i / ncl;
          return w.sc[(row0 + r) * ml + (long long)c0 * L + (i - r * ncl)];
        },
        [&](int i, float v) { ps[i] = v; });
}

// The fold phase of kFoldThreads columns of one row (blockIdx.x: the row
// within its slot times the column slices, blockIdx.y: the slot): each
// column's accumulator over the live blocks' P.V sums in table order, acc =
// acc + pv_c (exact: acc = acc * alpha_c + pv_c, then acc / l). Shared by
// GQA and MLA.
template <bool EXACT>
__device__ __forceinline__ void fold_row(float* ws, long long rows, int rows_per_slot,
                                         int width, const int* k_len, int L, int M,
                                         float* out) {
  extern __shared__ float smem[];  // (M) exact: alpha
  const Workspace w = carve(ws, rows, M, L);
  const int slices = (width + kFoldThreads - 1) / kFoldThreads;
  const int b = blockIdx.y, tid = threadIdx.x;
  const int slice = blockIdx.x % slices;
  const long long row = (long long)b * rows_per_slot + blockIdx.x / slices;
  const int live = live_blocks(k_len[b], L, M);
  if (EXACT) {
    for (int c = tid; c < live; c += blockDim.x) smem[c] = w.al[row * M + c];
    __syncthreads();
  }
  const float* pv = w.pv + row * M * width;
  const int d = slice * kFoldThreads + tid;
  if (d < width) {
    float acc = 0.0f;
    for (int c0 = 0; c0 < live; c0 += kFoldBatch) {  // kFoldBatch loads, then the adds
      float v[kFoldBatch];
#pragma unroll
      for (int u = 0; u < kFoldBatch; ++u)
        if (c0 + u < live) v[u] = pv[(long long)(c0 + u) * width + d];
#pragma unroll
      for (int u = 0; u < kFoldBatch; ++u)
        if (c0 + u < live) acc = EXACT ? fmaf(acc, smem[c0 + u], v[u]) : acc + v[u];
    }
    out[row * width + d] = EXACT ? acc / w.lr[row] : acc;
  }
}

// A softmax CTA's shared memory: one tile of lanes and three (M) arrays.
__host__ __forceinline__ size_t softmax_smem(int L, int M, int tile) {
  return sizeof(float) * ((size_t)(tile < M ? tile : M) * L + 3 * (size_t)M);
}

// The fold grid's x extent and CTA width for `rows_per_slot` rows `width` wide.
__host__ __forceinline__ int fold_ctas(int rows_per_slot, int width) {
  return rows_per_slot * ((width + kFoldThreads - 1) / kFoldThreads);
}

__host__ __forceinline__ int fold_threads(int width) {
  return width >= kFoldThreads ? kFoldThreads : (width + 31) / 32 * 32;
}

// A launch that may need more than the default 48 KB of shared memory, its
// static arrays included (at most kStaticSmem bytes in these kernels: a
// dynamic 48 KB beside them needs the attribute too).
constexpr size_t kStaticSmem = 1024;
template <typename K>
__host__ int smem_ok(K kern, size_t bytes) {
  if (bytes + kStaticSmem <= 48 * 1024) return 0;
  return (int)cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                   (int)bytes);
}

// ---------------------------------------------------------------------------
// GQA
// ---------------------------------------------------------------------------

// TQ: query dtype; TKV: the kv_dtype cast replayed per element; TP: the
// pool's storage (float, or int8_t/int16_t codes with per-block scales).
// The scores of a GQA score CTA's staged blocks in order ORDER: thread item
// i is score (g, l) of the blocks j = par, par + 2, ... (par = i / (G L)),
// partial t adding the products of d = t, t + PARTS, ...
template <int ORDER>
__device__ __forceinline__ void gqa_scores(const float* qs, const float* ks, int hs, int G,
                                           int hd, int L, int nc, int c0, int klen,
                                           float* ws, long long row0, long long ml,
                                           float scale) {
  constexpr int PARTS = ORDER >> 1;
  for (int i = threadIdx.x; i < 2 * G * L; i += kScoreThreads) {
    const int par = i / (G * L), gl = i - par * G * L;
    const int g = gl / L, l = gl - g * L;
    if (par >= nc) continue;
    const float* qr = qs + g * hs;
    float sc[kMaxChunk / 2][PARTS];
#pragma unroll
    for (int u = 0; u < kMaxChunk / 2; ++u)
#pragma unroll
      for (int t = 0; t < PARTS; ++t) sc[u][t] = 0.0f;
    for (int d = 0; d < hd; d += PARTS) {
#pragma unroll
      for (int t = 0; t < PARTS; ++t) {
        const float qd = qr[d + t];
#pragma unroll
        for (int u = 0; u < kMaxChunk / 2; ++u) {
          const int j = par + 2 * u;
          if (j < nc) sc[u][t] = fmaf(qd, ks[(j * L + l) * hs + d + t], sc[u][t]);
        }
      }
    }
    float* o = ws + (row0 + g) * ml + (long long)c0 * L + l;
#pragma unroll
    for (int u = 0; u < kMaxChunk / 2; ++u) {
      const int j = par + 2 * u;
      if (j < nc) {
        const float v = combine_parts<ORDER>(sc[u]) * scale;
        o[j * L] = ((c0 + j) * L + l < klen) ? v : kNegInf;
      }
    }
  }
}

// f(std::integral_constant<int, ORDER>) for a GQA launch's order (one
// dot_order gives GQA: a chain, 4 partials, 8 as a tree or by halves; the
// callers checked it). The score kernel switches on it uniformly, so each
// order is compiled once per kernel and the staging, which dominates its
// code, once for all orders.
template <typename F>
__device__ __forceinline__ void with_order(int order, F f) {
  switch (order) {
    case 2:
      f(std::integral_constant<int, 2>{});
      break;
    case 16:
      f(std::integral_constant<int, 16>{});
      break;
    case 17:
      f(std::integral_constant<int, 17>{});
      break;
    default:
      f(std::integral_constant<int, 8>{});
  }
}

template <typename TQ, typename TKV, typename TP>
__global__ void __launch_bounds__(kScoreThreads)
    gqa_decode_kernel_score(const TQ* __restrict__ q, const TP* __restrict__ k_pool,
                            const float* __restrict__ k_scale, float code_res,
                            const int* __restrict__ tables, const int* __restrict__ k_len,
                            float* __restrict__ ws, int KH, int G, int hd, int L, int M,
                            int chunk, int order, float scale, const CordicParams p) {
  extern __shared__ float smem[];
  __shared__ long long blk[kMaxChunk];
  __shared__ float ksc[kMaxChunk];
  const int hs = hd + 1;    // padded row stride: conflict-free across rows
  float* qs = smem;         // (G, hs)
  float* ks = qs + G * hs;  // (chunk, L, hs)
  const int b = blockIdx.z, h = blockIdx.y, tid = threadIdx.x;
  const int klen = k_len[b];
  const int live = live_blocks(klen, L, M);
  const int c0 = blockIdx.x * chunk;
  if (c0 >= live) return;
  const int nc = min(chunk, live - c0);
  constexpr bool QUANT = !std::is_same<TP, float>::value;
  if (tid < nc) {
    const long long id = tables[(long long)b * M + c0 + tid];
    blk[tid] = id;
    ksc[tid] = QUANT ? k_scale[id * KH + h] : 1.0f;
  }
  const long long qoff = ((long long)b * KH + h) * G * hd;
  stage(G * hd, [&](int i) { return load_as_float(q, qoff + i); },
        [&](int i, float v) {
          const int g = i / hd;
          qs[g * hs + (i - g * hd)] = v;
        });
  __syncthreads();
  const int hd4 = hd / 4;
  stage(nc * L * hd4,
        [&](int i) {
          const int jl = i / hd4, j = jl / L;
          return load_quad(k_pool, ((blk[j] * L + (jl - j * L)) * KH + h) * hd +
                                       4 * (i - jl * hd4));
        },
        [&](int i, const auto& v) {
          const int jl = i / hd4;
          put_quad<TKV, TP>(ks + jl * hs + 4 * (i - jl * hd4), v, ksc[jl / L], code_res, p);
        });
  __syncthreads();
  const long long ml = (long long)M * L;
  const long long row0 = ((long long)b * KH + h) * G;
  with_order(order, [&](auto o) {
    gqa_scores<decltype(o)::value>(qs, ks, hs, G, hd, L, nc, c0, klen, ws, row0, ml, scale);
  });
}

template <int IMPL>
__global__ void __launch_bounds__(kSoftmaxThreads)
    gqa_decode_kernel_softmax(float* __restrict__ ws, int B, int rows_per_slot,
                              const int* __restrict__ k_len, int L, int M, int tile,
                              const CordicParams p) {
  softmax_row<IMPL>(ws, (long long)B * rows_per_slot, rows_per_slot, k_len, L, M, tile, p);
}

// The P.V sums of `chunk` blocks for all G rows of a kv-head: V staged (and
// dequantized) once, two threads a value column.
template <typename TKV, typename TP>
__global__ void __launch_bounds__(kPvThreads)
    gqa_decode_kernel_pv(const TP* __restrict__ v_pool, const float* __restrict__ v_scale,
                         float code_res, const int* __restrict__ tables,
                         const int* __restrict__ k_len, float* __restrict__ ws, int B, int KH,
                         int G, int hd, int L, int M, int chunk, int parts, int piece,
                         const CordicParams p) {
  extern __shared__ float smem[];
  __shared__ long long blk[kMaxChunk];
  __shared__ float vsc[kMaxChunk];
  float* vs = smem;                   // (chunk, L, hd) values
  float* ps = vs + chunk * L * hd;    // (G, chunk * L) lane weights
  const int b = blockIdx.z, h = blockIdx.y, tid = threadIdx.x;
  const int live = live_blocks(k_len[b], L, M);
  const int c0 = blockIdx.x * chunk;
  if (c0 >= live) return;
  const int nc = min(chunk, live - c0);
  constexpr bool QUANT = !std::is_same<TP, float>::value;
  if (tid < nc) {
    const long long id = tables[(long long)b * M + c0 + tid];
    blk[tid] = id;
    vsc[tid] = QUANT ? v_scale[id * KH + h] : 1.0f;
  }
  const Workspace w = carve(ws, (long long)B * KH * G, M, L);
  const long long row0 = ((long long)b * KH + h) * G;
  stage_weights(ps, w, row0, G, c0, nc, L, M);
  __syncthreads();
  const int hd4 = hd / 4;
  stage(nc * L * hd4,
        [&](int i) {
          const int jl = i / hd4, j = jl / L;
          return load_quad(v_pool, ((blk[j] * L + (jl - j * L)) * KH + h) * hd +
                                       4 * (i - jl * hd4));
        },
        [&](int i, const auto& v) {
          const int jl = i / hd4;
          put_quad<TKV, TP>(vs + jl * hd + 4 * (i - jl * hd4), v, vsc[jl / L], code_res, p);
        });
  __syncthreads();
  // thread (half, column): each half of the CTA takes half of the rows
  const int half = tid / kPvCols, rh = (G + 1) / 2;
  with_pv_order(parts, piece, L, [&](auto np, auto pieces) {
    for (int d = tid - half * kPvCols; d < hd; d += kPvCols)
      pv_sums<decltype(np)::value, decltype(pieces)::value>(
          ps, vs, half * rh, min(G, (half + 1) * rh), nc, L, piece, hd, d,
          [&](int r, int j, float v) { w.pv[((row0 + r) * M + c0 + j) * hd + d] = v; });
  });
}

template <bool EXACT>
__global__ void __launch_bounds__(kFoldThreads)
    gqa_decode_kernel_fold(float* __restrict__ ws, int B, int rows_per_slot, int hd,
                           const int* __restrict__ k_len, int L, int M, float* __restrict__ out) {
  fold_row<EXACT>(ws, (long long)B * rows_per_slot, rows_per_slot, hd, k_len, L, M, out);
}

// The arguments of one GQA decode launch.
struct GqaArgs {
  const void *q, *k_pool, *v_pool;
  const float *k_scale, *v_scale;
  float code_res;
  const int *tables, *k_len;
  float *out, *ws;
  int B, KH, G, hd, L, M, chunk, tile, order, pv_parts, pv_piece;
  float scale;
};

template <typename TQ, typename TKV, typename TP, int IMPL>
int launch(const GqaArgs& a, const CordicParams& p, cudaStream_t s) {
  const int G = a.G, hd = a.hd, L = a.L, M = a.M;
  const dim3 blocks((M + a.chunk - 1) / a.chunk, a.KH, a.B);
  auto score = gqa_decode_kernel_score<TQ, TKV, TP>;
  const size_t score_bytes = sizeof(float) * (size_t)(G + a.chunk * L) * (hd + 1);
  int rc = smem_ok(score, score_bytes);
  if (rc) return rc;
  score<<<blocks, kScoreThreads, score_bytes, s>>>(
      (const TQ*)a.q, (const TP*)a.k_pool, a.k_scale, a.code_res, a.tables, a.k_len, a.ws,
      a.KH, G, hd, L, M, a.chunk, a.order, a.scale, p);
  if ((rc = (int)cudaGetLastError())) return rc;

  auto softmax = gqa_decode_kernel_softmax<IMPL>;
  const size_t softmax_bytes = softmax_smem(L, M, a.tile);
  if ((rc = smem_ok(softmax, softmax_bytes))) return rc;
  softmax<<<dim3(a.KH * G, a.B), kSoftmaxThreads, softmax_bytes, s>>>(a.ws, a.B, a.KH * G,
                                                                      a.k_len, L, M, a.tile, p);
  if ((rc = (int)cudaGetLastError())) return rc;

  auto pv = gqa_decode_kernel_pv<TKV, TP>;
  const size_t pv_bytes = sizeof(float) * (size_t)a.chunk * L * (hd + G);
  if ((rc = smem_ok(pv, pv_bytes))) return rc;
  pv<<<blocks, kPvThreads, pv_bytes, s>>>((const TP*)a.v_pool, a.v_scale, a.code_res,
                                          a.tables, a.k_len, a.ws, a.B, a.KH, G, hd, L, M,
                                          a.chunk, a.pv_parts, a.pv_piece, p);
  if ((rc = (int)cudaGetLastError())) return rc;

  auto fold = gqa_decode_kernel_fold<IMPL == kExact>;
  const size_t fold_bytes = sizeof(float) * (size_t)M;
  if ((rc = smem_ok(fold, fold_bytes))) return rc;
  fold<<<dim3(fold_ctas(a.KH * G, hd), a.B), fold_threads(hd), fold_bytes, s>>>(
      a.ws, a.B, a.KH * G, hd, a.k_len, L, M, a.out);
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
// per-head scale (k_scale / v_scale: (N, 1, KH, 1) float32). ws: the
// workspace of paged_attention.gqa_plan, ws_floats float32 words (at least
// workspace_floats(B * KH * G, M, L, hd)); chunk: blocks of a score / pv CTA
// (1..4); tile: blocks a softmax CTA holds in shared memory at once; order:
// the score dot's order, 2 * partials + halve (paged_attention.DotOrder; a
// chain, 4 partials, or 8 as a tree or by halves); pv_order, pv_chunk: the
// P.V dots' (paged_attention.pv_order: its code, a chain or 4 partials as a
// tree, and its pieces' lanes, 0 for one piece).
extern "C" int paged_gqa_decode(const void* q, int q_dtype, const void* k_pool,
                                const void* v_pool, int pool_dtype, const void* k_scale,
                                const void* v_scale, float code_res, const void* tables,
                                const void* k_len, void* out, void* ws, long long ws_floats,
                                int B, int KH, int G, int hd, int L, int M, int chunk, int tile,
                                int order, int pv_order, int pv_chunk, float scale, int impl,
                                int kv_dtype, const CordicParams* p, void* stream) {
  if (B == 0) return (int)cudaGetLastError();
  if (pool_dtype != 0 && (k_scale == nullptr || v_scale == nullptr))
    return (int)cudaErrorInvalidValue;
  if (!pv_order_ok(pv_order, pv_chunk)) return (int)cudaErrorInvalidValue;
  if (chunk < 1 || chunk > kMaxChunk || tile < 1 || hd % 4 || !order_ok(order) || order == 4 ||
      hd % (order >> 1) || ws_floats < workspace_floats((long long)B * KH * G, M, L, hd))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  const GqaArgs a{q,
                  k_pool,
                  v_pool,
                  (const float*)k_scale,
                  (const float*)v_scale,
                  code_res,
                  (const int*)tables,
                  (const int*)k_len,
                  (float*)out,
                  (float*)ws,
                  B,
                  KH,
                  G,
                  hd,
                  L,
                  M,
                  chunk,
                  tile,
                  order,
                  pv_order >> 1,
                  pv_chunk > 0 ? pv_chunk : L,
                  scale};
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
// Each slot scores q_eff . c + q_rope . r against its live blocks of the
// compressed-latent pool (N, L, R) and the shared rope-key pool (N, L, P) and
// accumulates the probabilities against the latent rows themselves: the
// output is the (H, R) latent, projected by wv_b outside. The pools have no
// head axis, so one staged block serves every head of a CTA. The phases:
//
//   score    grid (ceil(M / chunk), ceil(H / HG), B): HG heads of a slot a
//            CTA, its `chunk` blocks staged one after another; a score's
//            two sums (R and P products) each take the order's strided
//            partials (1, 2, 4 or 8), thread t summing partial t for 2
//            heads at once, then one thread a score combines them
//   softmax  grid (H, B), one head a CTA (the GQA phase's code)
//   pv       grid (ceil(M / chunk), ceil(R / 128), B): 128 latent columns
//            of `chunk` blocks a CTA, every head's P.V sums
//   fold     grid (H * ceil(R / 128), B), 128 latent columns of a head a CTA
//
// Order, shared with mla_decode_plain: jitted XLA:CPU's order for the JAX
// kernel's two dots at this geometry (paged_attention.dot_order, the
// launch's `order`): partial t of a score sum adds the products of elements
// t, t + parts, ... left to right as fused multiply-adds (parts 1: one
// chain), then the partials are combined as a tree or by halves, the latent
// sum and the rope sum separately; score = (sum_R + sum_P) * scale, as
// _mla_kernel writes it. Block and latent sums run left to right over the
// lanes, folded in table order as above.
// ---------------------------------------------------------------------------
namespace {

constexpr int kMlaThreads = 512;
// floats padding each staged latent and rope row of a score CTA
constexpr int kPad = 4;
// heads whose partial t of one lane's score one thread sums at once (with
// 4 partials a score, 2 heads a thread keep all 512 threads busy at H 16)
constexpr int kMlaHeads = 2;

// f(std::integral_constant<int, ORDER>) for a launch's order on the host:
// an MLA score kernel is instantiated per order (it has no dequantizing
// staging to share).
template <typename F>
__host__ int launch_order(int order, F f) {
  switch (order) {
    case 2:
      return f(std::integral_constant<int, 2>{});
    case 4:
      return f(std::integral_constant<int, 4>{});
    case 8:
      return f(std::integral_constant<int, 8>{});
    case 16:
      return f(std::integral_constant<int, 16>{});
    case 17:
      return f(std::integral_constant<int, 17>{});
    default:
      return (int)cudaErrorInvalidValue;
  }
}

template <typename TQ, int ORDER>
__global__ void __launch_bounds__(kMlaThreads)
    mla_decode_kernel_score(const TQ* __restrict__ q_eff, const TQ* __restrict__ q_rope,
                            const float* __restrict__ c_pool, const float* __restrict__ r_pool,
                            const int* __restrict__ tables, const int* __restrict__ k_len,
                            float* __restrict__ ws, int H, int R, int P, int L, int M, int HG,
                            int chunk, float scale) {
  extern __shared__ float smem[];
  __shared__ long long blk[kMaxChunk];
  // latent and rope rows padded by kPad: the score groups of a warp read
  // neighbouring lanes' rows on other banks
  const int cst = R + kPad, rst = P + kPad;
  constexpr int parts = ORDER >> 1;
  float* qe = smem;               // (hg, R) latent queries, then (hg, P) rope ones
  float* cs = qe + HG * (R + P);  // (L, cst) latent block
  float* rs = cs + L * cst;       // (L, rst) rope-key block
  float* part = rs + L * rst;     // (2, HG, L, parts + 1) partials: latent, rope
  const int b = blockIdx.z, h0 = blockIdx.y * HG, tid = threadIdx.x;
  const int klen = k_len[b];
  const int live = live_blocks(klen, L, M);
  const int c0 = blockIdx.x * chunk;
  if (c0 >= live) return;
  const int nc = min(chunk, live - c0);
  const int hg = min(HG, H - h0);
  if (tid < nc) blk[tid] = tables[(long long)b * M + c0 + tid];
  const long long qoff = ((long long)b * H + h0) * R, roff = ((long long)b * H + h0) * P;
  stage(hg * (R + P),
        [&](int i) {
          return i < hg * R ? load_as_float(q_eff, qoff + i)
                            : load_as_float(q_rope, roff + (i - hg * R));
        },
        [&](int i, float v) { qe[i] = v; });  // qr follows qe at hg * R
  // thread (task, t): partial t of lane l's scores for kMlaHeads heads
  const int task = tid / parts, t = tid - task * parts;
  const int tasks = L * ((hg + kMlaHeads - 1) / kMlaHeads);
  const int pst = parts + 1;  // padded: the final sums read across banks
  const int r4 = R / 4, p4 = P / 4;
  const long long ml = (long long)M * L;
  const long long row0 = (long long)b * H + h0;
  float* qrh = qe + hg * R;  // the rope queries, right after the hg latent ones
  for (int j = 0; j < nc; ++j) {
    const int base = (c0 + j) * L;
    __syncthreads();  // blk is set; the previous block's scores are done with cs / rs
    const long long id = blk[j];
    stage(L * (r4 + p4),
          [&](int i) {
            return i < L * r4 ? load_quad(c_pool, id * L * R + 4 * (long long)i)
                              : load_quad(r_pool, id * L * P + 4 * (long long)(i - L * r4));
          },
          [&](int i, const float4& v) {
            float* dst;
            if (i < L * r4) {
              const int l = i / r4;
              dst = cs + l * cst + 4 * (i - l * r4);
            } else {
              const int k = i - L * r4, l = k / p4;
              dst = rs + l * rst + 4 * (k - l * p4);
            }
            dst[0] = v.x;
            dst[1] = v.y;
            dst[2] = v.z;
            dst[3] = v.w;
          });
    __syncthreads();
    for (int k = task; k < tasks; k += kMlaThreads / parts) {
      const int l = k % L, h0 = k / L * kMlaHeads;
      float pr[kMlaHeads], pp[kMlaHeads];
#pragma unroll
      for (int u = 0; u < kMlaHeads; ++u) pr[u] = pp[u] = 0.0f;
      const float* cr = cs + l * cst;
      for (int i = t; i < R; i += parts) {
        const float c = cr[i];
#pragma unroll
        for (int u = 0; u < kMlaHeads; ++u)
          if (h0 + u < hg) pr[u] = fmaf(qe[(h0 + u) * R + i], c, pr[u]);
      }
      const float* rr = rs + l * rst;
      for (int i = t; i < P; i += parts) {
        const float r = rr[i];
#pragma unroll
        for (int u = 0; u < kMlaHeads; ++u)
          if (h0 + u < hg) pp[u] = fmaf(qrh[(h0 + u) * P + i], r, pp[u]);
      }
#pragma unroll
      for (int u = 0; u < kMlaHeads; ++u) {
        if (h0 + u < hg) {
          part[((h0 + u) * L + l) * pst + t] = pr[u];
          part[((HG + h0 + u) * L + l) * pst + t] = pp[u];
        }
      }
    }
    __syncthreads();
    for (int si = tid; si < hg * L; si += kMlaThreads) {  // si = h * L + l
      const float* a = part + si * pst;
      const float* c = part + (HG * L + si) * pst;
      const float sr = combine_parts<ORDER>(a);
      const float sp = combine_parts<ORDER>(c);
      const int h = si / L, l = si - h * L;
      const float v = (sr + sp) * scale;
      ws[(row0 + h) * ml + base + l] = (base + l < klen) ? v : kNegInf;
    }
  }
}

template <int IMPL>
__global__ void __launch_bounds__(kSoftmaxThreads)
    mla_decode_kernel_softmax(float* __restrict__ ws, int B, int H,
                              const int* __restrict__ k_len, int L, int M, int tile,
                              const CordicParams p) {
  softmax_row<IMPL>(ws, (long long)B * H, H, k_len, L, M, tile, p);
}

// The P.V sums of `chunk` blocks for all heads of a slot, over kPvCols
// latent columns: the latent slice staged once, two threads a column.
template <int PARTS, bool PIECES>
__global__ void __launch_bounds__(kPvThreads)
    mla_decode_kernel_pv(const float* __restrict__ c_pool, const int* __restrict__ tables,
                         const int* __restrict__ k_len, float* __restrict__ ws, int B, int H,
                         int R, int L, int M, int chunk, int piece) {
  extern __shared__ float smem[];
  __shared__ long long blk[kMaxChunk];
  const int cols = kPvCols;
  float* vs = smem;                  // (chunk, L, cols) latent slice
  float* ps = vs + chunk * L * cols; // (H, chunk * L) lane weights
  const int b = blockIdx.z, r0 = blockIdx.y * cols, tid = threadIdx.x;
  const int live = live_blocks(k_len[b], L, M);
  const int c0 = blockIdx.x * chunk;
  if (c0 >= live) return;
  const int nc = min(chunk, live - c0);
  if (tid < nc) blk[tid] = tables[(long long)b * M + c0 + tid];
  const Workspace w = carve(ws, (long long)B * H, M, L);
  const long long row0 = (long long)b * H;
  stage_weights(ps, w, row0, H, c0, nc, L, M);
  __syncthreads();
  const int c4 = cols / 4, width = min(cols, R - r0);
  stage(nc * L * c4,
        [&](int i) {
          const int jl = i / c4, j = jl / L, col = 4 * (i - jl * c4);
          return load_quad(c_pool, (blk[j] * L + (jl - j * L)) * R + r0 + (col < width ? col : 0));
        },
        [&](int i, const float4& v) {
          float* dst = vs + 4 * i;
          dst[0] = v.x;
          dst[1] = v.y;
          dst[2] = v.z;
          dst[3] = v.w;
        });
  __syncthreads();
  // thread (half, column): each half of the CTA takes half of the heads
  const int half = tid / kPvCols, cc = tid - half * kPvCols, hh = (H + 1) / 2;
  if (cc < width)
    pv_sums<PARTS, PIECES>(
        ps, vs, half * hh, min(H, (half + 1) * hh), nc, L, piece, cols, cc,
        [&](int r, int j, float v) { w.pv[((row0 + r) * M + c0 + j) * R + r0 + cc] = v; });
}

template <bool EXACT>
__global__ void __launch_bounds__(kFoldThreads)
    mla_decode_kernel_fold(float* __restrict__ ws, int B, int H, int R,
                           const int* __restrict__ k_len, int L, int M, float* __restrict__ out) {
  fold_row<EXACT>(ws, (long long)B * H, H, R, k_len, L, M, out);
}

template <typename TQ, int IMPL>
int launch_mla(const void* q_eff, const void* q_rope, const void* c_pool, const void* r_pool,
               const void* tables, const void* k_len, void* out, void* ws, int B, int H, int R,
               int P, int L, int M, int HG, int chunk, int tile, int order, int pv_parts,
               int pv_piece, float scale, const CordicParams& p, cudaStream_t s) {
  int rc = launch_order(order, [&](auto code) {
    constexpr int kOrder = decltype(code)::value, kParts = kOrder >> 1;
    auto score = mla_decode_kernel_score<TQ, kOrder>;
    const size_t score_bytes =
        sizeof(float) * ((size_t)HG * (R + P) + (size_t)L * (R + kPad + P + kPad) +
                         2 * (size_t)HG * L * (kParts + 1));
    int r = smem_ok(score, score_bytes);
    if (r) return r;
    score<<<dim3((M + chunk - 1) / chunk, (H + HG - 1) / HG, B), kMlaThreads, score_bytes,
            s>>>((const TQ*)q_eff, (const TQ*)q_rope, (const float*)c_pool,
                 (const float*)r_pool, (const int*)tables, (const int*)k_len, (float*)ws, H,
                 R, P, L, M, HG, chunk, scale);
    return (int)cudaGetLastError();
  });
  if (rc) return rc;

  auto softmax = mla_decode_kernel_softmax<IMPL>;
  const size_t softmax_bytes = softmax_smem(L, M, tile);
  if ((rc = smem_ok(softmax, softmax_bytes))) return rc;
  softmax<<<dim3(H, B), kSoftmaxThreads, softmax_bytes, s>>>((float*)ws, B, H,
                                                             (const int*)k_len, L, M, tile, p);
  if ((rc = (int)cudaGetLastError())) return rc;

  // a kernel per P.V order: the latent's staging is light, and the orders'
  // register needs differ
  const auto pv = pv_parts == 4     ? mla_decode_kernel_pv<4, false>
                  : pv_piece < L    ? mla_decode_kernel_pv<1, true>
                                    : mla_decode_kernel_pv<1, false>;
  const size_t pv_bytes = sizeof(float) * (size_t)chunk * L * (kPvCols + H);
  if ((rc = smem_ok(pv, pv_bytes))) return rc;
  pv<<<dim3((M + chunk - 1) / chunk, (R + kPvCols - 1) / kPvCols, B), kPvThreads, pv_bytes,
       s>>>((const float*)c_pool, (const int*)tables, (const int*)k_len, (float*)ws, B, H, R, L,
            M, chunk, pv_piece);
  if ((rc = (int)cudaGetLastError())) return rc;

  auto fold = mla_decode_kernel_fold<IMPL == kExact>;
  const size_t fold_bytes = sizeof(float) * (size_t)M;
  if ((rc = smem_ok(fold, fold_bytes))) return rc;
  fold<<<dim3(fold_ctas(H, R), B), fold_threads(R), fold_bytes, s>>>(
      (float*)ws, B, H, R, (const int*)k_len, L, M, (float*)out);
  return (int)cudaGetLastError();
}

template <typename TQ>
int launch_mla_impl(int impl, const void* qe, const void* qr, const void* cp, const void* rp,
                    const void* t, const void* kl, void* o, void* ws, int B, int H, int R,
                    int P, int L, int M, int HG, int chunk, int tile, int order, int pv_parts,
                    int pv_piece, float scale, const CordicParams& p, cudaStream_t s) {
  switch (impl) {
    case kExact:
      return launch_mla<TQ, kExact>(qe, qr, cp, rp, t, kl, o, ws, B, H, R, P, L, M, HG, chunk,
                                    tile, order, pv_parts, pv_piece, scale, p, s);
    case kCordicPallas:
      return launch_mla<TQ, kCordicPallas>(qe, qr, cp, rp, t, kl, o, ws, B, H, R, P, L, M, HG,
                                           chunk, tile, order, pv_parts, pv_piece, scale, p, s);
    case kCordicFixed:
      return launch_mla<TQ, kCordicFixed>(qe, qr, cp, rp, t, kl, o, ws, B, H, R, P, L, M, HG,
                                          chunk, tile, order, pv_parts, pv_piece, scale, p, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// impl: 0 exact, 1 cordic_pallas, 2 cordic_fixed. q_dtype: 0 float32, 1 bfloat16
// (q_eff and q_rope alike). ws: the workspace of paged_attention.mla_plan,
// ws_floats float32 words (at least workspace_floats(B * H, M, L, R)).
// score_heads: heads of a score CTA; chunk: blocks of a score / pv CTA
// (1..4); tile: blocks a softmax CTA holds in shared memory at once; order:
// the score dots' order, 2 * partials + halve (paged_attention.DotOrder);
// pv_order, pv_chunk: the P.V dots' (as paged_gqa_decode's).
extern "C" int paged_mla_decode(const void* q_eff, const void* q_rope, int q_dtype,
                                const void* c_pool, const void* r_pool, const void* tables,
                                const void* k_len, void* out, void* ws, long long ws_floats,
                                int B, int H, int R, int P, int L, int M, int score_heads,
                                int chunk, int tile, int order, int pv_order, int pv_chunk,
                                float scale, int impl, const CordicParams* p, void* stream) {
  if (B == 0 || H == 0) return (int)cudaGetLastError();
  if (!pv_order_ok(pv_order, pv_chunk)) return (int)cudaErrorInvalidValue;
  const int pv_parts = pv_order >> 1, pv_piece = pv_chunk > 0 ? pv_chunk : L;
  if (score_heads < 1 || chunk < 1 || chunk > kMaxChunk || tile < 1 || R % 4 || P % 4 ||
      !order_ok(order) || R % (order >> 1) || P % (order >> 1) ||
      ws_floats < workspace_floats((long long)B * H, M, L, R))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  return q_dtype == 0
             ? launch_mla_impl<float>(impl, q_eff, q_rope, c_pool, r_pool, tables, k_len, out,
                                      ws, B, H, R, P, L, M, score_heads, chunk, tile, order,
                                      pv_parts, pv_piece, scale, *p, s)
             : launch_mla_impl<__nv_bfloat16>(impl, q_eff, q_rope, c_pool, r_pool, tables,
                                              k_len, out, ws, B, H, R, P, L, M, score_heads,
                                              chunk, tile, order, pv_parts, pv_piece, scale, *p,
                                              s);
}

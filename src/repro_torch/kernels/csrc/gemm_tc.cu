// Row-count-invariant bf16 matrix products on Hopper's tensor cores.
//
// Replaces no TPU kernel: the JAX package leaves these products to XLA.
// They are the bf16 products of the paged prefill (models/common.py
// ``INVARIANT``, ROADMAP B.10 and B.12): the row projections, the MLPs and
// the float32 logits of bf16 operands. kernels/gemm.py ``gemm`` sends a
// launch here when both operands are bf16 (``gemm_route``); any float32
// operand takes gemm.cu's float32 chain, and nothing falls back from one to
// the other.
//
// tc_gemm: C[b] = A[b] (M x K) . B[b] (K x N), bf16 operands, float32
// accumulation in the tensor cores, one rounding to the output's dtype
// (bf16 or float32) in the epilogue.
//
// The invariance contract: an output element's bits depend on K, its own
// row of A and its own column of B, never on M, the batch count, the grid
// or the element's place in a tile.
//   * One fixed instruction sequence: every launch runs wgmma
//     m64n128k16.f32.bf16.bf16 on a 128 x 128 CTA tile (two consumer
//     warpgroups of 64 rows each). The grid follows the shape; the
//     instruction, the tile and the k-walk do not.
//   * The k-walk: each tile walks K from k = 0 in kBK = 64 slices, in order,
//     four k16 instructions a slice, each accumulating onto the same
//     float32 registers (started at 0). No split-K, no stream-K: an
//     element's sum never leaves its CTA.
//   * The K tail: the last slice's columns past K are zero-filled by TMA's
//     out-of-bounds fill, so a K that is not a multiple of 64 gives the bits
//     of the same operands zero-padded to the next multiple (their products
//     are +0).
//   * M and N edges: rows past M and columns past N are zero-filled on load
//     and masked on store; a row's arithmetic does not read its neighbours,
//     whichever warpgroup or 64-row fragment row holds it.
// chip_smoke.py phase (3d) checks each of these on the card: every row of
// every bf16 product bit-equal at M 1-4000 and across batch counts, a K
// tail against its zero padding.
//
// The bound. No plain version can replay a tensor core's order inside one
// instruction (Hopper aligns the k16 products to the largest exponent and
// truncates, by published measurements), so the kernel is held by
// invariance and by |c - c64| <= gamma * sum_k |a_k * b_k| against a
// float64 product of the same operands, gamma in kernels/gemm.py
// ``tc_gamma``.
//
// What bounds it: at a prefill's row counts the tensor cores (2MNK at 989
// TFLOP/s bf16), at a few rows the bytes of B. Design: TMA tile loads with
// 128-byte swizzle into a ring of kStages shared-memory stages, full and
// empty mbarriers; one producer warp issues the loads, two consumer
// warpgroups issue wgmma with one group in flight and release a stage when
// the group that read it is done; the epilogue stores each fragment
// straight from registers, masked. A is K-major (row-major (M, K)); B is
// read in either layout: N-major (a (K, N) weight, row-major) through
// wgmma's transpose bit, or K-major (the transpose of an (N, K) table, as
// the logits' embedding). The wrapper copies an operand whose strides TMA
// cannot describe.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBM = 128, kBN = 128, kBK = 64, kStages = 4;
constexpr int kConsumers = 2;                       // warpgroups of 64 rows
constexpr int kThreads = 128 * (kConsumers + 1);    // + the producer's
constexpr int kTileBytes = kBM * kBK * 2;           // A and B stages alike
constexpr int kSmemBytes = 2 * kStages * kTileBytes + 2 * kStages * 8 + 1024;

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_wait(uint32_t bar, int parity) {
  uint32_t done;
  do {
    asm volatile(
        "{\n .reg .pred p;\n"
        " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  } while (!done);
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
}

__device__ __forceinline__ void mbar_expect(uint32_t bar, int bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                         int c0, int c1, int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4, %5}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1), "r"(c2)
      : "memory");
}

// A shared-memory matrix descriptor, 128-byte swizzle: start address, the
// leading and stride byte offsets, all in 16-byte units.
__device__ __forceinline__ uint64_t sw128_desc(uint32_t addr, uint32_t lbo, uint32_t sbo) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)(lbo >> 4) << 16) |
         ((uint64_t)(sbo >> 4) << 32) | (1ull << 62);
}

__device__ __forceinline__ void fence_acc(float (&d)[64]) {
#pragma unroll
  for (int i = 0; i < 64; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// D (64 x 128, f32) += A (64 x 16) . B (16 x 128), both from shared memory;
// TRANS_B: B is N-major.
template <int TRANS_B>
__device__ __forceinline__ void wgmma_128(float (&d)[64], uint64_t da, uint64_t db) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %67, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1, 0, %66;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),
        "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]),
        "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]),
        "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "n"(TRANS_B), "r"(1));
}

__device__ __forceinline__ void put2(float* p, float x, float y) {
  *reinterpret_cast<float2*>(p) = make_float2(x, y);
}
__device__ __forceinline__ void put2(__nv_bfloat16* p, float x, float y) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(x, y);
}
__device__ __forceinline__ void put1(float* p, float x) { *p = x; }
__device__ __forceinline__ void put1(__nv_bfloat16* p, float x) { *p = __float2bfloat16_rn(x); }

// grid (ceil(M / 128), ceil(N / 128), batch); A's map (K, M, batch), B's
// (N, K, batch) when TRANS_B, else (K, N, batch); C (batch, M, N) contiguous.
template <typename TC, int TRANS_B>
__global__ void __launch_bounds__(kThreads, 1)
    tc_gemm_kernel(const __grid_constant__ CUtensorMap map_a,
                   const __grid_constant__ CUtensorMap map_b, TC* __restrict__ C, int M, int N,
                   int K, int za, int zb) {
  extern __shared__ uint8_t smem_raw[];
  // the 128-byte swizzle repeats every 1024 bytes: align the ring to it
  uint8_t* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  uint8_t* sa = smem;                                  // kStages x (128 x 64) of A
  uint8_t* sb = smem + kStages * kTileBytes;           // kStages x (64 x 128) of B
  uint64_t* full = reinterpret_cast<uint64_t*>(sb + kStages * kTileBytes);
  uint64_t* empty = full + kStages;

  const int m0 = blockIdx.x * kBM, n0 = blockIdx.y * kBN, z = blockIdx.z;
  const int z_a = z * za, z_b = z * zb;  // 0: an operand shared by the batch
  const int nk = (K + kBK - 1) / kBK;
  const int wg = threadIdx.x / 128;
  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(smem_u32(&full[s]), 1);
      mbar_init(smem_u32(&empty[s]), 128 * kConsumers);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (wg == 0) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n");
    if (threadIdx.x == 0) {
      for (int kt = 0; kt < nk; ++kt) {
        const int s = kt % kStages;
        mbar_wait(smem_u32(&empty[s]), ((kt / kStages) & 1) ^ 1);
        const uint32_t bar = smem_u32(&full[s]);
        mbar_expect(bar, 2 * kTileBytes);
        tma_load(smem_u32(sa + s * kTileBytes), &map_a, bar, kt * kBK, m0, z_a);
        if (TRANS_B) {  // two 64-column boxes, (64 k x 64 n) each
          tma_load(smem_u32(sb + s * kTileBytes), &map_b, bar, n0, kt * kBK, z_b);
          tma_load(smem_u32(sb + s * kTileBytes + kTileBytes / 2), &map_b, bar, n0 + 64,
                   kt * kBK, z_b);
        } else {
          tma_load(smem_u32(sb + s * kTileBytes), &map_b, bar, kt * kBK, n0, z_b);
        }
      }
    }
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n");
    const int c = wg - 1;  // this warpgroup's 64 rows of the tile
    float acc[64];
#pragma unroll
    for (int i = 0; i < 64; ++i) acc[i] = 0.0f;
    for (int kt = 0; kt < nk; ++kt) {
      const int s = kt % kStages;
      mbar_wait(smem_u32(&full[s]), (kt / kStages) & 1);
      const uint32_t a0 = smem_u32(sa + s * kTileBytes + c * 64 * 128);
      const uint32_t b0 = smem_u32(sb + s * kTileBytes);
      fence_acc(acc);
      asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
#pragma unroll
      for (int kk = 0; kk < kBK / 16; ++kk) {
        // A: rows of 128 bytes, 8-row atoms 1024 bytes apart, k16 = 32 bytes on
        const uint64_t da = sw128_desc(a0 + kk * 32, 16, 1024);
        // B N-major: 64-column atoms (64 k rows x 128 bytes) 8192 bytes apart,
        // 8 k rows 1024 bytes apart, k16 = 16 rows on; K-major: as A
        const uint64_t db = TRANS_B ? sw128_desc(b0 + kk * 2048, 8192, 1024)
                                    : sw128_desc(b0 + kk * 32, 16, 1024);
        wgmma_128<TRANS_B>(acc, da, db);
      }
      asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
      fence_acc(acc);
      // the group before this one is done: its stage goes back to the producer
      asm volatile("wgmma.wait_group.sync.aligned 1;\n" ::: "memory");
      fence_acc(acc);
      if (kt > 0) mbar_arrive(smem_u32(&empty[(kt - 1) % kStages]));
    }
    asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
    fence_acc(acc);
    // fragment layout of m64nNk16: register 4j + r of thread t holds row
    // 16 * warp + t % 32 / 4 + 8 * (r / 2), column 8j + 2 (t % 4) + r % 2
    const int t = threadIdx.x % 128;
    const int row_base = m0 + c * 64 + (t / 32) * 16 + (t % 32) / 4;
    const int col_base = n0 + 2 * (t % 4);
    const long long zmn = (long long)z * M * N;
    TC* Cz = C + zmn;
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      const int col = col_base + 8 * j;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int row = row_base + 8 * h;
        if (row < M) {
          const long long at = (long long)row * N + col;
          TC* p = Cz + at;
          const float x = acc[4 * j + 2 * h], y = acc[4 * j + 2 * h + 1];
          // a pair store wants the pair's first element at an even place
          if (col + 1 < N && ((zmn + at) & 1) == 0) {
            put2(p, x, y);
          } else {
            if (col < N) put1(p, x);
            if (col + 1 < N) put1(p + 1, y);
          }
        }
      }
    }
  }
}

EncodeTiled encoder() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
#if CUDART_VERSION >= 12050
    if (cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault,
                                         &q) != cudaSuccess ||
        q != cudaDriverEntryPointSuccess)
      return nullptr;
#else
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &q) !=
            cudaSuccess ||
        q != cudaDriverEntryPointSuccess)
      return nullptr;
#endif
    fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// A 3-d bf16 map (inner, outer, batch) with element strides (1, s1, s2)
// and a (box0, box1, 1) box, 128-byte swizzle, zero out-of-bounds fill.
int make_map(CUtensorMap* map, const void* base, long long inner, long long outer,
             long long batch, long long s1, long long s2, int box0, int box1) {
  EncodeTiled enc = encoder();
  if (enc == nullptr) return (int)cudaErrorNotSupported;
  cuuint64_t dims[3] = {(cuuint64_t)inner, (cuuint64_t)outer, (cuuint64_t)batch};
  cuuint64_t strides[2] = {(cuuint64_t)s1 * 2, (cuuint64_t)s2 * 2};
  cuuint32_t box[3] = {(cuuint32_t)box0, (cuuint32_t)box1, 1};
  cuuint32_t estr[3] = {1, 1, 1};
  CUresult r = enc(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, const_cast<void*>(base), dims,
                   strides, box, estr, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                   CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : (int)cudaErrorInvalidValue;
}

template <typename TC, int TRANS_B>
int launch(const CUtensorMap& ma, const CUtensorMap& mb, void* c, int batch, int M, int N, int K,
           int za, int zb, cudaStream_t s) {
  auto kern = tc_gemm_kernel<TC, TRANS_B>;
  static bool attr = false;
  if (!attr) {
    cudaError_t e =
        cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemBytes);
    if (e != cudaSuccess) return (int)e;
    attr = true;
  }
  dim3 grid((M + kBM - 1) / kBM, (N + kBN - 1) / kBN, batch);
  kern<<<grid, kThreads, kSmemBytes, s>>>(ma, mb, (TC*)c, M, N, K, za, zb);
  return (int)cudaGetLastError();
}

}  // namespace

// a (batch, M, K) bf16, element strides (sab, sam, 1); b (batch, K, N) bf16,
// element strides (sbb, sbk, sbn) with sbn == 1 (N-major) or sbk == 1
// (K-major); c (batch, M, N) contiguous, c_dtype 0 float32, 1 bf16
// (build.DTYPE_CODE). TMA's layout rules (kernels/gemm.py ``tma_ready``):
// each base 16-byte aligned, each stride but the unit one a multiple of 8
// elements; a batch stride of 0 is an operand shared by the batch. A layout
// outside them is refused with cudaErrorInvalidValue (the wrapper copies
// such an operand first).
extern "C" int tc_gemm(const void* a, long long sab, long long sam, long long sak,
                       const void* b, long long sbb, long long sbk, long long sbn, void* c,
                       int c_dtype, int batch, int M, int N, int K, void* stream) {
  if (batch <= 0 || M <= 0 || N <= 0 || K <= 0) return (int)cudaGetLastError();
  const bool trans_b = sbn == 1;
  auto legal = [](long long s) { return s > 0 && s % 8 == 0; };
  if (batch > 65535 || (N + kBN - 1) / kBN > 65535 || (c_dtype & ~1) || sak != 1 ||
      !(trans_b || sbk == 1) || ((uintptr_t)a & 15) || ((uintptr_t)b & 15) || !legal(sam) ||
      !legal(trans_b ? sbk : sbn) || (sab && !legal(sab)) || (sbb && !legal(sbb)))
    return (int)cudaErrorInvalidValue;
  // a batch stride of 0: a map of one batch, read at batch 0 by every CTA
  const int za = sab != 0, zb = sbb != 0;
  CUtensorMap ma, mb;
  int rc = make_map(&ma, a, K, M, za ? batch : 1, sam, za ? sab : sam * M, kBK, kBM);
  if (rc == 0)
    rc = trans_b ? make_map(&mb, b, N, K, zb ? batch : 1, sbk, zb ? sbb : sbk * K, 64, kBK)
                 : make_map(&mb, b, K, N, zb ? batch : 1, sbn, zb ? sbb : sbn * N, kBK, kBN);
  if (rc) return rc;
  cudaStream_t s = (cudaStream_t)stream;
  if (c_dtype == 0)
    return trans_b ? launch<float, 1>(ma, mb, c, batch, M, N, K, za, zb, s)
                   : launch<float, 0>(ma, mb, c, batch, M, N, K, za, zb, s);
  return trans_b ? launch<__nv_bfloat16, 1>(ma, mb, c, batch, M, N, K, za, zb, s)
                 : launch<__nv_bfloat16, 0>(ma, mb, c, batch, M, N, K, za, zb, s);
}

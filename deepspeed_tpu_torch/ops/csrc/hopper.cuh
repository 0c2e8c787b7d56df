// Hopper (sm_90a) helpers shared by the wgmma + TMA attention kernels:
// flash_attention_fwd.cu, flash_attention_bwd.cu and
// block_sparse_attention.cu.
//
// * smem_u32, the mbarrier wrappers, fence_async_shared;
// * tma_tile: one box of a 3-d tensor map into shared memory, reported to
//   an mbarrier; tile_map: cuTensorMapEncodeTiled, fetched from the driver
//   through cudaGetDriverEntryPoint (the libraries link nothing);
// * desc_sw128: the shared-memory matrix descriptor of a 128-byte-swizzled
//   tile, the layout TMA writes with CU_TENSOR_MAP_SWIZZLE_128B;
// * wg_fence / wg_commit / wg_wait, fence_acc;
// * Wgmma<N>::ss (A and B in shared memory, both K-major) and
//   Wgmma<N>::rs (A in registers, B MN-major in shared memory) for
//   wgmma.m64nNk16 with 16-bit operands and f32 accumulators, N in {64,
//   80, 96, 128, 192, 256}; pack_a repacks an accumulator as the register
//   A operand; product_ss / product_rs, the two 64 x 64 x 64 products of
//   the backward kernels (flash_attention_bwd.cu, block_sparse_attention.cu);
// * setmaxnreg and the named barriers of warp-specialized kernels.
//
// Accumulator layout of m64nNk16 (PTX ISA): warp w of the warpgroup holds
// rows 16 w + l / 4 and 16 w + l / 4 + 8 of lane l, columns 8 j + 2 (l %
// 4) + {0, 1} of tile j: per warp, the m16n8 mma.sync layout of N / 8
// tiles, held as float d[N / 8][4].
//
// Swizzled layouts (128-byte rows of 64 16-bit elements, 8-row groups of
// 1024 bytes): a tile wider than 64 columns is stored as 64-column
// sub-tiles one after the other. K-major operands advance 32 bytes a k
// step of 16 inside a sub-tile and a whole sub-tile past column 64 (the
// caller's address). An MN-major B operand wider than 64 (N > 64) finds
// its next 64 columns one sub-tile further on: the descriptor's leading
// byte offset; its 8-row groups along K lie 1024 bytes apart (the stride
// byte offset).

#pragma once

#include <cuda.h>          // CUtensorMap; the encoder is fetched at run time
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace hopper {

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n"
               :: "r"(smem_u32(bar)), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, int bytes) {
  asm volatile("mbarrier.expect_tx.shared::cta.b64 [%0], %1;\n"
               :: "r"(smem_u32(bar)), "r"(bytes) : "memory");
}

// arrive and expect `bytes` more of the async proxy in one step
__device__ __forceinline__ void mbar_arrive_expect_tx(uint64_t* bar,
                                                      int bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               :: "r"(smem_u32(bar)), "r"(bytes) : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n"
               :: "r"(smem_u32(bar)) : "memory");
}

// wait until the phase of parity `parity` has completed (the loop inside
// the asm: no branch the compiler could take for divergent)
__device__ __forceinline__ void mbar_wait(uint64_t* bar, int parity) {
  asm volatile("{\n.reg .pred done;\nWAIT_%=:\n"
               "mbarrier.try_wait.parity.shared::cta.b64 done, [%0], %1;\n"
               "@!done bra WAIT_%=;\n}\n"
               :: "r"(smem_u32(bar)), "r"(parity) : "memory");
}

// make barrier initialisation visible to the async proxy (TMA)
__device__ __forceinline__ void fence_mbar_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

// one box at (col, row, bh) of a 3-d tensor map into shared memory;
// elements past the tensor's ends read zeros
__device__ __forceinline__ void tma_tile(void* dst, const CUtensorMap* map,
                                         uint64_t* bar, int col, int row,
                                         int bh) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5}], [%2];\n"
      :: "r"(smem_u32(dst)), "l"(map), "r"(smem_u32(bar)), "r"(col),
         "r"(row), "r"(bh) : "memory");
}

// descriptor of a 128-byte-swizzled tile (1024-byte aligned): stride byte
// offset 1024 between 8-row groups; lbo_bytes between the 64-column
// sub-tiles of an MN-major operand (unused by K-major ones)
__device__ __forceinline__ uint64_t desc_sw128(const void* p,
                                               uint32_t lbo_bytes = 16) {
  uint64_t d = (smem_u32(p) & 0x3FFFF) >> 4;
  d |= uint64_t((lbo_bytes >> 4) & 0x3FFF) << 16;   // leading byte offset
  d |= uint64_t(1024 >> 4) << 32;                   // stride byte offset
  d |= uint64_t(1) << 62;                           // 128-byte swizzle
  return d;
}

__device__ __forceinline__ void wg_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wg_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
// wait until at most N committed groups of this warpgroup are pending
template <int N = 0> __device__ __forceinline__ void wg_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" :: "n"(N) : "memory");
}

// keep the compiler from moving accumulator reads or writes across a
// wgmma fence or wait
template <int NT>
__device__ __forceinline__ void fence_acc(float (*d)[4]) {
#pragma unroll
  for (int j = 0; j < NT; ++j)
#pragma unroll
    for (int c = 0; c < 4; ++c) asm volatile("" : "+f"(d[j][c]) :: "memory");
}

// two f32 values rounded to T (bf16 or fp16), lo in the low half
template <typename T>
__device__ __forceinline__ uint32_t pack2(float lo, float hi) {
  if constexpr (std::is_same<T, __nv_bfloat16>::value) {
    __nv_bfloat162 t = __floats2bfloat162_rn(lo, hi);
    return *reinterpret_cast<uint32_t*>(&t);
  } else {
    __half2 t = __floats2half2_rn(lo, hi);
    return *reinterpret_cast<uint32_t*>(&t);
  }
}

// the register A fragments of k step kk (16 columns) of a 64-row f32
// accumulator, rounded to T
template <typename T>
__device__ __forceinline__ void pack_a(uint32_t* a, const float (*x)[4],
                                       int kk) {
  a[0] = pack2<T>(x[2 * kk][0], x[2 * kk][1]);
  a[1] = pack2<T>(x[2 * kk][2], x[2 * kk][3]);
  a[2] = pack2<T>(x[2 * kk + 1][0], x[2 * kk + 1][1]);
  a[3] = pack2<T>(x[2 * kk + 1][2], x[2 * kk + 1][3]);
}

// ------------------------------------------------------------- wgmma

// operand lists of an accumulator of NT 8-column tiles
#define WG_T1(d, j) "+f"(d[j][0]), "+f"(d[j][1]), "+f"(d[j][2]), "+f"(d[j][3])
#define WG_T2(d, j) WG_T1(d, j), WG_T1(d, (j) + 1)
#define WG_T4(d, j) WG_T2(d, j), WG_T2(d, (j) + 2)
#define WG_T8(d, j) WG_T4(d, j), WG_T4(d, (j) + 4)
#define WG_T16(d, j) WG_T8(d, j), WG_T8(d, (j) + 8)
#define WG_OPS8(d) WG_T8(d, 0)
#define WG_OPS10(d) WG_T8(d, 0), WG_T2(d, 8)
#define WG_OPS12(d) WG_T8(d, 0), WG_T4(d, 8)
#define WG_OPS16(d) WG_T16(d, 0)
#define WG_OPS24(d) WG_T16(d, 0), WG_T8(d, 16)
#define WG_OPS32(d) WG_T16(d, 0), WG_T16(d, 16)

// the register numbers of those lists, and of the operands after them
#define WG_R8 \
  "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, " \
  "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
#define WG_SS_TAIL8 "}, %32, %33, p, 1, 1, 0, 0;\n}\n"
#define WG_SS_PRED8 "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
#define WG_RS_TAIL8 "}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
#define WG_RS_PRED8 "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
#define WG_R10 \
  "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, " \
  "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, " \
  "%32, %33, %34, %35, %36, %37, %38, %39"
#define WG_SS_TAIL10 "}, %40, %41, p, 1, 1, 0, 0;\n}\n"
#define WG_SS_PRED10 "{\n.reg .pred p;\nsetp.ne.b32 p, %42, 0;\n"
#define WG_RS_TAIL10 "}, {%40, %41, %42, %43}, %44, p, 1, 1, 1;\n}\n"
#define WG_RS_PRED10 "{\n.reg .pred p;\nsetp.ne.b32 p, %45, 0;\n"
#define WG_R12 \
  "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, " \
  "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, " \
  "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47"
#define WG_SS_TAIL12 "}, %48, %49, p, 1, 1, 0, 0;\n}\n"
#define WG_SS_PRED12 "{\n.reg .pred p;\nsetp.ne.b32 p, %50, 0;\n"
#define WG_RS_TAIL12 "}, {%48, %49, %50, %51}, %52, p, 1, 1, 1;\n}\n"
#define WG_RS_PRED12 "{\n.reg .pred p;\nsetp.ne.b32 p, %53, 0;\n"
#define WG_R16 \
  "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, " \
  "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, " \
  "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, " \
  "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
#define WG_SS_TAIL16 "}, %64, %65, p, 1, 1, 0, 0;\n}\n"
#define WG_SS_PRED16 "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
#define WG_RS_TAIL16 "}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
#define WG_RS_PRED16 "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
#define WG_R24 \
  "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, " \
  "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, " \
  "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, " \
  "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, " \
  "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, " \
  "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95"
#define WG_SS_TAIL24 "}, %96, %97, p, 1, 1, 0, 0;\n}\n"
#define WG_SS_PRED24 "{\n.reg .pred p;\nsetp.ne.b32 p, %98, 0;\n"
#define WG_RS_TAIL24 "}, {%96, %97, %98, %99}, %100, p, 1, 1, 1;\n}\n"
#define WG_RS_PRED24 "{\n.reg .pred p;\nsetp.ne.b32 p, %101, 0;\n"
#define WG_R32 \
  "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, " \
  "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, " \
  "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, " \
  "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, " \
  "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, " \
  "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, " \
  "%96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111, " \
  "%112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, %127"
#define WG_SS_TAIL32 "}, %128, %129, p, 1, 1, 0, 0;\n}\n"
#define WG_SS_PRED32 "{\n.reg .pred p;\nsetp.ne.b32 p, %130, 0;\n"
#define WG_RS_TAIL32 "}, {%128, %129, %130, %131}, %132, p, 1, 1, 1;\n}\n"
#define WG_RS_PRED32 "{\n.reg .pred p;\nsetp.ne.b32 p, %133, 0;\n"

template <int N> struct Wgmma;

// d (64 x N) = (acc ? d : 0) + A B^T: ss, A [64 rows, 16 k] and B [N rows,
// 16 k] both K-major in shared memory; rs, d += A B with A [64 rows, 16 k]
// in registers (pack_a) and B [16 k rows, N columns] MN-major in shared
// memory
#define WG_DEFINE(NT, N)                                                      \
  template <> struct Wgmma<N> {                                               \
    template <typename T>                                                     \
    static __device__ __forceinline__ void ss(float (*d)[4], uint64_t a,      \
                                              uint64_t b, int acc) {          \
      if constexpr (std::is_same<T, __nv_bfloat16>::value)                    \
        asm volatile(WG_SS_PRED##NT                                           \
                     "wgmma.mma_async.sync.aligned.m64n" #N                   \
                     "k16.f32.bf16.bf16 {" WG_R##NT WG_SS_TAIL##NT            \
                     : WG_OPS##NT(d) : "l"(a), "l"(b), "r"(acc));             \
      else                                                                    \
        asm volatile(WG_SS_PRED##NT                                           \
                     "wgmma.mma_async.sync.aligned.m64n" #N                   \
                     "k16.f32.f16.f16 {" WG_R##NT WG_SS_TAIL##NT              \
                     : WG_OPS##NT(d) : "l"(a), "l"(b), "r"(acc));             \
    }                                                                         \
    template <typename T>                                                     \
    static __device__ __forceinline__ void rs(float (*d)[4],                  \
                                              const uint32_t* a, uint64_t b) {\
      if constexpr (std::is_same<T, __nv_bfloat16>::value)                    \
        asm volatile(WG_RS_PRED##NT                                           \
                     "wgmma.mma_async.sync.aligned.m64n" #N                   \
                     "k16.f32.bf16.bf16 {" WG_R##NT WG_RS_TAIL##NT            \
                     : WG_OPS##NT(d)                                          \
                     : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b),    \
                       "r"(1));                                               \
      else                                                                    \
        asm volatile(WG_RS_PRED##NT                                           \
                     "wgmma.mma_async.sync.aligned.m64n" #N                   \
                     "k16.f32.f16.f16 {" WG_R##NT WG_RS_TAIL##NT              \
                     : WG_OPS##NT(d)                                          \
                     : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b),    \
                       "r"(1));                                               \
    }                                                                         \
  };

WG_DEFINE(8, 64)
WG_DEFINE(10, 80)
WG_DEFINE(12, 96)
WG_DEFINE(16, 128)
WG_DEFINE(24, 192)
WG_DEFINE(32, 256)

#undef WG_DEFINE

// S (64 x 64) = A times B^T, both 64 x 64 16-bit tiles K-major in shared
// memory (128-byte swizzled): four k steps of 16 over head dim 64
template <typename T>
__device__ __forceinline__ void product_ss(float (*d)[4], const T* a,
                                           const T* b) {
  const uint64_t da = desc_sw128(a), db = desc_sw128(b);
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)           // +32 bytes a k step
    Wgmma<64>::ss<T>(d, da + 2 * kk, db + 2 * kk, kk > 0);
}

// d += X (64 x 64 f32 in registers, rounded to T) times the tile B (64
// rows of k, MN-major, swizzled): four k steps of 16 rows (2048 bytes each)
template <typename T>
__device__ __forceinline__ void product_rs(float (*d)[4], const float (*x)[4],
                                           const T* b) {
  const uint64_t db = desc_sw128(b);
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    uint32_t a[4];
    pack_a<T>(a, x, kk);
    Wgmma<64>::rs<T>(d, a, db + 128 * kk);
  }
}

// ----------------------------------------------- warp specialisation

// hand registers back (the producer warpgroup) or take them (consumers);
// every thread of the warpgroup executes it
template <int REGS> __device__ __forceinline__ void regs_dealloc() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" :: "n"(REGS));
}
template <int REGS> __device__ __forceinline__ void regs_alloc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" :: "n"(REGS));
}

// named barrier `id` (1..15) of `count` threads: wait, or arrive only
__device__ __forceinline__ void named_sync(int id, int count) {
  asm volatile("bar.sync %0, %1;\n" :: "r"(id), "r"(count) : "memory");
}
__device__ __forceinline__ void named_arrive(int id, int count) {
  asm volatile("bar.arrive %0, %1;\n" :: "r"(id), "r"(count) : "memory");
}

// ---------------------------------------------------------- host side

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                 void*, const cuuint64_t*, const cuuint64_t*,
                                 const cuuint32_t*, const cuuint32_t*,
                                 CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

inline EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (!fn) {
    void* ptr = nullptr;
    cudaDriverEntryPointQueryResult found;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &ptr,
                                cudaEnableDefault, &found) == cudaSuccess &&
        found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(ptr);
  }
  return fn;
}

// a [BH, rows, D] 16-bit tensor in boxes of 64 columns x box_rows rows,
// 128-byte swizzled; elements past D or past rows read zeros
inline bool tile_map(CUtensorMap* m, const void* base, bool bf, int rows,
                     int BH, int D = 64, int box_rows = 64) {
  const EncodeTiled fn = encode_tiled();
  if (!fn) return false;
  const cuuint64_t dims[3] = {(cuuint64_t)D, (cuuint64_t)rows,
                              (cuuint64_t)BH};
  const cuuint64_t strides[2] = {(cuuint64_t)D * 2,
                                 (cuuint64_t)rows * D * 2};
  const cuuint32_t box[3] = {64, (cuuint32_t)box_rows, 1};
  const cuuint32_t unit[3] = {1, 1, 1};
  return fn(m, bf ? CU_TENSOR_MAP_DATA_TYPE_BFLOAT16
                  : CU_TENSOR_MAP_DATA_TYPE_FLOAT16,
            3, const_cast<void*>(base), dims, strides, box, unit,
            CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
            CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

constexpr int ERR_TENSOR_MAP = -2;

}  // namespace hopper

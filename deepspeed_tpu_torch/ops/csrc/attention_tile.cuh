// Tile helpers shared by the mma.sync attention kernels for Hopper (sm_90a):
// flash_attention_fwd.cu, flash_attention_bwd.cu and
// block_sparse_attention.cu.
//
// Element types: T is __nv_bfloat16 or __half. Products run on
// mma.sync.aligned.m16n8k16 with T operands and f32 accumulators; a value
// repacked as an operand (P, dS) is rounded to T.
//
// Head dims: a kernel is instantiated at a padded width DP in {32, 64, 96,
// 128, 192, 256} and reads rows of the real width D (any D % 8 == 0,
// D <= DP) from device memory; wider rows take the kernels of
// attention_wide.cuh. Columns D..DP are zeros in registers and shared memory
// (a 16-byte chunk of 8 elements lies wholly inside or outside the row,
// since D % 8 == 0), so Q K^T and P V are unchanged, and stores stop at
// column D. DP / 16 is even for every DP, which keeps the pairing of two
// k steps per ldmatrix.x4 in mma_abt.
//
// Widths above 128 (OwnA): a warp's 16 own rows as register fragments
// would take DP / 4 registers a matrix, beside accumulators of DP / 2, so
// the CTA's 64 own rows stay in shared memory and each k step's A fragment
// is read there by ldmatrix; the registers go to the accumulators.
//
// Accumulator layout of m16n8k16 (PTX ISA): lane l holds rows l/4 and
// l/4 + 8, columns 2*(l%4) + {0, 1} of each 16 x 8 tile.

#pragma once

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace tile {

using bf16 = __nv_bfloat16;
using f16 = __half;

// the padded width a kernel is instantiated at for head dim d
__host__ __device__ constexpr int pad_dim(int d) {
  return d <= 32 ? 32 : d <= 64 ? 64 : d <= 96 ? 96 : d <= 128 ? 128
         : d <= 192 ? 192 : 256;
}

template <typename T>
__device__ __forceinline__ void mma(float* c, const uint32_t* a, uint32_t b0,
                                    uint32_t b1) {
  if constexpr (std::is_same<T, bf16>::value) {
    asm volatile(
        "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
        "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
        "{%0, %1, %2, %3};\n"
        : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
  } else {
    asm volatile(
        "mma.sync.aligned.m16n8k16.row.col.f32.f16.f16.f32 "
        "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
        "{%0, %1, %2, %3};\n"
        : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
  }
}

// two f32 values rounded to T, lo in the low half
template <typename T>
__device__ __forceinline__ uint32_t pack(float lo, float hi) {
  if constexpr (std::is_same<T, bf16>::value) {
    __nv_bfloat162 t = __floats2bfloat162_rn(lo, hi);
    return *reinterpret_cast<uint32_t*>(&t);
  } else {
    __half2 t = __floats2half2_rn(lo, hi);
    return *reinterpret_cast<uint32_t*>(&t);
  }
}

// four 8x8 b16 matrices from shared memory; lanes 8i..8i+7 give the row
// addresses of matrix i. Without .trans lane l receives (row l/4, columns
// 2*(l%4) + {0, 1}) of each; with .trans the transposed matrix.
__device__ __forceinline__ void ldsm_x4(uint32_t* r, const void* ptr) {
  const uint32_t a = static_cast<uint32_t>(__cvta_generic_to_shared(ptr));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 "
               "{%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(a));
}

__device__ __forceinline__ void ldsm_x4_trans(uint32_t* r, const void* ptr) {
  const uint32_t a = static_cast<uint32_t>(__cvta_generic_to_shared(ptr));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 "
               "{%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(a));
}

// 16 bytes global -> shared without a register stop; src_bytes 0 writes
// zeros (a ragged edge or a padded column)
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           int src_bytes) {
  const uint32_t a = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(a), "l"(src), "r"(src_bytes));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N> __device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N));
}

// A fragments of rows r0 / r1 (k columns kk*16 + cq, cq + 1 and + 8) of a
// [n, D] matrix; rows past n and columns past D read zeros
template <typename T, int DP>
__device__ __forceinline__ void load_a(uint32_t (*f)[4], const T* base,
                                       int r0, int r1, int n, int D, int cq) {
  const bool l0 = r0 < n, l1 = r1 < n;
#pragma unroll
  for (int kk = 0; kk < DP / 16; ++kk) {
    const int c = kk * 16 + cq;
    const bool a = c < D, b = c + 8 < D;
    f[kk][0] = l0 && a ? *reinterpret_cast<const uint32_t*>(base + (size_t)r0 * D + c) : 0u;
    f[kk][1] = l1 && a ? *reinterpret_cast<const uint32_t*>(base + (size_t)r1 * D + c) : 0u;
    f[kk][2] = l0 && b ? *reinterpret_cast<const uint32_t*>(base + (size_t)r0 * D + c + 8) : 0u;
    f[kk][3] = l1 && b ? *reinterpret_cast<const uint32_t*>(base + (size_t)r1 * D + c + 8) : 0u;
  }
}

// acc[j] (16 x 8 tile j of a 16 x N product) = A (fragments a) times the
// transpose of the N rows at smem (N x DP, padded row LD): the Q K^T
// pattern. B fragment of k step kk = rows j*8 + lane/4, columns kk*16 +
// cq (+ 8); one ldmatrix.x4 gives two k steps
template <typename T, int DP, int N, int LD>
__device__ __forceinline__ void mma_abt(float (*acc)[4], const uint32_t (*a)[4],
                                        const T* smem, int lane) {
#pragma unroll
  for (int j = 0; j < N / 8; ++j) {
    acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;
    const T* r = &smem[(j * 8 + (lane & 7)) * LD + (lane >> 3) * 8];
#pragma unroll
    for (int kk = 0; kk < DP / 16; kk += 2) {
      uint32_t b[4];
      ldsm_x4(b, r + kk * 16);
      mma<T>(acc[j], a[kk], b[0], b[1]);
      mma<T>(acc[j], a[kk + 1], b[2], b[3]);
    }
  }
}

// out (16 x DP) += X (16 x N, the f32 accumulator tiles x, rounded to T
// and repacked as A fragments of 16 columns) times the N x DP rows at smem:
// the P V pattern. B fragment of column tile n = rows kk*16 + cq + {0, 1}
// (+ 8), column n*8 + lane/4; one ldmatrix.x4.trans gives two column tiles
template <typename T, int DP, int N, int LD>
__device__ __forceinline__ void mma_ab(float (*out)[4], const float (*x)[4],
                                       const T* smem, int lane) {
  const int v_row = (lane & 7) + ((lane >> 3) & 1) * 8, v_col = (lane >> 4) * 8;
#pragma unroll
  for (int kk = 0; kk < N / 16; ++kk) {
    uint32_t a[4];
    a[0] = pack<T>(x[2 * kk][0], x[2 * kk][1]);
    a[1] = pack<T>(x[2 * kk][2], x[2 * kk][3]);
    a[2] = pack<T>(x[2 * kk + 1][0], x[2 * kk + 1][1]);
    a[3] = pack<T>(x[2 * kk + 1][2], x[2 * kk + 1][3]);
    const T* r = &smem[(kk * 16 + v_row) * LD + v_col];
#pragma unroll
    for (int n = 0; n < DP / 8; n += 2) {
      uint32_t b[4];
      ldsm_x4_trans(b, r + n * 8);
      mma<T>(out[n], a, b[0], b[1]);
      mma<T>(out[n + 1], a, b[2], b[3]);
    }
  }
}

// rows r0 / r1 of a 16 x DP f32 accumulator, times scale, to T rows of
// [n, D] from column c0 on; columns past D are not written
template <typename T, int DP>
__device__ __forceinline__ void store_rows(T* base, const float (*acc)[4],
                                           int r0, int r1, int n, int D,
                                           int cq, float s0 = 1.f,
                                           float s1 = 1.f, int c0 = 0) {
#pragma unroll
  for (int rr = 0; rr < 2; ++rr) {
    const int row = rr ? r1 : r0;
    const float s = rr ? s1 : s0;
    if (row >= n) continue;
    T* out = base + (size_t)row * D + c0 + cq;
#pragma unroll
    for (int c = 0; c < DP / 8; ++c)
      if (c0 + c * 8 + cq < D)
        *reinterpret_cast<uint32_t*>(out + c * 8) =
            pack<T>(acc[c][2 * rr] * s, acc[c][2 * rr + 1] * s);
  }
}

// ROWS rows (from i0) of a and of b, [n, D] each, into the shared stage at
// dst (a then b, rows padded to LD = DP + 8) by cp.async, NT threads; rows
// past n and columns past D read zeros. The caller commits the group.
template <typename T, int DP, int ROWS, int NT>
__device__ __forceinline__ void load_pair(T* dst, const T* a, const T* b,
                                          int i0, int n, int D, int tid) {
  constexpr int LD = DP + 8;
  for (int idx = tid; idx < ROWS * DP / 8; idx += NT) {
    const int rr = idx / (DP / 8), c = (idx % (DP / 8)) * 8;
    const int row = i0 + rr;
    const bool live = row < n && c < D;
    const size_t src = live ? (size_t)row * D + c : 0;
    cp_async16(&dst[rr * LD + c], a + src, live ? 16 : 0);
    cp_async16(&dst[ROWS * LD + rr * LD + c], b + src, live ? 16 : 0);
  }
}

// dynamic shared memory of two stages of two tiles of `rows` rows
template <typename T, int DP> constexpr size_t pair_smem_bytes(int rows) {
  return (size_t)2 * 2 * rows * (DP + 8) * sizeof(T);
}

// ROWS rows (from i0) of one [n, D] matrix into shared memory at dst
// (rows padded to LD = DP + 8) by cp.async, NT threads; rows past n and
// columns past D read zeros. The caller commits the group.
template <typename T, int DP, int ROWS, int NT>
__device__ __forceinline__ void load_rows(T* dst, const T* a, int i0, int n,
                                          int D, int tid) {
  constexpr int LD = DP + 8;
  for (int idx = tid; idx < ROWS * DP / 8; idx += NT) {
    const int rr = idx / (DP / 8), c = (idx % (DP / 8)) * 8;
    const int row = i0 + rr;
    const bool live = row < n && c < D;
    cp_async16(&dst[rr * LD + c], a + (live ? (size_t)row * D + c : 0),
               live ? 16 : 0);
  }
}

// The A operand of a warp's products: its 16 of the CTA's 64 own rows.
// Up to width 128, fragments in registers (load_a); wider, the CTA's rows
// in shared memory (own_load issues their cp.async, which the caller
// commits and waits for with its first tile) and the fragments read by
// ldmatrix at every k step.
template <typename T, int DP> struct OwnA {
  static constexpr bool SMEM = DP > 128;
  uint32_t f[SMEM ? 1 : DP / 16][4];
  const T* s;                     // SMEM: the warp's first row
};

// shared memory of the own rows of `mats` matrices (0 below width 128)
template <typename T, int DP> constexpr size_t own_smem_bytes(int mats) {
  return DP > 128 ? (size_t)mats * 64 * (DP + 8) * sizeof(T) : 0;
}

// rows i0 .. i0 + 63 of [n, D] matrix `base` as the CTA's own A operand:
// this thread's fragments (rows r0 / r1), or the tile at `tile` in shared
// memory (4 warps, 128 threads)
template <typename T, int DP>
__device__ __forceinline__ void own_load(OwnA<T, DP>& a, const T* base,
                                         T* tile, int i0, int r0, int r1,
                                         int n, int D, int cq, int tid) {
  if constexpr (OwnA<T, DP>::SMEM) {
    load_rows<T, DP, 64, 128>(tile, base, i0, n, D, tid);
    a.s = tile + (tid / 32) * 16 * (DP + 8);
  } else {
    load_a<T, DP>(a.f, base, r0, r1, n, D, cq);
  }
}

// mma_abt with the A side an OwnA: from registers, or k step by k step
// from shared memory (lanes 0-15 give rows 0-15 at column 0, lanes 16-31
// the same rows at column 8: the four 8 x 8 matrices of the A fragment)
template <typename T, int DP, int N, int LD>
__device__ __forceinline__ void mma_abt(float (*acc)[4], const OwnA<T, DP>& a,
                                        const T* smem, int lane) {
  if constexpr (!OwnA<T, DP>::SMEM) {
    mma_abt<T, DP, N, LD>(acc, a.f, smem, lane);
  } else {
#pragma unroll
    for (int j = 0; j < N / 8; ++j)
      acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;
    const T* ar = a.s + (lane & 15) * LD + (lane >> 4) * 8;
#pragma unroll
    for (int kk = 0; kk < DP / 16; kk += 2) {
      uint32_t a0[4], a1[4];
      ldsm_x4(a0, ar + kk * 16);
      ldsm_x4(a1, ar + kk * 16 + 16);
#pragma unroll
      for (int j = 0; j < N / 8; ++j) {
        uint32_t b[4];
        ldsm_x4(b, &smem[(j * 8 + (lane & 7)) * LD + (lane >> 3) * 8 +
                         kk * 16]);
        mma<T>(acc[j], a0, b[0], b[1]);
        mma<T>(acc[j], a1, b[2], b[3]);
      }
    }
  }
}

// the four float4 slices of f32 row `row` ([n, D]) at columns c; zeros
// past D
__device__ __forceinline__ float4 load_f4(const float* row, int c, int D) {
  return c < D ? *reinterpret_cast<const float4*>(row + c)
               : make_float4(0.f, 0.f, 0.f, 0.f);
}

}  // namespace tile

// Weight-only blockwise-int8 matmul for Hopper (sm_90a), plain C interface.
//
// Replaces the Pallas kernel deepspeed_tpu/ops/pallas/quant_matmul.py
// (_kernel, launched by quant_matmul). It computes
//
//     y[m, n] = sum_kb ( sum_{k in block kb} x[m, k] * q[k, n] ) * s[kb, n]
//
// with q int8 [Kp, N], one f32 scale per `block` (256) rows of K and
// column, f32 accumulation, and y in x's dtype. Rows of q past K (the
// packing's zero padding) meet zeros of x, as in the JAX wrapper's pad.
//
// Bound: bytes at decode (M = the lane count, 8): every int8 weight is
// read once and used for M multiply-adds, so the weight read is the whole
// cost, and a decode matrix (2-65 MB) is small enough that the kernel
// must keep nearly all of it in flight at once. The design reads each
// weight byte once per M-tile, 4 bytes per lane with a warp on 128
// consecutive bytes of a row, with every load of a warp unrolled so none
// waits on another; converts to f32 in registers (the dequant is fused:
// one scale multiply per K-block and column, as in the TPU kernel); and
// spreads the work over (column tile, K-block) CTAs so that a decode
// launch has thousands of warps. Prefill (M up to a few thousand)
// re-reads each weight tile once per 8-row M-tile from L2 and is bound by
// CUDA-core f32 math here; tensor cores are later work.
//
// Layout: a CTA of WARPS = 8 warps owns BN = 128 columns x BM = 8 rows and
// a range of K-blocks of QB = 256 rows. Per K-block: the CTA stages x
// [BM, QB] as f32 in shared memory; warp w multiplies rows [32w, 32w+32)
// of the block into registers; the 8 warp partials are added in warp
// order through shared memory, giving the block's partial product, which
// is scaled once and added to the CTA's sum. With gridDim.z > 1 (few
// column x row tiles, e.g. decode) each z writes an f32 partial and a
// second kernel adds the partials in z order and casts: the result does
// not depend on scheduling.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BN = 128;            // columns per CTA: 32 lanes x 4
constexpr int BM = 8;              // rows of x per CTA
constexpr int QB = 256;            // K rows per scale block (QUANT_BLOCK)
constexpr int WARPS = 8;
constexpr int NT = WARPS * 32;
constexpr int ROWS = QB / WARPS;   // K rows per warp per block
constexpr int OUT_PER_T = BM * BN / NT;

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

template <typename T>
__global__ void __launch_bounds__(NT, 2)
quant_matmul_kernel(const T* __restrict__ x, const int8_t* __restrict__ q,
                    const float* __restrict__ scales, T* __restrict__ out,
                    float* __restrict__ partial, int M, int K, int N,
                    int nkb, int kb_per_cta) {
  __shared__ float xs[BM * QB];             // x tile of one K-block
  __shared__ float red[WARPS * BM * BN];    // the warps' block partials
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int col0 = blockIdx.x * BN;
  const int n0 = col0 + lane * 4;           // this lane's 4 columns
  const int m0 = blockIdx.y * BM;
  const int kb_begin = blockIdx.z * kb_per_cta;
  const int kb_end = min(nkb, kb_begin + kb_per_cta);
  const bool vec4 = (N % 4 == 0) && (n0 + 3 < N);

  float acc[OUT_PER_T];                     // outputs o = tid + j * NT
#pragma unroll
  for (int j = 0; j < OUT_PER_T; ++j) acc[j] = 0.f;

  for (int kb = kb_begin; kb < kb_end; ++kb) {
#pragma unroll
    for (int i = 0; i < BM * QB / NT; ++i) {
      const int idx = threadIdx.x + i * NT;
      const int m = m0 + idx / QB, k = kb * QB + idx % QB;
      xs[idx] = (m < M && k < K) ? to_f(x[(size_t)m * K + k]) : 0.f;
    }
    __syncthreads();
    float part[BM][4];
#pragma unroll
    for (int r = 0; r < BM; ++r)
#pragma unroll
      for (int c = 0; c < 4; ++c) part[r][c] = 0.f;
    const int krow = warp * ROWS;
    const int8_t* qb = q + ((size_t)kb * QB + krow) * N + n0;
    // all of the warp's loads are issued together; the weights stay packed
    // (one register per 4 columns) until their multiply
    char4 w[ROWS];
#pragma unroll
    for (int k = 0; k < ROWS; ++k) {
      const int8_t* qr = qb + (size_t)k * N;
      if (vec4) {
        w[k] = *reinterpret_cast<const char4*>(qr);
      } else {
        w[k].x = n0 < N ? qr[0] : 0;
        w[k].y = n0 + 1 < N ? qr[1] : 0;
        w[k].z = n0 + 2 < N ? qr[2] : 0;
        w[k].w = n0 + 3 < N ? qr[3] : 0;
      }
    }
#pragma unroll
    for (int k = 0; k < ROWS; ++k) {
      const float wf[4] = {static_cast<float>(w[k].x),
                           static_cast<float>(w[k].y),
                           static_cast<float>(w[k].z),
                           static_cast<float>(w[k].w)};
#pragma unroll
      for (int r = 0; r < BM; ++r) {
        const float xv = xs[r * QB + krow + k];
#pragma unroll
        for (int c = 0; c < 4; ++c) part[r][c] = fmaf(xv, wf[c], part[r][c]);
      }
    }
#pragma unroll
    for (int r = 0; r < BM; ++r)
#pragma unroll
      for (int c = 0; c < 4; ++c)
        red[(warp * BM + r) * BN + lane * 4 + c] = part[r][c];
    __syncthreads();
#pragma unroll
    for (int j = 0; j < OUT_PER_T; ++j) {
      const int o = threadIdx.x + j * NT;   // o = r * BN + c
      const int n = col0 + o % BN;
      float blk = 0.f;
#pragma unroll
      for (int v = 0; v < WARPS; ++v) blk += red[v * BM * BN + o];
      const float s = n < N ? scales[(size_t)kb * N + n] : 0.f;
      acc[j] += blk * s;                    // the block's partial, scaled once
    }
    __syncthreads();                        // xs / red reused by the next block
  }

#pragma unroll
  for (int j = 0; j < OUT_PER_T; ++j) {
    const int o = threadIdx.x + j * NT;
    const int m = m0 + o / BN, n = col0 + o % BN;
    if (m >= M || n >= N) continue;
    if (gridDim.z == 1)
      out[(size_t)m * N + n] = from_f<T>(acc[j]);
    else
      partial[((size_t)blockIdx.z * M + m) * N + n] = acc[j];
  }
}

template <typename T>
__global__ void sum_partials_kernel(const float* __restrict__ partial,
                                    T* __restrict__ out, int splits,
                                    size_t mn) {
  const size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= mn) return;
  float sum = 0.f;
  for (int z = 0; z < splits; ++z) sum += partial[z * mn + i];
  out[i] = from_f<T>(sum);
}

template <typename T>
int launch(const void* x, const int8_t* q, const float* scales, void* out,
           float* partial, int M, int K, int N, int nkb, int kb_per_cta,
           cudaStream_t stream) {
  const int splits = (nkb + kb_per_cta - 1) / kb_per_cta;
  dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM, splits);
  quant_matmul_kernel<T><<<grid, NT, 0, stream>>>(
      static_cast<const T*>(x), q, scales, static_cast<T*>(out), partial, M,
      K, N, nkb, kb_per_cta);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess || splits == 1) return static_cast<int>(e);
  const size_t mn = (size_t)M * N;
  const int threads = 256;
  sum_partials_kernel<T><<<(unsigned)((mn + threads - 1) / threads), threads,
                           0, stream>>>(partial, static_cast<T*>(out), splits,
                                        mn);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// x_dtype: 0 = float32, 1 = bfloat16. `partial` is an f32 buffer of
// ceil(nkb / kb_per_cta) * M * N floats, unused (may be null) when that
// count is 1. The scale block must be 256 rows (-2 otherwise). Returns the
// CUDA error of the launches (0 = launched).
int quant_matmul_launch(const void* x, const void* q, const void* scales,
                        void* out, void* partial, int M, int K, int N,
                        int nkb, int block, int kb_per_cta, int x_dtype,
                        void* stream) {
  if (block != QB) return -2;
  const int8_t* qp = static_cast<const int8_t*>(q);
  const float* sp = static_cast<const float*>(scales);
  float* pp = static_cast<float*>(partial);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (x_dtype == 0)
    return launch<float>(x, qp, sp, out, pp, M, K, N, nkb, kb_per_cta, st);
  if (x_dtype == 1)
    return launch<__nv_bfloat16>(x, qp, sp, out, pp, M, K, N, nkb,
                                 kb_per_cta, st);
  return -1;
}

const char* quant_matmul_error_string(int err) {
  return err == -1   ? "unsupported dtype"
         : err == -2 ? "scale block is not 256 rows"
                     : cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"

// Paged-attention decode kernel for Hopper (sm_90a), plain C interface.
//
// Replaces the Pallas kernel deepspeed_tpu/ops/pallas/paged_attention.py
// (_kernel, launched by paged_attention). One decode query per (lane b,
// head h) attends to the K/V rows of its sequence, which live in a pool
// of fixed-size blocks shared by all sequences; the lane's block table
// maps logical block j to a physical pool block.
//
// Any head dim hd % 8 == 0 up to 128; q in f32, bf16 or fp16, the pool in
// q's dtype or int8 with one f32 scale per slot.
//
// Bound: bytes. Each (b, h) reads ctx * hd K and V elements (plus one f32
// scale per row in the int8 tier) and does ~4 flops per element read, far
// below the card's flop/byte balance. The design therefore reads each
// live row exactly once, 16 bytes per thread, with neighbouring threads
// on neighbouring addresses, and touches only the ctx live rows (with a
// sliding window, only the rows inside it).
//
// Layout: one CTA per (h, b) with NTHREADS threads. A row of hd elements
// is split over TPT threads, the power of two at or above hd / VEC (VEC =
// 16 bytes of the pool type, or 8 bytes of an int8 row whose hd is not a
// multiple of 16; threads past the row's last slice load nothing and add
// zeros); the CTA's NTHREADS / TPT thread groups walk the context in
// chunks of TPG tokens per group. Per chunk: (1) each thread reads its tokens'
// block-table entries, then issues all TPG of its K-row loads before
// using any, and the groups write the chunk's scores to shared memory;
// (2) every thread reads them to update the running max m and sum l (the
// same values in the same order, so m and l agree across threads); (3)
// the V rows are loaded the same way and each group accumulates p * v
// into its own f32 slice of the output, rescaled by exp(m_old - m_new).
// At the end the groups' slices are summed through shared memory and
// divided by l. A token's address comes from its own table entry, so a
// chunk may span several pool blocks.
//
// Numerics follow the TPU kernel: f32 scores, softcap before ALiBi,
// masked scores set to -1e30 (not -inf), keep = k_pos <= ctx - 1 and
// (q_abs - k_pos < window or window <= 0), p rounded to the query dtype
// before p * v, int8 rows dequantized with their f32 scale and rounded to
// the query dtype, and a lane with ctx == 0 (or l == 0) writes zeros.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int NTHREADS = 128;
constexpr int TPG = 8;            // tokens per thread group per chunk
constexpr float NEG_INF = -1e30f;

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ float to_f(__half x) { return __half2float(x); }
__device__ __forceinline__ float to_f(int8_t x) { return static_cast<float>(x); }

template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}
template <> __device__ __forceinline__ __half from_f<__half>(float x) {
  return __float2half(x);
}

// threads per pool row: the power of two at or above hd / vec
__host__ __device__ __forceinline__ int row_threads(int hd, int vec) {
  int t = 1;
  while (t * vec < hd) t <<= 1;
  return t;
}

// one thread's VEC pool elements in one load: 16 or 8 bytes
template <int BYTES> struct Raw;
template <> struct Raw<16> { using type = uint4; };
template <> struct Raw<8> { using type = uint2; };

// round an f32 value to T and back (the TPU kernel's casts to q.dtype)
template <typename T> __device__ __forceinline__ float round_to(float x) {
  return to_f(from_f<T>(x));
}

// T: query / output dtype; P: pool dtype (T, or int8 with f32 row scales);
// VEC: pool elements a thread loads at once
template <typename T, typename P, int VEC>
__global__ void __launch_bounds__(NTHREADS)
paged_attention_kernel(const T* __restrict__ q, const P* __restrict__ k_pool,
                       const P* __restrict__ v_pool,
                       const float* __restrict__ k_scale,
                       const float* __restrict__ v_scale,
                       const int* __restrict__ block_tables,
                       const int* __restrict__ context_lens,
                       const float* __restrict__ slopes, T* __restrict__ out,
                       int nh, int nblk, int bs, int hd, int nbk, int layer,
                       int window, float sm_scale, float softcap) {
  using R = typename Raw<VEC * sizeof(P)>::type;
  constexpr bool QUANT = sizeof(P) == 1;
  const int tpt = row_threads(hd, VEC);     // threads per row
  const int ngroups = NTHREADS / tpt;
  const int chunk = ngroups * TPG;          // tokens per chunk
  extern __shared__ float smem[];
  float* s_chunk = smem;                    // [chunk] scores of the chunk
  float* red = smem + chunk;                // [ngroups * hd] final reduction

  const int h = blockIdx.x, b = blockIdx.y, tid = threadIdx.x;
  const int grp = tid / tpt, g = tid % tpt; // token group, slice of hd
  const bool in_row = g * VEC < hd;         // a slice past hd adds zeros
  const int gs = in_row ? g * VEC : 0;      // ... and reads slice 0
  const int ctx = context_lens[b];
  T* o = out + ((size_t)b * nh + h) * hd;

  if (ctx <= 0) {                           // no live key: zeros, not NaN
    for (int d = tid; d < hd; d += NTHREADS) o[d] = from_f<T>(0.f);
    return;
  }
  const int q_abs = ctx - 1;
  const float slope = slopes ? slopes[h] : 0.f;

  float qv[VEC];
  const T* qp = q + ((size_t)b * nh + h) * hd + gs;
#pragma unroll
  for (int i = 0; i < VEC; ++i) qv[i] = in_row ? to_f(qp[i]) : 0.f;

  float acc[VEC];
#pragma unroll
  for (int i = 0; i < VEC; ++i) acc[i] = 0.f;
  float m = NEG_INF, l = 0.f;

  // keys before the window are masked; the TPU kernel's exp(-1e30 - m)
  // wipes their contribution to exactly zero once a live key is seen, so
  // starting at the first key inside the window changes nothing
  const int start = window > 0 ? max(0, q_abs - window + 1) : 0;
  const size_t head_rows = ((size_t)layer * nh + h) * nblk * bs;
  const P* kh = k_pool + head_rows * hd + gs;
  const P* vh = v_pool + head_rows * hd + gs;
  const float* ksh = QUANT ? k_scale + head_rows : nullptr;
  const float* vsh = QUANT ? v_scale + head_rows : nullptr;
  const int* table = block_tables + (size_t)b * nbk;

  for (int c0 = start; c0 < ctx; c0 += chunk) {
    // (1) scores: table entries, then every K-row load, then the math
    size_t row[TPG];                        // slot within this head's pool
#pragma unroll
    for (int i = 0; i < TPG; ++i) {
      const int pos = min(c0 + grp + i * ngroups, q_abs);  // tail: any live
      row[i] = (size_t)table[pos / bs] * bs + pos % bs;
    }
    R raw[TPG];
    float sc[TPG];
#pragma unroll
    for (int i = 0; i < TPG; ++i) {
      raw[i] = *reinterpret_cast<const R*>(kh + row[i] * hd);
      sc[i] = QUANT ? ksh[row[i]] : 1.f;
    }
#pragma unroll
    for (int i = 0; i < TPG; ++i) {
      const P* e = reinterpret_cast<const P*>(&raw[i]);
      float dot = 0.f;
#pragma unroll
      for (int v = 0; v < VEC; ++v) {
        const float kf = QUANT ? round_to<T>(to_f(e[v]) * sc[i]) : to_f(e[v]);
        dot = fmaf(qv[v], kf, dot);
      }
      for (int off = tpt / 2; off > 0; off >>= 1)
        dot += __shfl_xor_sync(0xffffffffu, dot, off);
      if (g == 0) {
        const int k_pos = c0 + grp + i * ngroups;
        float s = dot * sm_scale;
        if (softcap > 0.f) s = tanhf(s / softcap) * softcap;
        if (slopes) s += slope * static_cast<float>(k_pos - q_abs);
        const bool keep = k_pos <= q_abs &&
                          (window <= 0 || q_abs - k_pos < window);
        s_chunk[grp + i * ngroups] = keep ? s : NEG_INF;
      }
    }
    __syncthreads();
    // (2) running max and sum, computed identically by every thread
    const int n = min(chunk, ctx - c0);     // the chunk's tokens below ctx
    float m_new = m;
    for (int t = 0; t < n; ++t) m_new = fmaxf(m_new, s_chunk[t]);
    const float alpha = expf(m - m_new);
    float psum = 0.f;
    for (int t = 0; t < n; ++t) psum += expf(s_chunk[t] - m_new);
    l = l * alpha + psum;
    // (3) rescale, then p * v over this group's tokens
#pragma unroll
    for (int i = 0; i < VEC; ++i) acc[i] *= alpha;
#pragma unroll
    for (int i = 0; i < TPG; ++i) {
      raw[i] = *reinterpret_cast<const R*>(vh + row[i] * hd);
      sc[i] = QUANT ? vsh[row[i]] : 1.f;
    }
#pragma unroll
    for (int i = 0; i < TPG; ++i) {
      const int t = grp + i * ngroups;
      if (t >= n) continue;
      const float p = round_to<T>(expf(s_chunk[t] - m_new));
      const P* e = reinterpret_cast<const P*>(&raw[i]);
#pragma unroll
      for (int v = 0; v < VEC; ++v) {
        const float vf = QUANT ? round_to<T>(to_f(e[v]) * sc[i]) : to_f(e[v]);
        acc[v] = fmaf(p, vf, acc[v]);
      }
    }
    m = m_new;
    __syncthreads();              // s_chunk is rewritten by the next chunk
  }

  if (in_row)
#pragma unroll
    for (int i = 0; i < VEC; ++i) red[grp * hd + gs + i] = acc[i];
  __syncthreads();
  const float inv = 1.f / (l == 0.f ? 1.f : l);
  for (int d = tid; d < hd; d += NTHREADS) {
    float sum = 0.f;
    for (int r = 0; r < ngroups; ++r) sum += red[r * hd + d];
    o[d] = from_f<T>(sum * inv);
  }
}

template <typename T, typename P, int VEC>
int launch_vec(const void* q, const void* k_pool, const void* v_pool,
           const float* k_scale, const float* v_scale, const int* tables,
           const int* lens, const float* slopes, void* out, int B, int nh,
           int nblk, int bs, int hd, int nbk, int layer, int window,
           float sm_scale, float softcap, cudaStream_t stream) {
  const int ngroups = NTHREADS / row_threads(hd, VEC);
  const size_t smem = sizeof(float) * ((size_t)ngroups * TPG +
                                       (size_t)ngroups * hd);
  dim3 grid(nh, B);
  paged_attention_kernel<T, P, VEC><<<grid, NTHREADS, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const P*>(k_pool),
      static_cast<const P*>(v_pool), k_scale, v_scale, tables, lens, slopes,
      static_cast<T*>(out), nh, nblk, bs, hd, nbk, layer, window, sm_scale,
      softcap);
  return static_cast<int>(cudaGetLastError());
}

// 16-byte loads, or 8-byte ones for an int8 row whose hd is not a multiple
// of 16
template <typename T, typename P>
int launch(const void* q, const void* k_pool, const void* v_pool,
           const float* k_scale, const float* v_scale, const int* tables,
           const int* lens, const float* slopes, void* out, int B, int nh,
           int nblk, int bs, int hd, int nbk, int layer, int window,
           float sm_scale, float softcap, cudaStream_t stream) {
  constexpr int VEC = 16 / sizeof(P);
  if constexpr (sizeof(P) == 1)
    if (hd % VEC)
      return launch_vec<T, P, 8>(q, k_pool, v_pool, k_scale, v_scale,
                                 tables, lens, slopes, out, B, nh, nblk, bs,
                                 hd, nbk, layer, window, sm_scale, softcap,
                                 stream);
  return launch_vec<T, P, VEC>(q, k_pool, v_pool, k_scale, v_scale, tables,
                               lens, slopes, out, B, nh, nblk, bs, hd, nbk,
                               layer, window, sm_scale, softcap, stream);
}

}  // namespace

extern "C" {

// q_dtype: 0 = float32, 1 = bfloat16, 2 = float16. pool_dtype: the same
// codes for a pool of q's dtype, 3 = int8 (with k_scale / v_scale). hd: a
// multiple of 8 up to 128. Returns the CUDA error of the launch (0 =
// launched); -1 for a combination the kernel lacks.
int paged_attention_launch(const void* q, const void* k_pool,
                           const void* v_pool, const void* k_scale,
                           const void* v_scale, const void* block_tables,
                           const void* context_lens, const void* slopes,
                           void* out, int B, int nh, int nblk, int bs, int hd,
                           int nbk, int layer, int window, float sm_scale,
                           float softcap, int q_dtype, int pool_dtype,
                           void* stream) {
  const float* ks = static_cast<const float*>(k_scale);
  const float* vs = static_cast<const float*>(v_scale);
  const int* bt = static_cast<const int*>(block_tables);
  const int* ln = static_cast<const int*>(context_lens);
  const float* sl = static_cast<const float*>(slopes);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define PA_ARGS q, k_pool, v_pool, ks, vs, bt, ln, sl, out, B, nh, nblk, bs, \
                hd, nbk, layer, window, sm_scale, softcap, st
  if (hd < 8 || hd > 128 || hd % 8) return -1;
  if (pool_dtype == 3) {
    if (q_dtype == 0) return launch<float, int8_t>(PA_ARGS);
    if (q_dtype == 1) return launch<__nv_bfloat16, int8_t>(PA_ARGS);
    if (q_dtype == 2) return launch<__half, int8_t>(PA_ARGS);
  } else if (pool_dtype == q_dtype) {
    if (q_dtype == 0) return launch<float, float>(PA_ARGS);
    if (q_dtype == 1) return launch<__nv_bfloat16, __nv_bfloat16>(PA_ARGS);
    if (q_dtype == 2) return launch<__half, __half>(PA_ARGS);
  }
#undef PA_ARGS
  return -1;
}

const char* paged_attention_error_string(int err) {
  return err < 0 ? "unsupported dtype combination or head dim"
                 : cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"

// Helpers shared by the single-query decode kernels of decode_attention.cu
// (a dense cache) and paged_attention.cu (a block-table pool), and their
// kernel for head dims above 256 (row_wide).
//
// row_wide keeps registers and shared memory bounded whatever the head dim
// is: the grid is (h * ncol + column chunk, b), each CTA writing CW = 256
// columns of the output. A row is walked in slices of 8 elements a lane
// (16 bytes of bf16 / fp16, 32 of f32, 8 of int8), a warp covering 256
// columns at a time; each warp takes one key at a time, TPG keys a chunk.
// The score of a key sums over every 256-column piece of the row (the
// query's piece is read from device memory again for each, an L1 hit); the
// values of only the CTA's own columns are read. So each CTA reads all of
// K and its share of V: K is read ncol times, the cost of the wide path.
// Numerics are the narrow kernels': f32 scores, softcap before ALiBi, the
// window and causal masks at -1e30 with p exactly 0, p rounded to the
// query dtype before p * v, int8 rows dequantized with their f32 scale and
// rounded to the query dtype, zeros where l == 0.

#pragma once

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace drow {

constexpr int NT = 128;           // threads a CTA
constexpr int NWARPS = NT / 32;
constexpr float NEG_INF = -1e30f;
constexpr unsigned FULL = 0xffffffffu;

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

// round an f32 value to T and back (the TPU kernels' casts to q.dtype)
template <typename T> __device__ __forceinline__ float round_to(float x) {
  return to_f(from_f<T>(x));
}

// BYTES of one row slice, loaded at once
template <int BYTES> struct alignas(16) Slice { uint4 w[BYTES / 16]; };
template <> struct alignas(8) Slice<8> { uint2 w; };

// softcap and ALiBi on one scaled score (the TPU kernels' order)
__device__ __forceinline__ float cap_bias(float s, int k_pos, int q_abs,
                                          float softcap, bool alibi,
                                          float slope) {
  if (softcap > 0.f) s = tanhf(s / softcap) * softcap;
  if (alibi) s += slope * static_cast<float>(k_pos - q_abs);
  return s;
}

// the sum over each group of tpt neighbouring lanes (groups of a warp,
// any size up to 32; lanes past the warp's last whole group are idle but
// take part in the shuffles); every lane of a group gets its sum
__device__ __forceinline__ float group_sum(float v, int tpt, int g,
                                           int lane) {
  if ((tpt & (tpt - 1)) == 0) {             // a power of two: butterfly
    for (int off = tpt / 2; off > 0; off >>= 1)
      v += __shfl_xor_sync(FULL, v, off);
    return v;
  }
  // a tree onto the group's first lane (i adds i + off while inside the
  // group), then a broadcast from it
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    const float t = __shfl_down_sync(FULL, v, off);
    if (g + off < tpt) v += t;
  }
  return __shfl_sync(FULL, v, lane - g);
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    v = fmaxf(v, __shfl_xor_sync(FULL, v, off));
  return v;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(FULL, v, off);
  return v;
}

// ------------------------------------------------------ head dims > 256

constexpr int CW = 256;           // output columns a CTA
constexpr int WV = 8;             // elements a lane loads at once
constexpr int WTPG = 4;           // keys a warp takes a chunk

// The address of a row, for row_wide. Dense: the (b, h) rows of a cache
// [L, B, nh, max_len, hd] at one layer; live length cur_len, one query at
// position cur_len - 1.
template <typename T>
struct DenseRows {
  const T* q;
  const T* k;
  const T* v;
  const float* slopes;
  T* out;
  int B, nh, max_len, hd, layer, cur_len, window;
  float sm_scale, softcap;
  __device__ int ctx(int) const { return cur_len; }
  __device__ size_t base(int b, int h) const {
    return (((size_t)layer * B + b) * nh + h) * max_len;
  }
  // row index of position pos of (b, h), from base(b, h)
  __device__ size_t row(size_t base, int, int pos) const {
    return base + pos;
  }
  __device__ float kscale(size_t) const { return 1.f; }
  __device__ float vscale(size_t) const { return 1.f; }
};

// T: query / output dtype; P: cache dtype (T, or int8 with f32 row scales,
// A::QUANT)
template <typename T, typename P, typename A>
__global__ void __launch_bounds__(NT) row_wide(const A a) {
  using S = Slice<WV * sizeof(P)>;          // a cache slice
  using SQ = Slice<WV * sizeof(T)>;         // a query slice
  constexpr int CHUNK = NWARPS * WTPG;      // keys a chunk
  __shared__ float red_m[NWARPS], red_l[NWARPS];
  __shared__ float red[NWARPS][CW];
  const int ncol = (a.hd + CW - 1) / CW;
  const int h = blockIdx.x / ncol, cc = blockIdx.x % ncol, b = blockIdx.y;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int hd = a.hd, c0 = cc * CW + lane * WV;
  const bool own = c0 < hd;                 // the lane's slice of the CTA's columns
  const int ctx = max(a.ctx(b), 0);
  const int q_abs = ctx - 1;
  const float slope = a.slopes ? a.slopes[h] : 0.f;
  const int start = a.window > 0 ? max(0, q_abs - a.window + 1) : 0;
  const size_t base = a.base(b, h);
  const T* qp = a.q + ((size_t)b * a.nh + h) * hd;

  float acc[WV];
#pragma unroll
  for (int i = 0; i < WV; ++i) acc[i] = 0.f;
  float m = NEG_INF, l = 0.f;
  for (int t0 = start; t0 < ctx; t0 += CHUNK) {
    size_t row[WTPG];
    float s[WTPG];
#pragma unroll
    for (int i = 0; i < WTPG; ++i) {
      row[i] = a.row(base, b, min(t0 + warp + i * NWARPS, ctx - 1));
      s[i] = 0.f;
    }
    // the scores: every 256-column piece of the row
    for (int d0 = lane * WV; d0 < hd; d0 += CW) {
      const SQ qs = *reinterpret_cast<const SQ*>(qp + d0);
      const T* qe = reinterpret_cast<const T*>(&qs);
      S ks[WTPG];
#pragma unroll
      for (int i = 0; i < WTPG; ++i)
        ks[i] = *reinterpret_cast<const S*>(a.k + row[i] * hd + d0);
#pragma unroll
      for (int i = 0; i < WTPG; ++i) {
        const P* e = reinterpret_cast<const P*>(&ks[i]);
        const float sc = a.kscale(row[i]);
#pragma unroll
        for (int j = 0; j < WV; ++j) {
          const float kf = sizeof(P) == 1 ? round_to<T>(to_f(e[j]) * sc)
                                          : to_f(e[j]);
          s[i] = fmaf(to_f(qe[j]), kf, s[i]);
        }
      }
    }
    float mx = NEG_INF;
#pragma unroll
    for (int i = 0; i < WTPG; ++i) {
      const int k_pos = t0 + warp + i * NWARPS;
      const float x = cap_bias(warp_sum(s[i]) * a.sm_scale, k_pos, q_abs,
                               a.softcap, a.slopes != nullptr, slope);
      s[i] = k_pos < ctx ? x : NEG_INF;
      mx = fmaxf(mx, s[i]);
    }
    if (lane == 0) red_m[warp] = mx;
    __syncthreads();
#pragma unroll
    for (int w = 0; w < NWARPS; ++w) mx = fmaxf(mx, red_m[w]);
    mx = fmaxf(mx, m);
    const float alpha = expf(m - mx);
    m = mx;
    float ps = 0.f;
#pragma unroll
    for (int i = 0; i < WTPG; ++i) {
      s[i] = s[i] > 0.5f * NEG_INF ? expf(s[i] - mx) : 0.f;
      ps += s[i];
    }
    if (lane == 0) red_l[warp] = ps;
    S vs[WTPG];
#pragma unroll
    for (int i = 0; i < WTPG; ++i)
      if (own) vs[i] = *reinterpret_cast<const S*>(a.v + row[i] * hd + c0);
    __syncthreads();
    ps = 0.f;
#pragma unroll
    for (int w = 0; w < NWARPS; ++w) ps += red_l[w];
    l = l * alpha + ps;
#pragma unroll
    for (int j = 0; j < WV; ++j) acc[j] *= alpha;
    if (own)
#pragma unroll
      for (int i = 0; i < WTPG; ++i) {
        if (s[i] == 0.f) continue;
        const float p = round_to<T>(s[i]);
        const P* e = reinterpret_cast<const P*>(&vs[i]);
        const float sc = a.vscale(row[i]);
#pragma unroll
        for (int j = 0; j < WV; ++j) {
          const float vf = sizeof(P) == 1 ? round_to<T>(to_f(e[j]) * sc)
                                          : to_f(e[j]);
          acc[j] = fmaf(p, vf, acc[j]);
        }
      }
    __syncthreads();                        // red_m / red_l are rewritten
  }
  // the warps' slices summed and normalized
#pragma unroll
  for (int j = 0; j < WV; ++j) red[warp][lane * WV + j] = acc[j];
  __syncthreads();
  const float inv = 1.f / (l == 0.f ? 1.f : l);
  T* o = a.out + ((size_t)b * a.nh + h) * hd + cc * CW;
  for (int d = tid; d < CW && cc * CW + d < hd; d += NT) {
    float sum = 0.f;
#pragma unroll
    for (int w = 0; w < NWARPS; ++w) sum += red[w][d];
    o[d] = from_f<T>(sum * inv);
  }
}

template <typename T, typename P, typename A>
int launch_wide(const A& a, int B, cudaStream_t stream) {
  const int ncol = (a.hd + CW - 1) / CW;
  row_wide<T, P, A><<<dim3(a.nh * ncol, B), NT, 0, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace drow

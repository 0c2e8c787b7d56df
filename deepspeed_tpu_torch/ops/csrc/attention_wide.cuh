// Head dims above 256 for the mma.sync and f32 attention kernels of
// flash_attention_fwd.cu, flash_attention_bwd.cu and
// block_sparse_attention.cu: one forward, one dQ and one dK/dV kernel,
// templated on the element type and on the caller's schedule and masks (a
// policy, below), for any D % 8 == 0.
//
// Shared memory and registers stay bounded whatever D is:
// * the scores S = Q K^T (and dP = dO V^T) accumulate over D in chunks of
//   CK = 64 columns: each chunk of the CTA's 64 own rows and of the visited
//   tile's rows is copied to shared memory by cp.async, multiplied into the
//   f32 score fragments and overwritten by the next chunk;
// * the outputs' columns (O, dQ, dK and dV) are split over CTAs in chunks
//   of CW = 128 (blockIdx.z), each CTA recomputing the scores of every tile
//   it visits: ceil(D / 128) times the score products of one pass, the
//   cost of the wide path (PERF.md).
// Products: bf16 / fp16 on mma.sync.m16n8k16 (operands by ldmatrix); f32
// on CUDA cores in the same fragment layout (lane l holds rows l / 4 and
// l / 4 + 8, columns 2 (l % 4) + {0, 1} of every 8-column tile), so the
// masks, the softmax and the epilogues are one code for the three types.
// The numerics are the narrow kernels': f32 scores times sm_scale, the
// caller's masks at -1e30 with p exactly 0, p (and dS) rounded to the
// element type before the products, a row without a live key writes zeros.
//
// A policy Pol (a struct of static device functions over the caller's
// parameter struct Pol::Prm) gives, for QMAJOR = true (own query tiles: the
// forward, dQ) or false (own key tiles: dK/dV):
//   own<QMAJOR>(p, bh, rank)            the own 64-row tile of grid row rank
//   list<QMAJOR>(p, bh, t, &e0, &e1)    the visited 64-row tiles' entries
//   other<QMAJOR>(p, bh, t, e)          entry e's first row
//   scores<QMAJOR, NJ>(p, bh, t, e, s, ds, a0, a1, b0, cq)
//       the masks (and softcap, ALiBi) on the scaled score fragments s of
//       rows a0 / a1 and columns b0 + 8 j + cq + {0, 1} (rows are queries
//       when QMAJOR, else keys); ds gets each entry's softcap derivative
//       and is left at 1 where there is none.

#pragma once

#include "attention_tile.cuh"

#include <type_traits>

namespace wide {

using namespace tile;

constexpr float NEG_INF = -1e30f;
constexpr float LOG2E = 1.4426950408889634f;
constexpr int NT = 128;           // 4 warps x 16 own rows
constexpr int R = 64;             // own rows a CTA
constexpr int CK = 64;            // columns of D a score chunk
constexpr int CW = 128;           // output columns a CTA
constexpr int BQ = 32;            // query rows a dK/dV step

// head dims above this take these kernels
constexpr int FROM_DIM = 256;

template <typename E> __host__ __device__ constexpr bool is_f32() {
  return std::is_same<E, float>::value;
}

// row strides in shared memory: a 16-byte pad a row
template <typename E> struct Ld {
  static constexpr int PAD = 16 / sizeof(E);
  static constexpr int K = CK + PAD;      // a score chunk
  static constexpr int C = CW + PAD;      // an output-column tile
  static constexpr int X = 64 + 4;        // f32: a warp's staged P or dS
};

// What every wide kernel reads besides its policy's parameters
struct Args {
  const void* q;
  const void* k;
  const void* v;
  const void* dout;
  const float* lse;               // the backward's input
  const float* delta;
  void* o;                        // the forward's output, or dq
  float* lse_out;                 // the forward's
  void* dk;
  void* dv;
  size_t kv_head;                 // elements between the (b, h) heads of k and v
  int Sq, Sk, D;
  float sm_scale;
};

// ROWS rows (from r0) of [n, D] matrix src, columns [c0, c0 + W), into dst
// (row stride LD) by cp.async; zeros past n and D. The caller commits.
template <typename E, int ROWS, int W, int LD>
__device__ __forceinline__ void load(E* dst, const E* src, int r0, int n,
                                     int c0, int D, int tid) {
  constexpr int V = 16 / sizeof(E);
  for (int idx = tid; idx < ROWS * W / V; idx += NT) {
    const int rr = idx / (W / V), c = (idx % (W / V)) * V;
    const int row = r0 + rr, col = c0 + c;
    const bool live = row < n && col < D;
    cp_async16(dst + rr * LD + c, live ? src + (size_t)row * D + col : src,
               live ? 16 : 0);
  }
}

__device__ __forceinline__ void landed() {
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();
}

// acc (the warp's 16 x N) += A (the warp's 16 of the 64 rows at As) times
// the transpose of the N rows at Bs, over CK columns
template <typename E, int N>
__device__ __forceinline__ void abt(float (*acc)[4], const E* As,
                                    const E* Bs, int warp, int lane) {
  constexpr int LD = Ld<E>::K;
  if constexpr (is_f32<E>()) {
    const int cq = (lane % 4) * 2;
    const float* a0 = As + (warp * 16 + lane / 4) * LD;
    const float* a1 = a0 + 8 * LD;
#pragma unroll 4
    for (int k = 0; k < CK; k += 4) {
      const float4 x0 = *reinterpret_cast<const float4*>(a0 + k);
      const float4 x1 = *reinterpret_cast<const float4*>(a1 + k);
#pragma unroll
      for (int j = 0; j < N / 8; ++j)
#pragma unroll
        for (int cc = 0; cc < 2; ++cc) {
          const float4 b =
              *reinterpret_cast<const float4*>(Bs + (j * 8 + cq + cc) * LD + k);
          acc[j][cc] += x0.x * b.x + x0.y * b.y + x0.z * b.z + x0.w * b.w;
          acc[j][2 + cc] += x1.x * b.x + x1.y * b.y + x1.z * b.z + x1.w * b.w;
        }
    }
  } else {
    const E* ar = As + (warp * 16 + (lane & 15)) * LD + (lane >> 4) * 8;
#pragma unroll
    for (int kk = 0; kk < CK / 16; kk += 2) {
      uint32_t a0[4], a1[4];
      ldsm_x4(a0, ar + kk * 16);
      ldsm_x4(a1, ar + kk * 16 + 16);
#pragma unroll
      for (int j = 0; j < N / 8; ++j) {
        uint32_t b[4];
        ldsm_x4(b, Bs + (j * 8 + (lane & 7)) * LD + (lane >> 3) * 8 + kk * 16);
        mma<E>(acc[j], a0, b[0], b[1]);
        mma<E>(acc[j], a1, b[2], b[3]);
      }
    }
  }
}

// out (the warp's 16 x CW) += X (16 x N, fragments; rounded to E for the
// 16-bit types) times the N x CW rows at Cs. f32: X goes through the
// warp's stage xs, so each lane reads whole rows of it.
template <typename E, int N>
__device__ __forceinline__ void ab(float (*out)[4], const float (*x)[4],
                                   const E* Cs, float* xs, int lane) {
  constexpr int LC = Ld<E>::C;
  if constexpr (is_f32<E>()) {
    constexpr int LX = Ld<E>::X;
    const int r = lane / 4, cq = (lane % 4) * 2;
    __syncwarp();                           // the last use of xs is done
#pragma unroll
    for (int j = 0; j < N / 8; ++j) {
      *reinterpret_cast<float2*>(xs + r * LX + j * 8 + cq) =
          make_float2(x[j][0], x[j][1]);
      *reinterpret_cast<float2*>(xs + (r + 8) * LX + j * 8 + cq) =
          make_float2(x[j][2], x[j][3]);
    }
    __syncwarp();
#pragma unroll 2
    for (int k = 0; k < N; ++k) {
      const float x0 = xs[r * LX + k], x1 = xs[(r + 8) * LX + k];
#pragma unroll
      for (int n = 0; n < CW / 8; ++n) {
        const float2 b = *reinterpret_cast<const float2*>(Cs + k * LC + n * 8 + cq);
        out[n][0] = fmaf(x0, b.x, out[n][0]);
        out[n][1] = fmaf(x0, b.y, out[n][1]);
        out[n][2] = fmaf(x1, b.x, out[n][2]);
        out[n][3] = fmaf(x1, b.y, out[n][3]);
      }
    }
  } else {
    mma_ab<E, CW, N, LC>(out, x, Cs, lane);
  }
}

// rows r0 / r1 of the warp's 16 x CW accumulator, times s0 / s1, into
// columns [c0, c0 + CW) of [n, D] rows; nothing past n or D
template <typename E>
__device__ __forceinline__ void store(E* base, const float (*acc)[4], int r0,
                                      int r1, int n, int D, int cq, float s0,
                                      float s1, int c0) {
#pragma unroll
  for (int rr = 0; rr < 2; ++rr) {
    const int row = rr ? r1 : r0;
    const float s = rr ? s1 : s0;
    if (row >= n) continue;
    E* out = base + (size_t)row * D + c0 + cq;
#pragma unroll
    for (int c = 0; c < CW / 8; ++c) {
      if (c0 + c * 8 + cq >= D) continue;
      const float x = acc[c][2 * rr] * s, y = acc[c][2 * rr + 1] * s;
      if constexpr (is_f32<E>())
        *reinterpret_cast<float2*>(out + c * 8) = make_float2(x, y);
      else
        *reinterpret_cast<uint32_t*>(out + c * 8) = pack<E>(x, y);
    }
  }
}

template <int NJ>
__device__ __forceinline__ void fill(float (*a)[4], float x) {
#pragma unroll
  for (int j = 0; j < NJ; ++j) a[j][0] = a[j][1] = a[j][2] = a[j][3] = x;
}

// p from the saved logsumexp; a masked entry is exactly 0
__device__ __forceinline__ float prob(float s, float lse) {
  return s > 0.5f * NEG_INF ? exp2f((s - lse) * LOG2E) : 0.f;
}

// dynamic shared memory: `chunks` score chunks of 64 rows, `tiles`
// output-column tiles of `rows` rows, and the f32 stages
template <typename E>
constexpr size_t smem_bytes(int chunks, int tiles, int rows) {
  return sizeof(E) * ((size_t)chunks * R * Ld<E>::K +
                      (size_t)tiles * rows * Ld<E>::C) +
         (is_f32<E>() ? sizeof(float) * 4 * 16 * Ld<E>::X : 0);
}

// ---------------------------------------------------------------- forward

template <typename E, typename Pol>
__global__ void __launch_bounds__(NT)
wide_fwd(const Args w, const typename Pol::Prm p) {
  constexpr int LK = Ld<E>::K, NJ = R / 8;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  E* As = reinterpret_cast<E*>(smem_raw);   // Q chunk
  E* Bs = As + R * LK;                      // K chunk
  E* Cs = Bs + R * LK;                      // V columns
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  float* xs = reinterpret_cast<float*>(Cs + R * Ld<E>::C) + warp * 16 * Ld<E>::X;
  const int bh = blockIdx.x, t = Pol::template own<true>(p, bh, blockIdx.y);
  const int c0 = blockIdx.z * CW, D = w.D;
  const int r0 = t * R + warp * 16 + lane / 4, r1 = r0 + 8;
  const int cq = (lane % 4) * 2;
  const E* qb = static_cast<const E*>(w.q) + (size_t)bh * w.Sq * D;
  const E* kb = static_cast<const E*>(w.k) + bh * w.kv_head;
  const E* vb = static_cast<const E*>(w.v) + bh * w.kv_head;

  float of[CW / 8][4];
  fill<CW / 8>(of, 0.f);
  float m[2] = {NEG_INF, NEG_INF}, l[2] = {0.f, 0.f};   // l: this thread's part
  int e0, e1;
  Pol::template list<true>(p, bh, t, &e0, &e1);
  for (int e = e0; e < e1; ++e) {
    const int k0 = Pol::template other<true>(p, bh, t, e);
    float sf[NJ][4], ds[NJ][4];
    fill<NJ>(sf, 0.f);
    for (int d0 = 0; d0 < D; d0 += CK) {
      __syncthreads();                      // the last chunk is read
      load<E, R, CK, LK>(As, qb, t * R, w.Sq, d0, D, tid);
      load<E, R, CK, LK>(Bs, kb, k0, w.Sk, d0, D, tid);
      landed();
      abt<E, R>(sf, As, Bs, warp, lane);    // S += Q K^T over the chunk
    }
#pragma unroll
    for (int j = 0; j < NJ; ++j)
#pragma unroll
      for (int c = 0; c < 4; ++c) sf[j][c] *= w.sm_scale;
    Pol::template scores<true, NJ>(p, bh, t, e, sf, ds, r0, r1, k0, cq);
    // online softmax for the thread's two rows (a row spans a lane quad);
    // the rescale takes the difference first, so m == mx == -1e30 (no live
    // key yet) gives exactly 1
#pragma unroll
    for (int rr = 0; rr < 2; ++rr) {
      float mx = m[rr];
#pragma unroll
      for (int j = 0; j < NJ; ++j)
        mx = fmaxf(mx, fmaxf(sf[j][2 * rr], sf[j][2 * rr + 1]));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      const float mxl = mx * LOG2E;
      const float alpha = exp2f((m[rr] - mx) * LOG2E);
      float ps = 0.f;
#pragma unroll
      for (int j = 0; j < NJ; ++j)
#pragma unroll
        for (int c = 2 * rr; c < 2 * rr + 2; ++c) {
          const float pe = sf[j][c] > 0.5f * NEG_INF
                               ? exp2f(fmaf(sf[j][c], LOG2E, -mxl)) : 0.f;
          sf[j][c] = pe;
          ps += pe;
        }
      l[rr] = l[rr] * alpha + ps;
      m[rr] = mx;
#pragma unroll
      for (int n = 0; n < CW / 8; ++n) {
        of[n][2 * rr] *= alpha;
        of[n][2 * rr + 1] *= alpha;
      }
    }
    __syncthreads();
    load<E, R, CW, Ld<E>::C>(Cs, vb, k0, w.Sk, c0, D, tid);
    landed();
    ab<E, R>(of, sf, Cs, xs, lane);         // O += P V, this CTA's columns
  }

  float inv[2];
#pragma unroll
  for (int rr = 0; rr < 2; ++rr) {
    float lt = l[rr];
    lt += __shfl_xor_sync(0xffffffffu, lt, 1);
    lt += __shfl_xor_sync(0xffffffffu, lt, 2);
    inv[rr] = 1.f / (lt == 0.f ? 1.f : lt);  // a dead row writes zeros
    const int row = rr ? r1 : r0;
    if (w.lse_out && blockIdx.z == 0 && row < w.Sq && lane % 4 == 0)
      w.lse_out[(size_t)bh * w.Sq + row] = m[rr] + logf(fmaxf(lt, 1e-37f));
  }
  store<E>(static_cast<E*>(w.o) + (size_t)bh * w.Sq * D, of, r0, r1, w.Sq,
           D, cq, inv[0], inv[1], c0);
}

// -------------------------------------------------------------------- dQ

template <typename E, typename Pol>
__global__ void __launch_bounds__(NT)
wide_dq(const Args w, const typename Pol::Prm p) {
  constexpr int LK = Ld<E>::K, NJ = R / 8;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  E* Qs = reinterpret_cast<E*>(smem_raw);   // Q, K, dO and V chunks
  E* Ks = Qs + R * LK;
  E* Ds = Ks + R * LK;
  E* Vs = Ds + R * LK;
  E* Cs = Vs + R * LK;                      // K columns
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  float* xs = reinterpret_cast<float*>(Cs + R * Ld<E>::C) + warp * 16 * Ld<E>::X;
  const int bh = blockIdx.x, t = Pol::template own<true>(p, bh, blockIdx.y);
  const int c0 = blockIdx.z * CW, D = w.D;
  const int r0 = t * R + warp * 16 + lane / 4, r1 = r0 + 8;
  const int cq = (lane % 4) * 2;
  const size_t qo = (size_t)bh * w.Sq, ko = (size_t)bh * w.Sk;
  const E* qb = static_cast<const E*>(w.q) + qo * D;
  const E* db = static_cast<const E*>(w.dout) + qo * D;
  const E* kb = static_cast<const E*>(w.k) + bh * w.kv_head;
  const E* vb = static_cast<const E*>(w.v) + bh * w.kv_head;
  float lse[2], dlt[2];
  lse[0] = r0 < w.Sq ? w.lse[qo + r0] : 0.f;
  lse[1] = r1 < w.Sq ? w.lse[qo + r1] : 0.f;
  dlt[0] = r0 < w.Sq ? w.delta[qo + r0] : 0.f;
  dlt[1] = r1 < w.Sq ? w.delta[qo + r1] : 0.f;

  float acc[CW / 8][4];
  fill<CW / 8>(acc, 0.f);
  int e0, e1;
  Pol::template list<true>(p, bh, t, &e0, &e1);
  for (int e = e0; e < e1; ++e) {
    const int k0 = Pol::template other<true>(p, bh, t, e);
    float sf[NJ][4], dp[NJ][4], ds[NJ][4];
    fill<NJ>(sf, 0.f);
    fill<NJ>(dp, 0.f);
    fill<NJ>(ds, 1.f);
    for (int d0 = 0; d0 < D; d0 += CK) {
      __syncthreads();
      load<E, R, CK, LK>(Qs, qb, t * R, w.Sq, d0, D, tid);
      load<E, R, CK, LK>(Ks, kb, k0, w.Sk, d0, D, tid);
      load<E, R, CK, LK>(Ds, db, t * R, w.Sq, d0, D, tid);
      load<E, R, CK, LK>(Vs, vb, k0, w.Sk, d0, D, tid);
      landed();
      abt<E, R>(sf, Qs, Ks, warp, lane);    // S += Q K^T
      abt<E, R>(dp, Ds, Vs, warp, lane);    // dP += dO V^T
    }
#pragma unroll
    for (int j = 0; j < NJ; ++j)
#pragma unroll
      for (int c = 0; c < 4; ++c) sf[j][c] *= w.sm_scale;
    Pol::template scores<true, NJ>(p, bh, t, e, sf, ds, r0, r1, k0, cq);
#pragma unroll
    for (int j = 0; j < NJ; ++j)
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int rr = c >> 1;
        sf[j][c] = prob(sf[j][c], lse[rr]) * (dp[j][c] - dlt[rr]) *
                   ds[j][c] * w.sm_scale;   // dS
      }
    __syncthreads();
    load<E, R, CW, Ld<E>::C>(Cs, kb, k0, w.Sk, c0, D, tid);
    landed();
    ab<E, R>(acc, sf, Cs, xs, lane);        // dQ += dS K
  }
  store<E>(static_cast<E*>(w.o) + qo * D, acc, r0, r1, w.Sq, D, cq, 1.f, 1.f,
           c0);
}

// ----------------------------------------------------------------- dK, dV

// the own rows are keys: S^T = K Q^T and dP^T = V dO^T come out with the
// queries as columns, so P^T and dS^T are A operands of dV and dK. Each
// listed 64-row query tile is taken in steps of BQ rows.
template <typename E, typename Pol>
__global__ void __launch_bounds__(NT)
wide_dkv(const Args w, const typename Pol::Prm p) {
  constexpr int LK = Ld<E>::K, LC = Ld<E>::C, NJ = BQ / 8;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  E* Ks = reinterpret_cast<E*>(smem_raw);   // K, Q, V and dO chunks
  E* Qs = Ks + R * LK;
  E* Vs = Qs + R * LK;
  E* Ds = Vs + R * LK;
  E* Dc = Ds + R * LK;                      // dO and Q columns
  E* Qc = Dc + BQ * LC;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  float* xs = reinterpret_cast<float*>(Qc + BQ * LC) + warp * 16 * Ld<E>::X;
  const int bh = blockIdx.x, t = Pol::template own<false>(p, bh, blockIdx.y);
  const int c0 = blockIdx.z * CW, D = w.D;
  const int r0 = t * R + warp * 16 + lane / 4, r1 = r0 + 8;   // keys
  const int cq = (lane % 4) * 2;
  const size_t qo = (size_t)bh * w.Sq, ko = (size_t)bh * w.Sk;
  const E* qb = static_cast<const E*>(w.q) + qo * D;
  const E* db = static_cast<const E*>(w.dout) + qo * D;
  const E* kb = static_cast<const E*>(w.k) + bh * w.kv_head;
  const E* vb = static_cast<const E*>(w.v) + bh * w.kv_head;

  float dk[CW / 8][4], dv[CW / 8][4];
  fill<CW / 8>(dk, 0.f);
  fill<CW / 8>(dv, 0.f);
  int e0, e1;
  Pol::template list<false>(p, bh, t, &e0, &e1);
  for (int e = e0; e < e1; ++e)
    for (int sub = 0; sub < R / BQ; ++sub) {
      const int q0 = Pol::template other<false>(p, bh, t, e) + sub * BQ;
      float st[NJ][4], dpt[NJ][4], ds[NJ][4];
      fill<NJ>(st, 0.f);
      fill<NJ>(dpt, 0.f);
      fill<NJ>(ds, 1.f);
      for (int d0 = 0; d0 < D; d0 += CK) {
        __syncthreads();
        load<E, R, CK, LK>(Ks, kb, t * R, w.Sk, d0, D, tid);
        load<E, BQ, CK, LK>(Qs, qb, q0, w.Sq, d0, D, tid);
        load<E, R, CK, LK>(Vs, vb, t * R, w.Sk, d0, D, tid);
        load<E, BQ, CK, LK>(Ds, db, q0, w.Sq, d0, D, tid);
        landed();
        abt<E, BQ>(st, Ks, Qs, warp, lane);   // S^T += K Q^T
        abt<E, BQ>(dpt, Vs, Ds, warp, lane);  // dP^T += V dO^T
      }
#pragma unroll
      for (int j = 0; j < NJ; ++j)
#pragma unroll
        for (int c = 0; c < 4; ++c) st[j][c] *= w.sm_scale;
      Pol::template scores<false, NJ>(p, bh, t, e, st, ds, r0, r1, q0, cq);
#pragma unroll
      for (int j = 0; j < NJ; ++j)
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          const int qi = q0 + j * 8 + cq + (c & 1);
          const bool in = qi < w.Sq;
          const float pr = prob(st[j][c], in ? w.lse[qo + qi] : 0.f);
          st[j][c] = pr;                                    // P^T
          dpt[j][c] = pr * (dpt[j][c] - (in ? w.delta[qo + qi] : 0.f)) *
                      ds[j][c] * w.sm_scale;                // dS^T
        }
      __syncthreads();
      load<E, BQ, CW, LC>(Dc, db, q0, w.Sq, c0, D, tid);
      load<E, BQ, CW, LC>(Qc, qb, q0, w.Sq, c0, D, tid);
      landed();
      ab<E, BQ>(dv, st, Dc, xs, lane);      // dV += P^T dO
      ab<E, BQ>(dk, dpt, Qc, xs, lane);     // dK += dS^T Q
    }
  store<E>(static_cast<E*>(w.dk) + ko * D, dk, r0, r1, w.Sk, D, cq, 1.f, 1.f,
           c0);
  store<E>(static_cast<E*>(w.dv) + ko * D, dv, r0, r1, w.Sk, D, cq, 1.f, 1.f,
           c0);
}

// ----------------------------------------------------------------- launch

// grid (b*h, own tiles, output-column chunks); dtype 0 f32, 1 bf16, 2 fp16.
// WHICH: 0 the forward, 1 dQ, 2 dK/dV (only the kernels a file launches
// are compiled)
template <int WHICH, typename E, typename Pol> auto kernel_of() {
  if constexpr (WHICH == 0) return wide_fwd<E, Pol>;
  else if constexpr (WHICH == 1) return wide_dq<E, Pol>;
  else return wide_dkv<E, Pol>;
}

template <int WHICH, typename Pol>
int launch(const Args& w, const typename Pol::Prm& p, int BH, int tiles,
           int dtype, cudaStream_t stream) {
  auto go = [&](auto e) -> int {
    using E = decltype(e);
    auto kernel = kernel_of<WHICH, E, Pol>();
    const size_t smem = WHICH == 0 ? smem_bytes<E>(2, 1, R)
                        : WHICH == 1 ? smem_bytes<E>(4, 1, R)
                                     : smem_bytes<E>(4, 2, BQ);
    if (smem > 48 * 1024) {                 // above 48 KB only by opt-in
      const cudaError_t err = cudaFuncSetAttribute(
          kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
          static_cast<int>(smem));
      if (err != cudaSuccess) return static_cast<int>(err);
    }
    kernel<<<dim3(BH, tiles, (w.D + CW - 1) / CW), NT, smem, stream>>>(w, p);
    return static_cast<int>(cudaGetLastError());
  };
  if (dtype == 0) return go(float());
  if (dtype == 1) return go(bf16());
  return go(f16());
}

}  // namespace wide

// Flash attention backward (FlashAttention-2 schedule) for Hopper (sm_90a),
// plain C interface: two kernels.
//
// Replaces the backward Pallas kernels of
// deepspeed_tpu/ops/pallas/flash_attention.py: _bwd_dq_kernel (launched by
// _bwd at :402) and _bwd_dkv_kernel (:421). Inputs q, dO [B*H, S, D],
// k, v [B*H, Sk, D], the forward's row logsumexp lse [B*H, S] f32 and
// delta = rowsum(dO * O) [B*H, S] f32 (a plain torch op, as the JAX package
// computes it outside its kernels). Outputs dq [B*H, S, D] (kernel
// flash_bwd_dq) and dk, dv [B*H, Sk, D] (kernel flash_bwd_dkv), in the
// inputs' dtype (f32, bf16 or fp16; any D % 8 == 0: up to 256 the 16-bit
// kernels instantiated at a padded width, attention_tile.cuh; above it the
// wide kernels of attention_wide.cuh with this file's schedule and masks). The score
// pipeline is the forward's (csrc/flash_attention_fwd.cu): causal masking
// with offset Sk - S, a key-padding row [B, Sk] or (q, k) tiles per batch
// or per head (int32, nonzero = attend), ALiBi slope * (k - q), a causal
// sliding window and the Gemma-2 softcap, whose derivative 1 - tanh^2 is
// threaded through dS.
//
// Numerics follow the TPU kernels: f32 scores scaled by sm_scale,
// p = exp(s - lse) with masked entries exactly 0 (always guarded, so a row
// with no live key gets zero gradients, as _bwd_p does), dp = dO V^T in f32,
// dS = p (dp - delta) dsoft sm_scale, and P and dS rounded to the value
// dtype before the products dV += P^T dO, dK += dS^T Q, dQ += dS K, which
// sum in f32.
//
// Bound: operations at head_dim 64 and S = 1024 (a causal backward does 5
// products of D flops per live (q, k) pair against ~8 D bytes per row); the
// design keeps every S x Sk intermediate in registers. Two forms of each
// kernel: the train path's call (16-bit, head dim 64, no mask, ALiBi, window
// or softcap) runs on wgmma with TMA (the section "Hopper" below); every
// other call runs the mma.sync form: one CTA of 4 warps per 64 rows (queries
// for dq, keys for dkv); each warp owns 16 rows, keeps its rows' two A
// operands (Q and dO for dq, K and V for dkv) in registers as
// mma.sync.m16n8k16 fragments and streams 64-row tiles of the other side
// through a cp.async double buffer in shared memory (rows padded by 8
// elements for ldmatrix). dkv computes S^T = K Q^T directly, so P^T and dS^T
// come out of the accumulators already in the A-operand layout of dV and dK:
// no transpose through shared memory. Above width 128 the own rows stay in
// shared memory (OwnA, attention_tile.cuh), dq takes key tiles of 32 and
// dk/dv splits its output columns over two CTAs (blockIdx.z).
//
// What both forms' schedule does about the time (PERF.md, Findings, PR 6;
// the block-sparse kernels of block_sparse_attention.cu proved both):
// - Longest lists first. The grid is (b*h, rank): every head's longest
//   causal list dispatches before any shorter one, so the last wave is
//   short lists. dq ranks the query tiles from the last (it sees every
//   key), dk/dv the key tiles from the first (every query sees it).
// - Tiles are classified once: a tile wholly below the causal diagonal and
//   inside the ragged edge runs no mask code at all; a diagonal or edge
//   tile runs the positional mask in a pass of its own over the score
//   fragments (mask_pos); a call with a mask, ALiBi, a window or a softcap
//   is a compile-time variant (EXTRAS) whose pass runs the whole score
//   pipeline on every tile and keeps the softcap's derivative beside the
//   scores. The dS loop itself holds no mask code.
// The causal triangle and the window skip whole tiles. f32: CUDA-core
// FMAs, so f32 results stay f32 (no TF32): DP / 32 threads per row, each
// owning 32 of its row's dims, partial dot products meeting by shuffles.

#include "attention_tile.cuh"
#include "attention_wide.cuh"
#include "hopper.cuh"

#include <type_traits>

namespace {

using namespace tile;
using namespace hopper;

constexpr float NEG_INF = -1e30f;
constexpr float LOG2E = 1.4426950408889634f;
constexpr int NTHREADS = 128;
constexpr int BR = 64;            // rows per 16-bit CTA: 4 warps x 16

struct Params {
  const void* q;
  const void* k;
  const void* v;
  const void* dout;
  const float* lse;               // [B*H, S]
  const float* delta;             // [B*H, S]
  const int* kvm;                 // [B, Sk] or null
  const int* qkm;                 // [B or B*H, S, Sk] or null
  const float* slopes;            // [H] or null
  void* dq;
  void* dk;
  void* dv;
  int H, S, Sk, D, causal, window, qkm_per_head;
  float sm_scale, softcap;
};

// softcap, ALiBi and the masks on one scaled score (the TPU kernels'
// _scores order): returns -1e30 for a masked entry and sets *dsoft to the
// softcap's derivative (1 without one)
__device__ __forceinline__ float score(const Params& p, float s, int b, int bh,
                                       int row, int key, float slope,
                                       float* dsoft) {
  float d = 1.f;
  if (p.softcap > 0.f) {
    const float t = tanhf(s / p.softcap);
    s = t * p.softcap;
    d = 1.f - t * t;
  }
  *dsoft = d;
  const int q_pos = row + (p.Sk - p.S);
  if (p.slopes) s += slope * static_cast<float>(key - q_pos);
  bool keep = key < p.Sk && row < p.S;
  if (p.causal) keep = keep && key <= q_pos;
  if (p.window > 0) keep = keep && q_pos - key < p.window;
  if (keep && p.kvm) keep = p.kvm[(size_t)b * p.Sk + key] != 0;
  if (keep && p.qkm)
    keep = p.qkm[((size_t)(p.qkm_per_head ? bh : b) * p.S + row) * p.Sk +
                 key] != 0;
  return keep ? s : NEG_INF;
}

// p from the saved logsumexp; a masked entry is exactly 0 (a dead row's lse
// is itself -1e30-sized and exp(s - lse) would resurrect it)
__device__ __forceinline__ float prob(float s, float lse) {
  return s > 0.5f * NEG_INF ? exp2f((s - lse) * LOG2E) : 0.f;
}

// key tiles [lo, hi) of size bk that the causal triangle and the window
// leave live for query rows [q0, q_last] (the forward's gate)
__device__ __forceinline__ void key_tiles(const Params& p, int q0, int q_last,
                                          int bk, int* lo, int* hi) {
  const int offset = p.Sk - p.S;
  *lo = 0;
  *hi = (p.Sk + bk - 1) / bk;
  if (p.causal) {
    const int last_key = q_last + offset;
    *hi = last_key < 0 ? 0 : min(*hi, last_key / bk + 1);
  }
  if (p.window > 0) {
    const int first_key = q0 + offset - (p.window - 1);
    if (first_key > 0) *lo = first_key / bk;
  }
}

// query tiles [lo, hi) of size bq holding a row that sees some key of
// [k0, k_last]: the same gate, solved for the queries (_run_gate is
// symmetric in the two block indices)
__device__ __forceinline__ void query_tiles(const Params& p, int k0,
                                            int k_last, int bq, int* lo,
                                            int* hi) {
  const int offset = p.Sk - p.S;
  *lo = 0;
  *hi = (p.S + bq - 1) / bq;
  if (p.causal) {
    const int first_q = k0 - offset;          // q + offset >= k0
    if (first_q > 0) *lo = first_q / bq;
  }
  if (p.window > 0) {
    const int last_q = k_last - offset + p.window - 1;
    *hi = last_q < 0 ? 0 : min(*hi, last_q / bq + 1);
  }
}

// ------------------------------------------------------------ bf16, fp16

// -1e30 on the entries of a 16 x (8 * NJ) score tile (mma.sync layout: the
// thread's rows a0 / a1, columns b0 + 8 j + cq + {0, 1}) that the causal
// diagonal or the ragged edge masks. QMAJOR: rows are queries and columns
// keys (dq); else rows are keys and columns queries (dk/dv, S^T)
template <int NJ, bool QMAJOR>
__device__ __forceinline__ void mask_pos(float (*s)[4], const Params& p,
                                         int a0, int a1, int b0, int cq) {
  const int offset = p.Sk - p.S;
#pragma unroll
  for (int j = 0; j < NJ; ++j)
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const int a = c < 2 ? a0 : a1, bc = b0 + j * 8 + cq + (c & 1);
      const int row = QMAJOR ? a : bc, key = QMAJOR ? bc : a;
      const bool keep = key < p.Sk && row < p.S &&
                        (!p.causal || key <= row + offset);
      if (!keep) s[j][c] = NEG_INF;
    }
}

// the whole score pipeline (softcap, ALiBi, every mask) on a scaled score
// tile of the same layout; dsoft gets each entry's softcap derivative
template <int NJ, bool QMAJOR>
__device__ __forceinline__ void extras_tile(float (*s)[4], float (*dsoft)[4],
                                            const Params& p, int b, int bh,
                                            int a0, int a1, int b0, int cq,
                                            float slope) {
#pragma unroll
  for (int j = 0; j < NJ; ++j)
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const int a = c < 2 ? a0 : a1, bc = b0 + j * 8 + cq + (c & 1);
      s[j][c] = score(p, s[j][c], b, bh, QMAJOR ? a : bc, QMAJOR ? bc : a,
                      slope, &dsoft[j][c]);
    }
}

template <int NJ>
__device__ __forceinline__ void scale_tile(float (*s)[4], float scale) {
#pragma unroll
  for (int j = 0; j < NJ; ++j)
#pragma unroll
    for (int c = 0; c < 4; ++c) s[j][c] *= scale;
}

// dQ for 64 query rows: loop over the live key tiles of 64 (32 above
// width 128) with K and V double-buffered in shared memory. EXACT: D ==
// DP, a compile-time width (no column predicates, constant strides)
template <typename T, int DP, bool EXTRAS, bool EXACT>
__global__ void __launch_bounds__(NTHREADS)
flash_bwd_dq(Params p) {
  constexpr int BK = DP > 128 ? 32 : 64, LD = DP + 8, TILE = BK * LD;
  constexpr int NJ = BK / 8;
  constexpr bool OWN_SMEM = OwnA<T, DP>::SMEM;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* sm = reinterpret_cast<T*>(smem_raw);
  const int D = EXACT ? DP : p.D;
  const int bh = blockIdx.x, b = bh / p.H, h = bh % p.H;
  const int qt = gridDim.y - 1 - blockIdx.y;  // the last query tile sees most
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int q0 = qt * BR;
  const int r0 = q0 + warp * 16 + lane / 4, r1 = r0 + 8;
  const int cq = (lane % 4) * 2;
  const float slope = p.slopes ? p.slopes[h] : 0.f;
  const size_t qoff = (size_t)bh * p.S;

  OwnA<T, DP> qa, da;                          // Q and dO, the A operands
  own_load<T, DP>(qa, static_cast<const T*>(p.q) + qoff * D, sm + 4 * TILE,
                  q0, r0, r1, p.S, D, cq, tid);
  own_load<T, DP>(da, static_cast<const T*>(p.dout) + qoff * D,
                  sm + 4 * TILE + 64 * LD, q0, r0, r1, p.S, D, cq, tid);
  if (OWN_SMEM) cp_async_commit();             // waited for with tile lo
  float lse[2], dlt[2];
  lse[0] = r0 < p.S ? p.lse[qoff + r0] : 0.f;
  lse[1] = r1 < p.S ? p.lse[qoff + r1] : 0.f;
  dlt[0] = r0 < p.S ? p.delta[qoff + r0] : 0.f;
  dlt[1] = r1 < p.S ? p.delta[qoff + r1] : 0.f;
  float acc[DP / 8][4];
#pragma unroll
  for (int n = 0; n < DP / 8; ++n) acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;

  int lo, hi;
  key_tiles(p, q0, min(q0 + BR, p.S) - 1, BK, &lo, &hi);
  const T* kb = static_cast<const T*>(p.k) + (size_t)bh * p.Sk * D;
  const T* vb = static_cast<const T*>(p.v) + (size_t)bh * p.Sk * D;
  if (lo < hi) {
    load_pair<T, DP, BK, NTHREADS>(sm, kb, vb, lo * BK, p.Sk, D, tid);
    cp_async_commit();
  }
  // the warp's rows start at q position warp_q0: a key tile needs the
  // positional mask only if its last key lies past it (causal) or it runs
  // past Sk; rows past S are never written
  const int warp_q0 = q0 + warp * 16 + (p.Sk - p.S);

  for (int kt = lo; kt < hi; ++kt) {
    const int k0 = kt * BK, stage = (kt - lo) & 1;
    if (kt + 1 < hi) {
      load_pair<T, DP, BK, NTHREADS>(sm + 2 * (stage ^ 1) * TILE, kb, vb,
                                     k0 + BK, p.Sk, D, tid);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const T* Ks = sm + 2 * stage * TILE;
    const T* Vs = Ks + TILE;
    float sf[NJ][4], dp[NJ][4], dsf[EXTRAS ? NJ : 1][4];
    mma_abt<T, DP, BK, LD>(sf, qa, Ks, lane);   // S = Q K^T
    mma_abt<T, DP, BK, LD>(dp, da, Vs, lane);   // dP = dO V^T
    scale_tile<NJ>(sf, p.sm_scale);
    if (EXTRAS)
      extras_tile<NJ, true>(sf, dsf, p, b, bh, r0, r1, k0, cq, slope);
    else if ((p.causal && k0 + BK - 1 > warp_q0) || k0 + BK > p.Sk)
      mask_pos<NJ, true>(sf, p, r0, r1, k0, cq);
#pragma unroll
    for (int j = 0; j < NJ; ++j)
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int rr = c >> 1;
        const float d = (dp[j][c] - dlt[rr]) * p.sm_scale;
        sf[j][c] = prob(sf[j][c], lse[rr]) *
                   (EXTRAS ? d * dsf[j][c] : d);                   // dS
      }
    mma_ab<T, DP, BK, LD>(acc, sf, Ks, lane);   // dQ += dS K
    __syncthreads();                            // the stage is refilled next
  }
  if (OWN_SMEM) cp_async_wait<0>();            // no key tile: not waited for
  store_rows<T, DP>(static_cast<T*>(p.dq) + qoff * D, acc, r0, r1, p.S, D,
                    cq);
}

// dK and dV for 64 key rows: loop over the query tiles of BQ that see them,
// with Q and dO double-buffered in shared memory and each tile's lse and
// delta beside them. Above width 128 the dK and dV accumulators of the
// whole width would not fit the registers: blockIdx.z picks the half of
// the columns this CTA accumulates (S^T and dP^T are computed by both)
template <typename T, int DP, int BQ, bool EXTRAS, bool EXACT>
__global__ void __launch_bounds__(NTHREADS)
flash_bwd_dkv(Params p) {
  constexpr int LD = DP + 8, TILE = BQ * LD, NJ = BQ / 8;
  constexpr bool OWN_SMEM = OwnA<T, DP>::SMEM;
  constexpr int DO = OWN_SMEM ? DP / 2 : DP;   // columns accumulated here
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* sm = reinterpret_cast<T*>(smem_raw);
  __shared__ float rows_s[2][2][BQ];           // [stage][lse, delta][query]
  const int D = EXACT ? DP : p.D;
  const int bh = blockIdx.x, b = bh / p.H, h = bh % p.H;
  const int kt = blockIdx.y;                   // key tile 0 sees most queries
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int k0 = kt * BR;
  const int r0 = k0 + warp * 16 + lane / 4, r1 = r0 + 8;
  const int cq = (lane % 4) * 2;
  const float slope = p.slopes ? p.slopes[h] : 0.f;
  const size_t koff = (size_t)bh * p.Sk, qoff = (size_t)bh * p.S;

  const int c0 = blockIdx.z * DO;
  OwnA<T, DP> ka, va;                          // K and V, the A operands
  own_load<T, DP>(ka, static_cast<const T*>(p.k) + koff * D, sm + 4 * TILE,
                  k0, r0, r1, p.Sk, D, cq, tid);
  own_load<T, DP>(va, static_cast<const T*>(p.v) + koff * D,
                  sm + 4 * TILE + 64 * LD, k0, r0, r1, p.Sk, D, cq, tid);
  if (OWN_SMEM) cp_async_commit();             // waited for with tile lo
  float dk[DO / 8][4], dv[DO / 8][4];
#pragma unroll
  for (int n = 0; n < DO / 8; ++n)
#pragma unroll
    for (int c = 0; c < 4; ++c) dk[n][c] = dv[n][c] = 0.f;

  int lo, hi;
  query_tiles(p, k0, min(k0 + BR, p.Sk) - 1, BQ, &lo, &hi);
  const T* qb = static_cast<const T*>(p.q) + qoff * D;
  const T* db = static_cast<const T*>(p.dout) + qoff * D;
  auto load = [&](int q0, int stage) {         // Q, dO, lse and delta
    for (int i = tid; i < BQ; i += NTHREADS) {
      const bool live = q0 + i < p.S;
      rows_s[stage][0][i] = live ? p.lse[qoff + q0 + i] : 0.f;
      rows_s[stage][1][i] = live ? p.delta[qoff + q0 + i] : 0.f;
    }
    load_pair<T, DP, BQ, NTHREADS>(sm + 2 * stage * TILE, qb, db, q0, p.S, D,
                                   tid);
    cp_async_commit();
  };
  if (lo < hi) load(lo * BQ, 0);
  // the warp's keys end at warp_k1: a query tile needs the positional mask
  // if that key lies past the tile's first query position (causal) or its
  // queries run past S (they would add to dK, dV)
  const int warp_k1 = k0 + warp * 16 + 15 - (p.Sk - p.S);

  for (int qt = lo; qt < hi; ++qt) {
    const int q0 = qt * BQ, stage = (qt - lo) & 1;
    if (qt + 1 < hi) {
      load(q0 + BQ, stage ^ 1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const T* Qs = sm + 2 * stage * TILE;
    const T* Ds = Qs + TILE;
    const float* lse = rows_s[stage][0];
    const float* dlt = rows_s[stage][1];
    float st[NJ][4], dpt[NJ][4], dsf[EXTRAS ? NJ : 1][4];
    mma_abt<T, DP, BQ, LD>(st, ka, Qs, lane);  // S^T = K Q^T
    mma_abt<T, DP, BQ, LD>(dpt, va, Ds, lane); // dP^T = V dO^T
    scale_tile<NJ>(st, p.sm_scale);
    if (EXTRAS)
      extras_tile<NJ, false>(st, dsf, p, b, bh, r0, r1, q0, cq, slope);
    else if ((p.causal && warp_k1 > q0) || q0 + BQ > p.S || k0 + BR > p.Sk)
      mask_pos<NJ, false>(st, p, r0, r1, q0, cq);
#pragma unroll
    for (int j = 0; j < NJ; ++j)
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int qi = j * 8 + cq + (c & 1);
        const float pr = prob(st[j][c], lse[qi]);
        const float d = (dpt[j][c] - dlt[qi]) * p.sm_scale;
        st[j][c] = pr;                                             // P^T
        dpt[j][c] = pr * (EXTRAS ? d * dsf[j][c] : d);             // dS^T
      }
    mma_ab<T, DO, BQ, LD>(dv, st, Ds + c0, lane);   // dV += P^T dO
    mma_ab<T, DO, BQ, LD>(dk, dpt, Qs + c0, lane);  // dK += dS^T Q
    __syncthreads();                           // the stage is refilled next
  }
  if (OWN_SMEM) cp_async_wait<0>();            // no query tile: not waited for
  store_rows<T, DO>(static_cast<T*>(p.dk) + koff * D, dk, r0, r1, p.Sk, D,
                    cq, 1.f, 1.f, c0);
  store_rows<T, DO>(static_cast<T*>(p.dv) + koff * D, dv, r0, r1, p.Sk, D,
                    cq, 1.f, 1.f, c0);
}

// ------------------------------------------------------------------- f32

// TPR = DP / 32 threads per row, each owning the float4 slices i*TPR + t
// (i < 8) of its row: 32 dims, neighbouring threads on neighbouring
// addresses; columns past D are zeros
template <int DP>
__device__ __forceinline__ void load_row32(float* dst, const float* row,
                                           int t, int D) {
  constexpr int TPR = DP / 32;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const float4 x = load_f4(row, 4 * (i * TPR + t), D);
    dst[4 * i] = x.x; dst[4 * i + 1] = x.y; dst[4 * i + 2] = x.z; dst[4 * i + 3] = x.w;
  }
}

template <int DP>
__device__ __forceinline__ void store_row32(float* row, const float* src,
                                            int t, int D) {
  constexpr int TPR = DP / 32;
#pragma unroll
  for (int i = 0; i < 8; ++i)
    if (4 * (i * TPR + t) < D)
      *reinterpret_cast<float4*>(row + 4 * (i * TPR + t)) =
          make_float4(src[4 * i], src[4 * i + 1], src[4 * i + 2], src[4 * i + 3]);
}

// the dot products of this thread's slices with one shared row (a, b
// against x, y), summed over the row's TPR threads
template <int DP>
__device__ __forceinline__ void dot2(const float* a, const float* x,
                                     const float* b, const float* y, int t,
                                     float* ax, float* by) {
  constexpr int TPR = DP / 32;
  float s = 0.f, d = 0.f;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const float4 u = *reinterpret_cast<const float4*>(x + 4 * (i * TPR + t));
    const float4 w = *reinterpret_cast<const float4*>(y + 4 * (i * TPR + t));
    s = fmaf(a[4 * i], u.x, s); s = fmaf(a[4 * i + 1], u.y, s);
    s = fmaf(a[4 * i + 2], u.z, s); s = fmaf(a[4 * i + 3], u.w, s);
    d = fmaf(b[4 * i], w.x, d); d = fmaf(b[4 * i + 1], w.y, d);
    d = fmaf(b[4 * i + 2], w.z, d); d = fmaf(b[4 * i + 3], w.w, d);
  }
#pragma unroll
  for (int m = 1; m < TPR; m <<= 1) {
    s += __shfl_xor_sync(0xffffffffu, s, m);
    d += __shfl_xor_sync(0xffffffffu, d, m);
  }
  *ax = s;
  *by = d;
}

// acc += w * this thread's slices of the shared row x
template <int DP>
__device__ __forceinline__ void axpy32(float* acc, float w, const float* x,
                                       int t) {
  constexpr int TPR = DP / 32;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const float4 u = *reinterpret_cast<const float4*>(x + 4 * (i * TPR + t));
    acc[4 * i] = fmaf(w, u.x, acc[4 * i]);
    acc[4 * i + 1] = fmaf(w, u.y, acc[4 * i + 1]);
    acc[4 * i + 2] = fmaf(w, u.z, acc[4 * i + 2]);
    acc[4 * i + 3] = fmaf(w, u.w, acc[4 * i + 3]);
  }
}

// nrows rows of two [n, D] f32 matrices (from row i0) into shared tiles of
// width DP; rows past n and columns past D read zeros
template <int DP>
__device__ __forceinline__ void load_f32_pair(float* da, float* db,
                                              const float* a, const float* b,
                                              int i0, int nrows, int n,
                                              int D, int tid) {
  for (int idx = tid; idx < nrows * DP / 4; idx += NTHREADS) {
    const int rr = idx / (DP / 4), c = (idx % (DP / 4)) * 4;
    float4 x = make_float4(0.f, 0.f, 0.f, 0.f), y = x;
    if (i0 + rr < n) {
      x = load_f4(a + (size_t)(i0 + rr) * D, c, D);
      y = load_f4(b + (size_t)(i0 + rr) * D, c, D);
    }
    *reinterpret_cast<float4*>(&da[rr * DP + c]) = x;
    *reinterpret_cast<float4*>(&db[rr * DP + c]) = y;
  }
}

template <int DP>
__global__ void __launch_bounds__(NTHREADS)
flash_bwd_dq_f32(Params p) {
  constexpr int TPR = DP / 32, ROWS = NTHREADS / TPR;
  constexpr int BK = DP > 128 ? 16 : 32;       // keys a shared tile
  __shared__ __align__(16) float Ks[BK * DP];
  __shared__ __align__(16) float Vs[BK * DP];
  const int D = p.D;
  const int bh = blockIdx.x, b = bh / p.H, h = bh % p.H;
  const int qt = gridDim.y - 1 - blockIdx.y;
  const int tid = threadIdx.x, t = tid % TPR;
  const int q0 = qt * ROWS, row = q0 + tid / TPR;
  const float slope = p.slopes ? p.slopes[h] : 0.f;
  const size_t qoff = (size_t)bh * p.S, koff = (size_t)bh * p.Sk;
  const int rr = min(row, p.S - 1);
  float qv[32], dov[32], acc[32];
  load_row32<DP>(qv, static_cast<const float*>(p.q) + (qoff + rr) * D, t, D);
  load_row32<DP>(dov, static_cast<const float*>(p.dout) + (qoff + rr) * D, t,
                 D);
#pragma unroll
  for (int i = 0; i < 32; ++i) acc[i] = 0.f;
  const float lse = p.lse[qoff + rr], dlt = p.delta[qoff + rr];

  int lo, hi;
  key_tiles(p, q0, min(q0 + ROWS, p.S) - 1, BK, &lo, &hi);
  for (int kt = lo; kt < hi; ++kt) {
    const int k0 = kt * BK;
    __syncthreads();
    load_f32_pair<DP>(Ks, Vs, static_cast<const float*>(p.k) + koff * D,
                      static_cast<const float*>(p.v) + koff * D, k0, BK, p.Sk,
                      D, tid);
    __syncthreads();
    for (int kk = 0; kk < BK; ++kk) {
      float s, dp, dsoft;
      dot2<DP>(qv, &Ks[kk * DP], dov, &Vs[kk * DP], t, &s, &dp);
      s = score(p, s * p.sm_scale, b, bh, row, k0 + kk, slope, &dsoft);
      const float ds = prob(s, lse) * (dp - dlt) * dsoft * p.sm_scale;
      axpy32<DP>(acc, ds, &Ks[kk * DP], t);
    }
  }
  if (row < p.S)
    store_row32<DP>(static_cast<float*>(p.dq) + (qoff + row) * D, acc, t, D);
}

template <int DP>
__global__ void __launch_bounds__(NTHREADS)
flash_bwd_dkv_f32(Params p) {
  constexpr int TPR = DP / 32, ROWS = NTHREADS / TPR;
  constexpr int BQ = DP > 128 ? 16 : 32;       // queries a shared tile
  __shared__ __align__(16) float Qs[BQ * DP];
  __shared__ __align__(16) float Ds[BQ * DP];
  __shared__ float Ls[BQ], Es[BQ];
  const int D = p.D;
  const int bh = blockIdx.x, b = bh / p.H, h = bh % p.H;
  const int kt = blockIdx.y;
  const int tid = threadIdx.x, t = tid % TPR;
  const int k0 = kt * ROWS, key = k0 + tid / TPR;
  const float slope = p.slopes ? p.slopes[h] : 0.f;
  const size_t qoff = (size_t)bh * p.S, koff = (size_t)bh * p.Sk;
  const int kr = min(key, p.Sk - 1);
  float kv[32], vv[32], dk[32], dv[32];
  load_row32<DP>(kv, static_cast<const float*>(p.k) + (koff + kr) * D, t, D);
  load_row32<DP>(vv, static_cast<const float*>(p.v) + (koff + kr) * D, t, D);
#pragma unroll
  for (int i = 0; i < 32; ++i) dk[i] = dv[i] = 0.f;

  int lo, hi;
  query_tiles(p, k0, min(k0 + ROWS, p.Sk) - 1, BQ, &lo, &hi);
  for (int qt = lo; qt < hi; ++qt) {
    const int q0 = qt * BQ;
    __syncthreads();
    load_f32_pair<DP>(Qs, Ds, static_cast<const float*>(p.q) + qoff * D,
                      static_cast<const float*>(p.dout) + qoff * D, q0, BQ,
                      p.S, D, tid);
    for (int i = tid; i < BQ; i += NTHREADS) {
      const bool live = q0 + i < p.S;
      Ls[i] = live ? p.lse[qoff + q0 + i] : 0.f;
      Es[i] = live ? p.delta[qoff + q0 + i] : 0.f;
    }
    __syncthreads();
    for (int qq = 0; qq < BQ; ++qq) {
      float s, dp, dsoft;
      dot2<DP>(kv, &Qs[qq * DP], vv, &Ds[qq * DP], t, &s, &dp);
      s = score(p, s * p.sm_scale, b, bh, q0 + qq, key, slope, &dsoft);
      const float pr = prob(s, Ls[qq]);
      const float ds = pr * (dp - Es[qq]) * dsoft * p.sm_scale;
      axpy32<DP>(dv, pr, &Ds[qq * DP], t);
      axpy32<DP>(dk, ds, &Qs[qq * DP], t);
    }
  }
  if (key < p.Sk) {
    store_row32<DP>(static_cast<float*>(p.dk) + (koff + key) * D, dk, t, D);
    store_row32<DP>(static_cast<float*>(p.dv) + (koff + key) * D, dv, t, D);
  }
}

// ------------------------------------------- Hopper: wgmma + TMA (D 64)

// The train path's call (16-bit, head dim 64, no mask, ALiBi, window or
// softcap) runs these two kernels; every other call the ones above. One
// CTA is one consumer warpgroup (128 threads, 64 rows: keys for dk/dv,
// queries for dq) and one producer warp. The producer streams the other
// side's 64-row tiles (Q, dO and their lse and delta for dk/dv; K and V for
// dq) by TMA into a ring of STAGES shared-memory slots, 128-byte swizzled,
// and signals each slot through an mbarrier; the consumers free it through
// another. The four products of a tile run as wgmma.m64n64k16: S and dP
// with both operands in shared memory, then dV / dK (or dQ) with P and dS
// as register A operands repacked from the accumulators (the mma.sync
// layout within each warp) and the streamed tile as a transposed B.

constexpr int WG = 128;                 // consumer threads
constexpr int WG_THREADS = WG + 32;     // and the producer warp
constexpr int STAGES = 2;
constexpr int TILE_ELEMS = 64 * 64;     // one 64 x 64 16-bit tile, 8 KB

struct Maps {                           // [BH, rows, 64] tensor maps
  CUtensorMap q, k, v, dout;
};

// shared memory of the wgmma kernels: two own tiles, STAGES slots of two
// streamed tiles, STAGES slots of 64 lse and 64 delta, the barriers;
// 1024 bytes of slack for the tiles' alignment
constexpr size_t WG_SMEM = 1024 + sizeof(bf16) * TILE_ELEMS * (2 + 2 * STAGES)
                           + sizeof(float) * 2 * 64 * STAGES
                           + sizeof(uint64_t) * (2 * STAGES + 1);

struct WgSmem {
  unsigned char* own;                   // 2 tiles
  unsigned char* ring;                  // STAGES x 2 tiles
  float* rows;                          // STAGES x [lse 64, delta 64]
  uint64_t* full;                       // STAGES
  uint64_t* empty;                      // STAGES
  uint64_t* own_bar;
};

__device__ __forceinline__ WgSmem wg_smem(unsigned char* raw) {
  WgSmem s;
  s.own = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(raw) + 1023) & ~uintptr_t(1023));
  s.ring = s.own + 2 * TILE_ELEMS * 2;
  s.rows = reinterpret_cast<float*>(s.ring + STAGES * 2 * TILE_ELEMS * 2);
  s.full = reinterpret_cast<uint64_t*>(s.rows + 2 * 64 * STAGES);
  s.empty = s.full + STAGES;
  s.own_bar = s.empty + STAGES;
  return s;
}

// the barriers: full (the producer warp's 32 lanes and the TMA bytes),
// empty (the 128 consumers), own (the own tiles' bytes)
__device__ __forceinline__ void wg_init(const WgSmem& s) {
  if (threadIdx.x == 0) {
    for (int i = 0; i < STAGES; ++i) {
      mbar_init(&s.full[i], 32);
      mbar_init(&s.empty[i], WG);
    }
    mbar_init(s.own_bar, 1);
    fence_mbar_init();
  }
  __syncthreads();
}

// dK and dV for 64 key rows (blockIdx.y: key tile 0, seen by the most
// queries, first): the producer streams Q, dO, lse and delta of the query
// tiles that see them
template <typename T>
__global__ void __launch_bounds__(WG_THREADS, 2)
flash_bwd_dkv_wg(const __grid_constant__ Maps maps, Params p) {
  extern __shared__ unsigned char smem_raw[];
  const WgSmem s = wg_smem(smem_raw);
  const int bh = blockIdx.x, k0 = blockIdx.y * 64;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  int lo, hi;
  query_tiles(p, k0, min(k0 + 64, p.Sk) - 1, 64, &lo, &hi);
  wg_init(s);
  T* Ks = reinterpret_cast<T*>(s.own);
  T* Vs = Ks + TILE_ELEMS;
  if (warp == 4) {                        // the producer warp
    if (lane == 0) {
      mbar_arrive_expect_tx(s.own_bar, 2 * TILE_ELEMS * 2);
      tma_tile(Ks, &maps.k, s.own_bar, 0, k0, bh);
      tma_tile(Vs, &maps.v, s.own_bar, 0, k0, bh);
    }
    const size_t qoff = (size_t)bh * p.S;
    for (int qt = lo; qt < hi; ++qt) {
      const int i = qt - lo, st = i % STAGES, ph = (i / STAGES) & 1;
      if (i >= STAGES) mbar_wait(&s.empty[st], ph ^ 1);
      float* rows = s.rows + st * 128;
      for (int j = lane; j < 64; j += 32) {
        const int q = qt * 64 + j;
        rows[j] = q < p.S ? p.lse[qoff + q] : 0.f;
        rows[64 + j] = q < p.S ? p.delta[qoff + q] : 0.f;
      }
      if (lane == 0) {
        T* slot = reinterpret_cast<T*>(s.ring) + st * 2 * TILE_ELEMS;
        mbar_expect_tx(&s.full[st], 2 * TILE_ELEMS * 2);
        tma_tile(slot, &maps.q, &s.full[st], 0, qt * 64, bh);
        tma_tile(slot + TILE_ELEMS, &maps.dout, &s.full[st], 0, qt * 64, bh);
      }
      mbar_arrive(&s.full[st]);
    }
    return;
  }
  // the consumer warpgroup: rows k0 + 16 warp + lane / 4 (+ 8), columns
  // (queries) 8 j + 2 (lane % 4) (+ 1) of each accumulator
  const int r0 = k0 + warp * 16 + lane / 4, r1 = r0 + 8;
  const int cq = (lane % 4) * 2;
  const int warp_k1 = k0 + warp * 16 + 15 - (p.Sk - p.S);
  float dk[8][4], dv[8][4];
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int c = 0; c < 4; ++c) dk[j][c] = dv[j][c] = 0.f;
  mbar_wait(s.own_bar, 0);
  for (int qt = lo; qt < hi; ++qt) {
    const int i = qt - lo, st = i % STAGES, q0 = qt * 64;
    mbar_wait(&s.full[st], (i / STAGES) & 1);
    const T* Qs = reinterpret_cast<const T*>(s.ring) + st * 2 * TILE_ELEMS;
    const T* Ds = Qs + TILE_ELEMS;
    const float* lse = s.rows + st * 128;
    const float* dlt = lse + 64;
    float sf[8][4], dp[8][4];
    fence_acc<8>(dk);
    fence_acc<8>(dv);
    wg_fence();
    product_ss<T>(sf, Ks, Qs);            // S^T = K Q^T
    product_ss<T>(dp, Vs, Ds);            // dP^T = V dO^T
    wg_commit();
    wg_wait();
    fence_acc<8>(sf);
    fence_acc<8>(dp);
    scale_tile<8>(sf, p.sm_scale);
    if ((p.causal && warp_k1 > q0) || q0 + 64 > p.S || k0 + 64 > p.Sk)
      mask_pos<8, false>(sf, p, r0, r1, q0, cq);
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int qi = j * 8 + cq + (c & 1);
        const float pr = prob(sf[j][c], lse[qi]);
        sf[j][c] = pr;                                          // P^T
        dp[j][c] = pr * ((dp[j][c] - dlt[qi]) * p.sm_scale);    // dS^T
      }
    wg_fence();
    product_rs<T>(dv, sf, Ds);            // dV += P^T dO
    product_rs<T>(dk, dp, Qs);            // dK += dS^T Q
    wg_commit();
    wg_wait();
    fence_acc<8>(dk);
    fence_acc<8>(dv);
    mbar_arrive(&s.empty[st]);
  }
  const size_t koff = (size_t)bh * p.Sk * 64;
  store_rows<T, 64>(static_cast<T*>(p.dk) + koff, dk, r0, r1, p.Sk, 64, cq);
  store_rows<T, 64>(static_cast<T*>(p.dv) + koff, dv, r0, r1, p.Sk, 64, cq);
}

// dQ for 64 query rows (blockIdx.y: the last query tile, which sees the
// most keys, first): the producer streams the K and V tiles they see
template <typename T>
__global__ void __launch_bounds__(WG_THREADS, 2)
flash_bwd_dq_wg(const __grid_constant__ Maps maps, Params p) {
  extern __shared__ unsigned char smem_raw[];
  const WgSmem s = wg_smem(smem_raw);
  const int bh = blockIdx.x, q0 = (gridDim.y - 1 - blockIdx.y) * 64;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  int lo, hi;
  key_tiles(p, q0, min(q0 + 64, p.S) - 1, 64, &lo, &hi);
  wg_init(s);
  T* Qs = reinterpret_cast<T*>(s.own);
  T* Ds = Qs + TILE_ELEMS;
  if (warp == 4) {                        // the producer warp
    if (lane == 0) {
      mbar_arrive_expect_tx(s.own_bar, 2 * TILE_ELEMS * 2);
      tma_tile(Qs, &maps.q, s.own_bar, 0, q0, bh);
      tma_tile(Ds, &maps.dout, s.own_bar, 0, q0, bh);
    }
    for (int kt = lo; kt < hi; ++kt) {
      const int i = kt - lo, st = i % STAGES, ph = (i / STAGES) & 1;
      if (i >= STAGES) mbar_wait(&s.empty[st], ph ^ 1);
      if (lane == 0) {
        T* slot = reinterpret_cast<T*>(s.ring) + st * 2 * TILE_ELEMS;
        mbar_expect_tx(&s.full[st], 2 * TILE_ELEMS * 2);
        tma_tile(slot, &maps.k, &s.full[st], 0, kt * 64, bh);
        tma_tile(slot + TILE_ELEMS, &maps.v, &s.full[st], 0, kt * 64, bh);
      }
      mbar_arrive(&s.full[st]);
    }
    return;
  }
  const int r0 = q0 + warp * 16 + lane / 4, r1 = r0 + 8;
  const int cq = (lane % 4) * 2;
  const int warp_q0 = q0 + warp * 16 + (p.Sk - p.S);
  const size_t qoff = (size_t)bh * p.S;
  float lse[2], dlt[2];
  lse[0] = r0 < p.S ? p.lse[qoff + r0] : 0.f;
  lse[1] = r1 < p.S ? p.lse[qoff + r1] : 0.f;
  dlt[0] = r0 < p.S ? p.delta[qoff + r0] : 0.f;
  dlt[1] = r1 < p.S ? p.delta[qoff + r1] : 0.f;
  float acc[8][4];
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int c = 0; c < 4; ++c) acc[j][c] = 0.f;
  mbar_wait(s.own_bar, 0);
  for (int kt = lo; kt < hi; ++kt) {
    const int i = kt - lo, st = i % STAGES, k0 = kt * 64;
    mbar_wait(&s.full[st], (i / STAGES) & 1);
    const T* Ks = reinterpret_cast<const T*>(s.ring) + st * 2 * TILE_ELEMS;
    const T* Vs = Ks + TILE_ELEMS;
    float sf[8][4], dp[8][4];
    fence_acc<8>(acc);
    wg_fence();
    product_ss<T>(sf, Qs, Ks);            // S = Q K^T
    product_ss<T>(dp, Ds, Vs);            // dP = dO V^T
    wg_commit();
    wg_wait();
    fence_acc<8>(sf);
    fence_acc<8>(dp);
    scale_tile<8>(sf, p.sm_scale);
    if ((p.causal && k0 + 63 > warp_q0) || k0 + 64 > p.Sk)
      mask_pos<8, true>(sf, p, r0, r1, k0, cq);
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int rr = c >> 1;
        sf[j][c] = prob(sf[j][c], lse[rr]) *
                   ((dp[j][c] - dlt[rr]) * p.sm_scale);        // dS
      }
    wg_fence();
    product_rs<T>(acc, sf, Ks);           // dQ += dS K
    wg_commit();
    wg_wait();
    fence_acc<8>(acc);
    mbar_arrive(&s.empty[st]);
  }
  store_rows<T, 64>(static_cast<T*>(p.dq) + qoff * 64, acc, r0, r1, p.S, 64,
                    cq);
}

template <typename T>
int launch_wg(const Params& p, int BH, bool dkv, cudaStream_t st) {
  const bool bf = std::is_same<T, bf16>::value;
  Maps maps;
  if (!tile_map(&maps.q, p.q, bf, p.S, BH) ||
      !tile_map(&maps.k, p.k, bf, p.Sk, BH) ||
      !tile_map(&maps.v, p.v, bf, p.Sk, BH) ||
      !tile_map(&maps.dout, p.dout, bf, p.S, BH))
    return ERR_TENSOR_MAP;
  auto kernel = dkv ? flash_bwd_dkv_wg<T> : flash_bwd_dq_wg<T>;
  const cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)WG_SMEM);
  if (e != cudaSuccess) return static_cast<int>(e);
  const dim3 grid(BH, ((dkv ? p.Sk : p.S) + 63) / 64);
  kernel<<<grid, WG_THREADS, WG_SMEM, st>>>(maps, p);
  return static_cast<int>(cudaGetLastError());
}

// ------------------------------------------------- head dims above 256

// this file's schedule and masks for attention_wide.cuh: dq ranks the
// query tiles from the last, dk/dv the key tiles from the first (longest
// lists first), over the tiles key_tiles / query_tiles leave, with the
// whole score pipeline and the softcap's derivative on every score
struct Wide {
  using Prm = Params;
  template <bool QMAJOR>
  static __device__ int own(const Params&, int, int rank) {
    return QMAJOR ? gridDim.y - 1 - rank : rank;
  }
  template <bool QMAJOR>
  static __device__ void list(const Params& p, int, int t, int* e0, int* e1) {
    const int r0 = t * wide::R;
    if (QMAJOR)
      key_tiles(p, r0, min(r0 + wide::R, p.S) - 1, wide::R, e0, e1);
    else
      query_tiles(p, r0, min(r0 + wide::R, p.Sk) - 1, wide::R, e0, e1);
  }
  template <bool QMAJOR>
  static __device__ int other(const Params&, int, int, int e) {
    return e * wide::R;
  }
  template <bool QMAJOR, int NJ>
  static __device__ void scores(const Params& p, int bh, int, int,
                                float (*s)[4], float (*ds)[4], int a0, int a1,
                                int b0, int cq) {
    const float slope = p.slopes ? p.slopes[bh % p.H] : 0.f;
    extras_tile<NJ, QMAJOR>(s, ds, p, bh / p.H, bh, a0, a1, b0, cq, slope);
  }
};

// ---------------------------------------------------------------- launch

// grid (b*h, tiles of rows_per_cta over n, splits): blockIdx.y is the rank
// that each kernel maps to a tile, longest list first; blockIdx.z the
// column half of a wide dk/dv
template <typename KernelFn>
int launch(KernelFn kernel, const Params& p, int rows_per_cta, int n, int BH,
           cudaStream_t stream, size_t smem = 0, int splits = 1) {
  if (smem > 48 * 1024) {                   // above 48 KB only by opt-in
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  dim3 grid(BH, (n + rows_per_cta - 1) / rows_per_cta, splits);
  kernel<<<grid, NTHREADS, smem, stream>>>(p);
  return static_cast<int>(cudaGetLastError());
}

// f32 rows are spread over DP / 32 threads: widths 32, 64, 128 and 256
constexpr int f32_dim(int d) {
  return d <= 32 ? 32 : d <= 64 ? 64 : d <= 128 ? 128 : 256;
}

// the (EXTRAS, EXACT) variant of a 16-bit kernel: go(extras, exact) with
// both as std::integral_constant. D 64 without extras runs the wgmma
// kernels (dispatch), so that exact variant is compiled only at the other
// widths; above 128 the width is a run-time D only
template <int DP, typename F>
int variant(const Params& p, bool extras, F&& go) {
  using Y = std::true_type;
  using N = std::false_type;
  if constexpr (DP <= 128) {
    if (extras) return p.D == DP ? go(Y(), Y()) : go(Y(), N());
    if constexpr (DP != 64) {
      if (p.D == DP) return go(N(), Y());
    }
  }
  return extras ? go(Y(), N()) : go(N(), N());
}

template <typename T, int DP>
int launch_dq_mma(const Params& p, int BH, bool extras, cudaStream_t st) {
  constexpr size_t smem = pair_smem_bytes<T, DP>(DP > 128 ? 32 : 64) +
                          own_smem_bytes<T, DP>(2);
  return variant<DP>(p, extras, [&](auto x, auto e) {
    return launch(flash_bwd_dq<T, DP, decltype(x)::value, decltype(e)::value>,
                  p, BR, p.S, BH, st, smem);
  });
}

template <typename T, int DP>
int launch_dkv_mma(const Params& p, int BH, bool extras, cudaStream_t st) {
  // query tiles of 32 above head_dim 64 keep dK, dV, K, V and the score
  // tiles within the register file
  constexpr int BQ = DP > 64 ? 32 : 64;
  constexpr size_t smem = pair_smem_bytes<T, DP>(BQ) +
                          own_smem_bytes<T, DP>(2);
  return variant<DP>(p, extras, [&](auto x, auto e) {
    return launch(
        flash_bwd_dkv<T, DP, BQ, decltype(x)::value, decltype(e)::value>, p,
        BR, p.Sk, BH, st, smem, DP > 128 ? 2 : 1);
  });
}

template <int DP>
int launch_dq(const Params& p, int BH, int dtype, bool extras,
              cudaStream_t st) {
  if (dtype == 1) return launch_dq_mma<bf16, DP>(p, BH, extras, st);
  return launch_dq_mma<f16, DP>(p, BH, extras, st);
}

template <int DP>
int launch_dkv(const Params& p, int BH, int dtype, bool extras,
               cudaStream_t st) {
  if (dtype == 1) return launch_dkv_mma<bf16, DP>(p, BH, extras, st);
  return launch_dkv_mma<f16, DP>(p, BH, extras, st);
}

template <int DP>
int launch_f32(const Params& p, int BH, bool dkv, cudaStream_t st) {
  constexpr int rows = NTHREADS / (DP / 32);
  return dkv ? launch(flash_bwd_dkv_f32<DP>, p, rows, p.Sk, BH, st)
             : launch(flash_bwd_dq_f32<DP>, p, rows, p.S, BH, st);
}

// one entry point for both kernels: dkv selects dk/dv
int dispatch(const Params& p, int BH, int dtype, bool dkv, cudaStream_t st) {
  const bool extras = p.kvm || p.qkm || p.slopes || p.window > 0 ||
                      p.softcap > 0.f;
  if (p.D > wide::FROM_DIM) {
    wide::Args w = {};
    w.q = p.q; w.k = p.k; w.v = p.v; w.dout = p.dout;
    w.lse = p.lse; w.delta = p.delta;
    w.o = p.dq; w.dk = p.dk; w.dv = p.dv;
    w.kv_head = (size_t)p.Sk * p.D;
    w.Sq = p.S; w.Sk = p.Sk; w.D = p.D; w.sm_scale = p.sm_scale;
    const int n = dkv ? p.Sk : p.S;
    const int tiles = (n + wide::R - 1) / wide::R;
    return dkv ? wide::launch<2, Wide>(w, p, BH, tiles, dtype, st)
               : wide::launch<1, Wide>(w, p, BH, tiles, dtype, st);
  }
  if (dtype == 0) {
    switch (f32_dim(p.D)) {
      case 32: return launch_f32<32>(p, BH, dkv, st);
      case 64: return launch_f32<64>(p, BH, dkv, st);
      case 128: return launch_f32<128>(p, BH, dkv, st);
      default: return launch_f32<256>(p, BH, dkv, st);
    }
  }
  if (p.D == 64 && !extras)               // the train path: wgmma + TMA
    return dtype == 1 ? launch_wg<bf16>(p, BH, dkv, st)
                      : launch_wg<f16>(p, BH, dkv, st);
  switch (pad_dim(p.D)) {
    case 32: return dkv ? launch_dkv<32>(p, BH, dtype, extras, st)
                        : launch_dq<32>(p, BH, dtype, extras, st);
    case 64: return dkv ? launch_dkv<64>(p, BH, dtype, extras, st)
                        : launch_dq<64>(p, BH, dtype, extras, st);
    case 96: return dkv ? launch_dkv<96>(p, BH, dtype, extras, st)
                        : launch_dq<96>(p, BH, dtype, extras, st);
    case 128: return dkv ? launch_dkv<128>(p, BH, dtype, extras, st)
                         : launch_dq<128>(p, BH, dtype, extras, st);
    case 192: return dkv ? launch_dkv<192>(p, BH, dtype, extras, st)
                         : launch_dq<192>(p, BH, dtype, extras, st);
    default: return dkv ? launch_dkv<256>(p, BH, dtype, extras, st)
                        : launch_dq<256>(p, BH, dtype, extras, st);
  }
}

Params make_params(const void* q, const void* k, const void* v,
                   const void* dout, const void* lse, const void* delta,
                   const void* kvm, const void* qkm, const void* slopes,
                   void* dq, void* dk, void* dv, int H, int S, int Sk, int D,
                   int causal, int window, int qkm_per_head, float sm_scale,
                   float softcap) {
  Params p;
  p.q = q; p.k = k; p.v = v; p.dout = dout;
  p.lse = static_cast<const float*>(lse);
  p.delta = static_cast<const float*>(delta);
  p.kvm = static_cast<const int*>(kvm);
  p.qkm = static_cast<const int*>(qkm);
  p.slopes = static_cast<const float*>(slopes);
  p.dq = dq; p.dk = dk; p.dv = dv;
  p.H = H; p.S = S; p.Sk = Sk; p.D = D; p.causal = causal; p.window = window;
  p.qkm_per_head = qkm_per_head;
  p.sm_scale = sm_scale; p.softcap = softcap;
  return p;
}

bool supported(int D, int dtype) {
  return dtype >= 0 && dtype <= 2 && D >= 8 && D % 8 == 0;
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16, 2 = float16 (q, k, v, dout and the
// outputs alike). D: any multiple of 8. Each returns the CUDA
// error of its launch (0 = launched); -1 for a dtype or head dim the
// kernels lack.
int flash_attention_bwd_dq_launch(const void* q, const void* k, const void* v,
                                  const void* dout, const void* lse,
                                  const void* delta, const void* kvm,
                                  const void* qkm, const void* slopes,
                                  void* dq, int BH, int H, int S, int Sk,
                                  int D, int causal, int window,
                                  int qkm_per_head, float sm_scale,
                                  float softcap, int dtype, void* stream) {
  const Params p = make_params(q, k, v, dout, lse, delta, kvm, qkm, slopes,
                               dq, nullptr, nullptr, H, S, Sk, D, causal,
                               window, qkm_per_head, sm_scale, softcap);
  if (!supported(D, dtype)) return -1;
  if (S <= 0 || BH <= 0) return 0;
  return dispatch(p, BH, dtype, false, static_cast<cudaStream_t>(stream));
}

int flash_attention_bwd_dkv_launch(const void* q, const void* k,
                                   const void* v, const void* dout,
                                   const void* lse, const void* delta,
                                   const void* kvm, const void* qkm,
                                   const void* slopes, void* dk, void* dv,
                                   int BH, int H, int S, int Sk, int D,
                                   int causal, int window, int qkm_per_head,
                                   float sm_scale, float softcap, int dtype,
                                   void* stream) {
  const Params p = make_params(q, k, v, dout, lse, delta, kvm, qkm, slopes,
                               nullptr, dk, dv, H, S, Sk, D, causal, window,
                               qkm_per_head, sm_scale, softcap);
  if (!supported(D, dtype)) return -1;
  if (Sk <= 0 || BH <= 0) return 0;
  return dispatch(p, BH, dtype, true, static_cast<cudaStream_t>(stream));
}

const char* flash_attention_bwd_error_string(int err) {
  if (err == ERR_TENSOR_MAP) return "TMA tensor map encoding failed";
  return err < 0 ? "unsupported dtype or head dim"
                 : cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"

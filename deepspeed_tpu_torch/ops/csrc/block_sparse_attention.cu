// Block-sparse flash attention for Hopper (sm_90a), plain C interface:
// three kernels.
//
// Replaces the Pallas kernels of
// deepspeed_tpu/ops/pallas/block_sparse_attention.py: _fwd_kernel (launched
// by _fwd at :271), _bwd_dq_kernel (:312) and _bwd_dkv_kernel (:353).
// q, k, v, dO [B*H, S, D]; the forward writes o [B*H, S, D] and the row
// logsumexp lse [B*H, S] f32; the backward reads lse and delta =
// rowsum(dO * O) [B*H, S] f32 (a plain torch op, as the JAX package
// computes it outside its kernels) and writes dq, or dk and dv. f32, bf16
// or fp16, any D % 8 == 0: up to 256 instantiated at a padded width
// (attention_tile.cuh), above it the wide kernels of attention_wide.cuh
// walking the same lists with this file's masks.
//
// The sparsity is a schedule, not a mask: the host (ops/
// block_sparse_attention.py, once per layout) lists for every (head, 64-row
// query tile) the 64-key tiles that hold a live (q, k) pair, and for every
// (head, key tile) the query tiles, as CSR arrays (ptr, idx) with one flag
// word per listed tile. A CTA walks only its list: a skipped tile costs
// neither its products nor its K/V (or Q/dO) load, so the work and the
// bytes scale with the layout's density. The grid runs the lists longest
// first: blockIdx.x is the (batch, head) and blockIdx.y a rank in the
// host's per-head order of tiles by descending list length, so every
// head's longest list dispatches before any second-longest (the fixed
// layout's dk/dv lists run from 1 to 61 tiles; launched in tile order
// they left a tail, PERF.md). Inside a listed tile the exact pattern
// applies per element: the fine layout layout[h, q / fine, k / fine]
// (uint8, a fine block that is a multiple of 8 and divides S, one byte
// per 8-key group, looked up only when the tile's flag has LAYOUT_BIT),
// then causal (key <= query) and the window (query - key < window) and
// the ragged edge (only when the flag has POS_BIT). A tile that lies
// wholly inside the layout, causal and window carries no flag and runs no
// mask at all (taking that path out of the flash forward cost 70% on an
// H100).
//
// Numerics follow the TPU kernels: f32 scores times sm_scale, masked
// entries at -1e30 with p exactly 0 (always guarded), p rounded to the value
// dtype before P V, lse = m + log(max(l, 1e-37)), p = exp(s - lse) in the
// backward, dS = p (dp - delta) sm_scale with P and dS rounded to the value
// dtype before the products, which sum in f32. One difference, by design:
// a query row with no live key writes zeros and gets zero gradients; the
// TPU kernel masks with a finite -1e30 and gives such a row, if its tile
// list is not empty, the mean of V over the keys it visited.
//
// Bound: operations at the train leg's shape (S 4096, D 64, 29.7% of the
// causal pairs live); the design keeps every score tile in registers.
// bf16 / fp16: the flash kernels' shape (csrc/flash_attention_*.cu): one
// CTA of 4 warps per 64-row tile, mma.sync.m16n8k16 with ldmatrix
// operands, the CTA's own rows as A fragments in registers, the listed
// tiles of the other side double-buffered through shared memory by
// cp.async (rows padded by 8 elements). The forward and dq own a query
// tile; dk/dv own a key tile and compute S^T = K Q^T, so P^T and dS^T come
// out in the A-operand layout of dV and dK (no atomics, no second pass).
// Above width 128 the own rows stay in shared memory (OwnA,
// attention_tile.cuh) and dk/dv splits its output columns over two CTAs
// (blockIdx.z). The long leg's calls (16-bit, D 64) run bs_fwd_wg, bs_dq_wg
// and bs_dkv_wg instead: persistent, TMA-fed, on wgmma (the sections
// "Hopper: dK/dV" and "Hopper: forward and dQ" below).
// f32: CUDA-core FMAs (no TF32), 64 rows per CTA with 2, 4 or 8 threads
// per row (widths 32, 64, 96, 128, 192, 256).

#include "attention_tile.cuh"
#include "attention_wide.cuh"
#include "hopper.cuh"

#include <type_traits>

namespace {

using namespace tile;

constexpr float NEG_INF = -1e30f;
constexpr float LOG2E = 1.4426950408889634f;
constexpr int T = 64;             // the schedule's query and key tile
constexpr int NTHREADS = 128;     // 16-bit CTA: 4 warps x 16 rows
constexpr int LAYOUT_BIT = 1;     // the tile needs the fine layout lookup
constexpr int POS_BIT = 2;        // ... causal, window or the ragged edge

struct Params {
  const void* q;
  const void* k;
  const void* v;
  const void* dout;
  const float* lse_in;            // [B*H, S] (backward)
  const float* delta;             // [B*H, S] (backward)
  const uint8_t* layout;          // [H, nf, nf] or null (layout_exact off)
  const int* ptr;                 // [H * nT + 1] list offsets
  const int* idx;                 // listed tiles
  const int* flags;               // one flag word per listed tile
  const int* order;               // [H * nT]: each head's tiles, longest list first
  const int* cta_ptr;             // wgmma kernels: each CTA's (h * nT + t)
  const int* cta_items;           // items, CSR, balanced on the host
  const int* bits;                // wgmma forward, dq: each listed tile's
                                  // fine layout, 64 bits (mask_bits)
  void* o;
  float* lse;
  void* dq;
  void* dk;
  void* dv;
  int H, S, D, nT, nf, fine, causal, window;
  float sm_scale;
};

// the positional part of the pattern: the ragged edge, causal, the window
__device__ __forceinline__ bool pos_live(const Params& p, int row, int key) {
  return row < p.S && key < p.S && (!p.causal || key <= row) &&
         (p.window <= 0 || row - key < p.window);
}

// whether entry (row, key) of a flagged tile is live (the f32 kernels)
__device__ __forceinline__ bool live(const Params& p, int h, int flags,
                                     int row, int key) {
  if ((flags & POS_BIT) && !pos_live(p, row, key)) return false;
  if (flags & LAYOUT_BIT)
    return p.layout[((size_t)h * p.nf + row / p.fine) * p.nf + key / p.fine] != 0;
  return true;
}

// -1e30 on the dead entries of a flagged 16 x (8 * NJ) score tile of the
// mma.sync layout: the thread's rows a0 / a1 and its columns b0 + 8 j +
// cq + {0, 1}. QMAJOR: rows are queries and columns keys (the forward,
// dq); else rows are keys and columns queries (dk/dv, S^T). The 8
// columns of a group share one layout block, so a thread reads one
// layout byte a row and group.
template <int NJ, bool QMAJOR>
__device__ __forceinline__ void mask_tile(float (*s)[4], const Params& p,
                                          int h, int fl, int a0, int a1,
                                          int b0, int cq) {
  const uint8_t* lay = nullptr;
  int ab0 = 0, ab1 = 0;
  if (fl & LAYOUT_BIT) {
    lay = p.layout + (size_t)h * p.nf * p.nf;
    ab0 = min(a0, p.S - 1) / p.fine;
    ab1 = min(a1, p.S - 1) / p.fine;
  }
#pragma unroll
  for (int j = 0; j < NJ; ++j) {
    const int bg = b0 + j * 8;
    bool in0 = true, in1 = true;
    if (fl & LAYOUT_BIT) {
      const int bb = min(bg, p.S - 1) / p.fine;
      in0 = (QMAJOR ? lay[(size_t)ab0 * p.nf + bb] : lay[(size_t)bb * p.nf + ab0]) != 0;
      in1 = (QMAJOR ? lay[(size_t)ab1 * p.nf + bb] : lay[(size_t)bb * p.nf + ab1]) != 0;
    }
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const int a = c < 2 ? a0 : a1, b = bg + cq + (c & 1);
      bool keep = c < 2 ? in0 : in1;
      if (fl & POS_BIT) keep = keep && (QMAJOR ? pos_live(p, a, b) : pos_live(p, b, a));
      if (!keep) s[j][c] = NEG_INF;
    }
  }
}

// -1e30 on the dead entries of a flagged 64 x 64 score tile of the wgmma
// forward and dQ (rows queries, columns keys): the fine layout from the
// tile's 64-bit word (lo, hi: bit 8 rg + kg set when rows 8 rg.. and keys
// 8 kg.. of the tile are live in the layout; made on the host, read by the
// producer, so the consumers make no device-memory read), then causal, the
// window and the ragged edge. Consumer warp w's rows a0 and a1 = a0 + 8
// lie in row groups 2 w and 2 w + 1: bytes 2 w and 2 w + 1 of the word.
__device__ __forceinline__ void mask_bits(float (*s)[4], const Params& p,
                                          int fl, uint32_t lo, uint32_t hi,
                                          int warp, int a0, int a1, int b0,
                                          int cq) {
  const uint32_t w = (fl & LAYOUT_BIT) ? (warp < 2 ? lo : hi) : ~0u;
  const uint32_t g0 = w >> (16 * (warp & 1)), g1 = g0 >> 8;
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const int bg = b0 + j * 8;
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const int a = c < 2 ? a0 : a1, b = bg + cq + (c & 1);
      bool keep = (((c < 2 ? g0 : g1) >> j) & 1) != 0;
      if (fl & POS_BIT) keep = keep && pos_live(p, a, b);
      if (!keep) s[j][c] = NEG_INF;
    }
  }
}

// p from the saved logsumexp; a masked entry is exactly 0
__device__ __forceinline__ float prob(float s, float lse) {
  return s > 0.5f * NEG_INF ? exp2f((s - lse) * LOG2E) : 0.f;
}

// ------------------------------------------------------------ bf16, fp16

// forward for one 64-row query tile over its listed key tiles
template <typename E, int DP, bool EXACT>
__global__ void __launch_bounds__(NTHREADS)
bs_fwd_mma(Params p) {
  constexpr int BK = T, LD = DP + 8, TILE = BK * LD;
  constexpr bool OWN_SMEM = OwnA<E, DP>::SMEM;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  E* sm = reinterpret_cast<E*>(smem_raw);
  const int bh = blockIdx.x, h = bh % p.H;
  const int qt = p.order[h * p.nT + blockIdx.y];  // the longest lists first
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int r0 = qt * T + warp * 16 + lane / 4, r1 = r0 + 8;
  const int cq = (lane % 4) * 2;
  const size_t off = (size_t)bh * p.S;
  const int D = EXACT ? DP : p.D;

  OwnA<E, DP> qa;                                // Q, the A operand
  own_load<E, DP>(qa, static_cast<const E*>(p.q) + off * D, sm + 4 * TILE,
                  qt * T, r0, r1, p.S, D, cq, tid);
  if (OWN_SMEM) cp_async_commit();               // waited for with tile e0
  float of[DP / 8][4];
#pragma unroll
  for (int n = 0; n < DP / 8; ++n) of[n][0] = of[n][1] = of[n][2] = of[n][3] = 0.f;
  float m[2] = {NEG_INF, NEG_INF}, l[2] = {0.f, 0.f};   // l: this thread's part

  const int e0 = p.ptr[h * p.nT + qt], e1 = p.ptr[h * p.nT + qt + 1];
  const E* kb = static_cast<const E*>(p.k) + off * D;
  const E* vb = static_cast<const E*>(p.v) + off * D;
  auto load = [&](int k0, int stage) {
    load_pair<E, DP, BK, NTHREADS>(sm + 2 * stage * TILE, kb, vb, k0, p.S, D,
                                   tid);
    cp_async_commit();
  };
  if (e0 < e1) load(p.idx[e0] * BK, 0);

  for (int e = e0; e < e1; ++e) {
    const int k0 = p.idx[e] * BK, fl = p.flags[e], stage = (e - e0) & 1;
    if (e + 1 < e1) {
      load(p.idx[e + 1] * BK, stage ^ 1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const E* Ks = sm + 2 * stage * TILE;
    const E* Vs = Ks + TILE;
    float sf[BK / 8][4];
    mma_abt<E, DP, BK, LD>(sf, qa, Ks, lane);       // S = Q K^T
#pragma unroll
    for (int j = 0; j < BK / 8; ++j)
#pragma unroll
      for (int c = 0; c < 4; ++c) sf[j][c] *= p.sm_scale;
    if (fl != 0) mask_tile<BK / 8, true>(sf, p, h, fl, r0, r1, k0, cq);
    // online softmax for the thread's two rows (a row spans a lane quad);
    // the rescale takes the difference first, so m == mx == -1e30 (no live
    // key yet) gives exactly 1
#pragma unroll
    for (int rr = 0; rr < 2; ++rr) {
      float mx = m[rr];
#pragma unroll
      for (int j = 0; j < BK / 8; ++j)
        mx = fmaxf(mx, fmaxf(sf[j][2 * rr], sf[j][2 * rr + 1]));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      const float mxl = mx * LOG2E;
      const float alpha = exp2f((m[rr] - mx) * LOG2E);
      float ps = 0.f;
#pragma unroll
      for (int j = 0; j < BK / 8; ++j)
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
      for (int n = 0; n < DP / 8; ++n) {
        of[n][2 * rr] *= alpha;
        of[n][2 * rr + 1] *= alpha;
      }
    }
    mma_ab<E, DP, BK, LD>(of, sf, Vs, lane);         // O += P V
    __syncthreads();                            // the stage is refilled next
  }
  if (OWN_SMEM) cp_async_wait<0>();              // an empty list: not waited for

  float inv[2];
#pragma unroll
  for (int rr = 0; rr < 2; ++rr) {
    float lt = l[rr];
    lt += __shfl_xor_sync(0xffffffffu, lt, 1);
    lt += __shfl_xor_sync(0xffffffffu, lt, 2);
    inv[rr] = 1.f / (lt == 0.f ? 1.f : lt);      // a dead row writes zeros
    const int row = rr ? r1 : r0;
    if (row < p.S && lane % 4 == 0)
      p.lse[off + row] = m[rr] + logf(fmaxf(lt, 1e-37f));
  }
  store_rows<E, DP>(static_cast<E*>(p.o) + off * D, of, r0, r1, p.S, D, cq,
                    inv[0], inv[1]);
}

// dQ for one 64-row query tile over its listed key tiles
template <typename E, int DP, bool EXACT>
__global__ void __launch_bounds__(NTHREADS)
bs_dq_mma(Params p) {
  constexpr int BK = T, LD = DP + 8, TILE = BK * LD;
  constexpr bool OWN_SMEM = OwnA<E, DP>::SMEM;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  E* sm = reinterpret_cast<E*>(smem_raw);
  const int bh = blockIdx.x, h = bh % p.H;
  const int qt = p.order[h * p.nT + blockIdx.y];
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int r0 = qt * T + warp * 16 + lane / 4, r1 = r0 + 8;
  const int cq = (lane % 4) * 2;
  const size_t off = (size_t)bh * p.S;
  const int D = EXACT ? DP : p.D;

  OwnA<E, DP> qa, da;                            // Q and dO, the A operands
  own_load<E, DP>(qa, static_cast<const E*>(p.q) + off * D, sm + 4 * TILE,
                  qt * T, r0, r1, p.S, D, cq, tid);
  own_load<E, DP>(da, static_cast<const E*>(p.dout) + off * D,
                  sm + 4 * TILE + 64 * LD, qt * T, r0, r1, p.S, D, cq, tid);
  if (OWN_SMEM) cp_async_commit();               // waited for with tile e0
  float lse[2], dlt[2];
  lse[0] = r0 < p.S ? p.lse_in[off + r0] : 0.f;
  lse[1] = r1 < p.S ? p.lse_in[off + r1] : 0.f;
  dlt[0] = r0 < p.S ? p.delta[off + r0] : 0.f;
  dlt[1] = r1 < p.S ? p.delta[off + r1] : 0.f;
  float acc[DP / 8][4];
#pragma unroll
  for (int n = 0; n < DP / 8; ++n) acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;

  const int e0 = p.ptr[h * p.nT + qt], e1 = p.ptr[h * p.nT + qt + 1];
  const E* kb = static_cast<const E*>(p.k) + off * D;
  const E* vb = static_cast<const E*>(p.v) + off * D;
  auto load = [&](int k0, int stage) {
    load_pair<E, DP, BK, NTHREADS>(sm + 2 * stage * TILE, kb, vb, k0, p.S, D,
                                   tid);
    cp_async_commit();
  };
  if (e0 < e1) load(p.idx[e0] * BK, 0);

  for (int e = e0; e < e1; ++e) {
    const int k0 = p.idx[e] * BK, fl = p.flags[e], stage = (e - e0) & 1;
    if (e + 1 < e1) {
      load(p.idx[e + 1] * BK, stage ^ 1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const E* Ks = sm + 2 * stage * TILE;
    const E* Vs = Ks + TILE;
    float sf[BK / 8][4], dp[BK / 8][4];
    mma_abt<E, DP, BK, LD>(sf, qa, Ks, lane);       // S = Q K^T
    mma_abt<E, DP, BK, LD>(dp, da, Vs, lane);       // dP = dO V^T
#pragma unroll
    for (int j = 0; j < BK / 8; ++j)
#pragma unroll
      for (int c = 0; c < 4; ++c) sf[j][c] *= p.sm_scale;
    if (fl != 0) mask_tile<BK / 8, true>(sf, p, h, fl, r0, r1, k0, cq);
#pragma unroll
    for (int j = 0; j < BK / 8; ++j)
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int rr = c >> 1;
        sf[j][c] = prob(sf[j][c], lse[rr]) * (dp[j][c] - dlt[rr]) * p.sm_scale;  // dS
      }
    mma_ab<E, DP, BK, LD>(acc, sf, Ks, lane);       // dQ += dS K
    __syncthreads();
  }
  if (OWN_SMEM) cp_async_wait<0>();              // an empty list: not waited for
  store_rows<E, DP>(static_cast<E*>(p.dq) + off * D, acc, r0, r1, p.S, D, cq);
}

// dK and dV for one 64-row key tile over its listed query tiles, each
// taken in 64 / BQ steps of BQ rows, with Q, dO and the rows' lse and
// delta double-buffered in shared memory
template <typename E, int DP, int BQ, bool EXACT>
__global__ void __launch_bounds__(NTHREADS)
bs_dkv_mma(Params p) {
  constexpr int LD = DP + 8, TILE = BQ * LD, SUB = T / BQ;
  constexpr bool OWN_SMEM = OwnA<E, DP>::SMEM;
  constexpr int DO = OWN_SMEM ? DP / 2 : DP;     // columns accumulated here
  extern __shared__ __align__(16) unsigned char smem_raw[];
  E* sm = reinterpret_cast<E*>(smem_raw);
  __shared__ float rows_s[2][2][BQ];           // [stage][lse, delta][query]
  const int bh = blockIdx.x, h = bh % p.H;
  const int kt = p.order[h * p.nT + blockIdx.y];
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int r0 = kt * T + warp * 16 + lane / 4, r1 = r0 + 8;   // keys
  const int cq = (lane % 4) * 2;
  const size_t off = (size_t)bh * p.S;
  const int D = EXACT ? DP : p.D;

  const int c0 = blockIdx.z * DO;
  OwnA<E, DP> ka, va;                            // K and V, the A operands
  own_load<E, DP>(ka, static_cast<const E*>(p.k) + off * D, sm + 4 * TILE,
                  kt * T, r0, r1, p.S, D, cq, tid);
  own_load<E, DP>(va, static_cast<const E*>(p.v) + off * D,
                  sm + 4 * TILE + 64 * LD, kt * T, r0, r1, p.S, D, cq, tid);
  if (OWN_SMEM) cp_async_commit();               // waited for with step 0
  float dk[DO / 8][4], dv[DO / 8][4];
#pragma unroll
  for (int n = 0; n < DO / 8; ++n)
#pragma unroll
    for (int c = 0; c < 4; ++c) dk[n][c] = dv[n][c] = 0.f;

  const int e0 = p.ptr[h * p.nT + kt], e1 = p.ptr[h * p.nT + kt + 1];
  const int steps = (e1 - e0) * SUB;
  const E* qb = static_cast<const E*>(p.q) + off * D;
  const E* db = static_cast<const E*>(p.dout) + off * D;
  auto first_row = [&](int s) { return p.idx[e0 + s / SUB] * T + (s % SUB) * BQ; };
  auto load = [&](int s, int stage) {
    const int q0 = first_row(s);
    for (int i = tid; i < BQ; i += NTHREADS) {
      const bool in = q0 + i < p.S;
      rows_s[stage][0][i] = in ? p.lse_in[off + q0 + i] : 0.f;
      rows_s[stage][1][i] = in ? p.delta[off + q0 + i] : 0.f;
    }
    load_pair<E, DP, BQ, NTHREADS>(sm + 2 * stage * TILE, qb, db, q0, p.S, D,
                                   tid);
    cp_async_commit();
  };
  if (steps > 0) load(0, 0);

  for (int s = 0; s < steps; ++s) {
    const int q0 = first_row(s), fl = p.flags[e0 + s / SUB], stage = s & 1;
    if (s + 1 < steps) {
      load(s + 1, stage ^ 1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const E* Qs = sm + 2 * stage * TILE;
    const E* Ds = Qs + TILE;
    const float* lse = rows_s[stage][0];
    const float* dlt = rows_s[stage][1];
    float st[BQ / 8][4], dpt[BQ / 8][4];
    mma_abt<E, DP, BQ, LD>(st, ka, Qs, lane);      // S^T = K Q^T
    mma_abt<E, DP, BQ, LD>(dpt, va, Ds, lane);     // dP^T = V dO^T
#pragma unroll
    for (int j = 0; j < BQ / 8; ++j)
#pragma unroll
      for (int c = 0; c < 4; ++c) st[j][c] *= p.sm_scale;
    if (fl != 0) mask_tile<BQ / 8, false>(st, p, h, fl, r0, r1, q0, cq);
#pragma unroll
    for (int j = 0; j < BQ / 8; ++j)
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int qi = j * 8 + cq + (c & 1);
        const float pr = prob(st[j][c], lse[qi]);
        st[j][c] = pr;                                          // P^T
        dpt[j][c] = pr * (dpt[j][c] - dlt[qi]) * p.sm_scale;    // dS^T
      }
    mma_ab<E, DO, BQ, LD>(dv, st, Ds + c0, lane);  // dV += P^T dO
    mma_ab<E, DO, BQ, LD>(dk, dpt, Qs + c0, lane); // dK += dS^T Q
    __syncthreads();                           // the stage is refilled next
  }
  if (OWN_SMEM) cp_async_wait<0>();              // an empty list: not waited for
  store_rows<E, DO>(static_cast<E*>(p.dk) + off * D, dk, r0, r1, p.S, D, cq,
                    1.f, 1.f, c0);
  store_rows<E, DO>(static_cast<E*>(p.dv) + off * D, dv, r0, r1, p.S, D, cq,
                    1.f, 1.f, c0);
}

// ------------------------------------------------------------------- f32

// 64 rows per CTA, TPR threads per row, each owning the float4 slices
// i*TPR + t (i < NV) of its row: neighbouring threads on neighbouring
// addresses
template <int DP> struct F32 {
  static constexpr int TPR = DP > 128 ? 8 : DP == 128 ? 4 : 2;
  static constexpr int DPT = DP / TPR;           // dims a thread owns
  static constexpr int NV = DPT / 4;
  static constexpr int NT = T * TPR;            // threads per CTA
  static constexpr int SUBT = DP > 128 ? 16 : 32;   // rows of a shared sub-tile
};

template <int DP>
__device__ __forceinline__ void load_slices(float* dst, const float* row,
                                            int t, int D) {
  using L = F32<DP>;
#pragma unroll
  for (int i = 0; i < L::NV; ++i) {
    const float4 x = load_f4(row, 4 * (i * L::TPR + t), D);
    dst[4 * i] = x.x; dst[4 * i + 1] = x.y; dst[4 * i + 2] = x.z; dst[4 * i + 3] = x.w;
  }
}

template <int DP>
__device__ __forceinline__ void store_slices(float* row, const float* src,
                                             int t, int D, float scale) {
  using L = F32<DP>;
#pragma unroll
  for (int i = 0; i < L::NV; ++i)
    if (4 * (i * L::TPR + t) < D)
      *reinterpret_cast<float4*>(row + 4 * (i * L::TPR + t)) =
          make_float4(src[4 * i] * scale, src[4 * i + 1] * scale,
                      src[4 * i + 2] * scale, src[4 * i + 3] * scale);
}

// the dot products of this thread's slices with one shared row (a with
// x, b with y), summed over the row's TPR threads
template <int DP>
__device__ __forceinline__ void dot2(const float* a, const float* x,
                                     const float* b, const float* y, int t,
                                     float* ax, float* by) {
  using L = F32<DP>;
  float s = 0.f, d = 0.f;
#pragma unroll
  for (int i = 0; i < L::NV; ++i) {
    const float4 u = *reinterpret_cast<const float4*>(x + 4 * (i * L::TPR + t));
    const float4 w = *reinterpret_cast<const float4*>(y + 4 * (i * L::TPR + t));
    s = fmaf(a[4 * i], u.x, s); s = fmaf(a[4 * i + 1], u.y, s);
    s = fmaf(a[4 * i + 2], u.z, s); s = fmaf(a[4 * i + 3], u.w, s);
    d = fmaf(b[4 * i], w.x, d); d = fmaf(b[4 * i + 1], w.y, d);
    d = fmaf(b[4 * i + 2], w.z, d); d = fmaf(b[4 * i + 3], w.w, d);
  }
#pragma unroll
  for (int m = 1; m < L::TPR; m <<= 1) {
    s += __shfl_xor_sync(0xffffffffu, s, m);
    d += __shfl_xor_sync(0xffffffffu, d, m);
  }
  *ax = s;
  *by = d;
}

// the dot product of this thread's slices with one shared row, summed
// over the row's TPR threads
template <int DP>
__device__ __forceinline__ float dot1(const float* a, const float* x, int t) {
  using L = F32<DP>;
  float s = 0.f;
#pragma unroll
  for (int i = 0; i < L::NV; ++i) {
    const float4 u = *reinterpret_cast<const float4*>(x + 4 * (i * L::TPR + t));
    s = fmaf(a[4 * i], u.x, s); s = fmaf(a[4 * i + 1], u.y, s);
    s = fmaf(a[4 * i + 2], u.z, s); s = fmaf(a[4 * i + 3], u.w, s);
  }
#pragma unroll
  for (int m = 1; m < L::TPR; m <<= 1) s += __shfl_xor_sync(0xffffffffu, s, m);
  return s;
}

// acc += w * this thread's slices of the shared row x
template <int DP>
__device__ __forceinline__ void axpy(float* acc, float w, const float* x,
                                     int t) {
  using L = F32<DP>;
#pragma unroll
  for (int i = 0; i < L::NV; ++i) {
    const float4 u = *reinterpret_cast<const float4*>(x + 4 * (i * L::TPR + t));
    acc[4 * i] = fmaf(w, u.x, acc[4 * i]);
    acc[4 * i + 1] = fmaf(w, u.y, acc[4 * i + 1]);
    acc[4 * i + 2] = fmaf(w, u.z, acc[4 * i + 2]);
    acc[4 * i + 3] = fmaf(w, u.w, acc[4 * i + 3]);
  }
}

// rows [i0, i0 + SUBT) of two [n, D] f32 matrices into shared tiles of
// width DP; rows past n and columns past D read zeros
template <int DP>
__device__ __forceinline__ void load_f32_pair(float* da, float* db,
                                              const float* a, const float* b,
                                              int i0, int n, int D,
                                              int tid) {
  using L = F32<DP>;
  for (int idx = tid; idx < L::SUBT * DP / 4; idx += L::NT) {
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
__global__ void __launch_bounds__(F32<DP>::NT)
bs_fwd_f32(Params p) {
  using L = F32<DP>;
  constexpr int BK = L::SUBT;
  __shared__ __align__(16) float Ks[BK * DP];
  __shared__ __align__(16) float Vs[BK * DP];
  const int bh = blockIdx.x, h = bh % p.H;
  const int qt = p.order[h * p.nT + blockIdx.y];
  const int tid = threadIdx.x, t = tid % L::TPR;
  const int row = qt * T + tid / L::TPR;
  const size_t off = (size_t)bh * p.S;
  const int D = p.D;
  const float* kb = static_cast<const float*>(p.k) + off * D;
  const float* vb = static_cast<const float*>(p.v) + off * D;
  float qv[L::DPT], acc[L::DPT];
  load_slices<DP>(qv, static_cast<const float*>(p.q) + (off + min(row, p.S - 1)) * D,
                  t, D);
#pragma unroll
  for (int i = 0; i < L::DPT; ++i) acc[i] = 0.f;
  float m = NEG_INF, l = 0.f;

  const int e0 = p.ptr[h * p.nT + qt], e1 = p.ptr[h * p.nT + qt + 1];
  for (int e = e0; e < e1; ++e) {
    const int fl = p.flags[e];
    for (int k0 = p.idx[e] * T; k0 < min(p.idx[e] * T + T, p.S); k0 += BK) {
      __syncthreads();
      load_f32_pair<DP>(Ks, Vs, kb, vb, k0, p.S, D, tid);
      __syncthreads();
      float sc[BK];
      float mx = m;
#pragma unroll
      for (int kk = 0; kk < BK; ++kk) {
        float s = dot1<DP>(qv, &Ks[kk * DP], t) * p.sm_scale;
        if (fl != 0 && !live(p, h, fl, row, k0 + kk)) s = NEG_INF;
        sc[kk] = s;
        mx = fmaxf(mx, s);
      }
      const float alpha = expf(m - mx);
      float ps = 0.f;
#pragma unroll
      for (int kk = 0; kk < BK; ++kk) {
        sc[kk] = sc[kk] > 0.5f * NEG_INF ? expf(sc[kk] - mx) : 0.f;
        ps += sc[kk];
      }
      l = l * alpha + ps;
      m = mx;
#pragma unroll
      for (int i = 0; i < L::DPT; ++i) acc[i] *= alpha;
#pragma unroll
      for (int kk = 0; kk < BK; ++kk) axpy<DP>(acc, sc[kk], &Vs[kk * DP], t);
    }
  }
  if (row < p.S) {
    const float ls = l == 0.f ? 1.f : l;        // a dead row writes zeros
    store_slices<DP>(static_cast<float*>(p.o) + (off + row) * D, acc, t, D,
                     1.f / ls);
    if (t == 0) p.lse[off + row] = m + logf(fmaxf(l, 1e-37f));
  }
}

template <int DP>
__global__ void __launch_bounds__(F32<DP>::NT)
bs_dq_f32(Params p) {
  using L = F32<DP>;
  constexpr int BK = L::SUBT;
  __shared__ __align__(16) float Ks[BK * DP];
  __shared__ __align__(16) float Vs[BK * DP];
  const int bh = blockIdx.x, h = bh % p.H;
  const int qt = p.order[h * p.nT + blockIdx.y];
  const int tid = threadIdx.x, t = tid % L::TPR;
  const int row = qt * T + tid / L::TPR, rc = min(row, p.S - 1);
  const size_t off = (size_t)bh * p.S;
  const int D = p.D;
  const float* kb = static_cast<const float*>(p.k) + off * D;
  const float* vb = static_cast<const float*>(p.v) + off * D;
  float qv[L::DPT], dov[L::DPT], acc[L::DPT];
  load_slices<DP>(qv, static_cast<const float*>(p.q) + (off + rc) * D, t,
                  D);
  load_slices<DP>(dov, static_cast<const float*>(p.dout) + (off + rc) * D, t,
                  D);
#pragma unroll
  for (int i = 0; i < L::DPT; ++i) acc[i] = 0.f;
  const float lse = p.lse_in[off + rc], dlt = p.delta[off + rc];

  const int e0 = p.ptr[h * p.nT + qt], e1 = p.ptr[h * p.nT + qt + 1];
  for (int e = e0; e < e1; ++e) {
    const int fl = p.flags[e];
    for (int k0 = p.idx[e] * T; k0 < min(p.idx[e] * T + T, p.S); k0 += BK) {
      __syncthreads();
      load_f32_pair<DP>(Ks, Vs, kb, vb, k0, p.S, D, tid);
      __syncthreads();
      for (int kk = 0; kk < BK; ++kk) {
        float s, dp;
        dot2<DP>(qv, &Ks[kk * DP], dov, &Vs[kk * DP], t, &s, &dp);
        s *= p.sm_scale;
        if (fl != 0 && !live(p, h, fl, row, k0 + kk)) s = NEG_INF;
        axpy<DP>(acc, prob(s, lse) * (dp - dlt) * p.sm_scale, &Ks[kk * DP], t);
      }
    }
  }
  if (row < p.S)
    store_slices<DP>(static_cast<float*>(p.dq) + (off + row) * D, acc, t, D,
                     1.f);
}

template <int DP>
__global__ void __launch_bounds__(F32<DP>::NT)
bs_dkv_f32(Params p) {
  using L = F32<DP>;
  constexpr int BQ = L::SUBT;
  __shared__ __align__(16) float Qs[BQ * DP];
  __shared__ __align__(16) float Ds[BQ * DP];
  __shared__ float Ls[BQ], Es[BQ];
  const int bh = blockIdx.x, h = bh % p.H;
  const int kt = p.order[h * p.nT + blockIdx.y];
  const int tid = threadIdx.x, t = tid % L::TPR;
  const int key = kt * T + tid / L::TPR, kc = min(key, p.S - 1);
  const size_t off = (size_t)bh * p.S;
  const int D = p.D;
  const float* qb = static_cast<const float*>(p.q) + off * D;
  const float* db = static_cast<const float*>(p.dout) + off * D;
  float kv[L::DPT], vv[L::DPT], dk[L::DPT], dv[L::DPT];
  load_slices<DP>(kv, static_cast<const float*>(p.k) + (off + kc) * D, t,
                  D);
  load_slices<DP>(vv, static_cast<const float*>(p.v) + (off + kc) * D, t,
                  D);
#pragma unroll
  for (int i = 0; i < L::DPT; ++i) dk[i] = dv[i] = 0.f;

  const int e0 = p.ptr[h * p.nT + kt], e1 = p.ptr[h * p.nT + kt + 1];
  for (int e = e0; e < e1; ++e) {
    const int fl = p.flags[e];
    for (int q0 = p.idx[e] * T; q0 < min(p.idx[e] * T + T, p.S); q0 += BQ) {
      __syncthreads();
      load_f32_pair<DP>(Qs, Ds, qb, db, q0, p.S, D, tid);
      for (int i = tid; i < BQ; i += L::NT) {
        const bool in = q0 + i < p.S;
        Ls[i] = in ? p.lse_in[off + q0 + i] : 0.f;
        Es[i] = in ? p.delta[off + q0 + i] : 0.f;
      }
      __syncthreads();
      for (int qq = 0; qq < BQ; ++qq) {
        float s, dp;
        dot2<DP>(kv, &Qs[qq * DP], vv, &Ds[qq * DP], t, &s, &dp);
        s *= p.sm_scale;
        if (fl != 0 && !live(p, h, fl, q0 + qq, key)) s = NEG_INF;
        const float pr = prob(s, Ls[qq]);
        axpy<DP>(dv, pr, &Ds[qq * DP], t);
        axpy<DP>(dk, pr * (dp - Es[qq]) * p.sm_scale, &Qs[qq * DP], t);
      }
    }
  }
  if (key < p.S) {
    store_slices<DP>(static_cast<float*>(p.dk) + (off + key) * D, dk, t, D,
                     1.f);
    store_slices<DP>(static_cast<float*>(p.dv) + (off + key) * D, dv, t, D,
                     1.f);
  }
}

// ----------------------------------------------- Hopper: dK/dV, wgmma

// The long leg's dK/dV call (16-bit, D 64) in the shape of
// flash_attention_bwd.cu's flash_bwd_dkv_wg, walking the CSR lists:
// * Persistent CTAs, two an SM, each a consumer warpgroup and a producer
//   warpgroup that keeps 40 registers a thread and hands the consumers
//   216 (setmaxnreg; at the 168 of a 160-thread CTA the consumers
//   spilled 64-124 bytes and took 1.25-1.32x as long, PERF.md). Each CTA
//   takes a list of (head, key tile) items, each for every batch row,
//   balanced on the host
//   (ops/block_sparse_attention.py, balance: longest processing time first
//   over each item's tile count). The fixed layout's dK/dV lists run from
//   1 to 61 tiles; dealt round-robin, the CTAs that drew the long ones
//   took 1.5x the mean.
// * The producer's first warp reads every list entry and row the
//   consumers would otherwise wait on: an item's head, key tile and list
//   length go to shared memory beside its own K and V tiles (TMA, two own
//   slots, so the next item's land while this one's last products and
//   epilogue run), and each listed query tile's flags and first row beside
//   its Q and dO (TMA) and its lse and delta rows (plain loads, made
//   before the slot is waited for) in a ring of DKV_STAGES slots signalled
//   full and freed through mbarriers. The ring runs on across items, so a
//   short list does not drain it.
// * The consumers compute S^T = K Q^T and dP^T = V dO^T (wgmma, both
//   operands in shared memory, 128-byte swizzle), then P^T and dS^T in
//   registers, then dV += P^T dO and dK += dS^T Q with the register A
//   operand. A tile whose flag word has LAYOUT_BIT or POS_BIT is masked,
//   one branch a tile; the rest run no mask code.
// * Tile e's dV / dK products and tile e + 1's S^T / dP^T products are
//   issued as one group, so the warpgroup waits on the tensor cores once
//   a tile.
// The arithmetic is bs_dkv_mma's up to rounding: the same products with P
// and dS rounded to the element type, p = exp(s sm_scale - lse) taken as
// one FFMA and one EX2 and dS = p (dp sm_scale - delta sm_scale) as one
// FFMA and one FMUL, with lse log2(e) and delta sm_scale made once a
// query row by the producer.

using hopper::Wgmma;
using hopper::ERR_TENSOR_MAP;

// 2^x by the SFU (ex2.approx.ftz: about 2 ulp); -huge gives exactly 0
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

constexpr int DKV_WG = 128;               // consumer threads
constexpr int DKV_THREADS = 2 * DKV_WG;   // and the producer warpgroup
constexpr int DKV_STAGES = 3;
// registers a thread after setmaxnreg: two CTAs an SM of 256 threads start
// at 128; the producer warpgroup hands 88 of them to the consumers
constexpr int DKV_PRODUCER_REGS = 40;
constexpr int DKV_CONSUMER_REGS = 216;
constexpr int DKV_TILE = 64 * 64;         // one 64 x 64 16-bit tile, 8 KB

struct DkvMaps {                          // [BH, S, 64] tensor maps
  CUtensorMap q, k, v, dout;
};

// two own slots of K and V, DKV_STAGES ring slots of Q and dO (99 KB: two
// CTAs an SM), their lse and delta rows, the barriers, the items' and
// entries' metadata; 1024 bytes of slack for the alignment
constexpr size_t DKV_SMEM = 1024 + 2 * DKV_TILE * (4 + 2 * DKV_STAGES) +
                            sizeof(float) * 128 * DKV_STAGES +
                            sizeof(uint64_t) * (2 * DKV_STAGES + 4) +
                            sizeof(int) * (2 * DKV_STAGES + 8);

template <typename E>
__global__ void __launch_bounds__(DKV_THREADS, 2)
bs_dkv_wg(const __grid_constant__ DkvMaps maps, Params p, int BH) {
  using namespace hopper;
  extern __shared__ unsigned char smem_raw[];
  E* own = reinterpret_cast<E*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  E* ring = own + 4 * DKV_TILE;             // [stage][Q, dO]
  float* rows = reinterpret_cast<float*>(ring + 2 * DKV_STAGES * DKV_TILE);
  uint64_t* full = reinterpret_cast<uint64_t*>(rows + 128 * DKV_STAGES);
  uint64_t* empty = full + DKV_STAGES;
  uint64_t* own_full = empty + DKV_STAGES;  // [2]
  uint64_t* own_empty = own_full + 2;       // [2]
  int* meta = reinterpret_cast<int*>(own_empty + 2);  // [stage][flags, q0]
  int* imeta = meta + 2 * DKV_STAGES;       // [own slot][bh, h, kt, count]
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  // this CTA's items: its (head, key tile) list, each for every batch row
  const int B = BH / p.H, c0 = p.cta_ptr[blockIdx.x];
  const int items = (p.cta_ptr[blockIdx.x + 1] - c0) * B;
  if (tid == 0) {
    for (int i = 0; i < DKV_STAGES; ++i) {
      mbar_init(&full[i], 32);
      mbar_init(&empty[i], DKV_WG);
    }
    for (int i = 0; i < 2; ++i) {
      mbar_init(&own_full[i], 1);
      mbar_init(&own_empty[i], DKV_WG);
    }
    fence_mbar_init();
  }
  __syncthreads();

  // the role through a shuffle, so the compiler sees it uniform (a wgmma
  // in a path it cannot prove uniform is serialized)
  const int wg = __shfl_sync(0xffffffffu, tid / DKV_WG, 0);
  if (wg == 1) {                            // the producer warpgroup
    regs_dealloc<DKV_PRODUCER_REGS>();
    if (warp > 4) return;                   // its first warp produces
    // every device-memory read the consumers would wait on is made here:
    // the item's head, key tile and list length go beside its own tiles,
    // each ring entry's flags and query tile beside its rows; the list's
    // entries are read 32 at a time (a lane each) and the rows before the
    // slot is waited for
    int i = 0;                              // ring entries so far
    for (int n = 0; n < items; ++n) {
      const int hk = p.cta_items[c0 + n / B], h = hk / p.nT, kt = hk % p.nT;
      const int bh = (n % B) * p.H + h;
      const int e0 = p.ptr[hk], e1 = p.ptr[hk + 1];
      const int os = n & 1;
      if (lane == 0) {
        if (n >= 2) mbar_wait(&own_empty[os], ((n >> 1) & 1) ^ 1);
        int* im = imeta + 4 * os;
        im[0] = bh;
        im[1] = h;
        im[2] = kt;
        im[3] = e1 - e0;
        E* ks = own + 2 * os * DKV_TILE;
        mbar_arrive_expect_tx(&own_full[os], 2 * DKV_TILE * 2);
        tma_tile(ks, &maps.k, &own_full[os], 0, kt * T, bh);
        tma_tile(ks + DKV_TILE, &maps.v, &own_full[os], 0, kt * T, bh);
      }
      const size_t off = (size_t)bh * p.S;
      for (int eb = e0; eb < e1; eb += 32) {
        const bool mine = eb + lane < e1;
        const int tiles = mine ? p.idx[eb + lane] : 0;
        const int flags = mine ? p.flags[eb + lane] : 0;
        for (int j = 0; j < min(32, e1 - eb); ++j, ++i) {
          const int st = i % DKV_STAGES;
          const int q0 = __shfl_sync(0xffffffffu, tiles, j) * T;
          const int fl = __shfl_sync(0xffffffffu, flags, j);
          float r0[2], r1[2];               // lse log2(e), delta sm_scale
#pragma unroll
          for (int u = 0; u < 2; ++u) {
            const int q = q0 + lane + 32 * u;
            r0[u] = q < p.S ? p.lse_in[off + q] * LOG2E : 0.f;
            r1[u] = q < p.S ? p.delta[off + q] * p.sm_scale : 0.f;
          }
          if (i >= DKV_STAGES)
            mbar_wait(&empty[st], ((i / DKV_STAGES) & 1) ^ 1);
          if (lane == 0) {
            E* slot = ring + 2 * st * DKV_TILE;
            meta[2 * st] = fl;
            meta[2 * st + 1] = q0;
            mbar_expect_tx(&full[st], 2 * DKV_TILE * 2);
            tma_tile(slot, &maps.q, &full[st], 0, q0, bh);
            tma_tile(slot + DKV_TILE, &maps.dout, &full[st], 0, q0, bh);
          }
          float* r = rows + st * 128;
#pragma unroll
          for (int u = 0; u < 2; ++u) {
            r[lane + 32 * u] = r0[u];
            r[64 + lane + 32 * u] = r1[u];
          }
          mbar_arrive(&full[st]);
        }
      }
    }
    return;
  }
  regs_alloc<DKV_CONSUMER_REGS>();
  // the consumer warpgroup: key rows kt * 64 + 16 warp + lane / 4 (+ 8),
  // query columns 8 j + 2 (lane % 4) (+ 1) of each accumulator. Tile e's
  // dV / dK products and tile e + 1's S^T / dP^T products go out as one
  // wgmma group, so the tensor cores run them back to back while the
  // warpgroup waits once a tile; P^T and dS^T stay packed in pa / da
  // (their registers are read by the products after the issue) until
  // that group is done.
  const int cq = (lane % 4) * 2;
  const float scl2 = p.sm_scale * LOG2E;
  uint32_t pa[4][4] = {}, da[4][4] = {};
  auto keep = [&]() {                       // pa / da live until here
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
#pragma unroll
      for (int c = 0; c < 4; ++c)
        asm volatile("" :: "r"(pa[kk][c]), "r"(da[kk][c]));
  };
  auto slot = [&](int i) { return ring + 2 * (i % DKV_STAGES) * DKV_TILE; };
  // tile i's P^T and dS^T into pa / da (e: its place in the item's list)
  auto prepare = [&](int i, int e, int h, int r0, int r1, float (*st)[4],
                     float (*dpt)[4], float (*dk)[4], float (*dv)[4]) {
    wg_wait();                              // S^T, dP^T of i; dV, dK of i - 1
    keep();
    fence_acc<8>(st);
    fence_acc<8>(dpt);
    fence_acc<8>(dk);
    fence_acc<8>(dv);
    if (e > 0) mbar_arrive(&empty[(i - 1) % DKV_STAGES]);
    const int* me = meta + 2 * (i % DKV_STAGES);
    const int fl = me[0];
    // p = exp(s sm_scale - lse) as one FFMA and one EX2 (lse2 = lse
    // log2(e)); a masked entry is exactly 0; dS = p (dp sm_scale - delta
    // sm_scale)
    if (fl != 0) mask_tile<8, false>(st, p, h, fl, r0, r1, me[1], cq);
    const float* lse2 = rows + (i % DKV_STAGES) * 128;
    const float* dlts = lse2 + 64;
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int qi = j * 8 + cq + (c & 1);
        const float pr = st[j][c] > 0.5f * NEG_INF
                             ? ex2(fmaf(st[j][c], scl2, -lse2[qi])) : 0.f;
        st[j][c] = pr;                                          // P^T
        dpt[j][c] = pr * fmaf(dpt[j][c], p.sm_scale, -dlts[qi]); // dS^T
      }
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      pack_a<E>(pa[kk], st, kk);
      pack_a<E>(da[kk], dpt, kk);
    }
  };
  auto issue_rs = [&](int i, float (*dk)[4], float (*dv)[4]) {
    const E* Qs = slot(i);
    const uint64_t dd = desc_sw128(Qs + DKV_TILE), dq = desc_sw128(Qs);
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)          // dV += P^T dO
      Wgmma<64>::rs<E>(dv, pa[kk], dd + 128 * kk);
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)          // dK += dS^T Q
      Wgmma<64>::rs<E>(dk, da[kk], dq + 128 * kk);
  };
  int i = 0;
  for (int n = 0; n < items; ++n) {
    const int os = n & 1;
    mbar_wait(&own_full[os], (n >> 1) & 1);
    const int* im = imeta + 4 * os;
    const int bh = im[0], h = im[1], kt = im[2];
    const int count = __shfl_sync(0xffffffffu, im[3], 0);   // uniform
    const int r0 = kt * T + warp * 16 + lane / 4, r1 = r0 + 8;
    float dk[8][4], dv[8][4], st[8][4], dpt[8][4];
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int c = 0; c < 4; ++c) dk[j][c] = dv[j][c] = 0.f;
    const E* Ks = own + 2 * os * DKV_TILE;
    const E* Vs = Ks + DKV_TILE;
    // the first tile's S^T / dP^T alone, then each tile's dV / dK with the
    // next one's S^T / dP^T, then the last tile's dV / dK alone: no wgmma
    // in a branch
    if (count > 0) {
      mbar_wait(&full[i % DKV_STAGES], (i / DKV_STAGES) & 1);
      wg_fence();
      product_ss<E>(st, Ks, slot(i));              // S^T = K Q^T
      product_ss<E>(dpt, Vs, slot(i) + DKV_TILE);  // dP^T = V dO^T
      wg_commit();
      for (int e = 0; e + 1 < count; ++e, ++i) {
        prepare(i, e, h, r0, r1, st, dpt, dk, dv);
        mbar_wait(&full[(i + 1) % DKV_STAGES], ((i + 1) / DKV_STAGES) & 1);
        wg_fence();
        issue_rs(i, dk, dv);
        product_ss<E>(st, Ks, slot(i + 1));
        product_ss<E>(dpt, Vs, slot(i + 1) + DKV_TILE);
        wg_commit();
      }
      prepare(i, count - 1, h, r0, r1, st, dpt, dk, dv);
      wg_fence();
      issue_rs(i, dk, dv);
      wg_commit();
      ++i;
      wg_wait();
      keep();
      fence_acc<8>(dk);
      fence_acc<8>(dv);
      mbar_arrive(&empty[(i - 1) % DKV_STAGES]);
    }
    mbar_arrive(&own_empty[os]);            // K, V and imeta of this slot are read
    const size_t off = (size_t)bh * p.S * 64;
    store_rows<E, 64>(static_cast<E*>(p.dk) + off, dk, r0, r1, p.S, 64, cq);
    store_rows<E, 64>(static_cast<E*>(p.dv) + off, dv, r0, r1, p.S, 64, cq);
  }
}

template <typename E>
int launch_dkv_wg(const Params& p, int BH, cudaStream_t st) {
  const bool bf = std::is_same<E, bf16>::value;
  DkvMaps maps;
  if (!hopper::tile_map(&maps.q, p.q, bf, p.S, BH) ||
      !hopper::tile_map(&maps.k, p.k, bf, p.S, BH) ||
      !hopper::tile_map(&maps.v, p.v, bf, p.S, BH) ||
      !hopper::tile_map(&maps.dout, p.dout, bf, p.S, BH))
    return ERR_TENSOR_MAP;
  static int sms = 0;                       // the host's lists: 2 an SM
  if (sms == 0) {
    int dev = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  }
  const cudaError_t e = cudaFuncSetAttribute(
      bs_dkv_wg<E>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)DKV_SMEM);
  if (e != cudaSuccess) return static_cast<int>(e);
  bs_dkv_wg<E><<<2 * sms, DKV_THREADS, DKV_SMEM, st>>>(maps, p, BH);
  return static_cast<int>(cudaGetLastError());
}

// ------------------------------------ Hopper: forward and dQ, wgmma

// The long leg's forward and dQ calls (16-bit, D 64) in bs_dkv_wg's shape,
// walking the query-tile lists:
// * Persistent CTAs, two an SM, each a consumer warpgroup (64 query rows,
//   216 registers a thread by setmaxnreg) and a producer warpgroup. Each
//   CTA takes a list of (head, query tile) items, each for every batch
//   row, balanced on the host over each item's list length plus a per-item
//   cost (ops/block_sparse_attention.py, Schedule.cta_slots). The PR 4
//   kernels ran one CTA of 4 warps per (b*h, query tile): 2048 CTAs a
//   long-leg launch, each loading its own Q, walking 1-19 key tiles and
//   waiting on its own list reads, with nothing beside its softmax.
// * The producer's first warp makes every device-memory read the consumers
//   would wait on: an item's head, query tile and list length go to shared
//   memory beside its own Q (and dO, and for dQ its rows' lse log2(e) and
//   delta sm_scale) in two own slots, so the next item's land under this
//   one's epilogue; each listed key tile's flags and first key beside its K
//   and V (TMA) in a ring of QWG_STAGES slots signalled full and freed
//   through mbarriers, running on across items. The list's entries are
//   read 32 at a time, a lane each.
// * The forward's consumers compute S = Q K^T (both operands in shared
//   memory, 128-byte swizzle), mask a flagged tile (one branch a tile), run
//   the online softmax on the unscaled scores (exp((s - m) sm_scale) as one
//   FFMA and one EX2), then O += P V with P as the register A operand and V
//   read MN-major. Tile e + 1's S goes out together with tile e's P V, as
//   two wgmma groups: the warpgroup waits for S, runs the softmax while P V
//   runs, then waits for P V before O is rescaled (never while a product
//   into O is in flight). The other CTA on the SM fills the gaps.
// * dQ's consumers compute S = Q K^T and dP = dO V^T, P = exp(s sm_scale -
//   lse) (one FFMA, one EX2; a masked entry exactly 0), dS = P (dp sm_scale
//   - delta sm_scale), rounded and packed as the A operand of dQ += dS K (K
//   read MN-major). Tile e's dS K goes out with tile e + 1's S / dP; dS of
//   tile e + 1 is computed while dS K runs. Each item owns its rows: no
//   atomics, and repeats are bit-identical.
// * A flagged tile is masked from the host's 64-bit word of its fine layout
//   (mask_bits), which the producer puts beside the tile's flags: the
//   consumers make no device-memory read. Looking the layout up in device
//   memory, as mask_tile does, left the forward at the parent's time on
//   DeepSpeed's block-16 layout, whose every tile is masked (PERF.md, PR 9).
// The arithmetic is bs_fwd_mma's and bs_dq_mma's up to rounding.

constexpr int QWG_STAGES = 4;             // K / V ring slots

struct QwgMaps {                          // [BH, S, 64] tensor maps
  CUtensorMap q, k, v, dout;
};

// shared memory of the query-side kernels (DQ: the dQ kernel): two own
// slots of Q (and dO), QWG_STAGES ring slots of K and V (82 KB forward,
// 98 KB dQ: two CTAs an SM), dQ's rows, the barriers, the items' and
// entries' metadata; 1024 bytes of slack for the alignment
template <bool DQ> struct Qwg {
  static constexpr int OWN = DQ ? 2 : 1;  // tiles an item owns
  static constexpr size_t SMEM = 1024 + 2 * DKV_TILE * 2 * (OWN + QWG_STAGES) +
                                 sizeof(float) * 2 * 128 +
                                 sizeof(uint64_t) * (2 * QWG_STAGES + 4) +
                                 sizeof(int) * (4 * QWG_STAGES + 6);
};

template <typename E, bool DQ> struct QwgSmem {
  E* own;                                 // [slot][Q, dO]
  E* ring;                                // [stage][K, V]
  float* rows;                            // [slot][lse log2(e), delta sm_scale]
  uint64_t* full;                         // [stage]
  uint64_t* empty;                        // [stage]
  uint64_t* own_full;                     // [slot]
  uint64_t* own_empty;                    // [slot]
  int* meta;                              // [stage][flags, first key, bits]
  int* imeta;                             // [slot][bh, qt, count]

  __device__ explicit QwgSmem(unsigned char* raw) {
    own = reinterpret_cast<E*>(
        (reinterpret_cast<uintptr_t>(raw) + 1023) & ~uintptr_t(1023));
    ring = own + 2 * Qwg<DQ>::OWN * DKV_TILE;
    rows = reinterpret_cast<float*>(ring + 2 * QWG_STAGES * DKV_TILE);
    full = reinterpret_cast<uint64_t*>(rows + 2 * 128);
    empty = full + QWG_STAGES;
    own_full = empty + QWG_STAGES;
    own_empty = own_full + 2;
    meta = reinterpret_cast<int*>(own_empty + 2);
    imeta = meta + 4 * QWG_STAGES;
  }

  // full: one arrival with the TMA bytes; empty: the consumers; own_full:
  // the producer warp's 32 lanes (dQ's rows) with the bytes
  __device__ void init() const {
    if (threadIdx.x == 0) {
      for (int i = 0; i < QWG_STAGES; ++i) {
        hopper::mbar_init(&full[i], 1);
        hopper::mbar_init(&empty[i], DKV_WG);
      }
      for (int i = 0; i < 2; ++i) {
        hopper::mbar_init(&own_full[i], 32);
        hopper::mbar_init(&own_empty[i], DKV_WG);
      }
      hopper::fence_mbar_init();
    }
    __syncthreads();
  }
};

// this CTA's item count: its (head, query tile) list, each for every
// batch row; item n is list entry n / B of batch row n % B
__device__ __forceinline__ int cta_item_count(const Params& p, int BH) {
  return (p.cta_ptr[blockIdx.x + 1] - p.cta_ptr[blockIdx.x]) * (BH / p.H);
}

// the producer warp of bs_fwd_wg / bs_dq_wg
template <typename E, bool DQ>
__device__ __forceinline__ void q_produce(const QwgMaps& maps,
                                          const Params& p, int BH,
                                          const QwgSmem<E, DQ>& s,
                                          int lane) {
  using namespace hopper;
  constexpr int OWN = Qwg<DQ>::OWN;
  const int B = BH / p.H, c0 = p.cta_ptr[blockIdx.x];
  const int items = cta_item_count(p, BH);
  int i = 0;                                // ring entries so far
  for (int n = 0; n < items; ++n) {
    const int hq = p.cta_items[c0 + n / B], h = hq / p.nT, qt = hq % p.nT;
    const int bh = (n % B) * p.H + h;
    const int e0 = p.ptr[hq], e1 = p.ptr[hq + 1];
    const int os = n & 1;
    float r0[2] = {0.f, 0.f}, r1[2] = {0.f, 0.f};   // dQ: the item's rows
    if constexpr (DQ) {
      const size_t off = (size_t)bh * p.S;
#pragma unroll
      for (int u = 0; u < 2; ++u) {
        const int q = qt * T + lane + 32 * u;
        r0[u] = q < p.S ? p.lse_in[off + q] * LOG2E : 0.f;
        r1[u] = q < p.S ? p.delta[off + q] * p.sm_scale : 0.f;
      }
    }
    if (n >= 2) mbar_wait(&s.own_empty[os], ((n >> 1) & 1) ^ 1);
    if (lane == 0) {
      int* im = s.imeta + 3 * os;
      im[0] = bh;
      im[1] = qt;
      im[2] = e1 - e0;
      E* qs = s.own + OWN * os * DKV_TILE;
      mbar_expect_tx(&s.own_full[os], OWN * DKV_TILE * 2);
      tma_tile(qs, &maps.q, &s.own_full[os], 0, qt * T, bh);
      if constexpr (DQ)
        tma_tile(qs + DKV_TILE, &maps.dout, &s.own_full[os], 0, qt * T, bh);
    }
    if constexpr (DQ) {
      float* r = s.rows + os * 128;
#pragma unroll
      for (int u = 0; u < 2; ++u) {
        r[lane + 32 * u] = r0[u];
        r[64 + lane + 32 * u] = r1[u];
      }
    }
    mbar_arrive(&s.own_full[os]);
    for (int eb = e0; eb < e1; eb += 32) {
      const bool mine = eb + lane < e1;
      const int tiles = mine ? p.idx[eb + lane] : 0;
      const int flags = mine ? p.flags[eb + lane] : 0;
      const int lo = mine ? p.bits[2 * (eb + lane)] : 0;
      const int hi = mine ? p.bits[2 * (eb + lane) + 1] : 0;
      for (int j = 0; j < min(32, e1 - eb); ++j, ++i) {
        const int st = i % QWG_STAGES;
        const int k0 = __shfl_sync(0xffffffffu, tiles, j) * T;
        const int fl = __shfl_sync(0xffffffffu, flags, j);
        const int blo = __shfl_sync(0xffffffffu, lo, j);
        const int bhi = __shfl_sync(0xffffffffu, hi, j);
        if (lane == 0) {
          if (i >= QWG_STAGES)
            mbar_wait(&s.empty[st], ((i / QWG_STAGES) & 1) ^ 1);
          int* me = s.meta + 4 * st;
          me[0] = fl;
          me[1] = k0;
          me[2] = blo;
          me[3] = bhi;
          E* slot = s.ring + 2 * st * DKV_TILE;
          mbar_arrive_expect_tx(&s.full[st], 2 * DKV_TILE * 2);
          tma_tile(slot, &maps.k, &s.full[st], 0, k0, bh);
          tma_tile(slot + DKV_TILE, &maps.v, &s.full[st], 0, k0, bh);
        }
      }
    }
  }
}

template <typename E>
__global__ void __launch_bounds__(DKV_THREADS, 2)
bs_fwd_wg(const __grid_constant__ QwgMaps maps, Params p, int BH) {
  using namespace hopper;
  extern __shared__ unsigned char smem_raw[];
  const QwgSmem<E, false> s(smem_raw);
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  s.init();
  // the role through a shuffle, so the compiler sees it uniform
  const int wg = __shfl_sync(0xffffffffu, tid / DKV_WG, 0);
  if (wg == 1) {                            // the producer warpgroup
    regs_dealloc<DKV_PRODUCER_REGS>();
    if (warp == 4) q_produce<E, false>(maps, p, BH, s, lane);
    return;
  }
  regs_alloc<DKV_CONSUMER_REGS>();
  // the consumer warpgroup: query rows qt * 64 + 16 warp + lane / 4 (+ 8),
  // key columns 8 j + 2 (lane % 4) (+ 1) of the score tile
  const int cq = (lane % 4) * 2;
  const float scl2 = p.sm_scale * LOG2E;
  const int items = cta_item_count(p, BH);
  uint32_t pa[4][4] = {};                   // P of the tile in P V, packed
  auto keep = [&]() {                       // pa lives until here
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
#pragma unroll
      for (int c = 0; c < 4; ++c) asm volatile("" :: "r"(pa[kk][c]));
  };
  auto slot = [&](int t) { return s.ring + 2 * (t % QWG_STAGES) * DKV_TILE; };
  auto full_wait = [&](int t) {
    mbar_wait(&s.full[t % QWG_STAGES], (t / QWG_STAGES) & 1);
  };
  auto issue_pv = [&](int t, float (*of)[4]) {   // O += P V of tile t
    const uint64_t dv = desc_sw128(slot(t) + DKV_TILE);
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) Wgmma<64>::rs<E>(of, pa[kk], dv + 128 * kk);
  };
  int i = 0;                                // ring entries so far
  for (int n = 0; n < items; ++n) {
    const int os = n & 1;
    mbar_wait(&s.own_full[os], (n >> 1) & 1);
    const int* im = s.imeta + 3 * os;
    const int bh = im[0], qt = im[1];
    const int count = __shfl_sync(0xffffffffu, im[2], 0);   // uniform
    const int r0 = qt * T + warp * 16 + lane / 4, r1 = r0 + 8;
    const E* Qs = s.own + os * DKV_TILE;
    float of[8][4], sf[8][4], m[2] = {NEG_INF, NEG_INF}, l[2] = {0.f, 0.f};
    float alpha[2] = {1.f, 1.f};
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int c = 0; c < 4; ++c) of[j][c] = 0.f;
    // tile t's S in sf -> unnormalized P: the mask where the tile's flag
    // asks for it, then the online softmax of the thread's two rows on the
    // unscaled scores. A row with no live key yet (mx == -1e30) takes its
    // offset as 0, so its masked scores still give exactly 0, and m == mx
    // == -1e30 rescales by exactly 1. Updates m, l and O's rescale alpha.
    auto softmax = [&](int t) {
      const int* me = s.meta + 4 * (t % QWG_STAGES);
      const int fl = me[0];
      if (fl != 0)
        mask_bits(sf, p, fl, me[2], me[3], warp, r0, r1, me[1], cq);
#pragma unroll
      for (int rr = 0; rr < 2; ++rr) {
        float mx = m[rr];
#pragma unroll
        for (int j = 0; j < 8; ++j)
          mx = fmaxf(mx, fmaxf(sf[j][2 * rr], sf[j][2 * rr + 1]));
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
        const float mxs = mx == NEG_INF ? 0.f : mx * scl2;
        alpha[rr] = ex2((m[rr] - mx) * scl2);
        float ps = 0.f;
#pragma unroll
        for (int j = 0; j < 8; ++j)
#pragma unroll
          for (int c = 2 * rr; c < 2 * rr + 2; ++c) {
            const float e = ex2(fmaf(sf[j][c], scl2, -mxs));
            sf[j][c] = e;
            ps += e;
          }
        l[rr] = l[rr] * alpha[rr] + ps;
        m[rr] = mx;
      }
    };
    auto rescale_pack = [&]() {             // O *= alpha; P -> A operand
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        of[j][0] *= alpha[0];
        of[j][1] *= alpha[0];
        of[j][2] *= alpha[1];
        of[j][3] *= alpha[1];
      }
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) pack_a<E>(pa[kk], sf, kk);
    };
    // the first tile's S alone, then each tile's P V with the next one's
    // S, then the last tile's P V alone: no wgmma in a branch
    if (count > 0) {
      full_wait(i);
      wg_fence();
      product_ss<E>(sf, Qs, slot(i));       // S = Q K^T
      wg_commit();
      wg_wait<0>();
      fence_acc<8>(sf);
      softmax(i);
      rescale_pack();
      for (int e = 0; e + 1 < count; ++e, ++i) {
        full_wait(i + 1);
        fence_acc<8>(of);
        fence_acc<8>(sf);
        wg_fence();
        product_ss<E>(sf, Qs, slot(i + 1));
        wg_commit();
        issue_pv(i, of);
        wg_commit();
        wg_wait<1>();                       // S of tile i + 1 has landed
        fence_acc<8>(sf);
        softmax(i + 1);
        wg_wait<0>();                       // P V of tile i has landed
        keep();
        fence_acc<8>(of);
        mbar_arrive(&s.empty[i % QWG_STAGES]);
        rescale_pack();
      }
      fence_acc<8>(of);
      wg_fence();
      issue_pv(i, of);
      wg_commit();
      wg_wait<0>();
      keep();
      fence_acc<8>(of);
      mbar_arrive(&s.empty[i % QWG_STAGES]);
      ++i;
    }
    mbar_arrive(&s.own_empty[os]);          // Q and imeta of this slot are read
    float inv[2];
#pragma unroll
    for (int rr = 0; rr < 2; ++rr) {
      float lt = l[rr];
      lt += __shfl_xor_sync(0xffffffffu, lt, 1);
      lt += __shfl_xor_sync(0xffffffffu, lt, 2);
      inv[rr] = 1.f / (lt == 0.f ? 1.f : lt);      // a dead row writes zeros
      const int row = rr ? r1 : r0;
      // m is the unscaled max: lse = m sm_scale + log(max(l, 1e-37)), -1e30
      // + log(1e-37) for a row without a live key as in bs_fwd_mma
      const float ms = m[rr] == NEG_INF ? NEG_INF : m[rr] * p.sm_scale;
      if (row < p.S && lane % 4 == 0)
        p.lse[(size_t)bh * p.S + row] = ms + logf(fmaxf(lt, 1e-37f));
    }
    store_rows<E, 64>(static_cast<E*>(p.o) + (size_t)bh * p.S * 64, of, r0,
                      r1, p.S, 64, cq, inv[0], inv[1]);
  }
}

template <typename E>
__global__ void __launch_bounds__(DKV_THREADS, 2)
bs_dq_wg(const __grid_constant__ QwgMaps maps, Params p, int BH) {
  using namespace hopper;
  extern __shared__ unsigned char smem_raw[];
  const QwgSmem<E, true> s(smem_raw);
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  s.init();
  const int wg = __shfl_sync(0xffffffffu, tid / DKV_WG, 0);
  if (wg == 1) {                            // the producer warpgroup
    regs_dealloc<DKV_PRODUCER_REGS>();
    if (warp == 4) q_produce<E, true>(maps, p, BH, s, lane);
    return;
  }
  regs_alloc<DKV_CONSUMER_REGS>();
  const int cq = (lane % 4) * 2;
  const float scl2 = p.sm_scale * LOG2E;
  const int items = cta_item_count(p, BH);
  uint32_t da[4][4] = {};                   // dS of the tile in dS K, packed
  auto keep = [&]() {                       // da lives until here
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
#pragma unroll
      for (int c = 0; c < 4; ++c) asm volatile("" :: "r"(da[kk][c]));
  };
  auto slot = [&](int t) { return s.ring + 2 * (t % QWG_STAGES) * DKV_TILE; };
  auto full_wait = [&](int t) {
    mbar_wait(&s.full[t % QWG_STAGES], (t / QWG_STAGES) & 1);
  };
  auto issue_dq = [&](int t, float (*acc)[4]) {  // dQ += dS K of tile t
    const uint64_t dk = desc_sw128(slot(t));
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) Wgmma<64>::rs<E>(acc, da[kk], dk + 128 * kk);
  };
  int i = 0;
  for (int n = 0; n < items; ++n) {
    const int os = n & 1;
    mbar_wait(&s.own_full[os], (n >> 1) & 1);
    const int* im = s.imeta + 3 * os;
    const int bh = im[0], qt = im[1];
    const int count = __shfl_sync(0xffffffffu, im[2], 0);   // uniform
    const int r0 = qt * T + warp * 16 + lane / 4, r1 = r0 + 8;
    const E* Qs = s.own + 2 * os * DKV_TILE;
    const E* Ds = Qs + DKV_TILE;
    const float* rw = s.rows + os * 128;
    const float lse2[2] = {rw[r0 - qt * T], rw[r1 - qt * T]};
    const float dlts[2] = {rw[64 + r0 - qt * T], rw[64 + r1 - qt * T]};
    float acc[8][4], sf[8][4], dp[8][4];
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int c = 0; c < 4; ++c) acc[j][c] = 0.f;
    // tile t's S, dP in sf, dp -> dS in sf: p = exp(s sm_scale - lse) as
    // one FFMA and one EX2, a masked entry exactly 0; dS = p (dp sm_scale -
    // delta sm_scale)
    auto dscore = [&](int t) {
      const int* me = s.meta + 4 * (t % QWG_STAGES);
      const int fl = me[0];
      if (fl != 0)
        mask_bits(sf, p, fl, me[2], me[3], warp, r0, r1, me[1], cq);
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          const int rr = c >> 1;
          const float pr = sf[j][c] > 0.5f * NEG_INF
                               ? ex2(fmaf(sf[j][c], scl2, -lse2[rr])) : 0.f;
          sf[j][c] = pr * fmaf(dp[j][c], p.sm_scale, -dlts[rr]);
        }
    };
    auto pack = [&]() {
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) pack_a<E>(da[kk], sf, kk);
    };
    // the first tile's S / dP alone, then each tile's dS K with the next
    // one's S / dP, then the last tile's dS K alone: no wgmma in a branch
    if (count > 0) {
      full_wait(i);
      wg_fence();
      product_ss<E>(sf, Qs, slot(i));                 // S = Q K^T
      product_ss<E>(dp, Ds, slot(i) + DKV_TILE);      // dP = dO V^T
      wg_commit();
      wg_wait<0>();
      fence_acc<8>(sf);
      fence_acc<8>(dp);
      dscore(i);
      for (int e = 0; e + 1 < count; ++e, ++i) {
        full_wait(i + 1);
        pack();
        fence_acc<8>(acc);
        fence_acc<8>(sf);
        fence_acc<8>(dp);
        wg_fence();
        product_ss<E>(sf, Qs, slot(i + 1));
        product_ss<E>(dp, Ds, slot(i + 1) + DKV_TILE);
        wg_commit();
        issue_dq(i, acc);
        wg_commit();
        wg_wait<1>();                       // S, dP of tile i + 1 have landed
        fence_acc<8>(sf);
        fence_acc<8>(dp);
        dscore(i + 1);
        wg_wait<0>();                       // dS K of tile i has landed
        keep();
        fence_acc<8>(acc);
        mbar_arrive(&s.empty[i % QWG_STAGES]);
      }
      pack();
      fence_acc<8>(acc);
      wg_fence();
      issue_dq(i, acc);
      wg_commit();
      wg_wait<0>();
      keep();
      fence_acc<8>(acc);
      mbar_arrive(&s.empty[i % QWG_STAGES]);
      ++i;
    }
    mbar_arrive(&s.own_empty[os]);  // Q, dO, rows and imeta of this slot are read
    store_rows<E, 64>(static_cast<E*>(p.dq) + (size_t)bh * p.S * 64, acc, r0,
                      r1, p.S, 64, cq);
  }
}

// the forward (DQ false) or dQ kernel of the long leg's call: persistent,
// two CTAs an SM, over the host's per-CTA item lists
template <typename E, bool DQ>
int launch_q_wg(const Params& p, int BH, cudaStream_t st) {
  const bool bf = std::is_same<E, bf16>::value;
  QwgMaps maps;
  if (!hopper::tile_map(&maps.q, p.q, bf, p.S, BH) ||
      !hopper::tile_map(&maps.k, p.k, bf, p.S, BH) ||
      !hopper::tile_map(&maps.v, p.v, bf, p.S, BH) ||
      (DQ && !hopper::tile_map(&maps.dout, p.dout, bf, p.S, BH)))
    return ERR_TENSOR_MAP;
  static int sms = 0;                       // the host's lists: 2 an SM
  if (sms == 0) {
    int dev = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  }
  auto kernel = DQ ? bs_dq_wg<E> : bs_fwd_wg<E>;
  const cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)Qwg<DQ>::SMEM);
  if (e != cudaSuccess) return static_cast<int>(e);
  kernel<<<2 * sms, DKV_THREADS, Qwg<DQ>::SMEM, st>>>(maps, p, BH);
  return static_cast<int>(cudaGetLastError());
}

// ------------------------------------------------- head dims above 256

// this file's schedule and masks for attention_wide.cuh: the host's
// longest-first order, the CSR lists (the key-tile ones for dk/dv) and the
// tile's flags
struct Wide {
  using Prm = Params;
  template <bool QMAJOR>
  static __device__ int own(const Params& p, int bh, int rank) {
    return p.order[(bh % p.H) * p.nT + rank];
  }
  template <bool QMAJOR>
  static __device__ void list(const Params& p, int bh, int t, int* e0,
                              int* e1) {
    const int i = (bh % p.H) * p.nT + t;
    *e0 = p.ptr[i];
    *e1 = p.ptr[i + 1];
  }
  template <bool QMAJOR>
  static __device__ int other(const Params& p, int, int, int e) {
    return p.idx[e] * T;
  }
  template <bool QMAJOR, int NJ>
  static __device__ void scores(const Params& p, int bh, int, int e,
                                float (*s)[4], float (*)[4], int a0, int a1,
                                int b0, int cq) {
    const int fl = p.flags[e];
    if (fl != 0) mask_tile<NJ, QMAJOR>(s, p, bh % p.H, fl, a0, a1, b0, cq);
  }
};

// ---------------------------------------------------------------- launch

template <typename KernelFn>
int launch(KernelFn kernel, const Params& p, int BH, int threads,
           cudaStream_t stream, size_t smem = 0, int splits = 1) {
  if (smem > 48 * 1024) {                   // above 48 KB only by opt-in
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  kernel<<<dim3(BH, p.nT, splits), threads, smem, stream>>>(p);
  return static_cast<int>(cudaGetLastError());
}

// each kernel at padded width DP: f32, or the 16-bit kernel of element E
// (dtype 1 bf16, 2 fp16), EXACT when D == DP (a compile-time width, up to
// 128)
template <int DP, typename F>
int by_type(const Params& p, int dtype, F&& go) {
  if constexpr (DP > 128) {
    return dtype == 1 ? go(bf16(), std::false_type())
                      : go(f16(), std::false_type());
  } else {
    const bool exact = p.D == DP;
    if (dtype == 1)
      return exact ? go(bf16(), std::true_type())
                   : go(bf16(), std::false_type());
    return exact ? go(f16(), std::true_type()) : go(f16(), std::false_type());
  }
}

template <int DP>
int launch_fwd(const Params& p, int BH, int dtype, cudaStream_t st) {
  if (dtype == 0) return launch(bs_fwd_f32<DP>, p, BH, F32<DP>::NT, st);
  if (p.D == 64)                            // the long leg: wgmma + TMA
    return dtype == 1 ? launch_q_wg<bf16, false>(p, BH, st)
                      : launch_q_wg<f16, false>(p, BH, st);
  constexpr size_t smem =
      pair_smem_bytes<bf16, DP>(T) + own_smem_bytes<bf16, DP>(1);
  return by_type<DP>(p, dtype, [&](auto e, auto x) {
    // D 64 took the wgmma kernel above: no exact variant at width 64
    constexpr bool exact = decltype(x)::value && DP != 64;
    return launch(bs_fwd_mma<decltype(e), DP, exact>, p, BH, NTHREADS, st,
                  smem);
  });
}

template <int DP>
int launch_dq(const Params& p, int BH, int dtype, cudaStream_t st) {
  if (dtype == 0) return launch(bs_dq_f32<DP>, p, BH, F32<DP>::NT, st);
  if (p.D == 64)                            // the long leg: wgmma + TMA
    return dtype == 1 ? launch_q_wg<bf16, true>(p, BH, st)
                      : launch_q_wg<f16, true>(p, BH, st);
  constexpr size_t smem =
      pair_smem_bytes<bf16, DP>(T) + own_smem_bytes<bf16, DP>(2);
  return by_type<DP>(p, dtype, [&](auto e, auto x) {
    constexpr bool exact = decltype(x)::value && DP != 64;
    return launch(bs_dq_mma<decltype(e), DP, exact>, p, BH, NTHREADS, st,
                  smem);
  });
}

template <int DP>
int launch_dkv(const Params& p, int BH, int dtype, cudaStream_t st) {
  if (dtype == 0) return launch(bs_dkv_f32<DP>, p, BH, F32<DP>::NT, st);
  if (p.D == 64)                            // the long leg: wgmma + TMA
    return dtype == 1 ? launch_dkv_wg<bf16>(p, BH, st)
                      : launch_dkv_wg<f16>(p, BH, st);
  // query steps of 32 rows above head_dim 64 keep dK, dV, K, V and the
  // score tiles within the register file (as in flash_attention_bwd.cu)
  constexpr int BQ = DP > 64 ? 32 : 64;
  constexpr size_t smem =
      pair_smem_bytes<bf16, DP>(BQ) + own_smem_bytes<bf16, DP>(2);
  return by_type<DP>(p, dtype, [&](auto e, auto x) {
    // D 64 took the wgmma kernel above: no exact variant at width 64
    constexpr bool exact = decltype(x)::value && DP != 64;
    return launch(bs_dkv_mma<decltype(e), DP, BQ, exact>, p, BH, NTHREADS,
                  st, smem, DP > 128 ? 2 : 1);
  });
}

Params make_params(const void* q, const void* k, const void* v,
                   const void* dout, const void* lse_in, const void* delta,
                   const void* layout, const void* ptr, const void* idx,
                   const void* flags, const void* order, int H, int S,
                   int D, int fine, int causal, int window, float sm_scale) {
  Params p = {};
  p.q = q; p.k = k; p.v = v; p.dout = dout;
  p.lse_in = static_cast<const float*>(lse_in);
  p.delta = static_cast<const float*>(delta);
  p.layout = static_cast<const uint8_t*>(layout);
  p.ptr = static_cast<const int*>(ptr);
  p.idx = static_cast<const int*>(idx);
  p.flags = static_cast<const int*>(flags);
  p.order = static_cast<const int*>(order);
  p.H = H; p.S = S; p.D = D; p.nT = (S + T - 1) / T;
  p.fine = fine; p.nf = fine > 0 ? S / fine : 0;
  p.causal = causal; p.window = window; p.sm_scale = sm_scale;
  return p;
}

bool supported(int D, int dtype) {
  return dtype >= 0 && dtype <= 2 && D >= 8 && D % 8 == 0;
}

// the wide kernel `which` (0 forward, 1 dq, 2 dk/dv) for D above 256
int launch_wide(const Params& p, int BH, int dtype, int which,
                cudaStream_t st) {
  wide::Args w = {};
  w.q = p.q; w.k = p.k; w.v = p.v; w.dout = p.dout;
  w.lse = p.lse_in; w.delta = p.delta; w.lse_out = p.lse;
  w.o = which == 0 ? p.o : p.dq; w.dk = p.dk; w.dv = p.dv;
  w.kv_head = (size_t)p.S * p.D;
  w.Sq = p.S; w.Sk = p.S; w.D = p.D; w.sm_scale = p.sm_scale;
  if (which == 0) return wide::launch<0, Wide>(w, p, BH, p.nT, dtype, st);
  if (which == 1) return wide::launch<1, Wide>(w, p, BH, p.nT, dtype, st);
  return wide::launch<2, Wide>(w, p, BH, p.nT, dtype, st);
}

// fn at the padded width of head dim D (up to 256)
template <typename Fn>
int dispatch(Fn fn, int D) {
  switch (pad_dim(D)) {
    case 32: return fn(std::integral_constant<int, 32>());
    case 64: return fn(std::integral_constant<int, 64>());
    case 96: return fn(std::integral_constant<int, 96>());
    case 128: return fn(std::integral_constant<int, 128>());
    case 192: return fn(std::integral_constant<int, 192>());
    default: return fn(std::integral_constant<int, 256>());
  }
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16, 2 = float16 (q, k, v, dout and the
// outputs alike). D: any multiple of 8. ptr / idx / flags /
// order: the query-tile lists and their order (forward, dq) or the key-tile
// ones (dkv); cta_ptr / cta_items: the persistent kernels' item lists (the
// (head, query tile) items for the forward and dq, the (head, key tile)
// ones for dkv), 2 CTAs an SM; bits (forward, dq): each listed tile's fine
// layout as two ints (mask_bits). layout: null when layout_exact is off;
// fine: a multiple of 8 that divides S. Each returns the CUDA error of its
// launch (0 = launched); -1 for a dtype or head dim the kernels lack, -2
// when a TMA tensor map cannot be encoded.
int block_sparse_attention_fwd_launch(const void* q, const void* k,
                                      const void* v, const void* layout,
                                      const void* ptr, const void* idx,
                                      const void* flags, const void* order,
                                      const void* cta_ptr,
                                      const void* cta_items, const void* bits,
                                      void* o, void* lse, int BH, int H,
                                      int S, int D, int fine, int causal,
                                      int window, float sm_scale, int dtype,
                                      void* stream) {
  Params p = make_params(q, k, v, nullptr, nullptr, nullptr, layout, ptr, idx,
                         flags, order, H, S, D, fine, causal, window, sm_scale);
  p.o = o;
  p.lse = static_cast<float*>(lse);
  p.cta_ptr = static_cast<const int*>(cta_ptr);
  p.cta_items = static_cast<const int*>(cta_items);
  p.bits = static_cast<const int*>(bits);
  if (!supported(D, dtype)) return -1;
  if (S <= 0 || BH <= 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (D > wide::FROM_DIM) return launch_wide(p, BH, dtype, 0, st);
  return dispatch(
      [&](auto d) { return launch_fwd<decltype(d)::value>(p, BH, dtype, st); },
      D);
}

int block_sparse_attention_bwd_dq_launch(const void* q, const void* k,
                                         const void* v, const void* dout,
                                         const void* lse, const void* delta,
                                         const void* layout, const void* ptr,
                                         const void* idx, const void* flags,
                                         const void* order,
                                         const void* cta_ptr,
                                         const void* cta_items,
                                         const void* bits, void* dq,
                                         int BH, int H, int S, int D,
                                         int fine, int causal, int window,
                                         float sm_scale, int dtype,
                                         void* stream) {
  Params p = make_params(q, k, v, dout, lse, delta, layout, ptr, idx, flags,
                         order, H, S, D, fine, causal, window, sm_scale);
  p.dq = dq;
  p.cta_ptr = static_cast<const int*>(cta_ptr);
  p.cta_items = static_cast<const int*>(cta_items);
  p.bits = static_cast<const int*>(bits);
  if (!supported(D, dtype)) return -1;
  if (S <= 0 || BH <= 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (D > wide::FROM_DIM) return launch_wide(p, BH, dtype, 1, st);
  return dispatch(
      [&](auto d) { return launch_dq<decltype(d)::value>(p, BH, dtype, st); },
      D);
}

int block_sparse_attention_bwd_dkv_launch(const void* q, const void* k,
                                          const void* v, const void* dout,
                                          const void* lse, const void* delta,
                                          const void* layout, const void* ptr,
                                          const void* idx, const void* flags,
                                          const void* order,
                                          const void* cta_ptr,
                                          const void* cta_items, void* dk,
                                          void* dv, int BH, int H,
                                          int S, int D, int fine, int causal,
                                          int window, float sm_scale,
                                          int dtype, void* stream) {
  Params p = make_params(q, k, v, dout, lse, delta, layout, ptr, idx, flags,
                         order, H, S, D, fine, causal, window, sm_scale);
  p.dk = dk;
  p.dv = dv;
  p.cta_ptr = static_cast<const int*>(cta_ptr);
  p.cta_items = static_cast<const int*>(cta_items);
  if (!supported(D, dtype)) return -1;
  if (S <= 0 || BH <= 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (D > wide::FROM_DIM) return launch_wide(p, BH, dtype, 2, st);
  return dispatch(
      [&](auto d) { return launch_dkv<decltype(d)::value>(p, BH, dtype, st); },
      D);
}

const char* block_sparse_attention_error_string(int err) {
  if (err == ERR_TENSOR_MAP) return "TMA tensor map encoding failed";
  return err < 0 ? "unsupported dtype or head dim"
                 : cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"

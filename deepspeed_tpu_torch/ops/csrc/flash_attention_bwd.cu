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
// inputs' dtype. The score pipeline is the forward's (csrc/
// flash_attention_fwd.cu): causal masking with offset Sk - S, a key-padding
// row [B, Sk] or (q, k) tiles per batch or per head (int32, nonzero =
// attend), ALiBi slope * (k - q), a causal sliding window and the Gemma-2
// softcap, whose derivative 1 - tanh^2 is threaded through dS.
//
// Numerics follow the TPU kernels: f32 scores scaled by sm_scale,
// p = exp(s - lse) with masked entries exactly 0 (always guarded, so a row
// with no live key gets zero gradients, as _bwd_p does), dp = dO V^T in f32,
// dS = p (dp - delta) dsoft sm_scale, and P and dS rounded to the value
// dtype before the products dV += P^T dO, dK += dS^T Q, dQ += dS K, which
// sum in f32.
//
// Bound: operations at head_dim 64 and S = 1024 (a causal backward does
// 5 products of D flops per live (q, k) pair against ~8 D bytes per row);
// the design keeps every S x Sk intermediate in registers. bf16: one CTA of
// 4 warps per 64 rows (queries for dq, keys for dkv); each warp owns 16
// rows, keeps its rows' two A operands (Q and dO for dq, K and V for dkv)
// in registers as mma.sync.m16n8k16 fragments and streams 64-row tiles of
// the other side through a cp.async double buffer in shared memory (rows
// padded by 8 elements for ldmatrix). dkv computes S^T = K Q^T directly, so
// P^T and dS^T come out of the accumulators already in the A-operand
// layout of dV and dK: no transpose through shared memory. The causal
// triangle and the window skip whole tiles; without a mask, bias, window or
// softcap only the tiles that cross the diagonal or a ragged edge run the
// per-element mask (the forward's fast path). f32: CUDA-core FMAs, so f32
// results stay f32 (no TF32): D / 32 threads per row, each owning 32 of its
// row's dims, partial dot products meeting by shuffles.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float NEG_INF = -1e30f;
constexpr float LOG2E = 1.4426950408889634f;
constexpr int NTHREADS = 128;
constexpr int BR = 64;            // rows per bf16 CTA: 4 warps x 16

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
  int H, S, Sk, causal, window, qkm_per_head;
  float sm_scale, softcap;
};

// softcap, ALiBi and the masks on one scaled score (the TPU kernels' _scores
// order): returns -1e30 for a masked entry and sets *dsoft to the softcap's
// derivative (1 without one)
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

// ------------------------------------------------------------------ bf16

__device__ __forceinline__ void mma_bf16(float* c, const uint32_t* a,
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 t = __floats2bfloat162_rn(lo, hi);   // .x = lo = low half
  return *reinterpret_cast<uint32_t*>(&t);
}

// four 8x8 b16 matrices from shared memory (see flash_attention_fwd.cu):
// without .trans lane l receives (row l/4, columns 2*(l%4) + {0, 1}) of
// each; with .trans the transposed matrix
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

using bf16 = __nv_bfloat16;

// A fragments of rows r0 / r1 (k columns kk*16 + cq, cq + 1 and + 8) of a
// [n, D] bf16 matrix; rows past n read zeros
template <int D>
__device__ __forceinline__ void load_a(uint32_t (*f)[4], const bf16* base,
                                       int r0, int r1, int n, int cq) {
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    const int c = kk * 16 + cq;
    f[kk][0] = r0 < n ? *reinterpret_cast<const uint32_t*>(base + (size_t)r0 * D + c) : 0u;
    f[kk][1] = r1 < n ? *reinterpret_cast<const uint32_t*>(base + (size_t)r1 * D + c) : 0u;
    f[kk][2] = r0 < n ? *reinterpret_cast<const uint32_t*>(base + (size_t)r0 * D + c + 8) : 0u;
    f[kk][3] = r1 < n ? *reinterpret_cast<const uint32_t*>(base + (size_t)r1 * D + c + 8) : 0u;
  }
}

// acc[j] (16 x 8 tile j of a 16 x N product) += A (fragments a) times the
// transpose of the N rows at smem (N x D, padded row LD): the Q K^T
// pattern. B fragment of k step kk = rows j*8 + lane/4, columns kk*16 +
// cq (+ 8); one ldmatrix.x4 gives two k steps
template <int D, int N, int LD>
__device__ __forceinline__ void mma_abt(float (*acc)[4], const uint32_t (*a)[4],
                                        const bf16* smem, int lane) {
#pragma unroll
  for (int j = 0; j < N / 8; ++j) {
    acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;
    const bf16* r = &smem[(j * 8 + (lane & 7)) * LD + (lane >> 3) * 8];
#pragma unroll
    for (int kk = 0; kk < D / 16; kk += 2) {
      uint32_t b[4];
      ldsm_x4(b, r + kk * 16);
      mma_bf16(acc[j], a[kk], b[0], b[1]);
      mma_bf16(acc[j], a[kk + 1], b[2], b[3]);
    }
  }
}

// out (16 x D) += X (16 x N, the f32 accumulator tiles x, rounded to bf16
// and repacked as A fragments of 16 columns) times the N x D rows at smem:
// the P V pattern. B fragment of column tile n = rows kk*16 + cq + {0, 1}
// (+ 8), column n*8 + lane/4; one ldmatrix.x4.trans gives two column tiles
template <int D, int N, int LD>
__device__ __forceinline__ void mma_ab(float (*out)[4], const float (*x)[4],
                                       const bf16* smem, int lane) {
  const int v_row = (lane & 7) + ((lane >> 3) & 1) * 8, v_col = (lane >> 4) * 8;
#pragma unroll
  for (int kk = 0; kk < N / 16; ++kk) {
    uint32_t a[4];
    a[0] = pack_bf16(x[2 * kk][0], x[2 * kk][1]);
    a[1] = pack_bf16(x[2 * kk][2], x[2 * kk][3]);
    a[2] = pack_bf16(x[2 * kk + 1][0], x[2 * kk + 1][1]);
    a[3] = pack_bf16(x[2 * kk + 1][2], x[2 * kk + 1][3]);
    const bf16* r = &smem[(kk * 16 + v_row) * LD + v_col];
#pragma unroll
    for (int n = 0; n < D / 8; n += 2) {
      uint32_t b[4];
      ldsm_x4_trans(b, r + n * 8);
      mma_bf16(out[n], a, b[0], b[1]);
      mma_bf16(out[n + 1], a, b[2], b[3]);
    }
  }
}

// rows r0 / r1 of a 16 x D f32 accumulator to bf16 rows of [n, D]
template <int D>
__device__ __forceinline__ void store_rows(bf16* base, const float (*acc)[4],
                                           int r0, int r1, int n, int cq) {
#pragma unroll
  for (int rr = 0; rr < 2; ++rr) {
    const int row = rr ? r1 : r0;
    if (row >= n) continue;
    bf16* out = base + (size_t)row * D + cq;
#pragma unroll
    for (int c = 0; c < D / 8; ++c)
      *reinterpret_cast<__nv_bfloat162*>(out + c * 8) =
          __floats2bfloat162_rn(acc[c][2 * rr], acc[c][2 * rr + 1]);
  }
}

// two 64-row tiles (rows i0.. of a and b, [n, D] each) into the shared
// stage at dst (a then b, rows padded to LD) by cp.async; rows past n
// read zeros
template <int D, int ROWS>
__device__ __forceinline__ void load_pair(bf16* dst, const bf16* a,
                                          const bf16* b, int i0, int n,
                                          int tid) {
  constexpr int LD = D + 8;
  for (int idx = tid; idx < ROWS * D / 8; idx += NTHREADS) {
    const int rr = idx / (D / 8), c = (idx % (D / 8)) * 8;
    const int row = i0 + rr;
    const bool live = row < n;
    const size_t src = (size_t)(live ? row : 0) * D + c;
    cp_async16(&dst[rr * LD + c], a + src, live ? 16 : 0);
    cp_async16(&dst[ROWS * LD + rr * LD + c], b + src, live ? 16 : 0);
  }
  cp_async_commit();
}

template <int D> constexpr size_t bf16_smem_bytes(int rows) {
  return 2 * 2 * rows * (D + 8) * sizeof(bf16);
}

// dQ for 64 query rows: loop over the live key tiles of 64 with K and V
// double-buffered in shared memory
template <int D, bool EXTRAS>
__global__ void __launch_bounds__(NTHREADS)
flash_bwd_dq_bf16(Params p) {
  constexpr int BK = 64, LD = D + 8, TILE = BK * LD;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* sm = reinterpret_cast<bf16*>(smem_raw);
  const int qt = gridDim.x - 1 - blockIdx.x;  // the longest causal rows first
  const int bh = blockIdx.y, b = bh / p.H, h = bh % p.H;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int q0 = qt * BR;
  const int r0 = q0 + warp * 16 + lane / 4, r1 = r0 + 8;
  const int cq = (lane % 4) * 2;
  const float slope = p.slopes ? p.slopes[h] : 0.f;
  const size_t qoff = (size_t)bh * p.S;

  uint32_t qf[D / 16][4], df[D / 16][4];
  load_a<D>(qf, static_cast<const bf16*>(p.q) + qoff * D, r0, r1, p.S, cq);
  load_a<D>(df, static_cast<const bf16*>(p.dout) + qoff * D, r0, r1, p.S,
            cq);
  float lse[2], dlt[2];
  lse[0] = r0 < p.S ? p.lse[qoff + r0] : 0.f;
  lse[1] = r1 < p.S ? p.lse[qoff + r1] : 0.f;
  dlt[0] = r0 < p.S ? p.delta[qoff + r0] : 0.f;
  dlt[1] = r1 < p.S ? p.delta[qoff + r1] : 0.f;
  float acc[D / 8][4];
#pragma unroll
  for (int n = 0; n < D / 8; ++n) acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;

  int lo, hi;
  key_tiles(p, q0, min(q0 + BR, p.S) - 1, BK, &lo, &hi);
  const bf16* kb = static_cast<const bf16*>(p.k) + (size_t)bh * p.Sk * D;
  const bf16* vb = static_cast<const bf16*>(p.v) + (size_t)bh * p.Sk * D;
  if (lo < hi) load_pair<D, BK>(sm, kb, vb, lo * BK, p.Sk, tid);

  for (int kt = lo; kt < hi; ++kt) {
    const int k0 = kt * BK, stage = (kt - lo) & 1;
    if (kt + 1 < hi) {
      load_pair<D, BK>(sm + 2 * (stage ^ 1) * TILE, kb, vb, k0 + BK, p.Sk,
                       tid);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const bf16* Ks = sm + 2 * stage * TILE;
    const bf16* Vs = Ks + TILE;
    float sf[BK / 8][4], dp[BK / 8][4];
    mma_abt<D, BK, LD>(sf, qf, Ks, lane);       // S = Q K^T
    mma_abt<D, BK, LD>(dp, df, Vs, lane);       // dP = dO V^T
    // the warp's rows start at q position warp_q0: a tile needs the
    // causal mask only if its last key lies past it, and the edge mask only
    // if it runs past Sk (rows past S are never written)
    const int warp_q0 = q0 + warp * 16 + (p.Sk - p.S);
    const bool masked = EXTRAS || (p.causal && k0 + BK - 1 > warp_q0) ||
                        k0 + BK > p.Sk;
#pragma unroll
    for (int j = 0; j < BK / 8; ++j)
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int rr = c >> 1, row = rr ? r1 : r0;
        const int key = k0 + j * 8 + cq + (c & 1);
        float s = sf[j][c] * p.sm_scale, dsoft = 1.f;
        if (masked) s = score(p, s, b, bh, row, key, slope, &dsoft);
        const float pr = prob(s, lse[rr]);
        sf[j][c] = pr * (dp[j][c] - dlt[rr]) * dsoft * p.sm_scale;   // dS
      }
    mma_ab<D, BK, LD>(acc, sf, Ks, lane);       // dQ += dS K
    __syncthreads();                            // the stage is refilled next
  }
  store_rows<D>(static_cast<bf16*>(p.dq) + qoff * D, acc, r0, r1, p.S, cq);
}

// dK and dV for 64 key rows: loop over the query tiles of BQ that see them,
// with Q and dO double-buffered in shared memory and each tile's lse and
// delta beside them
template <int D, int BQ, bool EXTRAS>
__global__ void __launch_bounds__(NTHREADS)
flash_bwd_dkv_bf16(Params p) {
  constexpr int LD = D + 8, TILE = BQ * LD;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* sm = reinterpret_cast<bf16*>(smem_raw);
  __shared__ float rows_s[2][2][BQ];           // [stage][lse, delta][query]
  const int kt = gridDim.x - 1 - blockIdx.x;
  const int bh = blockIdx.y, b = bh / p.H, h = bh % p.H;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int k0 = kt * BR;
  const int r0 = k0 + warp * 16 + lane / 4, r1 = r0 + 8;
  const int cq = (lane % 4) * 2;
  const float slope = p.slopes ? p.slopes[h] : 0.f;
  const size_t koff = (size_t)bh * p.Sk, qoff = (size_t)bh * p.S;

  uint32_t kf[D / 16][4], vf[D / 16][4];
  load_a<D>(kf, static_cast<const bf16*>(p.k) + koff * D, r0, r1, p.Sk, cq);
  load_a<D>(vf, static_cast<const bf16*>(p.v) + koff * D, r0, r1, p.Sk, cq);
  float dk[D / 8][4], dv[D / 8][4];
#pragma unroll
  for (int n = 0; n < D / 8; ++n)
#pragma unroll
    for (int c = 0; c < 4; ++c) dk[n][c] = dv[n][c] = 0.f;

  int lo, hi;
  query_tiles(p, k0, min(k0 + BR, p.Sk) - 1, BQ, &lo, &hi);
  const bf16* qb = static_cast<const bf16*>(p.q) + qoff * D;
  const bf16* db = static_cast<const bf16*>(p.dout) + qoff * D;
  auto load_rows = [&](int q0, int stage) {   // lse and delta of the tile
    for (int i = tid; i < BQ; i += NTHREADS) {
      const bool live = q0 + i < p.S;
      rows_s[stage][0][i] = live ? p.lse[qoff + q0 + i] : 0.f;
      rows_s[stage][1][i] = live ? p.delta[qoff + q0 + i] : 0.f;
    }
  };
  if (lo < hi) {
    load_rows(lo * BQ, 0);
    load_pair<D, BQ>(sm, qb, db, lo * BQ, p.S, tid);
  }

  for (int qt = lo; qt < hi; ++qt) {
    const int q0 = qt * BQ, stage = (qt - lo) & 1;
    if (qt + 1 < hi) {
      load_rows(q0 + BQ, stage ^ 1);
      load_pair<D, BQ>(sm + 2 * (stage ^ 1) * TILE, qb, db, q0 + BQ, p.S,
                       tid);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const bf16* Qs = sm + 2 * stage * TILE;
    const bf16* Ds = Qs + TILE;
    const float* lse = rows_s[stage][0];
    const float* dlt = rows_s[stage][1];
    float st[BQ / 8][4], dpt[BQ / 8][4];
    mma_abt<D, BQ, LD>(st, kf, Qs, lane);      // S^T = K Q^T
    mma_abt<D, BQ, LD>(dpt, vf, Ds, lane);     // dP^T = V dO^T
    // the warp's keys end at k0 + warp*16 + 15: a tile needs the causal
    // mask only if that key lies past the tile's first query position, and
    // the edge mask if its queries run past S (they would add to dK, dV)
    const bool masked = EXTRAS ||
                        (p.causal && k0 + warp * 16 + 15 > q0 + (p.Sk - p.S)) ||
                        q0 + BQ > p.S || k0 + BR > p.Sk;
#pragma unroll
    for (int j = 0; j < BQ / 8; ++j)
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int key = (c >> 1) ? r1 : r0;
        const int qi = j * 8 + cq + (c & 1);
        float s = st[j][c] * p.sm_scale, dsoft = 1.f;
        if (masked) s = score(p, s, b, bh, q0 + qi, key, slope, &dsoft);
        const float pr = prob(s, lse[qi]);
        st[j][c] = pr;                                               // P^T
        dpt[j][c] = pr * (dpt[j][c] - dlt[qi]) * dsoft * p.sm_scale; // dS^T
      }
    mma_ab<D, BQ, LD>(dv, st, Ds, lane);       // dV += P^T dO
    mma_ab<D, BQ, LD>(dk, dpt, Qs, lane);      // dK += dS^T Q
    __syncthreads();                           // the stage is refilled next
  }
  store_rows<D>(static_cast<bf16*>(p.dk) + koff * D, dk, r0, r1, p.Sk, cq);
  store_rows<D>(static_cast<bf16*>(p.dv) + koff * D, dv, r0, r1, p.Sk, cq);
}

// ------------------------------------------------------------------- f32

// TPR = D / 32 threads per row, each owning the float4 slices i*TPR + t
// (i < 8) of its row: 32 dims, neighbouring threads on neighbouring
// addresses
template <int D>
__device__ __forceinline__ void load_row32(float* dst, const float* row,
                                           int t) {
  constexpr int TPR = D / 32;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const float4 x = *reinterpret_cast<const float4*>(row + 4 * (i * TPR + t));
    dst[4 * i] = x.x; dst[4 * i + 1] = x.y; dst[4 * i + 2] = x.z; dst[4 * i + 3] = x.w;
  }
}

template <int D>
__device__ __forceinline__ void store_row32(float* row, const float* src,
                                            int t) {
  constexpr int TPR = D / 32;
#pragma unroll
  for (int i = 0; i < 8; ++i)
    *reinterpret_cast<float4*>(row + 4 * (i * TPR + t)) =
        make_float4(src[4 * i], src[4 * i + 1], src[4 * i + 2], src[4 * i + 3]);
}

// the dot products of this thread's slices with one shared row (a, b
// against x, y), summed over the row's TPR threads
template <int D>
__device__ __forceinline__ void dot2(const float* a, const float* x,
                                     const float* b, const float* y, int t,
                                     float* ax, float* by) {
  constexpr int TPR = D / 32;
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
template <int D>
__device__ __forceinline__ void axpy32(float* acc, float w, const float* x,
                                       int t) {
  constexpr int TPR = D / 32;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const float4 u = *reinterpret_cast<const float4*>(x + 4 * (i * TPR + t));
    acc[4 * i] = fmaf(w, u.x, acc[4 * i]);
    acc[4 * i + 1] = fmaf(w, u.y, acc[4 * i + 1]);
    acc[4 * i + 2] = fmaf(w, u.z, acc[4 * i + 2]);
    acc[4 * i + 3] = fmaf(w, u.w, acc[4 * i + 3]);
  }
}

// nrows rows of two [n, D] f32 matrices (from row i0) into shared tiles;
// rows past n read zeros
template <int D>
__device__ __forceinline__ void load_f32_pair(float* da, float* db,
                                              const float* a, const float* b,
                                              int i0, int nrows, int n,
                                              int tid) {
  for (int idx = tid; idx < nrows * D / 4; idx += NTHREADS) {
    const int rr = idx / (D / 4), c = (idx % (D / 4)) * 4;
    float4 x = make_float4(0.f, 0.f, 0.f, 0.f), y = x;
    if (i0 + rr < n) {
      x = *reinterpret_cast<const float4*>(a + (size_t)(i0 + rr) * D + c);
      y = *reinterpret_cast<const float4*>(b + (size_t)(i0 + rr) * D + c);
    }
    *reinterpret_cast<float4*>(&da[rr * D + c]) = x;
    *reinterpret_cast<float4*>(&db[rr * D + c]) = y;
  }
}

template <int D>
__global__ void __launch_bounds__(NTHREADS)
flash_bwd_dq_f32(Params p) {
  constexpr int TPR = D / 32, ROWS = NTHREADS / TPR, BK = 32;
  __shared__ __align__(16) float Ks[BK * D];
  __shared__ __align__(16) float Vs[BK * D];
  const int qt = gridDim.x - 1 - blockIdx.x;
  const int bh = blockIdx.y, b = bh / p.H, h = bh % p.H;
  const int tid = threadIdx.x, t = tid % TPR;
  const int q0 = qt * ROWS, row = q0 + tid / TPR;
  const float slope = p.slopes ? p.slopes[h] : 0.f;
  const size_t qoff = (size_t)bh * p.S, koff = (size_t)bh * p.Sk;
  const int rr = min(row, p.S - 1);
  float qv[32], dov[32], acc[32];
  load_row32<D>(qv, static_cast<const float*>(p.q) + (qoff + rr) * D, t);
  load_row32<D>(dov, static_cast<const float*>(p.dout) + (qoff + rr) * D, t);
#pragma unroll
  for (int i = 0; i < 32; ++i) acc[i] = 0.f;
  const float lse = p.lse[qoff + rr], dlt = p.delta[qoff + rr];

  int lo, hi;
  key_tiles(p, q0, min(q0 + ROWS, p.S) - 1, BK, &lo, &hi);
  for (int kt = lo; kt < hi; ++kt) {
    const int k0 = kt * BK;
    __syncthreads();
    load_f32_pair<D>(Ks, Vs, static_cast<const float*>(p.k) + koff * D,
                     static_cast<const float*>(p.v) + koff * D, k0, BK, p.Sk,
                     tid);
    __syncthreads();
    for (int kk = 0; kk < BK; ++kk) {
      float s, dp, dsoft;
      dot2<D>(qv, &Ks[kk * D], dov, &Vs[kk * D], t, &s, &dp);
      s = score(p, s * p.sm_scale, b, bh, row, k0 + kk, slope, &dsoft);
      const float ds = prob(s, lse) * (dp - dlt) * dsoft * p.sm_scale;
      axpy32<D>(acc, ds, &Ks[kk * D], t);
    }
  }
  if (row < p.S)
    store_row32<D>(static_cast<float*>(p.dq) + (qoff + row) * D, acc, t);
}

template <int D>
__global__ void __launch_bounds__(NTHREADS)
flash_bwd_dkv_f32(Params p) {
  constexpr int TPR = D / 32, ROWS = NTHREADS / TPR, BQ = 32;
  __shared__ __align__(16) float Qs[BQ * D];
  __shared__ __align__(16) float Ds[BQ * D];
  __shared__ float Ls[BQ], Es[BQ];
  const int kt = gridDim.x - 1 - blockIdx.x;
  const int bh = blockIdx.y, b = bh / p.H, h = bh % p.H;
  const int tid = threadIdx.x, t = tid % TPR;
  const int k0 = kt * ROWS, key = k0 + tid / TPR;
  const float slope = p.slopes ? p.slopes[h] : 0.f;
  const size_t qoff = (size_t)bh * p.S, koff = (size_t)bh * p.Sk;
  const int kr = min(key, p.Sk - 1);
  float kv[32], vv[32], dk[32], dv[32];
  load_row32<D>(kv, static_cast<const float*>(p.k) + (koff + kr) * D, t);
  load_row32<D>(vv, static_cast<const float*>(p.v) + (koff + kr) * D, t);
#pragma unroll
  for (int i = 0; i < 32; ++i) dk[i] = dv[i] = 0.f;

  int lo, hi;
  query_tiles(p, k0, min(k0 + ROWS, p.Sk) - 1, BQ, &lo, &hi);
  for (int qt = lo; qt < hi; ++qt) {
    const int q0 = qt * BQ;
    __syncthreads();
    load_f32_pair<D>(Qs, Ds, static_cast<const float*>(p.q) + qoff * D,
                     static_cast<const float*>(p.dout) + qoff * D, q0, BQ,
                     p.S, tid);
    for (int i = tid; i < BQ; i += NTHREADS) {
      const bool live = q0 + i < p.S;
      Ls[i] = live ? p.lse[qoff + q0 + i] : 0.f;
      Es[i] = live ? p.delta[qoff + q0 + i] : 0.f;
    }
    __syncthreads();
    for (int qq = 0; qq < BQ; ++qq) {
      float s, dp, dsoft;
      dot2<D>(kv, &Qs[qq * D], vv, &Ds[qq * D], t, &s, &dp);
      s = score(p, s * p.sm_scale, b, bh, q0 + qq, key, slope, &dsoft);
      const float pr = prob(s, Ls[qq]);
      const float ds = pr * (dp - Es[qq]) * dsoft * p.sm_scale;
      axpy32<D>(dv, pr, &Ds[qq * D], t);
      axpy32<D>(dk, ds, &Qs[qq * D], t);
    }
  }
  if (key < p.Sk) {
    store_row32<D>(static_cast<float*>(p.dk) + (koff + key) * D, dk, t);
    store_row32<D>(static_cast<float*>(p.dv) + (koff + key) * D, dv, t);
  }
}

// ---------------------------------------------------------------- launch

template <typename KernelFn>
int launch(KernelFn kernel, const Params& p, int rows_per_cta, int n, int BH,
           cudaStream_t stream, size_t smem = 0) {
  if (smem > 48 * 1024) {                   // above 48 KB only by opt-in
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  dim3 grid((n + rows_per_cta - 1) / rows_per_cta, BH);
  kernel<<<grid, NTHREADS, smem, stream>>>(p);
  return static_cast<int>(cudaGetLastError());
}

template <int D>
int launch_dq(const Params& p, int BH, int dtype, bool extras,
              cudaStream_t st) {
  if (dtype == 0) return launch(flash_bwd_dq_f32<D>, p, NTHREADS / (D / 32),
                                p.S, BH, st);
  const size_t smem = bf16_smem_bytes<D>(64);
  return extras ? launch(flash_bwd_dq_bf16<D, true>, p, BR, p.S, BH, st, smem)
                : launch(flash_bwd_dq_bf16<D, false>, p, BR, p.S, BH, st, smem);
}

template <int D>
int launch_dkv(const Params& p, int BH, int dtype, bool extras,
               cudaStream_t st) {
  if (dtype == 0) return launch(flash_bwd_dkv_f32<D>, p, NTHREADS / (D / 32),
                                p.Sk, BH, st);
  // query tiles of 32 at head_dim 128 keep dK, dV, K, V and the score
  // tiles within the register file
  constexpr int BQ = D > 64 ? 32 : 64;
  const size_t smem = bf16_smem_bytes<D>(BQ);
  return extras
      ? launch(flash_bwd_dkv_bf16<D, BQ, true>, p, BR, p.Sk, BH, st, smem)
      : launch(flash_bwd_dkv_bf16<D, BQ, false>, p, BR, p.Sk, BH, st, smem);
}

Params make_params(const void* q, const void* k, const void* v,
                   const void* dout, const void* lse, const void* delta,
                   const void* kvm, const void* qkm, const void* slopes,
                   void* dq, void* dk, void* dv, int H, int S, int Sk,
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
  p.H = H; p.S = S; p.Sk = Sk; p.causal = causal; p.window = window;
  p.qkm_per_head = qkm_per_head;
  p.sm_scale = sm_scale; p.softcap = softcap;
  return p;
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16 (q, k, v, dout and the outputs alike).
// D: 32, 64 or 128. Each returns the CUDA error of its launch (0 =
// launched); -1 for a dtype or head dim the kernels lack.
int flash_attention_bwd_dq_launch(const void* q, const void* k, const void* v,
                                  const void* dout, const void* lse,
                                  const void* delta, const void* kvm,
                                  const void* qkm, const void* slopes,
                                  void* dq, int BH, int H, int S, int Sk,
                                  int D, int causal, int window,
                                  int qkm_per_head, float sm_scale,
                                  float softcap, int dtype, void* stream) {
  const Params p = make_params(q, k, v, dout, lse, delta, kvm, qkm, slopes,
                               dq, nullptr, nullptr, H, S, Sk, causal, window,
                               qkm_per_head, sm_scale, softcap);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (S <= 0 || BH <= 0) return 0;
  if (dtype != 0 && dtype != 1) return -1;
  const bool extras = kvm || qkm || slopes || window > 0 || softcap > 0.f;
  if (D == 32) return launch_dq<32>(p, BH, dtype, extras, st);
  if (D == 64) return launch_dq<64>(p, BH, dtype, extras, st);
  if (D == 128) return launch_dq<128>(p, BH, dtype, extras, st);
  return -1;
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
                               nullptr, dk, dv, H, S, Sk, causal, window,
                               qkm_per_head, sm_scale, softcap);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (Sk <= 0 || BH <= 0) return 0;
  if (dtype != 0 && dtype != 1) return -1;
  const bool extras = kvm || qkm || slopes || window > 0 || softcap > 0.f;
  if (D == 32) return launch_dkv<32>(p, BH, dtype, extras, st);
  if (D == 64) return launch_dkv<64>(p, BH, dtype, extras, st);
  if (D == 128) return launch_dkv<128>(p, BH, dtype, extras, st);
  return -1;
}

const char* flash_attention_bwd_error_string(int err) {
  return err < 0 ? "unsupported dtype or head dim"
                 : cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"

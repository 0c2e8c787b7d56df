// Flash attention forward for Hopper (sm_90a), plain C interface.
//
// Replaces the forward Pallas kernel of
// deepspeed_tpu/ops/pallas/flash_attention.py (_fwd_kernel, launched by
// _fwd). q, k, v [B*H, S|Sk, D] -> o [B*H, S, D] and the row logsumexp
// lse [B*H, S] f32, with in-kernel causal masking (offset Sk - S: the last
// query row sees every key), a key-padding row [B, Sk] or (q, k) tiles per
// batch [B, S, Sk] or per head [B*H, S, Sk] (int32, nonzero = attend),
// ALiBi slope * (k - q), a causal sliding window, and the Gemma-2 softcap.
// Any head dim D % 8 == 0, in f32, bf16 or fp16; above 256 the wide kernel
// of attention_wide.cuh (scores accumulated over D in chunks, the output
// columns split over CTAs) with this file's masks.
//
// Bound: bytes for a causal prefill at head dim 64 and S 1024, with the
// operations close behind (about D / 2 flops a byte once q, k, v and o are
// each moved once); the design never writes the S x Sk scores and skips
// the key tiles that the causal triangle or the window excludes. Three
// kernels:
//
// * flash_fwd_wg (16-bit, no mask, ALiBi, window or softcap, D in {64, 80,
//   96, 128, 192, 256}: the generate prefill and the train path), the
//   warp-specialized Hopper form. Persistent: one CTA an SM walks work
//   items of 128 query rows of one head, in groups of heads whose K and V
//   stay in the L2 cache, every head's longest causal rows first. One
//   thread of the producer warpgroup streams each item's Q (two buffers
//   where they fit, so the next item's Q loads under this one) and its K
//   and V tiles of BK keys (128, or 64 above D 128) by TMA into two-slot
//   rings (one for K, one for V, each slot signalled full and freed
//   through mbarriers); two consumer warpgroups take 64 rows each. The
//   producer keeps 40 registers a thread and gives the rest to the
//   consumers (setmaxnreg: 232). S = Q K^T is wgmma m64nBKk16 with both
//   operands in shared memory (128-byte swizzle, D padded to 16 by the
//   zeros TMA reads past D); P is repacked from the accumulators as the
//   register A operand of O += P V, which runs at N = D with V read
//   MN-major. The two consumers take turns through two named barriers:
//   one issues its next S and its O += P V of the last tile, hands the
//   turn over and runs its softmax while the other's products run; the
//   softmax waits only for S, so its own P V runs under it too.
// * flash_fwd_mma (16-bit, every other call): one CTA per (64-row q tile,
//   b*h) with 4 warps of 16 rows on mma.sync.m16n8k16; K/V tiles of 64
//   double-buffered by cp.async, read by ldmatrix (.trans for V) from rows
//   padded by 8 elements. Instantiated at a padded width
//   (attention_tile.cuh); above 128 the Q rows stay in shared memory.
// * flash_fwd_f32: CUDA-core FMAs, so f32 results stay f32 (no TF32). One
//   CTA per (64-row q tile, b*h), TPR threads per query row (2, or 4 above
//   D 128), each owning float4 slices interleaved so the row's threads
//   read distinct banks; the partial dot products meet by shuffles.
//
// Both 16-bit kernels run the longest causal rows first, and without a
// mask, bias, window or softcap only the tiles that cross the causal
// diagonal or the ragged edge run the mask. Numerics follow the TPU
// kernel: f32 scores scaled by sm_scale, softcap before the ALiBi term,
// the bias before the masks, masked entries set to -1e30 and their p to
// exactly 0, p rounded to the value dtype before P V, a row with no live
// key writes zeros, and lse = m + log(max(l, 1e-37)). The wgmma kernel
// takes the row max on unscaled scores and exp((s - m) sm_scale) as one
// FFMA and one EX2 an element (equal up to rounding). Keys past Sk and
// queries past S (the ragged edge) are masked here; the TPU wrapper
// instead sends untileable shapes to its reference.

#include "attention_tile.cuh"
#include "attention_wide.cuh"
#include "hopper.cuh"

namespace {

using namespace tile;

constexpr float NEG_INF = -1e30f;
constexpr int NTHREADS = 128;
constexpr int BQ = 64;            // query rows per CTA

struct Params {
  const void* q;
  const void* k;
  const void* v;
  const int* kvm;                 // [B, Sk] or null
  const int* qkm;                 // [B or B*H, S, Sk] or null
  const float* slopes;            // [H] or null
  void* o;
  float* lse;
  int H, S, Sk, D, causal, window, qkm_per_head;
  float sm_scale, softcap;
};

// softcap, ALiBi and the masks on one scaled score (the TPU kernel's
// _scores order); returns -1e30 for a masked entry
__device__ __forceinline__ float score(const Params& p, float s, int b, int bh,
                                       int row, int key, float slope) {
  if (p.softcap > 0.f) s = tanhf(s / p.softcap) * p.softcap;
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

// key tiles [lo, hi) of size bk that the causal triangle and the window
// leave live for query rows [q0, q_last]
__device__ __forceinline__ void tile_range(const Params& p, int q0, int q_last,
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

// ------------------------------------------------------------ bf16, fp16

constexpr float LOG2E = 1.4426950408889634f;
constexpr int BK16 = 64;          // keys per 16-bit tile

// EXTRAS: a mask, ALiBi, a window or a softcap is given and every score
// runs the full pipeline; without, only tiles that cross the causal
// diagonal or the ragged edge are masked. On an H100 the full pipeline on
// every score takes a causal llama-1.1b prefill (22 launches, B 8, 32
// heads, S 1024, D 64) from 5.8 to 9.8 ms (PERF.md, Findings). EXACT: D
// == DP, a compile-time width (no column predicates, constant strides).
template <typename T, int DP, bool EXTRAS, bool EXACT>
__global__ void __launch_bounds__(NTHREADS)
flash_fwd_mma(Params p) {
  constexpr int BK = BK16, LD = DP + 8;     // padded shared-memory row
  constexpr int TILE = BK * LD;             // elements of one K or V tile
  constexpr bool OWN_SMEM = OwnA<T, DP>::SMEM;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* sm = reinterpret_cast<T*>(smem_raw);
  const int D = EXACT ? DP : p.D;

  const int qt = gridDim.x - 1 - blockIdx.x;  // the longest causal rows first
  const int bh = blockIdx.y, b = bh / p.H, h = bh % p.H;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int q0 = qt * BQ;
  const int r0 = q0 + warp * 16 + lane / 4, r1 = r0 + 8;
  const int cq = (lane % 4) * 2;
  const float slope = p.slopes ? p.slopes[h] : 0.f;

  OwnA<T, DP> qa;                           // Q, the A operand
  own_load<T, DP>(qa, static_cast<const T*>(p.q) + (size_t)bh * p.S * D,
                  sm + 4 * TILE, q0, r0, r1, p.S, D, cq, tid);
  if (OWN_SMEM) cp_async_commit();          // waited for with tile kt_lo
  float of[DP / 8][4];
#pragma unroll
  for (int n = 0; n < DP / 8; ++n)
    of[n][0] = of[n][1] = of[n][2] = of[n][3] = 0.f;
  float m[2] = {NEG_INF, NEG_INF}, l[2] = {0.f, 0.f};   // l: this thread's part

  int kt_lo, kt_hi;
  tile_range(p, q0, min(q0 + BQ, p.S) - 1, BK, &kt_lo, &kt_hi);
  const T* kb = static_cast<const T*>(p.k) + (size_t)bh * p.Sk * D;
  const T* vb = static_cast<const T*>(p.v) + (size_t)bh * p.Sk * D;

  // stage s holds K at sm + 2*s*TILE and V right after it; tile kt + 1 is
  // copied (cp.async) while tile kt computes
  auto load_tile = [&](int kt, int stage) {
    load_pair<T, DP, BK, NTHREADS>(sm + 2 * stage * TILE, kb, vb, kt * BK,
                                   p.Sk, D, tid);
    cp_async_commit();
  };
  if (kt_lo < kt_hi) load_tile(kt_lo, 0);

  for (int kt = kt_lo; kt < kt_hi; ++kt) {
    const int k0 = kt * BK, stage = (kt - kt_lo) & 1;
    if (kt + 1 < kt_hi) {
      load_tile(kt + 1, stage ^ 1);         // read two tiles ago: free
      cp_async_wait<1>();                   // tile kt has landed
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const T* Ks = sm + 2 * stage * TILE;
    const T* Vs = Ks + TILE;

    float sf[BK / 8][4];
    mma_abt<T, DP, BK, LD>(sf, qa, Ks, lane);   // S = Q K^T
    if (EXTRAS) {               // scale, softcap, ALiBi, masks
#pragma unroll
      for (int j = 0; j < BK / 8; ++j)
#pragma unroll
        for (int c = 0; c < 4; ++c)
          sf[j][c] = score(p, sf[j][c] * p.sm_scale, b, bh, c < 2 ? r0 : r1,
                           k0 + j * 8 + cq + (c & 1), slope);
    } else {
      // the warp's rows start at q position warp_q0: a tile needs the
      // causal mask only if its last key lies past it, and the edge mask
      // only if it runs past Sk (rows past S are never written)
      const int warp_q0 = q0 + warp * 16 + (p.Sk - p.S);
      const bool masked = (p.causal && k0 + BK - 1 > warp_q0) ||
                          k0 + BK > p.Sk;
#pragma unroll
      for (int j = 0; j < BK / 8; ++j)
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          const float s = sf[j][c] * p.sm_scale;
          if (masked) {
            const int key = k0 + j * 8 + cq + (c & 1);
            const int q_pos = (c < 2 ? r0 : r1) + (p.Sk - p.S);
            const bool keep = key < p.Sk && (!p.causal || key <= q_pos);
            sf[j][c] = keep ? s : NEG_INF;
          } else {
            sf[j][c] = s;
          }
        }
    }
    // online softmax for the thread's two rows (a row spans a lane quad)
#pragma unroll
    for (int rr = 0; rr < 2; ++rr) {
      float mx = m[rr];
#pragma unroll
      for (int j = 0; j < BK / 8; ++j)
        mx = fmaxf(mx, fmaxf(sf[j][2 * rr], sf[j][2 * rr + 1]));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      // exp(x - mx) as exp2(x * log2(e) - mx * log2(e)): one FFMA + EX2
      // for a live x; the rescale takes the difference first, so m == mx
      // == -1e30 (no live key yet) gives exactly 1, not the rounding
      // error of -1e30 * log2(e)
      const float mxl = mx * LOG2E;
      const float alpha = exp2f((m[rr] - mx) * LOG2E);
      float ps = 0.f;
#pragma unroll
      for (int j = 0; j < BK / 8; ++j)
#pragma unroll
        for (int c = 2 * rr; c < 2 * rr + 2; ++c) {
          const float e = sf[j][c] > 0.5f * NEG_INF
                              ? exp2f(fmaf(sf[j][c], LOG2E, -mxl)) : 0.f;
          sf[j][c] = e;
          ps += e;
        }
      l[rr] = l[rr] * alpha + ps;
      m[rr] = mx;
#pragma unroll
      for (int n = 0; n < DP / 8; ++n) {
        of[n][2 * rr] *= alpha;
        of[n][2 * rr + 1] *= alpha;
      }
    }
    mma_ab<T, DP, BK, LD>(of, sf, Vs, lane);    // O += P V
    __syncthreads();                        // the stage is refilled next
  }

  if (OWN_SMEM) cp_async_wait<0>();         // no key tile: Q was not waited for
  // finalize: the quad's partial sums, then o = acc / l and the lse
  float inv[2];
#pragma unroll
  for (int rr = 0; rr < 2; ++rr) {
    float lt = l[rr];
    lt += __shfl_xor_sync(0xffffffffu, lt, 1);
    lt += __shfl_xor_sync(0xffffffffu, lt, 2);
    inv[rr] = 1.f / (lt == 0.f ? 1.f : lt);
    const int row = rr ? r1 : r0;
    if (row < p.S && lane % 4 == 0)
      p.lse[(size_t)bh * p.S + row] = m[rr] + logf(fmaxf(lt, 1e-37f));
  }
  store_rows<T, DP>(static_cast<T*>(p.o) + (size_t)bh * p.S * D, of, r0, r1,
                    p.S, D, cq, inv[0], inv[1]);
}

// ------------------------------------------------------------------- f32

// TPR threads per query row (64 rows a CTA), each owning the float4 slices
// 4 (TPR i + t) .. + 3 of its row: 2 threads up to width 128, 4 above
template <int DP> struct F32Row {
  static constexpr int TPR = DP > 128 ? 4 : 2;
  static constexpr int NT = BQ * TPR;       // threads a CTA
  static constexpr int DH = DP / TPR;       // dims a thread owns
  static constexpr int BK = DP > 128 ? 16 : 32;   // keys a shared tile
};

template <int DP>
__global__ void __launch_bounds__(F32Row<DP>::NT)
flash_fwd_f32(Params p) {
  using L = F32Row<DP>;
  constexpr int BK = L::BK, DH = L::DH, TPR = L::TPR, NT = L::NT;
  __shared__ __align__(16) float Ks[BK * DP];
  __shared__ __align__(16) float Vs[BK * DP];
  const int D = p.D;
  const float* k = static_cast<const float*>(p.k);
  const float* v = static_cast<const float*>(p.v);

  const int qt = gridDim.x - 1 - blockIdx.x;
  const int bh = blockIdx.y, b = bh / p.H, h = bh % p.H;
  const int tid = threadIdx.x, t = tid % TPR;
  const int q0 = qt * BQ, row = q0 + tid / TPR;
  const float slope = p.slopes ? p.slopes[h] : 0.f;

  // this thread's dims: 4 TPR i + 4 t + {0..3}; zeros past D
  float qv[DH], acc[DH];
  const float* qr = static_cast<const float*>(p.q) +
                    ((size_t)bh * p.S + min(row, p.S - 1)) * D;
#pragma unroll
  for (int i = 0; i < DH / 4; ++i) {
    const float4 x = load_f4(qr, 4 * (TPR * i + t), D);
    qv[4 * i] = x.x; qv[4 * i + 1] = x.y; qv[4 * i + 2] = x.z; qv[4 * i + 3] = x.w;
  }
#pragma unroll
  for (int i = 0; i < DH; ++i) acc[i] = 0.f;
  float m = NEG_INF, l = 0.f;

  int kt_lo, kt_hi;
  tile_range(p, q0, min(q0 + BQ, p.S) - 1, BK, &kt_lo, &kt_hi);
  const float* kb = k + (size_t)bh * p.Sk * D;
  const float* vb = v + (size_t)bh * p.Sk * D;

  for (int kt = kt_lo; kt < kt_hi; ++kt) {
    const int k0 = kt * BK;
    __syncthreads();
    for (int idx = tid; idx < BK * DP / 4; idx += NT) {
      const int rr = idx / (DP / 4), c = (idx % (DP / 4)) * 4;
      const int key = k0 + rr;
      float4 kv = make_float4(0.f, 0.f, 0.f, 0.f), vv = kv;
      if (key < p.Sk) {
        kv = load_f4(kb + (size_t)key * D, c, D);
        vv = load_f4(vb + (size_t)key * D, c, D);
      }
      *reinterpret_cast<float4*>(&Ks[rr * DP + c]) = kv;
      *reinterpret_cast<float4*>(&Vs[rr * DP + c]) = vv;
    }
    __syncthreads();

    float sc[BK];
    float mx = m;
#pragma unroll
    for (int kk = 0; kk < BK; ++kk) {
      const float* kr = &Ks[kk * DP + 4 * t];
      float dot = 0.f;
#pragma unroll
      for (int i = 0; i < DH / 4; ++i) {
        const float4 x = *reinterpret_cast<const float4*>(kr + 4 * TPR * i);
        dot = fmaf(qv[4 * i], x.x, dot);
        dot = fmaf(qv[4 * i + 1], x.y, dot);
        dot = fmaf(qv[4 * i + 2], x.z, dot);
        dot = fmaf(qv[4 * i + 3], x.w, dot);
      }
#pragma unroll
      for (int o = 1; o < TPR; o <<= 1)        // the row's threads
        dot += __shfl_xor_sync(0xffffffffu, dot, o);
      sc[kk] = score(p, dot * p.sm_scale, b, bh, row, k0 + kk, slope);
      mx = fmaxf(mx, sc[kk]);
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
    for (int i = 0; i < DH; ++i) acc[i] *= alpha;
#pragma unroll
    for (int kk = 0; kk < BK; ++kk) {
      const float* vr = &Vs[kk * DP + 4 * t];
#pragma unroll
      for (int i = 0; i < DH / 4; ++i) {
        const float4 x = *reinterpret_cast<const float4*>(vr + 4 * TPR * i);
        acc[4 * i] = fmaf(sc[kk], x.x, acc[4 * i]);
        acc[4 * i + 1] = fmaf(sc[kk], x.y, acc[4 * i + 1]);
        acc[4 * i + 2] = fmaf(sc[kk], x.z, acc[4 * i + 2]);
        acc[4 * i + 3] = fmaf(sc[kk], x.w, acc[4 * i + 3]);
      }
    }
  }

  if (row < p.S) {
    const float ls = l == 0.f ? 1.f : l;
    float* orow = static_cast<float*>(p.o) + ((size_t)bh * p.S + row) * D;
#pragma unroll
    for (int i = 0; i < DH / 4; ++i) {
      const int c = 4 * (TPR * i + t);
      if (c < D)
        *reinterpret_cast<float4*>(orow + c) =
            make_float4(acc[4 * i] / ls, acc[4 * i + 1] / ls,
                        acc[4 * i + 2] / ls, acc[4 * i + 3] / ls);
    }
    if (t == 0)
      p.lse[(size_t)bh * p.S + row] = m + logf(fmaxf(l, 1e-37f));
  }
}

// ------------------------------------------------- head dims above 256

// this file's schedule and masks for attention_wide.cuh: own query tiles
// from the last (the longest causal rows first), the key tiles that
// tile_range leaves, and the whole score pipeline on every score
struct Wide {
  using Prm = Params;
  template <bool QMAJOR>
  static __device__ int own(const Params&, int, int rank) {
    return gridDim.y - 1 - rank;
  }
  template <bool QMAJOR>
  static __device__ void list(const Params& p, int, int t, int* e0, int* e1) {
    tile_range(p, t * wide::R, min(t * wide::R + wide::R, p.S) - 1, wide::R,
               e0, e1);
  }
  template <bool QMAJOR>
  static __device__ int other(const Params&, int, int, int e) {
    return e * wide::R;
  }
  template <bool QMAJOR, int NJ>
  static __device__ void scores(const Params& p, int bh, int, int,
                                float (*s)[4], float (*)[4], int a0, int a1,
                                int b0, int cq) {
    const float slope = p.slopes ? p.slopes[bh % p.H] : 0.f;
#pragma unroll
    for (int j = 0; j < NJ; ++j)
#pragma unroll
      for (int c = 0; c < 4; ++c)
        s[j][c] = score(p, s[j][c], bh / p.H, bh, c < 2 ? a0 : a1,
                        b0 + j * 8 + cq + (c & 1), slope);
  }
};

// ------------------------------------------- Hopper: wgmma + TMA

using namespace hopper;

// 2^x by the SFU (ex2.approx.ftz: about 2 ulp); -huge gives exactly 0
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

constexpr int WG_BQ = 128;        // query rows a work item: two consumer warpgroups
constexpr int WG_NT = 384;        // the producer warpgroup and the consumers
constexpr int WG_STAGES = 2;      // slots of each of the K and V rings
constexpr int WG_CONSUMERS = 256;
constexpr size_t WG_SMEM_MAX = 227 * 1024;

// the tiles of head dim D: BK keys a K or V tile, DS sub-tiles of 64
// columns (128-byte rows), KSTEPS k steps of 16 in Q K^T, QBUF Q buffers
// (two where they fit: the next item's Q loads under this one)
template <int D> struct WgTile {
  static constexpr int BK = D > 128 ? 64 : 128;
  static constexpr int DS = (D + 63) / 64;
  static constexpr int KSTEPS = (D + 15) / 16;
  static constexpr int Q_BYTES = DS * WG_BQ * 128;
  static constexpr int KV_BYTES = DS * BK * 128;       // one K or V tile
  static constexpr int RING = 2 * WG_STAGES * KV_BYTES;
  static constexpr int QBUF = 2048 + 2 * Q_BYTES + RING <= WG_SMEM_MAX ? 2 : 1;
  static constexpr int BARS = 2 * QBUF + 4 * WG_STAGES;
  static constexpr size_t SMEM = 1024 + QBUF * Q_BYTES + RING +
                                 BARS * sizeof(uint64_t);
};

struct WgMaps {                   // [BH, rows, D] tensor maps
  CUtensorMap q, k, v;
};

// K and V bytes of the heads whose work items run together: they stay in
// the L2 cache (50 MB) while every query tile of those heads reads them
// (on an H100, groups of 8 MB ran the generate prefill 10% slower than
// 32 MB, from the imbalance of short groups; PERF.md, PR 7)
constexpr size_t WG_GROUP_BYTES = 32u << 20;

// work item `item` of a call: (query tile, b*h). The heads go in groups of
// GH; inside a group every head's last query tile (the longest causal
// rows) first
__device__ __forceinline__ void wg_item(const Params& p, int item, int BH,
                                        int GH, int bk, int* q0, int* bh,
                                        int* lo, int* n) {
  const int ntq = (p.S + WG_BQ - 1) / WG_BQ;
  const int grp = item / (GH * ntq), r = item % (GH * ntq);
  const int heads = min(GH, BH - grp * GH);   // the last group may be short
  *q0 = (ntq - 1 - r / heads) * WG_BQ;
  *bh = grp * GH + r % heads;
  int hi;
  tile_range(p, *q0, min(*q0 + WG_BQ, p.S) - 1, bk, lo, &hi);
  *n = max(hi - *lo, 0);
}

// Persistent: one CTA an SM walks the work items blockIdx.x, + gridDim.x,
// ...; the producer runs ahead into the next item (its Q and first K, V
// tiles) while the consumers finish this one, and every ring slot's phase
// follows a tile count g that runs on across items.
template <typename T, int D>
__global__ void __launch_bounds__(WG_NT, 1)
flash_fwd_wg(const __grid_constant__ WgMaps maps, Params p, int BH,
             int GH) {
  using L = WgTile<D>;
  constexpr int BK = L::BK, ST = WG_STAGES, QB = L::QBUF;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* qs = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  unsigned char* ks = qs + QB * L::Q_BYTES;            // [slot][DS][BK][64]
  unsigned char* vs = ks + ST * L::KV_BYTES;
  uint64_t* q_full = reinterpret_cast<uint64_t*>(vs + ST * L::KV_BYTES);
  uint64_t* q_empty = q_full + QB;
  uint64_t* k_full = q_empty + QB;
  uint64_t* k_empty = k_full + ST;
  uint64_t* v_full = k_empty + ST;
  uint64_t* v_empty = v_full + ST;

  const int items = (p.S + WG_BQ - 1) / WG_BQ * BH;
  // the warpgroup index through a shuffle: provably warp-uniform, so the
  // roles' branches do not make the compiler serialize the wgmma
  const int tid = threadIdx.x;
  const int wg = __shfl_sync(0xffffffffu, tid / 128, 0);
  if (tid == 0) {
    for (int b = 0; b < QB; ++b) {
      mbar_init(&q_full[b], 1);
      mbar_init(&q_empty[b], WG_CONSUMERS);
    }
    for (int b = 0; b < ST; ++b) {
      mbar_init(&k_full[b], 1);
      mbar_init(&v_full[b], 1);
      mbar_init(&k_empty[b], WG_CONSUMERS);
      mbar_init(&v_empty[b], WG_CONSUMERS);
    }
    fence_mbar_init();
  }
  __syncthreads();

  if (wg == 0) {                  // the producer: one thread issues the TMA
    regs_dealloc<40>();
    if (tid == 0) {
      int g = 0, k = 0;
      for (int item = blockIdx.x; item < items; item += gridDim.x, ++k) {
        int q0, bh, lo, n;
        wg_item(p, item, BH, GH, BK, &q0, &bh, &lo, &n);
        const int qb = k % QB;
        if (k >= QB) mbar_wait(&q_empty[qb], ((k / QB) - 1) & 1);
        mbar_arrive_expect_tx(&q_full[qb], L::Q_BYTES);
        for (int ds = 0; ds < L::DS; ++ds)
          tma_tile(qs + qb * L::Q_BYTES + ds * WG_BQ * 128, &maps.q,
                   &q_full[qb], 64 * ds, q0, bh);
        for (int i = 0; i < n; ++i, ++g) {
          const int st = g % ST, key0 = (lo + i) * BK;
          if (g >= ST) mbar_wait(&k_empty[st], ((g / ST) - 1) & 1);
          mbar_arrive_expect_tx(&k_full[st], L::KV_BYTES);
          for (int ds = 0; ds < L::DS; ++ds)
            tma_tile(ks + st * L::KV_BYTES + ds * BK * 128, &maps.k,
                     &k_full[st], 64 * ds, key0, bh);
          if (g >= ST) mbar_wait(&v_empty[st], ((g / ST) - 1) & 1);
          mbar_arrive_expect_tx(&v_full[st], L::KV_BYTES);
          for (int ds = 0; ds < L::DS; ++ds)
            tma_tile(vs + st * L::KV_BYTES + ds * BK * 128, &maps.v,
                     &v_full[st], 64 * ds, key0, bh);
        }
      }
    }
    return;
  }

  regs_alloc<232>();
  // consumer c: rows q0 + 64 c + 16 warp + lane / 4 (+ 8) of each
  // accumulator, columns 8 j + 2 (lane % 4) (+ 1)
  const int c = wg - 1, warp = (tid / 32) % 4, lane = tid % 32;
  const int cq = (lane % 4) * 2;
  const int me = 1 + c, other = 2 - c;        // the turns' named barriers
  const float scale_log2 = p.sm_scale * LOG2E;
  float of[D / 8][4], sf[BK / 8][4];
  uint32_t pf[BK / 16][4];                    // P of the last tile, packed
  float m[2], l[2], alpha[2];
  int g = 0, k = 0;                           // tiles and items so far
  int q0, bh, lo, n, r0, r1, warp_q0;
  const unsigned char* qa;

  auto issue_s = [&](int j) {                 // S = Q K^T of tile j
    const unsigned char* kt = ks + ((g + j) % ST) * L::KV_BYTES;
#pragma unroll
    for (int kk = 0; kk < L::KSTEPS; ++kk) {
      const int sub = kk / 4, w = kk % 4;     // sub-tile, 32 bytes a step
      Wgmma<BK>::template ss<T>(
          sf, desc_sw128(qa + sub * WG_BQ * 128) + 2 * w,
          desc_sw128(kt + sub * BK * 128) + 2 * w, kk > 0);
    }
  };
  auto issue_pv = [&](int j) {                // O += P V of tile j
    const uint64_t dv =
        desc_sw128(vs + ((g + j) % ST) * L::KV_BYTES, BK * 128);
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk)      // 16 rows (2048 bytes) a step
      Wgmma<D>::template rs<T>(of, pf[kk], dv + 128 * kk);
  };
  // P of tile j: mask S where the tile crosses the warp's causal diagonal
  // or the ragged edge (one branch a tile, none per element), then the
  // online softmax of the thread's two rows on the unscaled scores: exp((s
  // - mx) sm_scale) as one FFMA and one EX2 an element. A row without a
  // live key yet (mx == -1e30) takes its offset as 0, so its masked
  // scores still give exactly 0, and m == mx == -1e30 rescales by exactly
  // 1. Updates m, l (unscaled max, sum) and O's rescale alpha
  auto softmax = [&](int j) {
    const int k0 = (lo + j) * BK;
    if ((p.causal && k0 + BK - 1 > warp_q0) || k0 + BK > p.Sk) {
#pragma unroll
      for (int jj = 0; jj < BK / 8; ++jj)
#pragma unroll
        for (int cc = 0; cc < 4; ++cc) {
          const int key = k0 + jj * 8 + cq + (cc & 1);
          const int q_pos = (cc < 2 ? r0 : r1) + (p.Sk - p.S);
          if (!(key < p.Sk && (!p.causal || key <= q_pos)))
            sf[jj][cc] = NEG_INF;
        }
    }
#pragma unroll
    for (int rr = 0; rr < 2; ++rr) {
      float mx = m[rr];
#pragma unroll
      for (int jj = 0; jj < BK / 8; ++jj)
        mx = fmaxf(mx, fmaxf(sf[jj][2 * rr], sf[jj][2 * rr + 1]));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      const float mxs = mx == NEG_INF ? 0.f : mx * scale_log2;
      alpha[rr] = ex2((m[rr] - mx) * scale_log2);
      float ps = 0.f;
#pragma unroll
      for (int jj = 0; jj < BK / 8; ++jj)
#pragma unroll
        for (int cc = 2 * rr; cc < 2 * rr + 2; ++cc) {
          const float e = ex2(fmaf(sf[jj][cc], scale_log2, -mxs));
          sf[jj][cc] = e;
          ps += e;
        }
      l[rr] = l[rr] * alpha[rr] + ps;
      m[rr] = mx;
    }
  };
  auto rescale_pack = [&]() {                 // O *= alpha; P -> A operand
#pragma unroll
    for (int jj = 0; jj < D / 8; ++jj) {
      of[jj][0] *= alpha[0];
      of[jj][1] *= alpha[0];
      of[jj][2] *= alpha[1];
      of[jj][3] *= alpha[1];
    }
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) pack_a<T>(pf[kk], sf, kk);
  };

  for (int item = blockIdx.x; item < items; item += gridDim.x, ++k) {
    wg_item(p, item, BH, GH, BK, &q0, &bh, &lo, &n);
    r0 = q0 + 64 * c + warp * 16 + lane / 4;
    r1 = r0 + 8;
    warp_q0 = q0 + 64 * c + warp * 16 + (p.Sk - p.S);
    const int qb = k % QB;
    qa = qs + qb * L::Q_BYTES + c * 64 * 128;
#pragma unroll
    for (int jj = 0; jj < D / 8; ++jj)
      of[jj][0] = of[jj][1] = of[jj][2] = of[jj][3] = 0.f;
    m[0] = m[1] = NEG_INF;
    l[0] = l[1] = 0.f;
    mbar_wait(&q_full[qb], (k / QB) & 1);

    // Turn j issues S of tile j and O += P V of tile j - 1 (turn 0 only
    // S, turn n only P V), hands the turn to the other consumer and runs
    // the softmax, which waits only for S, while its P V runs. The turns
    // alternate, consumer 0 first. No wgmma sits in a branch that the
    // compiler cannot prove uniform (it would serialize them).
    if (n > 0) {
      if (c == 1) named_arrive(other, WG_CONSUMERS);
      mbar_wait(&k_full[g % ST], (g / ST) & 1);
      named_sync(me, WG_CONSUMERS);
      fence_acc<BK / 8>(sf);
      wg_fence();
      issue_s(0);
      wg_commit();
      named_arrive(other, WG_CONSUMERS);
      wg_wait<0>();
      fence_acc<BK / 8>(sf);
      mbar_arrive(&k_empty[g % ST]);
      softmax(0);
      rescale_pack();
      for (int j = 1; j < n; ++j) {
        const int t = g + j;
        mbar_wait(&k_full[t % ST], (t / ST) & 1);
        mbar_wait(&v_full[(t - 1) % ST], ((t - 1) / ST) & 1);
        named_sync(me, WG_CONSUMERS);
        fence_acc<D / 8>(of);
        fence_acc<BK / 8>(sf);
        wg_fence();
        issue_s(j);
        wg_commit();
        issue_pv(j - 1);
        wg_commit();
        named_arrive(other, WG_CONSUMERS);
        wg_wait<1>();                         // S has landed
        fence_acc<BK / 8>(sf);
        mbar_arrive(&k_empty[t % ST]);
        softmax(j);
        wg_wait<0>();                         // P V has landed
        fence_acc<D / 8>(of);
        mbar_arrive(&v_empty[(t - 1) % ST]);
        rescale_pack();
      }
    }
    mbar_arrive(&q_empty[qb]);                // every S of this item is done
    if (n > 0) {
      const int t = g + n - 1;
      mbar_wait(&v_full[t % ST], (t / ST) & 1);
      named_sync(me, WG_CONSUMERS);
      fence_acc<D / 8>(of);
      wg_fence();
      issue_pv(n - 1);
      wg_commit();
      if (c == 0) named_arrive(other, WG_CONSUMERS);
      wg_wait<0>();
      fence_acc<D / 8>(of);
      mbar_arrive(&v_empty[t % ST]);
    }
    g += n;

    float inv[2];
#pragma unroll
    for (int rr = 0; rr < 2; ++rr) {
      float lt = l[rr];
      lt += __shfl_xor_sync(0xffffffffu, lt, 1);
      lt += __shfl_xor_sync(0xffffffffu, lt, 2);
      inv[rr] = 1.f / (lt == 0.f ? 1.f : lt);
      const int row = rr ? r1 : r0;
      // m is the unscaled max: lse = m sm_scale + log(max(l, 1e-37)), -1e30
      // for a row without a live key as in the other kernels
      const float ms = m[rr] == NEG_INF ? NEG_INF : m[rr] * p.sm_scale;
      if (row < p.S && lane % 4 == 0)
        p.lse[(size_t)bh * p.S + row] = ms + logf(fmaxf(lt, 1e-37f));
    }
    store_rows<T, D>(static_cast<T*>(p.o) + (size_t)bh * p.S * D, of, r0,
                     r1, p.S, D, cq, inv[0], inv[1]);
  }
}

// the head dims the wgmma kernel is built for (16-bit, no extras)
__host__ __device__ constexpr bool wg_dim(int d) {
  return d == 64 || d == 80 || d == 96 || d == 128 || d == 192 || d == 256;
}

template <typename T, int D>
int launch_wg(const Params& p, int BH, cudaStream_t st) {
  using L = WgTile<D>;
  const bool bf = std::is_same<T, bf16>::value;
  WgMaps maps;
  if (!tile_map(&maps.q, p.q, bf, p.S, BH, D, WG_BQ) ||
      !tile_map(&maps.k, p.k, bf, p.Sk, BH, D, L::BK) ||
      !tile_map(&maps.v, p.v, bf, p.Sk, BH, D, L::BK))
    return ERR_TENSOR_MAP;
  const cudaError_t e = cudaFuncSetAttribute(
      flash_fwd_wg<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)L::SMEM);
  if (e != cudaSuccess) return static_cast<int>(e);
  static int sms = 0;                       // one CTA an SM, persistent
  if (!sms) {
    int dev = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  }
  const int items = (p.S + WG_BQ - 1) / WG_BQ * BH;
  const size_t head_bytes = (size_t)p.Sk * D * 2 * sizeof(T);   // K and V
  const int GH = head_bytes >= WG_GROUP_BYTES
                     ? 1 : (int)(WG_GROUP_BYTES / head_bytes);
  flash_fwd_wg<T, D><<<min(items, sms), WG_NT, L::SMEM, st>>>(maps, p, BH,
                                                               GH);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int dispatch_wg(const Params& p, int BH, cudaStream_t st) {
  switch (p.D) {
    case 64: return launch_wg<T, 64>(p, BH, st);
    case 80: return launch_wg<T, 80>(p, BH, st);
    case 96: return launch_wg<T, 96>(p, BH, st);
    case 128: return launch_wg<T, 128>(p, BH, st);
    case 192: return launch_wg<T, 192>(p, BH, st);
    default: return launch_wg<T, 256>(p, BH, st);
  }
}

// ---------------------------------------------------------------- launch

template <typename KernelFn>
int launch(KernelFn kernel, const Params& p, int BH, cudaStream_t stream,
           size_t smem = 0, int threads = NTHREADS) {
  if (smem > 48 * 1024) {                   // above 48 KB only by opt-in
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  dim3 grid((p.S + BQ - 1) / BQ, BH);
  kernel<<<grid, threads, smem, stream>>>(p);
  return static_cast<int>(cudaGetLastError());
}

// the mma.sync kernel at width DP. A compile-time width (EXACT) where D ==
// DP up to 128; D 64, 96 and 128 without extras run the wgmma kernel, so
// of their exact variants only the one with extras is built
template <typename T, int DP>
int launch_mma(const Params& p, int BH, bool extras, cudaStream_t st) {
  constexpr size_t smem =
      pair_smem_bytes<T, DP>(BK16) + own_smem_bytes<T, DP>(1);
  if constexpr (DP <= 128) {
    if (p.D == DP && extras)
      return launch(flash_fwd_mma<T, DP, true, true>, p, BH, st, smem);
    if constexpr (DP == 32)
      if (p.D == DP)
        return launch(flash_fwd_mma<T, DP, false, true>, p, BH, st, smem);
  }
  return extras ? launch(flash_fwd_mma<T, DP, true, false>, p, BH, st, smem)
                : launch(flash_fwd_mma<T, DP, false, false>, p, BH, st, smem);
}

template <int DP>
int launch_dp(const Params& p, int BH, int dtype, bool extras,
              cudaStream_t st) {
  if (dtype == 0)
    return launch(flash_fwd_f32<DP>, p, BH, st, 0, F32Row<DP>::NT);
  if (dtype == 1) return launch_mma<bf16, DP>(p, BH, extras, st);
  return launch_mma<f16, DP>(p, BH, extras, st);
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16, 2 = float16 (q, k, v and o alike).
// D: any multiple of 8. Returns the CUDA error of the launch
// (0 = launched); -1 for a dtype or head dim the kernels lack, -2 when a
// TMA tensor map cannot be encoded.
int flash_attention_fwd_launch(const void* q, const void* k, const void* v,
                               const void* kvm, const void* qkm,
                               const void* slopes, void* o, void* lse, int BH,
                               int H, int S, int Sk, int D, int causal,
                               int window, int qkm_per_head, float sm_scale,
                               float softcap, int dtype, void* stream) {
  Params p;
  p.q = q; p.k = k; p.v = v;
  p.kvm = static_cast<const int*>(kvm);
  p.qkm = static_cast<const int*>(qkm);
  p.slopes = static_cast<const float*>(slopes);
  p.o = o;
  p.lse = static_cast<float*>(lse);
  p.H = H; p.S = S; p.Sk = Sk; p.D = D; p.causal = causal; p.window = window;
  p.qkm_per_head = qkm_per_head;
  p.sm_scale = sm_scale; p.softcap = softcap;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype < 0 || dtype > 2 || D < 8 || D % 8) return -1;
  if (S <= 0 || BH <= 0) return 0;
  if (D > wide::FROM_DIM) {
    wide::Args w = {};
    w.q = q; w.k = k; w.v = v; w.o = o; w.lse_out = p.lse;
    w.kv_head = (size_t)Sk * D;
    w.Sq = S; w.Sk = Sk; w.D = D; w.sm_scale = sm_scale;
    return wide::launch<0, Wide>(w, p, BH, (S + wide::R - 1) / wide::R,
                                 dtype, st);
  }
  const bool extras = kvm || qkm || slopes || window > 0 || softcap > 0.f;
  if (dtype != 0 && !extras && wg_dim(D))   // the Hopper kernel
    return dtype == 1 ? dispatch_wg<bf16>(p, BH, st)
                      : dispatch_wg<f16>(p, BH, st);
  switch (pad_dim(D)) {
    case 32: return launch_dp<32>(p, BH, dtype, extras, st);
    case 64: return launch_dp<64>(p, BH, dtype, extras, st);
    case 96: return launch_dp<96>(p, BH, dtype, extras, st);
    case 128: return launch_dp<128>(p, BH, dtype, extras, st);
    case 192: return launch_dp<192>(p, BH, dtype, extras, st);
    default: return launch_dp<256>(p, BH, dtype, extras, st);
  }
}

const char* flash_attention_fwd_error_string(int err) {
  if (err == ERR_TENSOR_MAP) return "TMA tensor map encoding failed";
  return err < 0 ? "unsupported dtype or head dim"
                 : cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"

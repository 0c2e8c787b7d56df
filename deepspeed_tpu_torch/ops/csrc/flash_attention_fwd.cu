// Flash attention forward (FlashAttention-2 schedule) for Hopper (sm_90a),
// plain C interface.
//
// Replaces the forward Pallas kernel of
// deepspeed_tpu/ops/pallas/flash_attention.py (_fwd_kernel, launched by
// _fwd). q, k, v [B*H, S|Sk, D] -> o [B*H, S, D] and the row logsumexp
// lse [B*H, S] f32, with in-kernel causal masking (offset Sk - S: the last
// query row sees every key), a key-padding row [B, Sk] or (q, k) tiles per
// batch [B, S, Sk] or per head [B*H, S, Sk] (int32, nonzero = attend),
// ALiBi slope * (k - q), a causal sliding window, and the Gemma-2 softcap.
//
// Bound: bytes at head_dim 64, where a causal prefill does ~D/2 flops per
// byte moved only when the whole of q, k, v and o is read or written once
// per (q tile, k tile) pair in registers and shared memory. The design
// therefore never writes the S x Sk scores: each CTA keeps its 64 query
// rows' scores, softmax statistics and output accumulator in registers,
// streams the K/V tiles of 64 keys through shared memory, and skips the
// key tiles that the causal triangle or the window excludes.
//
// bf16 layout: one CTA per (64-row q tile, b*h) with 4 warps of 16 rows.
// S = Q K^T and O += P V run on the tensor cores with
// mma.sync.aligned.m16n8k16 (bf16 in, f32 accumulate); the accumulator
// layout of that instruction is documented (thread lane holds rows
// lane/4 and lane/4 + 8, columns 2*(lane%4) + {0, 1} of each 16x8 tile),
// so the masks, softcap, ALiBi and the online softmax apply in registers
// and the P tile is repacked in registers as the A operand of P V. K/V
// tiles are double-buffered: tile k+1 is copied by cp.async while tile k
// computes. The K and V operands come from shared memory by ldmatrix
// (.trans for V), whose rows are padded by 8 elements so each 8-row phase
// hits distinct banks. Without a mask, bias, window or softcap, only the
// tiles that cross the causal diagonal or the ragged edge run the mask.
//
// f32 layout: CUDA-core FMAs, so f32 results stay f32 (no TF32). One CTA
// per (64-row q tile, b*h), two threads per query row, each owning half
// of the head dim (float4 slices interleaved so the pair reads distinct
// banks); tiles of 32 keys in shared memory; the pair's partial dot
// products meet by one shuffle.
//
// Numerics follow the TPU kernel: f32 scores scaled by sm_scale, softcap
// before the ALiBi term, the bias before the masks, masked entries set to
// -1e30 and their p to exactly 0 (always guarded, which is exact), p
// rounded to the value dtype before P V, a row with no live key writes
// zeros, and lse = m + log(max(l, 1e-37)). Keys past Sk and queries past S
// (the ragged edge) are masked here; the TPU wrapper instead sends
// untileable shapes to its reference.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

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
  int H, S, Sk, causal, window, qkm_per_head;
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

// four 8x8 b16 matrices from shared memory; lanes 8i..8i+7 give the row
// addresses of matrix i. Without .trans lane l receives (row l/4, columns
// 2*(l%4) + {0, 1}) of each; with .trans (rows 2*(l%4) + {0, 1}, column
// l/4), i.e. the transposed matrix.
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
// zeros (the ragged edge)
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

constexpr float LOG2E = 1.4426950408889634f;
constexpr int BK16 = 64;          // keys per bf16 tile

// dynamic shared memory of the bf16 kernel: two stages of K and V tiles,
// rows padded by 8 elements
template <int D> constexpr size_t bf16_smem_bytes() {
  return 2 * 2 * BK16 * (D + 8) * sizeof(__nv_bfloat16);
}

// EXTRAS: a mask, ALiBi, a window or a softcap is given and every score
// runs the full pipeline; without, only tiles that cross the causal
// diagonal or the ragged edge are masked. On an H100 the full pipeline on
// every score takes a causal llama-1.1b prefill (22 launches, B 8, 32
// heads, S 1024, D 64) from 5.8 to 9.8 ms (PERF.md, Findings).
template <int D, bool EXTRAS>
__global__ void __launch_bounds__(NTHREADS)
flash_fwd_bf16(Params p) {
  constexpr int BK = BK16, LD = D + 8;      // padded shared-memory row
  constexpr int TILE = BK * LD;             // elements of one K or V tile
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* sm = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  const __nv_bfloat16* q = static_cast<const __nv_bfloat16*>(p.q);
  const __nv_bfloat16* k = static_cast<const __nv_bfloat16*>(p.k);
  const __nv_bfloat16* v = static_cast<const __nv_bfloat16*>(p.v);
  __nv_bfloat16* o = static_cast<__nv_bfloat16*>(p.o);

  const int qt = gridDim.x - 1 - blockIdx.x;  // the longest causal rows first
  const int bh = blockIdx.y, b = bh / p.H, h = bh % p.H;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int q0 = qt * BQ;
  const int r0 = q0 + warp * 16 + lane / 4, r1 = r0 + 8;
  const int cq = (lane % 4) * 2;
  const float slope = p.slopes ? p.slopes[h] : 0.f;

  // Q as A fragments (rows r0 / r1, k columns cq, cq + 1 and + 8)
  uint32_t qf[D / 16][4];
  const __nv_bfloat16* qb = q + (size_t)bh * p.S * D;
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    const int c = kk * 16 + cq;
    qf[kk][0] = r0 < p.S ? *reinterpret_cast<const uint32_t*>(qb + (size_t)r0 * D + c) : 0u;
    qf[kk][1] = r1 < p.S ? *reinterpret_cast<const uint32_t*>(qb + (size_t)r1 * D + c) : 0u;
    qf[kk][2] = r0 < p.S ? *reinterpret_cast<const uint32_t*>(qb + (size_t)r0 * D + c + 8) : 0u;
    qf[kk][3] = r1 < p.S ? *reinterpret_cast<const uint32_t*>(qb + (size_t)r1 * D + c + 8) : 0u;
  }

  float of[D / 8][4];
#pragma unroll
  for (int n = 0; n < D / 8; ++n)
    of[n][0] = of[n][1] = of[n][2] = of[n][3] = 0.f;
  float m[2] = {NEG_INF, NEG_INF}, l[2] = {0.f, 0.f};   // l: this thread's part

  int kt_lo, kt_hi;
  tile_range(p, q0, min(q0 + BQ, p.S) - 1, BK, &kt_lo, &kt_hi);
  const __nv_bfloat16* kb = k + (size_t)bh * p.Sk * D;
  const __nv_bfloat16* vb = v + (size_t)bh * p.Sk * D;

  // stage s holds K at sm + 2*s*TILE and V right after it; tile kt + 1 is
  // copied (cp.async) while tile kt computes
  auto load_tile = [&](int kt, int stage) {
    __nv_bfloat16* Kd = sm + 2 * stage * TILE;
    __nv_bfloat16* Vd = Kd + TILE;
    for (int idx = tid; idx < BK * D / 8; idx += NTHREADS) {
      const int rr = idx / (D / 8), c = (idx % (D / 8)) * 8;
      const int key = kt * BK + rr;
      const bool live = key < p.Sk;         // the ragged edge reads zeros
      const size_t src = (size_t)(live ? key : 0) * D + c;
      cp_async16(&Kd[rr * LD + c], kb + src, live ? 16 : 0);
      cp_async16(&Vd[rr * LD + c], vb + src, live ? 16 : 0);
    }
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
    const __nv_bfloat16* Ks = sm + 2 * stage * TILE;
    const __nv_bfloat16* Vs = Ks + TILE;

    // S = Q K^T: 8 tiles of 8 keys. B fragment of k step kk = K rows
    // j*8 + lane/4, columns kk*16 + cq (+ 8); one ldmatrix.x4 gives two
    // k steps (matrix i: rows j*8..j*8+7, columns kk*16 + 8*i)
    float sf[BK / 8][4];
#pragma unroll
    for (int j = 0; j < BK / 8; ++j) {
      sf[j][0] = sf[j][1] = sf[j][2] = sf[j][3] = 0.f;
      const __nv_bfloat16* kr = &Ks[(j * 8 + (lane & 7)) * LD + (lane >> 3) * 8];
#pragma unroll
      for (int kk = 0; kk < D / 16; kk += 2) {
        uint32_t kf[4];
        ldsm_x4(kf, kr + kk * 16);
        mma_bf16(sf[j], qf[kk], kf[0], kf[1]);
        mma_bf16(sf[j], qf[kk + 1], kf[2], kf[3]);
      }
    }
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
      for (int n = 0; n < D / 8; ++n) {
        of[n][2 * rr] *= alpha;
        of[n][2 * rr + 1] *= alpha;
      }
    }
    // O += P V: P (rounded to bf16) repacked as A fragments of 16 keys.
    // B fragment of column tile n = V[keys kk*16 + cq + {0,1} (+8)]
    // [column n*8 + lane/4]; one ldmatrix.x4.trans gives two column tiles
    // (matrix i: keys kk*16 + 8*(i&1) .. +7, columns (n + i/2)*8 .. +7)
    const int v_row = (lane & 7) + ((lane >> 3) & 1) * 8, v_col = (lane >> 4) * 8;
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
      uint32_t a[4];
      a[0] = pack_bf16(sf[2 * kk][0], sf[2 * kk][1]);
      a[1] = pack_bf16(sf[2 * kk][2], sf[2 * kk][3]);
      a[2] = pack_bf16(sf[2 * kk + 1][0], sf[2 * kk + 1][1]);
      a[3] = pack_bf16(sf[2 * kk + 1][2], sf[2 * kk + 1][3]);
      const __nv_bfloat16* vr = &Vs[(kk * 16 + v_row) * LD + v_col];
#pragma unroll
      for (int n = 0; n < D / 8; n += 2) {
        uint32_t vb[4];
        ldsm_x4_trans(vb, vr + n * 8);
        mma_bf16(of[n], a, vb[0], vb[1]);
        mma_bf16(of[n + 1], a, vb[2], vb[3]);
      }
    }
    __syncthreads();                        // the stage is refilled next
  }

  // finalize: the quad's partial sums, then o = acc / l and the lse
#pragma unroll
  for (int rr = 0; rr < 2; ++rr) {
    float lt = l[rr];
    lt += __shfl_xor_sync(0xffffffffu, lt, 1);
    lt += __shfl_xor_sync(0xffffffffu, lt, 2);
    const int row = rr ? r1 : r0;
    if (row >= p.S) continue;
    const float ls = lt == 0.f ? 1.f : lt;
    __nv_bfloat16* orow = o + ((size_t)bh * p.S + row) * D + cq;
#pragma unroll
    for (int n = 0; n < D / 8; ++n)
      *reinterpret_cast<__nv_bfloat162*>(orow + n * 8) =
          __floats2bfloat162_rn(of[n][2 * rr] / ls, of[n][2 * rr + 1] / ls);
    if (lane % 4 == 0)
      p.lse[(size_t)bh * p.S + row] = m[rr] + logf(fmaxf(lt, 1e-37f));
  }
}

// ------------------------------------------------------------------- f32

template <int D>
__global__ void __launch_bounds__(NTHREADS)
flash_fwd_f32(Params p) {
  constexpr int BK = 32, DH = D / 2;        // keys per tile, dims per thread
  __shared__ __align__(16) float Ks[BK * D];
  __shared__ __align__(16) float Vs[BK * D];
  const float* q = static_cast<const float*>(p.q);
  const float* k = static_cast<const float*>(p.k);
  const float* v = static_cast<const float*>(p.v);
  float* o = static_cast<float*>(p.o);

  const int qt = gridDim.x - 1 - blockIdx.x;
  const int bh = blockIdx.y, b = bh / p.H, h = bh % p.H;
  const int tid = threadIdx.x, half = tid & 1;
  const int q0 = qt * BQ, row = q0 + tid / 2;
  const float slope = p.slopes ? p.slopes[h] : 0.f;

  // this thread's dims: 8*i + 4*half + {0..3}
  float qv[DH], acc[DH];
  const float* qr = q + ((size_t)bh * p.S + min(row, p.S - 1)) * D;
#pragma unroll
  for (int i = 0; i < D / 8; ++i) {
    const float4 t = *reinterpret_cast<const float4*>(qr + 8 * i + 4 * half);
    qv[4 * i] = t.x; qv[4 * i + 1] = t.y; qv[4 * i + 2] = t.z; qv[4 * i + 3] = t.w;
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
    for (int idx = tid; idx < BK * D / 4; idx += NTHREADS) {
      const int rr = idx / (D / 4), c = (idx % (D / 4)) * 4;
      const int key = k0 + rr;
      float4 kv = make_float4(0.f, 0.f, 0.f, 0.f), vv = kv;
      if (key < p.Sk) {
        kv = *reinterpret_cast<const float4*>(kb + (size_t)key * D + c);
        vv = *reinterpret_cast<const float4*>(vb + (size_t)key * D + c);
      }
      *reinterpret_cast<float4*>(&Ks[rr * D + c]) = kv;
      *reinterpret_cast<float4*>(&Vs[rr * D + c]) = vv;
    }
    __syncthreads();

    float sc[BK];
    float mx = m;
#pragma unroll
    for (int kk = 0; kk < BK; ++kk) {
      const float* kr = &Ks[kk * D + 4 * half];
      float dot = 0.f;
#pragma unroll
      for (int i = 0; i < D / 8; ++i) {
        const float4 t = *reinterpret_cast<const float4*>(kr + 8 * i);
        dot = fmaf(qv[4 * i], t.x, dot);
        dot = fmaf(qv[4 * i + 1], t.y, dot);
        dot = fmaf(qv[4 * i + 2], t.z, dot);
        dot = fmaf(qv[4 * i + 3], t.w, dot);
      }
      dot += __shfl_xor_sync(0xffffffffu, dot, 1);   // the pair's halves
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
      const float* vr = &Vs[kk * D + 4 * half];
#pragma unroll
      for (int i = 0; i < D / 8; ++i) {
        const float4 t = *reinterpret_cast<const float4*>(vr + 8 * i);
        acc[4 * i] = fmaf(sc[kk], t.x, acc[4 * i]);
        acc[4 * i + 1] = fmaf(sc[kk], t.y, acc[4 * i + 1]);
        acc[4 * i + 2] = fmaf(sc[kk], t.z, acc[4 * i + 2]);
        acc[4 * i + 3] = fmaf(sc[kk], t.w, acc[4 * i + 3]);
      }
    }
  }

  if (row < p.S) {
    const float ls = l == 0.f ? 1.f : l;
    float* orow = o + ((size_t)bh * p.S + row) * D + 4 * half;
#pragma unroll
    for (int i = 0; i < D / 8; ++i)
      *reinterpret_cast<float4*>(orow + 8 * i) =
          make_float4(acc[4 * i] / ls, acc[4 * i + 1] / ls,
                      acc[4 * i + 2] / ls, acc[4 * i + 3] / ls);
    if (half == 0)
      p.lse[(size_t)bh * p.S + row] = m + logf(fmaxf(l, 1e-37f));
  }
}

template <typename KernelFn>
int launch(KernelFn kernel, const Params& p, int BH, cudaStream_t stream,
           size_t smem = 0) {
  if (smem > 48 * 1024) {                   // above 48 KB only by opt-in
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  dim3 grid((p.S + BQ - 1) / BQ, BH);
  kernel<<<grid, NTHREADS, smem, stream>>>(p);
  return static_cast<int>(cudaGetLastError());
}

template <int D>
int launch_bf16(const Params& p, int BH, bool extras, cudaStream_t stream) {
  constexpr size_t smem = bf16_smem_bytes<D>();
  return extras ? launch(flash_fwd_bf16<D, true>, p, BH, stream, smem)
                : launch(flash_fwd_bf16<D, false>, p, BH, stream, smem);
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16 (q, k, v and o alike). D: 32, 64 or
// 128. Returns the CUDA error of the launch (0 = launched); -1 for a
// dtype or head dim the kernel lacks.
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
  p.H = H; p.S = S; p.Sk = Sk; p.causal = causal; p.window = window;
  p.qkm_per_head = qkm_per_head;
  p.sm_scale = sm_scale; p.softcap = softcap;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (S <= 0 || BH <= 0) return 0;
  const bool extras = kvm || qkm || slopes || window > 0 || softcap > 0.f;
  if (dtype == 1) {
    if (D == 32) return launch_bf16<32>(p, BH, extras, st);
    if (D == 64) return launch_bf16<64>(p, BH, extras, st);
    if (D == 128) return launch_bf16<128>(p, BH, extras, st);
  } else if (dtype == 0) {
    if (D == 32) return launch(flash_fwd_f32<32>, p, BH, st);
    if (D == 64) return launch(flash_fwd_f32<64>, p, BH, st);
    if (D == 128) return launch(flash_fwd_f32<128>, p, BH, st);
  }
  return -1;
}

const char* flash_attention_fwd_error_string(int err) {
  return err < 0 ? "unsupported dtype or head dim"
                 : cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"

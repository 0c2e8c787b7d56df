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
// Any head dim D % 8 == 0 up to 128, in f32, bf16 or fp16: the kernels are
// instantiated at a padded width (attention_tile.cuh).
//
// Bound: bytes at head_dim 64, where a causal prefill does ~D/2 flops per
// byte moved only when the whole of q, k, v and o is read or written once
// per (q tile, k tile) pair in registers and shared memory. The design
// therefore never writes the S x Sk scores: each CTA keeps its 64 query
// rows' scores, softmax statistics and output accumulator in registers,
// streams the K/V tiles of 64 keys through shared memory, and skips the
// key tiles that the causal triangle or the window excludes.
//
// bf16 / fp16 layout: one CTA per (64-row q tile, b*h) with 4 warps of 16
// rows. S = Q K^T and O += P V run on the tensor cores with
// mma.sync.aligned.m16n8k16 (16-bit in, f32 accumulate); the accumulator
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

#include "attention_tile.cuh"

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

  uint32_t qf[DP / 16][4];                  // Q as A fragments
  load_a<T, DP>(qf, static_cast<const T*>(p.q) + (size_t)bh * p.S * D, r0,
                r1, p.S, D, cq);
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
    mma_abt<T, DP, BK, LD>(sf, qf, Ks, lane);   // S = Q K^T
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

template <int DP>
__global__ void __launch_bounds__(NTHREADS)
flash_fwd_f32(Params p) {
  constexpr int BK = 32, DH = DP / 2;       // keys per tile, dims per thread
  __shared__ __align__(16) float Ks[BK * DP];
  __shared__ __align__(16) float Vs[BK * DP];
  const int D = p.D;
  const float* k = static_cast<const float*>(p.k);
  const float* v = static_cast<const float*>(p.v);

  const int qt = gridDim.x - 1 - blockIdx.x;
  const int bh = blockIdx.y, b = bh / p.H, h = bh % p.H;
  const int tid = threadIdx.x, half = tid & 1;
  const int q0 = qt * BQ, row = q0 + tid / 2;
  const float slope = p.slopes ? p.slopes[h] : 0.f;

  // this thread's dims: 8*i + 4*half + {0..3}; zeros past D
  float qv[DH], acc[DH];
  const float* qr = static_cast<const float*>(p.q) +
                    ((size_t)bh * p.S + min(row, p.S - 1)) * D;
#pragma unroll
  for (int i = 0; i < DP / 8; ++i) {
    const float4 t = load_f4(qr, 8 * i + 4 * half, D);
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
    for (int idx = tid; idx < BK * DP / 4; idx += NTHREADS) {
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
      const float* kr = &Ks[kk * DP + 4 * half];
      float dot = 0.f;
#pragma unroll
      for (int i = 0; i < DP / 8; ++i) {
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
      const float* vr = &Vs[kk * DP + 4 * half];
#pragma unroll
      for (int i = 0; i < DP / 8; ++i) {
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
    float* orow = static_cast<float*>(p.o) + ((size_t)bh * p.S + row) * D +
                  4 * half;
#pragma unroll
    for (int i = 0; i < DP / 8; ++i)
      if (8 * i + 4 * half < D)
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

template <typename T, int DP>
int launch_mma(const Params& p, int BH, bool extras, cudaStream_t st) {
  constexpr size_t smem = pair_smem_bytes<T, DP>(BK16);
  if (p.D == DP)
    return extras ? launch(flash_fwd_mma<T, DP, true, true>, p, BH, st, smem)
                  : launch(flash_fwd_mma<T, DP, false, true>, p, BH, st, smem);
  return extras ? launch(flash_fwd_mma<T, DP, true, false>, p, BH, st, smem)
                : launch(flash_fwd_mma<T, DP, false, false>, p, BH, st, smem);
}

template <int DP>
int launch_dp(const Params& p, int BH, int dtype, bool extras,
              cudaStream_t st) {
  if (dtype == 0) return launch(flash_fwd_f32<DP>, p, BH, st);
  if (dtype == 1) return launch_mma<bf16, DP>(p, BH, extras, st);
  return launch_mma<f16, DP>(p, BH, extras, st);
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16, 2 = float16 (q, k, v and o alike).
// D: any multiple of 8 up to 128. Returns the CUDA error of the launch
// (0 = launched); -1 for a dtype or head dim the kernel lacks.
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
  if (dtype < 0 || dtype > 2 || D < 8 || D > 128 || D % 8) return -1;
  if (S <= 0 || BH <= 0) return 0;
  const bool extras = kvm || qkm || slopes || window > 0 || softcap > 0.f;
  switch (pad_dim(D)) {
    case 32: return launch_dp<32>(p, BH, dtype, extras, st);
    case 64: return launch_dp<64>(p, BH, dtype, extras, st);
    case 96: return launch_dp<96>(p, BH, dtype, extras, st);
    default: return launch_dp<128>(p, BH, dtype, extras, st);
  }
}

const char* flash_attention_fwd_error_string(int err) {
  return err < 0 ? "unsupported dtype or head dim"
                 : cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"

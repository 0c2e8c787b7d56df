// Decode attention against a dense KV cache for Hopper (sm_90a), plain C
// interface.
//
// Replaces the Pallas kernel deepspeed_tpu/ops/pallas/decode_attention.py
// (_kernel, launched by decode_attention). T <= 64 new queries of one
// sequence, at absolute positions [cur_len - T, cur_len), attend to the
// sequence's preallocated cache [B, nh, max_len, hd] (or the stacked
// [L, B, nh, max_len, hd] with a layer index); positions >= cur_len are
// dead and never read.
//
// Any head dim hd % 8 == 0 up to 256, in f32, bf16 or fp16 (q, caches
// and output alike).
//
// Bound: bytes. Each (b, h) reads the live K and V rows once and does
// ~4 * T flops per element read; at the decode step's T = 1 that is far
// below the card's flop/byte balance. The design therefore reads only the
// live rows [max(0, q_first - window + 1), cur_len), each exactly once
// per (b, h) whatever T is, 16 bytes per thread with neighbouring threads
// on neighbouring addresses, and keeps many row loads in flight. Both
// kernels run one CTA per (h, b) with NTHREADS threads.
//
// T = 1 (every decode step), decode_attention_1: the structure of
// paged_attention.cu with a contiguous address in place of the block-table
// lookup. A row of hd elements is split over TPT threads, the power of two
// at or above hd / VEC (VEC = 16 bytes of the cache type, or 32 bytes where
// 16 would need more than a warp: f32 above hd 128; threads past the row's
// last slice load nothing and add zeros); the CTA's NTHREADS / TPT
// thread groups walk the keys in chunks of TPG tokens per group. Per chunk:
// (1) each thread issues all TPG of its K-row loads before using any and
// scores them against the query (held in registers); (2) the chunk's max is
// reduced over the thread's scores, the warp (shuffles) and the CTA's 4
// warps (shared memory), so every thread holds the same running max m; (3)
// each thread turns its scores into p and the chunk's sum of p is reduced
// the same way into the running sum l; (4) the V rows are loaded the same
// way and each group accumulates p * v into its own f32 slice of the output,
// rescaled by exp(m_old - m_new). At the end the groups' slices are summed
// through shared memory and divided by l.
//
// 1 < T <= 64, decode_attention_multi (instantiated at a padded width HD of
// 32, 64, 128 or 256, with 256 threads at 256; columns past hd are zeros;
// at 256 the f32 queries and rows take 213 KB of shared memory, by the
// opt-in above 48 KB): all T queries sit in shared
// memory (f32) and the CTA walks the live keys in chunks of MC: (1) the
// chunk's K and V rows are copied to shared memory (16 bytes per thread,
// coalesced; rows past cur_len are zeros); (2) each thread scores one key of
// the chunk against every other query (TPK threads per key); (3) one warp
// per query row takes the chunk's max and sum of p (online softmax) and
// leaves p, rounded to the cache dtype, in shared memory; (4) each thread
// owns one output column of every (NT / HD)-th query and accumulates
// p * v in f32 registers. Every K/V chunk is scored against all T queries
// while it is in shared memory, so no row is read twice.
//
// Numerics follow the TPU kernel: f32 scores, softcap on the scaled score
// before the ALiBi term slope * (k - q_abs), keep = k <= q_abs and
// (q_abs - k < window or window <= 0), masked scores set to -1e30 and
// their p to 0, p rounded to the cache dtype before p * v, and l == 0
// writes zeros. Starting at the first key inside the window is exact: the
// TPU kernel's masked keys before it contribute exp(-1e30 - m) = 0.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int NTHREADS = 128;
constexpr int TPG = 8;            // tokens per thread group per chunk (T = 1)
constexpr int MC = 64;            // keys per chunk (T > 1)
constexpr int MAX_T = 64;         // queries per call
constexpr float NEG_INF = -1e30f;

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ float to_f(__half x) { return __half2float(x); }

template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}
template <> __device__ __forceinline__ __half from_f<__half>(float x) {
  return __float2half(x);
}

// threads per cache row: the power of two at or above hd / vec
__host__ __device__ __forceinline__ int row_threads(int hd, int vec) {
  int t = 1;
  while (t * vec < hd) t <<= 1;
  return t;
}

// BYTES of one row slice, loaded at once (16-byte aligned)
template <int BYTES> struct alignas(16) Slice { uint4 w[BYTES / 16]; };

// round an f32 value to T and back (the TPU kernel's cast of p to v.dtype)
template <typename T> __device__ __forceinline__ float round_to(float x) {
  return to_f(from_f<T>(x));
}

// softcap, ALiBi and the masks on one scaled score
__device__ __forceinline__ float masked_score(float s, int k_pos, int q_abs,
                                              int window, float softcap,
                                              const float* slopes,
                                              float slope) {
  if (softcap > 0.f) s = tanhf(s / softcap) * softcap;
  if (slopes) s += slope * static_cast<float>(k_pos - q_abs);
  const bool keep = k_pos <= q_abs && (window <= 0 || q_abs - k_pos < window);
  return keep ? s : NEG_INF;
}

// T: query, cache and output dtype; VEC: elements a thread loads at once.
// One query (T = 1).
template <typename T, int VEC>
__global__ void __launch_bounds__(NTHREADS)
decode_attention_1(const T* __restrict__ q, const T* __restrict__ k_cache,
                   const T* __restrict__ v_cache,
                   const float* __restrict__ slopes, T* __restrict__ out,
                   int B, int nh, int max_len, int hd, int layer, int cur_len,
                   int window, float sm_scale, float softcap) {
  using R = Slice<VEC * sizeof(T)>;
  constexpr int NWARPS = NTHREADS / 32;
  const int tpt = row_threads(hd, VEC);     // threads per row
  const int ngroups = NTHREADS / tpt;
  const int chunk = ngroups * TPG;          // tokens per chunk
  extern __shared__ float smem[];
  float* red_m = smem;                      // [NWARPS] chunk max parts
  float* red_l = smem + NWARPS;             // [NWARPS] chunk sum parts
  float* red = smem + 2 * NWARPS;           // [ngroups * hd] final reduction

  const int h = blockIdx.x, b = blockIdx.y;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int grp = tid / tpt, g = tid % tpt; // token group, slice of hd
  const bool in_row = g * VEC < hd;         // a slice past hd adds zeros
  const int gs = in_row ? g * VEC : 0;      // ... and reads slice 0
  const int q_abs = cur_len - 1;            // the query's position
  const float slope = slopes ? slopes[h] : 0.f;

  float qv[VEC], acc[VEC];
  const T* qp = q + ((size_t)b * nh + h) * hd + gs;
#pragma unroll
  for (int i = 0; i < VEC; ++i) {
    qv[i] = in_row ? to_f(qp[i]) : 0.f;
    acc[i] = 0.f;
  }
  float m = NEG_INF, l = 0.f;

  // keys before the window are skipped (exact; see the note)
  const int start = window > 0 ? max(0, q_abs - window + 1) : 0;
  const size_t head_rows = (((size_t)layer * B + b) * nh + h) * max_len;
  const T* kh = k_cache + head_rows * hd + gs;
  const T* vh = v_cache + head_rows * hd + gs;

  for (int c0 = start; c0 < cur_len; c0 += chunk) {
    // (1) scores: every K-row load of the thread, then the math; the xor
    // shuffles leave each group's full dot product in all of its lanes
    int row[TPG];
#pragma unroll
    for (int i = 0; i < TPG; ++i)
      row[i] = min(c0 + grp + i * ngroups, cur_len - 1);  // tail: a live row
    R raw[TPG];
#pragma unroll
    for (int i = 0; i < TPG; ++i)
      raw[i] = *reinterpret_cast<const R*>(kh + (size_t)row[i] * hd);
    float sc[TPG];
#pragma unroll
    for (int i = 0; i < TPG; ++i) {
      const T* e = reinterpret_cast<const T*>(&raw[i]);
      float dot = 0.f;
#pragma unroll
      for (int v = 0; v < VEC; ++v) dot = fmaf(qv[v], to_f(e[v]), dot);
      for (int off = tpt / 2; off > 0; off >>= 1)
        dot += __shfl_xor_sync(0xffffffffu, dot, off);
      // k_pos >= cur_len: masked by k_pos <= q_abs
      sc[i] = masked_score(dot * sm_scale, c0 + grp + i * ngroups, q_abs,
                           window, softcap, slopes, slope);
    }
    // (2) the chunk's max: the thread's scores, the warp, then the CTA's
    // warps through shared memory
    float mx = sc[0];
#pragma unroll
    for (int i = 1; i < TPG; ++i) mx = fmaxf(mx, sc[i]);
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
    if (lane == 0) red_m[warp] = mx;
    __syncthreads();
    // (3) p = exp(s - m_new) for the thread's tokens (masked: exactly 0),
    // and the chunk's sum of p, counted once per group (its lane g == 0)
#pragma unroll
    for (int w = 0; w < NWARPS; ++w) mx = fmaxf(mx, red_m[w]);
    mx = fmaxf(mx, m);
    const float alpha = expf(m - mx);
    m = mx;
    float ps = 0.f;
#pragma unroll
    for (int i = 0; i < TPG; ++i) {
      sc[i] = sc[i] > 0.5f * NEG_INF ? expf(sc[i] - mx) : 0.f;
      ps += sc[i];
    }
    ps = g == 0 ? ps : 0.f;
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      ps += __shfl_xor_sync(0xffffffffu, ps, off);
    if (lane == 0) red_l[warp] = ps;
    // (4) p * v over this group's tokens, rescaled by exp(m_old - m_new);
    // the V loads go out before the barrier that publishes the sums
#pragma unroll
    for (int i = 0; i < TPG; ++i)
      raw[i] = *reinterpret_cast<const R*>(vh + (size_t)row[i] * hd);
    __syncthreads();
    ps = 0.f;
#pragma unroll
    for (int w = 0; w < NWARPS; ++w) ps += red_l[w];
    l = l * alpha + ps;
#pragma unroll
    for (int i = 0; i < VEC; ++i) acc[i] *= alpha;
    const int n = cur_len - c0;             // the chunk's live tokens
#pragma unroll
    for (int i = 0; i < TPG; ++i) {
      if (grp + i * ngroups >= n) continue;
      const T* e = reinterpret_cast<const T*>(&raw[i]);
      const float p = round_to<T>(sc[i]);
#pragma unroll
      for (int v = 0; v < VEC; ++v) acc[v] = fmaf(p, to_f(e[v]), acc[v]);
    }
    // red_m / red_l are rewritten only after the next chunk's first
    // barrier (red_l) or after every thread passed this one (red_m)
  }

  // sum the groups' slices and normalize
  if (in_row)
#pragma unroll
    for (int i = 0; i < VEC; ++i) red[grp * hd + gs + i] = acc[i];
  __syncthreads();
  const float ls = l == 0.f ? 1.f : l;
  T* o = out + ((size_t)b * nh + h) * hd;
  for (int d = tid; d < hd; d += NTHREADS) {
    float sum = 0.f;
    for (int r = 0; r < ngroups; ++r) sum += red[r * hd + d];
    o[d] = from_f<T>(sum / ls);
  }
}

// dynamic shared memory of decode_attention_multi: the queries and the
// chunk's scores (f32), the running max, sum and rescale of each query,
// and the chunk's K and V rows padded by 16 bytes (distinct banks when
// neighbouring threads read neighbouring rows)
template <typename T, int HD> size_t multi_smem_bytes(int Tq) {
  constexpr int LD = HD + 16 / sizeof(T);
  return sizeof(float) * ((size_t)Tq * (HD + MC) + 3 * MAX_T) +
         2 * sizeof(T) * (size_t)MC * LD;
}

// threads of decode_attention_multi at padded width HD
__host__ __device__ constexpr int multi_threads(int hd) {
  return hd > 128 ? 256 : NTHREADS;
}

// T: query, cache and output dtype; HD: the padded head dim (32, 64, 128
// or 256) for the real hd <= HD.
template <typename T, int HD>
__global__ void __launch_bounds__(multi_threads(HD))
decode_attention_multi(const T* __restrict__ q, const T* __restrict__ k_cache,
                       const T* __restrict__ v_cache,
                       const float* __restrict__ slopes, T* __restrict__ out,
                       int B, int nh, int Tq, int max_len, int hd, int layer,
                       int cur_len, int window, float sm_scale,
                       float softcap) {
  constexpr int VEC = 16 / sizeof(T);
  constexpr int NT = multi_threads(HD);
  constexpr int LD = HD + VEC;              // padded shared-memory row
  constexpr int TPK = NT / MC;              // threads per key (scoring)
  constexpr int TPO = NT / HD;              // threads per output column
  constexpr int NS = MAX_T / TPK;           // queries per thread (scoring)
  constexpr int NACC = MAX_T / TPO;         // queries per thread (p * v)
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* qs = reinterpret_cast<float*>(smem_raw);   // [Tq][HD]
  float* ps = qs + Tq * HD;                 // [Tq][MC] scores, then p
  float* m_s = ps + Tq * MC;                // [MAX_T] running max
  float* l_s = m_s + MAX_T;                 // [MAX_T] running sum
  float* a_s = l_s + MAX_T;                 // [MAX_T] the chunk's rescale
  T* ks = reinterpret_cast<T*>(a_s + MAX_T);        // [MC][LD]
  T* vs = ks + MC * LD;                     // [MC][LD]

  const int h = blockIdx.x, b = blockIdx.y;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int q_first = cur_len - Tq;         // position of query 0
  const float slope = slopes ? slopes[h] : 0.f;
  // scoring: key kc of the chunk against queries kt0 + TPK * j; p * v:
  // column od of queries ot0 + TPO * j. A warp shares kt0 and ot0, so its
  // reads of qs and ps are broadcasts.
  const int kc = tid % MC, kt0 = tid / MC;
  const int od = tid % HD, ot0 = tid / HD;

  const T* qb = q + ((size_t)b * nh + h) * Tq * hd;
  for (int i = tid; i < Tq * HD; i += NT) {
    const int t = i / HD, d = i % HD;
    qs[i] = d < hd ? to_f(qb[t * hd + d]) : 0.f;
  }
  if (tid < MAX_T) {
    m_s[tid] = NEG_INF;
    l_s[tid] = 0.f;
  }
  float acc[NACC];
#pragma unroll
  for (int j = 0; j < NACC; ++j) acc[j] = 0.f;

  // keys before every query's window are skipped (exact; see the note)
  const int start = window > 0 ? max(0, q_first - window + 1) : 0;
  const size_t head_rows = (((size_t)layer * B + b) * nh + h) * max_len;
  const T* kh = k_cache + head_rows * hd;
  const T* vh = v_cache + head_rows * hd;

  for (int c0 = start; c0 < cur_len; c0 += MC) {
    const int n = min(MC, cur_len - c0);    // the chunk's live keys
    __syncthreads();                        // the last chunk's rows are read
    // (1) the chunk's K and V rows; rows past cur_len and columns past hd
    // are zeros
    for (int idx = tid; idx < MC * HD / VEC; idx += NT) {
      const int r = idx / (HD / VEC), c = (idx % (HD / VEC)) * VEC;
      uint4 kv = make_uint4(0u, 0u, 0u, 0u), vv = kv;
      if (r < n && c < hd) {
        kv = *reinterpret_cast<const uint4*>(kh + (size_t)(c0 + r) * hd + c);
        vv = *reinterpret_cast<const uint4*>(vh + (size_t)(c0 + r) * hd + c);
      }
      *reinterpret_cast<uint4*>(ks + r * LD + c) = kv;
      *reinterpret_cast<uint4*>(vs + r * LD + c) = vv;
    }
    __syncthreads();
    // (2) scores of key kc against the thread's queries
    float s[NS];
#pragma unroll
    for (int j = 0; j < NS; ++j) s[j] = 0.f;
#pragma unroll
    for (int d0 = 0; d0 < HD; d0 += VEC) {
      const uint4 raw = *reinterpret_cast<const uint4*>(ks + kc * LD + d0);
      const T* e = reinterpret_cast<const T*>(&raw);
      float kf[VEC];
#pragma unroll
      for (int i = 0; i < VEC; ++i) kf[i] = to_f(e[i]);
#pragma unroll
      for (int j = 0; j < NS; ++j) {
        const int t = kt0 + j * TPK;
        if (t >= Tq) break;
        const float* qr = qs + t * HD + d0;
#pragma unroll
        for (int i = 0; i < VEC; i += 4) {
          const float4 q4 = *reinterpret_cast<const float4*>(qr + i);
          s[j] = fmaf(q4.x, kf[i], s[j]);
          s[j] = fmaf(q4.y, kf[i + 1], s[j]);
          s[j] = fmaf(q4.z, kf[i + 2], s[j]);
          s[j] = fmaf(q4.w, kf[i + 3], s[j]);
        }
      }
    }
#pragma unroll
    for (int j = 0; j < NS; ++j) {
      const int t = kt0 + j * TPK;
      if (t >= Tq) break;
      // k_pos >= cur_len (a zero row): masked by k_pos <= q_abs
      ps[t * MC + kc] = masked_score(s[j] * sm_scale, c0 + kc, q_first + t,
                                     window, softcap, slopes, slope);
    }
    __syncthreads();
    // (3) online softmax, one warp per query row (MC = 2 x 32 keys)
    for (int t = warp; t < Tq; t += NT / 32) {
      float* row = ps + t * MC;
      const float m_old = m_s[t];
      const float x0 = row[lane], x1 = row[lane + 32];
      float mx = fmaxf(x0, x1);
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      mx = fmaxf(mx, m_old);
      const float p0 = x0 > 0.5f * NEG_INF ? expf(x0 - mx) : 0.f;
      const float p1 = x1 > 0.5f * NEG_INF ? expf(x1 - mx) : 0.f;
      float sum = p0 + p1;
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        sum += __shfl_xor_sync(0xffffffffu, sum, off);
      row[lane] = round_to<T>(p0);
      row[lane + 32] = round_to<T>(p1);
      if (lane == 0) {
        const float alpha = expf(m_old - mx);
        m_s[t] = mx;
        l_s[t] = l_s[t] * alpha + sum;
        a_s[t] = alpha;
      }
    }
    __syncthreads();
    // (4) p * v for column od; p of the zero rows past cur_len is 0
#pragma unroll
    for (int j = 0; j < NACC; ++j) {
      const int t = ot0 + j * TPO;
      if (t >= Tq) break;
      acc[j] *= a_s[t];
    }
    for (int c = 0; c < n; c += 4) {
      float vf[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) vf[i] = to_f(vs[(c + i) * LD + od]);
#pragma unroll
      for (int j = 0; j < NACC; ++j) {
        const int t = ot0 + j * TPO;
        if (t >= Tq) break;
        const float4 p4 = *reinterpret_cast<const float4*>(ps + t * MC + c);
        acc[j] = fmaf(p4.x, vf[0], acc[j]);
        acc[j] = fmaf(p4.y, vf[1], acc[j]);
        acc[j] = fmaf(p4.z, vf[2], acc[j]);
        acc[j] = fmaf(p4.w, vf[3], acc[j]);
      }
    }
  }

#pragma unroll
  for (int j = 0; j < NACC; ++j) {
    const int t = ot0 + j * TPO;
    if (t >= Tq) break;
    const float l = l_s[t];
    if (od < hd)
      out[(((size_t)b * nh + h) * Tq + t) * hd + od] =
          from_f<T>(acc[j] / (l == 0.f ? 1.f : l));
  }
}

template <typename T, int VEC>
int launch_1(const void* q, const void* k_cache, const void* v_cache,
             const float* slopes, void* out, int B, int nh, int max_len,
             int hd, int layer, int cur_len, int window, float sm_scale,
             float softcap, cudaStream_t stream) {
  const int ngroups = NTHREADS / row_threads(hd, VEC);
  const size_t smem = sizeof(float) * ((size_t)2 * (NTHREADS / 32) +
                                       (size_t)ngroups * hd);
  decode_attention_1<T, VEC><<<dim3(nh, B), NTHREADS, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k_cache),
      static_cast<const T*>(v_cache), slopes, static_cast<T*>(out), B, nh,
      max_len, hd, layer, cur_len, window, sm_scale, softcap);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int HD>
int launch_multi(const void* q, const void* k_cache, const void* v_cache,
                 const float* slopes, void* out, int B, int nh, int Tq,
                 int max_len, int hd, int layer, int cur_len, int window,
                 float sm_scale, float softcap, cudaStream_t stream) {
  const size_t smem = multi_smem_bytes<T, HD>(Tq);
  if (smem > 48 * 1024) {                   // above 48 KB only by opt-in
    const cudaError_t e = cudaFuncSetAttribute(
        decode_attention_multi<T, HD>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  decode_attention_multi<T, HD>
      <<<dim3(nh, B), multi_threads(HD), smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k_cache),
      static_cast<const T*>(v_cache), slopes, static_cast<T*>(out), B, nh, Tq,
      max_len, hd, layer, cur_len, window, sm_scale, softcap);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch(const void* q, const void* k_cache, const void* v_cache,
           const float* slopes, void* out, int B, int nh, int Tq, int max_len,
           int hd, int layer, int cur_len, int window, float sm_scale,
           float softcap, cudaStream_t stream) {
  constexpr int VEC = 16 / sizeof(T);
  if (Tq == 1 && row_threads(hd, VEC) > 32)  // a row in at most one warp
    return launch_1<T, 2 * VEC>(q, k_cache, v_cache, slopes, out, B, nh,
                                max_len, hd, layer, cur_len, window, sm_scale,
                                softcap, stream);
  if (Tq == 1)
    return launch_1<T, VEC>(q, k_cache, v_cache, slopes, out, B, nh, max_len,
                            hd, layer, cur_len, window, sm_scale, softcap,
                            stream);
#define DA_MULTI(HD)                                                         \
  if (hd <= HD)                                                              \
    return launch_multi<T, HD>(q, k_cache, v_cache, slopes, out, B, nh, Tq,  \
                               max_len, hd, layer, cur_len, window,          \
                               sm_scale, softcap, stream);
  DA_MULTI(32)
  DA_MULTI(64)
  DA_MULTI(128)
  DA_MULTI(256)
#undef DA_MULTI
  return -1;
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16, 2 = float16 (q, caches and output
// alike); hd: a multiple of 8 up to 256. Returns the CUDA error of the
// launch (0 = launched); -1 for a dtype, head dim or query count the
// kernel lacks.
int decode_attention_launch(const void* q, const void* k_cache,
                            const void* v_cache, const void* slopes, void* out,
                            int B, int nh, int Tq, int max_len, int hd,
                            int layer, int cur_len, int window, float sm_scale,
                            float softcap, int dtype, void* stream) {
  const float* sl = static_cast<const float*>(slopes);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (Tq < 1 || Tq > MAX_T || hd < 8 || hd > 256 || hd % 8) return -1;
  if (dtype == 0)
    return launch<float>(q, k_cache, v_cache, sl, out, B, nh, Tq, max_len, hd,
                         layer, cur_len, window, sm_scale, softcap, st);
  if (dtype == 1)
    return launch<__nv_bfloat16>(q, k_cache, v_cache, sl, out, B, nh, Tq,
                                 max_len, hd, layer, cur_len, window,
                                 sm_scale, softcap, st);
  if (dtype == 2)
    return launch<__half>(q, k_cache, v_cache, sl, out, B, nh, Tq, max_len, hd,
                          layer, cur_len, window, sm_scale, softcap, st);
  return -1;
}

const char* decode_attention_error_string(int err) {
  return err < 0 ? "unsupported dtype, head dim or query count"
                 : cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"

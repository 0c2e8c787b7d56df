// Paged-attention decode kernel for Hopper (sm_90a), plain C interface.
//
// Replaces the Pallas kernel deepspeed_tpu/ops/pallas/paged_attention.py
// (_kernel, launched by paged_attention). One decode query per (lane b,
// head h) attends to the K/V rows of its sequence, which live in a pool
// of fixed-size blocks shared by all sequences; the lane's block table
// maps logical block j to a physical pool block.
//
// Any head dim hd % 8 == 0; q in f32, bf16 or fp16, the pool in q's dtype
// or int8 with one f32 scale per slot. Above 256 the kernel row_wide of
// decode_row.cuh (the output columns split over CTAs, the row walked in
// 256-column pieces) with this file's block-table addressing.
//
// Bound: bytes. Each (b, h) reads ctx * hd K and V elements (plus one f32
// scale per row in the int8 tier) and does ~4 flops per element read, far
// below the card's flop/byte balance. The design therefore reads each
// live row exactly once, 16 bytes per thread (32 for f32 rows above hd
// 128), neighbouring threads on neighbouring addresses, touches only the
// live rows (with a sliding window, only the rows inside it), and keeps
// enough loads in flight to fill the card:
//
// * Split context (flash-decoding). The grid is (h, b, split): the live
//   positions of a lane are cut into `splits` contiguous ranges, one a
//   CTA, where B * nh alone would leave the card's SMs with few CTAs (the
//   wrapper picks the count from the shapes). Each CTA keeps its own
//   running max m, sum l and unnormalized output o. The splits of one
//   (b, h) form one thread-block cluster (at most 8) and combine in split
//   order through distributed shared memory in the same launch: rank z
//   writes columns [z hd / S, (z + 1) hd / S) of the output from every
//   rank's (m, l, o). No scratch in device memory, no second kernel, and
//   repeats are bit-identical.
// * The split's slice of the block table is staged in shared memory once,
//   so a row's address costs a shared-memory read, not a device-memory
//   load that the row's load would wait on.
// * decode_attention.cu's chunk structure. A row of hd elements is split
//   over TPT threads, the power of two at or above hd / VEC (threads past
//   the row's last slice load nothing and add zeros); the CTA's NTHREADS /
//   TPT thread groups walk the split in chunks of TPG tokens a group. Per
//   chunk: (1) the next chunk's K and V rows are loaded (so loads stay in
//   flight through the math: a two-chunk register pipeline), then this
//   chunk's scores; (2) the chunk's max through
//   shuffles and the CTA's 4 warps (shared memory), so every thread holds
//   the same running max; (3) p and the chunk's sum of p the same way; (4)
//   p * v into the group's f32 slice, rescaled by exp(m_old - m_new). A
//   split walks whole chunks. At the end the groups' slices are summed
//   through shared memory.
//
// Numerics follow the TPU kernel: f32 scores, softcap before ALiBi,
// keep = k_pos <= ctx - 1 and (q_abs - k_pos < window or window <= 0) (a
// split visits only kept positions, so only its own end masks), p rounded
// to the query dtype before p * v, int8 rows dequantized with their f32
// scale and rounded to the query dtype, and a lane with ctx == 0 (or
// l == 0) writes zeros. Splitting changes where the running max is taken,
// so p is rounded relative to each split's max: the output differs from an
// unsplit pass by that rounding only.

#include <cooperative_groups.h>

#include "decode_row.cuh"

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int NTHREADS = 128;
constexpr int NWARPS = NTHREADS / 32;
constexpr int MAX_SPLITS = 8;     // portable cluster size
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

// BYTES of one row slice, loaded at once
template <int BYTES> struct alignas(16) Slice { uint4 w[BYTES / 16]; };
template <> struct alignas(8) Slice<8> { uint2 w; };

// tokens a thread group takes a chunk: 8, or 4 with 32-byte slices (two
// chunks' K and V rows are in registers at once)
__host__ __device__ constexpr int tokens_per_group(int slice_bytes) {
  return slice_bytes > 16 ? 4 : 8;
}

// round an f32 value to T and back (the TPU kernel's casts to q.dtype)
template <typename T> __device__ __forceinline__ float round_to(float x) {
  return to_f(from_f<T>(x));
}

struct Args {
  const void* q;
  const void* k_pool;
  const void* v_pool;
  const float* k_scale;
  const float* v_scale;
  const int* block_tables;
  const int* context_lens;
  const float* slopes;
  void* out;
  int nh, nblk, bs, hd, nbk, layer, window;
  float sm_scale, softcap;
};

// dynamic shared memory: the chunk's max and sum parts, the groups'
// slices, this split's output and (m, l), its table entries
__host__ __device__ __forceinline__ size_t smem_floats(int ngroups, int hd) {
  return 2 * NWARPS + (size_t)ngroups * hd + hd + 2;
}

// T: query / output dtype; P: pool dtype (T, or int8 with f32 row scales);
// VEC: pool elements a thread loads at once
template <typename T, typename P, int VEC>
__global__ void __launch_bounds__(NTHREADS)
paged_attention_kernel(const Args a) {
  using R = Slice<VEC * sizeof(P)>;
  constexpr bool QUANT = sizeof(P) == 1;
  constexpr int TPG = tokens_per_group(VEC * sizeof(P));
  const int hd = a.hd, bs = a.bs;
  const int tpt = row_threads(hd, VEC);     // threads per row
  const int ngroups = NTHREADS / tpt;
  const int chunk = ngroups * TPG;          // tokens per chunk
  extern __shared__ __align__(16) float smem[];
  float* red_m = smem;                      // [NWARPS]
  float* red_l = red_m + NWARPS;            // [NWARPS]
  float* red = red_l + NWARPS;              // [ngroups * hd]
  float* o_s = red + ngroups * hd;          // [hd] this split's output
  float* ml_s = o_s + hd;                   // [2] this split's m and l
  int* tab = reinterpret_cast<int*>(ml_s + 2);   // the split's table slice

  const int h = blockIdx.x, b = blockIdx.y, z = blockIdx.z;
  const int nsplit = gridDim.z;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int grp = tid / tpt, g = tid % tpt; // token group, slice of hd
  const bool in_row = g * VEC < hd;         // a slice past hd adds zeros
  const int gs = in_row ? g * VEC : 0;      // ... and reads slice 0
  const int ctx = max(a.context_lens[b], 0);
  const int q_abs = ctx - 1;
  const float slope = a.slopes ? a.slopes[h] : 0.f;

  // keys before the window are masked; the TPU kernel's exp(-1e30 - m)
  // wipes their contribution to exactly zero once a live key is seen, so
  // starting at the first key inside the window changes nothing. This
  // split's positions: [t0, t1) of the live ones
  const int start = a.window > 0 ? max(0, q_abs - a.window + 1) : 0;
  const int live = max(ctx - start, 0);
  // whole chunks a split (the last may be short, later ones empty)
  const int per = ((live + nsplit - 1) / nsplit + chunk - 1) / chunk * chunk;
  const int t0 = start + z * per, t1 = min(ctx, t0 + per);
  const int j0 = t0 / bs;
  const int nj = t1 > t0 ? (t1 - 1) / bs - j0 + 1 : 0;
  const int* table = a.block_tables + (size_t)b * a.nbk;
  for (int i = tid; i < nj; i += NTHREADS) tab[i] = table[j0 + i];

  float qv[VEC];
  const T* qp = static_cast<const T*>(a.q) + ((size_t)b * a.nh + h) * hd + gs;
#pragma unroll
  for (int i = 0; i < VEC; ++i) qv[i] = in_row ? to_f(qp[i]) : 0.f;
  float acc[VEC];
#pragma unroll
  for (int i = 0; i < VEC; ++i) acc[i] = 0.f;
  float m = NEG_INF, l = 0.f;

  const size_t head_rows = ((size_t)a.layer * a.nh + h) * a.nblk * bs;
  const P* kh = static_cast<const P*>(a.k_pool) + head_rows * hd + gs;
  const P* vh = static_cast<const P*>(a.v_pool) + head_rows * hd + gs;
  const float* ksh = QUANT ? a.k_scale + head_rows : nullptr;
  const float* vsh = QUANT ? a.v_scale + head_rows : nullptr;
  __syncthreads();                          // tab is staged

  // chunk c0's K and V rows (and int8 scales) of this thread: positions
  // past the split read the split's last live row, which is masked
  auto fetch = [&](int c0, R* kr, float* ks, R* vr, float* vs) {
#pragma unroll
    for (int i = 0; i < TPG; ++i) {
      const int pos = min(c0 + grp + i * ngroups, t1 - 1);
      const size_t row = (size_t)tab[pos / bs - j0] * bs + pos % bs;
      kr[i] = *reinterpret_cast<const R*>(kh + row * hd);
      vr[i] = *reinterpret_cast<const R*>(vh + row * hd);
      ks[i] = QUANT ? ksh[row] : 1.f;
      vs[i] = QUANT ? vsh[row] : 1.f;
    }
  };
  R raw[TPG], vraw[TPG];
  float sc[TPG], vsc[TPG];
  if (t0 < t1) fetch(t0, raw, sc, vraw, vsc);
  for (int c0 = t0; c0 < t1; c0 += chunk) {
    // (1) the next chunk's rows go out before this one is used, then this
    // chunk's scores; the xor shuffles leave each group's full dot product
    // in all of its lanes
    const bool more = c0 + chunk < t1;
    R nraw[TPG], nvraw[TPG];
    float nsc[TPG], nvsc[TPG];
    if (more) fetch(c0 + chunk, nraw, nsc, nvraw, nvsc);
    float s[TPG];
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
      const int k_pos = c0 + grp + i * ngroups;
      float x = dot * a.sm_scale;
      if (a.softcap > 0.f) x = tanhf(x / a.softcap) * a.softcap;
      if (a.slopes) x += slope * static_cast<float>(k_pos - q_abs);
      s[i] = k_pos < t1 ? x : NEG_INF;      // past the split: the next one's
    }
    // (2) the chunk's max: the thread's scores, the warp, then the CTA's
    // warps through shared memory
    float mx = s[0];
#pragma unroll
    for (int i = 1; i < TPG; ++i) mx = fmaxf(mx, s[i]);
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
      s[i] = s[i] > 0.5f * NEG_INF ? expf(s[i] - mx) : 0.f;
      ps += s[i];
    }
    ps = g == 0 ? ps : 0.f;
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      ps += __shfl_xor_sync(0xffffffffu, ps, off);
    if (lane == 0) red_l[warp] = ps;
    // (4) p * v over this group's tokens, rescaled by exp(m_old - m_new)
    __syncthreads();
    ps = 0.f;
#pragma unroll
    for (int w = 0; w < NWARPS; ++w) ps += red_l[w];
    l = l * alpha + ps;
#pragma unroll
    for (int v = 0; v < VEC; ++v) acc[v] *= alpha;
#pragma unroll
    for (int i = 0; i < TPG; ++i) {
      if (s[i] == 0.f) continue;            // masked (or exactly 0)
      const float p = round_to<T>(s[i]);
      const P* e = reinterpret_cast<const P*>(&vraw[i]);
#pragma unroll
      for (int v = 0; v < VEC; ++v) {
        const float vf = QUANT ? round_to<T>(to_f(e[v]) * vsc[i]) : to_f(e[v]);
        acc[v] = fmaf(p, vf, acc[v]);
      }
    }
    // red_m / red_l are rewritten only after the next chunk's first
    // barrier (red_l) or after every thread passed this one (red_m)
    if (more) {
#pragma unroll
      for (int i = 0; i < TPG; ++i) {
        raw[i] = nraw[i];
        vraw[i] = nvraw[i];
        sc[i] = nsc[i];
        vsc[i] = nvsc[i];
      }
    }
  }

  // this split's output: the groups' slices summed
  if (in_row)
#pragma unroll
    for (int i = 0; i < VEC; ++i) red[grp * hd + gs + i] = acc[i];
  __syncthreads();
  T* o = static_cast<T*>(a.out) + ((size_t)b * a.nh + h) * hd;
  if (nsplit == 1) {                        // launched without a cluster
    const float inv = 1.f / (l == 0.f ? 1.f : l);
    for (int d = tid; d < hd; d += NTHREADS) {
      float sum = 0.f;
      for (int r = 0; r < ngroups; ++r) sum += red[r * hd + d];
      o[d] = from_f<T>(sum * inv);
    }
    return;
  }
  for (int d = tid; d < hd; d += NTHREADS) {
    float sum = 0.f;
    for (int r = 0; r < ngroups; ++r) sum += red[r * hd + d];
    o_s[d] = sum;
  }
  if (tid == 0) {
    ml_s[0] = m;
    ml_s[1] = l;
  }
  // the splits of (b, h) combine in split order: rank z writes its share
  // of the columns from every rank's (m, l, o)
  cg::cluster_group cluster = cg::this_cluster();
  cluster.sync();
  float mk[MAX_SPLITS], wk[MAX_SPLITS];
  float M = NEG_INF;
#pragma unroll
  for (int k = 0; k < MAX_SPLITS; ++k) {
    if (k < nsplit) {
      const float* ml = cluster.map_shared_rank(ml_s, k);
      mk[k] = ml[0];
      wk[k] = ml[1];
      M = fmaxf(M, mk[k]);
    }
  }
  float L = 0.f;
#pragma unroll
  for (int k = 0; k < MAX_SPLITS; ++k)
    if (k < nsplit) {
      mk[k] = expf(mk[k] - M);              // the split's weight
      L += wk[k] * mk[k];
    }
  const float inv = 1.f / (L == 0.f ? 1.f : L);
  const int d1 = hd * (z + 1) / nsplit;
  for (int d = hd * z / nsplit + tid; d < d1; d += NTHREADS) {
    float sum = 0.f;
#pragma unroll
    for (int k = 0; k < MAX_SPLITS; ++k)
      if (k < nsplit) sum += cluster.map_shared_rank(o_s, k)[d] * mk[k];
    o[d] = from_f<T>(sum * inv);
  }
  cluster.sync();                           // no CTA leaves while read
}

template <typename T, typename P, int VEC>
int launch_vec(const Args& a, int B, int splits, cudaStream_t stream) {
  const int ngroups = NTHREADS / row_threads(a.hd, VEC);
  const int chunk = ngroups * tokens_per_group(VEC * sizeof(P));
  // a split of at most `per` positions (the kernel's, for the longest
  // context the table holds) spans at most per / bs blocks, plus one
  const int per = ((a.nbk * a.bs + splits - 1) / splits + chunk - 1) / chunk *
                  chunk;
  const size_t smem = sizeof(float) * smem_floats(ngroups, a.hd) +
                      sizeof(int) * ((size_t)(per + a.bs - 1) / a.bs + 1);
  auto kernel = paged_attention_kernel<T, P, VEC>;
  if (smem > 48 * 1024) {                   // above 48 KB only by opt-in
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(a.nh, B, splits);
  cfg.blockDim = dim3(NTHREADS);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = 1;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = splits;
  cfg.attrs = attr;
  cfg.numAttrs = splits > 1 ? 1 : 0;
  const cudaError_t e = cudaLaunchKernelEx(&cfg, kernel, a);
  if (e != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(cudaGetLastError());
}

// the rows of a pool for row_wide (decode_row.cuh): position pos of lane
// b through its block table, from the head's first row
template <typename T, typename P>
struct PagedRows {
  const T* q;
  const P* k;
  const P* v;
  const float* k_scale;
  const float* v_scale;
  const int* block_tables;
  const int* context_lens;
  const float* slopes;
  T* out;
  int nh, nblk, bs, hd, nbk, layer, window;
  float sm_scale, softcap;
  __device__ int ctx(int b) const { return context_lens[b]; }
  __device__ size_t base(int, int h) const {
    return ((size_t)layer * nh + h) * nblk * bs;
  }
  __device__ size_t row(size_t base, int b, int pos) const {
    return base + (size_t)block_tables[(size_t)b * nbk + pos / bs] * bs +
           pos % bs;
  }
  __device__ float kscale(size_t r) const { return k_scale ? k_scale[r] : 1.f; }
  __device__ float vscale(size_t r) const { return v_scale ? v_scale[r] : 1.f; }
};

// 16-byte slices; 8-byte ones for an int8 row whose hd is not a multiple
// of 16; 32-byte ones where 16 would spread a row over more than a warp;
// above 256 row_wide
template <typename T, typename P>
int launch(const Args& a, int B, int splits, cudaStream_t stream) {
  if (a.hd > 256) {
    const PagedRows<T, P> r = {
        static_cast<const T*>(a.q), static_cast<const P*>(a.k_pool),
        static_cast<const P*>(a.v_pool), a.k_scale, a.v_scale,
        a.block_tables, a.context_lens, a.slopes, static_cast<T*>(a.out),
        a.nh, a.nblk, a.bs, a.hd, a.nbk, a.layer, a.window, a.sm_scale,
        a.softcap};
    return drow::launch_wide<T, P>(r, B, stream);
  }
  constexpr int VEC = 16 / sizeof(P);
  if constexpr (sizeof(P) == 1)
    if (a.hd % VEC) return launch_vec<T, P, 8>(a, B, splits, stream);
  if (row_threads(a.hd, VEC) > 32)
    return launch_vec<T, P, 2 * VEC>(a, B, splits, stream);
  return launch_vec<T, P, VEC>(a, B, splits, stream);
}

}  // namespace

extern "C" {

// q_dtype: 0 = float32, 1 = bfloat16, 2 = float16. pool_dtype: the same
// codes for a pool of q's dtype, 3 = int8 (with k_scale / v_scale). hd: any
// multiple of 8. splits: CTAs (one cluster) a (b, h), 1 to 8 (above hd 256
// the columns are split instead).
// Returns the CUDA error of the launch (0 = launched); -1 for a
// combination the kernel lacks.
int paged_attention_launch(const void* q, const void* k_pool,
                           const void* v_pool, const void* k_scale,
                           const void* v_scale, const void* block_tables,
                           const void* context_lens, const void* slopes,
                           void* out, int B, int nh, int nblk, int bs, int hd,
                           int nbk, int layer, int window, float sm_scale,
                           float softcap, int splits, int q_dtype,
                           int pool_dtype, void* stream) {
  Args a;
  a.q = q; a.k_pool = k_pool; a.v_pool = v_pool;
  a.k_scale = static_cast<const float*>(k_scale);
  a.v_scale = static_cast<const float*>(v_scale);
  a.block_tables = static_cast<const int*>(block_tables);
  a.context_lens = static_cast<const int*>(context_lens);
  a.slopes = static_cast<const float*>(slopes);
  a.out = out;
  a.nh = nh; a.nblk = nblk; a.bs = bs; a.hd = hd; a.nbk = nbk;
  a.layer = layer; a.window = window;
  a.sm_scale = sm_scale; a.softcap = softcap;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (hd < 8 || hd % 8 || splits < 1 || splits > MAX_SPLITS) return -1;
  if (B <= 0 || nh <= 0) return 0;
  if (pool_dtype == 3) {
    if (q_dtype == 0) return launch<float, int8_t>(a, B, splits, st);
    if (q_dtype == 1) return launch<__nv_bfloat16, int8_t>(a, B, splits, st);
    if (q_dtype == 2) return launch<__half, int8_t>(a, B, splits, st);
  } else if (pool_dtype == q_dtype) {
    if (q_dtype == 0) return launch<float, float>(a, B, splits, st);
    if (q_dtype == 1)
      return launch<__nv_bfloat16, __nv_bfloat16>(a, B, splits, st);
    if (q_dtype == 2) return launch<__half, __half>(a, B, splits, st);
  }
  return -1;
}

const char* paged_attention_error_string(int err) {
  return err < 0 ? "unsupported dtype combination, head dim or split count"
                 : cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"

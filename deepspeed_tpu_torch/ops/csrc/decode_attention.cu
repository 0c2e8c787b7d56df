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
// Any head dim hd % 8 == 0, in f32, bf16 or fp16 (q, caches and output
// alike).
//
// Bound: bytes at T = 1. Each (b, h) reads the live K and V rows once and
// does ~4 T flops per element read: at T = 1 far below the card's
// flop/byte balance, at T = 64 (~128 flops a byte) above what CUDA cores
// sustain but below the tensor cores' ~295. The kernels read only the live
// rows [max(0, q_first - window + 1), cur_len), each once per (b, h)
// whatever T is.
//
// T = 1, decode_1 (every decode step): paged_attention.cu's structure with
// a contiguous address.
// * The row mapping. A row of hd elements is split over tpt = hd / VEC
//   lanes of VEC elements (16 or 32 bytes, the one that leaves the fewest
//   lanes idle: D 96 in bf16 takes 32-byte slices, 5 rows a warp); a warp
//   holds 32 / tpt rows (any group size, lanes past the last whole group
//   idle: 2 of 32 at D 80 and 96, where rounding the group up to a power
//   of two idled 8 or 12), and the CTA's groups walk the keys in chunks of
//   TPG keys a group. A group's partial dot products meet by shuffles (a
//   butterfly for a power-of-two group, else a tree and a broadcast).
// * A two-chunk register pipeline: a chunk's K and V rows are loaded
//   together, and the next chunk's go out before this one's math.
// * No barrier in the key loop: each row group keeps its own running max
//   m, sum l and output slice (an online softmax over its keys; its lanes
//   hold the same scores), and the groups' parts combine once at the end,
//   each weighted by exp(m_group - m). (paged_attention.cu reduces the max
//   and sum over the CTA at every chunk, two barriers a chunk.)
// * A context split (flash-decoding) where B * nh alone leaves the SMs
//   short of CTAs: the grid is (h, b, split), each split a contiguous range
//   of whole chunks with its own running max m, sum l and output; the
//   splits of a (b, h) form one thread-block cluster and combine in split
//   order through distributed shared memory in the same launch (no
//   scratch, no second kernel, repeats bit-identical). The wrapper picks
//   the count (split_plan).
//
// 1 < T <= 64, 16-bit, decode_multi_mma: the flash forward's mma.sync
// form (attention_tile.cuh). The T queries are the CTA's 64 own rows (4
// warps of 16; rows past T are zeros and never stored) as A fragments
// (in shared memory above width 128); the live keys go in tiles of 64,
// K and V double-buffered by cp.async; S = Q K^T and O += P V on
// mma.sync.m16n8k16 with the scores in registers, an online softmax per
// row, and P rounded to the cache dtype before P V. f32: decode_multi_f32
// on CUDA cores (no TF32): the queries in shared memory, one key of a chunk
// a thread against every query, a warp per query row for the softmax.
//
// Head dims above 256: T = 1 takes row_wide (decode_row.cuh), T > 1 the
// wide forward of attention_wide.cuh with this file's masks; both split
// the output columns over CTAs and keep registers and shared memory
// bounded.
//
// Numerics follow the TPU kernel: f32 scores, softcap on the scaled score
// before the ALiBi term slope * (k - q_abs), keep = k <= q_abs and
// (q_abs - k < window or window <= 0), masked scores set to -1e30 and
// their p to 0, p rounded to the cache dtype before p * v, and l == 0
// writes zeros. Starting at the first key inside the window is exact: the
// TPU kernel's masked keys before it contribute exp(-1e30 - m) = 0. A row
// group (and a split) takes its running max over its own keys, so p is
// rounded relative to it: the output differs from one pass over the row
// with one running max by that rounding only.

#include <cooperative_groups.h>

#include "attention_tile.cuh"
#include "attention_wide.cuh"
#include "decode_row.cuh"

namespace cg = cooperative_groups;

namespace {

using namespace drow;
using tile::bf16;
using tile::f16;

constexpr int MC = 64;            // keys per chunk (f32, T > 1)
constexpr int MAX_T = 64;         // queries per call
constexpr int MAX_SPLITS = 8;     // portable cluster size

// softcap, ALiBi and the masks on one scaled score
__device__ __forceinline__ float masked_score(float s, int k_pos, int q_abs,
                                              int window, float softcap,
                                              const float* slopes,
                                              float slope) {
  s = cap_bias(s, k_pos, q_abs, softcap, slopes != nullptr, slope);
  const bool keep = k_pos <= q_abs && (window <= 0 || q_abs - k_pos < window);
  return keep ? s : NEG_INF;
}

// ------------------------------------------------------------------ T = 1

template <typename T> using Args = DenseRows<T>;

// keys a group takes a chunk: 8, or 4 with 32-byte slices (two chunks' K
// and V rows are in registers at once)
__host__ __device__ constexpr int tokens_per_group(int slice_bytes) {
  return slice_bytes > 16 ? 4 : 8;
}

// dynamic shared memory: the groups' slices, running max, sum and weight,
// this split's output and (m, l)
__host__ __device__ __forceinline__ size_t smem_floats(int ngroups, int hd) {
  return (size_t)ngroups * (hd + 3) + hd + 2;
}

// T: query, cache and output dtype; VEC: elements a lane loads at once
template <typename T, int VEC>
__global__ void __launch_bounds__(NT)
decode_1(const Args<T> a) {
  using R = Slice<VEC * sizeof(T)>;
  constexpr int TPG = tokens_per_group(VEC * sizeof(T));
  const int hd = a.hd;
  const int tpt = hd / VEC;                 // lanes a row (at most 32)
  const int gpw = 32 / tpt;                 // rows a warp
  const int ngroups = NWARPS * gpw;
  const int chunk = ngroups * TPG;          // keys a chunk
  extern __shared__ __align__(16) float smem[];
  float* red = smem;                        // [ngroups * hd]
  float* gm = red + ngroups * hd;           // [ngroups] each group's max
  float* gl = gm + ngroups;                 // [ngroups] ... sum
  float* gw = gl + ngroups;                 // [ngroups] ... weight
  float* o_s = gw + ngroups;                // [hd] this split's output
  float* ml_s = o_s + hd;                   // [2] this split's m and l

  const int h = blockIdx.x, b = blockIdx.y, z = blockIdx.z;
  const int nsplit = gridDim.z;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int lg = lane / tpt, g = lane % tpt;
  const bool active = lg < gpw;             // lanes past the last group idle
  const int grp = warp * gpw + (active ? lg : 0);
  const int gs = g * VEC;
  const int cur_len = a.cur_len, q_abs = cur_len - 1;
  const float slope = a.slopes ? a.slopes[h] : 0.f;

  // this split's positions: [t0, t1) of the live ones, whole chunks
  const int start = a.window > 0 ? max(0, q_abs - a.window + 1) : 0;
  const int live = cur_len - start;
  const int per = ((live + nsplit - 1) / nsplit + chunk - 1) / chunk * chunk;
  const int t0 = start + z * per, t1 = min(cur_len, t0 + per);

  float qv[VEC], acc[VEC];
  const T* qp = a.q + ((size_t)b * a.nh + h) * hd + gs;
  {
    const R qr = *reinterpret_cast<const R*>(qp);
    const T* e = reinterpret_cast<const T*>(&qr);
#pragma unroll
    for (int i = 0; i < VEC; ++i) {
      qv[i] = to_f(e[i]);
      acc[i] = 0.f;
    }
  }
  float m = NEG_INF, l = 0.f;
  const size_t head = a.base(b, h) * hd + gs;
  const T* kh = a.k + head;
  const T* vh = a.v + head;

  // chunk c0's K and V rows of this thread: positions past the split read
  // its last live row, which is masked
  auto fetch = [&](int c0, R* kr, R* vr) {
#pragma unroll
    for (int i = 0; i < TPG; ++i) {
      const size_t row = min(c0 + grp + i * ngroups, t1 - 1);
      kr[i] = *reinterpret_cast<const R*>(kh + row * hd);
      vr[i] = *reinterpret_cast<const R*>(vh + row * hd);
    }
  };
  R kraw[TPG], vraw[TPG];
  if (t0 < t1) fetch(t0, kraw, vraw);
  for (int c0 = t0; c0 < t1; c0 += chunk) {
    // (1) the next chunk's rows go out before this one is used, then this
    // chunk's scores
    const bool more = c0 + chunk < t1;
    R nk[TPG], nv[TPG];
    if (more) fetch(c0 + chunk, nk, nv);
    float s[TPG];
#pragma unroll
    for (int i = 0; i < TPG; ++i) {
      const T* e = reinterpret_cast<const T*>(&kraw[i]);
      float dot = 0.f;
#pragma unroll
      for (int v = 0; v < VEC; ++v) dot = fmaf(qv[v], to_f(e[v]), dot);
      dot = group_sum(dot, tpt, g, lane);
      const int k_pos = c0 + grp + i * ngroups;
      const float x = cap_bias(dot * a.sm_scale, k_pos, q_abs, a.softcap,
                               a.slopes != nullptr, slope);
      s[i] = active && k_pos < t1 ? x : NEG_INF;  // past the split: the next one's
    }
    // (2) the group's online softmax over its keys of the chunk: its lanes
    // hold the same scores, so the running max m and sum l need no
    // exchange with other groups (and no barrier); the rescale takes the
    // difference first, so m == mx == -1e30 gives exactly 1
    float mx = m;
#pragma unroll
    for (int i = 0; i < TPG; ++i) mx = fmaxf(mx, s[i]);
    const float alpha = expf(m - mx);
    m = mx;
    float ps = 0.f;
#pragma unroll
    for (int i = 0; i < TPG; ++i) {
      s[i] = s[i] > 0.5f * NEG_INF ? expf(s[i] - mx) : 0.f;
      ps += s[i];
    }
    l = l * alpha + ps;
    // (3) p * v over the group's keys, rescaled by exp(m_old - m_new)
#pragma unroll
    for (int v = 0; v < VEC; ++v) acc[v] *= alpha;
#pragma unroll
    for (int i = 0; i < TPG; ++i) {
      if (s[i] == 0.f) continue;            // masked (or exactly 0)
      const float p = round_to<T>(s[i]);
      const T* e = reinterpret_cast<const T*>(&vraw[i]);
#pragma unroll
      for (int v = 0; v < VEC; ++v) acc[v] = fmaf(p, to_f(e[v]), acc[v]);
    }
    if (more) {
#pragma unroll
      for (int i = 0; i < TPG; ++i) {
        kraw[i] = nk[i];
        vraw[i] = nv[i];
      }
    }
  }

  // this split's (m, l) and output: the groups' parts, each weighted by
  // exp(m_group - m)
  if (active) {
#pragma unroll
    for (int i = 0; i < VEC; ++i) red[grp * hd + gs + i] = acc[i];
    if (g == 0) {
      gm[grp] = m;
      gl[grp] = l;
    }
  }
  __syncthreads();
  float M = NEG_INF;
  for (int r = 0; r < ngroups; ++r) M = fmaxf(M, gm[r]);
  for (int r = tid; r < ngroups; r += NT) gw[r] = expf(gm[r] - M);
  __syncthreads();
  float L = 0.f;
  for (int r = 0; r < ngroups; ++r) L += gl[r] * gw[r];
  T* o = a.out + ((size_t)b * a.nh + h) * hd;
  if (nsplit == 1) {                        // launched without a cluster
    const float inv = 1.f / (L == 0.f ? 1.f : L);
    for (int d = tid; d < hd; d += NT) {
      float sum = 0.f;
      for (int r = 0; r < ngroups; ++r) sum += red[r * hd + d] * gw[r];
      o[d] = from_f<T>(sum * inv);
    }
    return;
  }
  for (int d = tid; d < hd; d += NT) {
    float sum = 0.f;
    for (int r = 0; r < ngroups; ++r) sum += red[r * hd + d] * gw[r];
    o_s[d] = sum;
  }
  if (tid == 0) {
    ml_s[0] = M;
    ml_s[1] = L;
  }
  // the splits of (b, h) combine in split order: rank z writes its share
  // of the columns from every rank's (m, l, o)
  cg::cluster_group cluster = cg::this_cluster();
  cluster.sync();
  float mk[MAX_SPLITS], wk[MAX_SPLITS];
  M = NEG_INF;
#pragma unroll
  for (int k = 0; k < MAX_SPLITS; ++k) {
    if (k < nsplit) {
      const float* ml = cluster.map_shared_rank(ml_s, k);
      mk[k] = ml[0];
      wk[k] = ml[1];
      M = fmaxf(M, mk[k]);
    }
  }
  L = 0.f;
#pragma unroll
  for (int k = 0; k < MAX_SPLITS; ++k)
    if (k < nsplit) {
      mk[k] = expf(mk[k] - M);              // the split's weight
      L += wk[k] * mk[k];
    }
  const float inv = 1.f / (L == 0.f ? 1.f : L);
  const int d1 = hd * (z + 1) / nsplit;
  for (int d = hd * z / nsplit + tid; d < d1; d += NT) {
    float sum = 0.f;
#pragma unroll
    for (int k = 0; k < MAX_SPLITS; ++k)
      if (k < nsplit) sum += cluster.map_shared_rank(o_s, k)[d] * mk[k];
    o[d] = from_f<T>(sum * inv);
  }
  cluster.sync();                           // no CTA leaves while read
}

// the slice width of decode_1 for head dim hd: 16 or 32 bytes, the one
// that idles the fewest lanes (16 on a tie); 0 when neither fits a warp
template <typename T> int slice_elems(int hd) {
  constexpr int V16 = 16 / sizeof(T), V32 = 32 / sizeof(T);
  auto used = [&](int v) {                  // lanes of 32 that load
    const int tpt = hd / v;
    return hd % v || tpt > 32 ? 0 : 32 / tpt * tpt;
  };
  const int u16 = used(V16), u32 = used(V32);
  if (u16 == 0 && u32 == 0) return 0;
  return u32 > u16 ? V32 : V16;
}

template <typename T, int VEC>
int launch_1(const Args<T>& a, int splits, cudaStream_t stream) {
  const int ngroups = NWARPS * (32 / (a.hd / VEC));
  const size_t smem = sizeof(float) * smem_floats(ngroups, a.hd);
  auto kernel = decode_1<T, VEC>;
  if (smem > 48 * 1024) {                   // above 48 KB only by opt-in
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(a.nh, a.B, splits);
  cfg.blockDim = dim3(NT);
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

template <typename T>
int launch_t1(const Args<T>& a, int splits, cudaStream_t st) {
  if (a.hd > wide::FROM_DIM) return launch_wide<T, T>(a, a.B, st);
  constexpr int V16 = 16 / sizeof(T), V32 = 32 / sizeof(T);
  const int vec = slice_elems<T>(a.hd);
  if (vec == V16) return launch_1<T, V16>(a, splits, st);
  if (vec == V32) return launch_1<T, V32>(a, splits, st);
  return -1;
}

// ------------------------------------------------- T > 1, bf16 and fp16

struct Multi {
  const void* q;
  const void* k;                  // this layer's [B, nh, max_len, hd]
  const void* v;
  const float* slopes;
  void* out;
  int nh, Tq, max_len, hd, cur_len, window;
  float sm_scale, softcap;
};

constexpr int BK = 64;            // keys a tile
constexpr float LOG2E = 1.4426950408889634f;

// T: query, cache and output dtype; DP: the padded head dim (32, 64, 96,
// 128, 192 or 256) for the real hd <= DP
template <typename T, int DP>
__global__ void __launch_bounds__(NT)
decode_multi_mma(const Multi a) {
  using namespace tile;
  constexpr int LD = DP + 8, TILE = BK * LD;
  constexpr bool OWN_SMEM = OwnA<T, DP>::SMEM;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* sm = reinterpret_cast<T*>(smem_raw);
  const int h = blockIdx.x, b = blockIdx.y, hd = a.hd;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int r0 = warp * 16 + lane / 4, r1 = r0 + 8;     // queries
  const int cq = (lane % 4) * 2;
  const int q_first = a.cur_len - a.Tq;
  const float slope = a.slopes ? a.slopes[h] : 0.f;
  const size_t bh = (size_t)b * a.nh + h;

  OwnA<T, DP> qa;                           // the queries, the A operand
  own_load<T, DP>(qa, static_cast<const T*>(a.q) + bh * a.Tq * hd,
                  sm + 4 * TILE, 0, r0, r1, a.Tq, hd, cq, tid);
  if (OWN_SMEM) cp_async_commit();          // waited for with the first tile
  float of[DP / 8][4];
#pragma unroll
  for (int n = 0; n < DP / 8; ++n)
    of[n][0] = of[n][1] = of[n][2] = of[n][3] = 0.f;
  float m[2] = {NEG_INF, NEG_INF}, l[2] = {0.f, 0.f};   // l: this thread's part

  // keys before every query's window are skipped (exact; see the note)
  const int start = a.window > 0 ? max(0, q_first - a.window + 1) : 0;
  const int kt_lo = start / BK, kt_hi = (a.cur_len + BK - 1) / BK;
  const T* kb = static_cast<const T*>(a.k) + bh * a.max_len * hd;
  const T* vb = static_cast<const T*>(a.v) + bh * a.max_len * hd;
  auto load_tile = [&](int kt, int stage) {
    load_pair<T, DP, BK, NT>(sm + 2 * stage * TILE, kb, vb, kt * BK,
                             a.cur_len, hd, tid);
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
    // a tile wholly inside every query's causal range and window, with
    // neither ALiBi nor a softcap, needs no mask (keys >= cur_len lie past
    // the last query's position, so the causal test covers them)
    const bool plain = k0 + BK - 1 <= q_first &&
                       (a.window <= 0 || a.cur_len - 1 - k0 < a.window) &&
                       !a.slopes && a.softcap <= 0.f;
#pragma unroll
    for (int j = 0; j < BK / 8; ++j)
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const float s = sf[j][c] * a.sm_scale;
        sf[j][c] = plain ? s
                         : masked_score(s, k0 + j * 8 + cq + (c & 1),
                                        q_first + (c < 2 ? r0 : r1), a.window,
                                        a.softcap, a.slopes, slope);
      }
    // online softmax for the thread's two rows (a row spans a lane quad);
    // the rescale takes the difference first, so m == mx == -1e30 (no live
    // key yet) gives exactly 1
#pragma unroll
    for (int rr = 0; rr < 2; ++rr) {
      float mx = m[rr];
#pragma unroll
      for (int j = 0; j < BK / 8; ++j)
        mx = fmaxf(mx, fmaxf(sf[j][2 * rr], sf[j][2 * rr + 1]));
      mx = fmaxf(mx, __shfl_xor_sync(FULL, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(FULL, mx, 2));
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

  float inv[2];
#pragma unroll
  for (int rr = 0; rr < 2; ++rr) {
    float lt = l[rr];
    lt += __shfl_xor_sync(FULL, lt, 1);
    lt += __shfl_xor_sync(FULL, lt, 2);
    inv[rr] = 1.f / (lt == 0.f ? 1.f : lt);
  }
  store_rows<T, DP>(static_cast<T*>(a.out) + bh * a.Tq * hd, of, r0, r1,
                    a.Tq, hd, cq, inv[0], inv[1]);
}

template <typename T, int DP>
int launch_mma(const Multi& a, int B, cudaStream_t st) {
  constexpr size_t smem = tile::pair_smem_bytes<T, DP>(BK) +
                          tile::own_smem_bytes<T, DP>(1);
  auto kernel = decode_multi_mma<T, DP>;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  kernel<<<dim3(a.nh, B), NT, smem, st>>>(a);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int dispatch_mma(const Multi& a, int B, cudaStream_t st) {
  switch (tile::pad_dim(a.hd)) {
    case 32: return launch_mma<T, 32>(a, B, st);
    case 64: return launch_mma<T, 64>(a, B, st);
    case 96: return launch_mma<T, 96>(a, B, st);
    case 128: return launch_mma<T, 128>(a, B, st);
    case 192: return launch_mma<T, 192>(a, B, st);
    default: return launch_mma<T, 256>(a, B, st);
  }
}

// ------------------------------------------------------------ T > 1, f32

// dynamic shared memory of decode_multi_f32: the queries and the chunk's
// scores, the running max, sum and rescale of each query, and the chunk's
// K and V rows padded by 16 bytes (distinct banks when neighbouring
// threads read neighbouring rows)
template <int HD> size_t multi_smem_bytes(int Tq) {
  constexpr int LD = HD + 4;
  return sizeof(float) * ((size_t)Tq * (HD + MC) + 3 * MAX_T +
                          2 * (size_t)MC * LD);
}

// threads of decode_multi_f32 at padded width HD
__host__ __device__ constexpr int multi_threads(int hd) {
  return hd > 128 ? 256 : NT;
}

// HD: the padded head dim (32, 64, 128 or 256) for the real hd <= HD.
// Every K/V chunk is scored against all T queries while it is in shared
// memory, so no row is read twice.
template <int HD>
__global__ void __launch_bounds__(multi_threads(HD))
decode_multi_f32(const Multi a) {
  constexpr int VEC = 4;
  constexpr int NTH = multi_threads(HD);
  constexpr int LD = HD + VEC;              // padded shared-memory row
  constexpr int TPK = NTH / MC;             // threads per key (scoring)
  constexpr int TPO = NTH / HD;             // threads per output column
  constexpr int NS = MAX_T / TPK;           // queries per thread (scoring)
  constexpr int NACC = MAX_T / TPO;         // queries per thread (p * v)
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int Tq = a.Tq, hd = a.hd;
  float* qs = reinterpret_cast<float*>(smem_raw);   // [Tq][HD]
  float* ps = qs + Tq * HD;                 // [Tq][MC] scores, then p
  float* m_s = ps + Tq * MC;                // [MAX_T] running max
  float* l_s = m_s + MAX_T;                 // [MAX_T] running sum
  float* a_s = l_s + MAX_T;                 // [MAX_T] the chunk's rescale
  float* ks = a_s + MAX_T;                  // [MC][LD]
  float* vs = ks + MC * LD;                 // [MC][LD]

  const int h = blockIdx.x, b = blockIdx.y;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int q_first = a.cur_len - Tq;       // position of query 0
  const float slope = a.slopes ? a.slopes[h] : 0.f;
  const size_t bh = (size_t)b * a.nh + h;
  // scoring: key kc of the chunk against queries kt0 + TPK * j; p * v:
  // column od of queries ot0 + TPO * j. A warp shares kt0 and ot0, so its
  // reads of qs and ps are broadcasts.
  const int kc = tid % MC, kt0 = tid / MC;
  const int od = tid % HD, ot0 = tid / HD;

  const float* qb = static_cast<const float*>(a.q) + bh * Tq * hd;
  for (int i = tid; i < Tq * HD; i += NTH) {
    const int t = i / HD, d = i % HD;
    qs[i] = d < hd ? qb[t * hd + d] : 0.f;
  }
  if (tid < MAX_T) {
    m_s[tid] = NEG_INF;
    l_s[tid] = 0.f;
  }
  float acc[NACC];
#pragma unroll
  for (int j = 0; j < NACC; ++j) acc[j] = 0.f;

  const int start = a.window > 0 ? max(0, q_first - a.window + 1) : 0;
  const float* kh = static_cast<const float*>(a.k) + bh * a.max_len * hd;
  const float* vh = static_cast<const float*>(a.v) + bh * a.max_len * hd;

  for (int c0 = start; c0 < a.cur_len; c0 += MC) {
    const int n = min(MC, a.cur_len - c0);  // the chunk's live keys
    __syncthreads();                        // the last chunk's rows are read
    // (1) the chunk's K and V rows; rows past cur_len and columns past hd
    // are zeros
    for (int idx = tid; idx < MC * HD / VEC; idx += NTH) {
      const int r = idx / (HD / VEC), c = (idx % (HD / VEC)) * VEC;
      float4 kv = make_float4(0.f, 0.f, 0.f, 0.f), vv = kv;
      if (r < n && c < hd) {
        kv = *reinterpret_cast<const float4*>(kh + (size_t)(c0 + r) * hd + c);
        vv = *reinterpret_cast<const float4*>(vh + (size_t)(c0 + r) * hd + c);
      }
      *reinterpret_cast<float4*>(ks + r * LD + c) = kv;
      *reinterpret_cast<float4*>(vs + r * LD + c) = vv;
    }
    __syncthreads();
    // (2) scores of key kc against the thread's queries
    float s[NS];
#pragma unroll
    for (int j = 0; j < NS; ++j) s[j] = 0.f;
#pragma unroll
    for (int d0 = 0; d0 < HD; d0 += VEC) {
      const float4 k4 = *reinterpret_cast<const float4*>(ks + kc * LD + d0);
#pragma unroll
      for (int j = 0; j < NS; ++j) {
        const int t = kt0 + j * TPK;
        if (t >= Tq) break;
        const float4 q4 = *reinterpret_cast<const float4*>(qs + t * HD + d0);
        s[j] = fmaf(q4.x, k4.x, s[j]);
        s[j] = fmaf(q4.y, k4.y, s[j]);
        s[j] = fmaf(q4.z, k4.z, s[j]);
        s[j] = fmaf(q4.w, k4.w, s[j]);
      }
    }
#pragma unroll
    for (int j = 0; j < NS; ++j) {
      const int t = kt0 + j * TPK;
      if (t >= Tq) break;
      // k_pos >= cur_len (a zero row): masked by k_pos <= q_abs
      ps[t * MC + kc] = masked_score(s[j] * a.sm_scale, c0 + kc, q_first + t,
                                     a.window, a.softcap, a.slopes, slope);
    }
    __syncthreads();
    // (3) online softmax, one warp per query row (MC = 2 x 32 keys)
    for (int t = warp; t < Tq; t += NTH / 32) {
      float* row = ps + t * MC;
      const float m_old = m_s[t];
      const float x0 = row[lane], x1 = row[lane + 32];
      float mx = fmaxf(warp_max(fmaxf(x0, x1)), m_old);
      const float p0 = x0 > 0.5f * NEG_INF ? expf(x0 - mx) : 0.f;
      const float p1 = x1 > 0.5f * NEG_INF ? expf(x1 - mx) : 0.f;
      const float sum = warp_sum(p0 + p1);
      row[lane] = p0;
      row[lane + 32] = p1;
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
      for (int i = 0; i < 4; ++i) vf[i] = vs[(c + i) * LD + od];
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
      static_cast<float*>(a.out)[(bh * Tq + t) * hd + od] =
          acc[j] / (l == 0.f ? 1.f : l);
  }
}

template <int HD>
int launch_f32(const Multi& a, int B, cudaStream_t stream) {
  const size_t smem = multi_smem_bytes<HD>(a.Tq);
  if (smem > 48 * 1024) {                   // above 48 KB only by opt-in
    const cudaError_t e = cudaFuncSetAttribute(
        decode_multi_f32<HD>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  decode_multi_f32<HD><<<dim3(a.nh, B), multi_threads(HD), smem, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

// ------------------------------------------------ T > 1, head dims > 256

// this file's schedule and masks for attention_wide.cuh: the T queries are
// the one own tile; the key tiles from the first inside the window to the
// last live one
struct WideP {
  const float* slopes;
  int nh, Tq, cur_len, window;
  float softcap;
};

struct Wide {
  using Prm = WideP;
  template <bool QMAJOR>
  static __device__ int own(const WideP&, int, int) { return 0; }
  template <bool QMAJOR>
  static __device__ void list(const WideP& p, int, int, int* e0, int* e1) {
    const int q_first = p.cur_len - p.Tq;
    *e0 = (p.window > 0 ? max(0, q_first - p.window + 1) : 0) / wide::R;
    *e1 = (p.cur_len + wide::R - 1) / wide::R;
  }
  template <bool QMAJOR>
  static __device__ int other(const WideP&, int, int, int e) {
    return e * wide::R;
  }
  template <bool QMAJOR, int NJ>
  static __device__ void scores(const WideP& p, int bh, int, int,
                                float (*s)[4], float (*)[4], int a0, int a1,
                                int b0, int cq) {
    const float slope = p.slopes ? p.slopes[bh % p.nh] : 0.f;
    const int q_first = p.cur_len - p.Tq;
#pragma unroll
    for (int j = 0; j < NJ; ++j)
#pragma unroll
      for (int c = 0; c < 4; ++c)
        s[j][c] = masked_score(s[j][c], b0 + j * 8 + cq + (c & 1),
                               q_first + (c < 2 ? a0 : a1), p.window,
                               p.softcap, p.slopes, slope);
  }
};

int launch_multi(const Multi& a, int B, int dtype, cudaStream_t st) {
  if (a.hd > wide::FROM_DIM) {
    wide::Args w = {};
    w.q = a.q; w.k = a.k; w.v = a.v; w.o = a.out;
    w.kv_head = (size_t)a.max_len * a.hd;
    w.Sq = a.Tq; w.Sk = a.cur_len; w.D = a.hd; w.sm_scale = a.sm_scale;
    WideP p = {a.slopes, a.nh, a.Tq, a.cur_len, a.window, a.softcap};
    return wide::launch<0, Wide>(w, p, B * a.nh, 1, dtype, st);
  }
  if (dtype == 1) return dispatch_mma<bf16>(a, B, st);
  if (dtype == 2) return dispatch_mma<f16>(a, B, st);
  if (a.hd <= 32) return launch_f32<32>(a, B, st);
  if (a.hd <= 64) return launch_f32<64>(a, B, st);
  if (a.hd <= 128) return launch_f32<128>(a, B, st);
  return launch_f32<256>(a, B, st);
}

// T = 1 in dtype T
template <typename T>
int launch_row(const void* q, const void* k_cache, const void* v_cache,
               const float* slopes, void* out, int B, int nh, int max_len,
               int hd, int layer, int cur_len, int window, float sm_scale,
               float softcap, int splits, cudaStream_t st) {
  Args<T> a;
  a.q = static_cast<const T*>(q);
  a.k = static_cast<const T*>(k_cache);
  a.v = static_cast<const T*>(v_cache);
  a.slopes = slopes;
  a.out = static_cast<T*>(out);
  a.B = B; a.nh = nh; a.max_len = max_len; a.hd = hd; a.layer = layer;
  a.cur_len = cur_len; a.window = window;
  a.sm_scale = sm_scale; a.softcap = softcap;
  return launch_t1<T>(a, splits, st);
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16, 2 = float16 (q, caches and output
// alike); hd: any multiple of 8. splits: CTAs (one cluster) a (b, h) at
// T = 1, 1 to 8 (the wrapper's split_plan). Returns the CUDA error of the
// launch (0 = launched); -1 for a dtype, head dim, query or split count
// the kernels lack.
int decode_attention_launch(const void* q, const void* k_cache,
                            const void* v_cache, const void* slopes, void* out,
                            int B, int nh, int Tq, int max_len, int hd,
                            int layer, int cur_len, int window, float sm_scale,
                            float softcap, int splits, int dtype,
                            void* stream) {
  const float* sl = static_cast<const float*>(slopes);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (Tq < 1 || Tq > MAX_T || hd < 8 || hd % 8 || dtype < 0 || dtype > 2 ||
      splits < 1 || splits > MAX_SPLITS)
    return -1;
  if (B <= 0 || nh <= 0) return 0;
  if (Tq == 1) {
    if (dtype == 0)
      return launch_row<float>(q, k_cache, v_cache, sl, out, B, nh, max_len,
                               hd, layer, cur_len, window, sm_scale, softcap,
                               splits, st);
    if (dtype == 1)
      return launch_row<bf16>(q, k_cache, v_cache, sl, out, B, nh, max_len,
                              hd, layer, cur_len, window, sm_scale, softcap,
                              splits, st);
    return launch_row<f16>(q, k_cache, v_cache, sl, out, B, nh, max_len, hd,
                           layer, cur_len, window, sm_scale, softcap, splits,
                           st);
  }
  const size_t esz = dtype == 0 ? 4 : 2;
  const size_t layer_off = (size_t)layer * B * nh * max_len * hd * esz;
  Multi a;
  a.q = q;
  a.k = static_cast<const char*>(k_cache) + layer_off;
  a.v = static_cast<const char*>(v_cache) + layer_off;
  a.slopes = sl;
  a.out = out;
  a.nh = nh; a.Tq = Tq; a.max_len = max_len; a.hd = hd; a.cur_len = cur_len;
  a.window = window; a.sm_scale = sm_scale; a.softcap = softcap;
  return launch_multi(a, B, dtype, st);
}

const char* decode_attention_error_string(int err) {
  return err < 0 ? "unsupported dtype, head dim, query or split count"
                 : cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"

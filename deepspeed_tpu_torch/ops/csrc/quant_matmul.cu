// Weight-only blockwise-int8 matmul for Hopper (sm_90a), plain C interface.
//
// Replaces the Pallas kernel deepspeed_tpu/ops/pallas/quant_matmul.py
// (_kernel, launched by quant_matmul). It computes
//
//     y[m, n] = sum_kb ( sum_{k in block kb} x[m, k] * q[k, n] ) * s[kb, n]
//
// with q int8 [Kp, N] (N contiguous, as pack_kernel stores it), one f32
// scale per `block` rows of K and column (any block >= 1; 256 by default),
// each block's partial product summed in f32 and scaled, and y in x's
// dtype. Rows of q past K (the
// packing's zero padding) meet zeros of x. A bf16 x and an int8 q are both
// exact in bf16, so the tensor-core products are exact and only the f32
// summation order differs from the plain version. Three kernels, one
// launch a call; the wrapper's _plan picks one:
//
// * gemv (bf16 x, M <= 16: decode). Bound by bytes: every weight byte is
//   read once and used M times. The operands are swapped, y^T = W^T x^T, so
//   the weight tile is the 16-row A operand of mma.sync m16n8k16 and the
//   <= 16 rows of x its 8-wide (or 2 x 8) B side. The A fragment needs
//   pairs of K rows in one register, and q is stored with N contiguous, so
//   a lane loads 16 bytes (16 columns) of each of the 4 K rows its fragment
//   holds (2c, 2c + 1, 2c + 8, 2c + 9 of a 16-row step) and the 16 columns
//   are spread over 8 mma tiles of 2 rows each: tile t, fragment row r
//   (r + 8) is column 16 r + 2 t (+ 1) of the warp's 128. int8 becomes
//   bf16 in registers, two at a time: a byte permute pairs the two K rows
//   of a column, and one exact bf16x2 add of 128 + (v & 0x7F) and -128 -
//   (v & 0x80) gives v. A CTA (8 warps) owns 128 columns and a range of
//   K-blocks, walked in pieces of at most 256 rows inside one block (a
//   256-row block is one piece) of 128 bytes a row that arrive by bulk
//   copies (the copy engine, one row a thread, counted by an mbarrier) in
//   a two-stage ring, so the next piece is in flight while one is
//   multiplied; x and the scales are fetched before the weights are waited
//   on. The warps split each piece's rows and add their partials in warp
//   order through shared memory into the block's sum, scaled once at the
//   block's end. A piece whose length is not a multiple of 16 ends inside
//   a 16-row step: x reads zeros past the piece, so those rows add 0.
// * gemm (bf16 x, M > 16: prefill). Bound by operations above M ~ 300. A
//   128 x 128 CTA tile, 8 warps of 64 x 32 on mma.sync m16n8k16, K steps
//   of 64 through a four-stage cp.async ring of bf16 x and int8 q tiles.
//   Each step's int8 tile is converted to bf16 once into shared memory
//   (the same exact conversion; two buffers, so the next step's conversion
//   overlaps this step's mma and a step takes one barrier) and feeds every
//   warp through ldmatrix.trans; the f32 accumulator of the current
//   K-block is scaled into the running sum at every block boundary. With
//   a block that is a multiple of 16 a 16-row k step never straddles one
//   (the parent's arithmetic, a compile-time variant). Any other block
//   takes the variant ANY: a step that holds a block's end runs its mma
//   once for each block it touches, with the x fragment's K columns on the
//   other side masked to zero, and folds each part into its own block's
//   scale; a split that starts inside a step masks the rows before it.
// * simt (f32 x). Exact f32 on CUDA cores (no TF32, no rounding of x): a
//   CTA owns 8 rows x 128 columns and walks its K-blocks in pieces of at
//   most 256 rows inside one block; its 8 warps split each piece's rows.
//
// Split K: where the tiles are too few to fill the card, the CTAs of a
// tile each take a range of whole K-blocks and form one thread-block
// cluster; they add their f32 sums through distributed shared memory in
// split order, each rank storing a slice of the tile. No scratch in device
// memory, no second kernel, and the result does not depend on scheduling:
// two calls give bit-identical outputs.

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int QB = 256;            // K rows a chunk (the default block)
constexpr int KSTEP = 16;          // the mma k step

// ------------------------------------------------------------ helpers

__device__ __forceinline__ void mma_bf16(float* c, const uint32_t* a,
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
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

// int8 -> bf16, exact, two at a time. The two int8 sit in the low bytes of
// the halves of p (the high bytes are ignored). With l = v & 0x7F and s the
// sign bit, bf16 0x4300 | l is 128 + l and bf16 0xC300 | s << 7 is -128 -
// 128 s; their sum, l - 128 s = v, is exact in bf16, so one bf16x2 add
// converts both.
__device__ __forceinline__ uint32_t i8x2_bf16x2(uint32_t p) {
  const uint32_t t = (p & 0x007F007Fu) | 0x43004300u;
  const uint32_t c = (p & 0x00800080u) | 0xC300C300u;
  uint32_t r;
  asm("add.rn.bf16x2 %0, %1, %2;" : "=r"(r) : "r"(t), "r"(c));
  return r;
}

// 16 int8 of one row (a uint4) -> 16 bf16 (two uint4), in column order
__device__ __forceinline__ void row16_bf16(uint4 v, uint4* out) {
  const uint32_t w[4] = {v.x, v.y, v.z, v.w};
  uint32_t p[8];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    p[2 * i] = i8x2_bf16x2(__byte_perm(w[i], 0u, 0x0100));      // columns 0, 1
    p[2 * i + 1] = i8x2_bf16x2(__byte_perm(w[i], 0u, 0x0302));  // columns 2, 3
  }
  out[0] = make_uint4(p[0], p[1], p[2], p[3]);
  out[1] = make_uint4(p[4], p[5], p[6], p[7]);
}

// the bf16 pairs {row a, row b} of a word's 4 columns: p[j] = column j
__device__ __forceinline__ void pairs4(uint32_t wa, uint32_t wb,
                                       uint32_t* p) {
  p[0] = i8x2_bf16x2(__byte_perm(wa, wb, 0x0400));
  p[1] = i8x2_bf16x2(__byte_perm(wa, wb, 0x0501));
  p[2] = i8x2_bf16x2(__byte_perm(wa, wb, 0x0602));
  p[3] = i8x2_bf16x2(__byte_perm(wa, wb, 0x0703));
}

// 16 bytes of a q row from column n on, zero past N, with plain loads (q
// rows not 16-byte aligned)
__device__ __forceinline__ uint4 load16_masked(const int8_t* src, int n,
                                               int N) {
  uint32_t w[4] = {0u, 0u, 0u, 0u};
#pragma unroll
  for (int b = 0; b < 16; ++b)
    if (n + b < N)
      w[b / 4] |= static_cast<uint32_t>(static_cast<uint8_t>(src[b]))
                  << (8 * (b % 4));
  return make_uint4(w[0], w[1], w[2], w[3]);
}

// Split K inside the launch: the CTAs of a tile are one thread-block
// cluster (grid.y = cluster.y = splits, at most 8), so they run together.
// Each has put its f32 sums of the tile in its shared memory, element (r,
// c) at tile[r * ld + c]; rank z adds rows x cols elements [z * n / S,
// (z + 1) * n / S) over the ranks in rank (= split) order through
// distributed shared memory and hands each total to store(r, c, y). With
// one split (launched without a cluster) it is a CTA barrier and a
// coalesced pass over the tile.
constexpr int MAX_SPLITS = 8;

template <typename Store>
__device__ __forceinline__ void cluster_reduce(float* tile, int rows,
                                               int cols, int ld,
                                               Store store) {
  if (gridDim.y == 1) {           // one split: launched without a cluster
    __syncthreads();
    for (int el = threadIdx.x; el < rows * cols; el += blockDim.x)
      store(el / cols, el % cols, tile[(el / cols) * ld + el % cols]);
    return;
  }
  cg::cluster_group cluster = cg::this_cluster();
  cluster.sync();
  const int S = static_cast<int>(cluster.num_blocks());
  const int z = static_cast<int>(cluster.block_rank());
  const int n = rows * cols;
  const int lo = n * z / S, hi = n * (z + 1) / S;
  for (int el = lo + threadIdx.x; el < hi; el += blockDim.x) {
    const int r = el / cols, c = el % cols, off = r * ld + c;
    float y = 0.f;
#pragma unroll
    for (int k = 0; k < MAX_SPLITS; ++k)
      if (k < S) y += cluster.map_shared_rank(tile, k)[off];
    store(r, c, y);
  }
  cluster.sync();                 // no CTA leaves while its tile is read
}

// ------------------------------------------------ gemv: bf16, M <= 16

constexpr int GV_WARPS = 8;
constexpr int GV_NT = GV_WARPS * 32;
constexpr int GV_BN = 128;                  // columns per CTA (and per warp)
constexpr int GV_STAGES = 2;                // pieces in the ring
constexpr int GV_STEPS = QB / 16 / GV_WARPS;  // 16-row steps per warp and piece
constexpr int GV_ROW = GV_BN + 16;         // bytes per row in shared memory
constexpr size_t GV_STAGE_BYTES = (size_t)QB * GV_ROW;  // one piece's rows

template <int MT> __host__ __device__ constexpr size_t gv_red_bytes() {
  return (size_t)GV_WARPS * MT * 32 * 32 * sizeof(float);
}
template <int MT> __host__ __device__ constexpr size_t gv_smem_bytes() {
  return GV_STAGES * GV_STAGE_BYTES + gv_red_bytes<MT>() +
         GV_STAGES * sizeof(uint64_t);
}

// mbarrier and bulk-copy helpers (the copy engine writes shared memory
// through the async proxy and reports its bytes to the barrier)
__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}
__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n"
               :: "r"(smem_u32(bar)), "r"(count));
}
__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               :: "r"(smem_u32(bar)), "r"(bytes) : "memory");
}
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  asm volatile(
      "{\n.reg .pred done;\nWAIT_%=:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 done, [%0], %1;\n"
      "@!done bra WAIT_%=;\n}\n"
      :: "r"(smem_u32(bar)), "r"(parity) : "memory");
}
__device__ __forceinline__ void bulk_copy(void* dst, const void* src,
                                          uint32_t bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n"
      :: "r"(smem_u32(dst)), "l"(src), "r"(bytes), "r"(smem_u32(bar))
      : "memory");
}
// generic-proxy accesses of shared memory ordered before async-proxy ones
__device__ __forceinline__ void fence_async_shared() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// reduced element el of a CTA's 128 columns x 8 MT rows: the value v =
// el / 32 of lane el % 32's accumulator (v = mt * 32 + tile * 4 + e)
__device__ __forceinline__ void gv_elem(int el, int n_base, int* m, int* n) {
  const int v = el >> 5, ln = el & 31;
  const int mt = v >> 5, t = (v >> 2) & 7, e = v & 3;
  *n = n_base + (ln >> 2) * 16 + 2 * t + (e >> 1);
  *m = mt * 8 + 2 * (ln & 3) + (e & 1);
}

// two CTAs an SM with one 8-row half (at most 128 registers), one with two
template <int MT>
__global__ void __launch_bounds__(GV_NT, 3 - MT)
gemv_kernel(const __nv_bfloat16* __restrict__ x, const int8_t* __restrict__ q,
            const float* __restrict__ scales, __nv_bfloat16* __restrict__ out,
            int M, int K, int N, int nkb, int block, int kb_per, int qvec) {
  constexpr int V = MT * 32;                // accumulator values per lane
  constexpr int OWN = MT * 1024 / GV_NT;    // reduced elements per thread
  extern __shared__ __align__(16) unsigned char smem[];
  unsigned char* ring = smem;               // [stage][256 rows][GV_ROW]
  float* red = reinterpret_cast<float*>(smem + GV_STAGES * GV_STAGE_BYTES);
  uint64_t* bar = reinterpret_cast<uint64_t*>(
      smem + GV_STAGES * GV_STAGE_BYTES + gv_red_bytes<MT>());
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int r = lane >> 2, c = lane & 3;
  const int n_base = blockIdx.x * GV_BN;
  const int kb0 = blockIdx.y * kb_per;
  const int k_begin = kb0 * block;          // this split's rows of K
  const int k_end = min(nkb, kb0 + kb_per) * block;
  // the split's K rows go in pieces of at most 256 inside one K-block (a
  // 256-row block is one piece)
  auto piece = [&](int k) {
    return min(QB, min(k_end, (k / block + 1) * block) - k);
  };
  const unsigned short* xh = reinterpret_cast<const unsigned short*>(x);
  // whole 128-byte rows in the copy engine; a ragged or unaligned tile by
  // plain loads (then the piece barriers order them)
  const bool bulk = qvec && n_base + GV_BN <= N;

  if (tid == 0) {
#pragma unroll
    for (int st = 0; st < GV_STAGES; ++st) mbar_init(bar + st, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  // piece i (rows k0 ..) of the CTA's 128 columns into stage i % STAGES:
  // thread t copies row t
  auto issue = [&](int i, int k0) {
    const int st = i % GV_STAGES, rows = piece(k0);
    if (tid >= rows) return;
    unsigned char* dst = ring + (size_t)st * GV_STAGE_BYTES + tid * GV_ROW;
    const int8_t* src = q + ((size_t)k0 + tid) * N + n_base;
    if (bulk) {
      fence_async_shared();               // the stage's last readers are done
      if (tid == 0) mbar_expect_tx(bar + st, rows * GV_BN);
      bulk_copy(dst, src, GV_BN, bar + st);
    } else {
#pragma unroll
      for (int j = 0; j < GV_BN / 16; ++j)
        reinterpret_cast<uint4*>(dst)[j] = load16_masked(src + 16 * j, n_base + 16 * j, N);
    }
  };

  issue(0, k_begin);
  int k_next = k_begin + piece(k_begin);    // the next piece to issue
  __syncthreads();
  float run[OWN], part[OWN];                // the sums; the block's so far
#pragma unroll
  for (int u = 0; u < OWN; ++u) run[u] = part[u] = 0.f;

  for (int i = 0, k0 = k_begin; k0 < k_end; ++i) {
    const int len = piece(k0);
    if (k_next < k_end) {                   // GV_STAGES == 2
      issue(i + 1, k_next);
      k_next += piece(k_next);
    }
    const int st = i % GV_STAGES;
    const unsigned char* stage = ring + (size_t)st * GV_STAGE_BYTES;
    const int kb = k0 / block;
    const int kx = min(K, k0 + len);        // x reads zeros from here on
    // piece i's x fragments and scales, requested before its weights are
    // waited on. B: x rows mt * 8 + r, K columns 2c, 2c + 1 (b0) and + 8 (b1)
    uint32_t b[GV_STEPS][MT][2];
#pragma unroll
    for (int s = 0; s < GV_STEPS; ++s)
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
        const int m = mt * 8 + r;
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int k = k0 + warp * (GV_STEPS * 16) + s * 16 + 2 * c + 8 * h;
          const size_t o = (size_t)m * K + k;
          const uint32_t lo = (m < M && k < kx) ? __ldg(xh + o) : 0u;
          const uint32_t hi = (m < M && k + 1 < kx) ? __ldg(xh + o + 1) : 0u;
          b[s][mt][h] = lo | (hi << 16);
        }
      }
    float sc[OWN];
#pragma unroll
    for (int u = 0; u < OWN; ++u) {
      int m, n;
      gv_elem(tid + u * GV_NT, n_base, &m, &n);
      sc[u] = n < N ? __ldg(scales + (size_t)kb * N + n) : 0.f;
    }
    float acc[MT][8][4];
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int t = 0; t < 8; ++t)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[mt][t][e] = 0.f;
    if (bulk) mbar_wait(bar + st, (i / GV_STAGES) & 1);   // piece i landed
#pragma unroll
    for (int s = 0; s < GV_STEPS; ++s) {
      if (warp * GV_STEPS * 16 + s * 16 >= len) break;   // past the piece
      // this lane's 16 columns of rows 2c, 2c + 1, 2c + 8, 2c + 9 of the
      // step (rows padded to 144 bytes: the 8 lanes of a phase hit 8 banks)
      const unsigned char* rows =
          stage + (warp * GV_STEPS * 16 + s * 16 + 2 * c) * GV_ROW + r * 16;
      const uint4 R0 = *reinterpret_cast<const uint4*>(rows);
      const uint4 R1 = *reinterpret_cast<const uint4*>(rows + GV_ROW);
      const uint4 R8 = *reinterpret_cast<const uint4*>(rows + 8 * GV_ROW);
      const uint4 R9 = *reinterpret_cast<const uint4*>(rows + 9 * GV_ROW);
      const uint32_t w0[4] = {R0.x, R0.y, R0.z, R0.w};
      const uint32_t w1[4] = {R1.x, R1.y, R1.z, R1.w};
      const uint32_t w8[4] = {R8.x, R8.y, R8.z, R8.w};
      const uint32_t w9[4] = {R9.x, R9.y, R9.z, R9.w};
#pragma unroll
      for (int w = 0; w < 4; ++w) {
        uint32_t lo[4], hi[4];      // rows (2c, 2c+1) / (2c+8, 2c+9), by column
        pairs4(w0[w], w1[w], lo);
        pairs4(w8[w], w9[w], hi);
        // tile 2w: columns 4w (fragment row r) and 4w + 1 (row r + 8)
        const uint32_t a0[4] = {lo[0], lo[1], hi[0], hi[1]};
        const uint32_t a1[4] = {lo[2], lo[3], hi[2], hi[3]};
#pragma unroll
        for (int mt = 0; mt < MT; ++mt) {
          mma_bf16(acc[mt][2 * w], a0, b[s][mt][0], b[s][mt][1]);
          mma_bf16(acc[mt][2 * w + 1], a1, b[s][mt][0], b[s][mt][1]);
        }
      }
    }
    // the warps' partials of piece i, added in warp order; the block's
    // sum is scaled once, at its end
    float* rw = red + (size_t)warp * V * 32 + lane;
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int t = 0; t < 8; ++t)
#pragma unroll
        for (int e = 0; e < 4; ++e) rw[(mt * 32 + t * 4 + e) * 32] = acc[mt][t][e];
    __syncthreads();
#pragma unroll
    for (int u = 0; u < OWN; ++u) {
      const int el = tid + u * GV_NT;
      float blk = part[u];
#pragma unroll
      for (int w = 0; w < GV_WARPS; ++w) blk += red[w * V * 32 + el];
      part[u] = blk;
      if (k0 + len == min(k_end, (kb + 1) * block)) {   // the block ends
        run[u] += blk * sc[u];
        part[u] = 0.f;
      }
    }
    __syncthreads();                        // red is rewritten by piece i + 1
    k0 += len;
  }

  // the tile's sums in red, indexed by reduced element; the cluster adds
  // the splits'
  float* tile = red;
#pragma unroll
  for (int u = 0; u < OWN; ++u) tile[tid + u * GV_NT] = run[u];
  cluster_reduce(tile, 1, MT * 1024, 0, [&](int, int el, float y) {
    int m, n;
    gv_elem(el, n_base, &m, &n);
    if (m < M && n < N) out[(size_t)m * N + n] = __float2bfloat16(y);
  });
}

// ------------------------------------------------- gemm: bf16, M > 16
// ------------------------------------------------- gemm: bf16, M > 16

constexpr int GM_BM = 128, GM_BN = 128, GM_BK = 64;
constexpr int GM_NT = 256;                  // 8 warps: 2 (M) x 4 (N), 64 x 32 each
constexpr int GM_STAGES = 4;
constexpr int GM_XLD = GM_BK + 8;           // bf16 per x row in shared memory
constexpr int GM_BLD = GM_BN + 8;           // bf16 per converted q row
constexpr int GM_TLD = GM_BN + 4;           // f32 per row of the finished tile
constexpr int GM_X_BYTES = GM_BM * GM_XLD * 2;
constexpr int GM_Q_BYTES = GM_BK * GM_BN;
constexpr int GM_STAGE_BYTES = GM_X_BYTES + GM_Q_BYTES;
constexpr int GM_B_BYTES = GM_BK * GM_BLD * 2;
constexpr size_t GM_SMEM = (size_t)GM_STAGES * GM_STAGE_BYTES + 2 * GM_B_BYTES;
static_assert((size_t)GM_BM * GM_TLD * 4 <= GM_SMEM, "tile fits the ring");

// grid.x = tiles, the M tile fastest so that CTAs running together share
// a weight tile in L2; grid.y = splits of whole K-blocks (one cluster).
// Step kt: one barrier; then the next loads are issued, step kt is
// multiplied from its x tile and its converted weights (bs[kt & 1]), and
// step kt + 1's int8 tile is converted into the other bs, so one warp's
// conversion overlaps another's mma. ANY: a block that is not a multiple
// of 16 (see the note at the top).
template <bool ANY>
__global__ void __launch_bounds__(GM_NT, 1)
gemm_kernel(const __nv_bfloat16* __restrict__ x, const int8_t* __restrict__ q,
            const float* __restrict__ scales, __nv_bfloat16* __restrict__ out,
            int M, int K, int N, int nkb, int block, int kb_per, int qvec,
            int xvec) {
  extern __shared__ __align__(16) unsigned char smem[];
  __nv_bfloat16* bs = reinterpret_cast<__nv_bfloat16*>(
      smem + GM_STAGES * GM_STAGE_BYTES);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, c = lane & 3;
  const int wm = warp >> 2, wn = warp & 3;
  const int tiles_m = (M + GM_BM - 1) / GM_BM;
  const int m0 = (blockIdx.x % tiles_m) * GM_BM;
  const int n0 = (blockIdx.x / tiles_m) * GM_BN;
  const int kb0 = blockIdx.y * kb_per;
  const int k_begin = kb0 * block;          // this split's rows of K
  const int k_end = min(nkb, kb0 + kb_per) * block;
  const int kx = min(K, k_end);             // x columns past it read zeros
  // the walk starts at a 16-row step (ANY: the rows before k_begin are
  // masked), so x tiles stay 16-byte aligned
  const int k_walk = ANY ? k_begin & ~(KSTEP - 1) : k_begin;
  const int nkt = (k_end - k_walk + GM_BK - 1) / GM_BK;

  auto x_tile = [&](int st) {
    return reinterpret_cast<__nv_bfloat16*>(smem + st * GM_STAGE_BYTES);
  };
  auto q_tile = [&](int st) {
    return reinterpret_cast<int8_t*>(smem + st * GM_STAGE_BYTES + GM_X_BYTES);
  };
  auto issue = [&](int kt) {
    const int st = kt % GM_STAGES, k = k_walk + kt * GM_BK;
    __nv_bfloat16* xs = x_tile(st);
#pragma unroll
    for (int u = 0; u < GM_BM * GM_BK / 8 / GM_NT; ++u) {
      const int ch = tid + u * GM_NT, row = ch >> 3, kc = k + (ch & 7) * 8;
      const int m = m0 + row;
      __nv_bfloat16* dst = xs + row * GM_XLD + (ch & 7) * 8;
      const __nv_bfloat16* src = x + (size_t)m * K + kc;
      if (xvec) {
        const bool ok = m < M && kc < kx;     // kx % 8 == 0: all 8 or none
        cp_async16(dst, ok ? src : x, ok ? 16 : 0);
      } else {
        const unsigned short* sh = reinterpret_cast<const unsigned short*>(src);
        uint32_t w[4];
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const uint32_t lo = (m < M && kc + 2 * j < kx) ? sh[2 * j] : 0u;
          const uint32_t hi = (m < M && kc + 2 * j + 1 < kx) ? sh[2 * j + 1] : 0u;
          w[j] = lo | (hi << 16);
        }
        *reinterpret_cast<uint4*>(dst) = make_uint4(w[0], w[1], w[2], w[3]);
      }
    }
    int8_t* qs = q_tile(st);
#pragma unroll
    for (int u = 0; u < GM_BK * GM_BN / 16 / GM_NT; ++u) {
      const int ch = tid + u * GM_NT, row = ch >> 3, n = n0 + (ch & 7) * 16;
      int8_t* dst = qs + row * GM_BN + (ch & 7) * 16;
      const int8_t* src = q + (size_t)(k + row) * N + n;
      const bool live = k + row < k_end;    // rows past the split: zeros
      if (qvec)
        cp_async16(dst, live && n < N ? src : q, live && n < N ? 16 : 0);
      else
        *reinterpret_cast<uint4*>(dst) =
            live ? load16_masked(src, n, N) : make_uint4(0u, 0u, 0u, 0u);
    }
  };
  auto convert = [&](int kt) {      // int8 -> bf16 once for all warps
    const int8_t* qs = q_tile(kt % GM_STAGES);
    __nv_bfloat16* b = bs + (kt & 1) * GM_BK * GM_BLD;
#pragma unroll
    for (int u = 0; u < GM_BK * GM_BN / 16 / GM_NT; ++u) {
      const int ch = tid + u * GM_NT, row = ch >> 3, c16 = (ch & 7) * 16;
      uint4 o[2];
      row16_bf16(*reinterpret_cast<const uint4*>(qs + row * GM_BN + c16), o);
      uint4* d = reinterpret_cast<uint4*>(b + row * GM_BLD + c16);
      d[0] = o[0];
      d[1] = o[1];
    }
  };

  float blk[4][4][4], run[4][4][4];
  // run += blk * the scales of K-block kb; blk = 0
  auto fold = [&](int kb) {
#pragma unroll
    for (int nj = 0; nj < 4; ++nj) {
      const int n = n0 + wn * 32 + nj * 8 + 2 * c;
      const float s0 = n < N ? __ldg(scales + (size_t)kb * N + n) : 0.f;
      const float s1 = n + 1 < N ? __ldg(scales + (size_t)kb * N + n + 1) : 0.f;
#pragma unroll
      for (int mi = 0; mi < 4; ++mi) {
        run[mi][nj][0] += blk[mi][nj][0] * s0;
        run[mi][nj][1] += blk[mi][nj][1] * s1;
        run[mi][nj][2] += blk[mi][nj][2] * s0;
        run[mi][nj][3] += blk[mi][nj][3] * s1;
#pragma unroll
        for (int e = 0; e < 4; ++e) blk[mi][nj][e] = 0.f;
      }
    }
  };
  int next_end = k_begin + block;           // the current K-block's end
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) blk[i][j][e] = run[i][j][e] = 0.f;

#pragma unroll
  for (int p = 0; p < GM_STAGES - 1; ++p) {
    if (p < nkt) issue(p);
    cp_async_commit();
  }
  cp_async_wait<GM_STAGES - 2>();   // step 0 landed
  __syncthreads();
  convert(0);
  for (int kt = 0; kt < nkt; ++kt) {
    cp_async_wait<GM_STAGES - 3>(); // steps kt and kt + 1 landed
    __syncthreads();                // bs[kt & 1] converted; step kt-1 done
    if (kt + GM_STAGES - 1 < nkt) issue(kt + GM_STAGES - 1);
    cp_async_commit();
    const __nv_bfloat16* xs = x_tile(kt % GM_STAGES);
    const __nv_bfloat16* b = bs + (kt & 1) * GM_BK * GM_BLD;
#pragma unroll
    for (int kk = 0; kk < GM_BK / 16; ++kk) {
      uint32_t a[4][4], bf[4][2];
#pragma unroll
      for (int mi = 0; mi < 4; ++mi)
        ldsm_x4(a[mi], xs + (wm * 64 + mi * 16 + (lane & 15)) * GM_XLD +
                           kk * 16 + (lane >> 4) * 8);
#pragma unroll
      for (int nj2 = 0; nj2 < 2; ++nj2) {
        uint32_t t[4];
        ldsm_x4_trans(t, b + (kk * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) *
                                 GM_BLD + wn * 32 + nj2 * 16 + (lane >> 4) * 8);
        bf[2 * nj2][0] = t[0];
        bf[2 * nj2][1] = t[1];
        bf[2 * nj2 + 1][0] = t[2];
        bf[2 * nj2 + 1][1] = t[3];
      }
      if constexpr (!ANY) {
#pragma unroll
        for (int mi = 0; mi < 4; ++mi)
#pragma unroll
          for (int nj = 0; nj < 4; ++nj)
            mma_bf16(blk[mi][nj], a[mi], bf[nj][0], bf[nj][1]);
        // a K-block ends at this k step's end: scale it into the sum (rows
        // past k_end are zeros and never end a block)
        const int row_end = k_begin + kt * GM_BK + (kk + 1) * KSTEP;
        if (row_end == next_end && row_end <= k_end) {
          fold(row_end / block - 1);
          next_end += block;
        }
      } else {
        // the step's rows [r, r + 16): x's K columns in [lo, hi) only
        const int r = k_walk + kt * GM_BK + kk * KSTEP;
        auto part = [&](int lo, int hi) {
          uint32_t km[2];
#pragma unroll
          for (int w = 0; w < 2; ++w) {
            const int col = 2 * c + 8 * w;
            km[w] = (col >= lo && col < hi ? 0x0000FFFFu : 0u) |
                    (col + 1 >= lo && col + 1 < hi ? 0xFFFF0000u : 0u);
          }
#pragma unroll
          for (int mi = 0; mi < 4; ++mi) {
            const uint32_t am[4] = {a[mi][0] & km[0], a[mi][1] & km[0],
                                    a[mi][2] & km[1], a[mi][3] & km[1]};
#pragma unroll
            for (int nj = 0; nj < 4; ++nj)
              mma_bf16(blk[mi][nj], am, bf[nj][0], bf[nj][1]);
          }
        };
        int lo = max(0, k_begin - r);       // rows before the split
        const int top = min(KSTEP, k_end - r);
        // every block that ends inside the step: its rows, then its fold
        while (next_end - r < top) {
          part(lo, next_end - r);
          fold(next_end / block - 1);
          lo = next_end - r;
          next_end += block;
        }
        if (lo < top) part(lo, top);
        if (next_end - r == top && next_end <= k_end) {
          fold(next_end / block - 1);
          next_end += block;
        }
      }
    }
    if (kt + 1 < nkt) convert(kt + 1);
  }

  // the tile's sums into the ring (f32, row m, column n), then the cluster
  // adds the splits' and stores bf16 rows coalesced
  cp_async_wait<0>();
  __syncthreads();
  float* tile = reinterpret_cast<float*>(smem);
#pragma unroll
  for (int mi = 0; mi < 4; ++mi)
#pragma unroll
    for (int nj = 0; nj < 4; ++nj)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int r = wm * 64 + mi * 16 + g + 8 * h;
        *reinterpret_cast<float2*>(tile + r * GM_TLD + wn * 32 + nj * 8 + 2 * c) =
            make_float2(run[mi][nj][2 * h], run[mi][nj][2 * h + 1]);
      }
  cluster_reduce(tile, min(GM_BM, M - m0), min(GM_BN, N - n0), GM_TLD,
                 [&](int r, int cc, float y) {
                   out[(size_t)(m0 + r) * N + n0 + cc] = __float2bfloat16(y);
                 });
}

// --------------------------------------------------- simt: f32, any M

constexpr int SM_BN = 128;                  // columns per CTA: 32 lanes x 4
constexpr int SM_BM = 8;                    // rows of x per CTA
constexpr int SM_WARPS = 8;
constexpr int SM_NT = SM_WARPS * 32;
constexpr int SM_ROWS = QB / SM_WARPS;      // K rows per warp per piece
constexpr int SM_OUT = SM_BM * SM_BN / SM_NT;

// Per piece (at most 256 rows inside one K-block): x [8, piece] staged as
// f32 in shared memory; warp w multiplies rows [32w, 32w + 32) of the
// piece in f32 FMAs; the 8 warp partials are added in warp order through
// shared memory into the block's sum, which is scaled once at the block's
// end (a 256-row block is one piece). At most 255 registers (one CTA an
// SM): the 32 packed weight words and the 8 x 4 partials stay in
// registers.
__global__ void __launch_bounds__(SM_NT, 1)
simt_kernel(const float* __restrict__ x, const int8_t* __restrict__ q,
            const float* __restrict__ scales, float* __restrict__ out, int M,
            int K, int N, int nkb, int block, int kb_per) {
  __shared__ float xs[SM_BM * QB];
  __shared__ float red[SM_WARPS * SM_BM * SM_BN];
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int tiles_m = (M + SM_BM - 1) / SM_BM;
  const int m0 = (blockIdx.x % tiles_m) * SM_BM;
  const int col0 = (blockIdx.x / tiles_m) * SM_BN;
  const int n0 = col0 + lane * 4;           // this lane's 4 columns
  const int kb_begin = blockIdx.y * kb_per;
  const int kb_end = min(nkb, kb_begin + kb_per);
  const bool vec4 = (N % 4 == 0) && (n0 + 3 < N) &&
                    (reinterpret_cast<uintptr_t>(q) % 4 == 0);

  float acc[SM_OUT], part[SM_OUT];          // outputs o = tid + j * SM_NT
#pragma unroll
  for (int j = 0; j < SM_OUT; ++j) acc[j] = part[j] = 0.f;

  for (int k0 = kb_begin * block, len; k0 < kb_end * block; k0 += len) {
    const int kb = k0 / block;
    len = min(QB, (kb + 1) * block - k0);   // the piece's rows
#pragma unroll
    for (int i = 0; i < SM_BM * QB / SM_NT; ++i) {
      const int idx = threadIdx.x + i * SM_NT;
      const int m = m0 + idx / QB, kk = idx % QB, k = k0 + kk;
      xs[idx] = (m < M && kk < len && k < K) ? x[(size_t)m * K + k] : 0.f;
    }
    __syncthreads();
    float p[SM_BM][4];
#pragma unroll
    for (int r = 0; r < SM_BM; ++r)
#pragma unroll
      for (int c = 0; c < 4; ++c) p[r][c] = 0.f;
    const int krow = warp * SM_ROWS;
    const int8_t* qb = q + ((size_t)k0 + krow) * N + n0;
    char4 w[SM_ROWS];                       // every load of the warp at once
#pragma unroll
    for (int k = 0; k < SM_ROWS; ++k) {
      const int8_t* qr = qb + (size_t)k * N;
      if (krow + k >= len) {                // past the piece
        w[k] = make_char4(0, 0, 0, 0);
      } else if (vec4) {
        w[k] = *reinterpret_cast<const char4*>(qr);
      } else {
        w[k].x = n0 < N ? qr[0] : 0;
        w[k].y = n0 + 1 < N ? qr[1] : 0;
        w[k].z = n0 + 2 < N ? qr[2] : 0;
        w[k].w = n0 + 3 < N ? qr[3] : 0;
      }
    }
#pragma unroll
    for (int k = 0; k < SM_ROWS; ++k) {
      const float wf[4] = {static_cast<float>(w[k].x), static_cast<float>(w[k].y),
                           static_cast<float>(w[k].z), static_cast<float>(w[k].w)};
#pragma unroll
      for (int r = 0; r < SM_BM; ++r) {
        const float xv = xs[r * QB + krow + k];
#pragma unroll
        for (int c = 0; c < 4; ++c) p[r][c] = fmaf(xv, wf[c], p[r][c]);
      }
    }
#pragma unroll
    for (int r = 0; r < SM_BM; ++r)
#pragma unroll
      for (int c = 0; c < 4; ++c)
        red[(warp * SM_BM + r) * SM_BN + lane * 4 + c] = p[r][c];
    __syncthreads();
#pragma unroll
    for (int j = 0; j < SM_OUT; ++j) {
      const int o = threadIdx.x + j * SM_NT;  // o = r * SM_BN + c
      const int n = col0 + o % SM_BN;
      float blk = part[j];
#pragma unroll
      for (int v = 0; v < SM_WARPS; ++v) blk += red[v * SM_BM * SM_BN + o];
      part[j] = blk;
      if (k0 + len == (kb + 1) * block) {   // the block is complete
        acc[j] += blk * (n < N ? scales[(size_t)kb * N + n] : 0.f);
        part[j] = 0.f;
      }
    }
    __syncthreads();                        // xs / red reused by the next piece
  }

  // red is free (the loop ended on a barrier): the tile's sums, row-major
#pragma unroll
  for (int j = 0; j < SM_OUT; ++j) red[threadIdx.x + j * SM_NT] = acc[j];
  cluster_reduce(red, min(SM_BM, M - m0), min(SM_BN, N - col0), SM_BN,
                 [&](int r, int cc, float y) {
                   out[(size_t)(m0 + r) * N + col0 + cc] = y;
                 });
}

// one launch of `kernel` on a (tiles, splits) grid whose splits of a tile
// form one cluster (no cluster for one split); dynamic shared memory above
// 48 KB is raised once
template <typename... P, typename... A>
cudaError_t launch(void (*kernel)(P...), int tiles, int splits, int threads,
                   size_t smem, bool* smem_set, cudaStream_t stream,
                   A... args) {
  if (smem > 48 * 1024 && !*smem_set) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return e;
    *smem_set = true;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(tiles, splits);
  cfg.blockDim = dim3(threads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = 1;
  attr[0].val.clusterDim.y = splits;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = splits > 1 ? 1 : 0;
  return cudaLaunchKernelEx(&cfg, kernel, args...);
}

}  // namespace

extern "C" {

// regime: 0 = simt (x float32), 1 = gemv (x bfloat16, M <= 16), 2 = gemm
// (x bfloat16). The grid is (tiles, splits) with kb_per K-blocks a split,
// as the wrapper's _plan computes them; splits <= 8 (one cluster a tile).
// qvec / xvec: q rows (x rows) start 16-byte aligned, so tiles go by
// cp.async. block: any scale block >= 1. Returns the CUDA error of the
// launch (0 = launched), -1 for a regime or split count this build lacks,
// -2 for a block below 1.
int quant_matmul_launch(const void* x, const void* q, const void* scales,
                        void* out, int M, int K, int N, int nkb, int block,
                        int regime, int tiles, int kb_per, int splits,
                        int qvec, int xvec, void* stream) {
  if (block <= 0) return -2;
  if (splits < 1 || splits > MAX_SPLITS) return -1;
  const int8_t* qp = static_cast<const int8_t*>(q);
  const float* sp = static_cast<const float*>(scales);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const __nv_bfloat16* xb = static_cast<const __nv_bfloat16*>(x);
  __nv_bfloat16* ob = static_cast<__nv_bfloat16*>(out);
  cudaError_t e;
  if (regime == 0) {
    static bool set = false;
    e = launch(simt_kernel, tiles, splits, SM_NT, 0, &set, st,
               static_cast<const float*>(x), qp, sp, static_cast<float*>(out),
               M, K, N, nkb, block, kb_per);
  } else if (regime == 1 && M <= 8) {
    static bool set = false;
    e = launch(gemv_kernel<1>, tiles, splits, GV_NT, gv_smem_bytes<1>(), &set,
               st, xb, qp, sp, ob, M, K, N, nkb, block, kb_per, qvec);
  } else if (regime == 1 && M <= 16) {
    static bool set = false;
    e = launch(gemv_kernel<2>, tiles, splits, GV_NT, gv_smem_bytes<2>(), &set,
               st, xb, qp, sp, ob, M, K, N, nkb, block, kb_per, qvec);
  } else if (regime == 2 && block % KSTEP == 0) {
    static bool set = false;
    e = launch(gemm_kernel<false>, tiles, splits, GM_NT, GM_SMEM, &set, st,
               xb, qp, sp, ob, M, K, N, nkb, block, kb_per, qvec, xvec);
  } else if (regime == 2) {
    static bool set = false;
    e = launch(gemm_kernel<true>, tiles, splits, GM_NT, GM_SMEM, &set, st,
               xb, qp, sp, ob, M, K, N, nkb, block, kb_per, qvec, xvec);
  } else {
    return -1;
  }
  if (e != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(cudaGetLastError());
}

const char* quant_matmul_error_string(int err) {
  return err == -1   ? "no kernel for this regime, row count or split count"
         : err == -2 ? "scale block below 1"
                     : cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"

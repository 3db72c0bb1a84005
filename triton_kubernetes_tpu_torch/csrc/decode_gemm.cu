// Row-invariant matrix products of the decode and verify ticks, for
// Hopper (sm_90a).
//
// Replaces: no TPU kernel. The JAX package computes the serving products
//   with plain XLA matmuls (`weight_einsum`,
//   triton_kubernetes_tpu/models/llama.py:86; the lm head in `unembed`,
//   :397). This kernel exists to hold the reference's pinned invariant on
//   this card: a speculative verify row is bitwise the decode row at the
//   same length (tests/test_speculation.py:262). cuBLAS picks its kernel
//   (tiles, split of the sum) by the row count, so a verify tick's
//   [B * S]-row product rounds differently from a decode tick's [B]-row
//   one. Here nothing about an output element's sum depends on M.
//
// Computes: a group of up to kMaxProblems products of one input,
//   y_p [M, N_p] = x [M, K] w_p [K, N_p]; x and w bf16, row-major (w a
//   weight in the JAX layout, N contiguous); f32 accumulators; y rounded
//   once to bf16 (the projections), or kept f32 (the lm head: the
//   reference's preferred_element_type). The decode step groups wq, wk and
//   wv, and w3 and w1, which read the same normed input: one launch each.
//   A model served in f32 has f32 x and w and f32 y: that product has its
//   own kernel at the end of this file (CUDA cores, one fmaf chain over
//   each K range), in the same grid and with the same merge.
//
// What bounds it on this card: bytes. At M <= 64 a product does 2 M FLOPs
//   per weight element read, far below the ~295 FLOPs a byte at which the
//   tensor cores and not HBM would limit it, so the bound is the weight
//   bytes over 3.35 TB/s. Reaching it takes bytes in flight on every SM:
//   one block per 64 output columns alone gives 16 blocks for wk and 64
//   for wq or wo on 132 SMs.
//
// Design: the grid is (problem, output tile, split) flattened, the splits
//   of a tile adjacent. The caller picks the tile width (64 or 128
//   columns, `_kernels.gemm_tile`) and S, the number of contiguous ranges
//   of whole 64-wide k tiles K is cut into (range s = [s nk / S,
//   (s + 1) nk / S), `_kernels.gemm_splits`), from the group's N and K
//   alone, never from M. A block (four warps) takes a row tile -- up to 64
//   rows of x -- for its column tile and range, so each weight element is
//   read from HBM once per call for any M <= 64. Larger M (a prefill
//   window's 256 rows) adds row tiles to the grid, innermost, so the row
//   tiles of one (column tile, range) run side by side and read its weights
//   once from HBM and again from the L2. A block walks its range in tiles
//   of 64 through a ring of
//   shared-memory stages kept full by 16-byte cp.async copies, each row
//   XOR-swizzled (16-byte chunk c of row r at c ^ r % 8) so that ldmatrix
//   reads are free of bank conflicts; rows of x past M and columns past N
//   are zero-filled copies and never stored. The four warps split each
//   stage's four 16-deep k steps (four ways at 64 columns, two at 128)
//   and the tile's columns (64 a warp), so a warp reads only its k steps
//   of the x tile: warp (wk, wn) sums, with mma.sync m16n8k16 (bf16 in,
//   f32 accumulate), the k steps wk, wk + kKw, ... of every stage in
//   increasing k, A fragments by ldmatrix and B fragments by
//   ldmatrix.trans from the [k][n] tile. At the end the warps' sums meet
//   in shared memory and are added in the order wk = 0, 1, ...; with S 1
//   the block then stores y. Otherwise it writes that f32 partial to a
//   workspace slab of its tile, and the last of the tile's S blocks to
//   arrive (`__threadfence`, then `atomicAdd` on the tile's counter,
//   which that block sets back to 0) sums the S partials in the order
//   s = 0, 1, ..., S - 1 and rounds once. An output element is then the
//   same chains of mma steps over the same k steps, added in the same
//   order, whatever M is, whichever block came last, whichever tile width
//   holds its column and whichever row tile its row; and an mma's row does
//   not see the other rows of its tile, so the number of 16-row tiles
//   instantiated (MT = 1, 2 or 4, from M) changes no bit of a row.
//
// Measured on an H100 (scripts/bench_decode_gemm.py; PERF.md, Findings):
//   merge costs each block a few L2 round trips at its end, so S stays as
//   small as fills about three quarters of the SMs; deeper rings moved
//   the small groups by a few percent at most; 128 columns with a ring of
//   3 gave the wide groups (w3+w1, the lm head) fewer, longer blocks and
//   half the x reads per weight byte; splitting the k steps over the
//   warps (in place of every warp walking every k step of its columns)
//   took the small groups' verify-row products (M 32) 4-17% faster.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

// Ring depths of the two tile widths (overridable for tuning builds, as
// scripts/bench_decode_gemm.py makes them).
#ifndef TK8S_GEMM_STAGES_64
#define TK8S_GEMM_STAGES_64 8
#endif
#ifndef TK8S_GEMM_STAGES_128
#define TK8S_GEMM_STAGES_128 3
#endif

namespace {

constexpr int kThreads = 128;  // four warps
constexpr int kBk = 64;        // k a stage: one 128-byte row of bf16
constexpr int kMaxRows = 64;   // rows a block (a row tile)
// Ring depth of the 64-column tile when M is past one row tile (a prefill
// window): 5 stages of 16 KB (80 KB) let two blocks share an SM, where
// TK8S_GEMM_STAGES_64's 128 KB leaves one. The depth changes no bit of a
// row.
constexpr int kRowTileStages64 = 5;
constexpr int kMaxProblems = 3;
constexpr int kMaxSplits = 16;

// The ring of a BN-column tile: depth, and bytes of one stage (the x
// tile of 16 MT rows of 128 bytes, then 64 w rows of 2 BN bytes).
template <int BN>
__host__ __device__ constexpr int stages() {
  return BN == 64 ? TK8S_GEMM_STAGES_64 : TK8S_GEMM_STAGES_128;
}
template <int BN>
__host__ __device__ constexpr int row_tile_stages() {
  return BN == 64 ? kRowTileStages64 : TK8S_GEMM_STAGES_128;
}
template <int MT, int BN>
__host__ __device__ constexpr int stage_bytes() {
  return MT * 16 * 128 + kBk * 2 * BN;
}

// The products of one launch: weights, outputs, widths, and the running
// count of output tiles through each problem (tile_end[p] is the first
// tile past problem p; unused problems repeat the last count).
template <typename W, typename Out>
struct Group {
  const W* w[kMaxProblems];
  Out* y[kMaxProblems];
  int n[kMaxProblems];
  int tile_end[kMaxProblems];
};

// Where a block's work lies: its problem's operands and width, the first
// column of its tile, the tile's index in the group, and its split.
template <typename W, typename Out>
struct Work {
  const W* w;
  Out* y;
  int p, n, n0, tile, split, r;
};

template <int BN, typename W, typename Out>
__device__ __forceinline__ Work<W, Out> work_of(const Group<W, Out>& g,
                                                int splits, int row_tiles) {
  Work<W, Out> o;
  o.r = blockIdx.x % row_tiles;
  o.tile = blockIdx.x / row_tiles / splits;
  o.split = blockIdx.x / row_tiles % splits;
  const int p = o.tile < g.tile_end[0] ? 0 : o.tile < g.tile_end[1] ? 1 : 2;
  o.p = p;
  o.w = p == 0 ? g.w[0] : p == 1 ? g.w[1] : g.w[2];
  o.y = p == 0 ? g.y[0] : p == 1 ? g.y[1] : g.y[2];
  o.n = p == 0 ? g.n[0] : p == 1 ? g.n[1] : g.n[2];
  o.n0 = (o.tile - (p == 0 ? 0 : p == 1 ? g.tile_end[0] : g.tile_end[1])) *
         BN;
  return o;
}

// First k tile of range s of nk tiles cut into `splits` ranges.
__device__ __forceinline__ int range_start(int s, int nk, int splits) {
  return (int)((long long)s * nk / splits);
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

// Byte offset of 16-byte chunk c of row r of a tile of `row_bytes`-byte
// rows (128 or 256): the chunk's low three bits XORed with r % 8, so the
// 8 rows an ldmatrix reads at one chunk index fall in 8 distinct 16-byte
// slots of the 128-byte bank line.
template <int row_bytes = 128>
__device__ __forceinline__ uint32_t swz(int r, int c) {
  return (uint32_t)(r * row_bytes + ((c ^ (r & 7)) << 4));
}

// 16 bytes from gmem into shared memory, or 16 zero bytes when !live
// (gmem is then not read).
__device__ __forceinline__ void cp_async16_zfill(void* smem, const void* gmem,
                                                 bool live) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_u32(smem)),
               "l"(gmem), "r"(live ? 16 : 0));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4],
                                            uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4],
                                                  uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

// c (16 x 8, f32) += a (16 x 16, bf16) b (16 x 8, bf16).
__device__ __forceinline__ void mma16816(float (&c)[4],
                                         const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

template <typename Out>
__device__ __forceinline__ void store2(Out* p, float a, float b);
template <>
__device__ __forceinline__ void store2<float>(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}
template <>
__device__ __forceinline__ void store2<__nv_bfloat16>(__nv_bfloat16* p,
                                                      float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
}

// After a block has written its partial to the workspace: true in the
// last of the tile's `splits` blocks to get here, which also resets the
// tile's counter for the next call. `flag` is a word of shared memory.
__device__ __forceinline__ bool last_to_arrive(int* counters, int tile,
                                               int splits, int* flag) {
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0)
    *flag = atomicAdd(counters + tile, 1) == splits - 1;
  __syncthreads();
  if (!*flag) return false;
  __threadfence();
  if (threadIdx.x == 0) counters[tile] = 0;
  return true;
}

// Issue the copies of k tile kt into one stage: x rows 0 .. 16 MT - 1
// (zero past m), then w rows k0 .. k0 + 63 at columns n0 .. n0 + BN - 1
// (zero past k and n). A thread keeps one 16-byte chunk of a row and
// takes every (128 / chunks a row)-th row, so its swizzle term is fixed.
template <int MT, int BN>
__device__ __forceinline__ void load_stage(unsigned char* stage,
                                           const __nv_bfloat16* x,
                                           const __nv_bfloat16* w, int m,
                                           int n, int k, int n0, int kt) {
  constexpr int xrows = kThreads / 8;  // x rows a pass
  const int t = threadIdx.x, c = t % 8, r0 = t / 8;
  const int k0 = kt * kBk;
  const bool k_live = k0 + 8 * c < k;
#pragma unroll
  for (int p = 0; p < (MT * 16 + xrows - 1) / xrows; ++p) {
    const int r = r0 + xrows * p;
    if (r >= MT * 16) break;
    const bool live = r < m && k_live;
    cp_async16_zfill(stage + swz(r, c),
                     live ? x + (size_t)r * k + k0 + 8 * c : x, live);
  }
  unsigned char* wst = stage + MT * 16 * 128;
  constexpr int chunks = BN / 8, rows = kThreads / chunks;
  const int wc = t % chunks, wr0 = t / chunks;
  const bool n_live = n0 + 8 * wc < n;
#pragma unroll
  for (int p = 0; p < kBk / rows; ++p) {
    const int r = wr0 + rows * p;
    const bool live = n_live && k0 + r < k;
    cp_async16_zfill(wst + swz<2 * BN>(r, wc),
                     live ? w + (size_t)(k0 + r) * n + n0 + 8 * wc : w, live);
  }
}

template <int MT, int BN, int kStages, typename Out>
__global__ void __launch_bounds__(kThreads)
decode_gemm_kernel(const __nv_bfloat16* __restrict__ x,
                   Group<__nv_bfloat16, Out> g, int m, int k, int splits,
                   float* __restrict__ ws, int* __restrict__ counters) {
  constexpr int kBytes = stage_bytes<MT, BN>();
  // The warps split each stage's four 16-deep k steps kKw ways and the
  // tile's columns 64 a warp: (4, 1) at BN 64, (2, 2) at BN 128. A warp
  // reads only its own k steps of the x tile, and no two warps the same
  // part of the w tile.
  constexpr int kKw = 4 * 64 / BN, kKsteps = kBk / 16 / kKw;
  constexpr int kPitch = BN + 4;  // floats a row of the reduce buffer
  static_assert(kKw * MT * 16 * kPitch * 4 <= kStages * kBytes,
                "the reduce buffer reuses the ring");
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int row_tiles = (m + kMaxRows - 1) / kMaxRows;
  const Work<__nv_bfloat16, Out> job = work_of<BN>(g, splits, row_tiles);
  const __nv_bfloat16* w = job.w;
  const int n = job.n, n0 = job.n0;
  // This block's rows: row tile r of x and y. Partials of a (column tile,
  // row tile) pair share a slab of `rows`-row stride and one counter.
  const int rows = min(m, kMaxRows);
  const int mr = min(kMaxRows, m - kMaxRows * job.r);
  x += (size_t)kMaxRows * job.r * k;
  Out* const y = job.y + (size_t)kMaxRows * job.r * n;
  const int slot = job.tile * row_tiles + job.r;
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int wk = warp % kKw, wn = warp / kKw;
  const int nk = (k + kBk - 1) / kBk;
  const int kt0 = range_start(job.split, nk, splits);
  const int len = range_start(job.split + 1, nk, splits) - kt0;

  float acc[MT][8][4];
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;

#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < len)
      load_stage<MT, BN>(smem_raw + s * kBytes, x, w, mr, n, k, n0, kt0 + s);
    cp_async_commit();
  }

  // ldmatrix row addresses: lane l names row (l % 8) + 8 ((l / 8) % 2) of
  // a 16-row block and 16-byte chunk l / 16 of a 16-column step.
  const int lr = (lane % 8) + 8 * ((lane / 8) % 2), lc = lane / 16;
  for (int j = 0; j < len; ++j) {
    cp_async_wait<kStages - 2>();
    __syncthreads();  // tile j has landed; stage j - 1 is free
    const int next = j + kStages - 1;
    if (next < len)
      load_stage<MT, BN>(smem_raw + (next % kStages) * kBytes, x, w, mr, n,
                         k, n0, kt0 + next);
    cp_async_commit();

    const unsigned char* xs = smem_raw + (j % kStages) * kBytes;
    const unsigned char* wst = xs + MT * 16 * 128;
#pragma unroll
    for (int q2 = 0; q2 < kKsteps; ++q2) {
      const int kk = wk + kKw * q2;
      uint32_t b[4][4];  // per 16 columns: b0, b1 of each n8 tile
#pragma unroll
      for (int q = 0; q < 4; ++q)
        ldmatrix_x4_trans(b[q], smem_u32(wst + swz<2 * BN>(
                                             16 * kk + lr,
                                             8 * wn + 2 * q + lc)));
#pragma unroll
      for (int i = 0; i < MT; ++i) {
        uint32_t a[4];
        ldmatrix_x4(a, smem_u32(xs + swz(16 * i + lr, 2 * kk + lc)));
#pragma unroll
        for (int nj = 0; nj < 8; ++nj)
          mma16816(acc[i][nj], a, b[nj / 2][2 * (nj % 2)],
                   b[nj / 2][2 * (nj % 2) + 1]);
      }
    }
  }
  cp_async_wait<0>();
  __syncthreads();  // every warp is done with the ring

  // Each warp's sums over its k steps into red [kKw][16 MT][kPitch]
  // (accumulator element e of an m16n8 tile: row g + 8 (e / 2), columns
  // 2 (lane % 4) + e % 2, g = lane / 4), then each thread adds the kKw
  // sums of its column pairs in the order wk = 0, 1, ...
  float* red = reinterpret_cast<float*>(smem_raw);
  const int gr = lane / 4, cc = 2 * (lane % 4);
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int nj = 0; nj < 8; ++nj)
#pragma unroll
      for (int h = 0; h < 2; ++h)
        *reinterpret_cast<float2*>(
            red + (wk * MT * 16 + 16 * i + gr + 8 * h) * kPitch + 64 * wn +
            8 * nj + cc) =
            make_float2(acc[i][nj][2 * h], acc[i][nj][2 * h + 1]);
  __syncthreads();
  // The slab of partials, when K is split: [splits][rows][BN] f32.
  float* slab =
      splits > 1 ? ws + (size_t)slot * splits * rows * BN : nullptr;
  for (int e = threadIdx.x; e < mr * (BN / 2); e += kThreads) {
    const int row = e / (BN / 2), col = 2 * (e % (BN / 2));
    if (n0 + col >= n) continue;  // N is a multiple of 8: pairs live or not
    float2* own = reinterpret_cast<float2*>(red + row * kPitch + col);
    float2 v = *own;
#pragma unroll
    for (int q = 1; q < kKw; ++q) {
      const float2 u = *reinterpret_cast<const float2*>(
          red + (q * MT * 16 + row) * kPitch + col);
      v.x += u.x;
      v.y += u.y;
    }
    if (splits == 1) {
      store2<Out>(y + (size_t)row * n + n0 + col, v.x, v.y);
    } else {
      *reinterpret_cast<float2*>(
          slab + ((size_t)job.split * rows + row) * BN + col) = v;
      *own = v;
    }
  }
  if (splits == 1) return;
  int* flag = reinterpret_cast<int*>(smem_raw + kStages * kBytes);
  if (!last_to_arrive(counters, slot, splits, flag)) return;
  // Sum the partials in split order; this block's own from shared memory.
  for (int e = threadIdx.x; e < mr * (BN / 2); e += kThreads) {
    const int row = e / (BN / 2), col = 2 * (e % (BN / 2));
    if (n0 + col >= n) continue;
    const float2 own =
        *reinterpret_cast<const float2*>(red + row * kPitch + col);
    float2 sum = job.split == 0
                     ? own
                     : __ldcg(reinterpret_cast<const float2*>(
                           slab + (size_t)row * BN + col));
    for (int s = 1; s < splits; ++s) {
      const float2 v = s == job.split
                           ? own
                           : __ldcg(reinterpret_cast<const float2*>(
                                 slab + ((size_t)s * rows + row) * BN + col));
      sum.x += v.x;
      sum.y += v.y;
    }
    store2<Out>(y + (size_t)row * n + n0 + col, sum.x, sum.y);
  }
}

// ---------------------------------------------------------------------
// W8A8: int8 or fp8 (e4m3) operands, the activation quantized per row
// (csrc/quantize_rows.cu) and each weight per output column, both scales
// folded in after the sum: y[m][n] = (float(sum_k xq[m][k] wq[n][k]) *
// x_scale[m]) * w_scale[n], rounded once to y's type. The reference's
// `quantized_einsum` (triton_kubernetes_tpu/ops/quantization.py:265): an
// int8 product summed in int32, an fp8 product in f32, and the same
// epilogue in the same order.
//
// The same grid, tiles, K split and ring as the bf16 kernel, on bytes: a
// stage is 128 k of 8-bit values (one 128-byte row, the bf16 stage's
// bytes), walked in four k steps of 32 by mma.sync m16n8k32 (s8 x s8 ->
// s32, or e4m3 x e4m3 -> f32). The weight is stored K-contiguous, [N, K]
// (`models/llama.py` transposes it once, when it quantizes): ldmatrix.trans
// moves 16-bit elements, so the [K, N] layout cannot give the "col" B
// fragment of 8-bit values; rows of n with k contiguous give it by a plain
// ldmatrix, as the A fragment of x rows. int8 partial sums -- the warps'
// and the K split's -- are added in int32 (the workspace holds int32), so
// the int8 sum is exact and its order does not matter: a row is bitwise
// its plain version for any M and S. fp8 partials are added in f32 in the
// order of the bf16 kernel (wk = 0, 1, ...; s = 0, 1, ..., S - 1), so an
// fp8 row too is the same whatever M is.
constexpr int kBk8 = 128;  // k a stage: one 128-byte row of 8-bit values

template <bool kInt8> struct Acc8;
template <> struct Acc8<true> { using S = int; using V = int2; };
template <> struct Acc8<false> { using S = float; using V = float2; };

// c (16 x 8) += a (16 x 32) b (32 x 8): int8 into int32, or e4m3 into f32
// (the accumulator's type picks the instruction).
__device__ __forceinline__ void mma16832(int (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%0, %1, %2, %3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}
__device__ __forceinline__ void mma16832(float (&c)[4],
                                         const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.f32.e4m3.e4m3.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ float acc_to_f32(int v) { return __int2float_rn(v); }
__device__ __forceinline__ float acc_to_f32(float v) { return v; }
__device__ __forceinline__ int2 add2(int2 a, int2 b) {
  return make_int2(a.x + b.x, a.y + b.y);
}
__device__ __forceinline__ float2 add2(float2 a, float2 b) {
  return make_float2(a.x + b.x, a.y + b.y);
}

// y[row][col, col + 1] of a summed pair: the epilogue, then one rounding.
template <typename Out, typename V>
__device__ __forceinline__ void store_scaled(Out* y, V v, float xs,
                                             const float* ws) {
  store2<Out>(y, __fmul_rn(__fmul_rn(acc_to_f32(v.x), xs), ws[0]),
              __fmul_rn(__fmul_rn(acc_to_f32(v.y), xs), ws[1]));
}

// The copies of k tile kt (128 bytes of k) into one stage: x rows 0 ..
// 16 MT - 1 (zero past m), then weight rows n0 .. n0 + BN - 1 (zero past
// n), each 128 bytes of k (zero past k; K is a multiple of 16).
template <int MT, int BN>
__device__ __forceinline__ void load_stage8(unsigned char* stage,
                                            const uint8_t* x,
                                            const uint8_t* w, int m, int n,
                                            int k, int n0, int kt) {
  constexpr int rows = kThreads / 8;  // rows a pass
  const int t = threadIdx.x, c = t % 8, r0 = t / 8;
  const int k0 = kt * kBk8;
  const bool k_live = k0 + 16 * c < k;
#pragma unroll
  for (int p = 0; p < (MT * 16 + rows - 1) / rows; ++p) {
    const int r = r0 + rows * p;
    if (r >= MT * 16) break;
    const bool live = r < m && k_live;
    cp_async16_zfill(stage + swz(r, c),
                     live ? x + (size_t)r * k + k0 + 16 * c : x, live);
  }
  unsigned char* wst = stage + MT * 16 * 128;
#pragma unroll
  for (int p = 0; p < BN / rows; ++p) {
    const int r = r0 + rows * p;
    const bool live = k_live && n0 + r < n;
    cp_async16_zfill(wst + swz(r, c),
                     live ? w + (size_t)(n0 + r) * k + k0 + 16 * c : w, live);
  }
}

// The weights' per-column scales of a group, beside its Group.
struct Scales {
  const float* s[kMaxProblems];
};

template <int MT, int BN, int kStages, bool kInt8, typename Out>
__global__ void __launch_bounds__(kThreads)
decode_gemm_w8a8_kernel(const uint8_t* __restrict__ x,
                        const float* __restrict__ x_scale,
                        Group<uint8_t, Out> g, Scales sc, int m, int k,
                        int splits, void* __restrict__ ws,
                        int* __restrict__ counters) {
  using S = typename Acc8<kInt8>::S;
  using V = typename Acc8<kInt8>::V;
  constexpr int kBytes = stage_bytes<MT, BN>();
  // Each stage's four k steps of 32 split kKw ways, the columns 64 a
  // warp, as in the bf16 kernel.
  constexpr int kKw = 4 * 64 / BN, kKsteps = kBk8 / 32 / kKw;
  constexpr int kPitch = BN + 4;
  static_assert(kKw * MT * 16 * kPitch * 4 <= kStages * kBytes,
                "the reduce buffer reuses the ring");
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int row_tiles = (m + kMaxRows - 1) / kMaxRows;
  const Work<uint8_t, Out> job = work_of<BN>(g, splits, row_tiles);
  const uint8_t* w = job.w;
  const float* w_scale = sc.s[job.p];
  const int n = job.n, n0 = job.n0;
  const int rows = min(m, kMaxRows);
  const int mr = min(kMaxRows, m - kMaxRows * job.r);
  x += (size_t)kMaxRows * job.r * k;
  x_scale += kMaxRows * job.r;
  Out* const y = job.y + (size_t)kMaxRows * job.r * n;
  const int slot = job.tile * row_tiles + job.r;
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int wk = warp % kKw, wn = warp / kKw;
  const int nk = (k + kBk8 - 1) / kBk8;
  const int kt0 = range_start(job.split, nk, splits);
  const int len = range_start(job.split + 1, nk, splits) - kt0;

  S acc[MT][8][4];
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0;

#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < len)
      load_stage8<MT, BN>(smem_raw + s * kBytes, x, w, mr, n, k, n0, kt0 + s);
    cp_async_commit();
  }

  // ldmatrix row addresses. A (x rows): matrices (rows 0-7, bytes 0-15),
  // (rows 8-15, 0-15), (rows 0-7, 16-31), (rows 8-15, 16-31) of a k step.
  // B (weight rows n): (n 0-7, bytes 0-15), (n 0-7, 16-31), (n 8-15,
  // 0-15), (n 8-15, 16-31) of 16 columns: b0 and b1 of two n8 tiles.
  const int lr = (lane % 8) + 8 * ((lane / 8) % 2), lc = lane / 16;
  const int br = (lane % 8) + 8 * (lane / 16), bc = (lane / 8) % 2;
  for (int j = 0; j < len; ++j) {
    cp_async_wait<kStages - 2>();
    __syncthreads();  // tile j has landed; stage j - 1 is free
    const int next = j + kStages - 1;
    if (next < len)
      load_stage8<MT, BN>(smem_raw + (next % kStages) * kBytes, x, w, mr, n,
                          k, n0, kt0 + next);
    cp_async_commit();

    const unsigned char* xs = smem_raw + (j % kStages) * kBytes;
    const unsigned char* wst = xs + MT * 16 * 128;
#pragma unroll
    for (int q2 = 0; q2 < kKsteps; ++q2) {
      const int kk = wk + kKw * q2;
      uint32_t b[4][4];
#pragma unroll
      for (int q = 0; q < 4; ++q)
        ldmatrix_x4(b[q], smem_u32(wst + swz(64 * wn + 16 * q + br,
                                             2 * kk + bc)));
#pragma unroll
      for (int i = 0; i < MT; ++i) {
        uint32_t a[4];
        ldmatrix_x4(a, smem_u32(xs + swz(16 * i + lr, 2 * kk + lc)));
#pragma unroll
        for (int nj = 0; nj < 8; ++nj)
          mma16832(acc[i][nj], a, b[nj / 2][2 * (nj % 2)],
                   b[nj / 2][2 * (nj % 2) + 1]);
      }
    }
  }
  cp_async_wait<0>();
  __syncthreads();  // every warp is done with the ring

  // The warps' sums meet in red [kKw][16 MT][kPitch] (of S) and are added
  // in the order wk = 0, 1, ...; then the split's merge, as in the bf16
  // kernel, on S.
  S* red = reinterpret_cast<S*>(smem_raw);
  const int gr = lane / 4, cc = 2 * (lane % 4);
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int nj = 0; nj < 8; ++nj)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        V v;
        v.x = acc[i][nj][2 * h];
        v.y = acc[i][nj][2 * h + 1];
        *reinterpret_cast<V*>(red + (wk * MT * 16 + 16 * i + gr + 8 * h) *
                                        kPitch +
                              64 * wn + 8 * nj + cc) = v;
      }
  __syncthreads();
  S* slab = splits > 1 ? reinterpret_cast<S*>(ws) +
                             (size_t)slot * splits * rows * BN
                       : nullptr;
  for (int e = threadIdx.x; e < mr * (BN / 2); e += kThreads) {
    const int row = e / (BN / 2), col = 2 * (e % (BN / 2));
    if (n0 + col >= n) continue;
    V* own = reinterpret_cast<V*>(red + row * kPitch + col);
    V v = *own;
#pragma unroll
    for (int q = 1; q < kKw; ++q)
      v = add2(v, *reinterpret_cast<const V*>(
                      red + (q * MT * 16 + row) * kPitch + col));
    if (splits == 1) {
      store_scaled<Out>(y + (size_t)row * n + n0 + col, v, x_scale[row],
                        w_scale + n0 + col);
    } else {
      *reinterpret_cast<V*>(slab + ((size_t)job.split * rows + row) * BN +
                            col) = v;
      *own = v;
    }
  }
  if (splits == 1) return;
  int* flag = reinterpret_cast<int*>(smem_raw + kStages * kBytes);
  if (!last_to_arrive(counters, slot, splits, flag)) return;
  for (int e = threadIdx.x; e < mr * (BN / 2); e += kThreads) {
    const int row = e / (BN / 2), col = 2 * (e % (BN / 2));
    if (n0 + col >= n) continue;
    const V own = *reinterpret_cast<const V*>(red + row * kPitch + col);
    V sum = job.split == 0 ? own
                           : __ldcg(reinterpret_cast<const V*>(
                                 slab + (size_t)row * BN + col));
    for (int s = 1; s < splits; ++s)
      sum = add2(sum, s == job.split
                          ? own
                          : __ldcg(reinterpret_cast<const V*>(
                                slab + ((size_t)s * rows + row) * BN + col)));
    store_scaled<Out>(y + (size_t)row * n + n0 + col, sum, x_scale[row],
                      w_scale + n0 + col);
  }
}

// f32 operands. There is no full-f32 tensor-core product, so this one is
// on the CUDA cores, in the same grid and with the same merge: one block
// per (tile, split) and every row. Its K range is walked in tiles of
// kF32Bk staged through shared memory; thread t owns column t % BN and
// rows t / BN + (256 / BN) i, and sums each output with fmaf over k in
// increasing order. That chain is the same whatever M is, so a row's bits
// are too. Rows past M are neither loaded nor summed.
constexpr int kF32Threads = 256;
constexpr int kF32Bk = 32;  // divides kBk: a range is whole kF32Bk tiles

template <int BN>
__global__ void __launch_bounds__(kF32Threads)
decode_gemm_f32_kernel(const float* __restrict__ x, Group<float, float> g,
                       int m, int k, int splits, float* __restrict__ ws,
                       int* __restrict__ counters) {
  constexpr int kGroups = kF32Threads / BN;   // row groups: 4 or 2
  constexpr int kRows = kMaxRows / kGroups;   // rows a thread: 16 or 32
  __shared__ float xs[kMaxRows][kF32Bk];
  __shared__ float wsh[kF32Bk][BN];
  __shared__ int flag;
  const int row_tiles = (m + kMaxRows - 1) / kMaxRows;
  const Work<float, float> job = work_of<BN>(g, splits, row_tiles);
  const float* w = job.w;
  const int n = job.n, n0 = job.n0;
  // This block's rows (row tile r), and the slab's row stride.
  const int stride = min(m, kMaxRows);
  const int mr = min(kMaxRows, m - kMaxRows * job.r);
  x += (size_t)kMaxRows * job.r * k;
  float* const y = job.y + (size_t)kMaxRows * job.r * n;
  const int slot = job.tile * row_tiles + job.r;
  const int t = threadIdx.x, col = t % BN, rg = t / BN;
  const int nk = (k + kBk - 1) / kBk;
  const int k_begin = range_start(job.split, nk, splits) * kBk;
  const int k_end = min(range_start(job.split + 1, nk, splits) * kBk, k);
  // Warp-uniform: a warp's 32 threads share rg.
  const int rows = (mr - rg + kGroups - 1) / kGroups;

  float acc[kRows];
#pragma unroll
  for (int i = 0; i < kRows; ++i) acc[i] = 0.f;

  for (int k0 = k_begin; k0 < k_end; k0 += kF32Bk) {
    for (int e = t; e < mr * kF32Bk; e += kF32Threads) {
      const int r = e / kF32Bk, c = e % kF32Bk;
      xs[r][c] = k0 + c < k ? x[(size_t)r * k + k0 + c] : 0.f;
    }
    for (int e = t; e < kF32Bk * BN; e += kF32Threads) {
      const int r = e / BN, c = e % BN;
      wsh[r][c] = (k0 + r < k && n0 + c < n)
                      ? w[(size_t)(k0 + r) * n + n0 + c]
                      : 0.f;
    }
    __syncthreads();
#pragma unroll 4
    for (int kk = 0; kk < kF32Bk; ++kk) {
      const float wv = wsh[kk][col];
#pragma unroll
      for (int i = 0; i < kRows; ++i)
        if (i < rows) acc[i] = fmaf(xs[rg + kGroups * i][kk], wv, acc[i]);
    }
    __syncthreads();
  }
  const bool live = n0 + col < n;
  if (splits > 1) {
    float* slab = ws + (size_t)slot * splits * stride * BN;
#pragma unroll
    for (int i = 0; i < kRows; ++i)
      if (i < rows && live)
        slab[((size_t)job.split * stride + rg + kGroups * i) * BN + col] =
            acc[i];
    if (!last_to_arrive(counters, slot, splits, &flag)) return;
#pragma unroll
    for (int i = 0; i < kRows; ++i) {
      if (i >= rows || !live) continue;
      const int row = rg + kGroups * i;
      float sum =
          job.split == 0 ? acc[i] : __ldcg(slab + (size_t)row * BN + col);
      for (int s = 1; s < splits; ++s)
        sum += s == job.split
                   ? acc[i]
                   : __ldcg(slab + ((size_t)s * stride + row) * BN + col);
      acc[i] = sum;
    }
  }
  if (!live) return;
#pragma unroll
  for (int i = 0; i < kRows; ++i)
    if (i < rows) y[(size_t)(rg + kGroups * i) * n + n0 + col] = acc[i];
}

// Checks the arguments every entry shares and fills the group; returns
// the grid's block count, or 0 for arguments the kernels do not take.
template <typename W, typename Out>
int make_group(Group<W, Out>& g, const void* const* w, void* const* y,
               const int* n, int count, int m, int k, int tile_n,
               int splits, const void* ws, const void* counters) {
  const int nk = (k + kBk - 1) / kBk;
  if (count < 1 || count > kMaxProblems || m < 1 || k < 8 ||
      k % 8 != 0 || (tile_n != 64 && tile_n != 128) || splits < 1 ||
      splits > kMaxSplits || splits > nk ||
      (splits > 1 && (ws == nullptr || counters == nullptr)))
    return 0;
  int tiles = 0;
  for (int p = 0; p < kMaxProblems; ++p) {
    if (p < count) {
      if (n[p] < 8 || n[p] % 8 != 0 || w[p] == nullptr || y[p] == nullptr)
        return 0;
      g.w[p] = (const W*)w[p];
      g.y[p] = (Out*)y[p];
      g.n[p] = n[p];
      tiles += (n[p] + tile_n - 1) / tile_n;
    } else {
      g.w[p] = g.w[count - 1];
      g.y[p] = g.y[count - 1];
      g.n[p] = g.n[count - 1];
    }
    g.tile_end[p] = tiles;
  }
  return tiles * splits * ((m + kMaxRows - 1) / kMaxRows);
}

template <int MT, int BN, int kStages, typename Out>
int launch_bf16(const void* x, const Group<__nv_bfloat16, Out>& g,
                int blocks, int m, int k, int splits, void* ws,
                void* counters, cudaStream_t stream) {
  // The ring, then the flag word.
  constexpr int smem = kStages * stage_bytes<MT, BN>() + 16;
  cudaError_t e = cudaFuncSetAttribute(
      decode_gemm_kernel<MT, BN, kStages, Out>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return (int)e;
  decode_gemm_kernel<MT, BN, kStages, Out><<<blocks, kThreads, smem,
                                             stream>>>(
      (const __nv_bfloat16*)x, g, m, k, splits, (float*)ws, (int*)counters);
  return (int)cudaGetLastError();
}

template <int BN, typename Out>
int launch_rows(const void* x, const Group<__nv_bfloat16, Out>& g,
                int blocks, int m, int k, int splits, void* ws,
                void* counters, cudaStream_t s) {
  constexpr int kRing = stages<BN>();
  if (m <= 16)
    return launch_bf16<1, BN, kRing, Out>(x, g, blocks, m, k, splits, ws,
                                          counters, s);
  if (m <= 32)
    return launch_bf16<2, BN, kRing, Out>(x, g, blocks, m, k, splits, ws,
                                          counters, s);
  if (m <= kMaxRows)
    return launch_bf16<4, BN, kRing, Out>(x, g, blocks, m, k, splits, ws,
                                          counters, s);
  return launch_bf16<4, BN, row_tile_stages<BN>(), Out>(
      x, g, blocks, m, k, splits, ws, counters, s);
}

template <typename Out>
int launch(const void* x, const void* const* w, void* const* y,
           const int* n, int count, int m, int k, int tile_n, int splits,
           void* ws, void* counters, void* stream) {
  Group<__nv_bfloat16, Out> g;
  const int blocks =
      make_group(g, w, y, n, count, m, k, tile_n, splits, ws, counters);
  if (blocks == 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (tile_n == 64)
    return launch_rows<64, Out>(x, g, blocks, m, k, splits, ws, counters, s);
  return launch_rows<128, Out>(x, g, blocks, m, k, splits, ws, counters, s);
}

int launch_f32(const void* x, const void* const* w, void* const* y,
               const int* n, int count, int m, int k, int tile_n,
               int splits, void* ws, void* counters, void* stream) {
  Group<float, float> g;
  const int blocks =
      make_group(g, w, y, n, count, m, k, tile_n, splits, ws, counters);
  if (blocks == 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (tile_n == 64)
    decode_gemm_f32_kernel<64><<<blocks, kF32Threads, 0, s>>>(
        (const float*)x, g, m, k, splits, (float*)ws, (int*)counters);
  else
    decode_gemm_f32_kernel<128><<<blocks, kF32Threads, 0, s>>>(
        (const float*)x, g, m, k, splits, (float*)ws, (int*)counters);
  return (int)cudaGetLastError();
}

template <int MT, int BN, int kStages, bool kInt8, typename Out>
int launch_w8a8_rows(const void* x, const void* x_scale,
                     const Group<uint8_t, Out>& g, const Scales& sc,
                     int blocks, int m, int k, int splits, void* ws,
                     void* counters, cudaStream_t stream) {
  constexpr int smem = kStages * stage_bytes<MT, BN>() + 16;
  cudaError_t e = cudaFuncSetAttribute(
      decode_gemm_w8a8_kernel<MT, BN, kStages, kInt8, Out>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return (int)e;
  decode_gemm_w8a8_kernel<MT, BN, kStages, kInt8, Out><<<blocks, kThreads,
                                                         smem, stream>>>(
      (const uint8_t*)x, (const float*)x_scale, g, sc, m, k, splits, ws,
      (int*)counters);
  return (int)cudaGetLastError();
}

template <int BN, bool kInt8, typename Out>
int launch_w8a8_tile(const void* x, const void* x_scale,
                     const Group<uint8_t, Out>& g, const Scales& sc,
                     int blocks, int m, int k, int splits, void* ws,
                     void* counters, cudaStream_t s) {
  constexpr int kRing = stages<BN>();
  if (m <= 16)
    return launch_w8a8_rows<1, BN, kRing, kInt8, Out>(
        x, x_scale, g, sc, blocks, m, k, splits, ws, counters, s);
  if (m <= 32)
    return launch_w8a8_rows<2, BN, kRing, kInt8, Out>(
        x, x_scale, g, sc, blocks, m, k, splits, ws, counters, s);
  if (m <= kMaxRows)
    return launch_w8a8_rows<4, BN, kRing, kInt8, Out>(
        x, x_scale, g, sc, blocks, m, k, splits, ws, counters, s);
  return launch_w8a8_rows<4, BN, row_tile_stages<BN>(), kInt8, Out>(
      x, x_scale, g, sc, blocks, m, k, splits, ws, counters, s);
}

template <bool kInt8, typename Out>
int launch_w8a8(const void* x, const void* x_scale, const void* const* w,
                const void* const* scale, void* const* y, const int* n,
                int count, int m, int k, int tile_n, int splits, void* ws,
                void* counters, void* stream) {
  Group<uint8_t, Out> g;
  const int blocks =
      make_group(g, w, y, n, count, m, k, tile_n, splits, ws, counters);
  if (blocks == 0 || k % 16 != 0 || splits > (k + kBk8 - 1) / kBk8 ||
      x_scale == nullptr)
    return (int)cudaErrorInvalidValue;
  Scales sc;
  for (int p = 0; p < kMaxProblems; ++p) {
    sc.s[p] = (const float*)scale[p < count ? p : count - 1];
    if (sc.s[p] == nullptr) return (int)cudaErrorInvalidValue;
  }
  cudaStream_t s = (cudaStream_t)stream;
  if (tile_n == 64)
    return launch_w8a8_tile<64, kInt8, Out>(x, x_scale, g, sc, blocks, m, k,
                                            splits, ws, counters, s);
  return launch_w8a8_tile<128, kInt8, Out>(x, x_scale, g, sc, blocks, m, k,
                                           splits, ws, counters, s);
}

}  // namespace

// One launch for `count` (1-3) products of x [m, k]: y_p [m, n_p] =
// x w_p, w_p [k, n_p], all row-major; the suffix names x's and w's dtype,
// then y's. m >= 1 (row tiles of 64); every n_p and k multiples of 8. A
// block takes tile_n (64 or 128) output columns of one row tile; K is cut
// into `splits` (1-16, at most ceil(k / 64)) ranges. splits > 1 needs an
// f32 workspace of (sum over p of ceil(n_p / tile_n)) * ceil(m / 64) *
// splits * min(m, 64) * tile_n floats and one int counter per (column
// tile, row tile), zero on entry and left zero. Unused w_p, y_p and n_p
// are ignored.
extern "C" int tk8s_decode_gemm_bf16_bf16(
    const void* x, const void* w0, const void* w1, const void* w2, void* y0,
    void* y1, void* y2, int n0, int n1, int n2, int count, int m, int k,
    int tile_n, int splits, void* workspace, void* counters, void* stream) {
  const void* w[kMaxProblems] = {w0, w1, w2};
  void* y[kMaxProblems] = {y0, y1, y2};
  const int n[kMaxProblems] = {n0, n1, n2};
  return launch<__nv_bfloat16>(x, w, y, n, count, m, k, tile_n, splits,
                               workspace, counters, stream);
}
extern "C" int tk8s_decode_gemm_bf16_f32(
    const void* x, const void* w0, const void* w1, const void* w2, void* y0,
    void* y1, void* y2, int n0, int n1, int n2, int count, int m, int k,
    int tile_n, int splits, void* workspace, void* counters, void* stream) {
  const void* w[kMaxProblems] = {w0, w1, w2};
  void* y[kMaxProblems] = {y0, y1, y2};
  const int n[kMaxProblems] = {n0, n1, n2};
  return launch<float>(x, w, y, n, count, m, k, tile_n, splits, workspace,
                       counters, stream);
}
extern "C" int tk8s_decode_gemm_f32_f32(
    const void* x, const void* w0, const void* w1, const void* w2, void* y0,
    void* y1, void* y2, int n0, int n1, int n2, int count, int m, int k,
    int tile_n, int splits, void* workspace, void* counters, void* stream) {
  const void* w[kMaxProblems] = {w0, w1, w2};
  void* y[kMaxProblems] = {y0, y1, y2};
  const int n[kMaxProblems] = {n0, n1, n2};
  return launch_f32(x, w, y, n, count, m, k, tile_n, splits, workspace,
                    counters, stream);
}

// W8A8: one launch for `count` (1-3) products of xq [m, k] (int8 or
// float8_e4m3fn bytes, row-major) with weights stored K-contiguous,
// w_p [n_p, k], of the same type: y_p [m, n_p] = (float(xq w_p^T) *
// x_scale[m]) * scale_p[n], x_scale [m] and scale_p [n_p] f32; the suffix
// names the operands' type (s8 or e4m3), then y's. k a multiple of 16,
// splits at most ceil(k / 128); otherwise as the entries above, with a
// workspace of as many 4-byte words (int32 for s8, f32 for e4m3).
#define TK8S_W8A8_ENTRY(name, kInt8, Out)                                     \
  extern "C" int name(const void* x, const void* x_scale, const void* w0,    \
                      const void* w1, const void* w2, const void* s0,        \
                      const void* s1, const void* s2, void* y0, void* y1,    \
                      void* y2, int n0, int n1, int n2, int count, int m,    \
                      int k, int tile_n, int splits, void* workspace,        \
                      void* counters, void* stream) {                        \
    const void* w[kMaxProblems] = {w0, w1, w2};                              \
    const void* sc[kMaxProblems] = {s0, s1, s2};                             \
    void* y[kMaxProblems] = {y0, y1, y2};                                    \
    const int n[kMaxProblems] = {n0, n1, n2};                                \
    return launch_w8a8<kInt8, Out>(x, x_scale, w, sc, y, n, count, m, k,     \
                                   tile_n, splits, workspace, counters,      \
                                   stream);                                  \
  }
TK8S_W8A8_ENTRY(tk8s_decode_gemm_s8_bf16, true, __nv_bfloat16)
TK8S_W8A8_ENTRY(tk8s_decode_gemm_s8_f32, true, float)
TK8S_W8A8_ENTRY(tk8s_decode_gemm_e4m3_bf16, false, __nv_bfloat16)
TK8S_W8A8_ENTRY(tk8s_decode_gemm_e4m3_f32, false, float)

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
// What bounds it on this card. At M <= 64 (decode and verify ticks) a
//   product does 2 M FLOPs per weight element read, far below the ~295
//   FLOPs a byte at which the tensor cores and not HBM would limit it, so
//   the bound is the weight bytes over 3.35 TB/s. Reaching it takes bytes
//   in flight on every SM: one block per 64 output columns alone gives 16
//   blocks for wk and 64 for wq or wo on 132 SMs. A prefill window's M
//   256 does 256 FLOPs a weight byte (bf16), at the ridge: there the
//   tensor cores must run near their full rate, which on Hopper only
//   wgmma reaches, and the operands' traffic from the L2 into the SMs
//   (each weight tile once per 128 rows, x once per column block) is what
//   a block's tile shape must keep down.
//
// Design, M <= 64: the grid is (problem, output tile, split) flattened,
//   the splits of a tile adjacent. The caller picks the tile width (64 or
//   128 columns, `_kernels.gemm_tile`) and S, the number of contiguous
//   ranges of whole 64-wide k tiles K is cut into (range s = [s nk / S,
//   (s + 1) nk / S), `_kernels.gemm_splits`), from the group's N and K
//   alone, never from M. A block (four warps) takes all the rows -- up to
//   64 rows of x -- for its column tile and range, so each weight element
//   is read from HBM once per call. A block walks its range in tiles of
//   64 through a ring of
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
//   order, whatever M is, whichever block came last and whichever tile
//   width holds its column; and an mma's row does not see the other rows
//   of its tile, so the number of 16-row tiles instantiated (MT = 1, 2 or
//   4, from M) changes no bit of a row.
//
// Design, M > 64 (wgmma): the grid gains row blocks of 128 rows,
//   innermost, so the blocks that read one weight tile run side by side
//   and share it through the L2. A block is three warpgroups: one copies
//   (the same swizzled 128-byte rows, by cp.async, into a ring as deep
//   as shared memory holds, each stage tracked by a full and an empty
//   mbarrier, its registers handed to the others by setmaxnreg) and two
//   multiply, 64 rows each -- wgmma's M -- reading A (x, K-major) and B
//   (the [k][n] weight tile, MN-major, the trans-b form; [n][k] and
//   K-major for 8-bit types) straight from shared memory through
//   descriptors. Both read each weight stage, so it is fetched once per
//   128 rows. The bits hold because the chains are the M <= 64 kernels':
//   a warpgroup keeps kKw accumulator sets and sends k step q of a stage
//   to set q % kKw, each set starting from zeros and always accumulating
//   as an mma.sync chain does; the sets are added in the order 0, 1, ...,
//   the K ranges are the same S of the shape and merge in the same slabs
//   in the same order, and the epilogue is the same one rounding. That
//   makes a row bitwise its M <= 64 launch's provided one wgmma k step
//   rounds as one mma.sync step does for the same operands and
//   accumulator: the bit probe at the end of this file (gemm_probe_kernel)
//   runs both chains on the same tiles, and chip_smoke.py asserts that
//   they agree before it relies on them. The int8 sum is exact in any
//   order, so its warpgroups keep one set and take two column tiles. The
//   probe found that e4m3 wgmma k steps do not round as mma.sync's, and
//   the tensor cores keep fewer bits than f32 across a chain of fp8
//   products (a W8A8 fp8 model's logits drifted past chip_smoke.py's
//   limit on them), so fp8 runs this kernel at every M (at M <= 64 the
//   second multiplying warpgroup holds no row and only converts): the
//   multiplying warpgroups convert each copied e4m3 tile to f16 (exact)
//   into one of two buffers while the tensor cores multiply the other,
//   and f16 wgmma sums the exact products in f32, in the kKw chains.
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
#include <cuda_fp16.h>
#include <cuda_fp8.h>
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

// The C entries fall into five groups, which ops/_kernels.py (UNITS) builds
// as five translation units in parallel, -DTK8S_UNIT=0..4: the template
// instantiations of each group compile only in its own unit. Without
// TK8S_UNIT one unit holds every entry.
#ifdef TK8S_UNIT
#define TK8S_IN_UNIT(i) (TK8S_UNIT == (i))
#else
#define TK8S_IN_UNIT(i) 1
#endif

namespace {

constexpr int kThreads = 128;  // four warps
constexpr int kBk = 64;        // k a stage: one 128-byte row of bf16
constexpr int kMaxRows = 64;   // rows a block (a row tile)
constexpr int kMaxProblems = 3;
constexpr int kMaxSplits = 16;

// The ring of a BN-column tile: depth, and bytes of one stage (the x
// tile of 16 MT rows of 128 bytes, then 64 w rows of 2 BN bytes).
template <int BN>
__host__ __device__ constexpr int stages() {
  return BN == 64 ? TK8S_GEMM_STAGES_64 : TK8S_GEMM_STAGES_128;
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
// its plain version for any M and S. This kernel takes int8 at M <= 64;
// e4m3 runs the wgmma kernel below at every M (its wgmma k step does not
// round as this kernel's mma.sync step does, so one instruction sequence
// for every M is what keeps an fp8 row the same whatever M is).
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

// ---------------------------------------------------------------------
// M > 64 on wgmma (the header note says why and how).

constexpr int kWg = 128;             // threads a warpgroup
constexpr int kWgRows = 64;          // rows of a warpgroup's product: wgmma's M
constexpr int kWgAtom = 1024;        // eight 128-byte rows: one swizzle atom
constexpr int kWgMaxSmem = 232448;   // dynamic shared memory a block may take
constexpr int kWgMaxStages = 8;      // most stages of its ring

// Descriptor of a 128-byte-swizzled operand at shared address `addr`:
// bits 0-13 addr / 16, 16-29 the leading byte offset / 16 (read only in
// the MN-major form: the stride between 64-column blocks), 32-45 the
// stride byte offset / 16 (1,024: from one eight-row atom to the next),
// 62-63 layout 1 (128-byte swizzle). Operands start 1,024-byte aligned.
__device__ __forceinline__ uint64_t wg_desc(uint32_t addr, uint32_t lead) {
  return (uint64_t)((addr & 0x3FFFFu) >> 4) |
         ((uint64_t)(lead >> 4) << 16) |
         ((uint64_t)(kWgAtom >> 4) << 32) | (1ull << 62);
}
__device__ __forceinline__ void wg_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wg_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
// Wait until at most N committed groups of products are in flight.
template <int N>
__device__ __forceinline__ void wg_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}
// After wg_wait: keeps the compiler from reading an accumulator before
// the wait (it does not know the products write it asynchronously).
template <int R>
__device__ __forceinline__ void wg_landed(float (&d)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+f"(d[i])::"memory");
}
template <int R>
__device__ __forceinline__ void wg_landed(int (&d)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+r"(d[i])::"memory");
}

#define TK8S_GM_D8(C, o)                                                \
  C(d[o]), C(d[o + 1]), C(d[o + 2]), C(d[o + 3]), C(d[o + 4]),          \
      C(d[o + 5]), C(d[o + 6]), C(d[o + 7])
#define TK8S_GM_D32(C, o)                                               \
  TK8S_GM_D8(C, o), TK8S_GM_D8(C, o + 8), TK8S_GM_D8(C, o + 16),        \
      TK8S_GM_D8(C, o + 24)
#define TK8S_GM_D64(C, o) TK8S_GM_D32(C, o), TK8S_GM_D32(C, o + 32)
#define TK8S_GM_D128(C) TK8S_GM_D64(C, 0), TK8S_GM_D64(C, 64)
#define TK8S_GM_P8(a)                                                   \
  "%" #a "0, %" #a "1, %" #a "2, %" #a "3, %" #a "4, %" #a "5, %" #a   \
  "6, %" #a "7, %" #a "8, %" #a "9"
#define TK8S_GM_P30                                                     \
  "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, " TK8S_GM_P8(1) ", "         \
  TK8S_GM_P8(2)
#define TK8S_GM_P32 TK8S_GM_P30 ", %30, %31"
#define TK8S_GM_P64                                                     \
  TK8S_GM_P30 ", " TK8S_GM_P8(3) ", " TK8S_GM_P8(4) ", " TK8S_GM_P8(5)  \
  ", %60, %61, %62, %63"
#define TK8S_GM_P128                                                    \
  TK8S_GM_P30 ", " TK8S_GM_P8(3) ", " TK8S_GM_P8(4) ", " TK8S_GM_P8(5)  \
  ", " TK8S_GM_P8(6) ", " TK8S_GM_P8(7) ", " TK8S_GM_P8(8) ", "         \
  TK8S_GM_P8(9) ", %100, %101, %102, %103, %104, %105, %106, %107, "    \
  "%108, %109, %110, %111, %112, %113, %114, %115, %116, %117, %118, "  \
  "%119, %120, %121, %122, %123, %124, %125, %126, %127"

// d (64 x N) += A B, one k step, both operands from shared memory; the
// accumulator is always added (scale-d 1), so a chain starts from its
// registers' zeros as mma.sync's does. bf16: A (64 x 16) K-major, B
// (16 x N) MN-major (the trans-b form, imm-trans-b 1). s8 and e4m3: A
// (64 x 32) and B (N x 32) both K-major, the only form 8-bit types take.
// d has N / 2 registers: N = 64, 128 or 256.
#define TK8S_GM_MMA(NAME, T, C, R, INSTR, TAIL, DREGS, PLIST, IA, IB, IS) \
  __device__ __forceinline__ void NAME(T (&d)[R], uint64_t da,            \
                                       uint64_t db) {                     \
    asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, %" IS ", 0;\n" INSTR   \
                 " {" PLIST "}, %" IA ", %" IB ", p" TAIL ";\n}\n"         \
                 : DREGS                                                  \
                 : "l"(da), "l"(db), "r"(1));                             \
  }
// The instruction of each operand kind at width N.
#define TK8S_GM_BF16(N)                                                   \
  "wgmma.mma_async.sync.aligned.m64n" #N "k16.f32.bf16.bf16"
#define TK8S_GM_E4M3(N)                                                   \
  "wgmma.mma_async.sync.aligned.m64n" #N "k32.f32.e4m3.e4m3"
#define TK8S_GM_S8(N) "wgmma.mma_async.sync.aligned.m64n" #N "k32.s32.s8.s8"
#define TK8S_GM_F16(N)                                                    \
  "wgmma.mma_async.sync.aligned.m64n" #N "k16.f32.f16.f16"
#define TK8S_GM_R32(C) TK8S_GM_D32(C, 0)
#define TK8S_GM_R64(C) TK8S_GM_D64(C, 0)
#define TK8S_GM_MMAS(NAME, T, C, INSTR, TAIL, N, R, DREGS, PLIST, IA, IB, \
                     IS)                                                  \
  TK8S_GM_MMA(NAME, T, C, R, INSTR(N), TAIL, DREGS(C), PLIST, IA, IB, IS)
// The widths the kernels take: bf16 and f16 (converted e4m3) N = BN (64,
// 128), both operands K-major for f16; s8 N = 2 BN (128, 256); e4m3 and
// s8 at 64 in the probe.
TK8S_GM_MMAS(wg_mma_bf16, float, "+f", TK8S_GM_BF16, ", 1, 1, 0, 1", 64, 32,
             TK8S_GM_R32, TK8S_GM_P32, "32", "33", "34")
TK8S_GM_MMAS(wg_mma_bf16, float, "+f", TK8S_GM_BF16, ", 1, 1, 0, 1", 128,
             64, TK8S_GM_R64, TK8S_GM_P64, "64", "65", "66")
TK8S_GM_MMAS(wg_mma_e4m3, float, "+f", TK8S_GM_E4M3, ", 1, 1", 64, 32,
             TK8S_GM_R32, TK8S_GM_P32, "32", "33", "34")
TK8S_GM_MMAS(wg_mma_f16, float, "+f", TK8S_GM_F16, ", 1, 1, 0, 0", 64, 32,
             TK8S_GM_R32, TK8S_GM_P32, "32", "33", "34")
TK8S_GM_MMAS(wg_mma_f16, float, "+f", TK8S_GM_F16, ", 1, 1, 0, 0", 128, 64,
             TK8S_GM_R64, TK8S_GM_P64, "64", "65", "66")
TK8S_GM_MMAS(wg_mma_s8, int, "+r", TK8S_GM_S8, "", 64, 32, TK8S_GM_R32,
             TK8S_GM_P32, "32", "33", "34")
TK8S_GM_MMAS(wg_mma_s8, int, "+r", TK8S_GM_S8, "", 128, 64, TK8S_GM_R64,
             TK8S_GM_P64, "64", "65", "66")
TK8S_GM_MMAS(wg_mma_s8, int, "+r", TK8S_GM_S8, "", 256, 128, TK8S_GM_D128,
             TK8S_GM_P128, "128", "129", "130")
#undef TK8S_GM_MMAS
#undef TK8S_GM_BF16
#undef TK8S_GM_E4M3
#undef TK8S_GM_S8
#undef TK8S_GM_F16
#undef TK8S_GM_P30
#undef TK8S_GM_MMA
#undef TK8S_GM_R32
#undef TK8S_GM_R64
#undef TK8S_GM_D8
#undef TK8S_GM_D32
#undef TK8S_GM_D64
#undef TK8S_GM_D128
#undef TK8S_GM_P8
#undef TK8S_GM_P32
#undef TK8S_GM_P64
#undef TK8S_GM_P128

// Shared-memory barriers (mbarrier) between the copying warpgroup and
// the multiplying ones: `mbar_arrive_copied` counts this thread once all
// the copies it has issued have landed (.noinc: one of the init count);
// `mbar_wait` spins until the phase of the given parity has completed.
__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(
                   smem_u32(bar)),
               "r"(count));
}
__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(
                   smem_u32(bar))
               : "memory");
}
__device__ __forceinline__ void mbar_arrive_copied(uint64_t* bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];\n" ::
                   "r"(smem_u32(bar))
               : "memory");
}
__device__ __forceinline__ void mbar_wait(uint64_t* bar, int parity) {
  uint32_t done;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(smem_u32(bar)), "r"(parity)
        : "memory");
  } while (!done);
}
// Orders the copies' writes to shared memory (the generic proxy) before
// this thread's later wgmma reads of it (the async proxy).
__device__ __forceinline__ void proxy_fence() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}
// Named barrier `id` (1-15) over `threads` threads.
__device__ __forceinline__ void bar_sync(int id, int threads) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}
// Registers move from the copying warpgroup to the multiplying ones.
template <int N>
__device__ __forceinline__ void regs_release() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(N));
}
template <int N>
__device__ __forceinline__ void regs_take() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(N));
}

// The operand kinds: bf16 (f32 sums, [K, N] weights read MN-major) and
// the W8A8 pair (int32 or f32 sums, [N, K] weights read K-major, the
// scales' epilogue). A stage is one 128-byte row of k of the inputs in
// every case: kSteps wgmma k steps. How each sums (the chains an output
// element is built of):
//   kChained: the M <= 64 kernels' kKw chains, k step q of a stage into
//     set (q / kSub) % kKw (kSub wgmma k steps make one of their mma.sync
//     k steps), each set from zeros, the sets added in order; so a row is
//     bitwise its M <= 64 launch's where the k steps round alike (bf16:
//     the bit probe);
//   kExact: one chain in any order (int8: an exact integer sum);
//   kConvert (e4m3): an e4m3 wgmma k step does not round as mma.sync's
//     does, and the tensor cores keep fewer bits than f32 across its fp8
//     products, so the multiplying warpgroups convert each copied k tile
//     to f16 (exact: every e4m3 value is an f16) into one of two f16
//     buffers while the tensor cores run the other, and f16 wgmma sums
//     the exact products in f32 -- two k16 steps for each of mma.sync's
//     k32 steps, in its chains.
struct WgBf16 {
  using In = __nv_bfloat16;
  using Acc = float;
  static constexpr bool kChained = true, kExact = false, kConvert = false;
  static constexpr bool kScaled = false, kWKMajor = false;
  // Values of k a copied tile, a 16-byte chunk; wgmma k steps over 128
  // bytes of k (for kConvert: over each 64-k half of the f16 tile);
  // wgmma k steps a chain step.
  static constexpr int kKb = kBk, kChunk = 8, kSteps = 4, kSub = 1;
  template <int R>
  static __device__ __forceinline__ void mma(float (&d)[R], uint64_t da,
                                             uint64_t db) {
    wg_mma_bf16(d, da, db);
  }
};
struct WgS8 {
  using In = uint8_t;
  using Acc = int;
  static constexpr bool kChained = false, kExact = true, kConvert = false;
  static constexpr bool kScaled = true, kWKMajor = true;
  static constexpr int kKb = kBk8, kChunk = 16, kSteps = 4, kSub = 1;
  template <int R>
  static __device__ __forceinline__ void mma(int (&d)[R], uint64_t da,
                                             uint64_t db) {
    wg_mma_s8(d, da, db);
  }
};
struct WgE4m3 {
  using In = uint8_t;
  using Acc = float;
  static constexpr bool kChained = true, kExact = false, kConvert = true;
  static constexpr bool kScaled = true, kWKMajor = true;
  static constexpr int kKb = kBk8, kChunk = 16, kSteps = 4, kSub = 2;
  template <int R>
  static __device__ __forceinline__ void mma(float (&d)[R], uint64_t da,
                                             uint64_t db) {
    wg_mma_f16(d, da, db);
  }
};
// e4m3 operands straight into an e4m3 wgmma: the bit probe's only.
struct WgE4m3Direct : WgE4m3 {
  static constexpr bool kConvert = false;
  static constexpr int kSub = 1;
  template <int R>
  static __device__ __forceinline__ void mma(float (&d)[R], uint64_t da,
                                             uint64_t db) {
    wg_mma_e4m3(d, da, db);
  }
};

template <bool kInt8> struct W8A8Of { using T = WgS8; };
template <> struct W8A8Of<false> { using T = WgE4m3; };
template <bool kInt8> using W8A8Op = typename W8A8Of<kInt8>::T;

// A block's shape: kCons multiplying warpgroups of 64 rows each over
// kCols = kTiles BN-wide tiles, one copying warpgroup, and a ring of
// copied k tiles as deep as shared memory holds (beside, for kConvert,
// two f16 buffers of a tile each: its k 64 h .. 64 h + 63 as half h, in
// a copied tile's layout). Chained sums keep kSets accumulator sets (the
// M <= 64 kernels' kKw); the exact one one set over two tiles.
template <class Op, int BN, int kCons>
struct WgPlan {
  static constexpr int kSets = Op::kChained ? 4 * 64 / BN : 1;
  static constexpr int kTiles = Op::kExact ? 2 : 1;
  static constexpr int kCols = kTiles * BN;
  static constexpr int kRegs = kCols / 2;  // accumulator registers a set
  static constexpr int kXBytes = kCons * kWgRows * 128;
  static constexpr int kCopyBytes = kXBytes + kCols * 128;  // one k tile
  static constexpr int kStageBytes = kCopyBytes;
  static constexpr int kF16Bytes = Op::kConvert ? 4 * kCopyBytes : 0;
  static constexpr int kFit =
      (kWgMaxSmem - 2 * kWgAtom - kF16Bytes) / kStageBytes;
  static constexpr int kStages = kFit < kWgMaxStages ? kFit : kWgMaxStages;
  static constexpr int kThreads = (kCons + 1) * kWg;
  // Room to align the rings, the rings, full and empty barriers, the flag.
  static constexpr int kSmem = kWgAtom + kStages * kStageBytes +
                               kF16Bytes + 2 * kStages * 8 + 16;
  static_assert(kSets * kRegs <= 128, "accumulators a thread");
  static_assert(kStages >= 2 && kSmem <= kWgMaxSmem, "shared memory");
};

// The copies of k tile kt into one stage, by copying thread t: x rows
// 0 .. 64 kCons - 1 of the block (zero at or past mb), K-major, 128
// bytes of k a row; then the weight tile: bf16 [K, N] as kCols / 64
// column blocks of 64 k rows (MN-major), 8-bit [N, K] as kCols rows of
// 128 bytes of k (K-major); zero past n and k. Each 128-byte row is
// swizzled as every other tile of this file (chunk c of row r at c ^ r %
// 8), which is the 128-byte swizzle wgmma reads.
template <class Op, int kCons, int kCols>
__device__ __forceinline__ void load_wg_stage(unsigned char* stage,
                                              const typename Op::In* x,
                                              const typename Op::In* w,
                                              int mb, int n, int k, int n0,
                                              int kt, int t) {
  using In = typename Op::In;
  constexpr int e = Op::kChunk;
  const int k0 = kt * Op::kKb, c = t % 8, r0 = t / 8;
  const bool k_live = k0 + e * c < k;
  // A thread keeps its chunk c and takes every 16th row (every rows-th k
  // row of a bf16 weight), so its swizzle term is fixed and the source
  // and destination advance by constants.
  const size_t step = (size_t)16 * k;
  const In* src = x + (size_t)r0 * k + k0 + e * c;
  unsigned char* dst = stage + swz(r0, c);
#pragma unroll
  for (int p = 0; p < kCons * kWgRows / 16; ++p) {
    const bool live = r0 + 16 * p < mb && k_live;
    cp_async16_zfill(dst + p * 16 * 128, live ? src : x, live);
    src += step;
  }
  unsigned char* wst = stage + kCons * kWgRows * 128;
  if constexpr (Op::kWKMajor) {
    src = w + (size_t)(n0 + r0) * k + k0 + e * c;
    dst = wst + swz(r0, c);
#pragma unroll
    for (int p = 0; p < kCols / 16; ++p) {
      const bool live = k_live && n0 + r0 + 16 * p < n;
      cp_async16_zfill(dst + p * 16 * 128, live ? src : w, live);
      src += step;
    }
  } else {
    constexpr int chunks = kCols / 8, rows = kWg / chunks;
    const int cc = t % chunks, kr0 = t / chunks;
    const bool n_live = n0 + 8 * cc < n;
    const size_t wstep = (size_t)rows * n;
    src = w + (size_t)(k0 + kr0) * n + n0 + 8 * cc;
    dst = wst + (cc / 8) * (kWgRows * 128) + swz(kr0, cc % 8);
#pragma unroll
    for (int p = 0; p < kBk / rows; ++p) {
      const bool live = n_live && k0 + kr0 + rows * p < k;
      cp_async16_zfill(dst + p * rows * 128, live ? src : w, live);
      src += wstep;
    }
  }
}

// 16 e4m3 values (one 16-byte chunk) as 16 f16 (two chunks), exactly.
__device__ __forceinline__ void e4m3x16_to_f16(uint4 v, uint4& lo,
                                               uint4& hi) {
  const uint32_t in[4] = {v.x, v.y, v.z, v.w};
  uint32_t out[8];
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const __half2_raw h = __nv_cvt_fp8x2_to_halfraw2(
        (__nv_fp8x2_storage_t)(in[i / 2] >> (16 * (i % 2))), __NV_E4M3);
    out[i] = (uint32_t)h.x | ((uint32_t)h.y << 16);
  }
  lo = make_uint4(out[0], out[1], out[2], out[3]);
  hi = make_uint4(out[4], out[5], out[6], out[7]);
}

// A copied e4m3 tile converted to f16 by the kThreads multiplying
// threads, thread t taking chunk c = t % 8 (k 16 c .. 16 c + 15) of rows
// t / 8 + (kThreads / 8) p: into half c / 4 of the f16 buffer, as chunks
// 2 (c % 4) and 2 (c % 4) + 1 of the same row, swizzled (each half is a
// copied tile's layout). x rows at or past mb are left as they are
// (their products are never stored).
template <int kCons, int kCols, int kCopyBytes>
__device__ __forceinline__ void convert_wg_stage(const unsigned char* raw,
                                                 unsigned char* f16, int mb,
                                                 int t) {
  constexpr int kThreads = kCons * kWg, kPass = kThreads / 8;
  constexpr int kRows = kCons * kWgRows + kCols;  // x rows, then w rows
  // x rows first, then the weight rows after kCons * 64 x rows, each
  // swizzled by its row index (the parts start a multiple of 8 apart);
  // a thread's rows are kPass apart, so its swizzle terms are fixed.
  const int c = t % 8, r0 = t / 8, sw = r0 & 7;
  const unsigned char* src = raw + r0 * 128 + ((c ^ sw) << 4);
  unsigned char* half = f16 + (c / 4) * kCopyBytes + r0 * 128;
  unsigned char* lo_at = half + (((2 * (c % 4)) ^ sw) << 4);
  unsigned char* hi_at = half + (((2 * (c % 4) + 1) ^ sw) << 4);
#pragma unroll
  for (int p = 0; p < kRows / kPass; ++p) {
    const int r = r0 + kPass * p;
    if (r < kCons * kWgRows && r >= mb) continue;
    uint4 lo, hi;
    e4m3x16_to_f16(
        *reinterpret_cast<const uint4*>(src + p * kPass * 128), lo, hi);
    *reinterpret_cast<uint4*>(lo_at + p * kPass * 128) = lo;
    *reinterpret_cast<uint4*>(hi_at + p * kPass * 128) = hi;
  }
}

// One output pair, (y[row][col], y[row][col + 1]), rounded once: bf16
// stores its f32 sums, W8A8 applies the scales first.
template <class Op, typename Out, typename Acc>
__device__ __forceinline__ void wg_emit(Out* y, Acc a, Acc b,
                                        const float* x_scale,
                                        const float* w_scale, int row,
                                        int col) {
  if constexpr (Op::kScaled) {
    typename Acc8<Op::kExact>::V v;
    v.x = a;
    v.y = b;
    store_scaled<Out>(y, v, x_scale[row], w_scale + col);
  } else {
    store2<Out>(y, a, b);
  }
}

template <class Op, int BN, int kCons, typename Out>
__device__ __forceinline__ void wgmma_gemm(
    const typename Op::In* __restrict__ x, const float* __restrict__ x_scale,
    const Group<typename Op::In, Out>& g, const Scales& sc, int m, int k,
    int splits, void* __restrict__ ws, int* __restrict__ counters) {
  using P = WgPlan<Op, BN, kCons>;
  using In = typename Op::In;
  using Acc = typename Op::Acc;
  using V = typename Acc8<Op::kExact>::V;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  unsigned char* ring =
      smem_raw + (kWgAtom - smem_u32(smem_raw) % kWgAtom) % kWgAtom;
  unsigned char* f16 = ring + P::kStages * P::kStageBytes;  // kConvert
  uint64_t* full = reinterpret_cast<uint64_t*>(f16 + P::kF16Bytes);
  uint64_t* empty = full + P::kStages;
  int* flag = reinterpret_cast<int*>(empty + P::kStages);

  // The grid: (kTiles-tile column block, split, row block of 64 kCons
  // rows), row blocks innermost, so the blocks that read one weight tile
  // run side by side and share it through the L2.
  const int row_blocks = (m + kCons * kWgRows - 1) / (kCons * kWgRows);
  const int rb = blockIdx.x % row_blocks;
  const int split = blockIdx.x / row_blocks % splits;
  const int cb = blockIdx.x / row_blocks / splits;
  // The block's problem p, and its first BN-wide tile, counted through
  // the group (a column block does not straddle two problems).
  int p = 0, t_begin = 0, c_begin = 0;
#pragma unroll
  for (int q = 0; q < kMaxProblems - 1; ++q) {
    const int cq = (g.tile_end[q] - t_begin + P::kTiles - 1) / P::kTiles;
    if (p == q && cb >= c_begin + cq) {
      p = q + 1;
      c_begin += cq;
      t_begin = g.tile_end[q];
    }
  }
  const In* w = p == 0 ? g.w[0] : p == 1 ? g.w[1] : g.w[2];
  Out* const y = p == 0 ? g.y[0] : p == 1 ? g.y[1] : g.y[2];
  const int n = p == 0 ? g.n[0] : p == 1 ? g.n[1] : g.n[2];
  const float* w_scale = p == 0 ? sc.s[0] : p == 1 ? sc.s[1] : sc.s[2];
  const int tile0 = t_begin + P::kTiles * (cb - c_begin);
  const int n0 = (tile0 - t_begin) * BN;
  const int row0 = rb * kCons * kWgRows;
  const int nk = (k + Op::kKb - 1) / Op::kKb;
  const int kt0 = range_start(split, nk, splits);
  const int len = range_start(split + 1, nk, splits) - kt0;
  const int wg = threadIdx.x / kWg;

  if (threadIdx.x == 0) {
    for (int s = 0; s < P::kStages; ++s) {
      mbar_init(full + s, kWg);          // the copying threads
      mbar_init(empty + s, kCons * 4);   // a warp of each multiplying one
    }
  }
  __syncthreads();

  if (wg == kCons) {
    // ---- the copying warpgroup: keeps the ring full, nothing else.
    if constexpr (kCons > 1) regs_release<56>();
    const int t = threadIdx.x - kCons * kWg;
    const In* xb = x + (size_t)row0 * k;
    const int mb = min(kCons * kWgRows, m - row0);
    for (int it = 0; it < len; ++it) {
      const int s = it % P::kStages;
      if (it >= P::kStages) mbar_wait(empty + s, (it / P::kStages - 1) & 1);
      load_wg_stage<Op, kCons, P::kCols>(ring + s * P::kStageBytes, xb, w,
                                         mb, n, k, n0, kt0 + it, t);
      mbar_arrive_copied(full + s);
    }
    cp_async_wait<0>();
    return;
  }

  // ---- the multiplying warpgroups, 64 rows each.
  if constexpr (kCons > 1) regs_take<224>();
  const int t = threadIdx.x % kWg, lane = t % 32;
  const int crow0 = row0 + wg * kWgRows;  // this warpgroup's first row
  const bool live = crow0 < m;            // false: every row past M
  Acc acc[P::kSets][P::kRegs];
#pragma unroll
  for (int q = 0; q < P::kSets; ++q)
#pragma unroll
    for (int i = 0; i < P::kRegs; ++i) acc[q][i] = 0;
  const auto ring_addr = smem_u32(ring);
  if constexpr (Op::kConvert) {
    // Copied tile j is converted into f16 buffer j % 2 by all the
    // multiplying threads, then its copy given back; tile j + 1's
    // conversion runs while the tensor cores multiply tile j.
    const int mb = min(kCons * kWgRows, m - row0);
    auto take = [&](int j) {
      const int s = j % P::kStages;
      mbar_wait(full + s, (j / P::kStages) & 1);
      convert_wg_stage<kCons, P::kCols, P::kCopyBytes>(
          ring + s * P::kStageBytes, f16 + (j % 2) * 2 * P::kCopyBytes, mb,
          threadIdx.x);
      proxy_fence();  // these stores, before wgmma reads them
      __syncwarp();
      if (lane == 0) mbar_arrive(empty + s);
      bar_sync(1, kCons * kWg);  // the whole buffer, before its products
    };
    take(0);
    for (int tile = 0; tile < len; ++tile) {
      if (live) {
        wg_fence();
        const auto buf = smem_u32(f16) + (tile % 2) * 2 * P::kCopyBytes;
#pragma unroll
        for (int h = 0; h < 2; ++h)
#pragma unroll
          for (int q = 0; q < Op::kSteps; ++q) {
            const auto half = buf + h * P::kCopyBytes;
            Op::mma(acc[(h * Op::kSteps + q) / Op::kSub % P::kSets],
                    wg_desc(half + wg * (kWgRows * 128) + 32 * q, 16),
                    wg_desc(half + P::kXBytes + 32 * q, 16));
          }
        wg_commit();
      }
      if (tile + 1 < len) {
        // The other buffer is free once every warpgroup's products of
        // tile - 1 are done (at most this tile's in flight).
        if (live) wg_wait<1>();
        bar_sync(1, kCons * kWg);
        take(tile + 1);
      }
    }
  } else {
    for (int it = 0; it < len; ++it) {
      const int s = it % P::kStages;
      mbar_wait(full + s, (it / P::kStages) & 1);
      if (live) {
        proxy_fence();
        wg_fence();
        const auto st = ring_addr + s * P::kStageBytes;
#pragma unroll
        for (int q = 0; q < Op::kSteps; ++q) {
          // Step q reads 32 bytes of k at 32 q of the stage's 128-byte
          // rows (bf16 B: 16 k rows at 16 q).
          const uint64_t da =
              wg_desc(st + wg * (kWgRows * 128) + 32 * q, 16);
          const uint64_t db =
              Op::kWKMajor ? wg_desc(st + P::kXBytes + 32 * q, 16)
                           : wg_desc(st + P::kXBytes + q * 16 * 128,
                                     kWgRows * 128);
          Op::mma(acc[q / Op::kSub % P::kSets], da, db);
        }
        wg_commit();
        wg_wait<1>();
      }
      // At most this stage's products are in flight: the last stage's
      // have read their operands, so one lane a warp gives that stage
      // back, once every lane of the warp is past this stage's wait (a
      // lane left behind could otherwise miss a whole phase).
      __syncwarp();
      if (it > 0 && lane == 0) mbar_arrive(empty + (it - 1) % P::kStages);
    }
  }
  wg_wait<0>();
#pragma unroll
  for (int q = 0; q < P::kSets; ++q) wg_landed(acc[q]);
  // The chains added in the order q = 0, 1, ...
#pragma unroll
  for (int q = 1; q < P::kSets; ++q)
#pragma unroll
    for (int i = 0; i < P::kRegs; ++i) acc[0][i] = acc[0][i] + acc[q][i];

  // Accumulator register i holds row 16 (warp) + lane / 4 + 8 ((i / 2) %
  // 2) of the warpgroup's 64 and column 8 (i / 4) + 2 (lane % 4) + i % 2.
  const int r_lo = crow0 + 16 * (t / 32) + lane / 4;
  const int c_lo = n0 + 2 * (lane % 4);
  if (splits == 1) {
    if (!live) return;
#pragma unroll
    for (int i = 0; i < P::kRegs; i += 2) {
      const int row = r_lo + 8 * ((i / 2) % 2), col = c_lo + 8 * (i / 4);
      if (row < m && col < n)
        wg_emit<Op, Out>(y + (size_t)row * n + col, acc[0][i], acc[0][i + 1],
                         x_scale, w_scale, row, col);
    }
    return;
  }
  // K split: this block's partial into the slab of each (BN-wide tile,
  // 64-row tile) it covers -- [splits][min(M, 64)][BN], as the M <= 64
  // kernels lay it out -- and the last of the S blocks adds them in the
  // order s = 0, 1, ..., S - 1.
  const int rows = min(m, kWgRows), rows64 = (m + kWgRows - 1) / kWgRows;
  Acc* const slabs = reinterpret_cast<Acc*>(ws);
  auto slab_of = [&](int row, int col) {
    const int tile = tile0 + (col - n0) / BN;
    return slabs + ((size_t)(tile * rows64 + row / kWgRows) * splits *
                        rows + row % kWgRows) * BN + (col - n0) % BN;
  };
  if (live) {
#pragma unroll
    for (int i = 0; i < P::kRegs; i += 2) {
      const int row = r_lo + 8 * ((i / 2) % 2), col = c_lo + 8 * (i / 4);
      if (row < m && col < n) {
        V v;
        v.x = acc[0][i];
        v.y = acc[0][i + 1];
        *reinterpret_cast<V*>(slab_of(row, col) + (size_t)split * rows * BN) =
            v;
      }
    }
  }
  __threadfence();
  bar_sync(1, kCons * kWg);
  const int slot0 = tile0 * rows64 + rb * kCons;
  if (threadIdx.x == 0) *flag = atomicAdd(counters + slot0, 1) == splits - 1;
  bar_sync(1, kCons * kWg);
  if (!*flag || !live) return;
  __threadfence();
  if (threadIdx.x == 0) counters[slot0] = 0;
#pragma unroll
  for (int i = 0; i < P::kRegs; i += 2) {
    const int row = r_lo + 8 * ((i / 2) % 2), col = c_lo + 8 * (i / 4);
    if (row >= m || col >= n) continue;
    const Acc* slab = slab_of(row, col);
    V own;
    own.x = acc[0][i];
    own.y = acc[0][i + 1];
    V sum = split == 0 ? own : __ldcg(reinterpret_cast<const V*>(slab));
    for (int s = 1; s < splits; ++s)
      sum = add2(sum, s == split ? own
                                 : __ldcg(reinterpret_cast<const V*>(
                                       slab + (size_t)s * rows * BN)));
    wg_emit<Op, Out>(y + (size_t)row * n + col, sum.x, sum.y, x_scale,
                     w_scale, row, col);
  }
}

template <int BN, int kCons, typename Out>
__global__ void __launch_bounds__((kCons + 1) * kWg, 1)
decode_gemm_wgmma_kernel(const __nv_bfloat16* __restrict__ x,
                         Group<__nv_bfloat16, Out> g, int m, int k,
                         int splits, float* __restrict__ ws,
                         int* __restrict__ counters) {
  wgmma_gemm<WgBf16, BN, kCons, Out>(x, nullptr, g, Scales{}, m, k, splits,
                                     ws, counters);
}

template <int BN, int kCons, bool kInt8, typename Out>
__global__ void __launch_bounds__((kCons + 1) * kWg, 1)
decode_gemm_w8a8_wgmma_kernel(const uint8_t* __restrict__ x,
                              const float* __restrict__ x_scale,
                              Group<uint8_t, Out> g, Scales sc, int m, int k,
                              int splits, void* __restrict__ ws,
                              int* __restrict__ counters) {
  wgmma_gemm<W8A8Op<kInt8>, BN, kCons, Out>(x, x_scale, g, sc, m, k, splits,
                                            ws, counters);
}

// ---------------------------------------------------------------------
// The bit probe: do a chain of wgmma k steps and a chain of mma.sync
// steps give the same bits for the same operands and accumulator? One
// warpgroup multiplies A [64][K] (row-major) by B -- bf16 [K][64], the
// weight layout read MN-major; 8-bit [64][K], read K-major -- from the
// same swizzled shared tiles both ways, each starting from C [64][64]
// (f32, int32 for s8), in `steps` k steps (1-8; K = 16 steps for bf16,
// 32 for 8-bit): mma.sync as the M <= 64 kernels issue it (ldmatrix
// fragments, warp w on rows 16 w .. 16 w + 15, m16n8k16 or m16n8k32) and
// wgmma as the M > 64 kernel does (m64n64, descriptors). Both results
// are written out, row-major, for the caller to compare.
template <class Op>
__global__ void __launch_bounds__(kWg)
gemm_probe_kernel(const typename Op::In* __restrict__ a,
                  const typename Op::In* __restrict__ b,
                  const typename Op::Acc* __restrict__ c,
                  typename Op::Acc* __restrict__ d_mma,
                  typename Op::Acc* __restrict__ d_wg, int steps) {
  using Acc = typename Op::Acc;
  constexpr int kTile = kWgRows * 256;  // [64][256 bytes] as two blocks
  extern __shared__ __align__(16) unsigned char smem_raw[];
  unsigned char* at =
      smem_raw + (kWgAtom - smem_u32(smem_raw) % kWgAtom) % kWgAtom;
  unsigned char* bt = at + kTile;
  const int t = threadIdx.x, lane = t % 32, warp = t / 32;
  const int kbytes = steps * 32;  // bytes of k: 32 a step either way
  // A, and 8-bit B, as [64 rows][kbytes] in 128-byte column blocks; bf16
  // B as [16 steps rows][64 columns] of 128-byte rows.
  for (int i = t; i < kWgRows * 16; i += kWg) {
    const int r = i / 16, ch = i % 16;
    if (ch * 16 >= kbytes) continue;
    *reinterpret_cast<uint4*>(at + (ch / 8) * (kWgRows * 128) +
                              swz(r, ch % 8)) =
        *reinterpret_cast<const uint4*>(
            reinterpret_cast<const unsigned char*>(a) + r * kbytes + 16 * ch);
    if (Op::kWKMajor)
      *reinterpret_cast<uint4*>(bt + (ch / 8) * (kWgRows * 128) +
                                swz(r, ch % 8)) =
          *reinterpret_cast<const uint4*>(
              reinterpret_cast<const unsigned char*>(b) + r * kbytes +
              16 * ch);
  }
  if (!Op::kWKMajor)
    for (int i = t; i < 16 * steps * 8; i += kWg) {
      const int r = i / 8, ch = i % 8;
      *reinterpret_cast<uint4*>(bt + swz(r, ch)) =
          *reinterpret_cast<const uint4*>(
              reinterpret_cast<const unsigned char*>(b) + r * 128 + 16 * ch);
    }
  proxy_fence();  // this thread's stores, before wgmma reads them
  __syncthreads();

  // mma.sync: element e of n8 tile nj is row 16 warp + lane / 4 + 8 (e /
  // 2), column 8 nj + 2 (lane % 4) + e % 2 -- wgmma's register 4 nj + e.
  const int gr = 16 * warp + lane / 4, gc = 2 * (lane % 4);
  Acc cm[8][4], cw[32];
#pragma unroll
  for (int nj = 0; nj < 8; ++nj)
#pragma unroll
    for (int e = 0; e < 4; ++e)
      cw[4 * nj + e] = cm[nj][e] =
          c[(gr + 8 * (e / 2)) * kWgRows + 8 * nj + gc + e % 2];
  const int lr = (lane % 8) + 8 * ((lane / 8) % 2), lc = lane / 16;
  const int br = (lane % 8) + 8 * (lane / 16), bc = (lane / 8) % 2;
  for (int kk = 0; kk < steps; ++kk) {
    const unsigned char* ab = at + (kk / 4) * (kWgRows * 128);
    uint32_t af[4], bf[4][4];
    ldmatrix_x4(af, smem_u32(ab + swz(16 * warp + lr, 2 * (kk % 4) + lc)));
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      if constexpr (Op::kWKMajor)
        ldmatrix_x4(bf[q], smem_u32(bt + (kk / 4) * (kWgRows * 128) +
                                    swz(16 * q + br, 2 * (kk % 4) + bc)));
      else
        ldmatrix_x4_trans(bf[q], smem_u32(bt + swz(16 * kk + lr,
                                                   2 * q + lc)));
    }
#pragma unroll
    for (int nj = 0; nj < 8; ++nj) {
      if constexpr (Op::kWKMajor)
        mma16832(cm[nj], af, bf[nj / 2][2 * (nj % 2)],
                 bf[nj / 2][2 * (nj % 2) + 1]);
      else
        mma16816(cm[nj], af, bf[nj / 2][2 * (nj % 2)],
                 bf[nj / 2][2 * (nj % 2) + 1]);
    }
  }
  unsigned char* a16 = bt + kTile;  // kConvert: A and B as f16, [64][K]
  unsigned char* b16 = a16 + 2 * kTile;
  if constexpr (Op::kConvert) {
    for (int i = t; i < 2 * kWgRows * 16; i += kWg) {
      const int r = i / 16 % kWgRows, ch = i % 16;
      if (ch * 16 >= kbytes) continue;
      const unsigned char* src = i < kWgRows * 16 ? at : bt;
      unsigned char* dst = (i < kWgRows * 16 ? a16 : b16) +
                           (ch / 4) * (kWgRows * 128);
      uint4 lo, hi;
      e4m3x16_to_f16(*reinterpret_cast<const uint4*>(
                         src + (ch / 8) * (kWgRows * 128) + swz(r, ch % 8)),
                     lo, hi);
      *reinterpret_cast<uint4*>(dst + swz(r, 2 * (ch % 4))) = lo;
      *reinterpret_cast<uint4*>(dst + swz(r, 2 * (ch % 4) + 1)) = hi;
    }
    proxy_fence();
    __syncthreads();
  }
  const auto aa = smem_u32(Op::kConvert ? a16 : at);
  const auto ba = smem_u32(Op::kConvert ? b16 : bt);
  wg_fence();
  // Op::kSub wgmma k steps of 32 bytes (16 f16 values) make one of
  // mma.sync's k32 steps when the operands were converted to f16.
  for (int kk = 0; kk < steps * Op::kSub; ++kk) {
    const uint64_t da =
        wg_desc(aa + (kk / 4) * (kWgRows * 128) + 32 * (kk % 4), 16);
    const uint64_t db =
        Op::kWKMajor
            ? wg_desc(ba + (kk / 4) * (kWgRows * 128) + 32 * (kk % 4), 16)
            : wg_desc(ba + kk * 16 * 128, kWgRows * 128);
    Op::mma(cw, da, db);
  }
  wg_commit();
  wg_wait<0>();
  wg_landed(cw);
#pragma unroll
  for (int nj = 0; nj < 8; ++nj)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int at_ = (gr + 8 * (e / 2)) * kWgRows + 8 * nj + gc + e % 2;
      d_mma[at_] = cm[nj][e];
      d_wg[at_] = cw[4 * nj + e];
    }
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

// Blocks of a wgmma launch: the group's column blocks of P::kTiles tiles
// (none straddles two problems), its K ranges, its row blocks.
template <class P, typename W, typename Out>
int wg_blocks(const Group<W, Out>& g, int m, int splits, int cons) {
  int blocks = 0, t = 0;
  for (int p = 0; p < kMaxProblems; ++p) {
    blocks += (g.tile_end[p] - t + P::kTiles - 1) / P::kTiles;
    t = g.tile_end[p];
  }
  return blocks * splits * ((m + cons * kWgRows - 1) / (cons * kWgRows));
}

template <int BN, int kCons, typename Out>
int launch_wg_bf16(const void* x, const Group<__nv_bfloat16, Out>& g,
                   int m, int k, int splits, void* ws, void* counters,
                   cudaStream_t stream) {
  using P = WgPlan<WgBf16, BN, kCons>;
  const int blocks = wg_blocks<P>(g, m, splits, kCons);
  cudaError_t e = cudaFuncSetAttribute(
      decode_gemm_wgmma_kernel<BN, kCons, Out>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, P::kSmem);
  if (e != cudaSuccess) return (int)e;
  decode_gemm_wgmma_kernel<BN, kCons, Out><<<blocks, P::kThreads, P::kSmem,
                                             stream>>>(
      (const __nv_bfloat16*)x, g, m, k, splits, (float*)ws, (int*)counters);
  return (int)cudaGetLastError();
}

template <int BN, int kCons, bool kInt8, typename Out>
int launch_wg_w8a8(const void* x, const void* x_scale,
                   const Group<uint8_t, Out>& g, const Scales& sc, int m,
                   int k, int splits, void* ws, void* counters,
                   cudaStream_t stream) {
  using P = WgPlan<W8A8Op<kInt8>, BN, kCons>;
  const int blocks = wg_blocks<P>(g, m, splits, kCons);
  cudaError_t e = cudaFuncSetAttribute(
      decode_gemm_w8a8_wgmma_kernel<BN, kCons, kInt8, Out>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, P::kSmem);
  if (e != cudaSuccess) return (int)e;
  decode_gemm_w8a8_wgmma_kernel<BN, kCons, kInt8, Out><<<
      blocks, P::kThreads, P::kSmem, stream>>>(
      (const uint8_t*)x, (const float*)x_scale, g, sc, m, k, splits, ws,
      (int*)counters);
  return (int)cudaGetLastError();
}

template <class Op>
int launch_probe(const void* a, const void* b, const void* c, void* d_mma,
                 void* d_wg, int steps, void* stream) {
  if (steps < 1 || steps > 8 || a == nullptr || b == nullptr ||
      c == nullptr || d_mma == nullptr || d_wg == nullptr)
    return (int)cudaErrorInvalidValue;
  // A and B, then (kConvert) both again as f16.
  constexpr int smem = kWgAtom + 6 * kWgRows * 256;
  cudaError_t e = cudaFuncSetAttribute(
      gemm_probe_kernel<Op>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (e != cudaSuccess) return (int)e;
  gemm_probe_kernel<Op><<<1, kWg, smem, (cudaStream_t)stream>>>(
      (const typename Op::In*)a, (const typename Op::In*)b,
      (const typename Op::Acc*)c, (typename Op::Acc*)d_mma,
      (typename Op::Acc*)d_wg, steps);
  return (int)cudaGetLastError();
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
  return launch_wg_bf16<BN, 2, Out>(x, g, m, k, splits, ws, counters, s);
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

#if TK8S_IN_UNIT(1)
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
#endif

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
  if constexpr (!kInt8) {  // e4m3: every M on wgmma (the note above)
    return launch_wg_w8a8<BN, 2, false, Out>(x, x_scale, g, sc, m, k, splits,
                                             ws, counters, s);
  } else {
    constexpr int kRing = stages<BN>();
    if (m <= 16)
      return launch_w8a8_rows<1, BN, kRing, true, Out>(
          x, x_scale, g, sc, blocks, m, k, splits, ws, counters, s);
    if (m <= 32)
      return launch_w8a8_rows<2, BN, kRing, true, Out>(
          x, x_scale, g, sc, blocks, m, k, splits, ws, counters, s);
    if (m <= kMaxRows)
      return launch_w8a8_rows<4, BN, kRing, true, Out>(
          x, x_scale, g, sc, blocks, m, k, splits, ws, counters, s);
    return launch_wg_w8a8<BN, 2, true, Out>(x, x_scale, g, sc, m, k, splits,
                                            ws, counters, s);
  }
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
#if TK8S_IN_UNIT(0)
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
#endif
#if TK8S_IN_UNIT(1)
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
#endif

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
#if TK8S_IN_UNIT(2)
TK8S_W8A8_ENTRY(tk8s_decode_gemm_s8_bf16, true, __nv_bfloat16)
TK8S_W8A8_ENTRY(tk8s_decode_gemm_s8_f32, true, float)
#endif
#if TK8S_IN_UNIT(3)
TK8S_W8A8_ENTRY(tk8s_decode_gemm_e4m3_bf16, false, __nv_bfloat16)
TK8S_W8A8_ENTRY(tk8s_decode_gemm_e4m3_f32, false, float)
#endif

// The bit probe (gemm_probe_kernel): a [64, 16 steps] (bf16) or [64, 32
// steps] (s8, e4m3) row-major; b [16 steps, 64] (bf16) or [64, 32 steps]
// (8-bit); c, d_mma and d_wg [64, 64] f32 (int32 for s8). steps 1-8.
#define TK8S_PROBE_ENTRY(name, Op)                                         \
  extern "C" int name(const void* a, const void* b, const void* c,         \
                      void* d_mma, void* d_wg, int steps, void* stream) {  \
    return launch_probe<Op>(a, b, c, d_mma, d_wg, steps, stream);          \
  }
#if TK8S_IN_UNIT(4)
TK8S_PROBE_ENTRY(tk8s_gemm_probe_bf16, WgBf16)
TK8S_PROBE_ENTRY(tk8s_gemm_probe_s8, WgS8)
TK8S_PROBE_ENTRY(tk8s_gemm_probe_e4m3, WgE4m3Direct)
TK8S_PROBE_ENTRY(tk8s_gemm_probe_e4m3_f16, WgE4m3)
#endif

// Chunked-prefill paged attention for Hopper (sm_90a).
//
// Replaces: the TPU kernel `_prefill_chunk_kernel`
//   (triton_kubernetes_tpu/ops/paged_attention.py:633, launched by
//   `_paged_prefill_attention_pallas` at :693, pallas_call :743),
//   unquantized and quantized (int8/fp8 pages with per-(page, head)
//   scales, :665-666 and :677-682).
//
// Computes: the C queries of one prefill window, at absolute positions
//   offset .. offset+C-1, attend causally by position to the sequence's
//   pages, the window's own K/V included (it is scattered in first).
//   q [1, C, Hq, D], pages [N, Hkv, bs, D] (one layer's slice of the pool;
//   q's dtype, or int8/fp8 with f32 scales [N, Hkv]), block_table [T]
//   int32. Query row r of KV head h is (token r / group, head h*group +
//   r % group), as the TPU kernel folds them (`_fold_heads`, :618); a key
//   is kept when k_pos <= q_pos.
//
// What bounds it on this card: operations. A row does 4*D FLOPs per key it
//   sees, and at C 256, group 4 every K/V byte feeds 1,024 query rows --
//   far above the ~295 FLOPs a byte where an H100 stops being bound by
//   memory. So the products belong on the tensor cores; but one window is
//   small (0.7-5 GFLOP at offsets 0-1,024), so the launch, the causal
//   imbalance between row tiles and the latency of each staged tile set
//   the time more than the peak rate does.
//
// Two designs, picked per call by ops/_kernels.py PAGED_TENSOR_CORE (the
//   `variant` argument, the table the decode and verify kernels read; an
//   entry refuses a design it is not built for):
// - tensor_core (bf16 queries at D 64/128, bs 16/32, on bf16, int8 and
//   fp8 pages): paged_prefill_mma_kernel below. One block of four warps
//   per (KV head, tile of 64 query rows); warp w owns rows 16w .. 16w+15
//   of the tile (4 tokens x a group of 4), so K and V are staged once for
//   every query head of the KV head. The grid puts the last row tiles --
//   the longest causal walks -- first. The block walks its keys in stages
//   of 64 fixed by absolute position (keys 64s .. 64s+63) through a ring
//   of three: page rows come from the block table by 16-byte cp.async
//   into rows padded by 16 bytes (ldmatrix is free of bank conflicts), and
//   the copies of stage s+2 are in flight while stage s is computed. It
//   stops at the last page its last row can see, and a warp skips a page
//   that is masked for all of its rows. Q goes to registers once as
//   mma.sync A fragments; Q K^T and P V run on mma.sync m16n8k16 (bf16 in,
//   f32 accumulate); 8-bit K and V are converted to bf16 tiles in shared
//   memory once per stage, by integer operations and one f32 add or
//   multiply a value (exact: every int8 and e4m3 value is a bf16 value;
//   the conversion unit is 4x slower). A warp's rows are whole, so the
//   softmax stays in registers: the score fragments become P's A
//   fragments, row maxima and sums are quad shuffles. A stage that every
//   row of a warp sees whole runs without the causal mask. With one warp
//   of 16 rows per scheduler (1,024 rows per KV head at C 256, group 4,
//   are 512 warps on 132 SMs), the time goes to the latency of each
//   stage's dependent steps.
//   Each row runs the decode span walk's operations in its order
//   (paged_common.cuh, paged_span_body), so a window's row is bitwise the
//   tensor-core decode kernel's output at the row's length (fault F9: a
//   preempted sequence's recompute takes its next token from a window's
//   last row where its solo run took it from a decode tick). The key axis
//   is cut into the decode's spans of TK8S_PAGED_SPAN keys, fixed by
//   position (four stages each); a row's state restarts from m = NEG_INF,
//   l = 0, acc = 0 at each span, and the spans below its length are merged
//   in increasing order with the decode's merge arithmetic: the finished
//   span into a merged state kept in shared memory, the last one at the
//   end. Within a span: the decode's per-page online softmax, exp by expf,
//   a page's sum of p in the span walk's order (each 16-key chunk
//   pairwise, then across the quad, then the chunks in order), and the
//   Q K^T and P V chains in its k order (a score over the D/16 k-steps in
//   order; a page's P V over its 16-key chunks in order, hi then lo on
//   8-bit pools).
// - cuda_core (f32 queries, other block sizes and widths):
//   paged_prefill_kernel below, the products on the CUDA cores in f32. Its
//   rows are the CUDA-core decode kernel's rows bit for bit: the same
//   per-row operations in the same order, the page's sum of exps added in
//   warp_sum's lane order (softmax_row_update). A preempted sequence's
//   recompute, whose next token comes from a prefill window, then samples
//   from the logits its solo run's decode tick gave (fault F9).
//
// Rounding order, shared with the plain version (ops/paged_attention.py
//   `_paged_attention_plain`, with the decode's spans where the tensor-core
//   design runs, `_kernels.paged_span`), so the card holds the kernels to
//   one bf16 ulp of it: q.k in f32 from q's dtype and K converted exactly,
//   then times D^-0.5 (then times the page's K scale); the reference's f32
//   online softmax per page of bs keys, m_new = max(m, page max), p =
//   exp(s - m_new), corr = exp(m - m_new), l = fmaf(l, corr, sum p) (exp:
//   expf; on the tensor cores the running max restarts at each span and the
//   spans are merged, as the decode's); p rounded to V's dtype before P*V on
//   unquantized pools, kept in f32 on quantized ones (on the tensor cores
//   p = hi + lo, two bf16 products, |p - hi - lo| <= 2^-16 p), whose page
//   sums are multiplied by the V scale; acc = fmaf(acc, corr, pv) per page;
//   acc / l where l > 0, else 0.
//
// Rows independent of the window (tensor-core design): stages are fixed by
//   key position, never by the offset or the row tile, an mma row does not
//   see its tile's other rows, a page past a row's position is an exact
//   no-op of its softmax (corr 1, p 0), and a row's spans follow from its
//   position alone. So the output row at position p has the same bits
//   whatever window it came in -- the identity the reference pins as making
//   prefix sharing invisible in outputs.
//
// What still holds it back (H100 SXM at 700 W, C 256 at offsets 0, 256 and
//   1,024 summed, before the decode's expf and spans: bf16 0.099 ms, 0.084
//   of the bound, int8 0.151, fp8 0.164; SDPA 0.21 -- PERF.md, Findings):
//   each 64-key stage is one
//   chain of dependent steps a warp, per page max shuffles, exp, sum
//   shuffles, P V and a fold of the whole accumulator, about 1.7 us a
//   stage where its instructions alone would take ~0.5 us; a fixed ~15 us
//   a launch (setup, the first stage's DRAM latency) dominates short
//   windows; 8-bit pages add the conversion pass, a barrier and the second
//   P V. A running max per stage rather than per page would cut the folds
//   and shuffles 4x, at the price of rows that are no longer the decode's
//   (F9) and a plain version that differs from the reference's.
#include <type_traits>

#include "paged_common.cuh"

namespace {

// ---- cuda_core: the products on the CUDA cores in f32 ----
//
// One block per (KV head, tile of 64 query rows). Pages are staged 64 keys
// at a time (V by 16-byte asynchronous copies, K converted to f32 on the
// way in). The score product is register tiled: each thread computes a
// 4-row x 8-key block from 16-byte shared-memory reads; P*V keeps each
// thread's column of the 64-row accumulator in registers.
constexpr int kThreads = 128;
constexpr int kRows = 64;       // query rows per block
constexpr int kKeys = 64;       // keys staged per tile
constexpr int kMaxDim = 128;    // one accumulator column per thread
// Score micro-tile of thread (rg = tid / 8, kg = tid % 8): rows rg + 16 i
// (i < 4) and keys kg + 8 jj (jj < 8) -- interleaved so that the eight
// threads of a 16-byte shared-memory phase read eight consecutive K rows.
constexpr int kTileRows = 4;
constexpr int kTileKeys = 8;

template <typename T, typename KV, int BS>
__global__ void __launch_bounds__(kThreads)
paged_prefill_kernel(const T* __restrict__ q, const KV* __restrict__ k_pages,
                     const KV* __restrict__ v_pages,
                     const float* __restrict__ k_scale,
                     const float* __restrict__ v_scale,
                     const int* __restrict__ block_table, T* __restrict__ out,
                     int chunk, int hkv, int group, int d, int offset,
                     float scale) {
  constexpr int vec = vec_of<KV>();
  constexpr bool quant = is_quant<KV>();
  constexpr int ppt = kKeys / BS;            // pages per tile
  constexpr int sp = kKeys + 1;              // score row stride (odd)
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int dp = d + 4;                      // f32 row stride: +16 B of pad
  KV* v_sh = reinterpret_cast<KV*>(smem_raw);  // [kKeys][d]
  float* q_sh = reinterpret_cast<float*>(v_sh + kKeys * d);  // [kRows][dp]
  float* k_sh = q_sh + kRows * dp;           // [kKeys][dp]
  float* s_sh = k_sh + kKeys * dp;           // [kRows][sp]
  float* p_sh = s_sh + kRows * sp;           // [kRows][sp]
  float* c_sh = p_sh + kRows * sp;           // [kRows][ppt]
  float* m_sh = c_sh + kRows * ppt;          // [kRows]
  float* l_sh = m_sh + kRows;                // [kRows]

  const int h = blockIdx.x;
  const int row0 = blockIdx.y * kRows;
  const int rows = min(kRows, chunk * group - row0);
  const int tid = threadIdx.x;
  const int hq = hkv * group;

  // Row r of this tile is (token (row0+r)/group, member (row0+r)%group);
  // rows past the window are zero queries whose results are never stored.
  for (int i = tid; i < kRows * d; i += kThreads) {
    const int r = i / d, c = i % d;
    float x = 0.f;
    if (r < rows) {
      const int gr = row0 + r;
      const int tok = gr / group, g = gr % group;
      x = to_f(q[((size_t)tok * hq + (size_t)h * group + g) * d + c]);
    }
    q_sh[r * dp + c] = x;
  }
  if (tid < kRows) {
    m_sh[tid] = TK8S_NEG_INF;
    l_sh[tid] = 0.f;
  }
  float acc[kRows];
#pragma unroll
  for (int r = 0; r < kRows; ++r) acc[r] = 0.f;

  // The last key any row of this tile attends is its last row's position.
  const int last_pos = offset + (row0 + rows - 1) / group;
  const int n_pages = last_pos / BS + 1;
  const int rg = tid / kTileKeys;
  const int kg = tid % kTileKeys;
  const int row_vecs = d / vec;
  __syncthreads();

  for (int p0 = 0; p0 < n_pages; p0 += ppt) {
    const int np = min(ppt, n_pages - p0);
    const int nk = np * BS;

    // 1. Stage the tile: V by async copies, K converted to f32.
    for (int i = tid; i < nk * row_vecs; i += kThreads) {
      const int j = i / row_vecs, cv = (i % row_vecs) * vec;
      const size_t src =
          (((size_t)block_table[p0 + j / BS] * hkv + h) * BS + j % BS) * d +
          cv;
      cp_async16(v_sh + j * d + cv, v_pages + src);
      float kf[vec];
      load16_as_f32(k_pages + src, kf);
#pragma unroll
      for (int e = 0; e < vec; e += 4)
        *reinterpret_cast<float4*>(k_sh + j * dp + cv + e) =
            make_float4(kf[e], kf[e + 1], kf[e + 2], kf[e + 3]);
    }
    cp_async_wait_all();
    __syncthreads();

    // 2. Scores, register tiled: 4 rows x 8 keys per thread.
    float sc[kTileRows][kTileKeys];
#pragma unroll
    for (int i = 0; i < kTileRows; ++i)
#pragma unroll
      for (int jj = 0; jj < kTileKeys; ++jj) sc[i][jj] = 0.f;
    for (int c = 0; c < d; c += 4) {
      float4 qv[kTileRows], kv[kTileKeys];
#pragma unroll
      for (int i = 0; i < kTileRows; ++i)
        qv[i] = *reinterpret_cast<const float4*>(
            q_sh + (rg + 16 * i) * dp + c);
#pragma unroll
      for (int jj = 0; jj < kTileKeys; ++jj)
        kv[jj] = *reinterpret_cast<const float4*>(
            k_sh + (kg + 8 * jj) * dp + c);
#pragma unroll
      for (int i = 0; i < kTileRows; ++i) {
#pragma unroll
        for (int jj = 0; jj < kTileKeys; ++jj) {
          float a = sc[i][jj];
          a = fmaf(qv[i].x, kv[jj].x, a);
          a = fmaf(qv[i].y, kv[jj].y, a);
          a = fmaf(qv[i].z, kv[jj].z, a);
          a = fmaf(qv[i].w, kv[jj].w, a);
          sc[i][jj] = a;
        }
      }
    }
    // K scale of each key's page (keys past the tile's pages: unused).
    float ksc[kTileKeys];
#pragma unroll
    for (int jj = 0; jj < kTileKeys; ++jj) {
      const int j = kg + 8 * jj;
      ksc[jj] = quant && j < nk
                    ? k_scale[(size_t)block_table[p0 + j / BS] * hkv + h]
                    : 1.f;
    }
#pragma unroll
    for (int i = 0; i < kTileRows; ++i) {
      const int r = rg + 16 * i;
      const int q_pos = offset + (row0 + r) / group;
#pragma unroll
      for (int jj = 0; jj < kTileKeys; ++jj) {
        const int j = kg + 8 * jj;
        float s = __fmul_rn(sc[i][jj], scale);
        if (quant) s = __fmul_rn(s, ksc[jj]);
        s_sh[r * sp + j] = p0 * BS + j <= q_pos ? s : TK8S_NEG_INF;
      }
    }
    __syncthreads();

    // 3. Online softmax, page by page, one thread per row.
    if (tid < rows) {
      for (int p = 0; p < np; ++p)
        softmax_row_update<T, KV, BS>(s_sh + tid * sp + p * BS,
                                      p_sh + tid * sp + p * BS, m_sh + tid,
                                      l_sh + tid, c_sh + tid * ppt + p);
    }
    __syncthreads();

    // 4. P*V: thread tid owns column tid of every row's accumulator.
    if (tid < d) {
      for (int p = 0; p < np; ++p) {
        const float vsc =
            quant ? v_scale[(size_t)block_table[p0 + p] * hkv + h] : 1.f;
        float vr[BS];
#pragma unroll
        for (int jj = 0; jj < BS; ++jj)
          vr[jj] = to_f(v_sh[(p * BS + jj) * d + tid]);
#pragma unroll
        for (int r = 0; r < kRows; ++r) {
          if (r < rows) {
            const float* pr = p_sh + r * sp + p * BS;
            float pv = 0.f;
#pragma unroll
            for (int jj = 0; jj < BS; ++jj) pv = fmaf(pr[jj], vr[jj], pv);
            acc[r] = acc_update<KV>(acc[r], c_sh[r * ppt + p], pv, vsc);
          }
        }
      }
    }
    __syncthreads();  // the next tile overwrites v_sh, k_sh and s_sh/p_sh
  }

  if (tid < d) {
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      if (r < rows) {
        const int gr = row0 + r;
        const int tok = gr / group, g = gr % group;
        const float l = l_sh[r];
        out[((size_t)tok * hq + (size_t)h * group + g) * d + tid] =
            from_f<T>(l > 0.f ? acc[r] / l : 0.f);
      }
    }
  }
}

template <typename T, typename KV, int BS>
int launch_bs(const T* q, const KV* k_pages, const KV* v_pages,
              const float* k_scale, const float* v_scale,
              const int* block_table, T* out, int chunk, int hkv, int group,
              int d, int offset, float scale, cudaStream_t stream) {
  const size_t smem =
      sizeof(KV) * (size_t)kKeys * d +
      sizeof(float) * ((size_t)(kRows + kKeys) * (d + 4) +
                       2 * (size_t)kRows * (kKeys + 1) +
                       (size_t)kRows * (kKeys / BS) + 2 * kRows);
  static std::atomic<unsigned long long> raised{0};
  cudaError_t e = raise_smem_limit(paged_prefill_kernel<T, KV, BS>, raised);
  if (e != cudaSuccess) return (int)e;
  dim3 grid(hkv, (chunk * group + kRows - 1) / kRows);
  paged_prefill_kernel<T, KV, BS><<<grid, kThreads, smem, stream>>>(
      q, k_pages, v_pages, k_scale, v_scale, block_table, out, chunk, hkv,
      group, d, offset, scale);
  return (int)cudaGetLastError();
}


// ---- tensor_core: mma.sync over a cp.async page ring ----

constexpr int kMmaWarps = 4;
constexpr int kMmaThreads = 32 * kMmaWarps;
constexpr int kMmaRows = 16 * kMmaWarps;  // query rows a block
constexpr int kMmaStageKeys = 64;         // keys a stage, fixed by position
constexpr int kMmaRing = 3;               // stages in the ring

static_assert(kSpanKeys % kMmaStageKeys == 0,
              "a span of the decode walk is whole prefill stages");

// Shared memory of one block: the query tile, the ring (K and V of each
// stage in the page type), on 8-bit pools one stage of K and V converted to
// bf16; on windows that reach past the first span, each thread's merged
// accumulator of the spans before the current one; then the walk's page
// ids (and on 8-bit pools their K and V scales).
template <typename KV, int D>
struct PrefillSmem {
  static constexpr int kBf16Stride = D + 8;                    // bf16 rows
  static constexpr int kKVStride = D + 16 / (int)sizeof(KV);   // page type
  static constexpr int kQBytes = kMmaRows * kBf16Stride * 2;
  static constexpr int kTileBytes =
      kMmaStageKeys * kKVStride * (int)sizeof(KV);
  static constexpr int kRingBytes = kMmaRing * 2 * kTileBytes;
  static constexpr int kConvBytes =
      is_quant<KV>() ? 2 * kMmaStageKeys * kBf16Stride * 2 : 0;
  static constexpr int kFixedBytes = kQBytes + kRingBytes + kConvBytes;
  static constexpr int kMergeBytes = kMmaThreads * (D / 2) * 4;
  static constexpr int kPageBytes = is_quant<KV>() ? 12 : 4;  // a page
};

// Four 8-bit page values (the bytes of w, first in the low byte) as two
// bf16x2 operands, exactly and without the conversion unit: each value is
// built as an f32 by integer operations and one f32 add or multiply, and
// its bf16 is the f32's high half (an int8 or e4m3 value has at most 8
// significant bits, so the low half is 0).
// int8 x: the f32 with bits 0x4b0000uu, u = x + 128, is 2^23 + u exactly.
// e4m3 s.eeee.mmm: the f32 with sign s, exponent field eeee and mantissa
// mmm0...0 is the value times 2^-120, for subnormals (eeee = 0) too; a NaN
// byte (0x7f, 0xff) reads as 480.
template <typename KV>
__device__ __forceinline__ void bf16x4_of(uint32_t w, uint32_t& lo,
                                          uint32_t& hi) {
  uint32_t f[4];
  if constexpr (std::is_same<KV, int8_t>::value) {
    const uint32_t u = w ^ 0x80808080u;
#pragma unroll
    for (int i = 0; i < 4; ++i)
      f[i] = __float_as_uint(
          __uint_as_float(__byte_perm(u, 0x4b000000u, 0x7440u + i)) -
          8388736.f);
  } else {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const uint32_t t = __byte_perm(w, 0u, 0x0444u | (i << 12));
      f[i] = __float_as_uint(
          __uint_as_float((t & 0x80000000u) | ((t & 0x7f000000u) >> 4)) *
          0x1p120f);
    }
  }
  lo = __byte_perm(f[0], f[1], 0x7632u);
  hi = __byte_perm(f[2], f[3], 0x7632u);
}

template <typename KV, int D, int BS>
__global__ void __launch_bounds__(kMmaThreads, 1)
paged_prefill_mma_kernel(const __nv_bfloat16* __restrict__ q,
                         const KV* __restrict__ k_pages,
                         const KV* __restrict__ v_pages,
                         const float* __restrict__ k_scale,
                         const float* __restrict__ v_scale,
                         const int* __restrict__ block_table,
                         __nv_bfloat16* __restrict__ out, int chunk, int hkv,
                         int group, int offset, float scale) {
  using L = PrefillSmem<KV, D>;
  constexpr bool quant = is_quant<KV>();
  constexpr int QS = L::kBf16Stride;  // bf16 stride: Q, and K/V as read
  constexpr int KVS = L::kKVStride;
  constexpr int KD = D / 16;                  // k-steps of a score
  constexpr int NT = kMmaStageKeys / 8;       // score n-tiles a stage
  constexpr int PPS = kMmaStageKeys / BS;     // pages a stage
  constexpr int TPP = BS / 8;                 // score n-tiles a page
  constexpr int KPP = BS / 16;                // P*V k-steps a page
  constexpr int CPR = D * (int)sizeof(KV) / 16;  // 16-byte copies a row
  constexpr int VEC = 16 / (int)sizeof(KV);
  static_assert(D % 16 == 0 && BS % 16 == 0 && kMmaStageKeys % BS == 0,
                "tensor-core prefill: D a multiple of 16, bs 16, 32 or 64");
  extern __shared__ __align__(16) unsigned char smem_raw[];

  const int rows = chunk * group, hq = hkv * group;
  const int n_tiles = (rows + kMmaRows - 1) / kMmaRows;
  // The last row tiles walk the most keys: they get the first blocks.
  const int h = blockIdx.x % hkv;
  const int row0 = (n_tiles - 1 - (int)blockIdx.x / hkv) * kMmaRows;
  const int tile_rows = min(kMmaRows, rows - row0);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t4 = lane & 3;
  // The block stops at the page of its last row's position.
  const int n_pages = (offset + (row0 + tile_rows - 1) / group) / BS + 1;
  const int k_end = n_pages * BS;
  const int n_stages = (k_end + kMmaStageKeys - 1) / kMmaStageKeys;

  __nv_bfloat16* q_sh = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  KV* ring = reinterpret_cast<KV*>(smem_raw + L::kQBytes);
  __nv_bfloat16* kb = reinterpret_cast<__nv_bfloat16*>(
      smem_raw + L::kQBytes + L::kRingBytes);  // 8-bit pools: [64][QS]
  __nv_bfloat16* vb = kb + kMmaStageKeys * QS;
  // Merged accumulators, element (nt, e) of thread tid at
  // (4 nt + e) * kMmaThreads + tid; only a window past the first span has
  // them.
  const bool spans = offset + chunk > kSpanKeys;
  float* a_mrg = reinterpret_cast<float*>(smem_raw + L::kFixedBytes);
  int* tbl = reinterpret_cast<int*>(smem_raw + L::kFixedBytes +
                                    (spans ? L::kMergeBytes : 0));
  float* ksc = reinterpret_cast<float*>(tbl + n_pages);
  float* vsc = ksc + n_pages;

  for (int i = tid; i < n_pages; i += kMmaThreads) tbl[i] = block_table[i];
  // Row r of the tile is (token (row0+r)/group, member (row0+r)%group);
  // rows past the window are zero queries whose results are never stored.
  for (int i = tid; i < kMmaRows * (D / 8); i += kMmaThreads) {
    const int r = i / (D / 8), c = (i % (D / 8)) * 8;
    uint4 v = make_uint4(0u, 0u, 0u, 0u);
    if (r < tile_rows) {
      const int gr = row0 + r;
      v = *reinterpret_cast<const uint4*>(
          q + ((size_t)(gr / group) * hq + (size_t)h * group + gr % group) *
                  D + c);
    }
    *reinterpret_cast<uint4*>(q_sh + r * QS + c) = v;
  }
  __syncthreads();

  // Stage st's K and V rows into ring slot st % kMmaRing (keys past the
  // walk's last page zero-filled), as one commit group; past the last
  // stage the group is empty, so every iteration waits for the same count.
  auto stage_copies = [&](int st) {
    if (st < n_stages) {
      KV* kd = ring + (size_t)(2 * (st % kMmaRing)) * kMmaStageKeys * KVS;
      KV* vd = kd + kMmaStageKeys * KVS;
      const int ks = st * kMmaStageKeys;
      for (int i = tid; i < kMmaStageKeys * CPR; i += kMmaThreads) {
        const int j = i / CPR, c = (i % CPR) * VEC;
        const int key = ks + j;
        const bool live = key < k_end;
        size_t src = 0;
        if (live)
          src = (((size_t)tbl[key / BS] * hkv + h) * BS + key % BS) * D + c;
        cp_async16_zfill(kd + j * KVS + c, k_pages + src, live);
        cp_async16_zfill(vd + j * KVS + c, v_pages + src, live);
      }
    }
    asm volatile("cp.async.commit_group;\n" ::: "memory");
  };
#pragma unroll
  for (int st = 0; st < kMmaRing - 1; ++st) stage_copies(st);
  if (quant) {
    for (int i = tid; i < n_pages; i += kMmaThreads) {
      ksc[i] = k_scale[(size_t)tbl[i] * hkv + h];
      vsc[i] = v_scale[(size_t)tbl[i] * hkv + h];
    }
  }

  // This warp's rows: wr0 + g and wr0 + g + 8 of the tile, at positions
  // rpos (padding rows take the last real row's); the first and the last
  // position any of them has.
  const int wr0 = warp * 16;
  const bool live_warp = wr0 < tile_rows;
  int rpos[2];
#pragma unroll
  for (int hf = 0; hf < 2; ++hf)
    rpos[hf] = offset + (row0 + min(wr0 + g + 8 * hf, tile_rows - 1)) / group;
  const int warp_first = offset + (row0 + wr0) / group;
  const int warp_last =
      offset + (row0 + min(wr0 + 15, tile_rows - 1)) / group;

  // The warp's query rows as A fragments, for the whole walk.
  uint32_t qa[KD][4];
#pragma unroll
  for (int kk = 0; kk < KD; ++kk)
    ldmatrix_x4(qa[kk],
                smem_u32(q_sh + (wr0 + (lane & 7) + ((lane >> 3) & 1) * 8) *
                                    QS +
                         kk * 16 + (lane >> 4) * 8));
  // (m, l, acc): the softmax state of the current span; (m_mrg, l_mrg,
  // a_mrg): the spans before it, merged in order.
  float m_run[2] = {TK8S_NEG_INF, TK8S_NEG_INF}, l_run[2] = {0.f, 0.f};
  float m_mrg[2] = {TK8S_NEG_INF, TK8S_NEG_INF}, l_mrg[2] = {0.f, 0.f};
  int cur_span = 0;
  float acc[D / 8][4];
#pragma unroll
  for (int nt = 0; nt < D / 8; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[nt][e] = 0.f;

  for (int st = 0; st < n_stages; ++st) {
    asm volatile("cp.async.wait_group %0;\n" ::"n"(kMmaRing - 2) : "memory");
    __syncthreads();  // stage st has landed; stage st - 1 is done with
    stage_copies(st + kMmaRing - 1);
    const KV* kt8 = ring + (size_t)(2 * (st % kMmaRing)) * kMmaStageKeys * KVS;
    const __nv_bfloat16* kt;
    const __nv_bfloat16* vt;
    if constexpr (quant) {
      // The stage's 8-bit K and V as bf16 tiles, 16 values a thread-step.
      const KV* vt8 = kt8 + kMmaStageKeys * KVS;
      for (int i = tid; i < 2 * kMmaStageKeys * (D / 16); i += kMmaThreads) {
        const int half = i / (kMmaStageKeys * (D / 16));
        const int j = (i / (D / 16)) % kMmaStageKeys, c = (i % (D / 16)) * 16;
        const uint4 u = *reinterpret_cast<const uint4*>(
            (half ? vt8 : kt8) + j * KVS + c);
        uint4 lo, hi;
        bf16x4_of<KV>(u.x, lo.x, lo.y);
        bf16x4_of<KV>(u.y, lo.z, lo.w);
        bf16x4_of<KV>(u.z, hi.x, hi.y);
        bf16x4_of<KV>(u.w, hi.z, hi.w);
        __nv_bfloat16* dst = (half ? vb : kb) + j * QS + c;
        *reinterpret_cast<uint4*>(dst) = lo;
        *reinterpret_cast<uint4*>(dst + 8) = hi;
      }
      __syncthreads();
      kt = kb;
      vt = vb;
    } else {
      kt = kt8;
      vt = kt8 + kMmaStageKeys * KVS;
    }
    const int ks = st * kMmaStageKeys;  // first key of the stage
    if (!live_warp || ks > warp_last) continue;  // nothing this warp sees
    if (ks > 0 && ks % kSpanKeys == 0) {
      // A span ends. Every row of the warp has keys in it (the warp's rows
      // lie within 16 positions of warp_last >= ks), so, as the decode's
      // last block does for each span below a row's length, fold it into
      // the merged state -- the first span is copied -- and start the next
      // from fresh state.
      const bool first = ks == kSpanKeys;
      float co[2], cs[2];
#pragma unroll
      for (int hf = 0; hf < 2; ++hf) {
        const float mn = fmaxf(m_mrg[hf], m_run[hf]);
        co[hf] = expf(m_mrg[hf] - mn);
        cs[hf] = expf(m_run[hf] - mn);
        l_mrg[hf] = first ? l_run[hf]
                          : fmaf(l_mrg[hf], co[hf], __fmul_rn(l_run[hf], cs[hf]));
        m_mrg[hf] = first ? m_run[hf] : mn;
        m_run[hf] = TK8S_NEG_INF;
        l_run[hf] = 0.f;
      }
#pragma unroll
      for (int nt = 0; nt < D / 8; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          float* a = a_mrg + (4 * nt + e) * kMmaThreads + tid;
          *a = first ? acc[nt][e]
                     : fmaf(*a, co[e >> 1], __fmul_rn(acc[nt][e], cs[e >> 1]));
          acc[nt][e] = 0.f;
        }
      cur_span = ks / kSpanKeys;
    }
    // WHOLE: every row of the warp sees every key of the stage, so no key
    // is masked and every page is visited.
    auto compute = [&](auto whole) {
      constexpr bool WHOLE = decltype(whole)::value;

      // 1. Scores of the warp's 16 rows against the stage's 64 keys; n-tile
      //    nt holds keys ks + 8 nt .. ks + 8 nt + 7.
      float s[NT][4];
#pragma unroll
      for (int nt = 0; nt < NT; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[nt][e] = 0.f;
#pragma unroll
      for (int kk = 0; kk < KD; ++kk) {
#pragma unroll
        for (int j = 0; j < NT / 2; ++j) {
          uint32_t r4[4];
          const int krow = j * 16 + (lane & 7) + (lane >> 4) * 8;
          ldmatrix_x4(r4, smem_u32(kt + krow * QS + kk * 16 +
                                   ((lane >> 3) & 1) * 8));
          mma16816(s[2 * j], qa[kk], r4[0], r4[1]);
          mma16816(s[2 * j + 1], qa[kk], r4[2], r4[3]);
        }
      }
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        const int page = (ks + nt * 8) / BS;  // past the walk: masked keys
        const float kscale =
            quant && (WHOLE || page < n_pages) ? ksc[page] : 1.f;
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int key = ks + nt * 8 + 2 * t4 + (e & 1);
          float x = __fmul_rn(s[nt][e], scale);
          if (quant) x = __fmul_rn(x, kscale);
          s[nt][e] = WHOLE || key <= rpos[e >> 1] ? x : TK8S_NEG_INF;
        }
      }

      // 2. Page by page: the online-softmax step of each row, then
      //    pv = P_page V_page into fresh accumulators and the recurrence.
#pragma unroll
      for (int pg = 0; pg < PPS; ++pg) {
        const int pstart = ks + pg * BS;
        if (!WHOLE && pstart > warp_last) break;  // masked for every row
        float corr[2];
#pragma unroll
        for (int hf = 0; hf < 2; ++hf) {
          float mx = TK8S_NEG_INF;
#pragma unroll
          for (int t = 0; t < TPP; ++t)
            mx = fmaxf(mx, fmaxf(s[pg * TPP + t][2 * hf],
                                 s[pg * TPP + t][2 * hf + 1]));
          mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
          mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
          const float m_new = fmaxf(m_run[hf], mx);
          // The page's sum of p as the span walk adds it: each 16-key
          // chunk's four values a thread, pairwise, then across the quad,
          // then the chunks in order (the first added to +0: exact).
          float sum = 0.f;
#pragma unroll
          for (int c = 0; c < KPP; ++c) {
            float pc[2][2];
#pragma unroll
            for (int t = 0; t < 2; ++t)
#pragma unroll
              for (int i = 0; i < 2; ++i) {
                const int nt = pg * TPP + 2 * c + t, e = 2 * hf + i;
                const int key = pstart + (2 * c + t) * 8 + 2 * t4 + i;
                pc[t][i] = WHOLE || key <= rpos[hf] ? expf(s[nt][e] - m_new)
                                                    : 0.f;
                s[nt][e] = pc[t][i];
              }
            float cs = (pc[0][0] + pc[0][1]) + (pc[1][0] + pc[1][1]);
            cs += __shfl_xor_sync(0xffffffffu, cs, 1);
            cs += __shfl_xor_sync(0xffffffffu, cs, 2);
            sum += cs;
          }
          corr[hf] = expf(m_run[hf] - m_new);
          l_run[hf] = fmaf(l_run[hf], corr[hf], sum);
          m_run[hf] = m_new;
        }
        // P as A fragments (k-step kk: keys pstart + 16 kk .. + 15): bf16 p
        // on bf16 pools, p = hi + lo on 8-bit pools.
        uint32_t pa[KPP][4], pl[KPP][4];
#pragma unroll
        for (int kk = 0; kk < KPP; ++kk)
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const int nt = pg * TPP + 2 * kk + (i >> 1), e = 2 * (i & 1);
            const __nv_bfloat162 hi =
                __floats2bfloat162_rn(s[nt][e], s[nt][e + 1]);
            pa[kk][i] = *reinterpret_cast<const uint32_t*>(&hi);
            if (quant)
              pl[kk][i] = pack_bf16x2(s[nt][e] - __low2float(hi),
                                      s[nt][e + 1] - __high2float(hi));
          }
        const float vs = quant ? vsc[pstart / BS] : 1.f;
#pragma unroll
        for (int np = 0; np < D / 16; ++np) {
          float pv[2][4];
#pragma unroll
          for (int j = 0; j < 2; ++j)
#pragma unroll
            for (int e = 0; e < 4; ++e) pv[j][e] = 0.f;
#pragma unroll
          for (int kk = 0; kk < KPP; ++kk) {
            uint32_t r4[4];
            ldmatrix_x4_trans(
                r4, smem_u32(vt + (pg * BS + kk * 16 + (lane & 7) +
                                   ((lane >> 3) & 1) * 8) * QS +
                             np * 16 + (lane >> 4) * 8));
#pragma unroll
            for (int j = 0; j < 2; ++j) {
              mma16816(pv[j], pa[kk], r4[2 * j], r4[2 * j + 1]);
              if (quant) mma16816(pv[j], pl[kk], r4[2 * j], r4[2 * j + 1]);
            }
          }
#pragma unroll
          for (int j = 0; j < 2; ++j)
#pragma unroll
            for (int e = 0; e < 4; ++e)
              acc[2 * np + j][e] =
                  quant ? fmaf(acc[2 * np + j][e], corr[e >> 1],
                               __fmul_rn(pv[j][e], vs))
                        : fmaf(acc[2 * np + j][e], corr[e >> 1], pv[j][e]);
        }
      }
    };
    if (ks + kMmaStageKeys - 1 <= warp_first)
      compute(std::true_type());
    else
      compute(std::false_type());
  }
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");

  // Accumulator element (nt, e): row wr0 + g + 8 (e / 2), column
  // 8 nt + 2 t4 + e % 2.
  if (!live_warp) return;
#pragma unroll
  for (int hf = 0; hf < 2; ++hf) {
    const int r = wr0 + g + 8 * hf;
    if (r >= tile_rows) continue;
    const int gr = row0 + r;
    // The row's state over every span below its length: the current span
    // alone, the merged spans (the current one starts past the row), or
    // the current span merged into them, as the decode's last block ends.
    float l = l_run[hf];
    if (cur_span > 0) {
      const bool live_cur = rpos[hf] >= cur_span * kSpanKeys;
      const float mn = fmaxf(m_mrg[hf], m_run[hf]);
      const float co = expf(m_mrg[hf] - mn), cs = expf(m_run[hf] - mn);
      l = live_cur ? fmaf(l_mrg[hf], co, __fmul_rn(l_run[hf], cs))
                   : l_mrg[hf];
#pragma unroll
      for (int nt = 0; nt < D / 8; ++nt)
#pragma unroll
        for (int e = 2 * hf; e < 2 * hf + 2; ++e) {
          const float a = a_mrg[(4 * nt + e) * kMmaThreads + tid];
          acc[nt][e] =
              live_cur ? fmaf(a, co, __fmul_rn(acc[nt][e], cs)) : a;
        }
    }
    __nv_bfloat16* o =
        out + ((size_t)(gr / group) * hq + (size_t)h * group + gr % group) *
                  D + 2 * t4;
#pragma unroll
    for (int nt = 0; nt < D / 8; ++nt)
      *reinterpret_cast<uint32_t*>(o + nt * 8) =
          pack_bf16x2(l > 0.f ? acc[nt][2 * hf] / l : 0.f,
                      l > 0.f ? acc[nt][2 * hf + 1] / l : 0.f);
  }
}

template <typename KV, int D, int BS>
int launch_mma(const void* q, const void* k_pages, const void* v_pages,
               const void* k_scale, const void* v_scale,
               const void* block_table, void* out, int chunk, int hkv,
               int group, int offset, float scale, void* stream) {
  using L = PrefillSmem<KV, D>;
  // The longest walk's pages size the page-id (and scale) table; a
  // window past the first span holds the merged accumulators.
  const int n_pages = (offset + chunk - 1) / BS + 1;
  const size_t smem = L::kFixedBytes +
                      (offset + chunk > kSpanKeys ? L::kMergeBytes : 0) +
                      (size_t)L::kPageBytes * n_pages;
  static std::atomic<unsigned long long> raised{0};
  cudaError_t e =
      raise_smem_limit(paged_prefill_mma_kernel<KV, D, BS>, raised);
  if (e != cudaSuccess) return (int)e;
  const int blocks = (chunk * group + kMmaRows - 1) / kMmaRows * hkv;
  paged_prefill_mma_kernel<KV, D, BS><<<blocks, kMmaThreads, smem,
                                        (cudaStream_t)stream>>>(
      (const __nv_bfloat16*)q, (const KV*)k_pages, (const KV*)v_pages,
      (const float*)k_scale, (const float*)v_scale, (const int*)block_table,
      (__nv_bfloat16*)out, chunk, hkv, group, offset, scale);
  return (int)cudaGetLastError();
}

template <typename T, typename KV>
int launch(const void* q, const void* k_pages, const void* v_pages,
           const void* k_scale, const void* v_scale, const void* block_table,
           void* out, int chunk, int hkv, int group, int d, int bs, int tw,
           int offset, float scale, int variant, void* stream) {
  constexpr int vec = vec_of<KV>();
  // The window must lie inside the table: every page a row walks exists.
  if (chunk < 1 || group < 1 || hkv < 1 || bs < 1 || tw < 1 || offset < 0 ||
      offset + chunk > tw * bs ||
      (is_quant<KV>() && (k_scale == nullptr || v_scale == nullptr)))
    return (int)cudaErrorInvalidValue;
  if (variant == TK8S_PAGED_CUDA_CORE) {
    if (d < vec || d > kMaxDim || d % vec != 0)
      return (int)cudaErrorInvalidValue;
    const T* qq = (const T*)q;
    const KV* kp = (const KV*)k_pages;
    const KV* vp = (const KV*)v_pages;
    const float* ks = (const float*)k_scale;
    const float* vs = (const float*)v_scale;
    const int* bt = (const int*)block_table;
    T* o = (T*)out;
    cudaStream_t s = (cudaStream_t)stream;
    switch (bs) {
      case 4:
        return launch_bs<T, KV, 4>(qq, kp, vp, ks, vs, bt, o, chunk, hkv,
                                   group, d, offset, scale, s);
      case 8:
        return launch_bs<T, KV, 8>(qq, kp, vp, ks, vs, bt, o, chunk, hkv,
                                   group, d, offset, scale, s);
      case 16:
        return launch_bs<T, KV, 16>(qq, kp, vp, ks, vs, bt, o, chunk, hkv,
                                    group, d, offset, scale, s);
      case 32:
        return launch_bs<T, KV, 32>(qq, kp, vp, ks, vs, bt, o, chunk, hkv,
                                    group, d, offset, scale, s);
      default:
        return (int)cudaErrorInvalidValue;
    }
  }
  // The tensor-core design is built for bf16 queries only.
  if constexpr (std::is_same<T, __nv_bfloat16>::value) {
    if (variant == TK8S_PAGED_TENSOR_CORE) {
#define TK8S_PREFILL_MMA(DD, BB)                                           \
  if (d == DD && bs == BB)                                                 \
    return launch_mma<KV, DD, BB>(q, k_pages, v_pages, k_scale, v_scale,   \
                                  block_table, out, chunk, hkv, group,     \
                                  offset, scale, stream);
      TK8S_PREFILL_MMA(128, 16)
      TK8S_PREFILL_MMA(128, 32)
      TK8S_PREFILL_MMA(64, 16)
      TK8S_PREFILL_MMA(64, 32)
#undef TK8S_PREFILL_MMA
    }
  }
  return (int)cudaErrorInvalidValue;
}

}  // namespace

#define TK8S_PREFILL_ENTRY(suffix, T, KV)                                   \
  extern "C" int tk8s_paged_prefill_##suffix(                               \
      const void* q, const void* k_pages, const void* v_pages,              \
      const void* k_scale, const void* v_scale, const void* block_table,    \
      void* out, int chunk, int hkv, int group, int d, int bs, int tw,      \
      int offset, float scale, int variant, void* stream) {                 \
    return launch<T, KV>(q, k_pages, v_pages, k_scale, v_scale,             \
                         block_table, out, chunk, hkv, group, d, bs, tw,    \
                         offset, scale, variant, stream);                   \
  }
TK8S_PAGED_DTYPES(TK8S_PREFILL_ENTRY)

// Device code shared by the paged-attention kernels (paged_decode.cu,
// paged_verify.cu, paged_prefill.cu): dtype conversion, 16-byte async
// copies into shared memory, warp reductions, the per-page online-softmax
// row update, and the two page walks of the decode and verify kernels --
// the CUDA-core walk (paged_rows_body: f32 queries, and shapes the second
// is not built for) and the span walk on the tensor cores
// (paged_span_body: bf16 queries at D 64/128, bs 16/32). Which one a
// call runs is ops/_kernels.py's PAGED_TENSOR_CORE table, passed to the
// C entries as a variant code; decode and verify read the same entry.
//
// Page types: the activation dtype T (bf16 or f32) on unquantized pools;
// int8 or fp8 (e4m3) on quantized ones, with one f32 scale per (page, KV
// head). 8-bit values convert to f32 exactly.
//
// The update is the one the TPU kernels run for every (page, row) step
// (triton_kubernetes_tpu/ops/paged_attention.py:516-528): the scores of one
// page's `bs` keys are already scaled and masked (NEG_INF where a key is
// past the row's position), then
//
//   m_new = max(m_prev, max_j s_j)
//   p_j   = exp(s_j - m_new)                (f32)
//   corr  = exp(m_prev - m_new)
//   l     = l * corr + sum_j p_j            (sum of the f32 p)
//   acc   = acc * corr + sum_j round(p_j) * v_j
//
// where round() is to V's dtype on unquantized pools. On quantized pools p
// stays f32 and the page's sum is multiplied by its V scale before it is
// added: acc = acc * corr + (sum_j p_j * v_j) * v_scale; the scores carry
// the K scale, s = ((q . k) * D^-0.5) * k_scale. Both recurrences are
// written with fmaf and __fmul_rn, so nvcc cannot contract them one way in
// one kernel and another way in the next: the decode and verify kernels,
// compiled separately, give the same bits for the same row.
#pragma once

#include <cuda_bf16.h>
#include <cuda_fp8.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <atomic>

#define TK8S_NEG_INF (-1e30f)

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ float to_f(int8_t x) { return (float)x; }
__device__ __forceinline__ float to_f(__nv_fp8_e4m3 x) {
  return static_cast<float>(x);
}

template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) {
  return x;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

// x rounded to T and back: the P*V operand of unquantized pools.
template <typename T> __device__ __forceinline__ float round_to(float x) {
  return to_f(from_f<T>(x));
}

// Elements of T in one 16-byte copy.
template <typename T> __host__ __device__ constexpr int vec_of() {
  return 16 / (int)sizeof(T);
}

// Whether a page type is quantized (8-bit values with per-page scales).
template <typename KV> __host__ __device__ constexpr bool is_quant() {
  return sizeof(KV) == 1;
}

// The 16 bytes at p (16-byte aligned) as floats: 4 f32, 8 bf16 or 16
// int8/fp8 values.
__device__ __forceinline__ void load16_as_f32(const __nv_bfloat16* p,
                                              float* f) {
  const uint4 u = *reinterpret_cast<const uint4*>(p);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 x = __bfloat1622float2(h[i]);
    f[2 * i] = x.x;
    f[2 * i + 1] = x.y;
  }
}
__device__ __forceinline__ void load16_as_f32(const float* p, float* f) {
  const float4 x = *reinterpret_cast<const float4*>(p);
  f[0] = x.x;
  f[1] = x.y;
  f[2] = x.z;
  f[3] = x.w;
}
template <typename KV>
__device__ __forceinline__ void load16_8bit_as_f32(const KV* p, float* f) {
  const uint4 u = *reinterpret_cast<const uint4*>(p);
  const KV* e = reinterpret_cast<const KV*>(&u);
#pragma unroll
  for (int i = 0; i < 16; ++i) f[i] = to_f(e[i]);
}
__device__ __forceinline__ void load16_as_f32(const int8_t* p, float* f) {
  load16_8bit_as_f32(p, f);
}
__device__ __forceinline__ void load16_as_f32(const __nv_fp8_e4m3* p,
                                              float* f) {
  load16_8bit_as_f32(p, f);
}

// Asynchronous 16-byte global -> shared copy (sm_80+); both addresses
// 16-byte aligned. cp_async_wait_all() waits for every copy this thread
// issued; a __syncthreads() after it publishes them to the block.
__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(gmem));
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.commit_group;\n" ::);
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}
__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

// One row's online-softmax step over one page of N keys, by one thread
// (the prefill kernel's CUDA-core design). `s` holds the page's N scores,
// `p` receives exp(s - m_new), rounded to T unless the pool is quantized;
// m, l and corr are this row's running state. Every value is the page walk
// of the decode and verify kernels' (paged_rows_body) bit for bit: the
// same max, exps and corr, and the page's sum of exps added in the order
// warp_sum adds them with lane j holding key j and the lanes past N
// holding 0 -- the butterfly's steps of offset >= N add zeros (exact), and
// each later step of offset o adds element i + o to element i. So a row a
// prefill window computes is the row a decode tick computes at its length
// (a preempted sequence's recompute gives its solo run's tokens).
template <int N>
__device__ __forceinline__ float lane_order_sum(float (&t)[N]) {
  static_assert(N >= 1 && N <= 32 && (N & (N - 1)) == 0,
                "a page is at most one warp's lanes, a power of two");
#pragma unroll
  for (int o = N / 2; o > 0; o >>= 1) {
#pragma unroll
    for (int i = 0; i < o; ++i) t[i] = t[i] + t[i + o];
  }
  return t[0];
}

template <typename T, typename KV, int N>
__device__ __forceinline__ void softmax_row_update(const float* s, float* p,
                                                   float* m, float* l,
                                                   float* corr) {
  const float m_prev = *m;
  float m_cur = TK8S_NEG_INF;
#pragma unroll
  for (int j = 0; j < N; ++j) m_cur = fmaxf(m_cur, s[j]);
  const float m_new = fmaxf(m_prev, m_cur);
  float e[N];
#pragma unroll
  for (int j = 0; j < N; ++j) {
    e[j] = expf(s[j] - m_new);
    p[j] = is_quant<KV>() ? e[j] : round_to<T>(e[j]);
  }
  const float sum = lane_order_sum<N>(e);
  const float c = expf(m_prev - m_new);
  *l = fmaf(*l, c, sum);
  *corr = c;
  *m = m_new;
}

// acc * corr + pv, with the page's V scale on quantized pools.
template <typename KV>
__device__ __forceinline__ float acc_update(float acc, float corr, float pv,
                                            float v_scale) {
  return is_quant<KV>() ? fmaf(acc, corr, __fmul_rn(pv, v_scale))
                        : fmaf(acc, corr, pv);
}

namespace {

// The page walk of the decode and verify kernels. Geometry of one block:
constexpr int kRowsThreads = 128;
constexpr int kRowsWarps = kRowsThreads / 32;
constexpr int kRowsKeys = 128;    // keys staged per tile: one per thread
constexpr int kRowsMaxDim = 128;  // one accumulator column per thread

// One block per (sequence b, KV head h) computes `spec * group` query rows
// against the sequence's pages, reading every K/V page once for all rows.
// Row r is (stagger r / group, group member r % group): query
// q[b, r / group, h * group + r % group], at length lengths[b] + r / group.
// Decode is spec = 1. A row attends the keys below its own length and
// skips the pages at or past it: row r gives, bit for bit, what this walk
// gives with spec = 1 at that length, since every per-row operation below
// is the same sequence of f32 operations whatever the other rows are.
//
// Per tile of 128 keys (ppt = 128 / bs pages): (1) stage the tile's K and
// V rows with 16-byte async copies, every copy in flight at once; (2)
// thread j scores key j against every row (the dot in D order, then the
// scale and, quantized, the page's K scale); (3) one warp per row runs the
// online-softmax update page by page, one lane per key; (4) thread c folds
// column c of P*V into every row's accumulator, page by page.
//
// Shared memory (bytes, R = spec * group rows):
//   K [128][d + 16 B pad] and V [128][d] in the page type, then f32
//   q [R][d], s [R][128], p [R][128], corr [R][ppt], l [R].
template <typename T, typename KV, int MAX_ROWS>
__device__ __forceinline__ void paged_rows_body(
    unsigned char* smem_raw, const T* __restrict__ q,
    const KV* __restrict__ k_pages, const KV* __restrict__ v_pages,
    const float* __restrict__ k_scale, const float* __restrict__ v_scale,
    const int* __restrict__ block_tables, const int* __restrict__ lengths,
    T* __restrict__ out, int hkv, int group, int spec, int d, int bs, int tw,
    float scale) {
  constexpr int vec = vec_of<KV>();
  constexpr bool quant = is_quant<KV>();
  constexpr int kRowsPerWarp = MAX_ROWS / kRowsWarps;
  const int rows = spec * group;
  const int ks = d + vec;                       // K row stride: +16 B pad
  const int ppt = kRowsKeys / bs;               // pages per tile
  KV* k_sh = reinterpret_cast<KV*>(smem_raw);   // [kRowsKeys][ks]
  KV* v_sh = k_sh + kRowsKeys * ks;             // [kRowsKeys][d]
  float* q_sh = reinterpret_cast<float*>(v_sh + kRowsKeys * d);  // [R][d]
  float* s_sh = q_sh + rows * d;                // [R][kRowsKeys]
  float* p_sh = s_sh + rows * kRowsKeys;        // [R][kRowsKeys]
  float* c_sh = p_sh + rows * kRowsKeys;        // [R][ppt]
  float* l_sh = c_sh + rows * ppt;              // [R]

  const int b = blockIdx.x;
  const int h = blockIdx.y;
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int hq = hkv * group;

  for (int i = tid; i < rows * d; i += kRowsThreads) {
    const int r = i / d, c = i % d;
    q_sh[i] = to_f(q[(((size_t)b * spec + r / group) * hq +
                      (size_t)h * group + r % group) * d + c]);
  }
  // Softmax state of rows warp + i * kRowsWarps, replicated across lanes.
  float m_run[kRowsPerWarp];
  float l_run[kRowsPerWarp];
#pragma unroll
  for (int i = 0; i < kRowsPerWarp; ++i) {
    m_run[i] = TK8S_NEG_INF;
    l_run[i] = 0.f;
  }
  float acc[MAX_ROWS];
#pragma unroll
  for (int g = 0; g < MAX_ROWS; ++g) acc[g] = 0.f;
  __syncthreads();

  const int len = lengths[b];
  // The longest row sets the walk (length 0 and spec 1: no page at all);
  // pages past the table do not exist for any row.
  const int n_pages = min((len + spec - 1 + bs - 1) / bs, tw);
  const int* table = block_tables + (size_t)b * tw;
  const int row_vecs = d / vec;
  for (int p0 = 0; p0 < n_pages; p0 += ppt) {
    const int np = min(ppt, n_pages - p0);
    const int nk = np * bs;

    // 1. Stage the tile's K and V rows, every copy in flight at once.
    for (int i = tid; i < nk * row_vecs; i += kRowsThreads) {
      const int j = i / row_vecs, cv = (i % row_vecs) * vec;
      const size_t src =
          (((size_t)table[p0 + j / bs] * hkv + h) * bs + j % bs) * d + cv;
      cp_async16(k_sh + j * ks + cv, k_pages + src);
      cp_async16(v_sh + j * d + cv, v_pages + src);
    }
    cp_async_wait_all();
    __syncthreads();

    // 2. Scores: thread j scores key j against every row. Row g sees key
    //    iff key < len + g / group, i.e. g >= group * (key - len + 1).
    if (tid < nk) {
      float part[MAX_ROWS];
#pragma unroll
      for (int g = 0; g < MAX_ROWS; ++g) part[g] = 0.f;
      const KV* krow = k_sh + tid * ks;
      for (int c = 0; c < d; c += vec) {
        float kf[vec];
        load16_as_f32(krow + c, kf);
#pragma unroll
        for (int g = 0; g < MAX_ROWS; ++g) {
          if (g < rows) {
            const float* qg = q_sh + g * d + c;
#pragma unroll
            for (int e = 0; e < vec; ++e) part[g] = fmaf(qg[e], kf[e], part[g]);
          }
        }
      }
      const int key = p0 * bs + tid;
      const int g_lo = group * (key - len + 1);
      float ksc = 1.f;
      if (quant) ksc = k_scale[(size_t)table[p0 + tid / bs] * hkv + h];
#pragma unroll
      for (int g = 0; g < MAX_ROWS; ++g) {
        if (g < rows) {
          float sc = __fmul_rn(part[g], scale);
          if (quant) sc = __fmul_rn(sc, ksc);
          s_sh[g * kRowsKeys + tid] = g >= g_lo ? sc : TK8S_NEG_INF;
        }
      }
    }
    __syncthreads();

    // 3. Online softmax, page by page: one warp per row, one lane per key;
    //    a row stops at the first page at or past its length.
#pragma unroll
    for (int i = 0; i < kRowsPerWarp; ++i) {
      const int g = warp + i * kRowsWarps;
      if (g < rows) {
        const int row_len = len + g / group;
        for (int p = 0; p < np && (p0 + p) * bs < row_len; ++p) {
          const int j = p * bs + lane;
          const float s = lane < bs ? s_sh[g * kRowsKeys + j] : TK8S_NEG_INF;
          const float m_new = fmaxf(m_run[i], warp_max(s));
          const float e = lane < bs ? expf(s - m_new) : 0.f;
          const float sum = warp_sum(e);
          if (lane < bs) p_sh[g * kRowsKeys + j] = quant ? e : round_to<T>(e);
          const float c = expf(m_run[i] - m_new);
          l_run[i] = fmaf(l_run[i], c, sum);
          if (lane == 0) c_sh[g * ppt + p] = c;
          m_run[i] = m_new;
        }
      }
    }
    __syncthreads();

    // 4. P*V: thread tid owns column tid of the [R, d] accumulator; rows
    //    below g_lo skip the page (it starts at or past their length).
    if (tid < d) {
      for (int p = 0; p < np; ++p) {
        const int g_lo = group * ((p0 + p) * bs - len + 1);
        float vsc = 1.f;
        if (quant) vsc = v_scale[(size_t)table[p0 + p] * hkv + h];
        float pv[MAX_ROWS];
#pragma unroll
        for (int g = 0; g < MAX_ROWS; ++g) pv[g] = 0.f;
        for (int jj = 0; jj < bs; ++jj) {
          const int j = p * bs + jj;
          const float vv = to_f(v_sh[j * d + tid]);
#pragma unroll
          for (int g = 0; g < MAX_ROWS; ++g)
            if (g < rows && g >= g_lo)
              pv[g] = fmaf(p_sh[g * kRowsKeys + j], vv, pv[g]);
        }
#pragma unroll
        for (int g = 0; g < MAX_ROWS; ++g)
          if (g < rows && g >= g_lo)
            acc[g] = acc_update<KV>(acc[g], c_sh[g * ppt + p], pv[g], vsc);
      }
    }
    __syncthreads();  // the next tile overwrites k_sh, v_sh and p_sh
  }

#pragma unroll
  for (int i = 0; i < kRowsPerWarp; ++i) {
    const int g = warp + i * kRowsWarps;
    if (g < rows && lane == 0) l_sh[g] = l_run[i];
  }
  __syncthreads();
  if (tid < d) {
#pragma unroll
    for (int g = 0; g < MAX_ROWS; ++g) {
      if (g < rows) {
        const float l = l_sh[g];
        out[(((size_t)b * spec + g / group) * hq + (size_t)h * group +
             g % group) * d + tid] = from_f<T>(l > 0.f ? acc[g] / l : 0.f);
      }
    }
  }
}

// Dynamic shared memory of one block of the page walk, in bytes.
template <typename KV>
size_t paged_rows_smem(int rows, int d, int bs) {
  return sizeof(KV) * (size_t)kRowsKeys * (2 * d + vec_of<KV>()) +
         sizeof(float) * ((size_t)rows * d + 2 * (size_t)rows * kRowsKeys +
                          (size_t)rows * (kRowsKeys / bs) + rows);
}

// A kernel's dynamic shared-memory limit belongs to the kernel on a device,
// not to a launch, and serving replicas in one process launch from threads
// of their own. The launchers whose need follows the call's shape (the
// CUDA-core walks: rows, D, bs; the prefill ring: the window's last page)
// therefore raise the limit once per (kernel, device), to all the card
// lets a block have beside the kernel's static shared memory, and never
// set it again: no thread can lower it under another's launch (faults F8,
// F10), and a launch asks only for its own size. `raised` is the caller's
// per-kernel record of the devices done; two threads that race on a first
// call both set the same value.
template <typename Kernel>
cudaError_t raise_smem_limit(Kernel* kernel,
                             std::atomic<unsigned long long>& raised) {
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  const unsigned long long bit = 1ull << (dev & 63);
  if (raised.load(std::memory_order_acquire) & bit) return cudaSuccess;
  int optin = 0;
  e = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                             dev);
  if (e != cudaSuccess) return e;
  cudaFuncAttributes attr;
  e = cudaFuncGetAttributes(&attr, kernel);
  if (e != cudaSuccess) return e;
  e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           optin - (int)attr.sharedSizeBytes);
  if (e == cudaSuccess) raised.fetch_or(bit, std::memory_order_release);
  return e;
}

// Whether the walk takes these shapes (the bindings check them first).
template <typename KV>
bool paged_rows_shapes_ok(int rows, int max_rows, int d, int bs,
                          const void* k_scale, const void* v_scale) {
  constexpr int vec = vec_of<KV>();
  if (rows < 1 || rows > max_rows || d < vec || d > kRowsMaxDim ||
      d % vec != 0 || bs < 1 || bs > 32 || kRowsKeys % bs != 0)
    return false;
  return !is_quant<KV>() || (k_scale != nullptr && v_scale != nullptr);
}

}  // namespace

// ---------------------------------------------------------------------------
// The span walk: the decode and verify kernels on the tensor cores.
//
// The key axis is cut into spans of TK8S_PAGED_SPAN keys, fixed by
// position (span s holds keys s * SPAN .. (s + 1) * SPAN - 1). The value
// is defined once, as ops/_kernels.py PAGED_SPAN_KEYS, and reaches this
// file as -DTK8S_PAGED_SPAN=...; the wrapper sizes the grid and the
// workspace by it and the plain version restarts its running max at it.
// A span is never chosen from the lengths, the batch or the row count, so
// a verify row meets the same spans as the decode row at its length.
//
// One block per (sequence b, KV head h, span s): grid (B, Hkv, ceil(T bs /
// SPAN)); a block whose span starts at or past its sequence's longest row
// exits at once (span 0 always runs, so a length-0 slot still writes its
// zeros). Rows are (stagger, group member) as in paged_rows_body, padded
// with zero queries to 16 (MT = 1) or 32 (MT = 2). Each live block runs the
// reference's per-page online softmax over its span from fresh state (m =
// NEG_INF, l = 0, acc = 0). If the sequence has one live span the block
// writes acc / l itself; otherwise it writes its rows' f32 (m, l, acc) to
// the workspace, and the last of the sequence's live blocks to arrive (a
// per-(b, h) counter: __threadfence, then atomicAdd) merges each row over
// the spans below that row's length, in increasing order, writes acc / l
// and sets the counter back to 0. One launch per call. The counters are
// zeroed once, when the wrapper creates them, and shared by every call on
// the device: calls must not overlap, i.e. one stream at a time.
//
// Four warps. Keys move through a ring of two stages of 64 keys (K and V,
// 16-byte cp.async copies into rows padded by 16 bytes so that ldmatrix
// and the 8-bit fragment loads are free of bank conflicts); the next
// stage's copies are in flight while a stage is computed. Per stage:
//   1. warp w scores keys 16 w .. 16 w + 15 of the stage against every row
//      with mma.sync m16n8k16 (bf16 in, f32 accumulate; 8-bit K converted
//      to bf16, exactly), then (dot * D^-0.5) * k_scale, masked to NEG_INF
//      past each row's length, and its rows' chunk maxima;
//   2. each warp walks the stage's page maxima in order for the running
//      max m of every page, takes p = exp(s - m) of its chunk (0 where
//      masked), the chunk's row sums of the f32 p, and stores p as the
//      bf16 A operand of P*V: rounded on bf16 pools, as the reference does
//      (p.astype(v.dtype)); split into hi + lo bf16 on 8-bit pools, where
//      the reference keeps p in f32 (|p - hi - lo| <= 2^-16 p);
//   3. warp w owns D / 4 output columns of every row and walks the stage's
//      pages in order: pv = P_page V_page into fresh accumulators (a page
//      of 16 keys is one k-step; 8-bit: P_hi V + P_lo V), then, for each
//      row the page is live for, acc = fmaf(acc, corr, pv) (pv * v_scale
//      by __fmul_rn on 8-bit pools) and l = fmaf(l, corr, sum p).
// mma.sync and not wgmma: the kernels are bound by bytes, and their 4-32
// rows are far below wgmma's 64-row tile.
//
// Bits: an mma's row does not see its tile's other rows, and every
// per-row step -- the scores, the quad max and sum, p's rounding, the fmaf
// recurrences, the merge -- is the same sequence of f32 operations in the
// decode and the verify kernel. A page past a row's length leaves that
// row's (m, l, acc) as they were, and a row with one live span is written
// as acc / l from that span's state whether the block merged or not. So
// verify row j is bitwise decode at length len + j.
#ifndef TK8S_PAGED_SPAN
#error "build with -DTK8S_PAGED_SPAN=<keys> (ops/_kernels.py PAGED_SPAN_KEYS)"
#endif

// Variant codes of the decode and verify C entries (ops/_kernels.py
// PAGED_VARIANTS): the CUDA-core walk above, or the span walk.
#define TK8S_PAGED_CUDA_CORE 0
#define TK8S_PAGED_TENSOR_CORE 1

namespace {

constexpr int kSpanKeys = TK8S_PAGED_SPAN;
constexpr int kSpanWarps = 4;
constexpr int kSpanThreads = 32 * kSpanWarps;
constexpr int kChunkKeys = 16;  // keys a warp scores a stage: one k-step
constexpr int kStageKeys = kSpanWarps * kChunkKeys;  // keys a ring stage
constexpr int kPRow = kChunkKeys + 8;  // bf16 stride of a P row: 48 bytes
static_assert(kSpanKeys % kStageKeys == 0, "a span is whole ring stages");

// Spans of a block table of tw pages of bs keys (the grid's z extent; one
// at least, so that an empty table still writes its zeros).
__host__ __device__ constexpr int paged_span_count(int tw, int bs) {
  return tw * bs > kSpanKeys ? (tw * bs + kSpanKeys - 1) / kSpanKeys : 1;
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

// 16-byte cp.async that zero-fills the destination when !live.
__device__ __forceinline__ void cp_async16_zfill(void* smem, const void* gmem,
                                                 bool live) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_u32(smem)),
               "l"(gmem), "r"(live ? 16 : 0));
}

// The mma.sync helpers of decode_gemm.cu.
__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], uint32_t addr) {
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

// Two floats as one bf16x2 register (lo in the low half: the element of
// the smaller index in an mma fragment).
__device__ __forceinline__ uint32_t pack_bf16x2(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// Two 8-bit page values as a bf16x2 operand; exact, since every int8 and
// every e4m3 value is a bf16 value.
template <typename KV>
__device__ __forceinline__ uint32_t bf16x2_of(KV lo, KV hi) {
  return pack_bf16x2(to_f(lo), to_f(hi));
}

// Shared memory of one block of the span walk, in bytes: the query tile,
// the ring (two stages of K and V), P (hi, and lo on 8-bit pools), the
// row statistics, and the span's page ids and scales.
template <typename KV, int D, int MT>
struct SpanSmem {
  static constexpr int kRows = 16 * MT;
  static constexpr int kQStride = D + 8;                       // bf16
  static constexpr int kKVStride = D + 16 / (int)sizeof(KV);   // page type
  static constexpr int kQBytes = kRows * kQStride * 2;
  static constexpr int kTileBytes = kStageKeys * kKVStride * (int)sizeof(KV);
  static constexpr int kRingBytes = 2 * 2 * kTileBytes;
  static constexpr int kPBytes =
      (is_quant<KV>() ? 2 : 1) * kSpanWarps * kRows * kPRow * 2;
  // chunk maxima and sums [4][kRows], page corrections [<= 4][kRows]
  static constexpr int kStatBytes = (2 * kSpanWarps + 4) * kRows * 4;
  // page ids, K and V scales of the span's pages (bs >= 16), a flag
  static constexpr int kPageBytes = 3 * (kSpanKeys / 16) * 4 + 16;
  static constexpr int kBytes =
      kQBytes + kRingBytes + kPBytes + kStatBytes + kPageBytes;
};

template <typename KV, int D, int BS, int MT>
__device__ __forceinline__ void paged_span_body(
    unsigned char* smem_raw, const __nv_bfloat16* __restrict__ q,
    const KV* __restrict__ k_pages, const KV* __restrict__ v_pages,
    const float* __restrict__ k_scale, const float* __restrict__ v_scale,
    const int* __restrict__ block_tables, const int* __restrict__ lengths,
    __nv_bfloat16* __restrict__ out, float* __restrict__ ws,
    int* __restrict__ counters, int hkv, int group, int spec, int tw,
    float scale) {
  using L = SpanSmem<KV, D, MT>;
  constexpr bool quant = is_quant<KV>();
  constexpr int kRows = L::kRows;
  constexpr int KVS = L::kKVStride;
  constexpr int KD = D / 16;                    // k-steps of a score
  constexpr int NTW = D / 8 / kSpanWarps;       // P*V column tiles a warp
  constexpr int PPS = kStageKeys / BS;          // pages a stage
  constexpr int CPP = BS / kChunkKeys;          // chunks a page
  constexpr int CPR = D * (int)sizeof(KV) / 16;  // 16-byte copies a row
  constexpr int VEC = 16 / (int)sizeof(KV);
  static_assert(NTW % 2 == 0 && BS % kChunkKeys == 0 &&
                    kStageKeys % BS == 0 && PPS <= 4,
                "span walk: D a multiple of 64, bs 16, 32 or 64");

  const int b = blockIdx.x, h = blockIdx.y, sp = blockIdx.z;
  const int nsp = gridDim.z;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t4 = lane & 3;
  const int rows = spec * group, hq = hkv * group;
  const int cap = tw * BS;  // keys the table covers
  const int len = lengths[b];
  const int max_len = min(len + spec - 1, cap);  // the longest row's length
  const int n_live = max(1, (max_len + kSpanKeys - 1) / kSpanKeys);
  if (sp >= n_live) return;
  const int k0 = sp * kSpanKeys;
  const int n_keys = max(0, min(kSpanKeys, max_len - k0));
  const int n_pages = (n_keys + BS - 1) / BS;
  const int k_end = k0 + n_pages * BS;  // whole pages are copied
  const int n_stages = (n_keys + kStageKeys - 1) / kStageKeys;

  __nv_bfloat16* q_sh = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  KV* ring = reinterpret_cast<KV*>(smem_raw + L::kQBytes);
  __nv_bfloat16* p_hi =
      reinterpret_cast<__nv_bfloat16*>(smem_raw + L::kQBytes + L::kRingBytes);
  __nv_bfloat16* p_lo = p_hi + kSpanWarps * kRows * kPRow;  // 8-bit pools
  float* cmax = reinterpret_cast<float*>(smem_raw + L::kQBytes +
                                         L::kRingBytes + L::kPBytes);
  float* csum = cmax + kSpanWarps * kRows;
  float* corr = csum + kSpanWarps * kRows;  // [PPS][kRows]
  int* tbl = reinterpret_cast<int*>(corr + 4 * kRows);
  float* ksc = reinterpret_cast<float*>(tbl + kSpanKeys / 16);
  float* vsc = ksc + kSpanKeys / 16;
  int* flag = reinterpret_cast<int*>(vsc + kSpanKeys / 16);

  const int* table = block_tables + (size_t)b * tw;
  for (int i = tid; i < n_pages; i += kSpanThreads) {
    const int page = table[k0 / BS + i];
    tbl[i] = page;
    if (quant) {
      ksc[i] = k_scale[(size_t)page * hkv + h];
      vsc[i] = v_scale[(size_t)page * hkv + h];
    }
  }
  for (int i = tid; i < kRows * (D / 8); i += kSpanThreads) {
    const int r = i / (D / 8), c = (i % (D / 8)) * 8;
    uint4 v = make_uint4(0u, 0u, 0u, 0u);
    if (r < rows)
      v = *reinterpret_cast<const uint4*>(
          q + (((size_t)b * spec + r / group) * hq + (size_t)h * group +
               r % group) * D + c);
    *reinterpret_cast<uint4*>(q_sh + r * L::kQStride + c) = v;
  }
  __syncthreads();

  // Stage st's K and V rows into ring slot st % 2; keys past the span's
  // last page are zero-filled.
  auto stage_copies = [&](int st) {
    KV* kd = ring + (size_t)(2 * (st & 1)) * kStageKeys * KVS;
    KV* vd = kd + kStageKeys * KVS;
    const int ks = k0 + st * kStageKeys;
    for (int i = tid; i < kStageKeys * CPR; i += kSpanThreads) {
      const int j = i / CPR, c = (i % CPR) * VEC;
      const int key = ks + j;
      const bool live = key < k_end;
      size_t src = 0;
      if (live)
        src = (((size_t)tbl[(key - k0) / BS] * hkv + h) * BS + key % BS) * D +
              c;
      cp_async16_zfill(kd + j * KVS + c, k_pages + src, live);
      cp_async16_zfill(vd + j * KVS + c, v_pages + src, live);
    }
    asm volatile("cp.async.commit_group;\n" ::: "memory");
  };
  if (n_stages > 0) stage_copies(0);

  // The query rows as A fragments, for the whole span.
  uint32_t qa[MT][KD][4];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int kk = 0; kk < KD; ++kk)
      ldmatrix_x4(qa[mt][kk],
                  smem_u32(q_sh +
                           (mt * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) *
                               L::kQStride +
                           kk * 16 + (lane >> 4) * 8));

  // This thread's rows: mt * 16 + g + 8 hf; their lengths (0: padding).
  int rlen[MT][2];
  float m_run[MT][2], l_run[MT][2], acc[MT][NTW][4];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      const int r = mt * 16 + g + 8 * hf;
      rlen[mt][hf] = r < rows ? min(len + r / group, cap) : 0;
      m_run[mt][hf] = TK8S_NEG_INF;
      l_run[mt][hf] = 0.f;
    }
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int nt = 0; nt < NTW; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mt][nt][e] = 0.f;

  const int pw = warp * kChunkKeys / BS;  // this warp's page in a stage
  const bool page_head = (warp * kChunkKeys) % BS == 0;
  for (int st = 0; st < n_stages; ++st) {
    asm volatile("cp.async.wait_group 0;\n" ::: "memory");
    __syncthreads();  // stage st has landed; stage st - 1 is done with
    if (st + 1 < n_stages) stage_copies(st + 1);
    const KV* kt = ring + (size_t)(2 * (st & 1)) * kStageKeys * KVS;
    const KV* vt = kt + kStageKeys * KVS;
    const int ks = k0 + st * kStageKeys;  // first key of the stage
    const int kc0 = ks + warp * kChunkKeys;  // first key of this chunk

    // 1. Scores of this warp's chunk against every row.
    float s[MT][2][4];
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int nt = 0; nt < 2; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[mt][nt][e] = 0.f;
    const KV* kc = kt + (warp * kChunkKeys) * KVS;
#pragma unroll
    for (int kk = 0; kk < KD; ++kk) {
      uint32_t bk[2][2];
      if constexpr (quant) {
#pragma unroll
        for (int nt = 0; nt < 2; ++nt) {
          const KV* row = kc + (nt * 8 + g) * KVS + kk * 16 + 2 * t4;
          bk[nt][0] = bf16x2_of(row[0], row[1]);
          bk[nt][1] = bf16x2_of(row[8], row[9]);
        }
      } else {
        uint32_t r4[4];
        ldmatrix_x4(r4, smem_u32(kc + ((lane & 7) + (lane >> 4) * 8) * KVS +
                                 kk * 16 + ((lane >> 3) & 1) * 8));
        bk[0][0] = r4[0];
        bk[0][1] = r4[1];
        bk[1][0] = r4[2];
        bk[1][1] = r4[3];
      }
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
        mma16816(s[mt][0], qa[mt][kk], bk[0][0], bk[0][1]);
        mma16816(s[mt][1], qa[mt][kk], bk[1][0], bk[1][1]);
      }
    }
    // Past the last page the chunk is zeros, masked for every row; its
    // page's K scale is then never read.
    const float kscale =
        quant && kc0 < k_end ? ksc[(kc0 - k0) / BS] : 1.f;
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int nt = 0; nt < 2; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int key = kc0 + nt * 8 + 2 * t4 + (e & 1);
          float x = __fmul_rn(s[mt][nt][e], scale);
          if (quant) x = __fmul_rn(x, kscale);
          s[mt][nt][e] = key < rlen[mt][e >> 1] ? x : TK8S_NEG_INF;
        }
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int hf = 0; hf < 2; ++hf) {
        float mx = fmaxf(fmaxf(s[mt][0][2 * hf], s[mt][0][2 * hf + 1]),
                         fmaxf(s[mt][1][2 * hf], s[mt][1][2 * hf + 1]));
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
        if (t4 == 0) cmax[warp * kRows + mt * 16 + g + 8 * hf] = mx;
      }
    __syncthreads();

    // 2. The running max at every page of the stage, in page order; p of
    //    this warp's chunk against its page's max; row sums; P operands.
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int hf = 0; hf < 2; ++hf) {
        const int r = mt * 16 + g + 8 * hf;
        float m_cur = m_run[mt][hf], m_prev = m_cur, m_new = m_cur;
#pragma unroll
        for (int pg = 0; pg < PPS; ++pg) {
          float pm = TK8S_NEG_INF;
#pragma unroll
          for (int c = 0; c < CPP; ++c)
            pm = fmaxf(pm, cmax[(pg * CPP + c) * kRows + r]);
          const float m_after = fmaxf(m_cur, pm);
          if (pg == pw) {
            m_prev = m_cur;
            m_new = m_after;
          }
          m_cur = m_after;
        }
        m_run[mt][hf] = m_cur;
        float p[2][2];
#pragma unroll
        for (int nt = 0; nt < 2; ++nt)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int key = kc0 + nt * 8 + 2 * t4 + e;
            p[nt][e] = key < rlen[mt][hf]
                           ? expf(s[mt][nt][2 * hf + e] - m_new)
                           : 0.f;
          }
        float sum = (p[0][0] + p[0][1]) + (p[1][0] + p[1][1]);
        sum += __shfl_xor_sync(0xffffffffu, sum, 1);
        sum += __shfl_xor_sync(0xffffffffu, sum, 2);
        if (t4 == 0) {
          csum[warp * kRows + r] = sum;
          if (page_head) corr[pw * kRows + r] = expf(m_prev - m_new);
        }
#pragma unroll
        for (int nt = 0; nt < 2; ++nt) {
          const int off = (warp * kRows + r) * kPRow + nt * 8 + 2 * t4;
          const __nv_bfloat162 hi = __floats2bfloat162_rn(p[nt][0], p[nt][1]);
          *reinterpret_cast<__nv_bfloat162*>(p_hi + off) = hi;
          if (quant)
            *reinterpret_cast<__nv_bfloat162*>(p_lo + off) =
                __floats2bfloat162_rn(p[nt][0] - __low2float(hi),
                                      p[nt][1] - __high2float(hi));
        }
      }
    __syncthreads();

    // 3. P*V page by page into this warp's columns, then the per-page
    //    recurrence of every row the page is live for.
    const int n_end = k0 + n_keys;
#pragma unroll
    for (int pg = 0; pg < PPS; ++pg) {
      const int pstart = ks + pg * BS;
      if (pstart >= n_end) break;
      float pv[MT][NTW][4];
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
#pragma unroll
        for (int nt = 0; nt < NTW; ++nt)
#pragma unroll
          for (int e = 0; e < 4; ++e) pv[mt][nt][e] = 0.f;
#pragma unroll
      for (int c = 0; c < CPP; ++c) {
        const int ch = pg * CPP + c;
        uint32_t pa[MT][4], pl[MT][4];
#pragma unroll
        for (int mt = 0; mt < MT; ++mt) {
          const int off =
              (ch * kRows + mt * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) *
                  kPRow +
              (lane >> 4) * 8;
          ldmatrix_x4(pa[mt], smem_u32(p_hi + off));
          if (quant) ldmatrix_x4(pl[mt], smem_u32(p_lo + off));
        }
        const KV* vc = vt + (ch * kChunkKeys) * KVS;
#pragma unroll
        for (int np = 0; np < NTW / 2; ++np) {
          const int n0 = warp * (D / kSpanWarps) + np * 16;
          uint32_t bv[2][2];
          if constexpr (quant) {
#pragma unroll
            for (int j = 0; j < 2; ++j) {
              const KV* col = vc + n0 + j * 8 + g;
              bv[j][0] = bf16x2_of(col[(2 * t4) * KVS], col[(2 * t4 + 1) * KVS]);
              bv[j][1] = bf16x2_of(col[(2 * t4 + 8) * KVS],
                                   col[(2 * t4 + 9) * KVS]);
            }
          } else {
            uint32_t r4[4];
            ldmatrix_x4_trans(
                r4, smem_u32(vc + ((lane & 7) + ((lane >> 3) & 1) * 8) * KVS +
                             n0 + (lane >> 4) * 8));
            bv[0][0] = r4[0];
            bv[0][1] = r4[1];
            bv[1][0] = r4[2];
            bv[1][1] = r4[3];
          }
#pragma unroll
          for (int mt = 0; mt < MT; ++mt)
#pragma unroll
            for (int j = 0; j < 2; ++j) {
              mma16816(pv[mt][2 * np + j], pa[mt], bv[j][0], bv[j][1]);
              if (quant)
                mma16816(pv[mt][2 * np + j], pl[mt], bv[j][0], bv[j][1]);
            }
        }
      }
      const float vs = quant ? vsc[(pstart - k0) / BS] : 1.f;
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
#pragma unroll
        for (int hf = 0; hf < 2; ++hf) {
          if (pstart >= rlen[mt][hf]) continue;  // past this row's length
          const int r = mt * 16 + g + 8 * hf;
          const float cr = corr[pg * kRows + r];
          float ps = csum[(pg * CPP) * kRows + r];
#pragma unroll
          for (int c = 1; c < CPP; ++c) ps += csum[(pg * CPP + c) * kRows + r];
          l_run[mt][hf] = fmaf(l_run[mt][hf], cr, ps);
#pragma unroll
          for (int nt = 0; nt < NTW; ++nt)
#pragma unroll
            for (int e = 2 * hf; e < 2 * hf + 2; ++e)
              acc[mt][nt][e] =
                  quant ? fmaf(acc[mt][nt][e], cr, __fmul_rn(pv[mt][nt][e], vs))
                        : fmaf(acc[mt][nt][e], cr, pv[mt][nt][e]);
        }
    }
  }

  // Accumulator element (mt, nt, e): row mt * 16 + g + 8 (e / 2), column
  // col0 + 8 nt + e % 2.
  const int col0 = warp * (D / kSpanWarps) + 2 * t4;
  if (n_live == 1) {  // the only span: write acc / l
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int hf = 0; hf < 2; ++hf) {
        const int r = mt * 16 + g + 8 * hf;
        if (r >= rows) continue;
        const float l = l_run[mt][hf];
        __nv_bfloat16* o = out + (((size_t)b * spec + r / group) * hq +
                                  (size_t)h * group + r % group) * D + col0;
#pragma unroll
        for (int nt = 0; nt < NTW; ++nt)
          *reinterpret_cast<__nv_bfloat162*>(o + nt * 8) =
              __floats2bfloat162_rn(
                  l > 0.f ? acc[mt][nt][2 * hf] / l : 0.f,
                  l > 0.f ? acc[mt][nt][2 * hf + 1] / l : 0.f);
      }
    return;
  }

  // Workspace: acc [B][Hkv][nsp][rows][D], then (m, l) [B][Hkv][nsp][rows].
  const size_t bh = (size_t)b * hkv + h;
  const size_t slots = (size_t)gridDim.x * hkv * nsp * rows;
  float* ws_acc = ws + bh * nsp * rows * D;
  float* ws_ml = ws + slots * D + bh * nsp * rows * 2;
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      const int r = mt * 16 + g + 8 * hf;
      if (r >= rows) continue;
      float* a = ws_acc + ((size_t)sp * rows + r) * D + col0;
#pragma unroll
      for (int nt = 0; nt < NTW; ++nt)
        *reinterpret_cast<float2*>(a + nt * 8) =
            make_float2(acc[mt][nt][2 * hf], acc[mt][nt][2 * hf + 1]);
      if (warp == 0 && t4 == 0)
        *reinterpret_cast<float2*>(ws_ml + ((size_t)sp * rows + r) * 2) =
            make_float2(m_run[mt][hf], l_run[mt][hf]);
    }
  __threadfence();
  __syncthreads();
  if (tid == 0) *flag = atomicAdd(counters + bh, 1) == n_live - 1;
  __syncthreads();
  if (!*flag) return;
  __threadfence();
  if (tid == 0) counters[bh] = 0;  // ready for the next call

  // The last block merges each row over the spans below its length.
  for (int i = tid; i < rows * (D / 4); i += kSpanThreads) {
    const int r = i / (D / 4), c = (i % (D / 4)) * 4;
    const int ns = (min(len + r / group, cap) + kSpanKeys - 1) / kSpanKeys;
    float4 a = make_float4(0.f, 0.f, 0.f, 0.f);
    float l = 0.f;
    if (ns > 0) {
      a = __ldcg(reinterpret_cast<const float4*>(ws_acc + (size_t)r * D + c));
      const float2 ml0 =
          __ldcg(reinterpret_cast<const float2*>(ws_ml + (size_t)r * 2));
      float m = ml0.x;
      l = ml0.y;
      for (int s2 = 1; s2 < ns; ++s2) {
        const float4 as = __ldcg(reinterpret_cast<const float4*>(
            ws_acc + ((size_t)s2 * rows + r) * D + c));
        const float2 ml = __ldcg(reinterpret_cast<const float2*>(
            ws_ml + ((size_t)s2 * rows + r) * 2));
        const float mn = fmaxf(m, ml.x);
        const float co = expf(m - mn), cs = expf(ml.x - mn);
        l = fmaf(l, co, __fmul_rn(ml.y, cs));
        a.x = fmaf(a.x, co, __fmul_rn(as.x, cs));
        a.y = fmaf(a.y, co, __fmul_rn(as.y, cs));
        a.z = fmaf(a.z, co, __fmul_rn(as.z, cs));
        a.w = fmaf(a.w, co, __fmul_rn(as.w, cs));
        m = mn;
      }
    }
    __nv_bfloat16* o = out + (((size_t)b * spec + r / group) * hq +
                              (size_t)h * group + r % group) * D + c;
    uint2 packed;
    packed.x = pack_bf16x2(l > 0.f ? a.x / l : 0.f, l > 0.f ? a.y / l : 0.f);
    packed.y = pack_bf16x2(l > 0.f ? a.z / l : 0.f, l > 0.f ? a.w / l : 0.f);
    *reinterpret_cast<uint2*>(o) = packed;
  }
}

}  // namespace

// The six (q dtype, page dtype) pairs of every paged kernel's C entries:
// ENTRY(suffix, T, KV) is expanded once per pair. A source that
// ops/_kernels.py (UNITS) builds as three translation units in parallel,
// -DTK8S_UNIT=0..2, holds one page kind's pairs in each: the unquantized
// pages, int8, fp8. Without TK8S_UNIT one unit holds every pair.
#define TK8S_PAGED_DTYPES_SAME(ENTRY)       \
  ENTRY(bf16, __nv_bfloat16, __nv_bfloat16) \
  ENTRY(f32, float, float)
#define TK8S_PAGED_DTYPES_INT8(ENTRY)     \
  ENTRY(bf16_int8, __nv_bfloat16, int8_t) \
  ENTRY(f32_int8, float, int8_t)
#define TK8S_PAGED_DTYPES_FP8(ENTRY)             \
  ENTRY(bf16_fp8, __nv_bfloat16, __nv_fp8_e4m3) \
  ENTRY(f32_fp8, float, __nv_fp8_e4m3)
#if !defined(TK8S_UNIT)
#define TK8S_PAGED_DTYPES(ENTRY) \
  TK8S_PAGED_DTYPES_SAME(ENTRY)  \
  TK8S_PAGED_DTYPES_INT8(ENTRY)  \
  TK8S_PAGED_DTYPES_FP8(ENTRY)
#elif TK8S_UNIT == 0
#define TK8S_PAGED_DTYPES(ENTRY) TK8S_PAGED_DTYPES_SAME(ENTRY)
#elif TK8S_UNIT == 1
#define TK8S_PAGED_DTYPES(ENTRY) TK8S_PAGED_DTYPES_INT8(ENTRY)
#else
#define TK8S_PAGED_DTYPES(ENTRY) TK8S_PAGED_DTYPES_FP8(ENTRY)
#endif

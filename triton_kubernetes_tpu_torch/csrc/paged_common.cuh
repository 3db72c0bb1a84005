// Device code shared by the paged-attention kernels (paged_decode.cu,
// paged_verify.cu, paged_prefill.cu): dtype conversion, 16-byte async
// copies into shared memory, warp reductions, the per-page online-softmax
// row update, and the whole page walk of the decode and verify kernels.
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

// One row's online-softmax step over one page, by one thread (the prefill
// kernel's). `s` holds the page's n scores, `p` receives exp(s - m_new),
// rounded to T unless the pool is quantized; m, l and corr are this row's
// running state.
template <typename T, typename KV>
__device__ __forceinline__ void softmax_row_update(const float* s, float* p,
                                                   int n, float* m, float* l,
                                                   float* corr) {
  const float m_prev = *m;
  float m_cur = TK8S_NEG_INF;
  for (int j = 0; j < n; ++j) m_cur = fmaxf(m_cur, s[j]);
  const float m_new = fmaxf(m_prev, m_cur);
  float sum = 0.f;
  for (int j = 0; j < n; ++j) {
    const float e = expf(s[j] - m_new);
    sum += e;
    p[j] = is_quant<KV>() ? e : round_to<T>(e);
  }
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

// The six (q dtype, page dtype) pairs of every paged kernel's C entries:
// ENTRY(suffix, T, KV) is expanded once per pair.
#define TK8S_PAGED_DTYPES(ENTRY)      \
  ENTRY(bf16, __nv_bfloat16, __nv_bfloat16) \
  ENTRY(f32, float, float)                  \
  ENTRY(bf16_int8, __nv_bfloat16, int8_t)   \
  ENTRY(bf16_fp8, __nv_bfloat16, __nv_fp8_e4m3) \
  ENTRY(f32_int8, float, int8_t)            \
  ENTRY(f32_fp8, float, __nv_fp8_e4m3)

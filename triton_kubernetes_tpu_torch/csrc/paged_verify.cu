// Speculative-verify paged attention for Hopper (sm_90a).
//
// Replaces: the TPU kernel `_verify_kernel`
//   (triton_kubernetes_tpu/ops/paged_attention.py:756, launched by
//   `_ragged_verify_attention_pallas` at :821), unquantized and quantized
//   (int8/fp8 pages with per-(page, head) scales, :793-794 and :805-810).
//
// Computes: S staggered queries per sequence. Row j of sequence b sits at
//   position lengths[b] - 1 + j and attends the keys at positions up to its
//   own, so it sees the draft tokens of rows < j and none of rows > j.
//   q [B, S, Hq, D], pages [N, Hkv, bs, D] (q's dtype, or int8/fp8 with f32
//   scales [N, Hkv]), block_tables [B, T] int32, lengths [B] int32 (tokens
//   written, row 0's included). Out [B, S, Hq, D].
//
// The contract: row j equals, bit for bit, paged_decode.cu at length
//   lengths[b] + j on the same pool. Both kernels run the same page walk of
//   paged_common.cuh on the same ops/_kernels.py PAGED_TENSOR_CORE entry --
//   this one with spec = S, decode with spec = 1. A row skips the pages at
//   or past its own length (the TPU kernel relies on a fully masked page
//   being an exact no-op of the online softmax; skipping it is the same
//   result without the work), and every per-row operation is the same
//   sequence of f32 operations in both; on the tensor-core design a row
//   merges only the spans below its own length, so a row whose stagger
//   crosses a span boundary still gets decode's bits.
//
// What bounds it on this card: bytes, as decode. The pages of the longest
//   row, ceil((len + S - 1) / bs), are read once for all S * group rows;
//   the work is 4*D FLOPs per (row, attended key), ~16 FLOPs per byte at
//   S 4 and group 4 -- still far below the ~295 FLOPs/byte of the ridge.
//   The first design sat far above its bound for latency and serial work:
//   64 blocks at batch 8, and each thread ran a 16-row x D fmaf chain per
//   key with P*V one column a thread.
//
// What the design does about it: one block per (sequence, KV head, span)
//   stages each K/V page once and scores it against all R = S * group rows,
//   so speculation costs extra FLOPs on pages already in shared memory, not
//   extra page reads; on the tensor-core design (bf16 queries at D 64/128,
//   bs 16/32) both products are mma.sync over 16 or 32 padded rows, the
//   spans spread a long sequence over many SMs and the next 64 keys are in
//   flight while the current ones are computed. The CUDA-core design (f32
//   queries, other shapes) is one block per (sequence, KV head), rows
//   instantiated for up to 16 and up to 32. Both take at most 32 rows
//   (spec_k <= 7 at group 4); the binding refuses more.
#include <type_traits>

#include "paged_common.cuh"

namespace {

template <typename T, typename KV, int MAX_ROWS>
__global__ void __launch_bounds__(kRowsThreads)
paged_verify_kernel(const T* __restrict__ q, const KV* __restrict__ k_pages,
                    const KV* __restrict__ v_pages,
                    const float* __restrict__ k_scale,
                    const float* __restrict__ v_scale,
                    const int* __restrict__ block_tables,
                    const int* __restrict__ lengths, T* __restrict__ out,
                    int hkv, int group, int spec, int d, int bs, int tw,
                    float scale) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  paged_rows_body<T, KV, MAX_ROWS>(smem_raw, q, k_pages, v_pages, k_scale,
                                   v_scale, block_tables, lengths, out, hkv,
                                   group, spec, d, bs, tw, scale);
}

template <typename KV, int D, int BS, int MT>
__global__ void __launch_bounds__(kSpanThreads, 2)
paged_verify_span_kernel(const __nv_bfloat16* __restrict__ q,
                         const KV* __restrict__ k_pages,
                         const KV* __restrict__ v_pages,
                         const float* __restrict__ k_scale,
                         const float* __restrict__ v_scale,
                         const int* __restrict__ block_tables,
                         const int* __restrict__ lengths,
                         __nv_bfloat16* __restrict__ out,
                         float* __restrict__ ws, int* __restrict__ counters,
                         int hkv, int group, int spec, int tw, float scale) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  paged_span_body<KV, D, BS, MT>(smem_raw, q, k_pages, v_pages, k_scale,
                                 v_scale, block_tables, lengths, out, ws,
                                 counters, hkv, group, spec, tw, scale);
}

template <typename T, typename KV, int MAX_ROWS>
int launch_rows(const void* q, const void* k_pages, const void* v_pages,
                const void* k_scale, const void* v_scale,
                const void* block_tables, const void* lengths, void* out,
                int b, int spec, int hkv, int group, int d, int bs, int tw,
                float scale, void* stream) {
  const size_t smem = paged_rows_smem<KV>(spec * group, d, bs);
  static std::atomic<unsigned long long> raised{0};
  cudaError_t e =
      raise_smem_limit(paged_verify_kernel<T, KV, MAX_ROWS>, raised);
  if (e != cudaSuccess) return (int)e;
  dim3 grid(b, hkv);
  paged_verify_kernel<T, KV, MAX_ROWS><<<grid, kRowsThreads, smem,
                                         (cudaStream_t)stream>>>(
      (const T*)q, (const KV*)k_pages, (const KV*)v_pages,
      (const float*)k_scale, (const float*)v_scale, (const int*)block_tables,
      (const int*)lengths, (T*)out, hkv, group, spec, d, bs, tw, scale);
  return (int)cudaGetLastError();
}

template <typename KV, int D, int BS, int MT>
int launch_span(const void* q, const void* k_pages, const void* v_pages,
                const void* k_scale, const void* v_scale,
                const void* block_tables, const void* lengths, void* out,
                void* ws, void* counters, int b, int spec, int hkv, int group,
                int tw, float scale, void* stream) {
  const int smem = SpanSmem<KV, D, MT>::kBytes;
  cudaError_t e = cudaFuncSetAttribute(
      paged_verify_span_kernel<KV, D, BS, MT>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return (int)e;
  dim3 grid(b, hkv, paged_span_count(tw, BS));
  paged_verify_span_kernel<KV, D, BS, MT><<<grid, kSpanThreads, smem,
                                            (cudaStream_t)stream>>>(
      (const __nv_bfloat16*)q, (const KV*)k_pages, (const KV*)v_pages,
      (const float*)k_scale, (const float*)v_scale, (const int*)block_tables,
      (const int*)lengths, (__nv_bfloat16*)out, (float*)ws, (int*)counters,
      hkv, group, spec, tw, scale);
  return (int)cudaGetLastError();
}

template <typename KV, int D, int BS>
int launch_span_rows(const void* q, const void* k_pages, const void* v_pages,
                     const void* k_scale, const void* v_scale,
                     const void* block_tables, const void* lengths, void* out,
                     void* ws, void* counters, int b, int spec, int hkv,
                     int group, int tw, float scale, void* stream) {
  if (spec * group <= 16)
    return launch_span<KV, D, BS, 1>(q, k_pages, v_pages, k_scale, v_scale,
                                     block_tables, lengths, out, ws,
                                     counters, b, spec, hkv, group, tw,
                                     scale, stream);
  return launch_span<KV, D, BS, 2>(q, k_pages, v_pages, k_scale, v_scale,
                                   block_tables, lengths, out, ws, counters,
                                   b, spec, hkv, group, tw, scale, stream);
}

template <typename T, typename KV>
int launch(const void* q, const void* k_pages, const void* v_pages,
           const void* k_scale, const void* v_scale,
           const void* block_tables, const void* lengths, void* out,
           void* ws, void* counters, int b, int spec, int hkv, int group,
           int d, int bs, int tw, float scale, int variant, void* stream) {
  const int rows = spec * group;
  if (spec < 1 || group < 1 || rows > 32) return (int)cudaErrorInvalidValue;
  if (variant == TK8S_PAGED_CUDA_CORE) {
    if (!paged_rows_shapes_ok<KV>(rows, 32, d, bs, k_scale, v_scale))
      return (int)cudaErrorInvalidValue;
    if (rows <= 16)
      return launch_rows<T, KV, 16>(q, k_pages, v_pages, k_scale, v_scale,
                                    block_tables, lengths, out, b, spec, hkv,
                                    group, d, bs, tw, scale, stream);
    return launch_rows<T, KV, 32>(q, k_pages, v_pages, k_scale, v_scale,
                                  block_tables, lengths, out, b, spec, hkv,
                                  group, d, bs, tw, scale, stream);
  }
  // The span walk is built for bf16 queries only.
  if constexpr (std::is_same<T, __nv_bfloat16>::value) {
    if (variant != TK8S_PAGED_TENSOR_CORE || ws == nullptr ||
        counters == nullptr ||
        (is_quant<KV>() && (k_scale == nullptr || v_scale == nullptr)))
      return (int)cudaErrorInvalidValue;
#define TK8S_VERIFY_SPAN(DD, BB)                                            \
  if (d == DD && bs == BB)                                                  \
    return launch_span_rows<KV, DD, BB>(q, k_pages, v_pages, k_scale,       \
                                        v_scale, block_tables, lengths, out, \
                                        ws, counters, b, spec, hkv, group,  \
                                        tw, scale, stream);
    TK8S_VERIFY_SPAN(128, 16)
    TK8S_VERIFY_SPAN(128, 32)
    TK8S_VERIFY_SPAN(64, 16)
    TK8S_VERIFY_SPAN(64, 32)
#undef TK8S_VERIFY_SPAN
  }
  return (int)cudaErrorInvalidValue;
}

}  // namespace

#define TK8S_VERIFY_ENTRY(suffix, T, KV)                                    \
  extern "C" int tk8s_paged_verify_##suffix(                                \
      const void* q, const void* k_pages, const void* v_pages,              \
      const void* k_scale, const void* v_scale, const void* block_tables,   \
      const void* lengths, void* out, void* ws, void* counters, int b,      \
      int spec, int hkv, int group, int d, int bs, int tw, float scale,     \
      int variant, void* stream) {                                          \
    return launch<T, KV>(q, k_pages, v_pages, k_scale, v_scale,             \
                         block_tables, lengths, out, ws, counters, b, spec, \
                         hkv, group, d, bs, tw, scale, variant, stream);    \
  }
TK8S_PAGED_DTYPES(TK8S_VERIFY_ENTRY)

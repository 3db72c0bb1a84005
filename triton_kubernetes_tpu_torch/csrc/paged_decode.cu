// Ragged paged-attention decode for Hopper (sm_90a).
//
// Replaces: the TPU kernel `_ragged_decode_kernel`
//   (triton_kubernetes_tpu/ops/paged_attention.py:461, launched by
//   `_ragged_paged_attention_pallas` at :541), unquantized and quantized
//   (int8/fp8 pages with per-(page, head) scales, :507-511 and :522-527).
//
// Computes: one decode query per sequence attends to that sequence's pages.
//   q [B, 1, Hq, D], pages [N, Hkv, bs, D] (one layer's slice of the pool;
//   q's dtype, or int8/fp8 with f32 scales [N, Hkv]), block_tables [B, T]
//   int32, lengths [B] int32 (tokens written, this one included). Head h =
//   kv_head * group + g. Keys at positions >= length are masked with
//   NEG_INF; a sequence of length 0 writes 0.
//
// What bounds it on this card: bytes. Each (sequence, KV head) reads its
//   ceil(len/bs) pages of K and V once and does 4*D FLOPs per (query row,
//   key) -- with group 4 that is ~4 FLOPs per byte read (~8 on 8-bit
//   pages), far below the ~295 FLOPs/byte where an H100 becomes compute
//   bound. What kept the first design far from that bound was latency and
//   serial work, not bandwidth: one block per (sequence, KV head) -- 64
//   blocks on 132 SMs at batch 8 -- walked its longest sequence alone, four
//   warps a block scored one key a thread with an fmaf chain over D, and a
//   tile's copies, scores, softmax and P*V ran back to back.
//
// Two designs, picked per call by ops/_kernels.py PAGED_TENSOR_CORE (the
//   `variant` argument; an entry refuses a design it is not built for):
// - tensor_core (bf16 queries at D 64/128, bs 16/32, on bf16, int8 and fp8
//   pages): the span walk of paged_common.cuh with one stagger. The key
//   axis is split into fixed spans of TK8S_PAGED_SPAN keys, one block per
//   (sequence, KV head, span), so a long sequence fills many SMs; both
//   products run on mma.sync; the next 64 keys are copied while the
//   current ones are computed; the last block of a (sequence, head) merges
//   the spans in the same launch.
// - cuda_core (f32 queries, other shapes): the page walk of
//   paged_common.cuh (paged_rows_body) with spec = 1, one block per
//   (sequence, KV head), 128 keys a tile staged by 16-byte async copies.
// Verify (paged_verify.cu) runs the same walk on the same table entry, so
// its rows stay bitwise equal to this kernel's.
//
// Rounding order (kept so the plain version can be held tight): q.k in f32
// from q's dtype and K converted exactly, then times D^-0.5 (then times the
// page's K scale); the online softmax runs in f32 per page of bs keys, its
// running max restarting at each span on the tensor-core design; p is
// rounded to V's dtype before P*V on unquantized pools and stays f32 on
// quantized ones (bf16 hi + lo on the tensor cores), whose page sums are
// multiplied by the V scale; acc and l stay f32; the output is acc / l
// where l > 0, else 0, rounded to q's dtype.
#include <type_traits>

#include "paged_common.cuh"

namespace {

constexpr int kMaxGroup = 8;  // query rows per KV head (two per warp)

template <typename T, typename KV>
__global__ void __launch_bounds__(kRowsThreads)
paged_decode_kernel(const T* __restrict__ q, const KV* __restrict__ k_pages,
                    const KV* __restrict__ v_pages,
                    const float* __restrict__ k_scale,
                    const float* __restrict__ v_scale,
                    const int* __restrict__ block_tables,
                    const int* __restrict__ lengths, T* __restrict__ out,
                    int hkv, int group, int d, int bs, int tw, float scale) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  paged_rows_body<T, KV, kMaxGroup>(smem_raw, q, k_pages, v_pages, k_scale,
                                    v_scale, block_tables, lengths, out, hkv,
                                    group, 1, d, bs, tw, scale);
}

template <typename KV, int D, int BS>
__global__ void __launch_bounds__(kSpanThreads, 2)
paged_decode_span_kernel(const __nv_bfloat16* __restrict__ q,
                         const KV* __restrict__ k_pages,
                         const KV* __restrict__ v_pages,
                         const float* __restrict__ k_scale,
                         const float* __restrict__ v_scale,
                         const int* __restrict__ block_tables,
                         const int* __restrict__ lengths,
                         __nv_bfloat16* __restrict__ out,
                         float* __restrict__ ws, int* __restrict__ counters,
                         int hkv, int group, int tw, float scale) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  paged_span_body<KV, D, BS, 1>(smem_raw, q, k_pages, v_pages, k_scale,
                                v_scale, block_tables, lengths, out, ws,
                                counters, hkv, group, 1, tw, scale);
}

template <typename KV, int D, int BS>
int launch_span(const void* q, const void* k_pages, const void* v_pages,
                const void* k_scale, const void* v_scale,
                const void* block_tables, const void* lengths, void* out,
                void* ws, void* counters, int b, int hkv, int group, int tw,
                float scale, void* stream) {
  const int smem = SpanSmem<KV, D, 1>::kBytes;
  cudaError_t e = cudaFuncSetAttribute(
      paged_decode_span_kernel<KV, D, BS>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return (int)e;
  dim3 grid(b, hkv, paged_span_count(tw, BS));
  paged_decode_span_kernel<KV, D, BS><<<grid, kSpanThreads, smem,
                                        (cudaStream_t)stream>>>(
      (const __nv_bfloat16*)q, (const KV*)k_pages, (const KV*)v_pages,
      (const float*)k_scale, (const float*)v_scale, (const int*)block_tables,
      (const int*)lengths, (__nv_bfloat16*)out, (float*)ws, (int*)counters,
      hkv, group, tw, scale);
  return (int)cudaGetLastError();
}

template <typename T, typename KV>
int launch(const void* q, const void* k_pages, const void* v_pages,
           const void* k_scale, const void* v_scale,
           const void* block_tables, const void* lengths, void* out,
           void* ws, void* counters, int b, int hkv, int group, int d, int bs,
           int tw, float scale, int variant, void* stream) {
  if (variant == TK8S_PAGED_CUDA_CORE) {
    if (!paged_rows_shapes_ok<KV>(group, kMaxGroup, d, bs, k_scale, v_scale))
      return (int)cudaErrorInvalidValue;
    const size_t smem = paged_rows_smem<KV>(group, d, bs);
    static std::atomic<unsigned long long> raised{0};
    cudaError_t e = raise_smem_limit(paged_decode_kernel<T, KV>, raised);
    if (e != cudaSuccess) return (int)e;
    dim3 grid(b, hkv);
    paged_decode_kernel<T, KV><<<grid, kRowsThreads, smem,
                                 (cudaStream_t)stream>>>(
        (const T*)q, (const KV*)k_pages, (const KV*)v_pages,
        (const float*)k_scale, (const float*)v_scale,
        (const int*)block_tables, (const int*)lengths, (T*)out, hkv, group,
        d, bs, tw, scale);
    return (int)cudaGetLastError();
  }
  // The span walk is built for bf16 queries only.
  if constexpr (std::is_same<T, __nv_bfloat16>::value) {
    if (variant != TK8S_PAGED_TENSOR_CORE || group < 1 ||
        group > kMaxGroup || ws == nullptr || counters == nullptr ||
        (is_quant<KV>() && (k_scale == nullptr || v_scale == nullptr)))
      return (int)cudaErrorInvalidValue;
#define TK8S_DECODE_SPAN(DD, BB)                                           \
  if (d == DD && bs == BB)                                                 \
    return launch_span<KV, DD, BB>(q, k_pages, v_pages, k_scale, v_scale,  \
                                   block_tables, lengths, out, ws,         \
                                   counters, b, hkv, group, tw, scale,     \
                                   stream);
    TK8S_DECODE_SPAN(128, 16)
    TK8S_DECODE_SPAN(128, 32)
    TK8S_DECODE_SPAN(64, 16)
    TK8S_DECODE_SPAN(64, 32)
#undef TK8S_DECODE_SPAN
  }
  return (int)cudaErrorInvalidValue;
}

}  // namespace

#define TK8S_DECODE_ENTRY(suffix, T, KV)                                    \
  extern "C" int tk8s_paged_decode_##suffix(                                \
      const void* q, const void* k_pages, const void* v_pages,              \
      const void* k_scale, const void* v_scale, const void* block_tables,   \
      const void* lengths, void* out, void* ws, void* counters, int b,      \
      int hkv, int group, int d, int bs, int tw, float scale, int variant,  \
      void* stream) {                                                       \
    return launch<T, KV>(q, k_pages, v_pages, k_scale, v_scale,             \
                         block_tables, lengths, out, ws, counters, b, hkv,  \
                         group, d, bs, tw, scale, variant, stream);         \
  }
TK8S_PAGED_DTYPES(TK8S_DECODE_ENTRY)

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
//   lengths[b] + j on the same pool. Both kernels are the page walk of
//   paged_common.cuh: this one with spec = S, decode with spec = 1. A row
//   skips the pages at or past its own length (the TPU kernel relies on a
//   fully masked page being an exact no-op of the online softmax; skipping
//   it is the same result without the work), and every per-row operation
//   -- the D-ordered dot, the warp-butterfly max and sum of a page, p's
//   rounding, the fmaf recurrences of l and acc -- is the same sequence of
//   f32 operations in both.
//
// What bounds it on this card: bytes, as decode. The pages of the longest
//   row, ceil((len + S - 1) / bs), are read once for all S * group rows;
//   the work is 4*D FLOPs per (row, attended key), ~16 FLOPs per byte at
//   S 4 and group 4 -- still far below the ~295 FLOPs/byte of the ridge.
//
// What the design does about it: one block per (sequence, KV head) stages
//   each K/V page once (16-byte async copies, 128 keys a tile) and scores
//   it against all R = S * group rows, so speculation costs extra FLOPs on
//   pages already in shared memory, not extra page reads; launching the
//   decode kernel on B * S flattened rows would read every page S times.
//   Rows are instantiated for up to 16 and up to 32 (spec_k <= 7 at group
//   4); the binding refuses more.
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

template <typename T, typename KV, int MAX_ROWS>
int launch_rows(const void* q, const void* k_pages, const void* v_pages,
                const void* k_scale, const void* v_scale,
                const void* block_tables, const void* lengths, void* out,
                int b, int spec, int hkv, int group, int d, int bs, int tw,
                float scale, void* stream) {
  const size_t smem = paged_rows_smem<KV>(spec * group, d, bs);
  cudaError_t e = cudaFuncSetAttribute(
      paged_verify_kernel<T, KV, MAX_ROWS>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  dim3 grid(b, hkv);
  paged_verify_kernel<T, KV, MAX_ROWS><<<grid, kRowsThreads, smem,
                                         (cudaStream_t)stream>>>(
      (const T*)q, (const KV*)k_pages, (const KV*)v_pages,
      (const float*)k_scale, (const float*)v_scale, (const int*)block_tables,
      (const int*)lengths, (T*)out, hkv, group, spec, d, bs, tw, scale);
  return (int)cudaGetLastError();
}

template <typename T, typename KV>
int launch(const void* q, const void* k_pages, const void* v_pages,
           const void* k_scale, const void* v_scale,
           const void* block_tables, const void* lengths, void* out, int b,
           int spec, int hkv, int group, int d, int bs, int tw, float scale,
           void* stream) {
  const int rows = spec * group;
  if (spec < 1 ||
      !paged_rows_shapes_ok<KV>(rows, 32, d, bs, k_scale, v_scale))
    return (int)cudaErrorInvalidValue;
  if (rows <= 16)
    return launch_rows<T, KV, 16>(q, k_pages, v_pages, k_scale, v_scale,
                                  block_tables, lengths, out, b, spec, hkv,
                                  group, d, bs, tw, scale, stream);
  return launch_rows<T, KV, 32>(q, k_pages, v_pages, k_scale, v_scale,
                                block_tables, lengths, out, b, spec, hkv,
                                group, d, bs, tw, scale, stream);
}

}  // namespace

#define TK8S_VERIFY_ENTRY(suffix, T, KV)                                    \
  extern "C" int tk8s_paged_verify_##suffix(                                \
      const void* q, const void* k_pages, const void* v_pages,              \
      const void* k_scale, const void* v_scale, const void* block_tables,   \
      const void* lengths, void* out, int b, int spec, int hkv, int group,  \
      int d, int bs, int tw, float scale, void* stream) {                   \
    return launch<T, KV>(q, k_pages, v_pages, k_scale, v_scale,             \
                         block_tables, lengths, out, b, spec, hkv, group,   \
                         d, bs, tw, scale, stream);                         \
  }
TK8S_PAGED_DTYPES(TK8S_VERIFY_ENTRY)

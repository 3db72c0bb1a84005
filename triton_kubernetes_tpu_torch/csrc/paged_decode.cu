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
//   bound.
//
// What the design does about it: the page walk of paged_common.cuh with
//   one stagger (spec = 1): one block per (sequence, KV head) reads each of
//   its K and V pages exactly once for all `group` query rows of the head
//   (the TPU kernel's fold of the GQA group onto rows), and the walk over
//   the block table stops at ceil(len/bs) pages, so past-the-length pages
//   cost nothing (the TPU kernel's trash-page DMA steering is not needed).
//   Pages are staged 128 keys at a time into shared memory with 16-byte
//   asynchronous copies, all in flight together, so a tile costs one memory
//   latency instead of one per page or per key; 8-bit pages halve the bytes
//   and convert to f32 exactly as they are read. The tile is not double
//   buffered and a block serves one (sequence, head), so a batch of 8 x 8
//   heads fills 64 of the 132 SMs; both are later work.
//
// Rounding order (kept so the plain version can be held tight): q.k in f32
// from q's dtype and K converted exactly, then times D^-0.5 (then times the
// page's K scale); the online softmax runs in f32 per page of bs keys; p is
// rounded to V's dtype before P*V on unquantized pools and stays f32 on
// quantized ones, whose page sums are multiplied by the V scale; acc and l
// stay f32; the output is acc / l where l > 0, else 0, rounded to q's dtype.
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

template <typename T, typename KV>
int launch(const void* q, const void* k_pages, const void* v_pages,
           const void* k_scale, const void* v_scale,
           const void* block_tables, const void* lengths, void* out, int b,
           int hkv, int group, int d, int bs, int tw, float scale,
           void* stream) {
  if (!paged_rows_shapes_ok<KV>(group, kMaxGroup, d, bs, k_scale, v_scale))
    return (int)cudaErrorInvalidValue;
  const size_t smem = paged_rows_smem<KV>(group, d, bs);
  cudaError_t e = cudaFuncSetAttribute(
      paged_decode_kernel<T, KV>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (e != cudaSuccess) return (int)e;
  dim3 grid(b, hkv);
  paged_decode_kernel<T, KV><<<grid, kRowsThreads, smem,
                               (cudaStream_t)stream>>>(
      (const T*)q, (const KV*)k_pages, (const KV*)v_pages,
      (const float*)k_scale, (const float*)v_scale, (const int*)block_tables,
      (const int*)lengths, (T*)out, hkv, group, d, bs, tw, scale);
  return (int)cudaGetLastError();
}

}  // namespace

#define TK8S_DECODE_ENTRY(suffix, T, KV)                                    \
  extern "C" int tk8s_paged_decode_##suffix(                                \
      const void* q, const void* k_pages, const void* v_pages,              \
      const void* k_scale, const void* v_scale, const void* block_tables,   \
      const void* lengths, void* out, int b, int hkv, int group, int d,     \
      int bs, int tw, float scale, void* stream) {                          \
    return launch<T, KV>(q, k_pages, v_pages, k_scale, v_scale,             \
                         block_tables, lengths, out, b, hkv, group, d, bs,  \
                         tw, scale, stream);                                \
  }
TK8S_PAGED_DTYPES(TK8S_DECODE_ENTRY)

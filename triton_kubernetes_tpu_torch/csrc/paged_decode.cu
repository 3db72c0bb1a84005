// Ragged paged-attention decode for Hopper (sm_90a).
//
// Replaces: the TPU kernel `_ragged_decode_kernel`
//   (triton_kubernetes_tpu/ops/paged_attention.py:461, launched by
//   `_ragged_paged_attention_pallas` at :541), unquantized pools.
//
// Computes: one decode query per sequence attends to that sequence's pages.
//   q [B, 1, Hq, D], pages [N, Hkv, bs, D] (one layer's slice of the pool),
//   block_tables [B, T] int32, lengths [B] int32 (tokens written, this one
//   included). Head h = kv_head * group + g. Keys at positions >= length
//   are masked with NEG_INF; a sequence of length 0 writes 0.
//
// What bounds it on this card: bytes. Each (sequence, KV head) reads its
//   ceil(len/bs) pages of K and V once and does 4*D FLOPs per (query row,
//   key) -- with group 4 that is ~4 FLOPs per byte read, far below the
//   ~295 FLOPs/byte where an H100 becomes compute bound.
//
// What the design does about it: one block per (sequence, KV head) reads
//   each of its K and V pages exactly once for all `group` query rows of the
//   head (the TPU kernel's fold of the GQA group onto rows), and the walk
//   over the block table stops at ceil(len/bs) pages, so past-the-length
//   pages cost nothing (the TPU kernel's trash-page DMA steering is not
//   needed). Pages are staged 128 keys at a time into shared memory with
//   16-byte asynchronous copies, all in flight together, so a tile costs one
//   memory latency instead of one per page or per key. Only the softmax
//   state is sequential over pages: the scores of a whole tile are computed
//   in parallel (one thread per key), then one warp per query row runs the
//   page-by-page online-softmax update, then each thread folds its column of
//   P*V page by page. The tile is not double buffered and a block serves
//   one (sequence, head), so a batch of 8 x 8 heads fills 64 of the 132 SMs;
//   both are later work.
//
// Rounding order (kept so the plain version can be held tight): q.k is
// bf16 x bf16 with f32 accumulation, then times D^-0.5; the online softmax
// runs in f32 per page of bs keys; p is rounded to V's dtype before P*V; acc
// and l stay f32; the output is acc / l where l > 0, else 0, rounded to q's
// dtype.
#include "paged_common.cuh"

namespace {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kKeys = 128;     // keys staged per tile: one per thread
constexpr int kMaxGroup = 8;   // query rows per KV head (two per warp)
constexpr int kMaxDim = 128;   // one accumulator column per thread

template <typename T>
__global__ void __launch_bounds__(kThreads)
paged_decode_kernel(const T* __restrict__ q, const T* __restrict__ k_pages,
                    const T* __restrict__ v_pages,
                    const int* __restrict__ block_tables,
                    const int* __restrict__ lengths, T* __restrict__ out,
                    int hkv, int group, int d, int bs, int tw, float scale) {
  constexpr int vec = vec_of<T>();
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int ks = d + vec;                     // K row stride: +16 B of pad
  const int ppt = kKeys / bs;                 // pages per tile
  T* k_sh = reinterpret_cast<T*>(smem_raw);   // [kKeys][ks]
  T* v_sh = k_sh + kKeys * ks;                // [kKeys][d]
  float* q_sh = reinterpret_cast<float*>(v_sh + kKeys * d);  // [group][d]
  float* s_sh = q_sh + group * d;             // [group][kKeys]
  float* p_sh = s_sh + group * kKeys;         // [group][kKeys]
  float* c_sh = p_sh + group * kKeys;         // [group][ppt]
  float* l_sh = c_sh + group * ppt;           // [group]

  const int b = blockIdx.x;
  const int h = blockIdx.y;
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int hq = hkv * group;

  const T* q_b = q + ((size_t)b * hq + (size_t)h * group) * d;
  for (int i = tid; i < group * d; i += kThreads) q_sh[i] = to_f(q_b[i]);
  // Softmax state of rows warp and warp + kWarps, replicated across lanes.
  float m_run[2] = {TK8S_NEG_INF, TK8S_NEG_INF};
  float l_run[2] = {0.f, 0.f};
  float acc[kMaxGroup];
#pragma unroll
  for (int g = 0; g < kMaxGroup; ++g) acc[g] = 0.f;
  __syncthreads();

  const int len = lengths[b];
  const int n_pages = (len + bs - 1) / bs;  // length 0 -> no page at all
  const int* table = block_tables + (size_t)b * tw;
  const int row_vecs = d / vec;
  for (int p0 = 0; p0 < n_pages; p0 += ppt) {
    const int np = min(ppt, n_pages - p0);
    const int nk = np * bs;

    // 1. Stage the tile's K and V rows, every copy in flight at once.
    for (int i = tid; i < nk * row_vecs; i += kThreads) {
      const int j = i / row_vecs, cv = (i % row_vecs) * vec;
      const size_t src =
          (((size_t)table[p0 + j / bs] * hkv + h) * bs + j % bs) * d + cv;
      cp_async16(k_sh + j * ks + cv, k_pages + src);
      cp_async16(v_sh + j * d + cv, v_pages + src);
    }
    cp_async_wait_all();
    __syncthreads();

    // 2. Scores: thread j scores key j against every row of the group.
    if (tid < nk) {
      float part[kMaxGroup];
#pragma unroll
      for (int g = 0; g < kMaxGroup; ++g) part[g] = 0.f;
      const T* krow = k_sh + tid * ks;
      for (int c = 0; c < d; c += vec) {
        float kf[vec];
        load16_as_f32(krow + c, kf);
#pragma unroll
        for (int g = 0; g < kMaxGroup; ++g) {
          if (g < group) {
            const float* qg = q_sh + g * d + c;
#pragma unroll
            for (int e = 0; e < vec; ++e) part[g] = fmaf(qg[e], kf[e], part[g]);
          }
        }
      }
      const bool live = p0 * bs + tid < len;
#pragma unroll
      for (int g = 0; g < kMaxGroup; ++g)
        if (g < group)
          s_sh[g * kKeys + tid] = live ? part[g] * scale : TK8S_NEG_INF;
    }
    __syncthreads();

    // 3. Online softmax, page by page: one warp per row, one lane per key.
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int g = warp + r * kWarps;
      if (g < group) {
        for (int p = 0; p < np; ++p) {
          const int j = p * bs + lane;
          const float s = lane < bs ? s_sh[g * kKeys + j] : TK8S_NEG_INF;
          const float m_new = fmaxf(m_run[r], warp_max(s));
          const float e = lane < bs ? expf(s - m_new) : 0.f;
          const float sum = warp_sum(e);
          if (lane < bs) p_sh[g * kKeys + j] = round_to<T>(e);
          const float c = expf(m_run[r] - m_new);
          l_run[r] = l_run[r] * c + sum;
          if (lane == 0) c_sh[g * ppt + p] = c;
          m_run[r] = m_new;
        }
      }
    }
    __syncthreads();

    // 4. P*V: thread tid owns column tid of the [group, d] accumulator.
    if (tid < d) {
      for (int p = 0; p < np; ++p) {
        float pv[kMaxGroup];
#pragma unroll
        for (int g = 0; g < kMaxGroup; ++g) pv[g] = 0.f;
        for (int jj = 0; jj < bs; ++jj) {
          const int j = p * bs + jj;
          const float vv = to_f(v_sh[j * d + tid]);
#pragma unroll
          for (int g = 0; g < kMaxGroup; ++g)
            if (g < group) pv[g] = fmaf(p_sh[g * kKeys + j], vv, pv[g]);
        }
#pragma unroll
        for (int g = 0; g < kMaxGroup; ++g)
          if (g < group) acc[g] = acc[g] * c_sh[g * ppt + p] + pv[g];
      }
    }
    __syncthreads();  // the next tile overwrites k_sh, v_sh and p_sh
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int g = warp + r * kWarps;
    if (g < group && lane == 0) l_sh[g] = l_run[r];
  }
  __syncthreads();
  if (tid < d) {
    T* o_b = out + ((size_t)b * hq + (size_t)h * group) * d;
#pragma unroll
    for (int g = 0; g < kMaxGroup; ++g) {
      if (g < group) {
        const float l = l_sh[g];
        o_b[g * d + tid] = from_f<T>(l > 0.f ? acc[g] / l : 0.f);
      }
    }
  }
}

template <typename T>
int launch(const void* q, const void* k_pages, const void* v_pages,
           const void* block_tables, const void* lengths, void* out, int b,
           int hkv, int group, int d, int bs, int tw, float scale,
           void* stream) {
  constexpr int vec = vec_of<T>();
  if (group < 1 || group > kMaxGroup || d < vec || d > kMaxDim ||
      d % vec != 0 || bs < 1 || bs > 32 || kKeys % bs != 0)
    return (int)cudaErrorInvalidValue;
  const size_t smem =
      sizeof(T) * (size_t)kKeys * (2 * d + vec) +
      sizeof(float) * ((size_t)group * d + 2 * (size_t)group * kKeys +
                       (size_t)group * (kKeys / bs) + group);
  cudaError_t e = cudaFuncSetAttribute(
      paged_decode_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (e != cudaSuccess) return (int)e;
  dim3 grid(b, hkv);
  paged_decode_kernel<T><<<grid, kThreads, smem, (cudaStream_t)stream>>>(
      (const T*)q, (const T*)k_pages, (const T*)v_pages,
      (const int*)block_tables, (const int*)lengths, (T*)out, hkv, group, d,
      bs, tw, scale);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int tk8s_paged_decode_bf16(const void* q, const void* k_pages,
                                      const void* v_pages,
                                      const void* block_tables,
                                      const void* lengths, void* out, int b,
                                      int hkv, int group, int d, int bs,
                                      int tw, float scale, void* stream) {
  return launch<__nv_bfloat16>(q, k_pages, v_pages, block_tables, lengths,
                               out, b, hkv, group, d, bs, tw, scale, stream);
}

extern "C" int tk8s_paged_decode_f32(const void* q, const void* k_pages,
                                     const void* v_pages,
                                     const void* block_tables,
                                     const void* lengths, void* out, int b,
                                     int hkv, int group, int d, int bs,
                                     int tw, float scale, void* stream) {
  return launch<float>(q, k_pages, v_pages, block_tables, lengths, out, b,
                       hkv, group, d, bs, tw, scale, stream);
}

// Chunked-prefill paged attention for Hopper (sm_90a).
//
// Replaces: the TPU kernel `_prefill_chunk_kernel`
//   (triton_kubernetes_tpu/ops/paged_attention.py:633, launched by
//   `_paged_prefill_attention_pallas` at :693), unquantized and quantized
//   (int8/fp8 pages with per-(page, head) scales, :665-666 and :677-682).
//
// Computes: the C queries of one prefill window, at absolute positions
//   offset .. offset+C-1, attend causally by position to the sequence's
//   pages, the window's own K/V included (it is scattered in first).
//   q [1, C, Hq, D], pages [N, Hkv, bs, D] (one layer's slice of the pool;
//   q's dtype, or int8/fp8 with f32 scales [N, Hkv]), block_table [T]
//   int32. Query row r of KV head h is (token r / group,
//   head h*group + r % group); a key is kept when k_pos <= q_pos.
//
// What bounds it on this card: at C = 256 and group 4 every K/V byte feeds
//   1,024 query rows, so the work is operations, not bytes: 4*D FLOPs per
//   (row, attended key).
//
// What the design does about it: one block per (KV head, tile of 64 query
//   rows) -- 1,024 rows per KV head are too many for one block, and 16
//   tiles x 8 KV heads fill the 132 SMs. A block stops its walk over the
//   block table at the last page its own rows can see (causal skip: a page
//   that is fully masked for a row is an exact no-op of the online softmax,
//   so stopping early changes no bit). Pages are staged 64 keys at a time
//   (V by 16-byte asynchronous copies, K converted to f32 on the way in), so
//   a tile costs one memory latency. The score product is register tiled:
//   each thread computes a 4-row x 8-key block from 16-byte shared-memory
//   reads, 8 FMAs per load; P*V keeps each thread's column of the 64-row
//   accumulator in registers and the page's V column too. The products run
//   on the CUDA cores in f32; moving them to the tensor cores (mma/wgmma on
//   bf16 tiles) is later work, and until then the kernel sits far above its
//   bound.
//
// Rounding order as in paged_decode.cu: q.k in f32 from q's dtype and K
// converted exactly, then times D^-0.5 (then times the page's K scale);
// f32 online softmax per page of bs keys; p rounded to V's dtype before
// P*V on unquantized pools, kept in f32 on quantized ones, whose page sums
// are multiplied by the V scale; f32 acc and l; acc / l where l > 0,
// else 0.
#include "paged_common.cuh"

namespace {

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
        softmax_row_update<T, KV>(s_sh + tid * sp + p * BS,
                                  p_sh + tid * sp + p * BS, BS, m_sh + tid,
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
  cudaError_t e = cudaFuncSetAttribute(
      paged_prefill_kernel<T, KV, BS>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  dim3 grid(hkv, (chunk * group + kRows - 1) / kRows);
  paged_prefill_kernel<T, KV, BS><<<grid, kThreads, smem, stream>>>(
      q, k_pages, v_pages, k_scale, v_scale, block_table, out, chunk, hkv,
      group, d, offset, scale);
  return (int)cudaGetLastError();
}

template <typename T, typename KV>
int launch(const void* q, const void* k_pages, const void* v_pages,
           const void* k_scale, const void* v_scale, const void* block_table,
           void* out, int chunk, int hkv, int group, int d, int bs,
           int offset, float scale, void* stream) {
  constexpr int vec = vec_of<KV>();
  if (chunk < 1 || group < 1 || d < vec || d > kMaxDim || d % vec != 0 ||
      offset < 0 ||
      (is_quant<KV>() && (k_scale == nullptr || v_scale == nullptr)))
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
      return launch_bs<T, KV, 4>(qq, kp, vp, ks, vs, bt, o, chunk, hkv, group,
                                 d, offset, scale, s);
    case 8:
      return launch_bs<T, KV, 8>(qq, kp, vp, ks, vs, bt, o, chunk, hkv, group,
                                 d, offset, scale, s);
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

}  // namespace

#define TK8S_PREFILL_ENTRY(suffix, T, KV)                                   \
  extern "C" int tk8s_paged_prefill_##suffix(                               \
      const void* q, const void* k_pages, const void* v_pages,              \
      const void* k_scale, const void* v_scale, const void* block_table,    \
      void* out, int chunk, int hkv, int group, int d, int bs, int offset,  \
      float scale, void* stream) {                                          \
    return launch<T, KV>(q, k_pages, v_pages, k_scale, v_scale,             \
                         block_table, out, chunk, hkv, group, d, bs,        \
                         offset, scale, stream);                            \
  }
TK8S_PAGED_DTYPES(TK8S_PREFILL_ENTRY)

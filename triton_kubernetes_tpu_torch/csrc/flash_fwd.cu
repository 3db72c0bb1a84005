// Causal GQA flash-attention forward for Hopper (sm_90a).
//
// Replaces: the TPU kernel `_flash_kernel`
//   (triton_kubernetes_tpu/ops/flash_attention.py:75, launched by
//   `_flash_forward_flat` at :165).
//
// Computes: for q [B, S, Hq, D] and k, v [B, S, Hkv, D] (query head h reads
//   KV head h / group), out = softmax(q k^T * D^-0.5, causal) v in q's dtype
//   [B, S, Hq, D] (contiguous), and the row logsumexp lse = m + log(l) in
//   f32 [B, Hq, S], the residual the backward kernels recompute p from.
//
// What bounds it on this card: 4 * D FLOPs per (query, visible key) pair
//   against ~4 bytes per pair of operands at S = 2048: operations, by two
//   orders of magnitude.
//
// What the design does about it: one block (128 threads) per (batch * query
//   head, tile of 64 queries); the TPU's sequential key-block grid axis
//   becomes the block's own loop over key tiles, which stops at the causal
//   diagonal (the reference's pl.when skip). Tiles are launched longest
//   first. Q is staged once; each K/V tile by 16-byte cp.async copies, the
//   next tile's K issued as soon as the scores are taken so its load
//   overlaps the softmax and P*V. Scores are register tiled (4 queries x 8
//   keys a thread); P*V keeps each thread's column of the 64-row
//   accumulator in registers and reads four p values per 16-byte load. The
//   products run on the CUDA cores in f32; moving them to the tensor cores
//   (mma/wgmma on bf16 tiles) is later work, and until then the kernel sits
//   far above its bound.
//
// Rounding order as the reference: q.k in f32 from T operands, then times
// the scale; f32 online softmax per tile of 64 keys (m, l, acc in f32); p
// rounded to T before P*V; out = acc / l where l > 0, else 0.
#include "flash_common.cuh"

namespace {

using flash::kSp;
using flash::kTile;
using flash::Strides;

constexpr int kThreads = 128;

template <typename T>
__global__ void __launch_bounds__(kThreads)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, T* __restrict__ out,
                 float* __restrict__ lse, int seq, int hq, int hkv, int d,
                 Strides qs, Strides ks, Strides vs, float scale) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int ld = flash::staged_ld<T>(d);
  T* q_sh = reinterpret_cast<T*>(smem_raw);  // [kTile][ld]
  T* k_sh = q_sh + kTile * ld;
  T* v_sh = k_sh + kTile * ld;
  float* s_sh = reinterpret_cast<float*>(v_sh + kTile * ld);  // [kTile][kSp]
  float* m_sh = s_sh + kTile * kSp;
  float* l_sh = m_sh + kTile;
  float* c_sh = l_sh + kTile;

  const int n_tiles = (seq + kTile - 1) / kTile;
  const int qt = n_tiles - 1 - blockIdx.x;  // longest walks first
  const int bh = blockIdx.y;
  const int b = bh / hq, h = bh % hq;
  const int hk = h / (hq / hkv);
  const int q0 = qt * kTile;
  const int tid = threadIdx.x;

  flash::stage_tile<T, kThreads>(q_sh, q, qs, b, h, q0, seq, d);
  flash::stage_tile<T, kThreads>(k_sh, k, ks, b, hk, 0, seq, d);
  flash::stage_tile<T, kThreads>(v_sh, v, vs, b, hk, 0, seq, d);
  if (tid < kTile) {
    m_sh[tid] = TK8S_NEG_INF;
    l_sh[tid] = 0.f;
  }
  float acc[kTile];
#pragma unroll
  for (int r = 0; r < kTile; ++r) acc[r] = 0.f;

  const int rg = tid / 8, kg = tid % 8;
  for (int kt = 0; kt <= qt; ++kt) {
    const int k0 = kt * kTile;
    cp_async_wait_all();
    __syncthreads();

    // 1. Scores of 4 queries x 8 keys per thread, scaled and masked.
    {
      float sc[4][8];
      flash::tile_dot<T, kThreads>(q_sh, k_sh, d, sc);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int r = rg + 16 * i;
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const int key = k0 + kg + 8 * j;
          s_sh[r * kSp + kg + 8 * j] =
              (key <= q0 + r && key < seq) ? sc[i][j] * scale : TK8S_NEG_INF;
        }
      }
    }
    __syncthreads();
    if (kt < qt)  // K is read; the next tile's copies run under the rest
      flash::stage_tile<T, kThreads>(k_sh, k, ks, b, hk, k0 + kTile, seq, d);

    // 2. Online softmax: two threads a row, 32 keys each (interleaved).
    {
      const int r = tid >> 1, half = tid & 1;
      float* srow = s_sh + r * kSp;
      float mx = TK8S_NEG_INF;
      for (int jj = 0; jj < kTile / 2; ++jj)
        mx = fmaxf(mx, srow[half + 2 * jj]);
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      const float m_prev = m_sh[r];
      const float m_new = fmaxf(m_prev, mx);
      float sum = 0.f;
      for (int jj = 0; jj < kTile / 2; ++jj) {
        const float e = expf(srow[half + 2 * jj] - m_new);
        sum += e;
        srow[half + 2 * jj] = round_to<T>(e);
      }
      sum += __shfl_xor_sync(0xffffffffu, sum, 1);
      __syncwarp();
      if (half == 0) {
        const float corr = expf(m_prev - m_new);
        l_sh[r] = l_sh[r] * corr + sum;
        c_sh[r] = corr;
        m_sh[r] = m_new;
      }
    }
    __syncthreads();

    // 3. acc = acc * corr + p V; thread tid owns column tid.
    if (tid < d) {
#pragma unroll
      for (int r = 0; r < kTile; ++r) acc[r] *= c_sh[r];
      for (int j = 0; j < kTile; j += 4) {
        const float v0 = to_f(v_sh[(j + 0) * ld + tid]);
        const float v1 = to_f(v_sh[(j + 1) * ld + tid]);
        const float v2 = to_f(v_sh[(j + 2) * ld + tid]);
        const float v3 = to_f(v_sh[(j + 3) * ld + tid]);
#pragma unroll
        for (int r = 0; r < kTile; ++r) {
          const float4 p = *reinterpret_cast<const float4*>(s_sh + r * kSp + j);
          float a = acc[r];
          a = fmaf(p.x, v0, a);
          a = fmaf(p.y, v1, a);
          a = fmaf(p.z, v2, a);
          a = fmaf(p.w, v3, a);
          acc[r] = a;
        }
      }
    }
    __syncthreads();
    if (kt < qt)
      flash::stage_tile<T, kThreads>(v_sh, v, vs, b, hk, k0 + kTile, seq, d);
  }

  if (tid < d) {
#pragma unroll
    for (int r = 0; r < kTile; ++r) {
      if (q0 + r < seq) {
        const float l = l_sh[r];
        out[(((size_t)b * seq + q0 + r) * hq + h) * d + tid] =
            from_f<T>(l > 0.f ? acc[r] / l : 0.f);
      }
    }
  }
  if (tid < kTile && q0 + tid < seq) {
    const float l = l_sh[tid];
    lse[((size_t)b * hq + h) * seq + q0 + tid] =
        l > 0.f ? m_sh[tid] + logf(l) : __int_as_float(0x7f800000);
  }
}

template <typename T>
int launch(const void* q, const void* k, const void* v, void* out, void* lse,
           int batch, int seq, int hq, int hkv, int d, Strides qs, Strides ks,
           Strides vs, float scale, void* stream) {
  if (batch < 1 || seq < 1 || hkv < 1 || hq % hkv != 0 || d < 8 ||
      d > flash::kMaxDim || d % 8 != 0)
    return (int)cudaErrorInvalidValue;
  const size_t smem = sizeof(T) * 3 * (size_t)kTile * flash::staged_ld<T>(d) +
                      sizeof(float) * ((size_t)kTile * kSp + 3 * kTile);
  cudaError_t e = cudaFuncSetAttribute(
      flash_fwd_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (e != cudaSuccess) return (int)e;
  dim3 grid((seq + kTile - 1) / kTile, batch * hq);
  flash_fwd_kernel<T><<<grid, kThreads, smem, (cudaStream_t)stream>>>(
      (const T*)q, (const T*)k, (const T*)v, (T*)out, (float*)lse, seq, hq,
      hkv, d, qs, ks, vs, scale);
  return (int)cudaGetLastError();
}

}  // namespace

#define TK8S_FLASH_FWD(SUFFIX, T)                                            \
  extern "C" int tk8s_flash_fwd_##SUFFIX(                                    \
      const void* q, const void* k, const void* v, void* out, void* lse,     \
      int batch, int seq, int hq, int hkv, int d, long long qsb,             \
      long long qss, long long qsh, long long ksb, long long kss,            \
      long long ksh, long long vsb, long long vss, long long vsh,            \
      float scale, void* stream) {                                           \
    return launch<T>(q, k, v, out, lse, batch, seq, hq, hkv, d,              \
                     Strides{qsb, qss, qsh}, Strides{ksb, kss, ksh},         \
                     Strides{vsb, vss, vsh}, scale, stream);                 \
  }

TK8S_FLASH_FWD(bf16, __nv_bfloat16)
TK8S_FLASH_FWD(f32, float)

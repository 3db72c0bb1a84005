// Causal GQA flash-attention backward, dQ, for Hopper (sm_90a).
//
// Replaces: the TPU kernel `_dq_kernel`
//   (triton_kubernetes_tpu/ops/flash_attention.py:196, launched by
//   `_flash_backward` at :295).
//
// Computes: for q, dO [B, S, Hq, D], k, v [B, S, Hkv, D], the forward's
//   lse and D = rowsum(dO * O) (both f32 [B, Hq, S]):
//     p  = exp(q k^T * scale - lse)          (f32, causal)
//     dp = dO v^T                            (f32)
//     ds = p * (dp - D) * scale              (rounded to T)
//     dq = ds k                              (f32 sum, stored as T)
//   dq is [B, S, Hq, D], contiguous.
//
// What bounds it on this card: 6 * D FLOPs per (query, visible key) pair:
//   operations, as in the forward.
//
// What the design does about it: one block (128 threads) per (batch * query
//   head, tile of 64 queries), longest walks first; Q and dO staged once,
//   then a loop over key tiles up to the diagonal. K and V of a tile come
//   in by 16-byte cp.async copies; V of the next tile is issued once dp is
//   taken and K once dq has read it. Both score products are register
//   tiled (4 queries x 8 keys a thread); dq keeps each thread's column of
//   the 64-row accumulator in registers. CUDA-core f32 products, like the
//   forward.
#include "flash_common.cuh"

namespace {

using flash::kSp;
using flash::kTile;
using flash::Strides;

constexpr int kThreads = 128;

template <typename T>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                    const T* __restrict__ v, const T* __restrict__ dout,
                    const float* __restrict__ lse,
                    const float* __restrict__ dvec, T* __restrict__ dq,
                    int seq, int hq, int hkv, int d, Strides qs, Strides ks,
                    Strides vs, Strides dos, float scale) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int ld = flash::staged_ld<T>(d);
  T* q_sh = reinterpret_cast<T*>(smem_raw);  // [kTile][ld] each
  T* do_sh = q_sh + kTile * ld;
  T* k_sh = do_sh + kTile * ld;
  T* v_sh = k_sh + kTile * ld;
  float* ds_sh = reinterpret_cast<float*>(v_sh + kTile * ld);  // [kTile][kSp]
  float* lse_sh = ds_sh + kTile * kSp;
  float* dvec_sh = lse_sh + kTile;

  const int n_tiles = (seq + kTile - 1) / kTile;
  const int qt = n_tiles - 1 - blockIdx.x;
  const int bh = blockIdx.y;
  const int b = bh / hq, h = bh % hq;
  const int hk = h / (hq / hkv);
  const int q0 = qt * kTile;
  const int tid = threadIdx.x;

  flash::stage_tile<T, kThreads>(q_sh, q, qs, b, h, q0, seq, d);
  flash::stage_tile<T, kThreads>(do_sh, dout, dos, b, h, q0, seq, d);
  flash::stage_tile<T, kThreads>(k_sh, k, ks, b, hk, 0, seq, d);
  flash::stage_tile<T, kThreads>(v_sh, v, vs, b, hk, 0, seq, d);
  if (tid < kTile) {
    const bool live = q0 + tid < seq;
    const size_t row = ((size_t)b * hq + h) * seq + q0 + tid;
    lse_sh[tid] = live ? lse[row] : 0.f;
    dvec_sh[tid] = live ? dvec[row] : 0.f;
  }
  float acc[kTile];
#pragma unroll
  for (int r = 0; r < kTile; ++r) acc[r] = 0.f;

  const int rg = tid / 8, kg = tid % 8;
  for (int kt = 0; kt <= qt; ++kt) {
    const int k0 = kt * kTile;
    cp_async_wait_all();
    __syncthreads();

    // 1. ds for 4 queries x 8 keys per thread.
    {
      float s[4][8], dp[4][8];
      flash::tile_dot<T, kThreads>(q_sh, k_sh, d, s);
      flash::tile_dot<T, kThreads>(do_sh, v_sh, d, dp);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int r = rg + 16 * i;
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const int key = k0 + kg + 8 * j;
          const bool live = key <= q0 + r && key < seq && q0 + r < seq;
          const float p =
              live ? expf(s[i][j] * scale - lse_sh[r]) : 0.f;
          ds_sh[r * kSp + kg + 8 * j] =
              round_to<T>(p * (dp[i][j] - dvec_sh[r]) * scale);
        }
      }
    }
    __syncthreads();
    if (kt < qt)
      flash::stage_tile<T, kThreads>(v_sh, v, vs, b, hk, k0 + kTile, seq, d);

    // 2. dq += ds k; thread tid owns column tid.
    if (tid < d) {
      for (int j = 0; j < kTile; j += 4) {
        const float k0v = to_f(k_sh[(j + 0) * ld + tid]);
        const float k1v = to_f(k_sh[(j + 1) * ld + tid]);
        const float k2v = to_f(k_sh[(j + 2) * ld + tid]);
        const float k3v = to_f(k_sh[(j + 3) * ld + tid]);
#pragma unroll
        for (int r = 0; r < kTile; ++r) {
          const float4 g =
              *reinterpret_cast<const float4*>(ds_sh + r * kSp + j);
          float a = acc[r];
          a = fmaf(g.x, k0v, a);
          a = fmaf(g.y, k1v, a);
          a = fmaf(g.z, k2v, a);
          a = fmaf(g.w, k3v, a);
          acc[r] = a;
        }
      }
    }
    __syncthreads();
    if (kt < qt)
      flash::stage_tile<T, kThreads>(k_sh, k, ks, b, hk, k0 + kTile, seq, d);
  }

  if (tid < d) {
#pragma unroll
    for (int r = 0; r < kTile; ++r)
      if (q0 + r < seq)
        dq[(((size_t)b * seq + q0 + r) * hq + h) * d + tid] = from_f<T>(acc[r]);
  }
}

template <typename T>
int launch(const void* q, const void* k, const void* v, const void* dout,
           const void* lse, const void* dvec, void* dq, int batch, int seq,
           int hq, int hkv, int d, Strides qs, Strides ks, Strides vs,
           Strides dos, float scale, void* stream) {
  if (batch < 1 || seq < 1 || hkv < 1 || hq % hkv != 0 || d < 8 ||
      d > flash::kMaxDim || d % 8 != 0)
    return (int)cudaErrorInvalidValue;
  const size_t smem = sizeof(T) * 4 * (size_t)kTile * flash::staged_ld<T>(d) +
                      sizeof(float) * ((size_t)kTile * kSp + 2 * kTile);
  cudaError_t e = cudaFuncSetAttribute(
      flash_bwd_dq_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (e != cudaSuccess) return (int)e;
  dim3 grid((seq + kTile - 1) / kTile, batch * hq);
  flash_bwd_dq_kernel<T><<<grid, kThreads, smem, (cudaStream_t)stream>>>(
      (const T*)q, (const T*)k, (const T*)v, (const T*)dout,
      (const float*)lse, (const float*)dvec, (T*)dq, seq, hq, hkv, d, qs, ks,
      vs, dos, scale);
  return (int)cudaGetLastError();
}

}  // namespace

#define TK8S_FLASH_DQ(SUFFIX, T)                                             \
  extern "C" int tk8s_flash_bwd_dq_##SUFFIX(                                 \
      const void* q, const void* k, const void* v, const void* dout,         \
      const void* lse, const void* dvec, void* dq, int batch, int seq,       \
      int hq, int hkv, int d, long long qsb, long long qss, long long qsh,   \
      long long ksb, long long kss, long long ksh, long long vsb,            \
      long long vss, long long vsh, long long dsb, long long dss,            \
      long long dsh, float scale, void* stream) {                            \
    return launch<T>(q, k, v, dout, lse, dvec, dq, batch, seq, hq, hkv, d,   \
                     Strides{qsb, qss, qsh}, Strides{ksb, kss, ksh},         \
                     Strides{vsb, vss, vsh}, Strides{dsb, dss, dsh}, scale,  \
                     stream);                                                \
  }

TK8S_FLASH_DQ(bf16, __nv_bfloat16)
TK8S_FLASH_DQ(f32, float)

// Causal GQA flash-attention backward, dK and dV, for Hopper (sm_90a).
//
// Replaces: the TPU kernel `_dkv_kernel`
//   (triton_kubernetes_tpu/ops/flash_attention.py:230, launched by
//   `_flash_backward` at :316), together with the group sum the reference
//   runs outside it (:342-343).
//
// Computes: for each key of KV head hk, over the group's query heads h and
//   every query that sees the key (q, dO [B, S, Hq, D], lse and
//   D = rowsum(dO * O) f32 [B, Hq, S]):
//     p  = exp(q k^T * scale - lse)          (f32, causal)
//     dv += round(p)^T dO                    (f32)
//     ds = round(p * (dO v^T - D) * scale)
//     dk += ds^T q                           (f32)
//   dk, dv are [B, S, Hkv, D] in T, contiguous.
//
// What bounds it on this card: 8 * D FLOPs per (query, visible key) pair:
//   operations.
//
// What the design does about it: one block (256 threads) per (batch * KV
//   head, tile of 64 keys). It stages its K and V tile once, then walks the
//   group's query heads and, for each, the query tiles from the diagonal
//   on, so dK and dV of a KV head are summed in f32 registers across the
//   whole group and written once: the reference's [B * Hq, S, D] f32
//   partials and its outside group sum are gone (only the f32 summation
//   order differs). Each query tile (Q, dO) comes in by 16-byte cp.async
//   copies. The two score products are register tiled (2 queries x 8 keys
//   a thread); thread t accumulates column t % 128 of key rows
//   32 * (t / 128) .. +31 for both dK and dV, reading four p and four ds
//   values per 16-byte load. CUDA-core f32 products, like the forward.
#include "flash_common.cuh"

namespace {

using flash::kSp;
using flash::kTile;
using flash::Strides;

constexpr int kThreads = 256;
constexpr int kHalf = kTile / 2;  // key rows per thread

template <typename T>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dkv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, const T* __restrict__ dout,
                     const float* __restrict__ lse,
                     const float* __restrict__ dvec, T* __restrict__ dk,
                     T* __restrict__ dv, int seq, int hq, int hkv, int d,
                     Strides qs, Strides ks, Strides vs, Strides dos,
                     float scale) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int ld = flash::staged_ld<T>(d);
  T* k_sh = reinterpret_cast<T*>(smem_raw);  // [kTile][ld] each
  T* v_sh = k_sh + kTile * ld;
  T* q_sh = v_sh + kTile * ld;
  T* do_sh = q_sh + kTile * ld;
  float* p_sh = reinterpret_cast<float*>(do_sh + kTile * ld);  // [q][key]
  float* ds_sh = p_sh + kTile * kSp;
  float* lse_sh = ds_sh + kTile * kSp;
  float* dvec_sh = lse_sh + kTile;

  const int kt = blockIdx.x;  // the first key tiles have the longest walks
  const int bh = blockIdx.y;
  const int b = bh / hkv, hk = bh % hkv;
  const int group = hq / hkv;
  const int k0 = kt * kTile;
  const int n_tiles = (seq + kTile - 1) / kTile;
  const int tid = threadIdx.x;
  const int col = tid % flash::kMaxDim, half = tid / flash::kMaxDim;

  flash::stage_tile<T, kThreads>(k_sh, k, ks, b, hk, k0, seq, d);
  flash::stage_tile<T, kThreads>(v_sh, v, vs, b, hk, k0, seq, d);
  float dk_acc[kHalf], dv_acc[kHalf];
#pragma unroll
  for (int j = 0; j < kHalf; ++j) dk_acc[j] = dv_acc[j] = 0.f;

  const int rg = tid / 8, kg = tid % 8;
  for (int g = 0; g < group; ++g) {
    const int h = hk * group + g;
    for (int qt = kt; qt < n_tiles; ++qt) {
      const int q0 = qt * kTile;
      flash::stage_tile<T, kThreads>(q_sh, q, qs, b, h, q0, seq, d);
      flash::stage_tile<T, kThreads>(do_sh, dout, dos, b, h, q0, seq, d);
      if (tid < kTile) {
        const bool live = q0 + tid < seq;
        const size_t row = ((size_t)b * hq + h) * seq + q0 + tid;
        lse_sh[tid] = live ? lse[row] : 0.f;
        dvec_sh[tid] = live ? dvec[row] : 0.f;
      }
      cp_async_wait_all();
      __syncthreads();

      // 1. p and ds for 2 queries x 8 keys per thread.
      {
        float s[2][8], dp[2][8];
        flash::tile_dot<T, kThreads>(q_sh, k_sh, d, s);
        flash::tile_dot<T, kThreads>(do_sh, v_sh, d, dp);
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          const int r = rg + 32 * i;
#pragma unroll
          for (int j = 0; j < 8; ++j) {
            const int key = k0 + kg + 8 * j;
            const bool live = key <= q0 + r && key < seq && q0 + r < seq;
            const float p = live ? expf(s[i][j] * scale - lse_sh[r]) : 0.f;
            p_sh[r * kSp + kg + 8 * j] = round_to<T>(p);
            ds_sh[r * kSp + kg + 8 * j] =
                round_to<T>(p * (dp[i][j] - dvec_sh[r]) * scale);
          }
        }
      }
      __syncthreads();

      // 2. dv += p^T dO, dk += ds^T q over this tile's 64 queries.
      if (col < d) {
        for (int r = 0; r < kTile; ++r) {
          const float doc = to_f(do_sh[r * ld + col]);
          const float qc = to_f(q_sh[r * ld + col]);
          const float* pr = p_sh + r * kSp + half * kHalf;
          const float* dr = ds_sh + r * kSp + half * kHalf;
#pragma unroll
          for (int j = 0; j < kHalf; j += 4) {
            const float4 p = *reinterpret_cast<const float4*>(pr + j);
            const float4 g4 = *reinterpret_cast<const float4*>(dr + j);
            dv_acc[j] = fmaf(p.x, doc, dv_acc[j]);
            dv_acc[j + 1] = fmaf(p.y, doc, dv_acc[j + 1]);
            dv_acc[j + 2] = fmaf(p.z, doc, dv_acc[j + 2]);
            dv_acc[j + 3] = fmaf(p.w, doc, dv_acc[j + 3]);
            dk_acc[j] = fmaf(g4.x, qc, dk_acc[j]);
            dk_acc[j + 1] = fmaf(g4.y, qc, dk_acc[j + 1]);
            dk_acc[j + 2] = fmaf(g4.z, qc, dk_acc[j + 2]);
            dk_acc[j + 3] = fmaf(g4.w, qc, dk_acc[j + 3]);
          }
        }
      }
      __syncthreads();  // the next query tile overwrites q_sh, do_sh, p, ds
    }
  }

  if (col < d) {
#pragma unroll
    for (int j = 0; j < kHalf; ++j) {
      const int key = k0 + half * kHalf + j;
      if (key < seq) {
        const size_t o = (((size_t)b * seq + key) * hkv + hk) * d + col;
        dk[o] = from_f<T>(dk_acc[j]);
        dv[o] = from_f<T>(dv_acc[j]);
      }
    }
  }
}

template <typename T>
int launch(const void* q, const void* k, const void* v, const void* dout,
           const void* lse, const void* dvec, void* dk, void* dv, int batch,
           int seq, int hq, int hkv, int d, Strides qs, Strides ks,
           Strides vs, Strides dos, float scale, void* stream) {
  if (batch < 1 || seq < 1 || hkv < 1 || hq % hkv != 0 || d < 8 ||
      d > flash::kMaxDim || d % 8 != 0)
    return (int)cudaErrorInvalidValue;
  const size_t smem = sizeof(T) * 4 * (size_t)kTile * flash::staged_ld<T>(d) +
                      sizeof(float) * (2 * (size_t)kTile * kSp + 2 * kTile);
  cudaError_t e = cudaFuncSetAttribute(
      flash_bwd_dkv_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (e != cudaSuccess) return (int)e;
  dim3 grid((seq + kTile - 1) / kTile, batch * hkv);
  flash_bwd_dkv_kernel<T><<<grid, kThreads, smem, (cudaStream_t)stream>>>(
      (const T*)q, (const T*)k, (const T*)v, (const T*)dout,
      (const float*)lse, (const float*)dvec, (T*)dk, (T*)dv, seq, hq, hkv, d,
      qs, ks, vs, dos, scale);
  return (int)cudaGetLastError();
}

}  // namespace

#define TK8S_FLASH_DKV(SUFFIX, T)                                            \
  extern "C" int tk8s_flash_bwd_dkv_##SUFFIX(                                \
      const void* q, const void* k, const void* v, const void* dout,         \
      const void* lse, const void* dvec, void* dk, void* dv, int batch,      \
      int seq, int hq, int hkv, int d, long long qsb, long long qss,         \
      long long qsh, long long ksb, long long kss, long long ksh,            \
      long long vsb, long long vss, long long vsh, long long dsb,            \
      long long dss, long long dsh, float scale, void* stream) {             \
    return launch<T>(q, k, v, dout, lse, dvec, dk, dv, batch, seq, hq, hkv,  \
                     d, Strides{qsb, qss, qsh}, Strides{ksb, kss, ksh},      \
                     Strides{vsb, vss, vsh}, Strides{dsb, dss, dsh}, scale,  \
                     stream);                                                \
  }

TK8S_FLASH_DKV(bf16, __nv_bfloat16)
TK8S_FLASH_DKV(f32, float)

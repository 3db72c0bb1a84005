// Device helpers shared by the two paged-attention kernels
// (paged_decode.cu, paged_prefill.cu): dtype conversion through the bf16
// intrinsics, 16-byte async copies into shared memory, warp reductions and
// the per-page online-softmax row update.
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
// where round() is to V's dtype. A page that is fully masked for a row
// whose m is already finite is an exact no-op: exp(NEG_INF - m) underflows
// to 0.0 and corr is exp(0) = 1.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#define TK8S_NEG_INF (-1e30f)

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) {
  return x;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

// x rounded to T and back: the P*V operand.
template <typename T> __device__ __forceinline__ float round_to(float x) {
  return to_f(from_f<T>(x));
}

// Elements of T in one 16-byte copy.
template <typename T> __host__ __device__ constexpr int vec_of() {
  return 16 / (int)sizeof(T);
}

// The 16 bytes at p (16-byte aligned) as floats: 8 bf16 or 4 f32.
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

// One row's online-softmax step over one page, by one thread. `s` holds
// the page's n scores, `p` receives exp(s - m_new) rounded to T; m, l and
// corr are this row's running state.
template <typename T>
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
    p[j] = round_to<T>(e);
  }
  const float c = expf(m_prev - m_new);
  *l = *l * c + sum;
  *corr = c;
  *m = m_new;
}

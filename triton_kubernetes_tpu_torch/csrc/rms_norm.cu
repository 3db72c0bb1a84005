// Row-invariant RMSNorm of the decode and verify ticks, for Hopper
// (sm_90a).
//
// Replaces: no TPU kernel. The JAX package's `rms_norm`
//   (triton_kubernetes_tpu/ops/norms.py:11) is a plain XLA reduction. This
//   kernel exists for the same reason as decode_gemm.cu: torch's
//   reduction splits a row's sum by the number of rows in the call, so a
//   verify tick's [B * S] rows would round differently from a decode
//   tick's [B]. Here a row's sum is taken in one fixed order whatever M is.
//
// Computes, per row of x [M, D] (bf16 or f32, scale [D] of the same type):
//   var = (sum_i x_i^2) * (1 / D)         (f32)
//   y_i = round((x_i * rsqrt(var + eps)) * scale_i)
// the reference's order: normed in f32, times the f32 scale, rounded once.
//
// What bounds it: bytes (x read once, y written once), a few microseconds
//   at the serving shapes, where one launch's latency dominates.
//
// Design: one block of 256 threads a row. Thread t sums x_i^2 for
//   i = 8 t + 2048 j + e in order of j and e (16-byte loads), the eight
//   warps reduce by a fixed shuffle tree, and warp 0 adds the eight warp
//   sums in order. D must be a multiple of 8 (the wrapper checks).
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

__device__ __forceinline__ void load8(const __nv_bfloat16* p, float (&f)[8]) {
  const uint4 u = *reinterpret_cast<const uint4*>(p);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 v = __bfloat1622float2(h[i]);
    f[2 * i] = v.x;
    f[2 * i + 1] = v.y;
  }
}
__device__ __forceinline__ void load8(const float* p, float (&f)[8]) {
  const float4 a = *reinterpret_cast<const float4*>(p);
  const float4 b = *reinterpret_cast<const float4*>(p + 4);
  f[0] = a.x; f[1] = a.y; f[2] = a.z; f[3] = a.w;
  f[4] = b.x; f[5] = b.y; f[6] = b.z; f[7] = b.w;
}
__device__ __forceinline__ void store8(__nv_bfloat16* p, const float (&f)[8]) {
  uint4 u;
  __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&u);
#pragma unroll
  for (int i = 0; i < 4; ++i) h[i] = __floats2bfloat162_rn(f[2 * i], f[2 * i + 1]);
  *reinterpret_cast<uint4*>(p) = u;
}
__device__ __forceinline__ void store8(float* p, const float (&f)[8]) {
  *reinterpret_cast<float4*>(p) = make_float4(f[0], f[1], f[2], f[3]);
  *reinterpret_cast<float4*>(p + 4) = make_float4(f[4], f[5], f[6], f[7]);
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
rms_norm_kernel(const T* __restrict__ x, const T* __restrict__ scale,
                T* __restrict__ y, int d, float eps) {
  __shared__ float warp_sums[kThreads / 32];
  const T* row = x + (size_t)blockIdx.x * d;
  T* out = y + (size_t)blockIdx.x * d;
  const int t = threadIdx.x;
  float sum = 0.f;
  for (int i = 8 * t; i < d; i += 8 * kThreads) {
    float f[8];
    load8(row + i, f);
#pragma unroll
    for (int e = 0; e < 8; ++e) sum = fmaf(f[e], f[e], sum);
  }
#pragma unroll
  for (int off = 16; off > 0; off /= 2)
    sum += __shfl_xor_sync(0xffffffffu, sum, off);
  if (t % 32 == 0) warp_sums[t / 32] = sum;
  __syncthreads();
  float total = 0.f;
#pragma unroll
  for (int w = 0; w < kThreads / 32; ++w) total += warp_sums[w];
  const float r = rsqrtf(total * (1.f / (float)d) + eps);
  for (int i = 8 * t; i < d; i += 8 * kThreads) {
    float f[8], s[8];
    load8(row + i, f);
    load8(scale + i, s);
#pragma unroll
    for (int e = 0; e < 8; ++e) f[e] = __fmul_rn(__fmul_rn(f[e], r), s[e]);
    store8(out + i, f);
  }
}

template <typename T>
int launch(const void* x, const void* scale, void* y, int m, int d,
           float eps, void* stream) {
  if (m < 1 || d < 8 || d % 8 != 0) return (int)cudaErrorInvalidValue;
  rms_norm_kernel<T><<<m, kThreads, 0, (cudaStream_t)stream>>>(
      (const T*)x, (const T*)scale, (T*)y, d, eps);
  return (int)cudaGetLastError();
}

}  // namespace

// x [m, d] and y [m, d] row-major, scale [d]; all bf16 or all f32.
extern "C" int tk8s_rms_norm_bf16(const void* x, const void* scale, void* y,
                                  int m, int d, float eps, void* stream) {
  return launch<__nv_bfloat16>(x, scale, y, m, d, eps, stream);
}
extern "C" int tk8s_rms_norm_f32(const void* x, const void* scale, void* y,
                                 int m, int d, float eps, void* stream) {
  return launch<float>(x, scale, y, m, d, eps, stream);
}

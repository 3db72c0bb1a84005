// Row-invariant RMSNorm of the serving steps, with the residual add that
// precedes it fused in, for Hopper (sm_90a).
//
// Replaces: no TPU kernel. The JAX package's `rms_norm`
//   (triton_kubernetes_tpu/ops/norms.py:11) and its residual adds
//   (triton_kubernetes_tpu/models/llama.py, `x + ...`) are plain XLA ops.
//   This kernel exists for the same reason as decode_gemm.cu: torch's
//   reduction splits a row's sum by the number of rows in the call, so a
//   verify tick's [B * S] rows would round differently from a decode
//   tick's [B]. Here a row's sum is taken in one fixed order whatever M is.
//
// Computes, per row of x [M, D] (bf16 or f32; delta [M, D] and scale [D]
// of the same type):
//   h_i = round(x_i + delta_i)             (f32 add, rounded once: bitwise
//                                           torch's `x + delta`)
//   var = (sum_i h_i^2) * (1 / D)          (f32)
//   y_i = round((h_i * rsqrt(var + eps)) * scale_i)
// the reference's order: normed in f32, times the f32 scale, rounded once.
// With delta null (the first layer's attention norm, after the embedding)
// h is x and is not written: the plain norm of x.
//
// What bounds it: bytes (x, delta and scale read once, h and y written
//   once): 0.14 MB at a decode tick's M 8, D 4096, some 0.04 us at
//   3.35 TB/s, far below one launch's latency. So what a layer boundary
//   costs is launches and dependent DRAM round trips, and the design cuts
//   both: the residual add is in the same launch (one launch a boundary,
//   not an add and a norm), and every load of a row is issued before the
//   first FMA, so a cold row costs one round trip, not one before the sum
//   and another for x and the scale after the barrier.
//
// Design: one block of 256 threads a row. Thread t owns the 16-byte
//   chunks at i = 8 t + 2048 j (j = 0, 1, ...): it loads the x, delta and
//   scale chunks of up to kHeld of them at once, keeps h in registers
//   (D <= 8192), sums h_i^2 with fmaf in the order of j, then of the
//   element e within a chunk, and writes h. The eight warps reduce by a
//   fixed xor-shuffle tree (16, 8, 4, 2, 1), and after the one barrier
//   every thread adds the eight warp sums in order. y = (h * r) * s from
//   the registers. Chunks past kHeld (D > 8192) are summed in the same
//   order and read back after the barrier from h (or x) as written. A
//   delta-null row takes the same operations in the same order as the
//   two-pass kernel this one replaced (its bits are unchanged), and a
//   fused row is bitwise that norm of torch's add. D must be a multiple
//   of 8 (the wrapper checks).
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kStride = 8 * kThreads;  // elements between a thread's chunks
constexpr int kHeld = 4;               // chunks a thread keeps: D <= 8192

// Eight elements of T as they are loaded: one 16-byte word of bf16, two
// of f32.
template <typename T> struct Pack;
template <> struct Pack<__nv_bfloat16> { uint4 u; };
template <> struct Pack<float> { float4 a, b; };

__device__ __forceinline__ void load(const __nv_bfloat16* p,
                                     Pack<__nv_bfloat16>& v) {
  v.u = *reinterpret_cast<const uint4*>(p);
}
__device__ __forceinline__ void load(const float* p, Pack<float>& v) {
  v.a = *reinterpret_cast<const float4*>(p);
  v.b = *reinterpret_cast<const float4*>(p + 4);
}
__device__ __forceinline__ void unpack(const Pack<__nv_bfloat16>& v,
                                       float (&f)[8]) {
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&v.u);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 t = __bfloat1622float2(h[i]);
    f[2 * i] = t.x;
    f[2 * i + 1] = t.y;
  }
}
__device__ __forceinline__ void unpack(const Pack<float>& v, float (&f)[8]) {
  f[0] = v.a.x; f[1] = v.a.y; f[2] = v.a.z; f[3] = v.a.w;
  f[4] = v.b.x; f[5] = v.b.y; f[6] = v.b.z; f[7] = v.b.w;
}
template <typename T>
__device__ __forceinline__ void load8(const T* p, float (&f)[8]) {
  Pack<T> v;
  load(p, v);
  unpack(v, f);
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
// h += d, as torch adds two tensors of T: an f32 add (never contracted
// into an FMA), rounded once to T.
__device__ __forceinline__ void add_round(__nv_bfloat16*, float (&h)[8],
                                          const float (&d)[8]) {
#pragma unroll
  for (int e = 0; e < 8; ++e)
    h[e] = __bfloat162float(__float2bfloat16_rn(__fadd_rn(h[e], d[e])));
}
__device__ __forceinline__ void add_round(float*, float (&h)[8],
                                          const float (&d)[8]) {
#pragma unroll
  for (int e = 0; e < 8; ++e) h[e] = __fadd_rn(h[e], d[e]);
}

// kAdd: h = x + delta is formed and written; otherwise h is x.
template <typename T, bool kAdd>
__global__ void __launch_bounds__(kThreads)
rms_norm_kernel(const T* __restrict__ x, const T* __restrict__ delta,
                const T* __restrict__ scale, T* __restrict__ h_out,
                T* __restrict__ y, int d, float eps) {
  __shared__ float warp_sums[kThreads / 32];
  const size_t row = (size_t)blockIdx.x * d;
  const int t = threadIdx.x;
  // Every load of the held chunks first: one DRAM round trip a row.
  Pack<T> xv[kHeld], dv[kHeld], sv[kHeld];
#pragma unroll
  for (int j = 0; j < kHeld; ++j) {
    const int i = 8 * t + kStride * j;
    if (i < d) {
      load(x + row + i, xv[j]);
      if (kAdd) load(delta + row + i, dv[j]);
      load(scale + i, sv[j]);
    }
  }
  float h[kHeld][8];
  float sum = 0.f;
#pragma unroll
  for (int j = 0; j < kHeld; ++j) {
    const int i = 8 * t + kStride * j;
    if (i < d) {
      unpack(xv[j], h[j]);
      if (kAdd) {
        float f[8];
        unpack(dv[j], f);
        add_round((T*)nullptr, h[j], f);
        store8(h_out + row + i, h[j]);
      }
#pragma unroll
      for (int e = 0; e < 8; ++e) sum = fmaf(h[j][e], h[j][e], sum);
    }
  }
  // D > kHeld * kStride: the remaining chunks, in the same order.
  for (int i = 8 * t + kStride * kHeld; i < d; i += kStride) {
    float f[8];
    load8(x + row + i, f);
    if (kAdd) {
      float g[8];
      load8(delta + row + i, g);
      add_round((T*)nullptr, f, g);
      store8(h_out + row + i, f);
    }
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
#pragma unroll
  for (int j = 0; j < kHeld; ++j) {
    const int i = 8 * t + kStride * j;
    if (i < d) {
      float s[8];
      unpack(sv[j], s);
#pragma unroll
      for (int e = 0; e < 8; ++e)
        h[j][e] = __fmul_rn(__fmul_rn(h[j][e], r), s[e]);
      store8(y + row + i, h[j]);
    }
  }
  for (int i = 8 * t + kStride * kHeld; i < d; i += kStride) {
    float f[8], s[8];
    load8((kAdd ? (const T*)h_out : x) + row + i, f);
    load8(scale + i, s);
#pragma unroll
    for (int e = 0; e < 8; ++e) f[e] = __fmul_rn(__fmul_rn(f[e], r), s[e]);
    store8(y + row + i, f);
  }
}

template <typename T>
int launch(const void* x, const void* delta, const void* scale, void* h,
           void* y, int m, int d, float eps, void* stream) {
  if (m < 1 || d < 8 || d % 8 != 0) return (int)cudaErrorInvalidValue;
  if (delta == nullptr)
    rms_norm_kernel<T, false><<<m, kThreads, 0, (cudaStream_t)stream>>>(
        (const T*)x, nullptr, (const T*)scale, nullptr, (T*)y, d, eps);
  else
    rms_norm_kernel<T, true><<<m, kThreads, 0, (cudaStream_t)stream>>>(
        (const T*)x, (const T*)delta, (const T*)scale, (T*)h, (T*)y, d,
        eps);
  return (int)cudaGetLastError();
}

}  // namespace

// x [m, d] and y [m, d] row-major, scale [d]; all bf16 or all f32.
extern "C" int tk8s_rms_norm_bf16(const void* x, const void* scale, void* y,
                                  int m, int d, float eps, void* stream) {
  return launch<__nv_bfloat16>(x, nullptr, scale, nullptr, y, m, d, eps,
                               stream);
}
extern "C" int tk8s_rms_norm_f32(const void* x, const void* scale, void* y,
                                 int m, int d, float eps, void* stream) {
  return launch<float>(x, nullptr, scale, nullptr, y, m, d, eps, stream);
}
// The residual add fused in: h = x + delta and y = rms_norm(h), each
// [m, d] row-major and written once; x is not written. delta null is the
// entry above (h not written).
extern "C" int tk8s_add_rms_norm_bf16(const void* x, const void* delta,
                                      const void* scale, void* h, void* y,
                                      int m, int d, float eps, void* stream) {
  return launch<__nv_bfloat16>(x, delta, scale, h, y, m, d, eps, stream);
}
extern "C" int tk8s_add_rms_norm_f32(const void* x, const void* delta,
                                     const void* scale, void* h, void* y,
                                     int m, int d, float eps, void* stream) {
  return launch<float>(x, delta, scale, h, y, m, d, eps, stream);
}

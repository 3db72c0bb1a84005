// What the row kernels share (rms_norm.cu, quantize_rows.cu): a row is
// cut into 16-byte chunks of eight elements, thread t of a block of n
// threads (256 unless a kernel says otherwise) owning the chunks at i =
// 8 t + 8 n j (j = 0, 1, ...); the per-token quantizer of the W8A8
// products; and a block's fixed-order reductions.
//
// The quantizer's arithmetic, per row of values v (already rounded to
// the row's dtype):
//   amax  = max_i |v_i|                       (exact in any order)
//   scale = max(amax / qmax, 1e-8)            (IEEE division: qmax 127 or
//                                              448)
//   int8: q_i = clip(rint(v_i / scale), -127, 127)     (IEEE division,
//                                              round half to even)
//   fp8:  q_i = e4m3(clip(v_i / scale, -448, 448))      (round to nearest
//                                              even, satfinite)
// Every step is exact or one IEEE rounding, so a row is bitwise
// `ops.quantization.quantize_rows_plain` (torch's ops) of the same values.
// The build keeps fast math off (`_kernels.NVCC_FLAGS`); the divisions
// are written `__fdiv_rn` all the same.
#pragma once
#include <cuda_bf16.h>
#include <cuda_fp8.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace rows {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kStride = 8 * kThreads;  // elements between a thread's chunks

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
// v rounded to T, as a store of v to T and a load back would give it.
__device__ __forceinline__ float round_to(__nv_bfloat16*, float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}
__device__ __forceinline__ float round_to(float*, float v) { return v; }

// The scale of a row of this amax.
template <bool kInt8>
__device__ __forceinline__ float row_scale(float amax) {
  return fmaxf(__fdiv_rn(amax, kInt8 ? 127.f : 448.f), 1e-8f);
}
// One quantized value of v / scale, as its byte.
template <bool kInt8>
__device__ __forceinline__ uint32_t quantize(float v, float scale) {
  const float q = __fdiv_rn(v, scale);
  if (kInt8)
    return (uint8_t)(int8_t)fminf(fmaxf(rintf(q), -127.f), 127.f);
  return (uint8_t)__nv_cvt_float_to_fp8(fminf(fmaxf(q, -448.f), 448.f),
                                        __NV_SATFINITE, __NV_E4M3);
}
// A chunk's eight values quantized, in one 8-byte store.
template <bool kInt8>
__device__ __forceinline__ void store_q8(uint8_t* p, const float (&f)[8],
                                         float scale) {
  uint32_t w[2] = {0u, 0u};
#pragma unroll
  for (int e = 0; e < 8; ++e)
    w[e / 4] |= quantize<kInt8>(f[e], scale) << (8 * (e % 4));
  *reinterpret_cast<uint2*>(p) = make_uint2(w[0], w[1]);
}
__device__ __forceinline__ float amax8(float amax, const float (&f)[8]) {
#pragma unroll
  for (int e = 0; e < 8; ++e) amax = fmaxf(amax, fabsf(f[e]));
  return amax;
}
// The block's max of each thread's v: a fixed xor-shuffle tree in each
// warp, then (after one barrier) the block's kBlockWarps warps' maxima in
// order, in every thread. `warp_max` holds kBlockWarps floats that no
// thread reads or writes for anything else during the call.
template <int kBlockWarps = kWarps>
__device__ __forceinline__ float block_max(float v, float* warp_max) {
#pragma unroll
  for (int o = 16; o > 0; o /= 2)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  if (threadIdx.x % 32 == 0) warp_max[threadIdx.x / 32] = v;
  __syncthreads();
  float out = 0.f;
#pragma unroll
  for (int w = 0; w < kBlockWarps; ++w) out = fmaxf(out, warp_max[w]);
  return out;
}

}  // namespace rows

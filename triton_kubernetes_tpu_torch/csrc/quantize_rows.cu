// Per-token activation quantization of the W8A8 products, for Hopper
// (sm_90a).
//
// Replaces: no TPU kernel. The JAX package quantizes the activation of a
//   quantized matmul with plain XLA ops inside `quantized_einsum`
//   (triton_kubernetes_tpu/ops/quantization.py:265-305: amax over the
//   contraction axes, `quantize_with_scale`, :94-108).
//
// Computes, per row of x [M, K] (bf16 or f32):
//   amax  = max_i |x_i|                       (exact in any order)
//   scale = max(amax / qmax, 1e-8)            (IEEE division: qmax 127 or
//                                              448)
//   int8: q_i = clip(rint(x_i / scale), -127, 127)     (IEEE division,
//                                              round half to even)
//   fp8:  q_i = e4m3(clip(x_i / scale, -448, 448))      (round to nearest
//                                              even, satfinite)
// into xq [M, K] (one byte each) and x_scale [M] f32. Every step is exact
// or one IEEE rounding, so a row is bitwise its plain version
// (`ops.quantization.quantize_rows_plain`, torch's ops) and independent of
// M. The build keeps fast math off (`_kernels.NVCC_FLAGS`); the divisions
// are written `__fdiv_rn` all the same.
//
// What bounds it: bytes. A decode tick's rows are 8 x 4096 bf16 (64 KB in,
//   32 KB out), far below one launch's latency; a prefill window's 256 x
//   14336 (w2's input) 7.3 MB in, 3.7 MB out, some 3.3 us at 3.35 TB/s.
//
// Design: one block of 256 threads a row; thread t takes elements t, t +
//   256, ... (neighbouring threads on neighbouring addresses). A first
//   pass takes the row's amax (a warp's by xor shuffles, then the eight
//   warps' through shared memory); a second pass, whose reads hit the
//   L1/L2 the first pass filled, divides, rounds, clips and stores.
#include <cuda_bf16.h>
#include <cuda_fp8.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ float to_f32(float v) { return v; }

// One quantized value of x / scale, as its byte.
template <bool kInt8>
__device__ __forceinline__ uint8_t quantize(float x, float scale) {
  const float q = __fdiv_rn(x, scale);
  if (kInt8)
    return (uint8_t)(int8_t)fminf(fmaxf(rintf(q), -127.f), 127.f);
  return (uint8_t)__nv_cvt_float_to_fp8(fminf(fmaxf(q, -448.f), 448.f),
                                        __NV_SATFINITE, __NV_E4M3);
}

template <typename T, bool kInt8>
__global__ void __launch_bounds__(kThreads)
quantize_rows_kernel(const T* __restrict__ x, uint8_t* __restrict__ xq,
                     float* __restrict__ x_scale, int k) {
  __shared__ float warp_max[kThreads / 32];
  const T* row = x + (size_t)blockIdx.x * k;
  uint8_t* out = xq + (size_t)blockIdx.x * k;
  float amax = 0.f;
  for (int i = threadIdx.x; i < k; i += kThreads)
    amax = fmaxf(amax, fabsf(to_f32(row[i])));
#pragma unroll
  for (int o = 16; o > 0; o /= 2)
    amax = fmaxf(amax, __shfl_xor_sync(0xffffffffu, amax, o));
  if (threadIdx.x % 32 == 0) warp_max[threadIdx.x / 32] = amax;
  __syncthreads();
#pragma unroll
  for (int w = 0; w < kThreads / 32; ++w) amax = fmaxf(amax, warp_max[w]);
  const float scale = fmaxf(__fdiv_rn(amax, kInt8 ? 127.f : 448.f), 1e-8f);
  if (threadIdx.x == 0) x_scale[blockIdx.x] = scale;
  for (int i = threadIdx.x; i < k; i += kThreads)
    out[i] = quantize<kInt8>(to_f32(row[i]), scale);
}

template <typename T, bool kInt8>
int launch(const void* x, void* xq, void* x_scale, int m, int k,
           void* stream) {
  if (m < 1 || k < 1 || x == nullptr || xq == nullptr || x_scale == nullptr)
    return (int)cudaErrorInvalidValue;
  quantize_rows_kernel<T, kInt8><<<m, kThreads, 0, (cudaStream_t)stream>>>(
      (const T*)x, (uint8_t*)xq, (float*)x_scale, k);
  return (int)cudaGetLastError();
}

}  // namespace

// x [m, k] row-major (the suffix names its dtype, then the quantized
// one) -> xq [m, k] int8 or float8_e4m3fn bytes and x_scale [m] f32.
extern "C" int tk8s_quantize_rows_bf16_int8(const void* x, void* xq,
                                            void* x_scale, int m, int k,
                                            void* stream) {
  return launch<__nv_bfloat16, true>(x, xq, x_scale, m, k, stream);
}
extern "C" int tk8s_quantize_rows_bf16_fp8(const void* x, void* xq,
                                           void* x_scale, int m, int k,
                                           void* stream) {
  return launch<__nv_bfloat16, false>(x, xq, x_scale, m, k, stream);
}
extern "C" int tk8s_quantize_rows_f32_int8(const void* x, void* xq,
                                           void* x_scale, int m, int k,
                                           void* stream) {
  return launch<float, true>(x, xq, x_scale, m, k, stream);
}
extern "C" int tk8s_quantize_rows_f32_fp8(const void* x, void* xq,
                                          void* x_scale, int m, int k,
                                          void* stream) {
  return launch<float, false>(x, xq, x_scale, m, k, stream);
}

// Per-token activation quantization of the W8A8 products, for Hopper
// (sm_90a): kernel A, standalone and fused into the SwiGLU of w2's input.
//
// Replaces: no TPU kernel. The JAX package quantizes the activation of a
//   quantized matmul with plain XLA ops inside `quantized_einsum`
//   (triton_kubernetes_tpu/ops/quantization.py:265-305: amax over the
//   contraction axes, `quantize_with_scale`, :94-108), and computes the
//   SwiGLU of w2's input with plain ops
//   (triton_kubernetes_tpu/models/llama.py:298-302).
//
// Computes, per row of x [M, K] (bf16 or f32), the quantization of
// rows_common.cuh into xq [M, K] (one byte each) and x_scale [M] f32,
// bitwise its plain version (`ops.quantization.quantize_rows_plain`) and
// independent of M. The fused entry takes gate and up [M, F] (gate the w3
// product, up the w1 product) and quantizes
//   p_i = T(g_i * up_i),  g_i = T(silu(gate_i)),  silu(v) = v / (1 + e^-v)
// (f32 arithmetic, IEEE division, each rounding to T as torch's
// `silu(gate.float()).to(T) * up` rounds), bitwise
// `quantize_rows_plain` of that product where `expf` gives torch's bits
// (the SiLU probe, `tk8s_silu_probe_bf16`, counts the bf16 inputs where it
// does not; chip_smoke.py runs it first).
//
// What bounds it: bytes in principle. A decode tick's wo input is 8 x
//   4096 bf16 (64 KB in, 32 KB out), far below one launch's latency; a
//   prefill window's w2 input 256 x 14336, gate and up 14.7 MB in, 3.7 MB
//   out, some 5.5 us at 3.35 TB/s. The fused pass's arithmetic (expf and
//   two IEEE divisions an element, kept for the bits) is near that.
//
// Design: one block a row, of 256 threads (standalone) or 1024 (fused:
//   each element's SiLU and two IEEE divisions make a decode tick's 8 rows
//   a latency chain, which 32 warps a row shorten). Thread t owns the
//   16-byte chunks at i = 8 t + 8 threads j and loads up to kHeld of them
//   at once (the row in registers up to K 14336, F 16384), so a row is
//   read from DRAM once and costs one round trip; the amax goes through
//   one xor-shuffle tree and one barrier; the bytes leave in 8-byte
//   stores. Chunks past kHeld are read again after the barrier (from the
//   L2) and take the same operations. The amax is exact in any order and
//   every other step is per element, so no bit depends on the layout. K
//   must be a multiple of 8 and the rows 16-byte aligned (the wrapper
//   checks).
#include "rows_common.cuh"

namespace {

using namespace rows;

constexpr int kHeld = 7;  // chunks a thread keeps: K <= 14336
// The fused SwiGLU's block: 32 warps, each thread keeping 2 chunks (F <=
// 16384).
constexpr int kSwThreads = 1024;
constexpr int kSwStride = 8 * kSwThreads;
constexpr int kSwHeld = 2;

template <typename T, bool kInt8>
__global__ void __launch_bounds__(kThreads)
quantize_rows_kernel(const T* __restrict__ x, uint8_t* __restrict__ xq,
                     float* __restrict__ x_scale, int k) {
  __shared__ float warp_max[kWarps];
  const size_t row = (size_t)blockIdx.x * k;
  const int t = threadIdx.x;
  Pack<T> xv[kHeld];
#pragma unroll
  for (int j = 0; j < kHeld; ++j) {
    const int i = 8 * t + kStride * j;
    if (i < k) load(x + row + i, xv[j]);
  }
  float amax = 0.f;
#pragma unroll
  for (int j = 0; j < kHeld; ++j) {
    if (8 * t + kStride * j < k) {
      float f[8];
      unpack(xv[j], f);
      amax = amax8(amax, f);
    }
  }
  for (int i = 8 * t + kStride * kHeld; i < k; i += kStride) {
    float f[8];
    load8(x + row + i, f);
    amax = amax8(amax, f);
  }
  const float scale = row_scale<kInt8>(block_max(amax, warp_max));
  if (t == 0) x_scale[blockIdx.x] = scale;
#pragma unroll
  for (int j = 0; j < kHeld; ++j) {
    const int i = 8 * t + kStride * j;
    if (i < k) {
      float f[8];
      unpack(xv[j], f);
      store_q8<kInt8>(xq + row + i, f, scale);
    }
  }
  for (int i = 8 * t + kStride * kHeld; i < k; i += kStride) {
    float f[8];
    load8(x + row + i, f);
    store_q8<kInt8>(xq + row + i, f, scale);
  }
}

// SiLU as torch's CUDA kernel computes it on an f32 tensor:
// x / (1 + exp(-x)), the division IEEE's.
__device__ __forceinline__ float silu(float v) {
  return __fdiv_rn(v, __fadd_rn(1.f, expf(-v)));
}

// One chunk of w2's input: p = T(T(silu(gate)) * up).
template <typename T>
__device__ __forceinline__ void swiglu8(const Pack<T>& g, const Pack<T>& u,
                                        float (&p)[8]) {
  float a[8], b[8];
  unpack(g, a);
  unpack(u, b);
#pragma unroll
  for (int e = 0; e < 8; ++e)
    p[e] = round_to((T*)nullptr,
                    __fmul_rn(round_to((T*)nullptr, silu(a[e])), b[e]));
}

template <typename T, bool kInt8>
__global__ void __launch_bounds__(kSwThreads)
swiglu_quant_kernel(const T* __restrict__ gate, const T* __restrict__ up,
                    uint8_t* __restrict__ xq, float* __restrict__ x_scale,
                    int f) {
  __shared__ float warp_max[kSwThreads / 32];
  const size_t row = (size_t)blockIdx.x * f;
  const int t = threadIdx.x;
  float p[kSwHeld][8];
  float amax = 0.f;
  {
    Pack<T> gv[kSwHeld], uv[kSwHeld];
#pragma unroll
    for (int j = 0; j < kSwHeld; ++j) {
      const int i = 8 * t + kSwStride * j;
      if (i < f) {
        load(gate + row + i, gv[j]);
        load(up + row + i, uv[j]);
      }
    }
#pragma unroll
    for (int j = 0; j < kSwHeld; ++j) {
      if (8 * t + kSwStride * j < f) {
        swiglu8(gv[j], uv[j], p[j]);
        amax = amax8(amax, p[j]);
      }
    }
  }
  for (int i = 8 * t + kSwStride * kSwHeld; i < f; i += kSwStride) {
    Pack<T> g, u;
    float q[8];
    load(gate + row + i, g);
    load(up + row + i, u);
    swiglu8(g, u, q);
    amax = amax8(amax, q);
  }
  const float scale =
      row_scale<kInt8>(block_max<kSwThreads / 32>(amax, warp_max));
  if (t == 0) x_scale[blockIdx.x] = scale;
#pragma unroll
  for (int j = 0; j < kSwHeld; ++j) {
    const int i = 8 * t + kSwStride * j;
    if (i < f) store_q8<kInt8>(xq + row + i, p[j], scale);
  }
  for (int i = 8 * t + kSwStride * kSwHeld; i < f; i += kSwStride) {
    Pack<T> g, u;
    float q[8];
    load(gate + row + i, g);
    load(up + row + i, u);
    swiglu8(g, u, q);
    store_q8<kInt8>(xq + row + i, q, scale);
  }
}

__global__ void silu_probe_kernel(const __nv_bfloat16* __restrict__ x,
                                  __nv_bfloat16* __restrict__ y, int n) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i < n) y[i] = __float2bfloat16_rn(silu(__bfloat162float(x[i])));
}

bool bad_rows(const void* a, const void* xq, const void* x_scale, int m,
              int k) {
  return m < 1 || k < 8 || k % 8 != 0 || a == nullptr || xq == nullptr ||
         x_scale == nullptr;
}

template <typename T, bool kInt8>
int launch(const void* x, void* xq, void* x_scale, int m, int k,
           void* stream) {
  if (bad_rows(x, xq, x_scale, m, k)) return (int)cudaErrorInvalidValue;
  quantize_rows_kernel<T, kInt8><<<m, kThreads, 0, (cudaStream_t)stream>>>(
      (const T*)x, (uint8_t*)xq, (float*)x_scale, k);
  return (int)cudaGetLastError();
}

template <typename T, bool kInt8>
int launch_swiglu(const void* gate, const void* up, void* xq, void* x_scale,
                  int m, int f, void* stream) {
  if (bad_rows(gate, xq, x_scale, m, f) || up == nullptr)
    return (int)cudaErrorInvalidValue;
  swiglu_quant_kernel<T, kInt8><<<m, kSwThreads, 0, (cudaStream_t)stream>>>(
      (const T*)gate, (const T*)up, (uint8_t*)xq, (float*)x_scale, f);
  return (int)cudaGetLastError();
}

}  // namespace

// x [m, k] row-major (the suffix names its dtype, then the quantized
// one) -> xq [m, k] int8 or float8_e4m3fn bytes and x_scale [m] f32; k a
// multiple of 8.
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
// gate, up [m, f] row-major of one dtype -> w2's quantized input: xq
// [m, f] and x_scale [m] of T(T(silu(gate)) * up); f a multiple of 8.
extern "C" int tk8s_swiglu_quant_bf16_int8(const void* gate, const void* up,
                                           void* xq, void* x_scale, int m,
                                           int f, void* stream) {
  return launch_swiglu<__nv_bfloat16, true>(gate, up, xq, x_scale, m, f,
                                            stream);
}
extern "C" int tk8s_swiglu_quant_bf16_fp8(const void* gate, const void* up,
                                          void* xq, void* x_scale, int m,
                                          int f, void* stream) {
  return launch_swiglu<__nv_bfloat16, false>(gate, up, xq, x_scale, m, f,
                                             stream);
}
extern "C" int tk8s_swiglu_quant_f32_int8(const void* gate, const void* up,
                                          void* xq, void* x_scale, int m,
                                          int f, void* stream) {
  return launch_swiglu<float, true>(gate, up, xq, x_scale, m, f, stream);
}
extern "C" int tk8s_swiglu_quant_f32_fp8(const void* gate, const void* up,
                                         void* xq, void* x_scale, int m,
                                         int f, void* stream) {
  return launch_swiglu<float, false>(gate, up, xq, x_scale, m, f, stream);
}
// The SiLU probe: y [n] = bf16(silu(x)) of x [n] bf16, by the SwiGLU
// kernel's SiLU.
extern "C" int tk8s_silu_probe_bf16(const void* x, void* y, int n,
                                    void* stream) {
  if (n < 1 || x == nullptr || y == nullptr)
    return (int)cudaErrorInvalidValue;
  silu_probe_kernel<<<(n + 255) / 256, 256, 0, (cudaStream_t)stream>>>(
      (const __nv_bfloat16*)x, (__nv_bfloat16*)y, n);
  return (int)cudaGetLastError();
}

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
//
// The W8A8 epilogue (rms_norm_quant_kernel, the entries
// tk8s_add_rms_norm_quant_*): where the norm's output feeds W8A8 products
// only, y is not written. Its row -- rounded to T in registers, the values
// the plain path quantizes -- goes through kernel A's arithmetic
// (rows_common.cuh): a second reduction (the amax) and a second barrier,
// then xq and x_scale, bitwise quantize_rows of the y the entries above
// write. A layer boundary before a W8A8 product is then one launch, not a
// norm and a quantizer. Chunks past kHeld form y again after each barrier
// from h (or x) as written, in the same operations.
#include "rows_common.cuh"

namespace {

using namespace rows;

constexpr int kHeld = 4;  // chunks a thread keeps: D <= 8192
// What a row's epilogue writes: y (kY), or y's row quantized to int8
// (kS8) or e4m3 (kE4m3) with its scale.
enum Out { kY, kS8, kE4m3 };

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

// One row of the norm: kAdd forms and writes h = x + delta (otherwise h
// is x); kOut says what the epilogue writes (y, or xq and x_scale).
template <typename T, bool kAdd, Out kOut>
__device__ __forceinline__ void norm_row(const T* __restrict__ x,
                                         const T* __restrict__ delta,
                                         const T* __restrict__ scale,
                                         T* __restrict__ h_out,
                                         T* __restrict__ y,
                                         uint8_t* __restrict__ xq,
                                         float* __restrict__ x_scale, int d,
                                         float eps) {
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
  const T* h_back = kAdd ? (const T*)h_out : x;  // chunks past kHeld
  if constexpr (kOut == kY) {
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
      load8(h_back + row + i, f);
      load8(scale + i, s);
#pragma unroll
      for (int e = 0; e < 8; ++e) f[e] = __fmul_rn(__fmul_rn(f[e], r), s[e]);
      store8(y + row + i, f);
    }
    return;
  }
  // Quantized out: y as the kY epilogue forms it, rounded to T in
  // registers (the values the plain path quantizes: the norm's output),
  // its row's amax by a second reduction, then y's bytes; y itself is not
  // written. Chunks past kHeld form y again after the barrier.
  __shared__ float warp_max[kWarps];
  constexpr bool kInt8 = kOut == kS8;
  float amax = 0.f;
#pragma unroll
  for (int j = 0; j < kHeld; ++j) {
    if (8 * t + kStride * j < d) {
      float s[8];
      unpack(sv[j], s);
#pragma unroll
      for (int e = 0; e < 8; ++e)
        h[j][e] = round_to((T*)nullptr,
                           __fmul_rn(__fmul_rn(h[j][e], r), s[e]));
      amax = amax8(amax, h[j]);
    }
  }
  for (int i = 8 * t + kStride * kHeld; i < d; i += kStride) {
    float f[8], s[8];
    load8(h_back + row + i, f);
    load8(scale + i, s);
#pragma unroll
    for (int e = 0; e < 8; ++e)
      f[e] = round_to((T*)nullptr, __fmul_rn(__fmul_rn(f[e], r), s[e]));
    amax = amax8(amax, f);
  }
  const float qs = row_scale<kInt8>(block_max(amax, warp_max));
  if (t == 0) x_scale[blockIdx.x] = qs;
#pragma unroll
  for (int j = 0; j < kHeld; ++j) {
    const int i = 8 * t + kStride * j;
    if (i < d) store_q8<kInt8>(xq + row + i, h[j], qs);
  }
  for (int i = 8 * t + kStride * kHeld; i < d; i += kStride) {
    float f[8], s[8];
    load8(h_back + row + i, f);
    load8(scale + i, s);
#pragma unroll
    for (int e = 0; e < 8; ++e)
      f[e] = round_to((T*)nullptr, __fmul_rn(__fmul_rn(f[e], r), s[e]));
    store_q8<kInt8>(xq + row + i, f, qs);
  }
}

template <typename T, bool kAdd>
__global__ void __launch_bounds__(kThreads)
rms_norm_kernel(const T* __restrict__ x, const T* __restrict__ delta,
                const T* __restrict__ scale, T* __restrict__ h_out,
                T* __restrict__ y, int d, float eps) {
  norm_row<T, kAdd, kY>(x, delta, scale, h_out, y, nullptr, nullptr, d, eps);
}

// The norm with kernel A, the W8A8 products' per-token quantizer, as its
// epilogue (a name apart from rms_norm_kernel, so a profile counts it
// apart).
template <typename T, bool kAdd, Out kOut>
__global__ void __launch_bounds__(kThreads)
rms_norm_quant_kernel(const T* __restrict__ x, const T* __restrict__ delta,
                      const T* __restrict__ scale, T* __restrict__ h_out,
                      uint8_t* __restrict__ xq, float* __restrict__ x_scale,
                      int d, float eps) {
  norm_row<T, kAdd, kOut>(x, delta, scale, h_out, nullptr, xq, x_scale, d,
                          eps);
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

template <typename T, Out kOut>
int launch_quant(const void* x, const void* delta, const void* scale,
                 void* h, void* xq, void* x_scale, int m, int d, float eps,
                 void* stream) {
  if (m < 1 || d < 8 || d % 8 != 0 || xq == nullptr || x_scale == nullptr ||
      (delta != nullptr && h == nullptr))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (delta == nullptr)
    rms_norm_quant_kernel<T, false, kOut><<<m, kThreads, 0, s>>>(
        (const T*)x, nullptr, (const T*)scale, nullptr, (uint8_t*)xq,
        (float*)x_scale, d, eps);
  else
    rms_norm_quant_kernel<T, true, kOut><<<m, kThreads, 0, s>>>(
        (const T*)x, (const T*)delta, (const T*)scale, (T*)h, (uint8_t*)xq,
        (float*)x_scale, d, eps);
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
// The entries above with y quantized per row for a W8A8 product: h as
// above (delta null: h is x and not written), and in y's place xq [m, d]
// (int8 or float8_e4m3fn, the suffix's second part) and x_scale [m] f32,
// bitwise quantize_rows of the y those entries write.
#define TK8S_NORM_QUANT(suffix, T, kOut)                                     \
  extern "C" int tk8s_add_rms_norm_quant_##suffix(                          \
      const void* x, const void* delta, const void* scale, void* h,         \
      void* xq, void* x_scale, int m, int d, float eps, void* stream) {     \
    return launch_quant<T, kOut>(x, delta, scale, h, xq, x_scale, m, d, eps, \
                                 stream);                                   \
  }
TK8S_NORM_QUANT(bf16_int8, __nv_bfloat16, kS8)
TK8S_NORM_QUANT(bf16_fp8, __nv_bfloat16, kE4m3)
TK8S_NORM_QUANT(f32_int8, float, kS8)
TK8S_NORM_QUANT(f32_fp8, float, kE4m3)

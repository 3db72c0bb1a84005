// Thread-level CPU emulation of the CUDA features the paged kernels, the
// decode GEMM (bf16 and W8A8), the norm and the row quantizer use, so that g++ can build and run them on a
// machine without a card (emulate_paged.py rewrites the sources to include
// this first). Blocks of a launch run one after another, in a shuffled order
// (emu_set_shuffle_seed picks it; a static __shared__ array is then one
// array that each block in turn has to itself);
// each runs as blockDim std::threads with real barriers for
// __syncthreads; warp collectives (shfl, ldmatrix, mma.sync) exchange
// their operands through per-warp buffers. cp.async copies at once;
// shared memory starts as 0xff bytes (NaN) so reads of unwritten shared
// memory show. mma.sync sums its 16 (bf16) or 32 (e4m3) products in order
// in f32: the card's tensor cores round differently, so a comparison with
// the plain version is held to the card's tolerance, not to bits; what the
// emulation checks is indexing, fragment layouts, masking, the ring and the
// span merge. The int8 mma sums in int32, exactly, as the card's does.
#pragma once
#include <stdint.h>
#include <stddef.h>
#include <string.h>
#include <math.h>
#include <algorithm>
#include <barrier>
#include <functional>
#include <random>
#include <thread>
#include <vector>
#define __device__
#define __host__
#define __global__
#define __forceinline__ inline
#define __restrict__
#define __launch_bounds__(...)
#define __align__(n) alignas(n)
#define __shared__ static
struct dim3 { unsigned x, y, z; dim3(unsigned a=1, unsigned b=1, unsigned c=1):x(a),y(b),z(c){} };
struct uint3_ { unsigned x, y, z; };
inline thread_local uint3_ threadIdx, blockIdx;
inline uint3_ gridDim, blockDim;
inline thread_local unsigned char* tls_smem;
struct uint4 { unsigned x, y, z, w; };
struct uint2 { unsigned x, y; };
struct float4 { float x, y, z, w; };
struct float2 { float x, y; };
struct int2 { int x, y; };
inline int2 make_int2(int a, int b) { return {a, b}; }
inline uint4 make_uint4(unsigned a, unsigned b, unsigned c, unsigned d) { return {a,b,c,d}; }
inline float4 make_float4(float a, float b, float c, float d) { return {a,b,c,d}; }
inline float2 make_float2(float a, float b) { return {a,b}; }
inline float f_of_bits(uint32_t u) { float f; memcpy(&f, &u, 4); return f; }
inline uint32_t bits_of_f(float f) { uint32_t u; memcpy(&u, &f, 4); return u; }
struct __nv_bfloat16 { unsigned short x; };
struct __nv_bfloat162 { __nv_bfloat16 x, y; };
inline float __bfloat162float(__nv_bfloat16 b) { return f_of_bits((uint32_t)b.x << 16); }
inline __nv_bfloat16 __float2bfloat16(float f) {
  uint32_t u = bits_of_f(f);
  if ((u & 0x7fffffffu) > 0x7f800000u) return {(unsigned short)0x7fc0};
  u += 0x7fffu + ((u >> 16) & 1u);
  return {(unsigned short)(u >> 16)};
}
inline __nv_bfloat16 __float2bfloat16_rn(float f) { return __float2bfloat16(f); }
inline __nv_bfloat162 __floats2bfloat162_rn(float a, float b) { return {__float2bfloat16(a), __float2bfloat16(b)}; }
inline float __low2float(__nv_bfloat162 v) { return __bfloat162float(v.x); }
inline float __high2float(__nv_bfloat162 v) { return __bfloat162float(v.y); }
inline float2 __bfloat1622float2(__nv_bfloat162 v) { return {__low2float(v), __high2float(v)}; }
struct __nv_fp8_e4m3 {
  unsigned char __x;
  explicit operator float() const {
    const int s = __x >> 7, e = (__x >> 3) & 15, m = __x & 7;
    float v;
    if (e == 15 && m == 7) v = NAN;
    else if (e == 0) v = ldexpf((float)m / 8.f, -6);
    else v = ldexpf(1.f + (float)m / 8.f, e - 7);
    return s ? -v : v;
  }
};
inline float __fmul_rn(float a, float b) { return a * b; }
inline float __fdiv_rn(float a, float b) { return a / b; }
inline float __int2float_rn(int v) { return (float)v; }
// float -> float8_e4m3fn, round to nearest even, saturating to +-448 (the
// nearest of the 127 finite magnitudes by search; ties to the even code).
typedef unsigned char __nv_fp8_storage_t;
enum __nv_saturation_t { __NV_NOSAT, __NV_SATFINITE };
enum __nv_fp8_interpretation_t { __NV_E4M3, __NV_E5M2 };
inline __nv_fp8_storage_t __nv_cvt_float_to_fp8(float x, __nv_saturation_t,
                                                __nv_fp8_interpretation_t) {
  const unsigned char sign = signbit(x) ? 0x80 : 0;
  const float a = fminf(fabsf(x), 448.f);
  int best = 0;
  float best_d = INFINITY;
  for (int c = 0; c < 0x7f; ++c) {
    const float v = (float)__nv_fp8_e4m3{(unsigned char)c};
    const float d = fabsf(v - a);
    if (d < best_d || (d == best_d && c % 2 == 0)) { best = c; best_d = d; }
  }
  return (unsigned char)(sign | best);
}
inline float __fadd_rn(float a, float b) { return a + b; }
// The card's rsqrtf is within 2 ulp of 1 / sqrt(x); this one rounds twice.
inline float rsqrtf(float x) { return 1.f / sqrtf(x); }
inline float __expf(float x) { return expf(x); }
inline float __uint_as_float(uint32_t u) { return f_of_bits(u); }
inline uint32_t __float_as_uint(float f) { return bits_of_f(f); }
// prmt: byte n of the result is byte (s >> 4n) & 7 of the 8 bytes y:x.
inline uint32_t __byte_perm(uint32_t x, uint32_t y, uint32_t s) {
  const uint64_t xy = ((uint64_t)y << 32) | x;
  uint32_t r = 0;
  for (int n = 0; n < 4; ++n)
    r |= (uint32_t)((xy >> (8 * ((s >> (4 * n)) & 7))) & 0xff) << (8 * n);
  return r;
}
struct WarpCtx {
  std::barrier<>* bar;
  float f[32];
  uintptr_t addr[32];
  uint32_t a[32][4], b[32][2];
};
inline thread_local WarpCtx* tls_warp;
inline thread_local std::barrier<>* tls_block_bar;
inline int lane_id() { return threadIdx.x & 31; }
inline float __shfl_xor_sync(unsigned, float x, int o) {
  WarpCtx* w = tls_warp; int l = lane_id();
  w->f[l] = x; w->bar->arrive_and_wait();
  float r = w->f[l ^ o]; w->bar->arrive_and_wait();
  return r;
}
inline void __syncthreads() { tls_block_bar->arrive_and_wait(); }
inline void __threadfence() {}
// Blocks run one at a time: a plain add is atomic here.
inline int atomicAdd(int* p, int v) { int o = *p; *p += v; return o; }
inline float4 __ldcg(const float4* p) { return *p; }
inline float __ldcg(const float* p) { return *p; }
inline float2 __ldcg(const float2* p) { return *p; }
inline int2 __ldcg(const int2* p) { return *p; }
inline uintptr_t __cvta_generic_to_shared(const void* p) { return (uintptr_t)p; }
inline uintptr_t smem_u32(const void* p) { return (uintptr_t)p; }
inline void cp_async16(void* s, const void* g) { memcpy(s, g, 16); }
inline void cp_async_wait_all() {}
inline void cp_async16_zfill(void* s, const void* g, bool live) {
  if (live) memcpy(s, g, 16); else memset(s, 0, 16);
}
// ldmatrix: lane l names a row (16 bytes) of matrix l / 8.
inline void ldmatrix_common(uint32_t (&r)[4], uintptr_t addr, bool trans) {
  WarpCtx* w = tls_warp; int l = lane_id();
  w->addr[l] = addr; w->bar->arrive_and_wait();
  for (int i = 0; i < 4; ++i) {
    uint16_t e[2];
    for (int h = 0; h < 2; ++h) {
      int row, col;
      if (!trans) { row = l / 4; col = 2 * (l % 4) + h; }
      else { row = 2 * (l % 4) + h; col = l / 4; }
      memcpy(&e[h], (const void*)(w->addr[i * 8 + row] + 2 * col), 2);
    }
    r[i] = (uint32_t)e[0] | ((uint32_t)e[1] << 16);
  }
  w->bar->arrive_and_wait();
}
inline void ldmatrix_x4(uint32_t (&r)[4], uintptr_t addr) { ldmatrix_common(r, addr, false); }
inline void ldmatrix_x4_trans(uint32_t (&r)[4], uintptr_t addr) { ldmatrix_common(r, addr, true); }
inline float bf_lo(uint32_t v) { return f_of_bits(v << 16); }
inline float bf_hi(uint32_t v) { return f_of_bits(v & 0xffff0000u); }
inline void mma16816(float (&c)[4], const uint32_t (&a)[4], uint32_t b0, uint32_t b1) {
  WarpCtx* w = tls_warp; int l = lane_id();
  for (int i = 0; i < 4; ++i) w->a[l][i] = a[i];
  w->b[l][0] = b0; w->b[l][1] = b1;
  w->bar->arrive_and_wait();
  auto A = [&](int row, int k) {
    uint32_t v = w->a[(row % 8) * 4 + (k % 8) / 2][(row >= 8 ? 1 : 0) + (k >= 8 ? 2 : 0)];
    return (k % 2) ? bf_hi(v) : bf_lo(v);
  };
  auto B = [&](int k, int n) {
    uint32_t v = w->b[n * 4 + (k % 8) / 2][k >= 8 ? 1 : 0];
    return (k % 2) ? bf_hi(v) : bf_lo(v);
  };
  const int g = l / 4, t = l % 4;
  for (int e = 0; e < 4; ++e) {
    const int row = g + 8 * (e / 2), col = 2 * t + e % 2;
    float s = 0.f;
    for (int k = 0; k < 16; ++k) s += A(row, k) * B(k, col);
    c[e] += s;
  }
  w->bar->arrive_and_wait();
}
// m16n8k32 with 8-bit A (row) and B (col): register r of A holds bytes of
// row g + 8 (r % 2) at k 4 t + 16 (r / 2) .. + 3 (g = lane / 4, t = lane %
// 4); register r of B bytes of column g at k 4 t + 16 r .. + 3.
template <typename Acc, typename Val>
inline void mma16832_common(Acc (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                            uint32_t b1, Val val) {
  WarpCtx* w = tls_warp; int l = lane_id();
  for (int i = 0; i < 4; ++i) w->a[l][i] = a[i];
  w->b[l][0] = b0; w->b[l][1] = b1;
  w->bar->arrive_and_wait();
  auto A = [&](int row, int k) {
    const int lane = (row % 8) * 4 + (k % 16) / 4;
    return val((uint8_t)(w->a[lane][(row >= 8 ? 1 : 0) + (k >= 16 ? 2 : 0)] >> (8 * (k % 4))));
  };
  auto B = [&](int k, int n) {
    const int lane = n * 4 + (k % 16) / 4;
    return val((uint8_t)(w->b[lane][k >= 16 ? 1 : 0] >> (8 * (k % 4))));
  };
  const int g = l / 4, t = l % 4;
  for (int e = 0; e < 4; ++e) {
    const int row = g + 8 * (e / 2), col = 2 * t + e % 2;
    Acc s = 0;
    for (int k = 0; k < 32; ++k) s += A(row, k) * B(k, col);
    c[e] += s;
  }
  w->bar->arrive_and_wait();
}
inline void mma16832(int (&c)[4], const uint32_t (&a)[4], uint32_t b0, uint32_t b1) {
  mma16832_common(c, a, b0, b1, [](uint8_t v) { return (int)(int8_t)v; });
}
inline void mma16832(float (&c)[4], const uint32_t (&a)[4], uint32_t b0, uint32_t b1) {
  mma16832_common(c, a, b0, b1, [](uint8_t v) { return (float)__nv_fp8_e4m3{v}; });
}
typedef int cudaError_t;
typedef void* cudaStream_t;
enum { cudaSuccess = 0, cudaErrorInvalidValue = 1, cudaFuncAttributeMaxDynamicSharedMemorySize = 8 };
template <typename F> inline cudaError_t cudaFuncSetAttribute(F, int, int) { return 0; }
inline cudaError_t cudaGetLastError() { return 0; }
inline int min(int a, int b) { return a < b ? a : b; }
inline int max(int a, int b) { return a > b ? a : b; }
inline std::mt19937 emu_rng(12345);
// Reseeds the order in which the blocks of later launches run.
extern "C" void emu_set_shuffle_seed(unsigned seed) { emu_rng.seed(seed); }
template <typename F>
void emu_launch(dim3 grid, int threads, int smem, F f) {
  gridDim = {grid.x, grid.y, grid.z};
  blockDim = {(unsigned)threads, 1, 1};
  std::vector<uint3_> blocks;
  for (unsigned z = 0; z < grid.z; ++z)
    for (unsigned y = 0; y < grid.y; ++y)
      for (unsigned x = 0; x < grid.x; ++x) blocks.push_back({x, y, z});
  std::shuffle(blocks.begin(), blocks.end(), emu_rng);
  for (const uint3_& bi : blocks) {
    std::vector<unsigned char> buf(smem + 64, 0xff);  // NaN bytes: catch uninitialised reads
    unsigned char* base = (unsigned char*)(((uintptr_t)buf.data() + 63) & ~(uintptr_t)63);
    std::barrier<> block_bar(threads);
    std::vector<std::unique_ptr<std::barrier<>>> wbars;
    std::vector<WarpCtx> warps(threads / 32);
    for (int i = 0; i < threads / 32; ++i) {
      wbars.emplace_back(new std::barrier<>(32));
      warps[i].bar = wbars.back().get();
    }
    std::vector<std::thread> ts;
    for (int t = 0; t < threads; ++t)
      ts.emplace_back([&, t] {
        threadIdx = {(unsigned)t, 0, 0};
        blockIdx = bi;
        tls_smem = base;
        tls_warp = &warps[t / 32];
        tls_block_bar = &block_bar;
        f();
        tls_warp->bar->arrive_and_drop();
        block_bar.arrive_and_drop();
      });
    for (auto& th : ts) th.join();
  }
}

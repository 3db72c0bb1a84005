// Thread-level CPU emulation of the CUDA features the paged kernels, the
// decode GEMM (bf16 and W8A8, mma.sync and wgmma), the norm and the row
// quantizer use, so that g++ can build and run them on a machine without
// a card (emulate_paged.py rewrites the sources to include this first).
// Blocks of a launch run one after another, in a shuffled order
// (emu_set_shuffle_seed picks it; a static __shared__ array is then one
// array that each block in turn has to itself);
// each runs as blockDim std::threads with real barriers for
// __syncthreads and named barriers (bar.sync); warp collectives (shfl,
// ldmatrix, mma.sync) exchange their operands through per-warp buffers.
// cp.async copies at once; shared memory starts as 0xff bytes (NaN) so
// reads of unwritten shared memory show, and its base is 1,024-byte
// aligned. mbarriers count arrivals and flip their phase as the card's
// do (a waiting thread sleeps on the word). wgmma reads its operands
// through their descriptors and the 128-byte swizzle and runs at once:
// each thread sums the products of its own accumulator elements
// (fence, commit, wait, setmaxnreg and the proxy fence are no-ops).
// mma.sync and wgmma sum a k step's 16 (bf16) or 32 (e4m3) products in
// order in f32, then add that to the accumulator: the card's tensor cores
// round differently, so a comparison with the plain version is held to
// the card's tolerance, not to bits, while an emulated wgmma chain is
// bitwise the emulated mma.sync chain over the same k steps; what the
// emulation checks is indexing, fragment and descriptor layouts,
// masking, the ring and its barriers, and the merges. The int8 products
// sum in int32, exactly, as the card's do. Math functions are the host's
// (math.h): `expf` is glibc's, which need not round as the card's does,
// so a kernel that calls it (the fused SwiGLU's SiLU) is held to its own
// emulated composition, not to torch. A block may hold up to 1,024
// threads and cross any number of barriers.
#pragma once
#include <stdint.h>
#include <stddef.h>
#include <string.h>
#include <math.h>
#include <algorithm>
#include <condition_variable>
#include <barrier>
#include <memory>
#include <mutex>
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
inline uint2 make_uint2(unsigned a, unsigned b) { return {a, b}; }
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
// f16: an e4m3 pair converted exactly (every e4m3 value is a normal f16
// or zero), and an f16 read back as float.
struct __half2_raw { unsigned short x, y; };
typedef unsigned short __nv_fp8x2_storage_t;
inline unsigned short emu_f16_bits(float v) {
  const uint32_t u = bits_of_f(v), sign = (u >> 16) & 0x8000u;
  if (isnan(v)) return 0x7e00;
  if ((u & 0x7fffffffu) == 0) return (unsigned short)sign;
  const int e = (int)((u >> 23) & 0xff) - 127 + 15;  // normal in f16
  return (unsigned short)(sign | (e << 10) | ((u >> 13) & 0x3ffu));
}
inline float emu_f16_value(unsigned short h) {
  const int e = (h >> 10) & 0x1f, m = h & 0x3ff;
  float v = e == 0 ? ldexpf((float)m, -24)
            : e == 31 ? (m ? NAN : INFINITY)
                      : ldexpf((float)(m | 0x400), e - 25);
  return (h & 0x8000) ? -v : v;
}
inline __half2_raw __nv_cvt_fp8x2_to_halfraw2(__nv_fp8x2_storage_t x,
                                              __nv_fp8_interpretation_t) {
  return {emu_f16_bits((float)__nv_fp8_e4m3{(unsigned char)(x & 0xff)}),
          emu_f16_bits((float)__nv_fp8_e4m3{(unsigned char)(x >> 8)})};
}
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
// A block's named barriers (bar.sync id, threads), made by their first
// caller, and the lock and condition its mbarriers' waiters sleep on.
struct BlockSync {
  std::mutex mu;
  std::condition_variable cv;
  std::unique_ptr<std::barrier<>> bar[16];
};
inline thread_local BlockSync* tls_sync;
inline void bar_sync(int id, int threads) {
  std::barrier<>* b;
  {
    std::lock_guard<std::mutex> lock(tls_sync->mu);
    if (!tls_sync->bar[id]) tls_sync->bar[id].reset(new std::barrier<>(threads));
    b = tls_sync->bar[id].get();
  }
  b->arrive_and_wait();
}
// mbarrier: bits 0-30 arrivals pending, 32-62 the count, 63 the phase.
inline void mbar_init(uint64_t* bar, int count) {
  std::lock_guard<std::mutex> lock(tls_sync->mu);
  *bar = ((uint64_t)count << 32) | (uint64_t)count;
}
inline void mbar_arrive(uint64_t* bar) {
  std::lock_guard<std::mutex> lock(tls_sync->mu);
  const uint64_t v = *bar, pend = (v & 0x7fffffffu) - 1;
  const uint64_t count = (v >> 32) & 0x7fffffffu;
  if (pend) {
    *bar = (v & ~(uint64_t)0x7fffffffu) | pend;
    return;
  }
  *bar = ((~v) & (1ull << 63)) | (count << 32) | count;
  tls_sync->cv.notify_all();
}
// The copies landed when they were issued.
inline void mbar_arrive_copied(uint64_t* bar) { mbar_arrive(bar); }
// Returns once the phase of this parity has completed (the phase bit
// differs from it).
inline void mbar_wait(uint64_t* bar, int parity) {
  std::unique_lock<std::mutex> lock(tls_sync->mu);
  tls_sync->cv.wait(lock, [&] { return (int)(*bar >> 63) != parity; });
}
inline int lane_id() { return threadIdx.x & 31; }
inline float __shfl_xor_sync(unsigned, float x, int o) {
  WarpCtx* w = tls_warp; int l = lane_id();
  w->f[l] = x; w->bar->arrive_and_wait();
  float r = w->f[l ^ o]; w->bar->arrive_and_wait();
  return r;
}
inline void __syncthreads() { tls_block_bar->arrive_and_wait(); }
inline void __syncwarp(unsigned = 0xffffffffu) { tls_warp->bar->arrive_and_wait(); }
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
// wgmma. A descriptor holds the operand's offset in the block's shared
// memory as the card's holds its address: bits 0-13 / 16, the leading
// byte offset at 16-29, the stride byte offset at 32-45, the swizzle mode
// at 62-63 (1: 128 bytes).
inline uint64_t wg_desc(uintptr_t addr, uint32_t lead) {
  const uintptr_t off = addr - (uintptr_t)tls_smem;
  if (off >= (1u << 18) || off % 16) abort();
  return (uint64_t)(off >> 4) | ((uint64_t)(lead >> 4) << 16) |
         ((uint64_t)(1024 >> 4) << 32) | (1ull << 62);
}
// Address of byte `off` of a descriptor's operand, swizzled: the 16-byte
// chunk bits (4-6) XORed with the row bits (7-9) of the address.
inline const unsigned char* wg_at(uint64_t desc, size_t off) {
  if ((desc >> 62) != 1) abort();
  uintptr_t a = (uintptr_t)tls_smem + ((desc & 0x3fff) << 4) + off;
  a ^= ((a >> 7) & 7) << 4;
  return (const unsigned char*)a;
}
// Byte offset of (row r, byte b of its 32-byte k step) of a K-major
// operand, and of (k row kr, column n) of an MN-major bf16 one.
inline size_t wg_kmajor(uint64_t desc, int r, int b) {
  return (size_t)(r / 8) * (((desc >> 32) & 0x3fff) << 4) + (r % 8) * 128 + b;
}
inline size_t wg_mnmajor(uint64_t desc, int kr, int n) {
  return (size_t)(kr / 8) * (((desc >> 32) & 0x3fff) << 4) + (kr % 8) * 128 +
         (size_t)(n / 64) * (((desc >> 16) & 0x3fff) << 4) + 2 * (n % 64);
}
// d (64 x 2R) += A B over one k step: thread t of the warpgroup (warp w,
// lane l) owns register i, row 16 w + l / 4 + 8 ((i / 2) % 2), column
// 8 (i / 4) + 2 (l % 4) + i % 2; its k step's products summed in order,
// then added, as the emulated mma.sync does.
template <typename Acc, int R, typename Prod>
inline void wg_mma_common(Acc (&d)[R], int steps, Prod prod) {
  const int t = threadIdx.x % 128, w = t / 32, l = t % 32;
  for (int i = 0; i < R; ++i) {
    const int row = 16 * w + l / 4 + 8 * ((i / 2) % 2);
    const int col = 8 * (i / 4) + 2 * (l % 4) + i % 2;
    Acc s = 0;
    for (int k = 0; k < steps; ++k) s += prod(row, col, k);
    d[i] += s;
  }
}
inline float bf16_at(const unsigned char* p) {
  uint16_t v;
  memcpy(&v, p, 2);
  return f_of_bits((uint32_t)v << 16);
}
template <int R>
inline void wg_mma_bf16(float (&d)[R], uint64_t da, uint64_t db) {
  wg_mma_common(d, 16, [&](int row, int col, int k) {
    return bf16_at(wg_at(da, wg_kmajor(da, row, 2 * k))) *
           bf16_at(wg_at(db, wg_mnmajor(db, k, col)));
  });
}
template <int R>
inline void wg_mma_e4m3(float (&d)[R], uint64_t da, uint64_t db) {
  wg_mma_common(d, 32, [&](int row, int col, int k) {
    return (float)__nv_fp8_e4m3{*wg_at(da, wg_kmajor(da, row, k))} *
           (float)__nv_fp8_e4m3{*wg_at(db, wg_kmajor(db, col, k))};
  });
}
template <int R>
inline void wg_mma_f16(float (&d)[R], uint64_t da, uint64_t db) {
  auto f16_at = [](const unsigned char* p) {
    uint16_t v;
    memcpy(&v, p, 2);
    return emu_f16_value(v);
  };
  wg_mma_common(d, 16, [&](int row, int col, int k) {
    return f16_at(wg_at(da, wg_kmajor(da, row, 2 * k))) *
           f16_at(wg_at(db, wg_kmajor(db, col, 2 * k)));
  });
}
template <int R>
inline void wg_mma_s8(int (&d)[R], uint64_t da, uint64_t db) {
  wg_mma_common(d, 32, [&](int row, int col, int k) {
    return (int)(int8_t)*wg_at(da, wg_kmajor(da, row, k)) *
           (int)(int8_t)*wg_at(db, wg_kmajor(db, col, k));
  });
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
    std::vector<unsigned char> buf(smem + 1024, 0xff);  // NaN bytes: catch uninitialised reads
    unsigned char* base = (unsigned char*)(((uintptr_t)buf.data() + 1023) & ~(uintptr_t)1023);
    std::barrier<> block_bar(threads);
    BlockSync sync;
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
        tls_sync = &sync;
        f();
        tls_warp->bar->arrive_and_drop();
        block_bar.arrive_and_drop();
      });
    for (auto& th : ts) th.join();
  }
}

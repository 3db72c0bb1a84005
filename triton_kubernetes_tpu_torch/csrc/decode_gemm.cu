// Row-invariant matrix product of the decode and verify ticks, for Hopper
// (sm_90a).
//
// Replaces: no TPU kernel. The JAX package computes the serving products
//   with plain XLA matmuls (`weight_einsum`,
//   triton_kubernetes_tpu/models/llama.py:86; the lm head in `unembed`,
//   :397). This kernel exists to hold the reference's pinned invariant on
//   this card: a speculative verify row is bitwise the decode row at the
//   same length (tests/test_speculation.py:262). cuBLAS picks its kernel
//   (tiles, split of the sum) by the row count, so a verify tick's
//   [B * S]-row product rounds differently from a decode tick's [B]-row
//   one. Here nothing about an output element's sum depends on M.
//
// Computes: y [M, N] = x [M, K] w [K, N]; x and w bf16, row-major (w a
//   weight in the JAX layout, N contiguous); f32 accumulators; y rounded
//   once to bf16 (the projections), or kept f32 (the lm head: the
//   reference's preferred_element_type). A model served in f32 has f32
//   x and w and f32 y: that product has its own kernel at the end of this
//   file (CUDA cores, one fmaf chain over K per output element).
//
// What bounds it on this card: bytes. At M <= 64 a product does 2 M FLOPs
//   per weight element read, far below the ~295 FLOPs a byte at which the
//   tensor cores and not HBM would limit it, so the bound is the weight
//   bytes over 3.35 TB/s.
//
// Design: one block (four warps) per 64 output columns and every row of
//   x, so each weight element is read from HBM once per call for any
//   M <= 64 (the wrapper runs larger M in launches of 64 rows). K is
//   walked in tiles of 64 through a ring of kStages shared-memory stages
//   kept full by 16-byte cp.async copies, each 128-byte row XOR-swizzled
//   (chunk c of row r at c ^ r % 8) so that ldmatrix reads are free of
//   bank conflicts; rows of x past M and columns past N are zero-filled
//   copies and never stored. Warp w owns columns 16 w .. 16 w + 15 of the
//   tile and sums the whole K itself, in increasing k, with mma.sync
//   m16n8k16 (bf16 in, f32 accumulate): A fragments by ldmatrix, B
//   fragments by ldmatrix.trans from the [k][n] tile. An output element
//   is the same chain of mma steps over the same K order whatever M is,
//   and an mma's row does not see the other rows of its tile, so the
//   number of 16-row tiles instantiated (MT = 1, 2 or 4, from M) changes
//   no bit of a row. No split of K, no atomics.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;  // four warps
constexpr int kBn = 64;        // output columns a block
constexpr int kBk = 64;        // k a stage: one 128-byte row of bf16
constexpr int kStages = 6;
constexpr int kMaxRows = 64;   // rows a launch

template <int MT>
__host__ __device__ constexpr int stage_bytes() {
  return (MT * 16 + kBk) * 128;  // the x tile, then the w tile
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

// Byte offset of 16-byte chunk c of row r of a tile of 128-byte rows.
__device__ __forceinline__ uint32_t swz(int r, int c) {
  return (uint32_t)(r * 128 + ((c ^ (r & 7)) << 4));
}

__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           bool live) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(live ? 16 : 0));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4],
                                            uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4],
                                                  uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

// c (16 x 8, f32) += a (16 x 16, bf16) b (16 x 8, bf16).
__device__ __forceinline__ void mma16816(float (&c)[4],
                                         const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

template <typename Out>
__device__ __forceinline__ void store2(Out* p, float a, float b);
template <>
__device__ __forceinline__ void store2<float>(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}
template <>
__device__ __forceinline__ void store2<__nv_bfloat16>(__nv_bfloat16* p,
                                                      float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
}

// Issue the copies of k tile kt into one stage: x rows 0 .. 16 MT - 1
// (zero past m), then w rows k0 .. k0 + 63 at columns n0 .. n0 + 63 (zero
// past k and n). Thread t keeps chunk t % 8 and takes every 16th row, so
// its swizzle term is fixed.
template <int MT>
__device__ __forceinline__ void load_stage(unsigned char* stage,
                                           const __nv_bfloat16* x,
                                           const __nv_bfloat16* w, int m,
                                           int n, int k, int n0, int kt) {
  const int t = threadIdx.x, c = t % 8, r0 = t / 8;
  const int k0 = kt * kBk;
  const uint32_t base = smem_addr(stage);
  const bool k_live = k0 + 8 * c < k;
#pragma unroll
  for (int p = 0; p < MT; ++p) {
    const int r = r0 + 16 * p;
    const bool live = r < m && k_live;
    cp_async16(base + swz(r, c), live ? x + (size_t)r * k + k0 + 8 * c : x,
               live);
  }
  const uint32_t wbase = base + MT * 16 * 128;
  const bool n_live = n0 + 8 * c < n;
#pragma unroll
  for (int p = 0; p < kBk / 16; ++p) {
    const int r = r0 + 16 * p;
    const bool live = n_live && k0 + r < k;
    cp_async16(wbase + swz(r, c),
               live ? w + (size_t)(k0 + r) * n + n0 + 8 * c : w, live);
  }
}

template <int MT, typename Out>
__global__ void __launch_bounds__(kThreads)
decode_gemm_kernel(const __nv_bfloat16* __restrict__ x,
                   const __nv_bfloat16* __restrict__ w, Out* __restrict__ y,
                   int m, int n, int k) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int n0 = blockIdx.x * kBn;
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int nk = (k + kBk - 1) / kBk;

  float acc[MT][2][4];
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;

#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < nk)
      load_stage<MT>(smem + s * stage_bytes<MT>(), x, w, m, n, k, n0, s);
    cp_async_commit();
  }

  // ldmatrix row addresses: lane l names row (l % 8) + 8 ((l / 8) % 2) of
  // a 16-row block and 16-byte chunk l / 16 of a 16-column step.
  const int lr = (lane % 8) + 8 * ((lane / 8) % 2), lc = lane / 16;
  for (int kt = 0; kt < nk; ++kt) {
    cp_async_wait<kStages - 2>();
    __syncthreads();  // tile kt has landed; stage kt - 1 is free
    const int next = kt + kStages - 1;
    if (next < nk)
      load_stage<MT>(smem + (next % kStages) * stage_bytes<MT>(), x, w, m, n,
                     k, n0, next);
    cp_async_commit();

    const uint32_t xs = smem_addr(smem + (kt % kStages) * stage_bytes<MT>());
    const uint32_t ws = xs + MT * 16 * 128;
#pragma unroll
    for (int kk = 0; kk < kBk / 16; ++kk) {
      uint32_t b[4];  // b0, b1 of column tile 0, then of column tile 1
      ldmatrix_x4_trans(b, ws + swz(16 * kk + lr, 2 * warp + lc));
#pragma unroll
      for (int i = 0; i < MT; ++i) {
        uint32_t a[4];
        ldmatrix_x4(a, xs + swz(16 * i + lr, 2 * kk + lc));
        mma16816(acc[i][0], a, b[0], b[1]);
        mma16816(acc[i][1], a, b[2], b[3]);
      }
    }
  }
  cp_async_wait<0>();

  // Accumulator element e of an m16n8 tile: row g + 8 (e / 2), columns
  // 2 (lane % 4) + e % 2 (g = lane / 4). N is a multiple of 8, so a
  // column pair is live or dead together.
  const int g = lane / 4, cc = 2 * (lane % 4);
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const int col = n0 + 16 * warp + 8 * j + cc;
      if (col >= n) continue;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int row = 16 * i + g + 8 * h;
        if (row < m)
          store2<Out>(y + (size_t)row * n + col, acc[i][j][2 * h],
                      acc[i][j][2 * h + 1]);
      }
    }
}

template <int MT, typename Out>
int launch_mt(const void* x, const void* w, void* y, int m, int n, int k,
              cudaStream_t stream) {
  constexpr int smem = kStages * stage_bytes<MT>();
  cudaError_t e = cudaFuncSetAttribute(
      decode_gemm_kernel<MT, Out>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return (int)e;
  decode_gemm_kernel<MT, Out>
      <<<(n + kBn - 1) / kBn, kThreads, smem, stream>>>(
          (const __nv_bfloat16*)x, (const __nv_bfloat16*)w, (Out*)y, m, n,
          k);
  return (int)cudaGetLastError();
}

template <typename Out>
int launch(const void* x, const void* w, void* y, int m, int n, int k,
           void* stream) {
  if (m < 1 || m > kMaxRows || n < 8 || n % 8 != 0 || k < 8 || k % 8 != 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (m <= 16) return launch_mt<1, Out>(x, w, y, m, n, k, s);
  if (m <= 32) return launch_mt<2, Out>(x, w, y, m, n, k, s);
  return launch_mt<4, Out>(x, w, y, m, n, k, s);
}

// f32 operands. There is no full-f32 tensor-core product, so this one is
// on the CUDA cores, in the same grid: one block per 64 output columns
// and every row, each weight element read from HBM once per call. K is
// walked in tiles of kF32Bk staged through shared memory; thread t owns
// column t % 64 and rows t / 64 + 4 i, and sums each output with fmaf
// over k in increasing order. That chain is the same whatever M is, so a
// row's bits are too. Rows past M are neither loaded nor summed.
constexpr int kF32Threads = 256;
constexpr int kF32Bk = 32;
constexpr int kF32RowGroups = kF32Threads / kBn;  // 4
constexpr int kF32RowsPerThread = kMaxRows / kF32RowGroups;  // 16

__global__ void __launch_bounds__(kF32Threads)
decode_gemm_f32_kernel(const float* __restrict__ x,
                       const float* __restrict__ w, float* __restrict__ y,
                       int m, int n, int k) {
  __shared__ float xs[kMaxRows][kF32Bk];
  __shared__ float ws[kF32Bk][kBn];
  const int t = threadIdx.x, col = t % kBn, rg = t / kBn;
  const int n0 = blockIdx.x * kBn;
  // Warp-uniform: a warp's 32 threads share rg.
  const int rows = (m - rg + kF32RowGroups - 1) / kF32RowGroups;

  float acc[kF32RowsPerThread];
#pragma unroll
  for (int i = 0; i < kF32RowsPerThread; ++i) acc[i] = 0.f;

  for (int k0 = 0; k0 < k; k0 += kF32Bk) {
    for (int e = t; e < m * kF32Bk; e += kF32Threads) {
      const int r = e / kF32Bk, c = e % kF32Bk;
      xs[r][c] = k0 + c < k ? x[(size_t)r * k + k0 + c] : 0.f;
    }
    for (int e = t; e < kF32Bk * kBn; e += kF32Threads) {
      const int r = e / kBn, c = e % kBn;
      ws[r][c] = (k0 + r < k && n0 + c < n)
                     ? w[(size_t)(k0 + r) * n + n0 + c]
                     : 0.f;
    }
    __syncthreads();
#pragma unroll 4
    for (int kk = 0; kk < kF32Bk; ++kk) {
      const float wv = ws[kk][col];
#pragma unroll
      for (int i = 0; i < kF32RowsPerThread; ++i)
        if (i < rows)
          acc[i] = fmaf(xs[rg + kF32RowGroups * i][kk], wv, acc[i]);
    }
    __syncthreads();
  }
  if (n0 + col >= n) return;
#pragma unroll
  for (int i = 0; i < kF32RowsPerThread; ++i)
    if (i < rows)
      y[(size_t)(rg + kF32RowGroups * i) * n + n0 + col] = acc[i];
}

int launch_f32(const void* x, const void* w, void* y, int m, int n, int k,
               void* stream) {
  if (m < 1 || m > kMaxRows || n < 8 || n % 8 != 0 || k < 8 || k % 8 != 0)
    return (int)cudaErrorInvalidValue;
  decode_gemm_f32_kernel<<<(n + kBn - 1) / kBn, kF32Threads, 0,
                           (cudaStream_t)stream>>>(
      (const float*)x, (const float*)w, (float*)y, m, n, k);
  return (int)cudaGetLastError();
}

}  // namespace

// x [m, k], w [k, n], y [m, n], all row-major; the suffix names x's and
// w's dtype, then y's. 1 <= m <= 64; n and k multiples of 8.
extern "C" int tk8s_decode_gemm_bf16_bf16(const void* x, const void* w,
                                          void* y, int m, int n, int k,
                                          void* stream) {
  return launch<__nv_bfloat16>(x, w, y, m, n, k, stream);
}
extern "C" int tk8s_decode_gemm_bf16_f32(const void* x, const void* w,
                                         void* y, int m, int n, int k,
                                         void* stream) {
  return launch<float>(x, w, y, m, n, k, stream);
}
extern "C" int tk8s_decode_gemm_f32_f32(const void* x, const void* w,
                                        void* y, int m, int n, int k,
                                        void* stream) {
  return launch_f32(x, w, y, m, n, k, stream);
}

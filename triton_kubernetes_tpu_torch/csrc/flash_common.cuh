// Device helpers shared by the three flash-attention kernels
// (flash_fwd.cu, flash_bwd_dq.cu, flash_bwd_dkv.cu).
//
// Operands are [B, S, H, D] tensors read through their strides (unit
// stride in D). A tile is 64 rows of one head -- 64 queries or 64 keys --
// staged into shared memory in the input dtype T by 16-byte cp.async
// copies, all issued at once; rows past the sequence are zero-filled. A
// staged row is D + 16/sizeof(T) elements long: the 16 bytes of padding
// put the rows that eight threads read in one shared-memory phase on
// different banks.
//
// The score products run on the CUDA cores in f32 from operands converted
// exactly from T, so a product of two tiles is the f32 dot of the same
// numbers the reference multiplies; only the summation order differs.
#pragma once

#include "paged_common.cuh"

namespace flash {

constexpr int kTile = 64;         // rows (queries or keys) per tile
constexpr int kMaxDim = 128;      // one output column per thread
constexpr int kSp = kTile + 4;    // f32 row stride of a score tile

// Strides of a [B, S, H, D] operand, in elements.
struct Strides {
  long long b, s, h;
};

// Row stride of a staged tile, in elements.
template <typename T>
__host__ __device__ constexpr int staged_ld(int d) {
  return d + vec_of<T>();
}

__device__ __forceinline__ size_t at(const Strides& st, int b, int s, int h) {
  return (size_t)b * st.b + (size_t)s * st.s + (size_t)h * st.h;
}

// Issue the copies of rows row0 .. row0+63 of head h of batch b into
// sh [kTile][staged_ld<T>(d)]; rows at or past n are zero-filled. The
// caller waits (cp_async_wait_all) and synchronises before reading.
template <typename T, int NT>
__device__ __forceinline__ void stage_tile(T* sh, const T* base,
                                           const Strides& st, int b, int h,
                                           int row0, int n, int d) {
  constexpr int vec = vec_of<T>();
  const int ld = staged_ld<T>(d);
  const int row_vecs = d / vec;
  for (int i = threadIdx.x; i < kTile * row_vecs; i += NT) {
    const int r = i / row_vecs, c = (i % row_vecs) * vec;
    T* dst = sh + r * ld + c;
    if (row0 + r < n)
      cp_async16(dst, base + at(st, b, row0 + r, h) + c);
    else
      *reinterpret_cast<uint4*>(dst) = make_uint4(0u, 0u, 0u, 0u);
  }
}

// Register-tiled product of two staged tiles: with NT threads, thread
// (rg = tid / 8, kg = tid % 8) computes rows rg + (NT/8) i (i < RI) of A
// against rows kg + 8 j (j < 8) of B over the first d columns:
//   acc[i][j] = sum_c A[rg + (NT/8) i][c] * B[kg + 8 j][c]      (f32)
// One 16-byte read of B feeds RI * vec FMAs, one of A 8 * vec.
template <typename T, int NT>
__device__ __forceinline__ void tile_dot(const T* a, const T* bm, int d,
                                         float (&acc)[kTile * 8 / NT][8]) {
  constexpr int RI = kTile * 8 / NT;
  constexpr int vec = vec_of<T>();
  const int ld = staged_ld<T>(d);
  const int rg = threadIdx.x / 8, kg = threadIdx.x % 8;
#pragma unroll
  for (int i = 0; i < RI; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;
  for (int c = 0; c < d; c += vec) {
    float av[RI][vec];
#pragma unroll
    for (int i = 0; i < RI; ++i)
      load16_as_f32(a + (rg + (NT / 8) * i) * ld + c, av[i]);
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      float bv[vec];
      load16_as_f32(bm + (kg + 8 * j) * ld + c, bv);
#pragma unroll
      for (int i = 0; i < RI; ++i) {
        float s = acc[i][j];
#pragma unroll
        for (int e = 0; e < vec; ++e) s = fmaf(av[i][e], bv[e], s);
        acc[i][j] = s;
      }
    }
  }
}

}  // namespace flash

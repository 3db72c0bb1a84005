// Tensor-core building blocks of the bf16 flash-attention kernels
// (flash_fwd.cu, flash_bwd_dkv.cu): Hopper's warpgroup matrix multiply
// (wgmma, sm_90a only), its shared-memory descriptors, the 128-byte
// swizzled tile layout it reads, and the copies that fill such tiles.
//
// A tile is ROWS rows (queries or keys) of one head, D = 64 or 128 bf16
// values each. It is stored as D / 64 column blocks of [ROWS][64]: a row
// of a block is 128 bytes, eight rows are one 1,024-byte swizzle atom,
// and the 16-byte chunk c of row r sits at chunk c ^ (r % 8). That one
// layout serves wgmma both ways:
//   * K-major (the product contracts over D: Q K^T, K Q^T, V dO^T): rows
//     are the M or N index, k-steps of 16 columns advance the start
//     address by 32 bytes inside a block and by one block every four;
//   * MN-major, the trans-b form (the product contracts over the rows:
//     P V, P^T dO, dS^T Q): rows are the K index, k-steps advance by 16
//     rows (2,048 bytes), and the leading byte offset is the stride
//     between the column blocks.
// Tiles start 1,024-byte aligned, so the descriptors' base offset is 0.
//
// Copies: 16-byte cp.async, each thread writing to the swizzled address
// itself, rather than TMA: the operands are strided [B, S, H, D] views
// whose tensor maps would have to be encoded per call with
// cuTensorMapEncodeTiled, from a library (libcuda) the build does not
// link. A row past the sequence is a copy
// of source size 0, which writes zeros. Both kernels give the copies to a
// warpgroup of their own, which hands its registers to the two that
// multiply (setmaxnreg) and tracks each ring stage with two mbarriers:
// one counts the copying threads as their copies land, the other the
// multiplying warps as they finish with the stage. wgmma reads shared
// memory through the async proxy, so fence.proxy.async sits between the
// wait for a stage and the products that read it.
//
// Fragments (PTX ISA, wgmma m64nNk16, f32 accumulators): thread t of a
// warpgroup (warp w = t / 32, lane l) holds, in accumulator register i,
//   row 16 w + l / 4 + 8 ((i / 2) % 2), column 8 (i / 4) + 2 (l % 4) + i % 2.
// The bf16 A operand of a 16-column k-step kk is four registers of two
// values: exactly accumulator registers 8 kk .. 8 kk + 7 rounded and
// packed in pairs, which is how a score tile becomes the next product's A
// operand without leaving the registers.
#pragma once

#include "flash_common.cuh"

namespace flash {
namespace tc {

constexpr int kRowBytes = 128;   // one row of a 64-column block
constexpr int kAtomBytes = 1024; // eight rows: one swizzle atom
constexpr int kWarpgroup = 128;  // threads

// Bytes of a [rows][D] tile.
__host__ __device__ constexpr int tile_bytes(int rows, int d) {
  return rows * d * 2;
}

// Byte offset of element (r, c) of a [ROWS][D] tile (c a multiple of 8
// addresses a 16-byte chunk).
template <int ROWS>
__device__ __forceinline__ uint32_t swizzled(int r, int c) {
  return (uint32_t)((c >> 6) * (ROWS * kRowBytes) + r * kRowBytes +
                    ((((c >> 3) & 7) ^ (r & 7)) << 4) + ((c & 7) << 1));
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

// 16-byte asynchronous copy that writes zeros instead when `live` is
// false (source size 0: nothing is read), so a ragged tile is filled by
// copies alone and one barrier tracks all of it.
__device__ __forceinline__ void cp_async16_or_zero(void* smem,
                                                   const void* gmem,
                                                   bool live) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_addr(smem)),
               "l"(gmem), "r"(live ? 16 : 0));
}

// The same for one 4-byte value.
__device__ __forceinline__ void cp_async4_or_zero(void* smem,
                                                  const void* gmem,
                                                  bool live) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   smem_addr(smem)),
               "l"(gmem), "r"(live ? 4 : 0));
}

// Issue the copies of rows row0 .. row0 + ROWS - 1 of head h of batch b
// into the swizzled tile at `tile`, by NT threads of which this is thread
// t; rows at or past n are zero-filled. A thread keeps its 16-byte column
// and takes every (NT / chunks)-th row, a multiple of 8, so its swizzle
// term is fixed and both addresses advance by constants. The caller
// arrives on the stage's barrier (barrier_arrive_when_copied).
template <int ROWS, int D, int NT>
__device__ __forceinline__ void load_tile(unsigned char* tile,
                                          const __nv_bfloat16* base,
                                          const Strides& st, int b, int h,
                                          int row0, int n, int t) {
  constexpr int chunks = D / 8;
  constexpr int pass_rows = NT / chunks;
  static_assert(NT % chunks == 0 && pass_rows % 8 == 0 &&
                    ROWS % pass_rows == 0,
                "a pass covers whole swizzle atoms");
  const int r0 = t / chunks, c = (t % chunks) * 8;
  // Rows past n are never read: their source stays at the tile's first.
  const __nv_bfloat16* row = base + at(st, b, row0, h) + c;
  const size_t pass_step = (size_t)pass_rows * st.s;
  const __nv_bfloat16* src = row + (size_t)r0 * st.s;
  unsigned char* dst = tile + swizzled<ROWS>(r0, c);
#pragma unroll
  for (int p = 0; p < ROWS / pass_rows; ++p) {
    const bool live = row0 + r0 + p * pass_rows < n;
    cp_async16_or_zero(dst, live ? src : row, live);
    src += pass_step;
    dst += pass_rows * kRowBytes;
  }
}

// Orders shared memory written by copies (the generic proxy) before this
// thread's later wgmma reads of it (the async proxy).
__device__ __forceinline__ void proxy_fence() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}
// Barrier over the 128 threads of warpgroup wg (barrier 0 is the block's).
__device__ __forceinline__ void warpgroup_sync(int wg) {
  asm volatile("bar.sync %0, 128;\n" ::"r"(wg + 1) : "memory");
}

// Turn taking between the two multiplying warpgroups of a block: named
// barrier 3 + wg belongs to warpgroup wg, which waits on it (`turn_take`)
// until the other has signalled it (`turn_give`); each completes on 256
// arrivals, 128 of either kind. (Barriers 1 and 2 are warpgroup_sync's.)
__device__ __forceinline__ void turn_take(int wg) {
  asm volatile("bar.sync %0, 256;\n" ::"r"(wg + 3) : "memory");
}
__device__ __forceinline__ void turn_give(int wg) {
  asm volatile("bar.arrive %0, 256;\n" ::"r"(wg + 3) : "memory");
}

// Shared-memory barriers (mbarrier) between the copying warpgroup and
// the ones that multiply: `arrive_when_copied` makes the barrier count
// this thread once all the copies it has issued have landed; `wait`
// spins until the barrier's phase of the given parity has completed.
__device__ __forceinline__ void barrier_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(
                   smem_addr(bar)),
               "r"(count));
}
__device__ __forceinline__ void barrier_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(
                   smem_addr(bar))
               : "memory");
}
__device__ __forceinline__ void barrier_arrive_when_copied(uint64_t* bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];\n" ::
                   "r"(smem_addr(bar))
               : "memory");
}
__device__ __forceinline__ void barrier_wait(uint64_t* bar, int parity) {
  uint32_t done;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(smem_addr(bar)), "r"(parity)
        : "memory");
  } while (!done);
}
// Move registers between warpgroups: the copying one gives up all but N,
// the multiplying ones take up to N (multiples of 8).
template <int N>
__device__ __forceinline__ void registers_release() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(N));
}
template <int N>
__device__ __forceinline__ void registers_take() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(N));
}

// Descriptor of a 128-byte-swizzled operand starting at shared address
// `addr`: bits 0-13 address / 16, 16-29 leading byte offset / 16, 32-45
// stride byte offset / 16 (1,024: from one atom of eight rows to the
// next), 62-63 layout 1 (128-byte swizzle). The leading offset is read
// only in the MN-major form (K-major passes the conventional 16).
__device__ __forceinline__ uint64_t descriptor(uint32_t addr,
                                               uint32_t leading_bytes) {
  return (uint64_t)((addr & 0x3FFFFu) >> 4) |
         ((uint64_t)(leading_bytes >> 4) << 16) |
         ((uint64_t)(kAtomBytes >> 4) << 32) | (1ull << 62);
}

__device__ __forceinline__ void mma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void mma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
// Wait for every committed product of this warpgroup.
__device__ __forceinline__ void mma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}
// After mma_wait: keeps the compiler from moving reads of an accumulator
// above the wait (it does not know the products write it asynchronously).
template <int N>
__device__ __forceinline__ void mma_landed(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

#define TK8S_WG_D8(o)                                                  \
  "+f"(d[o]), "+f"(d[o + 1]), "+f"(d[o + 2]), "+f"(d[o + 3]),          \
      "+f"(d[o + 4]), "+f"(d[o + 5]), "+f"(d[o + 6]), "+f"(d[o + 7])
#define TK8S_WG_D32(o) \
  TK8S_WG_D8(o), TK8S_WG_D8(o + 8), TK8S_WG_D8(o + 16), TK8S_WG_D8(o + 24)
#define TK8S_WG_P32                                                    \
  "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "  \
  "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "  \
  "%28, %29, %30, %31"
#define TK8S_WG_P64                                                    \
  TK8S_WG_P32 ", %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, "   \
  "%42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, "  \
  "%55, %56, %57, %58, %59, %60, %61, %62, %63"

// d (64 x N, f32) = A B (+ d if accumulate), bf16 operands. `mma_ss`: A
// (64 x 16, K-major) and B (N x 16, K-major) from shared memory. `mma_rs`:
// A from registers, B (16 x N) from shared memory in the MN-major
// (trans-b) form. N = 64 for 32 accumulator registers, 128 for 64.
__device__ __forceinline__ void mma_ss(float (&d)[32], uint64_t da,
                                       uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{" TK8S_WG_P32 "}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : TK8S_WG_D32(0)
      : "l"(da), "l"(db), "r"(accumulate));
}
__device__ __forceinline__ void mma_ss(float (&d)[64], uint64_t da,
                                       uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{" TK8S_WG_P64 "}, %64, %65, p, 1, 1, 0, 0;\n}\n"
      : TK8S_WG_D32(0), TK8S_WG_D32(32)
      : "l"(da), "l"(db), "r"(accumulate));
}
__device__ __forceinline__ void mma_rs(float (&d)[32],
                                       const uint32_t (&a)[4], uint64_t db,
                                       int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{" TK8S_WG_P32 "}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : TK8S_WG_D32(0)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db),
        "r"(accumulate));
}
__device__ __forceinline__ void mma_rs(float (&d)[64],
                                       const uint32_t (&a)[4], uint64_t db,
                                       int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{" TK8S_WG_P64 "}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : TK8S_WG_D32(0), TK8S_WG_D32(32)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db),
        "r"(accumulate));
}

#undef TK8S_WG_D8
#undef TK8S_WG_D32
#undef TK8S_WG_P32
#undef TK8S_WG_P64

// d = A B^T over D, both K-major tiles: A rows a_row0 .. +63 of a
// [A_ROWS][D] tile at a_addr, B all rows of a [B_ROWS][D] tile at b_addr
// (B_ROWS = the accumulator's N). Issues D / 16 products; the caller
// fences before and commits after.
template <int D, int A_ROWS, int B_ROWS, int NR>
__device__ __forceinline__ void product_over_d(float (&d)[NR],
                                               uint32_t a_addr, int a_row0,
                                               uint32_t b_addr) {
  static_assert(NR * 2 == B_ROWS, "accumulator width is B's rows");
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    const uint32_t a = a_addr + (kk / 4) * (A_ROWS * kRowBytes) +
                       a_row0 * kRowBytes + (kk % 4) * 32;
    const uint32_t bb = b_addr + (kk / 4) * (B_ROWS * kRowBytes) +
                        (kk % 4) * 32;
    mma_ss(d, descriptor(a, 16), descriptor(bb, 16), kk > 0);
  }
}

// d += A B over the B tile's rows: A (64 x B_ROWS) in registers as
// B_ROWS / 16 packed k-steps, B a [B_ROWS][D] tile at b_addr read in the
// MN-major form (D = the accumulator's N).
template <int D, int B_ROWS, int NR>
__device__ __forceinline__ void product_over_rows(
    float (&d)[NR], const uint32_t (&a)[B_ROWS / 16][4], uint32_t b_addr) {
  static_assert(NR * 2 == D, "accumulator width is D");
#pragma unroll
  for (int kk = 0; kk < B_ROWS / 16; ++kk)
    mma_rs(d, a[kk],
           descriptor(b_addr + kk * 16 * kRowBytes, B_ROWS * kRowBytes), 1);
}

// Two f32 values rounded to bf16 and packed, the lower column in the low
// half: one register of an A operand.
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// 2^x by the special-function unit (2 ulp; -inf and anything below -126
// give 0).
__device__ __forceinline__ float exp2_fast(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// Max and sum over the four lanes that share an accumulator row.
__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}
__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

// Round a warpgroup's 64 x D accumulator to bf16 into rows row0 .. +63 of
// a [ROWS][D] swizzled tile (conflict-free: the eight rows of a warp's
// store hit eight different chunks), then copy the rows below `live` out
// to `dst` (row stride `ld` elements) in 16-byte pieces.
template <int ROWS, int D, int NR>
__device__ __forceinline__ void store_rows(unsigned char* tile, int row0,
                                           int wg, const float (&d)[NR],
                                           __nv_bfloat16* dst, size_t ld,
                                           int live) {
  const int t = threadIdx.x % kWarpgroup;
  const int r_lo = row0 + 16 * (t / 32) + (t % 32) / 4;
  warpgroup_sync(wg);  // every warp's products have read these rows
#pragma unroll
  for (int i = 0; i < NR; i += 2) {
    const int r = r_lo + 8 * ((i / 2) % 2);
    const int c = 8 * (i / 4) + 2 * (t % 4);
    *reinterpret_cast<__nv_bfloat162*>(tile + swizzled<ROWS>(r, c)) =
        __floats2bfloat162_rn(d[i], d[i + 1]);
  }
  warpgroup_sync(wg);
  constexpr int chunks = D / 8;
  for (int i = t; i < 64 * chunks; i += kWarpgroup) {
    const int r = i / chunks, c = (i % chunks) * 8;
    if (r < live)
      *reinterpret_cast<uint4*>(dst + (size_t)r * ld + c) =
          *reinterpret_cast<const uint4*>(tile + swizzled<ROWS>(row0 + r, c));
  }
}

}  // namespace tc
}  // namespace flash

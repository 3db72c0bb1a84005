// Causal GQA flash-attention backward, dK and dV, for Hopper (sm_90a).
//
// Replaces: the TPU kernel `_dkv_kernel`
//   (triton_kubernetes_tpu/ops/flash_attention.py:230, launched by
//   `_flash_backward` at :316), together with the group sum the reference
//   runs outside it (:342-343).
//
// Computes: for each key of KV head hk, over the group's query heads h and
//   every query that sees the key (q, dO [B, S, Hq, D], lse and
//   D = rowsum(dO * O) f32 [B, Hq, S]):
//     p  = exp(q k^T * scale - lse)          (f32, causal)
//     dv += round(p)^T dO                    (f32)
//     ds = round(p * (dO v^T - D) * scale)
//     dk += ds^T q                           (f32)
//   dk, dv are [B, S, Hkv, D] in T, contiguous.
//
// What bounds it on this card: 8 * D FLOPs per (query, visible key) pair:
//   operations, and only the tensor cores reach that bound.
//
// Two kernels, chosen by (dtype, D) in one table in ops/_kernels.py and
// passed in as `variant`. Both take one block per (batch * KV head, tile
// of keys), stage its K and V once, and walk the group's query heads and,
// for each, the query tiles from the diagonal on, so dK and dV of a KV
// head are summed in f32 registers across the whole group and written
// once: the reference's [B * Hq, S, D] f32 partials and its outside group
// sum are gone (only the f32 summation order differs). The first key
// tiles have the longest walks and are launched first.
//
// 1. Tensor cores (`flash_bwd_dkv_tc_kernel`, bf16 at D 64 or 128). A
//    block is 128 keys: two warpgroups that multiply, 64 keys each, and a
//    third that only copies. The copying warpgroup stages K and V once
//    and keeps a ring of three query tiles of 64 (Q, dO, lse, D) full
//    with cp.async copies into 128-byte-swizzled shared memory, a
//    shared-memory barrier per stage each way, and gives its registers
//    up to the other two (setmaxnreg). The score tiles are computed
//    transposed, S^T = K Q^T and dP^T = V dO^T (wgmma, both operands in
//    shared memory), so that P^T and dS^T -- computed in the accumulator
//    registers, lse and D indexed by column -- are already laid out as
//    the A operands of dV += P^T dO and dK += dS^T Q, whose B operands
//    are the same dO and Q tiles read in the trans-b form. Nothing of a
//    score tile touches shared memory. dK and dV (64 x D f32 each a
//    warpgroup) live in registers for the whole walk and leave through
//    the block's K and V tiles in 16-byte rows. The two warpgroups meet
//    at no block barrier and take turns issuing their bursts of
//    products, so one's exp phase runs under the other's products. Only
//    a warpgroup's diagonal tile pays for the mask, and a tile wholly
//    before its keys is skipped. What still holds it back (some 40% of
//    the bound on an H100): each step waits for its first products
//    before the exp phase and for the exp phase before its last (232
//    registers leave no room to hold a second tile's scores), the
//    64-wide score products read both operands from shared memory at
//    its full bandwidth, and one block fills an SM.
//
// 2. CUDA cores (`flash_bwd_dkv_kernel`, f32 operands and bf16 at other
//    head widths; 256 threads, 64 keys). The two score products are
//    register tiled (2 queries x 8 keys a thread) and p, ds go through
//    shared memory in f32; thread t accumulates column t % 128 of key
//    rows 32 * (t / 128) .. +31 for both dK and dV.
#include "flash_wgmma.cuh"

namespace {

using flash::kSp;
using flash::kTile;
using flash::Strides;

constexpr int kThreads = 256;
constexpr int kHalf = kTile / 2;  // key rows per thread

template <typename T>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dkv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, const T* __restrict__ dout,
                     const float* __restrict__ lse,
                     const float* __restrict__ dvec, T* __restrict__ dk,
                     T* __restrict__ dv, int seq, int hq, int hkv, int d,
                     Strides qs, Strides ks, Strides vs, Strides dos,
                     float scale) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int ld = flash::staged_ld<T>(d);
  T* k_sh = reinterpret_cast<T*>(smem_raw);  // [kTile][ld] each
  T* v_sh = k_sh + kTile * ld;
  T* q_sh = v_sh + kTile * ld;
  T* do_sh = q_sh + kTile * ld;
  float* p_sh = reinterpret_cast<float*>(do_sh + kTile * ld);  // [q][key]
  float* ds_sh = p_sh + kTile * kSp;
  float* lse_sh = ds_sh + kTile * kSp;
  float* dvec_sh = lse_sh + kTile;

  const int kt = blockIdx.x;  // the first key tiles have the longest walks
  const int bh = blockIdx.y;
  const int b = bh / hkv, hk = bh % hkv;
  const int group = hq / hkv;
  const int k0 = kt * kTile;
  const int n_tiles = (seq + kTile - 1) / kTile;
  const int tid = threadIdx.x;
  const int col = tid % flash::kMaxDim, half = tid / flash::kMaxDim;

  flash::stage_tile<T, kThreads>(k_sh, k, ks, b, hk, k0, seq, d);
  flash::stage_tile<T, kThreads>(v_sh, v, vs, b, hk, k0, seq, d);
  float dk_acc[kHalf], dv_acc[kHalf];
#pragma unroll
  for (int j = 0; j < kHalf; ++j) dk_acc[j] = dv_acc[j] = 0.f;

  const int rg = tid / 8, kg = tid % 8;
  for (int g = 0; g < group; ++g) {
    const int h = hk * group + g;
    for (int qt = kt; qt < n_tiles; ++qt) {
      const int q0 = qt * kTile;
      flash::stage_tile<T, kThreads>(q_sh, q, qs, b, h, q0, seq, d);
      flash::stage_tile<T, kThreads>(do_sh, dout, dos, b, h, q0, seq, d);
      if (tid < kTile) {
        const bool live = q0 + tid < seq;
        const size_t row = ((size_t)b * hq + h) * seq + q0 + tid;
        lse_sh[tid] = live ? lse[row] : 0.f;
        dvec_sh[tid] = live ? dvec[row] : 0.f;
      }
      cp_async_wait_all();
      __syncthreads();

      // 1. p and ds for 2 queries x 8 keys per thread.
      {
        float s[2][8], dp[2][8];
        flash::tile_dot<T, kThreads>(q_sh, k_sh, d, s);
        flash::tile_dot<T, kThreads>(do_sh, v_sh, d, dp);
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          const int r = rg + 32 * i;
#pragma unroll
          for (int j = 0; j < 8; ++j) {
            const int key = k0 + kg + 8 * j;
            const bool live = key <= q0 + r && key < seq && q0 + r < seq;
            const float p = live ? expf(s[i][j] * scale - lse_sh[r]) : 0.f;
            p_sh[r * kSp + kg + 8 * j] = round_to<T>(p);
            ds_sh[r * kSp + kg + 8 * j] =
                round_to<T>(p * (dp[i][j] - dvec_sh[r]) * scale);
          }
        }
      }
      __syncthreads();

      // 2. dv += p^T dO, dk += ds^T q over this tile's 64 queries.
      if (col < d) {
        for (int r = 0; r < kTile; ++r) {
          const float doc = to_f(do_sh[r * ld + col]);
          const float qc = to_f(q_sh[r * ld + col]);
          const float* pr = p_sh + r * kSp + half * kHalf;
          const float* dr = ds_sh + r * kSp + half * kHalf;
#pragma unroll
          for (int j = 0; j < kHalf; j += 4) {
            const float4 p = *reinterpret_cast<const float4*>(pr + j);
            const float4 g4 = *reinterpret_cast<const float4*>(dr + j);
            dv_acc[j] = fmaf(p.x, doc, dv_acc[j]);
            dv_acc[j + 1] = fmaf(p.y, doc, dv_acc[j + 1]);
            dv_acc[j + 2] = fmaf(p.z, doc, dv_acc[j + 2]);
            dv_acc[j + 3] = fmaf(p.w, doc, dv_acc[j + 3]);
            dk_acc[j] = fmaf(g4.x, qc, dk_acc[j]);
            dk_acc[j + 1] = fmaf(g4.y, qc, dk_acc[j + 1]);
            dk_acc[j + 2] = fmaf(g4.z, qc, dk_acc[j + 2]);
            dk_acc[j + 3] = fmaf(g4.w, qc, dk_acc[j + 3]);
          }
        }
      }
      __syncthreads();  // the next query tile overwrites q_sh, do_sh, p, ds
    }
  }

  if (col < d) {
#pragma unroll
    for (int j = 0; j < kHalf; ++j) {
      const int key = k0 + half * kHalf + j;
      if (key < seq) {
        const size_t o = (((size_t)b * seq + key) * hkv + hk) * d + col;
        dk[o] = from_f<T>(dk_acc[j]);
        dv[o] = from_f<T>(dv_acc[j]);
      }
    }
  }
}

// ---- tensor-core kernel ----

constexpr int kTcKeys = 128;    // keys a block, 64 a warpgroup
constexpr int kTcQueries = 64;  // queries a tile
constexpr int kTcConsumers = 256;  // two warpgroups that multiply
constexpr int kTcThreads = kTcConsumers + 128;  // and one that copies
constexpr int kTcStages = 3;    // of (Q, dO, lse, D) query tiles
constexpr float kLog2e = 1.4426950408889634f;

template <int D>
constexpr size_t tc_smem_bytes() {
  return 2 * (size_t)flash::tc::tile_bytes(kTcKeys, D) +
         2 * kTcStages * (size_t)flash::tc::tile_bytes(kTcQueries, D) +
         2 * kTcStages * kTcQueries * sizeof(float) +
         (2 * kTcStages + 1) * sizeof(uint64_t) +  // the barriers
         flash::tc::kAtomBytes;  // room to align the first tile
}

template <int D>
__global__ void __launch_bounds__(kTcThreads, 1)
flash_bwd_dkv_tc_kernel(const __nv_bfloat16* __restrict__ q,
                        const __nv_bfloat16* __restrict__ k,
                        const __nv_bfloat16* __restrict__ v,
                        const __nv_bfloat16* __restrict__ dout,
                        const float* __restrict__ lse,
                        const float* __restrict__ dvec,
                        __nv_bfloat16* __restrict__ dk,
                        __nv_bfloat16* __restrict__ dv, int seq, int hq,
                        int hkv, Strides qs, Strides ks, Strides vs,
                        Strides dos, float scale) {
  namespace tc = flash::tc;
  constexpr int NR = D / 2;  // accumulator registers of a 64 x D tile
  constexpr int kKvBytes = tc::tile_bytes(kTcKeys, D);
  constexpr int kQBytes = tc::tile_bytes(kTcQueries, D);
  extern __shared__ unsigned char tc_smem_raw[];
  unsigned char* k_sh = tc_smem_raw +
      ((tc::kAtomBytes - tc::smem_addr(tc_smem_raw) % tc::kAtomBytes) %
       tc::kAtomBytes);
  unsigned char* v_sh = k_sh + kKvBytes;
  unsigned char* ring = v_sh + kKvBytes;  // stage s: Q, then dO
  // stage s: lse of the tile's 64 queries, then their D
  float* stats = reinterpret_cast<float*>(ring + kTcStages * 2 * kQBytes);
  // full[s]: stage s has landed; empty[s]: both multiplying warpgroups
  // are done with it; kv_full: this block's K and V have landed.
  uint64_t* full = reinterpret_cast<uint64_t*>(stats +
                                               kTcStages * 2 * kTcQueries);
  uint64_t* empty = full + kTcStages;
  uint64_t* kv_full = empty + kTcStages;

  const int kt = blockIdx.x;  // the first key tiles have the longest walks
  const int bh = blockIdx.y;
  const int b = bh / hkv, hk = bh % hkv;
  const int group = hq / hkv;
  const int tid = threadIdx.x;
  const int wg = tid / tc::kWarpgroup;
  const int first_qt = kt * (kTcKeys / kTcQueries);
  const int walk = (seq + kTcQueries - 1) / kTcQueries - first_qt;
  const int steps = group * walk;  // (query head of the group, query tile)

  if (tid == 0) {
    for (int s = 0; s < kTcStages; ++s) {
      tc::barrier_init(full + s, tc::kWarpgroup);
      tc::barrier_init(empty + s, kTcConsumers / 32);  // a warp each
    }
    tc::barrier_init(kv_full, tc::kWarpgroup);
  }
  __syncthreads();

  if (wg == 2) {
    // ---- the copying warpgroup: K and V once, then the ring of query
    // tiles. A query past the sequence reads zeros everywhere: its p is
    // exp(0) = 1 and its dO, dP and D are 0, so it adds nothing.
    tc::registers_release<40>();
    const int t = tid - kTcConsumers;
    tc::load_tile<kTcKeys, D, tc::kWarpgroup>(k_sh, k, ks, b, hk,
                                              kt * kTcKeys, seq, t);
    tc::load_tile<kTcKeys, D, tc::kWarpgroup>(v_sh, v, vs, b, hk,
                                              kt * kTcKeys, seq, t);
    tc::barrier_arrive_when_copied(kv_full);
    for (int step = 0; step < steps; ++step) {
      const int s = step % kTcStages, use = step / kTcStages;
      const int h = hk * group + step / walk;
      const int q0 = (first_qt + step % walk) * kTcQueries;
      if (use > 0) tc::barrier_wait(empty + s, (use - 1) & 1);
      unsigned char* q_sh = ring + s * 2 * kQBytes;
      tc::load_tile<kTcQueries, D, tc::kWarpgroup>(q_sh, q, qs, b, h, q0,
                                                   seq, t);
      tc::load_tile<kTcQueries, D, tc::kWarpgroup>(q_sh + kQBytes, dout, dos,
                                                   b, h, q0, seq, t);
      const int r = t % kTcQueries;
      const bool live = q0 + r < seq;
      tc::cp_async4_or_zero(
          stats + s * 2 * kTcQueries + t,
          (t < kTcQueries ? lse : dvec) + ((size_t)b * hq + h) * seq +
              (live ? q0 + r : 0),
          live);
      tc::barrier_arrive_when_copied(full + s);
    }
    asm volatile("cp.async.wait_all;\n" ::: "memory");
    return;
  }

  // ---- the two multiplying warpgroups, each on its 64 keys. They meet
  // at no barrier of their own, so one's exp phase can run under the
  // other's products.
  tc::registers_take<232>();
  const int lane = tid % 32;
  const int key_wg = kt * kTcKeys + 64 * wg;  // this warpgroup's first key
  // This thread's two key rows within the warpgroup's 64, its first column.
  const int row_lo = 16 * ((tid % tc::kWarpgroup) / 32) + lane / 4;
  const int col0 = 2 * (lane % 4);
  const float c = scale * kLog2e;

  float dk_acc[NR], dv_acc[NR];
#pragma unroll
  for (int i = 0; i < NR; ++i) dk_acc[i] = dv_acc[i] = 0.f;
  const uint32_t k_addr = tc::smem_addr(k_sh), v_addr = tc::smem_addr(v_sh);
  tc::barrier_wait(kv_full, 0);
  // The warpgroups take turns issuing their bursts of products (the
  // second lets the first go first), so one's exp phase runs under the
  // other's products and two bursts do not share the tensor cores.
  if (wg == 1) tc::turn_give(0);

  for (int step = 0; step < steps; ++step) {
    const int sg = step % kTcStages;
    tc::barrier_wait(full + sg, (step / kTcStages) & 1);
    tc::proxy_fence();
    const int q0 = (first_qt + step % walk) * kTcQueries;
    if (q0 + kTcQueries <= key_wg) {  // wholly before these keys
      if (lane == 0) tc::barrier_arrive(empty + sg);
      for (int burst = 0; burst < 2; ++burst) {  // pass both turns on
        tc::turn_take(wg);
        tc::turn_give(1 - wg);
      }
      continue;
    }
    const uint32_t q_addr = tc::smem_addr(ring + sg * 2 * kQBytes);
    const float* st = stats + sg * 2 * kTcQueries;

    // 1. S^T = K Q^T and dP^T = V dO^T, 64 keys x 64 queries each.
    float s[kTcQueries / 2], dp[kTcQueries / 2];
    tc::turn_take(wg);
    tc::mma_fence();
    tc::product_over_d<D, kTcKeys, kTcQueries>(s, k_addr, 64 * wg, q_addr);
    tc::product_over_d<D, kTcKeys, kTcQueries>(dp, v_addr, 64 * wg,
                                               q_addr + kQBytes);
    tc::mma_commit();
    tc::turn_give(1 - wg);
    tc::mma_wait();
    tc::mma_landed(s);
    tc::mma_landed(dp);

    // 2. P^T = exp(S^T scale - lse) and dS^T = P^T (dP^T - D) scale in
    // registers, rounded and packed as A operands. Only the diagonal
    // tile (q0 == key_wg) has pairs to mask.
    const bool diagonal = q0 == key_wg;
    uint32_t p[kTcQueries / 16][4], ds[kTcQueries / 16][4];
#pragma unroll
    for (int j = 0; j < kTcQueries / 8; ++j) {  // columns 8 j + col0, +1
      const float2 l2 = *reinterpret_cast<const float2*>(st + 8 * j + col0);
      const float2 dd = *reinterpret_cast<const float2*>(
          st + kTcQueries + 8 * j + col0);
      float pv[4], dsv[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {  // e / 2: row_lo, row_lo + 8
        const float lse2 = (e % 2 ? l2.y : l2.x) * kLog2e;
        const float dvv = e % 2 ? dd.y : dd.x;
        float pe = tc::exp2_fast(fmaf(s[4 * j + e], c, -lse2));
        if (diagonal && row_lo + 8 * (e / 2) > 8 * j + col0 + e % 2) pe = 0.f;
        pv[e] = pe;
        dsv[e] = pe * (dp[4 * j + e] - dvv) * scale;
      }
      p[j / 2][2 * (j % 2)] = tc::pack_bf16(pv[0], pv[1]);
      p[j / 2][2 * (j % 2) + 1] = tc::pack_bf16(pv[2], pv[3]);
      ds[j / 2][2 * (j % 2)] = tc::pack_bf16(dsv[0], dsv[1]);
      ds[j / 2][2 * (j % 2) + 1] = tc::pack_bf16(dsv[2], dsv[3]);
    }

    // 3. dV += P^T dO and dK += dS^T Q over the tile's 64 queries.
    tc::turn_take(wg);
    tc::mma_fence();
    tc::product_over_rows<D, kTcQueries>(dv_acc, p, q_addr + kQBytes);
    tc::product_over_rows<D, kTcQueries>(dk_acc, ds, q_addr);
    tc::mma_commit();
    tc::turn_give(1 - wg);
    tc::mma_wait();
    // The products are warpgroup-wide, so every lane is done with the
    // stage: one lane a warp gives it back.
    if (lane == 0) tc::barrier_arrive(empty + sg);
  }
  tc::mma_landed(dk_acc);
  tc::mma_landed(dv_acc);

  // A warpgroup's K and V rows are read by its own products only: they
  // carry its dK and dV rows to 16-byte stores.
  __nv_bfloat16* dst_k = dk + (((size_t)b * seq + key_wg) * hkv + hk) * D;
  __nv_bfloat16* dst_v = dv + (((size_t)b * seq + key_wg) * hkv + hk) * D;
  tc::store_rows<kTcKeys, D>(k_sh, 64 * wg, wg, dk_acc, dst_k,
                             (size_t)hkv * D, seq - key_wg);
  tc::store_rows<kTcKeys, D>(v_sh, 64 * wg, wg, dv_acc, dst_v,
                             (size_t)hkv * D, seq - key_wg);
}

template <int D>
int launch_tc(const void* q, const void* k, const void* v, const void* dout,
              const void* lse, const void* dvec, void* dk, void* dv,
              int batch, int seq, int hq, int hkv, Strides qs, Strides ks,
              Strides vs, Strides dos, float scale, void* stream) {
  constexpr size_t smem = tc_smem_bytes<D>();
  cudaError_t e = cudaFuncSetAttribute(
      flash_bwd_dkv_tc_kernel<D>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  dim3 grid((seq + kTcKeys - 1) / kTcKeys, batch * hkv);
  flash_bwd_dkv_tc_kernel<D>
      <<<grid, kTcThreads, smem, (cudaStream_t)stream>>>(
          (const __nv_bfloat16*)q, (const __nv_bfloat16*)k,
          (const __nv_bfloat16*)v, (const __nv_bfloat16*)dout,
          (const float*)lse, (const float*)dvec, (__nv_bfloat16*)dk,
          (__nv_bfloat16*)dv, seq, hq, hkv, qs, ks, vs, dos, scale);
  return (int)cudaGetLastError();
}

// variant 0: CUDA cores; 1: tensor cores (bf16, D 64 or 128 only).
template <typename T>
int launch(const void* q, const void* k, const void* v, const void* dout,
           const void* lse, const void* dvec, void* dk, void* dv, int batch,
           int seq, int hq, int hkv, int d, Strides qs, Strides ks,
           Strides vs, Strides dos, float scale, int variant, void* stream) {
  if (batch < 1 || seq < 1 || hkv < 1 || hq % hkv != 0 || d < 8 ||
      d > flash::kMaxDim || d % 8 != 0 || variant < 0 || variant > 1)
    return (int)cudaErrorInvalidValue;
  if (variant == 1) {
    if constexpr (sizeof(T) == 2) {
      if (d == 128)
        return launch_tc<128>(q, k, v, dout, lse, dvec, dk, dv, batch, seq,
                              hq, hkv, qs, ks, vs, dos, scale, stream);
      if (d == 64)
        return launch_tc<64>(q, k, v, dout, lse, dvec, dk, dv, batch, seq,
                             hq, hkv, qs, ks, vs, dos, scale, stream);
    }
    return (int)cudaErrorInvalidValue;
  }
  const size_t smem = sizeof(T) * 4 * (size_t)kTile * flash::staged_ld<T>(d) +
                      sizeof(float) * (2 * (size_t)kTile * kSp + 2 * kTile);
  cudaError_t e = cudaFuncSetAttribute(
      flash_bwd_dkv_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (e != cudaSuccess) return (int)e;
  dim3 grid((seq + kTile - 1) / kTile, batch * hkv);
  flash_bwd_dkv_kernel<T><<<grid, kThreads, smem, (cudaStream_t)stream>>>(
      (const T*)q, (const T*)k, (const T*)v, (const T*)dout,
      (const float*)lse, (const float*)dvec, (T*)dk, (T*)dv, seq, hq, hkv, d,
      qs, ks, vs, dos, scale);
  return (int)cudaGetLastError();
}

}  // namespace

#define TK8S_FLASH_DKV(SUFFIX, T)                                            \
  extern "C" int tk8s_flash_bwd_dkv_##SUFFIX(                                \
      const void* q, const void* k, const void* v, const void* dout,         \
      const void* lse, const void* dvec, void* dk, void* dv, int batch,      \
      int seq, int hq, int hkv, int d, long long qsb, long long qss,         \
      long long qsh, long long ksb, long long kss, long long ksh,            \
      long long vsb, long long vss, long long vsh, long long dsb,            \
      long long dss, long long dsh, float scale, int variant,                \
      void* stream) {                                                        \
    return launch<T>(q, k, v, dout, lse, dvec, dk, dv, batch, seq, hq, hkv,  \
                     d, Strides{qsb, qss, qsh}, Strides{ksb, kss, ksh},      \
                     Strides{vsb, vss, vsh}, Strides{dsb, dss, dsh}, scale,  \
                     variant, stream);                                       \
  }

TK8S_FLASH_DKV(bf16, __nv_bfloat16)
TK8S_FLASH_DKV(f32, float)

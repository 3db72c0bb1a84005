// Causal GQA flash-attention backward, dQ, for Hopper (sm_90a).
//
// Replaces: the TPU kernel `_dq_kernel`
//   (triton_kubernetes_tpu/ops/flash_attention.py:196, launched by
//   `_flash_backward` at :295).
//
// Computes: for q, dO [B, S, Hq, D], k, v [B, S, Hkv, D], the forward's
//   lse and D = rowsum(dO * O) (both f32 [B, Hq, S]):
//     p  = exp(q k^T * scale - lse)          (f32, causal)
//     dp = dO v^T                            (f32)
//     ds = p * (dp - D) * scale              (rounded to T)
//     dq = ds k                              (f32 sum, stored as T)
//   dq is [B, S, Hq, D], contiguous.
//
// What bounds it on this card: 6 * D FLOPs per (query, visible key) pair:
//   operations, as in the forward, and only the tensor cores reach it.
//
// Two kernels, chosen by (dtype, D) in one table in ops/_kernels.py and
// passed in as `variant`:
//
// 1. Tensor cores (`flash_bwd_dq_tc_kernel`, bf16 at D 64 or 128), built
//    as the forward's tensor-core kernel is: the same work with one more
//    score product and no online softmax. One block per (batch * query
//    head, tile of 128 queries), longest walks launched first: two
//    warpgroups that multiply, 64 query rows each, and a third that only
//    copies and gives its registers up to them (setmaxnreg). The copying
//    warpgroup stages Q and dO once and keeps two rings of three tiles of
//    64 keys, one of K and one of V, full with 16-byte cp.async copies
//    into 128-byte-swizzled shared memory, up to the causal diagonal,
//    with a shared-memory barrier per stage each way. Each row's lse and
//    D sit in registers, indexed by accumulator row. A multiplying
//    warpgroup's step issues dQ += dS K of the last tile, then S = Q K^T
//    and dP = dO V^T of this one (wgmma; Q, dO, K, V from shared memory
//    as they lie; dS from registers; K read again in the trans-b form),
//    waits, and computes this tile's dS in the accumulator registers,
//    rounded and packed in pairs as the next step's A operand: nothing
//    of a score tile touches shared memory. The two warpgroups take
//    turns issuing, so one's exp phase runs under the other's products.
//    Only a warpgroup's diagonal tile pays for the mask. dQ (64 x D f32 a
//    warpgroup) leaves through the block's Q tile in 16-byte rows. exp is
//    exp2 of a product folded with log2(e); the rounding points are the
//    reference's, only the f32 sums' order differs.
//
// 2. CUDA cores (`flash_bwd_dq_kernel`, f32 operands and bf16 at other
//    head widths): one block (128 threads) per (batch * query head, tile
//    of 64 queries), longest walks first; Q and dO staged once, then a
//    loop over key tiles up to the diagonal. K and V of a tile come in by
//    16-byte cp.async copies; V of the next tile is issued once dp is
//    taken and K once dq has read it. Both score products are register
//    tiled (4 queries x 8 keys a thread); dq keeps each thread's column
//    of the 64-row accumulator in registers.
#include "flash_wgmma.cuh"

namespace {

using flash::kSp;
using flash::kTile;
using flash::Strides;

constexpr int kThreads = 128;

template <typename T>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                    const T* __restrict__ v, const T* __restrict__ dout,
                    const float* __restrict__ lse,
                    const float* __restrict__ dvec, T* __restrict__ dq,
                    int seq, int hq, int hkv, int d, Strides qs, Strides ks,
                    Strides vs, Strides dos, float scale) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int ld = flash::staged_ld<T>(d);
  T* q_sh = reinterpret_cast<T*>(smem_raw);  // [kTile][ld] each
  T* do_sh = q_sh + kTile * ld;
  T* k_sh = do_sh + kTile * ld;
  T* v_sh = k_sh + kTile * ld;
  float* ds_sh = reinterpret_cast<float*>(v_sh + kTile * ld);  // [kTile][kSp]
  float* lse_sh = ds_sh + kTile * kSp;
  float* dvec_sh = lse_sh + kTile;

  const int n_tiles = (seq + kTile - 1) / kTile;
  const int qt = n_tiles - 1 - blockIdx.x;
  const int bh = blockIdx.y;
  const int b = bh / hq, h = bh % hq;
  const int hk = h / (hq / hkv);
  const int q0 = qt * kTile;
  const int tid = threadIdx.x;

  flash::stage_tile<T, kThreads>(q_sh, q, qs, b, h, q0, seq, d);
  flash::stage_tile<T, kThreads>(do_sh, dout, dos, b, h, q0, seq, d);
  flash::stage_tile<T, kThreads>(k_sh, k, ks, b, hk, 0, seq, d);
  flash::stage_tile<T, kThreads>(v_sh, v, vs, b, hk, 0, seq, d);
  if (tid < kTile) {
    const bool live = q0 + tid < seq;
    const size_t row = ((size_t)b * hq + h) * seq + q0 + tid;
    lse_sh[tid] = live ? lse[row] : 0.f;
    dvec_sh[tid] = live ? dvec[row] : 0.f;
  }
  float acc[kTile];
#pragma unroll
  for (int r = 0; r < kTile; ++r) acc[r] = 0.f;

  const int rg = tid / 8, kg = tid % 8;
  for (int kt = 0; kt <= qt; ++kt) {
    const int k0 = kt * kTile;
    cp_async_wait_all();
    __syncthreads();

    // 1. ds for 4 queries x 8 keys per thread.
    {
      float s[4][8], dp[4][8];
      flash::tile_dot<T, kThreads>(q_sh, k_sh, d, s);
      flash::tile_dot<T, kThreads>(do_sh, v_sh, d, dp);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int r = rg + 16 * i;
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const int key = k0 + kg + 8 * j;
          const bool live = key <= q0 + r && key < seq && q0 + r < seq;
          const float p =
              live ? expf(s[i][j] * scale - lse_sh[r]) : 0.f;
          ds_sh[r * kSp + kg + 8 * j] =
              round_to<T>(p * (dp[i][j] - dvec_sh[r]) * scale);
        }
      }
    }
    __syncthreads();
    if (kt < qt)
      flash::stage_tile<T, kThreads>(v_sh, v, vs, b, hk, k0 + kTile, seq, d);

    // 2. dq += ds k; thread tid owns column tid.
    if (tid < d) {
      for (int j = 0; j < kTile; j += 4) {
        const float k0v = to_f(k_sh[(j + 0) * ld + tid]);
        const float k1v = to_f(k_sh[(j + 1) * ld + tid]);
        const float k2v = to_f(k_sh[(j + 2) * ld + tid]);
        const float k3v = to_f(k_sh[(j + 3) * ld + tid]);
#pragma unroll
        for (int r = 0; r < kTile; ++r) {
          const float4 g =
              *reinterpret_cast<const float4*>(ds_sh + r * kSp + j);
          float a = acc[r];
          a = fmaf(g.x, k0v, a);
          a = fmaf(g.y, k1v, a);
          a = fmaf(g.z, k2v, a);
          a = fmaf(g.w, k3v, a);
          acc[r] = a;
        }
      }
    }
    __syncthreads();
    if (kt < qt)
      flash::stage_tile<T, kThreads>(k_sh, k, ks, b, hk, k0 + kTile, seq, d);
  }

  if (tid < d) {
#pragma unroll
    for (int r = 0; r < kTile; ++r)
      if (q0 + r < seq)
        dq[(((size_t)b * seq + q0 + r) * hq + h) * d + tid] = from_f<T>(acc[r]);
  }
}

// ---- tensor-core kernel ----

constexpr int kTcQueries = 128;  // queries a block, 64 a warpgroup
constexpr int kTcKeys = 64;      // keys a tile
constexpr int kTcConsumers = 256;  // two warpgroups that multiply
constexpr int kTcThreads = kTcConsumers + 128;  // and one that copies
constexpr int kTcStages = 3;     // of K tiles, and of V tiles
constexpr float kLog2e = 1.4426950408889634f;

template <int D>
constexpr size_t tc_smem_bytes() {
  return 2 * (size_t)flash::tc::tile_bytes(kTcQueries, D) +
         2 * kTcStages * (size_t)flash::tc::tile_bytes(kTcKeys, D) +
         (4 * kTcStages + 1) * sizeof(uint64_t) +  // the barriers
         flash::tc::kAtomBytes;  // room to align the first tile
}

template <int D>
__global__ void __launch_bounds__(kTcThreads, 1)
flash_bwd_dq_tc_kernel(const __nv_bfloat16* __restrict__ q,
                       const __nv_bfloat16* __restrict__ k,
                       const __nv_bfloat16* __restrict__ v,
                       const __nv_bfloat16* __restrict__ dout,
                       const float* __restrict__ lse,
                       const float* __restrict__ dvec,
                       __nv_bfloat16* __restrict__ dq, int seq, int hq,
                       int hkv, Strides qs, Strides ks, Strides vs,
                       Strides dos, float scale) {
  namespace tc = flash::tc;
  constexpr int NR = D / 2;  // accumulator registers of a 64 x D tile
  constexpr int kQBytes = tc::tile_bytes(kTcQueries, D);
  constexpr int kKvBytes = tc::tile_bytes(kTcKeys, D);
  extern __shared__ unsigned char tc_smem_raw[];
  unsigned char* q_sh = tc_smem_raw +
      ((tc::kAtomBytes - tc::smem_addr(tc_smem_raw) % tc::kAtomBytes) %
       tc::kAtomBytes);
  unsigned char* do_sh = q_sh + kQBytes;
  unsigned char* k_ring = do_sh + kQBytes;
  unsigned char* v_ring = k_ring + kTcStages * kKvBytes;
  // Per stage: k_full/v_full, the tile has landed; k_empty/v_empty, both
  // multiplying warpgroups are done with it. q_full: Q and dO have landed.
  uint64_t* k_full = reinterpret_cast<uint64_t*>(v_ring +
                                                 kTcStages * kKvBytes);
  uint64_t* k_empty = k_full + kTcStages;
  uint64_t* v_full = k_empty + kTcStages;
  uint64_t* v_empty = v_full + kTcStages;
  uint64_t* q_full = v_empty + kTcStages;

  const int n_qt = (seq + kTcQueries - 1) / kTcQueries;
  const int qt = n_qt - 1 - blockIdx.x;  // longest walks first
  const int bh = blockIdx.y;
  const int b = bh / hq, h = bh % hq;
  const int hk = h / (hq / hkv);
  const int q0 = qt * kTcQueries;
  // Key tiles the block walks: up to its diagonal, within the sequence.
  const int n_kt = min(2 * qt + 2, (seq + kTcKeys - 1) / kTcKeys);
  const int tid = threadIdx.x;
  const int wg = tid / tc::kWarpgroup;

  if (tid == 0) {
    for (int s = 0; s < kTcStages; ++s) {
      tc::barrier_init(k_full + s, tc::kWarpgroup);
      tc::barrier_init(v_full + s, tc::kWarpgroup);
      tc::barrier_init(k_empty + s, kTcConsumers / 32);  // a warp each
      tc::barrier_init(v_empty + s, kTcConsumers / 32);
    }
    tc::barrier_init(q_full, tc::kWarpgroup);
  }
  __syncthreads();

  if (wg == 2) {
    // ---- the copying warpgroup: Q and dO once, then the two rings.
    tc::registers_release<56>();
    const int t = tid - kTcConsumers;
    tc::load_tile<kTcQueries, D, tc::kWarpgroup>(q_sh, q, qs, b, h, q0, seq,
                                                 t);
    tc::load_tile<kTcQueries, D, tc::kWarpgroup>(do_sh, dout, dos, b, h, q0,
                                                 seq, t);
    tc::barrier_arrive_when_copied(q_full);
    for (int kt = 0; kt < n_kt; ++kt) {
      const int s = kt % kTcStages, use = kt / kTcStages;
      if (use > 0) tc::barrier_wait(k_empty + s, (use - 1) & 1);
      tc::load_tile<kTcKeys, D, tc::kWarpgroup>(k_ring + s * kKvBytes, k, ks,
                                                b, hk, kt * kTcKeys, seq, t);
      tc::barrier_arrive_when_copied(k_full + s);
      if (use > 0) tc::barrier_wait(v_empty + s, (use - 1) & 1);
      tc::load_tile<kTcKeys, D, tc::kWarpgroup>(v_ring + s * kKvBytes, v, vs,
                                                b, hk, kt * kTcKeys, seq, t);
      tc::barrier_arrive_when_copied(v_full + s);
    }
    asm volatile("cp.async.wait_all;\n" ::: "memory");
    return;
  }

  // ---- the two multiplying warpgroups, each on its 64 query rows.
  tc::registers_take<224>();
  const int lane = tid % 32;
  // This thread's two rows within its warpgroup's 64, and first column.
  const int row_lo = 16 * ((tid % tc::kWarpgroup) / 32) + lane / 4;
  const int col0 = 2 * (lane % 4);
  const int first = q0 + 64 * wg;  // the warpgroup's first query
  // Its last key tile: its diagonal, or the sequence's last tile.
  const int last = min(2 * qt + wg, n_kt - 1);
  // lse (times log2 e) and D of rows row_lo and row_lo + 8; rows past the
  // sequence take 0 and are never stored.
  const size_t stats = ((size_t)b * hq + h) * seq;
  const int r_lo = first + row_lo, r_hi = r_lo + 8;
  const float lse_lo = r_lo < seq ? lse[stats + r_lo] * kLog2e : 0.f;
  const float lse_hi = r_hi < seq ? lse[stats + r_hi] * kLog2e : 0.f;
  const float d_lo = r_lo < seq ? dvec[stats + r_lo] : 0.f;
  const float d_hi = r_hi < seq ? dvec[stats + r_hi] : 0.f;
  const float c = scale * kLog2e;

  float acc[NR];
#pragma unroll
  for (int i = 0; i < NR; ++i) acc[i] = 0.f;
  float s[kTcKeys / 2], dp[kTcKeys / 2];  // S and dP of the tile in hand
  uint32_t ds[kTcKeys / 16][4];  // dS rounded and packed: dS K's A operand
  const uint32_t q_addr = tc::smem_addr(q_sh);
  const uint32_t do_addr = tc::smem_addr(do_sh);
  tc::barrier_wait(q_full, 0);
  // The warpgroups take turns issuing products (the second lets the first
  // go first); both take n_kt + 1 turns, a warpgroup past its last tile
  // issuing nothing in its turn.
  if (wg == 1) tc::turn_give(0);

  // Step j issues dQ += dS K of tile j - 1, then S = Q K^T and
  // dP = dO V^T of tile j, waits for them, gives K of tile j - 1 and V of
  // tile j back, and computes dS of tile j.
  for (int j = 0; j <= n_kt; ++j) {
    const int st = j % kTcStages, pst = (j + kTcStages - 1) % kTcStages;
    const bool live = j <= last;
    const bool pending = j >= 1 && j - 1 <= last;
    if (j < n_kt) {
      tc::barrier_wait(k_full + st, (j / kTcStages) & 1);
      tc::barrier_wait(v_full + st, (j / kTcStages) & 1);
    }
    tc::proxy_fence();
    tc::turn_take(wg);
    tc::mma_fence();
    if (pending)
      tc::product_over_rows<D, kTcKeys>(
          acc, ds, tc::smem_addr(k_ring + pst * kKvBytes));
    if (live) {
      tc::product_over_d<D, kTcQueries, kTcKeys>(
          s, q_addr, 64 * wg, tc::smem_addr(k_ring + st * kKvBytes));
      tc::product_over_d<D, kTcQueries, kTcKeys>(
          dp, do_addr, 64 * wg, tc::smem_addr(v_ring + st * kKvBytes));
    }
    tc::mma_commit();
    tc::turn_give(1 - wg);
    tc::mma_wait();
    tc::mma_landed(s);
    tc::mma_landed(dp);
    tc::mma_landed(acc);
    // The products are warpgroup-wide, so every lane is done with the
    // tiles: one lane a warp gives them back (every tile, walked or not).
    if (lane == 0) {
      if (j >= 1) tc::barrier_arrive(k_empty + pst);
      if (j < n_kt) tc::barrier_arrive(v_empty + st);
    }
    if (!live) continue;

    // p = exp(s scale - lse) and dS = p (dP - D) scale in registers; only
    // the diagonal tile (keys from the warpgroup's first query on) has
    // pairs to mask.
    const bool diagonal = j == 2 * qt + wg;
    float dsv[kTcKeys / 2];
#pragma unroll
    for (int i = 0; i < kTcKeys / 2; ++i) {
      const int hi = (i / 2) % 2;  // row row_lo + 8 hi
      float p = tc::exp2_fast(fmaf(s[i], c, -(hi ? lse_hi : lse_lo)));
      if (diagonal && 8 * (i / 4) + col0 + i % 2 > row_lo + 8 * hi) p = 0.f;
      dsv[i] = p * (dp[i] - (hi ? d_hi : d_lo)) * scale;
    }
#pragma unroll
    for (int kk = 0; kk < kTcKeys / 16; ++kk)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        ds[kk][e] = tc::pack_bf16(dsv[8 * kk + 2 * e], dsv[8 * kk + 2 * e + 1]);
  }

  // A warpgroup's Q rows are read by its own products only: they carry
  // its dQ rows to 16-byte stores.
  tc::store_rows<kTcQueries, D>(
      q_sh, 64 * wg, wg, acc,
      dq + (((size_t)b * seq + first) * hq + h) * D, (size_t)hq * D,
      seq - first);
}

template <int D>
int launch_tc(const void* q, const void* k, const void* v, const void* dout,
              const void* lse, const void* dvec, void* dq, int batch,
              int seq, int hq, int hkv, Strides qs, Strides ks, Strides vs,
              Strides dos, float scale, void* stream) {
  constexpr size_t smem = tc_smem_bytes<D>();
  cudaError_t e = cudaFuncSetAttribute(
      flash_bwd_dq_tc_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (e != cudaSuccess) return (int)e;
  dim3 grid((seq + kTcQueries - 1) / kTcQueries, batch * hq);
  flash_bwd_dq_tc_kernel<D><<<grid, kTcThreads, smem, (cudaStream_t)stream>>>(
      (const __nv_bfloat16*)q, (const __nv_bfloat16*)k,
      (const __nv_bfloat16*)v, (const __nv_bfloat16*)dout, (const float*)lse,
      (const float*)dvec, (__nv_bfloat16*)dq, seq, hq, hkv, qs, ks, vs, dos,
      scale);
  return (int)cudaGetLastError();
}

// variant 0: CUDA cores; 1: tensor cores (bf16, D 64 or 128 only).
template <typename T>
int launch(const void* q, const void* k, const void* v, const void* dout,
           const void* lse, const void* dvec, void* dq, int batch, int seq,
           int hq, int hkv, int d, Strides qs, Strides ks, Strides vs,
           Strides dos, float scale, int variant, void* stream) {
  if (batch < 1 || seq < 1 || hkv < 1 || hq % hkv != 0 || d < 8 ||
      d > flash::kMaxDim || d % 8 != 0 || variant < 0 || variant > 1)
    return (int)cudaErrorInvalidValue;
  if (variant == 1) {
    if constexpr (sizeof(T) == 2) {
      if (d == 128)
        return launch_tc<128>(q, k, v, dout, lse, dvec, dq, batch, seq, hq,
                              hkv, qs, ks, vs, dos, scale, stream);
      if (d == 64)
        return launch_tc<64>(q, k, v, dout, lse, dvec, dq, batch, seq, hq,
                             hkv, qs, ks, vs, dos, scale, stream);
    }
    return (int)cudaErrorInvalidValue;
  }
  const size_t smem = sizeof(T) * 4 * (size_t)kTile * flash::staged_ld<T>(d) +
                      sizeof(float) * ((size_t)kTile * kSp + 2 * kTile);
  cudaError_t e = cudaFuncSetAttribute(
      flash_bwd_dq_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (e != cudaSuccess) return (int)e;
  dim3 grid((seq + kTile - 1) / kTile, batch * hq);
  flash_bwd_dq_kernel<T><<<grid, kThreads, smem, (cudaStream_t)stream>>>(
      (const T*)q, (const T*)k, (const T*)v, (const T*)dout,
      (const float*)lse, (const float*)dvec, (T*)dq, seq, hq, hkv, d, qs, ks,
      vs, dos, scale);
  return (int)cudaGetLastError();
}

}  // namespace

#define TK8S_FLASH_DQ(SUFFIX, T)                                             \
  extern "C" int tk8s_flash_bwd_dq_##SUFFIX(                                 \
      const void* q, const void* k, const void* v, const void* dout,         \
      const void* lse, const void* dvec, void* dq, int batch, int seq,       \
      int hq, int hkv, int d, long long qsb, long long qss, long long qsh,   \
      long long ksb, long long kss, long long ksh, long long vsb,            \
      long long vss, long long vsh, long long dsb, long long dss,            \
      long long dsh, float scale, int variant, void* stream) {               \
    return launch<T>(q, k, v, dout, lse, dvec, dq, batch, seq, hq, hkv, d,   \
                     Strides{qsb, qss, qsh}, Strides{ksb, kss, ksh},         \
                     Strides{vsb, vss, vsh}, Strides{dsb, dss, dsh}, scale,  \
                     variant, stream);                                       \
  }

TK8S_FLASH_DQ(bf16, __nv_bfloat16)
TK8S_FLASH_DQ(f32, float)

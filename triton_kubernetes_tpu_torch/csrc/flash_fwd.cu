// Causal GQA flash-attention forward for Hopper (sm_90a).
//
// Replaces: the TPU kernel `_flash_kernel`
//   (triton_kubernetes_tpu/ops/flash_attention.py:75, launched by
//   `_flash_forward_flat` at :165).
//
// Computes: for q [B, S, Hq, D] and k, v [B, S, Hkv, D] (query head h reads
//   KV head h / group), out = softmax(q k^T * D^-0.5, causal) v in q's dtype
//   [B, S, Hq, D] (contiguous), and the row logsumexp lse = m + log(l) in
//   f32 [B, Hq, S], the residual the backward kernels recompute p from.
//
// What bounds it on this card: 4 * D FLOPs per (query, visible key) pair
//   against ~4 bytes per pair of operands at S = 2048: operations, by two
//   orders of magnitude. Only the tensor cores (989 TFLOP/s in bf16) reach
//   that bound; the CUDA cores' f32 rate is 15 times lower.
//
// Two kernels, chosen by (dtype, D) in one table in ops/_kernels.py and
// passed in as `variant`:
//
// 1. Tensor cores (`flash_fwd_tc_kernel`, bf16 at D 64 or 128). One block
//    per (batch * query head, tile of 128 queries), longest walks
//    launched first: two warpgroups that multiply, 64 query rows each,
//    and a third that only copies. The copying warpgroup stages Q once
//    and keeps two rings of three tiles of 128 keys, one of K and one of
//    V, full with 16-byte cp.async copies into 128-byte-swizzled shared
//    memory, up to the causal diagonal; a shared-memory barrier per
//    stage tells the multiplying warpgroups that a tile has landed,
//    another tells the copier that both are done with it, and the copier
//    gives its registers up to them (setmaxnreg). A multiplying
//    warpgroup's step issues acc += P V of the last tile and S = Q K^T
//    of this one back to back (wgmma; Q and K [keys][D] from shared
//    memory, K-major as they lie; p from registers; V [keys][D] in the
//    trans-b form), waits, and runs this tile's softmax; the two take
//    turns issuing, so one's softmax runs under the other's products.
//    The scores never leave the accumulator registers: the scale, the
//    mask (only the diagonal tile pays for it) and the online softmax
//    run there, a row's max and sum reduced over the four lanes that
//    hold it; p is rounded to bf16 in registers, and acc (64 x D f32 a
//    warpgroup) is rescaled in registers. The output leaves through the
//    block's Q tile in 16-byte rows. exp is exp2 of a product folded
//    with log2(e), and out is acc times 1 / l: the rounding points below
//    are kept, an f32 value's last bit may differ. What still holds it
//    back (some 40% of the bound on an H100): between two of its bursts
//    of products a warpgroup spends about twice the burst's time on the
//    CUDA cores (max, exp, sum, rescale, pack, barriers), which run
//    slower while the other warpgroup's products use the register file,
//    so two warpgroups cannot keep the tensor cores busy; a third does
//    not fit the register file at this tile. One block fills an SM, so
//    nothing hides a block's first loads and last stores.
//
// 2. CUDA cores (`flash_fwd_kernel`, f32 operands -- the tensor cores have
//    no full-f32 product and TF32 would cost the 1e-5 agreement -- and
//    bf16 at other head widths). One block (128 threads) per 64 queries,
//    key tiles of 64, scores register tiled (4 queries x 8 keys a thread)
//    and kept in shared memory in f32, P*V one output column a thread.
//
// Rounding order as the reference, in both: q.k in f32 from T operands,
// then times the scale; f32 online softmax per key tile (m, l, acc in
// f32); p rounded to T before P*V; out = acc / l where l > 0, else 0. The
// key tile is part of the arithmetic (p is taken against the running max
// of its tile): 128 in the first kernel, 64 in the second.
#include "flash_wgmma.cuh"

namespace {

using flash::kSp;
using flash::kTile;
using flash::Strides;

constexpr int kThreads = 128;

template <typename T>
__global__ void __launch_bounds__(kThreads)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, T* __restrict__ out,
                 float* __restrict__ lse, int seq, int hq, int hkv, int d,
                 Strides qs, Strides ks, Strides vs, float scale) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int ld = flash::staged_ld<T>(d);
  T* q_sh = reinterpret_cast<T*>(smem_raw);  // [kTile][ld]
  T* k_sh = q_sh + kTile * ld;
  T* v_sh = k_sh + kTile * ld;
  float* s_sh = reinterpret_cast<float*>(v_sh + kTile * ld);  // [kTile][kSp]
  float* m_sh = s_sh + kTile * kSp;
  float* l_sh = m_sh + kTile;
  float* c_sh = l_sh + kTile;

  const int n_tiles = (seq + kTile - 1) / kTile;
  const int qt = n_tiles - 1 - blockIdx.x;  // longest walks first
  const int bh = blockIdx.y;
  const int b = bh / hq, h = bh % hq;
  const int hk = h / (hq / hkv);
  const int q0 = qt * kTile;
  const int tid = threadIdx.x;

  flash::stage_tile<T, kThreads>(q_sh, q, qs, b, h, q0, seq, d);
  flash::stage_tile<T, kThreads>(k_sh, k, ks, b, hk, 0, seq, d);
  flash::stage_tile<T, kThreads>(v_sh, v, vs, b, hk, 0, seq, d);
  if (tid < kTile) {
    m_sh[tid] = TK8S_NEG_INF;
    l_sh[tid] = 0.f;
  }
  float acc[kTile];
#pragma unroll
  for (int r = 0; r < kTile; ++r) acc[r] = 0.f;

  const int rg = tid / 8, kg = tid % 8;
  for (int kt = 0; kt <= qt; ++kt) {
    const int k0 = kt * kTile;
    cp_async_wait_all();
    __syncthreads();

    // 1. Scores of 4 queries x 8 keys per thread, scaled and masked.
    {
      float sc[4][8];
      flash::tile_dot<T, kThreads>(q_sh, k_sh, d, sc);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int r = rg + 16 * i;
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const int key = k0 + kg + 8 * j;
          s_sh[r * kSp + kg + 8 * j] =
              (key <= q0 + r && key < seq) ? sc[i][j] * scale : TK8S_NEG_INF;
        }
      }
    }
    __syncthreads();
    if (kt < qt)  // K is read; the next tile's copies run under the rest
      flash::stage_tile<T, kThreads>(k_sh, k, ks, b, hk, k0 + kTile, seq, d);

    // 2. Online softmax: two threads a row, 32 keys each (interleaved).
    {
      const int r = tid >> 1, half = tid & 1;
      float* srow = s_sh + r * kSp;
      float mx = TK8S_NEG_INF;
      for (int jj = 0; jj < kTile / 2; ++jj)
        mx = fmaxf(mx, srow[half + 2 * jj]);
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      const float m_prev = m_sh[r];
      const float m_new = fmaxf(m_prev, mx);
      float sum = 0.f;
      for (int jj = 0; jj < kTile / 2; ++jj) {
        const float e = expf(srow[half + 2 * jj] - m_new);
        sum += e;
        srow[half + 2 * jj] = round_to<T>(e);
      }
      sum += __shfl_xor_sync(0xffffffffu, sum, 1);
      __syncwarp();
      if (half == 0) {
        const float corr = expf(m_prev - m_new);
        l_sh[r] = l_sh[r] * corr + sum;
        c_sh[r] = corr;
        m_sh[r] = m_new;
      }
    }
    __syncthreads();

    // 3. acc = acc * corr + p V; thread tid owns column tid.
    if (tid < d) {
#pragma unroll
      for (int r = 0; r < kTile; ++r) acc[r] *= c_sh[r];
      for (int j = 0; j < kTile; j += 4) {
        const float v0 = to_f(v_sh[(j + 0) * ld + tid]);
        const float v1 = to_f(v_sh[(j + 1) * ld + tid]);
        const float v2 = to_f(v_sh[(j + 2) * ld + tid]);
        const float v3 = to_f(v_sh[(j + 3) * ld + tid]);
#pragma unroll
        for (int r = 0; r < kTile; ++r) {
          const float4 p = *reinterpret_cast<const float4*>(s_sh + r * kSp + j);
          float a = acc[r];
          a = fmaf(p.x, v0, a);
          a = fmaf(p.y, v1, a);
          a = fmaf(p.z, v2, a);
          a = fmaf(p.w, v3, a);
          acc[r] = a;
        }
      }
    }
    __syncthreads();
    if (kt < qt)
      flash::stage_tile<T, kThreads>(v_sh, v, vs, b, hk, k0 + kTile, seq, d);
  }

  if (tid < d) {
#pragma unroll
    for (int r = 0; r < kTile; ++r) {
      if (q0 + r < seq) {
        const float l = l_sh[r];
        out[(((size_t)b * seq + q0 + r) * hq + h) * d + tid] =
            from_f<T>(l > 0.f ? acc[r] / l : 0.f);
      }
    }
  }
  if (tid < kTile && q0 + tid < seq) {
    const float l = l_sh[tid];
    lse[((size_t)b * hq + h) * seq + q0 + tid] =
        l > 0.f ? m_sh[tid] + logf(l) : __int_as_float(0x7f800000);
  }
}

// ---- tensor-core kernel ----

constexpr int kTcQueries = 128;  // queries a block, 64 a warpgroup
constexpr int kTcKeys = 128;     // keys a tile
constexpr int kTcConsumers = 256;  // two warpgroups that multiply
constexpr int kTcThreads = kTcConsumers + 128;  // and one that copies
constexpr int kTcStages = 3;     // of K tiles, and of V tiles
constexpr float kLog2e = 1.4426950408889634f;

template <int D>
constexpr size_t tc_smem_bytes() {
  return (size_t)flash::tc::tile_bytes(kTcQueries, D) +
         2 * kTcStages * (size_t)flash::tc::tile_bytes(kTcKeys, D) +
         (4 * kTcStages + 1) * sizeof(uint64_t) +  // the barriers
         flash::tc::kAtomBytes;  // room to align the first tile
}

template <int D>
__global__ void __launch_bounds__(kTcThreads, 1)
flash_fwd_tc_kernel(const __nv_bfloat16* __restrict__ q,
                    const __nv_bfloat16* __restrict__ k,
                    const __nv_bfloat16* __restrict__ v,
                    __nv_bfloat16* __restrict__ out,
                    float* __restrict__ lse, int seq, int hq, int hkv,
                    Strides qs, Strides ks, Strides vs, float scale) {
  namespace tc = flash::tc;
  constexpr int NR = D / 2;  // accumulator registers of a 64 x D tile
  constexpr int kKvBytes = tc::tile_bytes(kTcKeys, D);
  extern __shared__ unsigned char tc_smem_raw[];
  unsigned char* q_sh = tc_smem_raw +
      ((tc::kAtomBytes - tc::smem_addr(tc_smem_raw) % tc::kAtomBytes) %
       tc::kAtomBytes);
  unsigned char* k_ring = q_sh + tc::tile_bytes(kTcQueries, D);
  unsigned char* v_ring = k_ring + kTcStages * kKvBytes;
  // Per stage: k_full/v_full, the tile has landed; k_empty/v_empty, both
  // multiplying warpgroups are done with it. q_full: Q has landed.
  uint64_t* k_full = reinterpret_cast<uint64_t*>(v_ring +
                                                 kTcStages * kKvBytes);
  uint64_t* k_empty = k_full + kTcStages;
  uint64_t* v_full = k_empty + kTcStages;
  uint64_t* v_empty = v_full + kTcStages;
  uint64_t* q_full = v_empty + kTcStages;

  const int n_tiles = (seq + kTcQueries - 1) / kTcQueries;
  const int qt = n_tiles - 1 - blockIdx.x;  // longest walks first
  const int bh = blockIdx.y;
  const int b = bh / hq, h = bh % hq;
  const int hk = h / (hq / hkv);
  const int q0 = qt * kTcQueries;
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
    // ---- the copying warpgroup: keeps the two rings full, nothing else.
    tc::registers_release<56>();
    const int t = tid - kTcConsumers;
    tc::load_tile<kTcQueries, D, tc::kWarpgroup>(q_sh, q, qs, b, h, q0, seq,
                                                 t);
    tc::barrier_arrive_when_copied(q_full);
    for (int kt = 0; kt <= qt; ++kt) {
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
  // This thread's two rows of the block's query tile, and its first column.
  const int row_lo = 64 * wg + 16 * ((tid % tc::kWarpgroup) / 32) + lane / 4;
  const int col0 = 2 * (lane % 4);

  float acc[NR];
#pragma unroll
  for (int i = 0; i < NR; ++i) acc[i] = 0.f;
  // Running max of the raw (unscaled) scores and this thread's share of
  // the running sum, for rows row_lo and row_lo + 8.
  float m_lo = TK8S_NEG_INF, m_hi = TK8S_NEG_INF, l_lo = 0.f, l_hi = 0.f;
  const float c = scale * kLog2e;
  const uint32_t q_addr = tc::smem_addr(q_sh);
  float s[kTcKeys / 2];         // scores of the tile in hand, then p
  uint32_t p[kTcKeys / 16][4];  // p rounded and packed: P V's A operand
  tc::barrier_wait(q_full, 0);
  // The warpgroups take turns issuing products (two named barriers, each
  // waited on by its owner and signalled by the other): while one's
  // products run, the other, whose products are done, is in its softmax,
  // so the tensor cores are not left idle by both at once. The second
  // lets the first go first.
  if (wg == 1) tc::turn_give(0);

  // Step j issues acc += P V of tile j - 1 and S = Q K^T of tile j back
  // to back, waits for both, gives the two tiles back, and runs the
  // softmax of tile j.
  for (int j = 0; j <= qt + 1; ++j) {
    const int ks_ = j % kTcStages, vs_ = (j + kTcStages - 1) % kTcStages;
    if (j <= qt) tc::barrier_wait(k_full + ks_, (j / kTcStages) & 1);
    if (j >= 1) tc::barrier_wait(v_full + vs_, ((j - 1) / kTcStages) & 1);
    tc::proxy_fence();
    tc::turn_take(wg);
    tc::mma_fence();
    if (j >= 1)
      tc::product_over_rows<D, kTcKeys>(
          acc, p, tc::smem_addr(v_ring + vs_ * kKvBytes));
    if (j <= qt)
      tc::product_over_d<D, kTcQueries, kTcKeys>(
          s, q_addr, 64 * wg, tc::smem_addr(k_ring + ks_ * kKvBytes));
    tc::mma_commit();
    tc::turn_give(1 - wg);
    tc::mma_wait();
    tc::mma_landed(s);
    tc::mma_landed(acc);
    // The products are warpgroup-wide, so every lane is done with the
    // tiles: one lane a warp gives them back.
    if (j >= 1 && lane == 0) tc::barrier_arrive(v_empty + vs_);
    if (j > qt) break;
    if (lane == 0) tc::barrier_arrive(k_empty + ks_);

    // Mask (the diagonal tile only: below it every key is visible and
    // before seq), then the online softmax on the raw scores.
    if (j == qt) {
      const int k0 = j * kTcKeys;
#pragma unroll
      for (int i = 0; i < kTcKeys / 2; ++i) {
        const int key = k0 + 8 * (i / 4) + col0 + i % 2;
        const int row = q0 + row_lo + 8 * ((i / 2) % 2);
        if (key > row || key >= seq) s[i] = TK8S_NEG_INF;
      }
    }
    // Four independent max chains a row keep the dependent depth short.
    float mx[2][4];
#pragma unroll
    for (int r = 0; r < 2; ++r)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        mx[r][e] = fmaxf(s[4 * e + 2 * r], s[4 * e + 2 * r + 1]);
#pragma unroll
    for (int i = 16; i < kTcKeys / 2; i += 4)
#pragma unroll
      for (int r = 0; r < 2; ++r)
        mx[r][(i / 4) % 4] = fmaxf(
            mx[r][(i / 4) % 4], fmaxf(s[i + 2 * r], s[i + 2 * r + 1]));
    const float mx_lo = fmaxf(fmaxf(mx[0][0], mx[0][1]),
                              fmaxf(mx[0][2], mx[0][3]));
    const float mx_hi = fmaxf(fmaxf(mx[1][0], mx[1][1]),
                              fmaxf(mx[1][2], mx[1][3]));
    const float new_lo = fmaxf(m_lo, tc::quad_max(mx_lo));
    const float new_hi = fmaxf(m_hi, tc::quad_max(mx_hi));
    const float corr_lo = tc::exp2_fast((m_lo - new_lo) * c);
    const float corr_hi = tc::exp2_fast((m_hi - new_hi) * c);
    m_lo = new_lo;
    m_hi = new_hi;
    const float mc_lo = new_lo * c, mc_hi = new_hi * c;
    float sum[2][2] = {{0.f, 0.f}, {0.f, 0.f}};
#pragma unroll
    for (int i = 0; i < kTcKeys / 2; i += 4) {
      s[i] = tc::exp2_fast(fmaf(s[i], c, -mc_lo));
      s[i + 1] = tc::exp2_fast(fmaf(s[i + 1], c, -mc_lo));
      s[i + 2] = tc::exp2_fast(fmaf(s[i + 2], c, -mc_hi));
      s[i + 3] = tc::exp2_fast(fmaf(s[i + 3], c, -mc_hi));
      sum[0][(i / 4) % 2] += s[i] + s[i + 1];
      sum[1][(i / 4) % 2] += s[i + 2] + s[i + 3];
    }
    l_lo = l_lo * corr_lo + (sum[0][0] + sum[0][1]);
    l_hi = l_hi * corr_hi + (sum[1][0] + sum[1][1]);
    // acc = acc * corr; round(p) packed for the next step's P V.
#pragma unroll
    for (int kk = 0; kk < kTcKeys / 16; ++kk)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        p[kk][e] = tc::pack_bf16(s[8 * kk + 2 * e], s[8 * kk + 2 * e + 1]);
#pragma unroll
    for (int i = 0; i < NR; i += 4) {
      acc[i] *= corr_lo;
      acc[i + 1] *= corr_lo;
      acc[i + 2] *= corr_hi;
      acc[i + 3] *= corr_hi;
    }
  }

  // out = acc / l, as acc times the reciprocal (one f32 ulp from the
  // quotient, far below the output's bf16 rounding).
  l_lo = tc::quad_sum(l_lo);
  l_hi = tc::quad_sum(l_hi);
  const float inv_lo = l_lo > 0.f ? 1.f / l_lo : 0.f;
  const float inv_hi = l_hi > 0.f ? 1.f / l_hi : 0.f;
#pragma unroll
  for (int i = 0; i < NR; i += 4) {
    acc[i] *= inv_lo;
    acc[i + 1] *= inv_lo;
    acc[i + 2] *= inv_hi;
    acc[i + 3] *= inv_hi;
  }
  // A warpgroup's Q rows are read by its own products only: they carry
  // its output rows to 16-byte stores.
  const int first = q0 + 64 * wg;
  tc::store_rows<kTcQueries, D>(
      q_sh, 64 * wg, wg, acc,
      out + (((size_t)b * seq + first) * hq + h) * D, (size_t)hq * D,
      seq - first);
  if (lane % 4 == 0) {
    float* row = lse + ((size_t)b * hq + h) * seq;
    const float inf = __int_as_float(0x7f800000);
    if (q0 + row_lo < seq)
      row[q0 + row_lo] = l_lo > 0.f ? m_lo * scale + logf(l_lo) : inf;
    if (q0 + row_lo + 8 < seq)
      row[q0 + row_lo + 8] = l_hi > 0.f ? m_hi * scale + logf(l_hi) : inf;
  }
}

template <int D>
int launch_tc(const void* q, const void* k, const void* v, void* out,
              void* lse, int batch, int seq, int hq, int hkv, Strides qs,
              Strides ks, Strides vs, float scale, void* stream) {
  constexpr size_t smem = tc_smem_bytes<D>();
  cudaError_t e = cudaFuncSetAttribute(
      flash_fwd_tc_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (e != cudaSuccess) return (int)e;
  dim3 grid((seq + kTcQueries - 1) / kTcQueries, batch * hq);
  flash_fwd_tc_kernel<D><<<grid, kTcThreads, smem, (cudaStream_t)stream>>>(
      (const __nv_bfloat16*)q, (const __nv_bfloat16*)k,
      (const __nv_bfloat16*)v, (__nv_bfloat16*)out, (float*)lse, seq, hq,
      hkv, qs, ks, vs, scale);
  return (int)cudaGetLastError();
}

// variant 0: CUDA cores; 1: tensor cores (bf16, D 64 or 128 only).
template <typename T>
int launch(const void* q, const void* k, const void* v, void* out, void* lse,
           int batch, int seq, int hq, int hkv, int d, Strides qs, Strides ks,
           Strides vs, float scale, int variant, void* stream) {
  if (batch < 1 || seq < 1 || hkv < 1 || hq % hkv != 0 || d < 8 ||
      d > flash::kMaxDim || d % 8 != 0 || variant < 0 || variant > 1)
    return (int)cudaErrorInvalidValue;
  if (variant == 1) {
    if constexpr (sizeof(T) == 2) {
      if (d == 128)
        return launch_tc<128>(q, k, v, out, lse, batch, seq, hq, hkv, qs, ks,
                              vs, scale, stream);
      if (d == 64)
        return launch_tc<64>(q, k, v, out, lse, batch, seq, hq, hkv, qs, ks,
                             vs, scale, stream);
    }
    return (int)cudaErrorInvalidValue;
  }
  const size_t smem = sizeof(T) * 3 * (size_t)kTile * flash::staged_ld<T>(d) +
                      sizeof(float) * ((size_t)kTile * kSp + 3 * kTile);
  cudaError_t e = cudaFuncSetAttribute(
      flash_fwd_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (e != cudaSuccess) return (int)e;
  dim3 grid((seq + kTile - 1) / kTile, batch * hq);
  flash_fwd_kernel<T><<<grid, kThreads, smem, (cudaStream_t)stream>>>(
      (const T*)q, (const T*)k, (const T*)v, (T*)out, (float*)lse, seq, hq,
      hkv, d, qs, ks, vs, scale);
  return (int)cudaGetLastError();
}

}  // namespace

#define TK8S_FLASH_FWD(SUFFIX, T)                                            \
  extern "C" int tk8s_flash_fwd_##SUFFIX(                                    \
      const void* q, const void* k, const void* v, void* out, void* lse,     \
      int batch, int seq, int hq, int hkv, int d, long long qsb,             \
      long long qss, long long qsh, long long ksb, long long kss,            \
      long long ksh, long long vsb, long long vss, long long vsh,            \
      float scale, int variant, void* stream) {                              \
    return launch<T>(q, k, v, out, lse, batch, seq, hq, hkv, d,              \
                     Strides{qsb, qss, qsh}, Strides{ksb, kss, ksh},         \
                     Strides{vsb, vss, vsh}, scale, variant, stream);        \
  }

TK8S_FLASH_FWD(bf16, __nv_bfloat16)
TK8S_FLASH_FWD(f32, float)

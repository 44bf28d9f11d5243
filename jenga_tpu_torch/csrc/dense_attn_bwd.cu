// The backward of dense attention (D) with per-sample key lengths, for
// Hopper (sm_90a): a dK|dV kernel and a dQ kernel.
//
// Replaces the stock Pallas TPU kernels behind the custom VJP of the flash
// kernel that jenga_tpu/ops/flash_attention.py:92 (`pl_flash`) calls, in
// jax/experimental/pallas/ops/tpu/flash_attention.py:
//   * dense_bwd_dkv: `_flash_attention_bwd_dkv` (:941; kernel
//     `_flash_attention_dkv_kernel` :796, pallas_call :1121);
//   * dense_bwd_dq: `_flash_attention_bwd_dq` (:1287; kernel
//     `_flash_attention_dq_kernel` :1146, pallas_call :1456).
// The training step reaches them through the autograd Function around D
// (ops/flash_attention.py): Wan's self- and cross-attention, HunyuanVideo's
// dense joint attention.
//
// Math, per (batch, head), from the forward's base-2 statistics
// (dense_attn.cu stores lse_i = m_i + log2(l_i) of s_ij below):
//   s_ij  = (q_i . k_j) * sm_scale * log2(e),  kv_valid = min(kv_len[b], Skv)
//   P_ij  = exp2(s_ij - lse_i) for j < kv_valid, else 0
//   di_i  = sum_d dO_id O_id   (the caller's, in torch: JAX computes it in
//                               jnp too)
//   dV_j  = sum_i P_ij dO_i,   dP_ij = dO_i . v_j
//   dS_ij = P_ij (dP_ij - di_i)
//   dQ_i  = sm_scale sum_j dS_ij k_j,   dK_j = sm_scale sum_i dS_ij q_i
// The factor is the natural sm_scale: log2(e) lives only inside P. Keys at
// or past kv_valid get dK = dV = 0; a row with no valid key has lse = +inf,
// so its P is 0 and its dQ is 0. lse and di are [bh, ceil(Sq / 128) * 128]
// with +inf and 0 in the padded rows.
//
// What bounds them: the tensor cores. dkv does four products per (query,
// key) pair (S, dP, dV, dK), 8 Sq Skv d FLOP per head, dq three (S, dP,
// dQ), 6 Sq Skv d: 26.7 and 20.0 ms at Wan's self-attention (2x12x32768)
// at the H100's 989 TFLOP/s bf16. Every tile re-reads its operands from L2;
// the bytes bound only the short key sets (257 image keys).
//
// Design, right and simple first, on the attn_sm90.cuh primitives: 384
// threads per block, a TMA producer thread in a warpgroup that drops to 40
// registers, two wgmma consumer warpgroups raised to 232 registers, each
// owning 64 rows of the block's tile, and a 2-stage full/empty mbarrier
// ring.
//   * dkv: one block per (128-key tile, batch*head). K and V of the tile are
//     loaded once; the ring streams 64-query tiles of Q and dO (3-D tensor
//     maps, 128-byte swizzle) and the rows' lse and di (1-D bulk copies).
//     Per query tile a consumer warpgroup computes S^T = K Q^T and dP^T =
//     V dO^T for its 64 keys (wgmma m64n64k16, both operands in shared
//     memory), P and dS on the accumulator registers, then dV += P^T dO and
//     dK += dS^T Q (m64n128k16) with P^T and dS^T as register A fragments
//     (the accumulator layout is the A-fragment layout) and dO, Q read as
//     MN-major B operands through their descriptors.
//   * dq: one block per (128-query tile, batch*head). Q and dO are loaded
//     once and each consumer thread reads its two rows' lse and di; the
//     ring streams 64-key tiles of K and V below kv_valid. Per key tile a
//     consumer warpgroup computes S = Q K^T and dP = dO V^T (m64n64k16),
//     dS, then dQ += dS K (m64n128k16, K MN-major).
// Accumulation is f32, the stored gradients bf16. Left for speed work: the
// overlap of one tile's products with the previous tile's elementwise part,
// a deeper ring, 128-wide tiles, and one fused kernel with dQ atomics.
// At few keys (512 text keys) dkv has only ceil(Skv / 128) x bh blocks,
// fewer than the card's 132 SMs at 12 heads.
//
// Plain C interface (loaded with ctypes); the launches go on the caller's
// stream and each function returns cudaGetLastError().

#include "attn_sm90.cuh"

using namespace sm90;

namespace {

constexpr int BQ = 64;                          // queries of a dkv ring tile
constexpr int BK = 64;                          // keys of a dq ring tile
constexpr uint32_t BOX64 = 64 * BOX_COLS * 2;       // 8 KB: 64 rows x 64 cols
constexpr uint32_t TILE64 = 2 * BOX64;              // 16 KB: 64 x 128 bf16
// dkv: K and V (128 x 128 each), then the ring of Q | dO | lse | di stages
constexpr uint32_t DKV_RING = 2 * TILE_BYTES;
constexpr uint32_t DKV_STAGE = 2 * TILE64 + 1024;   // lse, di: 256 B each
constexpr uint32_t DKV_BAR = DKV_RING + STAGES * DKV_STAGE;
constexpr size_t DKV_SMEM = DKV_BAR + 64 + 1024;
// dq: Q and dO (128 x 128 each), then the ring of K | V (64 x 128 each)
constexpr uint32_t DQ_RING = 2 * TILE_BYTES;
constexpr uint32_t DQ_STAGE = 2 * TILE64;
constexpr uint32_t DQ_BAR = DQ_RING + STAGES * DQ_STAGE;
constexpr size_t DQ_SMEM = DQ_BAR + 64 + 1024;
static_assert(DKV_SMEM <= 232448 && DQ_SMEM <= 232448, "227 KB per block");

struct BwdParams {
  __nv_bfloat16* dq;     // [bh, sq, D]
  __nv_bfloat16* dk;     // [bh, skv, D]
  __nv_bfloat16* dv;
  const float* lse;      // [bh, sq_pad]
  const float* di;       // [bh, sq_pad]
  const int* kv_len;     // [B] or null
  int heads, sq, skv, sq_pad;
  float sm_scale;
};

// d (64 rows x 64 f32, the warpgroup's accumulator) = A B (+ d if
// accumulate), A and B K-major in shared memory.
__device__ __forceinline__ void wgmma_ss_n64(float (&d)[32], uint64_t da,
                                             uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, "
      "%29, %30, %31}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(accumulate));
}

// A 1-D copy of `bytes` (a multiple of 16, both ends 16-byte aligned) from
// device memory into shared memory, counted in bytes on `bar`.
__device__ __forceinline__ void bulk_load(void* dst, const void* src,
                                          uint32_t bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(src)), "r"(bytes), "r"(smem_u32(bar))
      : "memory");
}

__device__ __forceinline__ unsigned char* aligned_smem() {
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  return smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
}

__device__ __forceinline__ int kv_valid_of(const BwdParams& p, int bh) {
  return p.kv_len == nullptr ? p.skv
                             : max(0, min(p.kv_len[bh / p.heads], p.skv));
}

__device__ __forceinline__ void init_barriers(uint64_t* bars) {
  if (threadIdx.x == 0) {
    mbar_init(&bars[0], 1);                   // the resident tiles
#pragma unroll
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(&bars[1 + s], 1);             // full
      mbar_init(&bars[1 + STAGES + s], CONSUMER_WARPS);  // empty
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
}

// Two 64-column boxes of `rows` rows of a 3-D map into dst.
__device__ __forceinline__ void load_tile(unsigned char* dst,
                                          const CUtensorMap* map,
                                          uint64_t* bar, int row, int bh,
                                          uint32_t box_bytes) {
  tma_load(dst, map, bar, 0, row, bh);
  tma_load(dst + box_bytes, map, bar, BOX_COLS, row, bh);
}

// Store this thread's two rows (r, r + 8 of a 64-row accumulator slice) of
// a 64 x 128 f32 accumulator, times `scale`, as bf16 rows of `out`; rows at
// or past `n_rows` are not stored.
__device__ __forceinline__ void store_rows(const float (&acc)[64],
                                           __nv_bfloat16* out, int row0,
                                           int n_rows, int t, float scale) {
#pragma unroll
  for (int rr = 0; rr < 2; ++rr) {
    const int row = row0 + 8 * rr;
    if (row >= n_rows) continue;
    __nv_bfloat16* orow = out + (size_t)row * D + 2 * t;
#pragma unroll
    for (int nb = 0; nb < 16; ++nb)
      *reinterpret_cast<__nv_bfloat162*>(orow + 8 * nb) =
          __floats2bfloat162_rn(acc[4 * nb + 2 * rr] * scale,
                                acc[4 * nb + 2 * rr + 1] * scale);
  }
}

// Accumulator element i of a m64nN tile is row g + 8 * ((i >> 1) & 1),
// column 8 * (i >> 2) + 2t + (i & 1); k-step kk of the A fragments made
// from it holds columns 16kk..16kk+15, elements 8kk..8kk+7.
__device__ __forceinline__ void pack_a(const float (&x)[32],
                                       uint32_t (&a)[4][4]) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
#pragma unroll
    for (int e = 0; e < 4; ++e)
      a[kk][e] = pack_bf16(x[8 * kk + 2 * e], x[8 * kk + 2 * e + 1]);
}

__global__ void __launch_bounds__(THREADS, 1)
    dense_bwd_dkv_kernel(const __grid_constant__ CUtensorMap tq,
                         const __grid_constant__ CUtensorMap tdo,
                         const __grid_constant__ CUtensorMap tk,
                         const __grid_constant__ CUtensorMap tv,
                         const BwdParams p) {
  unsigned char* smem = aligned_smem();
  uint64_t* kv_full = reinterpret_cast<uint64_t*>(smem + DKV_BAR);
  uint64_t* full = kv_full + 1;
  uint64_t* empty = full + STAGES;
  const int kt = blockIdx.x, bh = blockIdx.y;
  const int kv_valid = kv_valid_of(p, bh);
  // a key tile wholly past kv_valid walks no query tile: its gradients are 0
  const int nq = kt * BN < kv_valid ? (p.sq + BQ - 1) / BQ : 0;
  init_barriers(kv_full);

  if (threadIdx.x < 128) {
    // ===== producer: one thread issues every copy =====
    regs_dealloc<40>();
    if (threadIdx.x != 0 || nq == 0) return;
    mbar_expect_tx(kv_full, 2 * TILE_BYTES);
    load_tile(smem, &tk, kv_full, kt * BN, bh, BOX_BYTES);
    load_tile(smem + TILE_BYTES, &tv, kv_full, kt * BN, bh, BOX_BYTES);
    const float* lse = p.lse + (size_t)bh * p.sq_pad;
    const float* di = p.di + (size_t)bh * p.sq_pad;
    for (int j = 0; j < nq; ++j) {
      const int s = j % STAGES;
      mbar_wait(&empty[s], ((j / STAGES) & 1) ^ 1);
      unsigned char* st = smem + DKV_RING + s * DKV_STAGE;
      mbar_expect_tx(&full[s], 2 * TILE64 + 2 * BQ * 4);
      load_tile(st, &tq, &full[s], j * BQ, bh, BOX64);
      load_tile(st + TILE64, &tdo, &full[s], j * BQ, bh, BOX64);
      bulk_load(st + 2 * TILE64, lse + j * BQ, BQ * 4, &full[s]);
      bulk_load(st + 2 * TILE64 + BQ * 4, di + j * BQ, BQ * 4, &full[s]);
    }
  } else {
    // ===== consumers: 64 keys each =====
    regs_alloc<232>();
    const int ct = threadIdx.x - 128;
    const int cw = ct / 128;
    const int warp = (ct % 128) / 32, lane = ct % 32;
    const int g = lane >> 2, t = lane & 3;
    const int r0 = cw * 64 + warp * 16 + g;      // rows r0, r0 + 8 of the tile
    const bool valid0 = kt * BN + r0 < kv_valid;
    const bool valid1 = kt * BN + r0 + 8 < kv_valid;
    const float scale2 = p.sm_scale * LOG2E;
    const unsigned char* ks = smem + cw * 64 * 128;
    const unsigned char* vs = smem + TILE_BYTES + cw * 64 * 128;

    float dv[64], dk[64];
#pragma unroll
    for (int i = 0; i < 64; ++i) dv[i] = dk[i] = 0.f;
    if (nq > 0) mbar_wait(kv_full, 0);

    for (int j = 0; j < nq; ++j) {
      const int s = j % STAGES;
      mbar_wait(&full[s], (j / STAGES) & 1);
      const unsigned char* qs = smem + DKV_RING + s * DKV_STAGE;
      const unsigned char* dos = qs + TILE64;
      const float* lse = reinterpret_cast<const float*>(qs + 2 * TILE64);
      const float* di = lse + BQ;

      // S^T = K Q^T and dP^T = V dO^T: 8 k-steps of 16 dims, 4 per box
      float st[32], dpt[32];
      wg_fence();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        const uint32_t oa = (kk / 4) * BOX_BYTES + (kk % 4) * 32;
        const uint32_t ob = (kk / 4) * BOX64 + (kk % 4) * 32;
        wgmma_ss_n64(st, sw128_desc(ks + oa, 16, 1024),
                     sw128_desc(qs + ob, 16, 1024), kk > 0);
      }
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        const uint32_t oa = (kk / 4) * BOX_BYTES + (kk % 4) * 32;
        const uint32_t ob = (kk / 4) * BOX64 + (kk % 4) * 32;
        wgmma_ss_n64(dpt, sw128_desc(vs + oa, 16, 1024),
                     sw128_desc(dos + ob, 16, 1024), kk > 0);
      }
      wg_commit();
      wg_wait<0>();
      reg_fence(st);
      reg_fence(dpt);

      // P and dS: element i is key row r0 + 8 * ((i >> 1) & 1), query
      // column c = 8 * (i >> 2) + 2t + (i & 1) of this tile
#pragma unroll
      for (int i = 0; i < 32; ++i) {
        const int c = 8 * (i >> 2) + 2 * t + (i & 1);
        const bool ok = (i & 2) ? valid1 : valid0;
        const float pv = ok ? ex2(fmaf(st[i], scale2, -lse[c])) : 0.f;
        st[i] = pv;
        dpt[i] = pv * (dpt[i] - di[c]);
      }
      uint32_t pa[4][4], da[4][4];
      pack_a(st, pa);
      pack_a(dpt, da);

      // dV += P^T dO, dK += dS^T Q: k-step kk is queries 16kk..16kk+15,
      // 2 KB into each 64-column box; the boxes are BOX64 apart
      reg_fence(dv);
      reg_fence(dk);
      reg_fence(pa);
      reg_fence(da);
      wg_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        wgmma_rs(dv, pa[kk], sw128_desc(dos + kk * 16 * 128, BOX64, 1024));
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        wgmma_rs(dk, da[kk], sw128_desc(qs + kk * 16 * 128, BOX64, 1024));
      wg_commit();
      wg_wait<0>();
      reg_fence(dv);
      reg_fence(dk);
      reg_fence(pa);
      reg_fence(da);
      __syncwarp();
      if (lane == 0) mbar_arrive(&empty[s]);
    }

    const size_t base = ((size_t)bh * p.skv + (size_t)kt * BN) * D;
    const int n_rows = min(BN, p.skv - kt * BN);
    store_rows(dk, p.dk + base, r0, n_rows, t, p.sm_scale);
    store_rows(dv, p.dv + base, r0, n_rows, t, 1.f);
  }
}

__global__ void __launch_bounds__(THREADS, 1)
    dense_bwd_dq_kernel(const __grid_constant__ CUtensorMap tq,
                        const __grid_constant__ CUtensorMap tdo,
                        const __grid_constant__ CUtensorMap tk,
                        const __grid_constant__ CUtensorMap tv,
                        const BwdParams p) {
  unsigned char* smem = aligned_smem();
  uint64_t* q_full = reinterpret_cast<uint64_t*>(smem + DQ_BAR);
  uint64_t* full = q_full + 1;
  uint64_t* empty = full + STAGES;
  const int qb = blockIdx.x, bh = blockIdx.y;
  // the key tiles below kv_valid
  const int nk = (kv_valid_of(p, bh) + BK - 1) / BK;
  init_barriers(q_full);

  if (threadIdx.x < 128) {
    // ===== producer =====
    regs_dealloc<40>();
    if (threadIdx.x != 0 || nk == 0) return;
    mbar_expect_tx(q_full, 2 * TILE_BYTES);
    load_tile(smem, &tq, q_full, qb * BM, bh, BOX_BYTES);
    load_tile(smem + TILE_BYTES, &tdo, q_full, qb * BM, bh, BOX_BYTES);
    for (int j = 0; j < nk; ++j) {
      const int s = j % STAGES;
      mbar_wait(&empty[s], ((j / STAGES) & 1) ^ 1);
      unsigned char* st = smem + DQ_RING + s * DQ_STAGE;
      mbar_expect_tx(&full[s], 2 * TILE64);
      load_tile(st, &tk, &full[s], j * BK, bh, BOX64);
      load_tile(st + TILE64, &tv, &full[s], j * BK, bh, BOX64);
    }
  } else {
    // ===== consumers: 64 query rows each =====
    regs_alloc<232>();
    const int ct = threadIdx.x - 128;
    const int cw = ct / 128;
    const int warp = (ct % 128) / 32, lane = ct % 32;
    const int g = lane >> 2, t = lane & 3;
    const int r0 = cw * 64 + warp * 16 + g;      // rows r0, r0 + 8 of the tile
    const int kv_valid = kv_valid_of(p, bh);
    const float scale2 = p.sm_scale * LOG2E;
    const size_t row_off = (size_t)bh * p.sq_pad + (size_t)qb * BM + r0;
    const float lse_r[2] = {p.lse[row_off], p.lse[row_off + 8]};
    const float di_r[2] = {p.di[row_off], p.di[row_off + 8]};
    const unsigned char* q_rows = smem + cw * 64 * 128;
    const unsigned char* do_rows = smem + TILE_BYTES + cw * 64 * 128;

    float dq[64];
#pragma unroll
    for (int i = 0; i < 64; ++i) dq[i] = 0.f;
    if (nk > 0) mbar_wait(q_full, 0);

    for (int j = 0; j < nk; ++j) {
      const int s = j % STAGES;
      mbar_wait(&full[s], (j / STAGES) & 1);
      const unsigned char* ks = smem + DQ_RING + s * DQ_STAGE;
      const unsigned char* vs = ks + TILE64;

      // S = Q K^T and dP = dO V^T
      float sc[32], dp[32];
      wg_fence();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        const uint32_t oa = (kk / 4) * BOX_BYTES + (kk % 4) * 32;
        const uint32_t ob = (kk / 4) * BOX64 + (kk % 4) * 32;
        wgmma_ss_n64(sc, sw128_desc(q_rows + oa, 16, 1024),
                     sw128_desc(ks + ob, 16, 1024), kk > 0);
      }
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        const uint32_t oa = (kk / 4) * BOX_BYTES + (kk % 4) * 32;
        const uint32_t ob = (kk / 4) * BOX64 + (kk % 4) * 32;
        wgmma_ss_n64(dp, sw128_desc(do_rows + oa, 16, 1024),
                     sw128_desc(vs + ob, 16, 1024), kk > 0);
      }
      wg_commit();
      wg_wait<0>();
      reg_fence(sc);
      reg_fence(dp);

      // dS, keys at or past kv_valid masked in the tile that crosses it
      const bool need_mask = (j + 1) * BK > kv_valid;
      const int lim = kv_valid - j * BK - 2 * t;
#pragma unroll
      for (int i = 0; i < 32; ++i) {
        const int rr = (i >> 1) & 1;
        float pv = ex2(fmaf(sc[i], scale2, -lse_r[rr]));
        if (need_mask && 8 * (i >> 2) + (i & 1) >= lim) pv = 0.f;
        dp[i] = pv * (dp[i] - di_r[rr]);
      }
      uint32_t da[4][4];
      pack_a(dp, da);

      // dQ += dS K: k-step kk is keys 16kk..16kk+15
      reg_fence(dq);
      reg_fence(da);
      wg_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        wgmma_rs(dq, da[kk], sw128_desc(ks + kk * 16 * 128, BOX64, 1024));
      wg_commit();
      wg_wait<0>();
      reg_fence(dq);
      reg_fence(da);
      __syncwarp();
      if (lane == 0) mbar_arrive(&empty[s]);
    }

    store_rows(dq, p.dq + ((size_t)bh * p.sq + (size_t)qb * BM) * D, r0,
               min(BM, p.sq - qb * BM), t, p.sm_scale);
  }
}

BwdParams make_params(const void* lse, const void* di, const void* kv_len,
                      int heads, int sq, int skv, float sm_scale) {
  BwdParams p{};
  p.lse = static_cast<const float*>(lse);
  p.di = static_cast<const float*>(di);
  p.kv_len = static_cast<const int*>(kv_len);
  p.heads = heads;
  p.sq = sq;
  p.skv = skv;
  p.sq_pad = (sq + BM - 1) / BM * BM;
  p.sm_scale = sm_scale;
  return p;
}

template <class Kernel>
int launch(Kernel kernel, size_t smem, dim3 grid, const CUtensorMap& tq,
           const CUtensorMap& tdo, const CUtensorMap& tk,
           const CUtensorMap& tv, const BwdParams& p, void* stream) {
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  kernel<<<grid, THREADS, smem, static_cast<cudaStream_t>(stream)>>>(
      tq, tdo, tk, tv, p);
  return (int)cudaGetLastError();
}

}  // namespace

// dK, dV [bh, skv, D] bf16 from q, dout [bh, sq, D], k, v [bh, skv, D]
// (bf16), lse and di [bh, ceil(sq / 128) * 128] f32 and kv_len [B] or null.
extern "C" int dense_attn_bwd_dkv(const void* q, const void* k, const void* v,
                                  const void* dout, const void* lse,
                                  const void* di, const void* kv_len,
                                  void* dk, void* dv, int bh, int heads,
                                  int sq, int skv, float sm_scale,
                                  void* stream) {
  CUtensorMap tq, tdo, tk, tv;
  if (!make_map(&tq, q, bh, sq, BQ) || !make_map(&tdo, dout, bh, sq, BQ) ||
      !make_map(&tk, k, bh, skv) || !make_map(&tv, v, bh, skv))
    return (int)cudaErrorInvalidValue;
  BwdParams p = make_params(lse, di, kv_len, heads, sq, skv, sm_scale);
  p.dk = static_cast<__nv_bfloat16*>(dk);
  p.dv = static_cast<__nv_bfloat16*>(dv);
  return launch(dense_bwd_dkv_kernel, DKV_SMEM, dim3((skv + BN - 1) / BN, bh),
                tq, tdo, tk, tv, p, stream);
}

// dQ [bh, sq, D] bf16 from the same operands.
extern "C" int dense_attn_bwd_dq(const void* q, const void* k, const void* v,
                                 const void* dout, const void* lse,
                                 const void* di, const void* kv_len, void* dq,
                                 int bh, int heads, int sq, int skv,
                                 float sm_scale, void* stream) {
  CUtensorMap tq, tdo, tk, tv;
  if (!make_map(&tq, q, bh, sq) || !make_map(&tdo, dout, bh, sq) ||
      !make_map(&tk, k, bh, skv, BK) || !make_map(&tv, v, bh, skv, BK))
    return (int)cudaErrorInvalidValue;
  BwdParams p = make_params(lse, di, kv_len, heads, sq, skv, sm_scale);
  p.dq = static_cast<__nv_bfloat16*>(dq);
  return launch(dense_bwd_dq_kernel, DQ_SMEM, dim3((sq + BM - 1) / BM, bh),
                tq, tdo, tk, tv, p, stream);
}

extern "C" const char* dense_attn_bwd_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

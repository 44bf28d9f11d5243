// The backward of dense attention (D) over short key sequences (Skv <= 512)
// with per-sample key lengths, for Hopper (sm_90a): the short-key route of
// D's backward, three kernels launched by one call.
//
// Replaces, with dense_attn_bwd.cu (the route for Skv > 512), the stock
// Pallas TPU kernels behind the custom VJP of the flash kernel that
// jenga_tpu/ops/flash_attention.py:92 (`pl_flash`) calls, in
// jax/experimental/pallas/ops/tpu/flash_attention.py:
//   * `_flash_attention_bwd_dq` (:1287; kernel `_flash_attention_dq_kernel`
//     :1146, pallas_call :1456) -> bwd_dq_short, which also computes di;
//   * `_flash_attention_bwd_dkv` (:941; kernel `_flash_attention_dkv_kernel`
//     :796, pallas_call :1121) -> bwd_dkv_short (+ bwd_dkv_reduce).
// For keys up to 2048 JAX tiles them whole (bk = Skv), and computes di in
// jnp outside its kernels; here bwd_dq_short computes it. The training step
// reaches this route for Wan's cross-attention: 512 text keys in every Wan
// model, Wan2.1-I2V-14B's 257 CLIP image keys, over 32,760 query rows.
//
// Math, per (batch, head), from the forward's base-2 statistics lse_i (D's
// forward stores m_i + log2(l_i), +inf for a row with no valid key):
//   s_ij  = (q_i . k_j) * sm_scale * log2(e),  kv_valid = min(kv_len[b], Skv)
//   P_ij  = exp2(s_ij - lse_i) for j < kv_valid, else 0 (a select)
//   di_i  = sum_d dO_id O_id   (f32, from the bf16 dO and O)
//   dP_ij = dO_i . v_j,  dS_ij = P_ij (dP_ij - di_i)
//   dQ_i  = sm_scale sum_j dS_ij k_j,  dK_j = sm_scale sum_i dS_ij q_i,
//   dV_j  = sum_i P_ij dO_i
// Keys at or past kv_valid get dK = dV = 0; a row with no valid key (lse
// +inf) gets P = 0 and dQ = 0.
//
// What bounds it on the card: five products per (query, valid key) pair,
// 10 Sq Skv d FLOP per head, against q, o, dO, dq (Sq x d each) and k, v, dk,
// dv read or written once. At Wan-14B's image cross-attention (2 x 40 x
// 32,768 rows, 257 keys) the two are close: 0.87 ms of bf16 tensor-core
// time, 0.80 ms of HBM time for 2.7 GB. The products of dK|dV need all of a
// head's queries per key and those of dQ all of its keys per query, so the
// work is split in two kernels that both recompute S and dP (seven products
// instead of five), each accumulating its gradient in registers; no atomic
// and no f32 gradient copy the size of q.
//
// Design, on the attn_sm90.cuh primitives (TMA, mbarriers, wgmma), 384
// threads: a producer warpgroup whose lane 0 issues every copy, two wgmma
// consumer warpgroups of 64 rows each.
//   * bwd_dq_short: persistent, one block per SM, walking a contiguous
//     head-major run of (batch*head, 128-row query tile) units, as D's
//     short forward (dense_attn_short.cu). K of the head stays resident in
//     shared memory, V too up to 320 keys, else V streams through a 4-stage
//     ring. Keys go in 32-key sub-tiles, so the tail costs at most 31 key
//     columns (257 keys: 288). Each unit's Q and dO land in their own
//     buffers and are copied into registers as wgmma A-fragments (ldmatrix),
//     which frees the buffers for the next unit's tiles a whole unit ahead;
//     O is prefetched into L2 a unit ahead (cp.async.bulk.prefetch.tensor)
//     and read by the consumers into registers for di (32 columns of two
//     rows a thread, 16 bytes a load), the rows' lse a unit ahead. Per
//     sub-tile: S = Q K^T and dP = dO V^T (wgmma m64n32k16, A from
//     registers), dS on the accumulators, dQ += dS K (m64n128k16, K
//     MN-major); the dQ product of a sub-tile is issued with S and dP of the
//     next, and the two consumer warpgroups take turns on named barriers
//     (ping-pong), so one warpgroup's elementwise work runs under the
//     other's products. Each unit writes its rows' lse and di into a padded
//     f32 workspace for bwd_dkv_short (+inf and 0 past Sq).
//   * bwd_dkv_short: one block per (key tile of 128, query chunk, batch*head)
//     with the key tile fastest, so the blocks of one chunk's key tiles run
//     together and read its Q and dO tiles from L2 but once from memory.
//     The chunk count C is the host's choice (it fills the card's waves:
//     at Wan 1.3B's 12 heads over 4 key tiles, 96 tiles on 132 SMs).
//     K and V of the tile stay in shared memory; a 2-stage ring streams
//     64-row Q and dO tiles with their lse and di (the dK|dV body of
//     dense_attn_bwd.cu: S^T = K Q^T and dP^T = V dO^T m64n64k16, dV += P^T
//     dO and dK += dS^T Q m64n128k16 with P^T and dS^T from registers), the
//     two warpgroups taking turns on named barriers (ping-pong). A last key
//     tile of at most 64 keys (257 keys: one) runs both warpgroups on its
//     64 keys, each over one of two query tiles a stage, so it costs half a
//     tile. With C = 1 a block writes bf16 dK and dV; else (and in a narrow
//     last tile) f32 partials, which bwd_dkv_reduce sums in a fixed order,
//     so two runs give equal bits.
//   * Layout: q, k, v, o, dO are read through 4-D tensor maps over the
//     caller's strides (last dim contiguous, the others multiples of 8
//     elements); dq, dk, dv are written with their own strides, so Wan's
//     [B, S, H, D] views get [B, S, H, D] gradients with no copy.
//   * Every product of a step is unconditional: steps are chosen whole by
//     branches uniform over the block (ptxas serializes every wgmma of a
//     kernel when one sits on a divergent path, C7520).
// Left for speed work: the dK|dV tail still costs 64 key rows for one key
// (257 keys), and dK|dV's products of a stage wait on its elementwise part
// within a warpgroup (the next stage's S^T is not issued under it).
//
// Shared memory, bwd_dq_short:
//   Q tile, dO tile (128 x 128 bf16 each) ............  65,536 B
//   K and V, 320 keys each (V resident, Skv <= 320)
//     or K 512 keys + a 4-stage ring of 32-key V ...... 163,840 B
//   14 mbarriers, slack to the 1024-byte swizzle atom .   1,152 B
//   total ............................................ 230,528 B
// bwd_dkv_short: K, V tiles 65,536 B + 2 stages of (two 64-row Q and dO
// tiles, 512 B of lse and of di) 133,120 B + barriers and slack: 199,744 B.
//
// Plain C interface (loaded with ctypes); the launches go on the caller's
// stream and the function returns cudaGetLastError(), or
// cudaErrorInvalidValue for a shape it does not take or a tensor map that
// cannot be encoded.

#include "attn_sm90.cuh"

namespace {

using namespace sm90;

constexpr int MAX_KEYS = 512;
constexpr int MAP_ERROR = 10000;                // + the index of a bad map
constexpr int SUB = 32;                        // keys of a dq sub-tile
constexpr uint32_t SUB_BOX = SUB * BOX_COLS * 2;   // 4 KB: 32 rows x 64 cols
constexpr int RES_KEYS = 320;                  // V resident up to here
constexpr int V_STAGES = 4;                    // the V ring beyond it
constexpr uint32_t DQ_Q = 0;
constexpr uint32_t DQ_DO = TILE_BYTES;
constexpr uint32_t DQ_KV = 2 * TILE_BYTES;
constexpr uint32_t DQ_KV_BYTES = 2 * RES_KEYS * 256;
constexpr uint32_t DQ_BAR = DQ_KV + DQ_KV_BYTES;
constexpr size_t DQ_SMEM = DQ_BAR + 128 + 1024;
static_assert(MAX_KEYS * 256 + V_STAGES * 2 * SUB_BOX == DQ_KV_BYTES,
              "K of 512 keys and the V ring fill the resident K|V area");
static_assert(DQ_SMEM == 230528 && DQ_SMEM <= 232448, "the layout above");

// dkv: K and V (128 x 128 each), then the ring of Q | dO | lse | di stages
constexpr int BQ = 64;                           // queries of a ring tile
constexpr uint32_t BOX64 = BQ * BOX_COLS * 2;    // 8 KB: 64 rows x 64 cols
constexpr uint32_t TILE64 = 2 * BOX64;           // 16 KB: 64 x 128 bf16
constexpr uint32_t DKV_RING = 2 * TILE_BYTES;
constexpr uint32_t DKV_STAGE = 4 * TILE64 + 1024;
constexpr uint32_t DKV_BAR = DKV_RING + STAGES * DKV_STAGE;
constexpr size_t DKV_SMEM = DKV_BAR + 64 + 1024;
static_assert(DKV_SMEM == 199744, "the layout above");

// K|V of bwd_dq_short: K resident in two column halves of K_ROWS rows; V
// resident likewise (VRES) or a ring of V_STAGES 32-key stages.
template <bool VRES>
struct DqSlots {
  static constexpr int K_ROWS = VRES ? RES_KEYS : MAX_KEYS;
  static constexpr uint32_t K_HALF = K_ROWS * 128;
  static constexpr uint32_t V_OFF = DQ_KV + 2 * K_HALF;
  static constexpr uint32_t V_HALF = VRES ? K_HALF : SUB_BOX;
};

struct DqParams {
  const __nv_bfloat16* o;
  long long o_s, o_h, o_b;     // O's element strides: row, head, sample
  __nv_bfloat16* dq;
  long long dq_s, dq_h, dq_b;
  const float* lse;            // [B, H, Sq], rows contiguous
  long long lse_b, lse_h;
  float* lse_p;                // [B*H, sq_pad] workspace: lse, +inf past Sq
  float* di_p;                 // [B*H, sq_pad] workspace: di, 0 past Sq
  const int* kv_len;           // [B] or null
  long long units;             // B * H * nqt
  int heads, sq, skv, nqt, sq_pad;
  float scale2;                // sm_scale * log2(e)
  float sm_scale;
};

struct DkvParams {
  __nv_bfloat16* dk;
  __nv_bfloat16* dv;
  long long dk_s, dk_h, dk_b, dv_s, dv_h, dv_b;
  const float* lse_p;          // the dq kernel's workspace
  const float* di_p;
  float* part;                 // [seg * chunks + c][2][128][128] f32
  const int* kv_len;
  int heads, skv, nkt, nq64, sq_pad, chunks;
  float scale2, sm_scale;
};

// ---- shared helpers --------------------------------------------------------

// One box of a 4-D tensor map ({column, row, head, sample}) into shared
// memory; completion is counted in bytes on `bar`.
__device__ __forceinline__ void tma_load4(void* dst, const CUtensorMap* map,
                                          uint64_t* bar, int col, int row,
                                          int h, int b) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(col),
      "r"(row), "r"(h), "r"(b)
      : "memory");
}

// Both 64-column boxes of `row`'s box of a 4-D map, `half` bytes apart.
__device__ __forceinline__ void load_halves(unsigned char* dst,
                                            const CUtensorMap* map,
                                            uint64_t* bar, uint32_t half,
                                            int row, int h, int b) {
  tma_load4(dst, map, bar, 0, row, h, b);
  tma_load4(dst + half, map, bar, BOX_COLS, row, h, b);
}

// Both 64-column boxes of `row`'s box into L2 only.
__device__ __forceinline__ void prefetch_halves(const CUtensorMap* map,
                                                int row, int h, int b) {
#pragma unroll
  for (int c = 0; c < 2; ++c)
    asm volatile(
        "cp.async.bulk.prefetch.tensor.4d.L2.global.tile [%0, {%1, %2, %3, "
        "%4}];\n" ::"l"(reinterpret_cast<uint64_t>(map)),
        "r"(c * BOX_COLS), "r"(row), "r"(h), "r"(b)
        : "memory");
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

__device__ __forceinline__ int kv_valid_of(const int* kv_len, int b,
                                           int skv) {
  return kv_len == nullptr ? skv : max(0, min(kv_len[b], skv));
}

__device__ __forceinline__ void release(uint64_t* bar, int lane) {
  __syncwarp();
  if (lane == 0) mbar_arrive(bar);
}

// Order this warp's generic-proxy reads of a buffer before the producer's
// TMA rewrite of it (async proxy), then hand the buffer back.
__device__ __forceinline__ void release_buffer(uint64_t* bar, int lane) {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  release(bar, lane);
}

// ---- bwd_dq_short ------------------------------------------------------------

// d (64 rows x 32 f32) = A B (+ d if accumulate), A (64 x 16 bf16) in
// registers, B K-major in shared memory.
__device__ __forceinline__ void wgmma_rs_n32(float (&d)[16],
                                             const uint32_t (&a)[4],
                                             uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15}, {%16, %17, %18, %19}, %20, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db),
        "r"(accumulate));
}

// This warp's 16 rows of a landed 128 x 128 tile as wgmma A-fragments, one
// ldmatrix.x4 per k-step from the swizzled tile (as D's short forward).
__device__ __forceinline__ void load_frags(uint32_t (&a)[8][4],
                                           const unsigned char* tile,
                                           int row0, int lane) {
  const int r = row0 + (lane & 7) + 8 * ((lane >> 3) & 1);
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    const int c = 2 * kk + (lane >> 4);
    const uint32_t addr = smem_u32(tile + (c / 8) * BOX_BYTES + r * 128 +
                                   (((c % 8) ^ (r % 8)) * 16));
    asm volatile(
        "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
        : "=r"(a[kk][0]), "=r"(a[kk][1]), "=r"(a[kk][2]), "=r"(a[kk][3])
        : "r"(addr)
        : "memory");
  }
}

// Named barriers 1 and 2 order the two consumer warpgroups' products
// (ping-pong): a warpgroup waits on its own before issuing and arrives on
// the other's after, so one issues while the other runs its elementwise
// part.
__device__ __forceinline__ void pp_sync(int cw) {
  asm volatile("bar.sync %0, 256;\n" ::"r"(1 + cw) : "memory");
}
__device__ __forceinline__ void pp_arrive(int cw) {
  asm volatile("bar.arrive %0, 256;\n" ::"r"(2 - cw) : "memory");
}

// One ping-pong step of a sub-tile walk. DQ: dQ += dS K of the previous
// sub-tile (K rows at kp, 2 k-steps of 16 keys, K MN-major). SDP: S = Q K^T
// (kt) and dP = dO V^T (vt) of this sub-tile, 8 k-steps of 16 dims each.
// Issued together, committed once, waited on; every product of a step is
// unconditional.
template <bool DQ, bool SDP>
__device__ __forceinline__ void step(float (&dq)[64], uint32_t (&da)[2][4],
                                     const unsigned char* kp,
                                     float (&sc)[16], float (&dp)[16],
                                     uint32_t (&qa)[8][4],
                                     uint32_t (&doa)[8][4],
                                     const unsigned char* kt,
                                     const unsigned char* vt, uint32_t k_half,
                                     uint32_t v_half, int cw) {
  pp_sync(cw);
  if constexpr (DQ) {
    reg_fence(dq);
    reg_fence(da);
  }
  if constexpr (SDP) {
    reg_fence(qa);
    reg_fence(doa);
  }
  wg_fence();
  if constexpr (DQ) {
#pragma unroll
    for (int e = 0; e < SUB / 16; ++e)
      wgmma_rs(dq, da[e], sw128_desc(kp + e * 16 * 128, k_half, 1024));
  }
  if constexpr (SDP) {
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      wgmma_rs_n32(sc, qa[kk],
                   sw128_desc(kt + (kk / 4) * k_half + (kk % 4) * 32, 16,
                              1024),
                   kk > 0);
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      wgmma_rs_n32(dp, doa[kk],
                   sw128_desc(vt + (kk / 4) * v_half + (kk % 4) * 32, 16,
                              1024),
                   kk > 0);
  }
  wg_commit();
  pp_arrive(cw);
  wg_wait<0>();
  if constexpr (DQ) {
    reg_fence(dq);
    reg_fence(da);
  }
  if constexpr (SDP) {
    reg_fence(sc);
    reg_fence(dp);
    reg_fence(qa);
    reg_fence(doa);
  }
}

// dS of one 32-key sub-tile on the accumulators: element i of sc and dp is
// row r0 + 8 ((i >> 1) & 1), key 8 (i >> 2) + 2t + (i & 1) of the sub-tile.
// MASKED (the last sub-tile, lim < 32 valid keys) gives the keys at or past
// lim dS = 0 by a select. Leaves dS as bf16 A-fragments: k-step e = keys
// 16e..16e+15 = elements 8e..8e+7.
template <bool MASKED>
__device__ __forceinline__ void make_ds(const float (&sc)[16],
                                        const float (&dp)[16],
                                        uint32_t (&da)[2][4],
                                        const float (&lse_r)[2],
                                        const float (&di_r)[2], float scale2,
                                        int lim, int t) {
  float ds[16];
#pragma unroll
  for (int i = 0; i < 16; ++i) {
    const int rr = (i >> 1) & 1;
    const float p = ex2(fmaf(sc[i], scale2, -lse_r[rr]));
    const float x = p * (dp[i] - di_r[rr]);
    ds[i] = !MASKED || 8 * (i >> 2) + 2 * t + (i & 1) < lim ? x : 0.f;
  }
#pragma unroll
  for (int e = 0; e < 2; ++e)
#pragma unroll
    for (int k = 0; k < 4; ++k)
      da[e][k] = pack_bf16(ds[8 * e + 2 * k], ds[8 * e + 2 * k + 1]);
}

__device__ __forceinline__ void make_ds_keys(const float (&sc)[16],
                                             const float (&dp)[16],
                                             uint32_t (&da)[2][4],
                                             const float (&lse_r)[2],
                                             const float (&di_r)[2],
                                             float scale2, int lim, int t) {
  if (lim >= SUB)
    make_ds<false>(sc, dp, da, lse_r, di_r, scale2, SUB, t);
  else
    make_ds<true>(sc, dp, da, lse_r, di_r, scale2, lim, t);
}

// Store this thread's two rows (r0, r0 + 8 of the tile starting at global
// row `row0`) of a 64 x 128 f32 accumulator times `scale` as bf16 rows of
// `base` (row stride `rs` elements); rows at or past `n_rows` are skipped.
// Threads t and t ^ 1 swap one packed pair per two 8-column blocks (one
// shuffle), so each writes 8 contiguous bytes.
__device__ __forceinline__ void store_rows8(__nv_bfloat16* base, long long rs,
                                            int row0, int n_rows,
                                            const float (&acc)[64],
                                            float scale, int r0, int t) {
  const bool odd = t & 1;
#pragma unroll
  for (int rr = 0; rr < 2; ++rr) {
    const int row = row0 + r0 + 8 * rr;
    const bool keep = row < n_rows;
    __nv_bfloat16* orow = base + row * rs;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int ev = 4 * (2 * j) + 2 * rr, od = 4 * (2 * j + 1) + 2 * rr;
      const uint32_t pe = pack_bf16(acc[ev] * scale, acc[ev + 1] * scale);
      const uint32_t po = pack_bf16(acc[od] * scale, acc[od + 1] * scale);
      const uint32_t got = __shfl_xor_sync(0xffffffffu, odd ? pe : po, 1);
      if (keep)
        *reinterpret_cast<uint2*>(orow + 16 * j + 2 * t + (odd ? 6 : 0)) =
            odd ? make_uint2(got, po) : make_uint2(pe, got);
    }
  }
}

// Step (h, qt) on to the next unit of the head-major walk.
__device__ __forceinline__ void next_unit(int& b, int& h, int& qt, int heads,
                                          int nqt) {
  if (++qt == nqt) {
    qt = 0;
    if (++h == heads) {
      h = 0;
      ++b;
    }
  }
}

template <bool VRES>
__global__ void __launch_bounds__(THREADS, 1)
    bwd_dq_short(const __grid_constant__ CUtensorMap tq,
                 const __grid_constant__ CUtensorMap tdo,
                 const __grid_constant__ CUtensorMap to,
                 const __grid_constant__ CUtensorMap tk,
                 const __grid_constant__ CUtensorMap tv,
                 const DqParams p) {
  using S = DqSlots<VRES>;
  unsigned char* smem = aligned_smem();
  unsigned char* qs = smem + DQ_Q;
  unsigned char* dos = smem + DQ_DO;
  unsigned char* ks = smem + DQ_KV;
  unsigned char* vs = smem + S::V_OFF;
  uint64_t* q_full = reinterpret_cast<uint64_t*>(smem + DQ_BAR);
  uint64_t* q_empty = q_full + 1;
  uint64_t* do_full = q_full + 2;
  uint64_t* do_empty = q_full + 3;
  uint64_t* kv_full = q_full + 4;
  uint64_t* kv_empty = q_full + 5;
  uint64_t* v_full = q_full + 6;            // [V_STAGES] (V streamed)
  uint64_t* v_empty = v_full + V_STAGES;    // [V_STAGES]

  // this block's run of (batch, head, query tile) units, head-major
  const long long u0 = p.units * blockIdx.x / gridDim.x;
  const int count = (int)(p.units * (blockIdx.x + 1) / gridDim.x - u0);
  const int bh0 = (int)(u0 / p.nqt), qt0 = (int)(u0 % p.nqt);
  const int b0 = bh0 / p.heads, h0 = bh0 % p.heads;

  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    mbar_init(q_empty, CONSUMER_WARPS);
    mbar_init(do_full, 1);
    mbar_init(do_empty, CONSUMER_WARPS);
    mbar_init(kv_full, 1);
    mbar_init(kv_empty, CONSUMER_WARPS);
#pragma unroll
    for (int s = 0; s < V_STAGES; ++s) {
      mbar_init(&v_full[s], 1);
      mbar_init(&v_empty[s], CONSUMER_WARPS);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x < 128) {
    // ===== producer warpgroup: lane 0 of warp 0 issues every TMA =====
    regs_dealloc<40>();
    if (threadIdx.x != 0 || count == 0) return;
    // unit n's Q and dO (each into its buffer once the consumers have
    // copied the last one out) and its O into L2
    auto rows = [&](int n, int b, int h, int qt) {
      mbar_wait(q_empty, (n & 1) ^ 1);
      mbar_expect_tx(q_full, TILE_BYTES);
      load_halves(qs, &tq, q_full, BOX_BYTES, qt * BM, h, b);
      mbar_wait(do_empty, (n & 1) ^ 1);
      mbar_expect_tx(do_full, TILE_BYTES);
      load_halves(dos, &tdo, do_full, BOX_BYTES, qt * BM, h, b);
      prefetch_halves(&to, qt * BM, h, b);
    };
    int hc = 0;
    // a head's K (and V when resident), once the consumers are done with
    // the last head's; returns its 32-key sub-tiles
    auto keys = [&](int b, int h) {
      mbar_wait(kv_empty, (hc & 1) ^ 1);
      ++hc;
      const int nsub = (kv_valid_of(p.kv_len, b, p.skv) + SUB - 1) / SUB;
      if (nsub == 0) {
        mbar_arrive(kv_full);
        return 0;
      }
      mbar_expect_tx(kv_full, nsub * 2 * SUB_BOX * (VRES ? 2 : 1));
      for (int j = 0; j < nsub; ++j) {
        load_halves(ks + j * SUB * 128, &tk, kv_full, S::K_HALF, j * SUB, h,
                    b);
        if (VRES)
          load_halves(vs + j * SUB * 128, &tv, kv_full, S::V_HALF, j * SUB,
                      h, b);
      }
      return nsub;
    };
    int b = b0, h = h0, qt = qt0, c = 0;
    rows(0, b, h, qt);
    int nsub = keys(b, h);
    for (int n = 0; n < count; ++n) {
      int nb = b, nh = h, nqt = qt;
      next_unit(nb, nh, nqt, p.heads, p.nqt);
      const bool more = n + 1 < count;
      if (more) rows(n + 1, nb, nh, nqt);
      if constexpr (!VRES) {
        for (int j = 0; j < nsub; ++j, ++c) {
          const int s = c % V_STAGES;
          mbar_wait(&v_empty[s], ((c / V_STAGES) & 1) ^ 1);
          mbar_expect_tx(&v_full[s], 2 * SUB_BOX);
          load_halves(vs + s * 2 * SUB_BOX, &tv, &v_full[s], SUB_BOX,
                      j * SUB, h, b);
        }
      }
      if (more && nqt == 0) nsub = keys(nb, nh);
      b = nb;
      h = nh;
      qt = nqt;
    }
  } else {
    // ===== consumer warpgroups: 64 query rows each =====
    regs_alloc<232>();
    const int ct = threadIdx.x - 128;
    const int cw = ct / 128;                 // consumer warpgroup
    const int warp = (ct % 128) / 32, lane = ct % 32;
    const int t = lane & 3;                  // accumulator column pair
    const int qrow0 = cw * 64 + warp * 16;
    const int r0 = qrow0 + (lane >> 2);      // this thread's rows r0, r0 + 8
    if (cw == 1) pp_arrive(cw);              // warpgroup 0 goes first

    uint32_t qa[8][4], doa[8][4], da[2][4];
    float dq[64], sc[16], dp[16];
    // this thread's lse of a unit, loaded a unit ahead (+inf past Sq)
    float lse_next[2];
    auto load_lse = [&](int ub, int uh, int uq) {
#pragma unroll
      for (int rr = 0; rr < 2; ++rr) {
        const int row = uq * BM + r0 + 8 * rr;
        lse_next[rr] = row < p.sq
                           ? __ldg(p.lse + ub * p.lse_b + uh * p.lse_h + row)
                           : INFINITY;
      }
    };
    load_lse(b0, h0, qt0);
    int b = b0, h = h0, qt = qt0, c = 0, kv_valid = 0, nsub = 0;
    for (int n = 0; n < count; ++n, next_unit(b, h, qt, p.heads, p.nqt)) {
      // this thread's O: rows r0, r0 + 8, columns 32t .. 32t + 31, from
      // the L2 copy the producer prefetched a unit ahead (0 past Sq)
      uint4 ov[2][4];
#pragma unroll
      for (int rr = 0; rr < 2; ++rr) {
        const int row = qt * BM + r0 + 8 * rr;
        if (row < p.sq) {
          const uint4* src = reinterpret_cast<const uint4*>(
              p.o + b * p.o_b + h * p.o_h + (long long)row * p.o_s + 32 * t);
#pragma unroll
          for (int e = 0; e < 4; ++e) ov[rr][e] = __ldg(src + e);
        } else {
#pragma unroll
          for (int e = 0; e < 4; ++e) ov[rr][e] = make_uint4(0, 0, 0, 0);
        }
      }
      mbar_wait(q_full, n & 1);
      load_frags(qa, qs, qrow0, lane);
      release_buffer(q_empty, lane);
      mbar_wait(do_full, n & 1);
      load_frags(doa, dos, qrow0, lane);
      // di = rowsum(dO * O) in f32: dO from the landed tile, the four
      // threads of a row taking 32 columns each
      float di_r[2];
      const float lse_r[2] = {lse_next[0], lse_next[1]};
#pragma unroll
      for (int rr = 0; rr < 2; ++rr) {
        const int r = r0 + 8 * rr;
        float sum = 0.f;
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int ch = 4 * t + e;    // 16-byte chunk of the row, 0..15
          const uint4 raw = *reinterpret_cast<const uint4*>(
              dos + (ch / 8) * BOX_BYTES + r * 128 + (((ch % 8) ^ (r % 8)) * 16));
          const __nv_bfloat162* d2 =
              reinterpret_cast<const __nv_bfloat162*>(&raw);
          const __nv_bfloat162* o2 =
              reinterpret_cast<const __nv_bfloat162*>(&ov[rr][e]);
#pragma unroll
          for (int k = 0; k < 4; ++k) {
            const float2 x = __bfloat1622float2(d2[k]);
            const float2 y = __bfloat1622float2(o2[k]);
            sum = fmaf(x.x, y.x, sum);
            sum = fmaf(x.y, y.y, sum);
          }
        }
        sum += __shfl_xor_sync(0xffffffffu, sum, 1);
        sum += __shfl_xor_sync(0xffffffffu, sum, 2);
        di_r[rr] = sum;     // 0 past Sq: O reads as 0 there
      }
      release_buffer(do_empty, lane);
      if (t == 0) {
        const size_t off = ((size_t)b * p.heads + h) * p.sq_pad + qt * BM;
#pragma unroll
        for (int rr = 0; rr < 2; ++rr) {
          p.lse_p[off + r0 + 8 * rr] = lse_r[rr];
          p.di_p[off + r0 + 8 * rr] = di_r[rr];
        }
      }
      if (n + 1 < count) {
        int nb = b, nh = h, nq = qt;
        next_unit(nb, nh, nq, p.heads, p.nqt);
        load_lse(nb, nh, nq);
      }
      if (n == 0 || qt == 0) {
        // a new head's keys
        if (n > 0) release(kv_empty, lane);
        mbar_wait(kv_full, (b * p.heads + h - b0 * p.heads - h0) & 1);
        kv_valid = kv_valid_of(p.kv_len, b, p.skv);
        nsub = (kv_valid + SUB - 1) / SUB;
      }
#pragma unroll
      for (int e = 0; e < 64; ++e) dq[e] = 0.f;
      if (nsub > 0) {
        // sub-tile j's V: resident, or stage c of the ring
        auto v_at = [&](int j) -> const unsigned char* {
          if constexpr (VRES) {
            return vs + j * SUB * 128;
          } else {
            const int s = c % V_STAGES;
            mbar_wait(&v_full[s], (c / V_STAGES) & 1);
            return vs + s * 2 * SUB_BOX;
          }
        };
        auto v_done = [&]() {
          if constexpr (!VRES) {
            release(&v_empty[c % V_STAGES], lane);
            ++c;
          }
        };
        step<false, true>(dq, da, ks, sc, dp, qa, doa, ks, v_at(0),
                          S::K_HALF, S::V_HALF, cw);
        v_done();
#pragma unroll 1
        for (int j = 1; j < nsub; ++j) {
          make_ds<false>(sc, dp, da, lse_r, di_r, p.scale2, SUB, t);
          step<true, true>(dq, da, ks + (j - 1) * SUB * 128, sc, dp, qa, doa,
                           ks + j * SUB * 128, v_at(j), S::K_HALF, S::V_HALF,
                           cw);
          v_done();
        }
        make_ds_keys(sc, dp, da, lse_r, di_r, p.scale2,
                     kv_valid - (nsub - 1) * SUB, t);
        step<true, false>(dq, da, ks + (nsub - 1) * SUB * 128, sc, dp, qa,
                          doa, ks, vs, S::K_HALF, S::V_HALF, cw);
      }
      store_rows8(p.dq + b * p.dq_b + h * p.dq_h, p.dq_s, qt * BM, p.sq, dq,
                  p.sm_scale, r0, t);
    }
    // warpgroup 1's last arrive on warpgroup 0's barrier (its initial one
    // when the block ran no step) has its wait here
    if (cw == 0) pp_sync(cw);
  }
}

// ---- bwd_dkv_short -----------------------------------------------------------

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

// This thread's two key rows (r, r + 8 of the tile) of a 64 x 128 f32
// accumulator times `scale`: as bf16 rows of `out` (row stride rs; rows at
// or past n_rows skipped), or as f32 rows of a 128 x 128 partial `part`.
__device__ __forceinline__ void store_keys(const float (&acc)[64],
                                           __nv_bfloat16* out, long long rs,
                                           float* part, int r, int n_rows,
                                           int t, float scale) {
#pragma unroll
  for (int rr = 0; rr < 2; ++rr) {
    const int row = r + 8 * rr;
    if (part != nullptr) {
      float* prow = part + row * D + 2 * t;
#pragma unroll
      for (int nb = 0; nb < 16; ++nb)
        *reinterpret_cast<float2*>(prow + 8 * nb) =
            make_float2(acc[4 * nb + 2 * rr], acc[4 * nb + 2 * rr + 1]);
    } else if (row < n_rows) {
      __nv_bfloat16* orow = out + row * rs + 2 * t;
#pragma unroll
      for (int nb = 0; nb < 16; ++nb)
        *reinterpret_cast<__nv_bfloat162*>(orow + 8 * nb) =
            __floats2bfloat162_rn(acc[4 * nb + 2 * rr] * scale,
                                  acc[4 * nb + 2 * rr + 1] * scale);
    }
  }
}

// A shared-memory matrix descriptor (as sw128_desc) from a shared address.
__device__ __forceinline__ uint64_t sw128_desc_at(uint32_t addr, uint32_t lbo,
                                                  uint32_t sbo) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)(lbo >> 4) << 16) |
         ((uint64_t)(sbo >> 4) << 32) | (1ull << 62);
}

__device__ __forceinline__ float lds_f32(uint32_t addr) {
  float x;
  asm volatile("ld.shared.f32 %0, [%1];\n" : "=f"(x) : "r"(addr));
  return x;
}

// Whether key tile kt is a narrow tail: the last tile, with at most 64 keys.
// Its block runs both consumer warpgroups on those 64 keys, each over one
// of the two 64-row query tiles of every stage, and writes the two sums as
// the two halves of an f32 partial.
__device__ __forceinline__ bool tail_tile(const DkvParams& p, int kt) {
  return kt == p.nkt - 1 && p.skv - kt * BN <= 64;
}

__global__ void __launch_bounds__(THREADS, 1)
    bwd_dkv_short(const __grid_constant__ CUtensorMap tq,
                  const __grid_constant__ CUtensorMap tdo,
                  const __grid_constant__ CUtensorMap tk,
                  const __grid_constant__ CUtensorMap tv,
                  const DkvParams p) {
  unsigned char* smem = aligned_smem();
  uint64_t* kv_full = reinterpret_cast<uint64_t*>(smem + DKV_BAR);
  uint64_t* full = kv_full + 1;
  uint64_t* empty = full + STAGES;
  // (key tile, chunk, batch*head), the key tile fastest
  const int kt = blockIdx.x % p.nkt;
  const int chunk = (blockIdx.x / p.nkt) % p.chunks;
  const int bh = blockIdx.x / (p.nkt * p.chunks);
  const int b = bh / p.heads, h = bh % p.heads;
  // a stage holds one 64-row query tile, or two in a tail tile's block;
  // the chunk's stages
  const bool tail = tail_tile(p, kt);
  const int tiles = tail ? 2 : 1;
  const int nst = (p.nq64 + tiles - 1) / tiles;
  const int st0 = (int)((long long)nst * chunk / p.chunks);
  const int n = (int)((long long)nst * (chunk + 1) / p.chunks) - st0;

  if (threadIdx.x == 0) {
    mbar_init(kv_full, 1);
#pragma unroll
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], CONSUMER_WARPS);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x < 128) {
    // ===== producer: one thread issues every copy =====
    regs_dealloc<24>();
    if (threadIdx.x != 0) return;
    mbar_expect_tx(kv_full, 2 * TILE_BYTES);
    load_halves(smem, &tk, kv_full, BOX_BYTES, kt * BN, h, b);
    load_halves(smem + TILE_BYTES, &tv, kv_full, BOX_BYTES, kt * BN, h, b);
    const float* lse = p.lse_p + (size_t)bh * p.sq_pad;
    const float* di = p.di_p + (size_t)bh * p.sq_pad;
    for (int i = 0; i < n; ++i) {
      const int s = i % STAGES;
      const int j = (st0 + i) * tiles;   // its first 64-row query tile
      mbar_wait(&empty[s], ((i / STAGES) & 1) ^ 1);
      unsigned char* st = smem + DKV_RING + s * DKV_STAGE;
      mbar_expect_tx(&full[s], tiles * (2 * TILE64 + 2 * BQ * 4));
      for (int e = 0; e < tiles; ++e) {
        load_halves(st + e * TILE64, &tq, &full[s], BOX64, (j + e) * BQ, h,
                    b);
        load_halves(st + (2 + e) * TILE64, &tdo, &full[s], BOX64,
                    (j + e) * BQ, h, b);
      }
      bulk_load(st + 4 * TILE64, lse + j * BQ, tiles * BQ * 4, &full[s]);
      bulk_load(st + 4 * TILE64 + 2 * BQ * 4, di + j * BQ, tiles * BQ * 4,
                &full[s]);
    }
  } else {
    // ===== consumers: 64 keys each (a tail tile: the same 64 keys, the
    // stage's two query tiles) =====
    regs_alloc<240>();
    const int ct = threadIdx.x - 128;
    const int cw = ct / 128;
    const int warp = (ct % 128) / 32, lane = ct % 32;
    const int t = lane & 3;
    const int kr = (tail ? 0 : cw * 64) + warp * 16 + (lane >> 2);
    const int kv_valid = kv_valid_of(p.kv_len, b, p.skv);
    const bool valid0 = kt * BN + kr < kv_valid;
    const bool valid1 = kt * BN + kr + 8 < kv_valid;
    const uint32_t k_at = smem_u32(smem) + (tail ? 0 : cw * 64 * 128);
    // this warpgroup's query tile of a stage: its Q and dO, and (qoff / 64
    // bytes on) its lse and di
    const uint32_t qoff = tail ? cw * TILE64 : 0;
    static_assert(TILE64 / 64 == BQ * 4, "the lse offset is qoff / 64");
    if (cw == 1) pp_arrive(cw);              // warpgroup 0 goes first

    float dv[64], dk[64];
#pragma unroll
    for (int i = 0; i < 64; ++i) dv[i] = dk[i] = 0.f;
    mbar_wait(kv_full, 0);

    for (int i = 0; i < n; ++i) {
      const int s = i % STAGES;
      mbar_wait(&full[s], (i / STAGES) & 1);
      const uint32_t st = smem_u32(smem) + DKV_RING + s * DKV_STAGE;
      const uint32_t qs = st + qoff, dos = st + 2 * TILE64 + qoff;
      const uint32_t lse = st + 4 * TILE64 + qoff / 64;
      const uint32_t di = lse + 2 * BQ * 4;
      // K's and V's descriptors are made anew each stage: hoisted out of
      // the loop, their 32 registers would stay live through it
      uint32_t ks = k_at;
      asm volatile("" : "+r"(ks));
      const uint32_t vs = ks + TILE_BYTES;

      // S^T = K Q^T and dP^T = V dO^T: 8 k-steps of 16 dims, 4 per box
      float sc[32], dpt[32];
      pp_sync(cw);
      wg_fence();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        const uint32_t oa = (kk / 4) * BOX_BYTES + (kk % 4) * 32;
        const uint32_t ob = (kk / 4) * BOX64 + (kk % 4) * 32;
        wgmma_ss_n64(sc, sw128_desc_at(ks + oa, 16, 1024),
                     sw128_desc_at(qs + ob, 16, 1024), kk > 0);
      }
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        const uint32_t oa = (kk / 4) * BOX_BYTES + (kk % 4) * 32;
        const uint32_t ob = (kk / 4) * BOX64 + (kk % 4) * 32;
        wgmma_ss_n64(dpt, sw128_desc_at(vs + oa, 16, 1024),
                     sw128_desc_at(dos + ob, 16, 1024), kk > 0);
      }
      wg_commit();
      pp_arrive(cw);
      wg_wait<0>();
      reg_fence(sc);
      reg_fence(dpt);

      // P and dS: element i2 is key row kr + 8 * ((i2 >> 1) & 1), query
      // column c = 8 * (i2 >> 2) + 2t + (i2 & 1) of the tile; keys at or
      // past kv_valid get 0 by a select
      // (each pair packed as soon as it is made, so the accumulators die
      // one by one)
      uint32_t pa[4][4], dsa[4][4];
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int i2 = 8 * kk + 2 * e;
          const bool ok = (e & 1) ? valid1 : valid0;
          const uint32_t c4 = 4 * (8 * (i2 >> 2) + 2 * t);
          float pv[2], ds[2];
#pragma unroll
          for (int x = 0; x < 2; ++x) {
            const float pe = ex2(fmaf(sc[i2 + x], p.scale2,
                                      -lds_f32(lse + c4 + 4 * x)));
            const float de = pe * (dpt[i2 + x] - lds_f32(di + c4 + 4 * x));
            pv[x] = ok ? pe : 0.f;
            ds[x] = ok ? de : 0.f;
          }
          pa[kk][e] = pack_bf16(pv[0], pv[1]);
          dsa[kk][e] = pack_bf16(ds[0], ds[1]);
        }

      // dV += P^T dO, dK += dS^T Q: k-step kk is queries 16kk..16kk+15,
      // 2 KB into each 64-column box; the boxes are BOX64 apart
      pp_sync(cw);
      reg_fence(dv);
      reg_fence(dk);
      reg_fence(pa);
      reg_fence(dsa);
      wg_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        wgmma_rs(dv, pa[kk], sw128_desc_at(dos + kk * 16 * 128, BOX64, 1024));
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        wgmma_rs(dk, dsa[kk], sw128_desc_at(qs + kk * 16 * 128, BOX64, 1024));
      wg_commit();
      pp_arrive(cw);
      wg_wait<0>();
      reg_fence(dv);
      reg_fence(dk);
      reg_fence(pa);
      reg_fence(dsa);
      release(&empty[s], lane);
    }
    // warpgroup 1's last arrive on warpgroup 0's barrier (its initial one
    // when the block ran no step) has its wait here
    if (cw == 0) pp_sync(cw);

    // (b, h, chunk) again from the block index: nothing of it stays live
    // through the loop; the rows of this warpgroup's accumulator
    const int ob = blockIdx.x / (p.nkt * p.chunks);
    const int r0 = cw * 64 + warp * 16 + (lane >> 2);
    const int n_rows = min(BN, p.skv - kt * BN);
    if (p.chunks == 1 && !tail) {
      const int b1 = ob / p.heads, h1 = ob % p.heads;
      store_keys(dk, p.dk + b1 * p.dk_b + h1 * p.dk_h + (long long)kt * BN * p.dk_s,
                 p.dk_s, nullptr, r0, n_rows, t, p.sm_scale);
      store_keys(dv, p.dv + b1 * p.dv_b + h1 * p.dv_h + (long long)kt * BN * p.dv_s,
                 p.dv_s, nullptr, r0, n_rows, t, 1.f);
    } else {
      float* part = p.part + ((size_t)(ob * p.nkt + kt) * p.chunks +
                              (blockIdx.x / p.nkt) % p.chunks) * (2 * BN * D);
      store_keys(dk, nullptr, 0, part, r0, n_rows, t, 1.f);
      store_keys(dv, nullptr, 0, part + BN * D, r0, n_rows, t, 1.f);
    }
  }
}

// The chunks' partials of one (batch*head, key tile) summed in chunk order
// (in a tail tile each chunk's two halves, rows r and r + 64, in turn), dK
// times sm_scale, as bf16 rows of dk and dv: 256 threads, 8 columns of one
// row each per pass. A tile written whole by one block is skipped.
__global__ void __launch_bounds__(256)
    bwd_dkv_reduce(const DkvParams p) {
  const int seg = blockIdx.x;
  const int bh = seg / p.nkt, kt = seg % p.nkt;
  const bool tail = tail_tile(p, kt);
  if (p.chunks == 1 && !tail) return;
  const int b = bh / p.heads, h = bh % p.heads;
  const int n_rows = min(BN, p.skv - kt * BN);
  const int halves = tail ? 2 : 1;
  const size_t stride = 2 * BN * D;    // floats of one chunk's partial
  const float* part = p.part + (size_t)seg * p.chunks * stride;
  for (int x = threadIdx.x; x < 2 * n_rows * (D / 8); x += blockDim.x) {
    const int tensor = x / (n_rows * (D / 8));
    const int row = (x / (D / 8)) % n_rows, col = (x % (D / 8)) * 8;
    const float4* src = reinterpret_cast<const float4*>(
        part + tensor * BN * D + row * D + col);
    float4 lo = make_float4(0.f, 0.f, 0.f, 0.f), hi = lo;
    for (int c = 0; c < p.chunks; ++c) {
      for (int e = 0; e < halves; ++e) {
        const size_t at = (c * stride + e * 64 * D) / 4;
        const float4 a = src[at], f = src[at + 1];
        lo.x += a.x; lo.y += a.y; lo.z += a.z; lo.w += a.w;
        hi.x += f.x; hi.y += f.y; hi.z += f.z; hi.w += f.w;
      }
    }
    const float scale = tensor == 0 ? p.sm_scale : 1.f;
    const long long off =
        tensor == 0 ? b * p.dk_b + h * p.dk_h + (kt * BN + row) * p.dk_s
                    : b * p.dv_b + h * p.dv_h + (kt * BN + row) * p.dv_s;
    __nv_bfloat16* out = (tensor == 0 ? p.dk : p.dv) + off + col;
    *reinterpret_cast<uint4*>(out) = make_uint4(
        pack_bf16(lo.x * scale, lo.y * scale),
        pack_bf16(lo.z * scale, lo.w * scale),
        pack_bf16(hi.x * scale, hi.y * scale),
        pack_bf16(hi.z * scale, hi.w * scale));
  }
}

// ---- host side -----------------------------------------------------------------

// A 4-D map over bf16 (D, rows, heads, batch) with the caller's element
// strides st = {row, head, sample}: box_rows x 64-column boxes, 128-byte
// swizzle; rows past `rows` read as zeros.
bool make_map4(CUtensorMap* map, const void* base, int rows, int heads,
               int batch, const long long* st, int box_rows) {
  const EncodeTiledFn fn = encode_tiled();
  if (fn == nullptr) return false;
  const cuuint64_t dims[4] = {(cuuint64_t)D, (cuuint64_t)rows,
                              (cuuint64_t)heads, (cuuint64_t)batch};
  const cuuint64_t strides[3] = {(cuuint64_t)st[0] * 2,
                                 (cuuint64_t)st[1] * 2,
                                 (cuuint64_t)st[2] * 2};
  const cuuint32_t box[4] = {BOX_COLS, (cuuint32_t)box_rows, 1, 1};
  const cuuint32_t elem[4] = {1, 1, 1, 1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(base),
            dims, strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
            CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <class Kernel, class... Args>
int launch(Kernel kernel, size_t smem, int grid, int threads,
           cudaStream_t stream, const Args&... args) {
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  kernel<<<grid, threads, smem, stream>>>(args...);
  return (int)cudaGetLastError();
}

}  // namespace

// q, o, dout [B, H, Sq, 128], k and v [B, H, Skv, 128] in bf16, and the
// gradients dq, dk, dv of the same shapes, each addressed through
// `strides`: 26 element strides, (row, head, sample) of q, k, v, o, dout,
// dq, dk and dv in turn (the last dims contiguous; for the inputs multiples
// of 8, the pointers 16-byte aligned), then lse's (sample, head) strides
// (its rows contiguous). lse [B, H, Sq] f32, the forward's base-2 log-sum-
// exp; kv_len [B] int32 or null. ws: f32 [2, B*H, ceil(Sq / 128) * 128]
// (lse and di for the dK|dV kernel); part: f32 [B*H*ceil(Skv/128)*chunks,
// 2, 128, 128] when chunks > 1 or the last key tile holds at most 64 keys,
// else unused. device: the tensors' CUDA device; sms: its SM count, the dq
// kernel's grid cap.
extern "C" int dense_attn_bwd_short(
    const void* q, const void* k, const void* v, const void* o,
    const void* dout, const void* lse, const void* kv_len, void* dq,
    void* dk, void* dv, void* ws, void* part, int batch, int heads, int sq,
    int skv, const long long* strides, float sm_scale, int device, int sms,
    int chunks, void* stream) {
  if (batch < 1 || heads < 1 || sq < 1 || skv < 1 || skv > MAX_KEYS ||
      sms < 1 || chunks < 1)
    return (int)cudaErrorInvalidValue;
  // the caller's device, current in this thread (autograd runs a backward
  // on a thread of its own, where no context need be current yet: the
  // tensor maps' encoding needs one)
  const cudaError_t dev_err = cudaSetDevice(device);
  if (dev_err != cudaSuccess) return (int)dev_err;
  const long long* s_q = strides;
  const long long* s_k = strides + 3;
  const long long* s_v = strides + 6;
  const long long* s_o = strides + 9;
  const long long* s_do = strides + 12;
  const long long* s_dq = strides + 15;
  const long long* s_dk = strides + 18;
  const long long* s_dv = strides + 21;
  const long long* s_lse = strides + 24;
  const bool vres = skv <= RES_KEYS;
  CUtensorMap tq, tdo, to, tk32, tv32, tq64, tdo64, tk, tv;
  // a map that cannot be encoded returns MAP_ERROR + its index
  CUtensorMap* maps[9] = {&tq, &tdo, &to, &tk32, &tv32, &tq64, &tdo64, &tk,
                          &tv};
  const void* bases[9] = {q, dout, o, k, v, q, dout, k, v};
  const long long* map_strides[9] = {s_q, s_do, s_o, s_k, s_v, s_q, s_do,
                                     s_k, s_v};
  const int map_rows[9] = {sq, sq, sq, skv, skv, sq, sq, skv, skv};
  const int map_box[9] = {BM, BM, BM, SUB, SUB, BQ, BQ, BN, BN};
  for (int i = 0; i < 9; ++i)
    if (!make_map4(maps[i], bases[i], map_rows[i], heads, batch,
                   map_strides[i], map_box[i]))
      return MAP_ERROR + i;
  const int nqt = (sq + BM - 1) / BM;
  const int sq_pad = nqt * BM;
  float* lse_p = static_cast<float*>(ws);
  float* di_p = lse_p + (size_t)batch * heads * sq_pad;

  DqParams a{};
  a.o = static_cast<const __nv_bfloat16*>(o);
  a.o_s = s_o[0];
  a.o_h = s_o[1];
  a.o_b = s_o[2];
  a.dq = static_cast<__nv_bfloat16*>(dq);
  a.dq_s = s_dq[0];
  a.dq_h = s_dq[1];
  a.dq_b = s_dq[2];
  a.lse = static_cast<const float*>(lse);
  a.lse_b = s_lse[0];
  a.lse_h = s_lse[1];
  a.lse_p = lse_p;
  a.di_p = di_p;
  a.kv_len = static_cast<const int*>(kv_len);
  a.units = (long long)batch * heads * nqt;
  a.heads = heads;
  a.sq = sq;
  a.skv = skv;
  a.nqt = nqt;
  a.sq_pad = sq_pad;
  a.scale2 = sm_scale * LOG2E;
  a.sm_scale = sm_scale;

  DkvParams c{};
  c.dk = static_cast<__nv_bfloat16*>(dk);
  c.dv = static_cast<__nv_bfloat16*>(dv);
  c.dk_s = s_dk[0];
  c.dk_h = s_dk[1];
  c.dk_b = s_dk[2];
  c.dv_s = s_dv[0];
  c.dv_h = s_dv[1];
  c.dv_b = s_dv[2];
  c.lse_p = lse_p;
  c.di_p = di_p;
  c.part = static_cast<float*>(part);
  c.kv_len = static_cast<const int*>(kv_len);
  c.heads = heads;
  c.skv = skv;
  c.nkt = (skv + BN - 1) / BN;
  c.nq64 = (sq + BQ - 1) / BQ;
  c.sq_pad = sq_pad;
  c.chunks = chunks < c.nq64 ? chunks : c.nq64;
  c.scale2 = sm_scale * LOG2E;
  c.sm_scale = sm_scale;

  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int dq_grid = (int)(a.units < sms ? a.units : sms);
  int err = vres ? launch(bwd_dq_short<true>, DQ_SMEM, dq_grid, THREADS, st,
                          tq, tdo, to, tk32, tv32, a)
                 : launch(bwd_dq_short<false>, DQ_SMEM, dq_grid, THREADS, st,
                          tq, tdo, to, tk32, tv32, a);
  if (err != 0) return err;
  const int segs = batch * heads * c.nkt;
  err = launch(bwd_dkv_short, DKV_SMEM, segs * c.chunks, THREADS, st, tq64,
               tdo64, tk, tv, c);
  const bool narrow_tail = skv - (c.nkt - 1) * BN <= 64;
  if (err != 0 || (c.chunks == 1 && !narrow_tail)) return err;
  return launch(bwd_dkv_reduce, 0, segs, 256, st, c);
}

extern "C" const char* dense_attn_bwd_short_error_string(int err) {
  static const char* const names[9] = {
      "the tensor map of q (128-row boxes) cannot be encoded",
      "the tensor map of dout (128-row boxes) cannot be encoded",
      "the tensor map of o cannot be encoded",
      "the tensor map of k (32-row boxes) cannot be encoded",
      "the tensor map of v (32-row boxes) cannot be encoded",
      "the tensor map of q (64-row boxes) cannot be encoded",
      "the tensor map of dout (64-row boxes) cannot be encoded",
      "the tensor map of k (128-row boxes) cannot be encoded",
      "the tensor map of v (128-row boxes) cannot be encoded"};
  if (err >= MAP_ERROR && err < MAP_ERROR + 9) return names[err - MAP_ERROR];
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

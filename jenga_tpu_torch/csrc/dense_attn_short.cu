// Dense non-causal attention over short key sequences (Skv <= 512) with
// per-sample key lengths, for Hopper (sm_90a): the short-key route of
// kernel D.
//
// Replaces, with dense_attn.cu (the route for Skv > 512), the stock Pallas
// TPU flash-attention kernel that jenga_tpu/ops/flash_attention.py:73
// (`dense_attention`, `pl_flash` :92) calls on the TPU. The model reaches
// this route for Wan's cross-attention: the 512 padded text keys of every
// Wan model (CFG in one batch of 2) and Wan2.1-I2V-14B's 257 CLIP image
// keys, each over 32,760 query rows at 832x480x81f.
//
// Math (per query row i of one (batch, head)), as dense_attn.cu:
//   s_ij = (q_i . k_j) * sm_scale * log2(e),  j < kv_valid = min(kv_len[b], Skv)
//   o_i  = sum_j exp2(s_ij - m_i) v_j / sum_j exp2(s_ij - m_i)
// with m_i the exact running row max (online softmax over the key tiles,
// never a fixed max); a row with no valid key stores zeros and lse = +inf.
// Where `lse` is not null each stored row's base-2 log-sum-exp m_i +
// log2(l_i) goes to lse[bh, ceil(Sq / 128) * 128], the layout
// dense_attn_bwd.cu reads.
//
// What bounds it on the card: per 128-row query tile the tensor cores do
// 4 x 128 x Skv' x 128 FLOP (Skv' the key columns computed) against the
// tile's own 32 KB of Q read and 32 KB of O written; K|V is at most 256 KB
// per head. At Wan-14B's image cross-attention (2 x 40 x 32,768 rows, 257
// keys) the bytes bound it: 1.34 GB of Q and O, 0.40 ms at 3.35 TB/s. At
// 512 keys the operations do (0.208 ms at Wan 1.3B's 2 x 12 heads, 0.695
// ms at 14B's 2 x 40).
//
// What held the mainloop instance (one thread block per 128-row query
// block, K|V streamed per block) back at short keys: each block did 3-4
// key tiles, so its Q load, pipeline fill and O store had nothing to hide
// behind; each of a head's 256 query blocks read that head's K|V again from
// L2; a 257th key cost a whole 128-key tile of both products; and the
// wrapper copied q, k, v out of the model's [B, S, H, D] layout and the
// model copied the output back.
//
// Design, on the primitives of attn_sm90.cuh (not its mainloop), from the
// probe P4 (cross_attn_resident.cu):
//   * Persistent blocks, head-major: one thread block per SM, each walking
//     a contiguous run of (batch*head, 128-row query tile) units in
//     head-major order, so it loads a head's keys once per head it touches
//     (at Wan-14B ~155 tiles and at most 3 heads per block).
//   * Resident keys: K of all the head's keys stays in shared memory,
//     loaded under one barrier per head. V stays resident too when Skv <=
//     384 (K|V 192 KB beside the 32 KB Q buffer); over 384 keys V streams
//     through a 2-stage ring per query tile, as in P4.
//   * A narrow last key tile: P V of Skv's last tile runs over its 16-key
//     chunks only, rounded up to 1, 2, 4 or 8 (a template parameter: 257
//     keys cost 272 columns of P V). S and the softmax of that tile run at
//     full width, the keys at or past kv_valid = min(kv_len[b], Skv) left
//     out of the max and given P = 0 (a select, so no -inf reaches the
//     arithmetic); the TMA zero-fills K and V rows past Skv.
//   * Q and O overlap the math: the consumers copy a tile's Q into
//     registers (ldmatrix) as it lands and release the buffer, so the next
//     tile's Q loads during this one; the last P V of a tile is issued
//     with S of the next tile's first key tile (same head), so a tile
//     boundary costs no step of its own (at a head switch or a run's end
//     that S is a dead copy, so every last step has one form); O leaves
//     from registers, threads t and t ^ 1 swapping one pair per two
//     8-column blocks so each store is 8 contiguous bytes. Two
//     consumer warpgroups of 64 rows take turns on named barriers
//     (ping-pong): one issues its products while the other runs its
//     softmax. Each step's products are chosen whole by a uniform branch,
//     none conditional inside a step (ptxas serializes every wgmma of a
//     kernel that has one on a divergent path).
//   * The caller's layout: Q, K and V are read through 4-D tensor maps
//     over (D, rows, heads, batch) with the caller's strides (last dim
//     contiguous, the others multiples of 8 elements), and O is written
//     with its own strides, so [B, H, S, D] and [B, S, H, D] are taken
//     alike, with no copy. Rows past Sq or Skv are zero-filled within
//     their head, never read from the next one.
//   * sm_scale < 0 is taken by negating Q's bf16 fragments in registers,
//     so the max is always taken over the raw logits and the scale folds
//     into one FMA per element.
//   * The producer warpgroup drops to 24 registers and the consumers rise
//     to 240: at 40/232 (P4's split) the consumers spilled.
// Tried on the H100 and dropped as slower: S of the narrow tile as
// m64n16k16 chunks and a softmax over its chunks alone (ptxas serialized
// the kernel's wgmmas for lack of registers, C7511); wgmmas of a variable
// count inside one step (serialized, C7520); O stored as the accumulator
// lays it out, 4 bytes a thread, half a 32-byte sector a store.
// tools/short_kernel_probe.py times the kernel beside variants without
// its stores, its exps or its products.
//
// Shared memory:
//   Q, one 128 x 128 tile (its landing buffer) ........  32,768 B
//   K|V, six 128 x 128 tiles: K 3 + V 3 (Skv <= 384)
//     or K 4 + a 2-stage V ring (Skv <= 512) ........ 196,608 B
//   8 mbarriers (K|V full/empty, Q full/empty, ring) ..      64 B
//   slack to align to the 1024-byte swizzle atom .....   1,024 B
//   total ............................................ 230,464 B
//
// Plain C interface (loaded with ctypes); the launch goes on the caller's
// stream and the function returns cudaGetLastError(), or
// cudaErrorInvalidValue for a shape it does not take or a tensor map that
// cannot be encoded.

#include "attn_sm90.cuh"

namespace {

using namespace sm90;

constexpr int MAX_KEYS = 512;
constexpr int CHUNK = 16;                 // keys of one P V k-step
constexpr int TILE_CHUNKS = BN / CHUNK;
constexpr int KV_TILES = 6;               // K|V tiles of shared memory
constexpr uint32_t Q_OFF = 0;
constexpr uint32_t K_OFF = TILE_BYTES;
constexpr uint32_t SBAR_OFF = K_OFF + KV_TILES * TILE_BYTES;
constexpr size_t SSMEM_BYTES = SBAR_OFF + 64 + 1024;
static_assert(SBAR_OFF == 229376 && SSMEM_BYTES == 230464,
              "the layout written above");
static_assert(SSMEM_BYTES <= 232448, "227 KB per block on sm_90");

// The K|V tiles with V resident (VRES, Skv <= 384) or streamed.
template <bool VRES>
struct Slots {
  static constexpr int K_TILES = VRES ? 3 : MAX_KEYS / BN;
  static constexpr int V_SLOTS = KV_TILES - K_TILES;
  static constexpr uint32_t V_OFF = K_OFF + K_TILES * TILE_BYTES;
  static_assert(VRES ? V_SLOTS == K_TILES : V_SLOTS == STAGES,
                "V resident, or a 2-stage ring");
};

struct ShortParams {
  __nv_bfloat16* o;
  long long o_s, o_h, o_b;  // O's element strides: row, head, sample
  const int* kv_len;        // [B] or null
  float* lse;               // [B*H, nqt * BM] base-2 log-sum-exp, or null
  long long units;          // B * H * nqt
  int heads, sq, skv, nqt;
  int nkt;                  // ceil(Skv / 128) key tiles
  float scale2;             // |sm_scale| * log2(e)
  int negate;               // sm_scale < 0: Q negated in registers
};

// The keys of one sample: nk key tiles, the last with lv valid keys; its
// width in 16-key chunks c is the tail's CL when it is Skv's last tile,
// else a whole tile (kv_len cut it short). nk = 0 when kv_len[b] <= 0.
struct Keys {
  int nk, lv, c;
};

template <int CL>
__device__ __forceinline__ Keys sample_keys(const ShortParams& p, int b) {
  int kv = p.skv;
  if (p.kv_len != nullptr) kv = max(0, min(p.kv_len[b], p.skv));
  Keys ks;
  ks.nk = (kv + BN - 1) / BN;
  ks.lv = kv - (ks.nk - 1) * BN;
  ks.c = ks.nk == p.nkt ? CL : TILE_CHUNKS;
  return ks;
}

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

// One 128 x 128 tile: two 64-column boxes.
__device__ __forceinline__ void load_tile(unsigned char* dst,
                                          const CUtensorMap* map,
                                          uint64_t* bar, int row, int h,
                                          int b) {
  tma_load4(dst, map, bar, 0, row, h, b);
  tma_load4(dst + BOX_BYTES, map, bar, BOX_COLS, row, h, b);
}

// This warp's 16 query rows of the Q tile as wgmma A-fragments, one
// ldmatrix.x4 per k-step from the swizzled tile (as P4), negated with
// `negate` (bf16 sign bits).
__device__ __forceinline__ void load_q(uint32_t (&qa)[8][4],
                                       const unsigned char* qs, int row0,
                                       int lane, int negate) {
  const int r = row0 + (lane & 7) + 8 * ((lane >> 3) & 1);
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    const int c = 2 * kk + (lane >> 4);
    const uint32_t addr = smem_u32(qs + (c / 8) * BOX_BYTES + r * 128 +
                                   (((c % 8) ^ (r % 8)) * 16));
    asm volatile(
        "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
        : "=r"(qa[kk][0]), "=r"(qa[kk][1]), "=r"(qa[kk][2]), "=r"(qa[kk][3])
        : "r"(addr)
        : "memory");
  }
  if (negate) {
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
#pragma unroll
      for (int e = 0; e < 4; ++e) qa[kk][e] ^= 0x80008000u;
  }
}

// Copy this warp's rows of the landed Q tile into registers and hand the
// buffer back. The proxy fence orders the ldmatrix reads (generic proxy)
// before the producer's TMA rewrite of the buffer (async proxy), as the
// PTX memory model asks: with V resident the producer issues the next Q
// the moment the buffer is free. It cost no measurable time on the H100.
__device__ __forceinline__ void take_q(uint32_t (&qa)[8][4],
                                       const unsigned char* qs,
                                       uint64_t* q_full, uint64_t* q_empty,
                                       int n, int row0, int lane,
                                       int negate) {
  mbar_wait(q_full, n & 1);
  load_q(qa, qs, row0, lane, negate);
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  __syncwarp();
  if (lane == 0) mbar_arrive(q_empty);
}

// S = Q K^T for this warpgroup's 64 rows and one resident key tile: 8
// k-steps of 16 dims, Q's A-fragments from registers, K from shared memory
// (K-major, 4 k-steps in each 64-column box). Issued, not committed.
__device__ __forceinline__ void issue_s(float (&sc)[64],
                                        const uint32_t (&qa)[8][4],
                                        const unsigned char* kt) {
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk)
    wgmma_rs_kmajor(
        sc, qa[kk],
        sw128_desc(kt + (kk / 4) * BOX_BYTES + (kk % 4) * 32, 16, 1024),
        kk > 0);
}

// O += P V over the first C 16-key k-steps of a V tile (keys 16kk..16kk+15
// are 2 KB into each box; the two boxes, d 0-63 and 64-127, one lbo
// apart). Issued, not committed.
template <int C>
__device__ __forceinline__ void issue_pv(float (&o)[64],
                                         const uint32_t (&pa)[8][4],
                                         const unsigned char* vt) {
#pragma unroll
  for (int kk = 0; kk < C; ++kk)
    wgmma_rs(o, pa[kk], sw128_desc(vt + kk * 16 * 128, BOX_BYTES, 1024));
}

// Named barriers 1 and 2 order the two consumer warpgroups' products
// (ping-pong): a warpgroup waits on its own before issuing and arrives on
// the other's after, so one issues while the other runs its softmax.
__device__ __forceinline__ void pp_sync(int cw) {
  asm volatile("bar.sync %0, 256;\n" ::"r"(1 + cw) : "memory");
}
__device__ __forceinline__ void pp_arrive(int cw) {
  asm volatile("bar.arrive %0, 256;\n" ::"r"(2 - cw) : "memory");
}

// reg_fence over the first N A-fragment k-steps: what a step's P V reads,
// and no stale k-step of a narrow tile.
template <int N>
__device__ __forceinline__ void fence_first(uint32_t (&r)[8][4]) {
#pragma unroll
  for (int i = 0; i < N; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) asm volatile("" : "+r"(r[i][e])::"memory");
}

// One ping-pong step: O += P V over PC k-steps of vt (PC = 0: none) and S
// of key tile kt, issued together and waited on. Every product of a step
// is unconditional: a step is chosen whole by a uniform branch, so no
// wgmma sits on a divergent path.
template <int PC>
__device__ __forceinline__ void step(float (&o)[64], uint32_t (&pa)[8][4],
                                     const unsigned char* vt,
                                     float (&sc)[64], uint32_t (&qa)[8][4],
                                     const unsigned char* kt, int cw) {
  pp_sync(cw);
  if constexpr (PC > 0) {
    reg_fence(o);
    fence_first<PC>(pa);
  }
  reg_fence(qa);
  wg_fence();
  if constexpr (PC > 0) issue_pv<PC>(o, pa, vt);
  issue_s(sc, qa, kt);
  wg_commit();
  pp_arrive(cw);
  wg_wait<0>();
  if constexpr (PC > 0) {
    reg_fence(o);
    fence_first<PC>(pa);
  }
  reg_fence(sc);
  reg_fence(qa);
}

// The online softmax of one key tile on the S accumulator: element i of sc
// is row r0 + 8 ((i >> 1) & 1), key 8 (i >> 2) + 2t + (i & 1). MASKED (a
// last tile with lim < 128 valid keys) leaves keys at or past lim out of
// the max and gives them P = 0. Leaves P as bf16 A-fragments in pa (k-step
// kk = keys 16kk..16kk+15 = accumulator n8-blocks 2kk and 2kk + 1) and
// rescales O and the row sums l to the new max (on the first tile m =
// -inf: O and l are 0 and the rescale is by 0). Every tile holds a valid
// key of every row, so m is finite after the first tile.
template <bool MASKED>
__device__ __forceinline__ void softmax_tile(float (&sc)[64],
                                             uint32_t (&pa)[8][4],
                                             float (&o)[64],
                                             float (&m_row)[2],
                                             float (&l_row)[2], float scale2,
                                             int lim, int t) {
  float mx[2] = {-INFINITY, -INFINITY}, alpha[2], rs[2] = {0.f, 0.f};
#pragma unroll
  for (int i = 0; i < 64; ++i) {
    const bool ok = !MASKED || 8 * (i >> 2) + 2 * t + (i & 1) < lim;
    mx[(i >> 1) & 1] = fmaxf(mx[(i >> 1) & 1], ok ? sc[i] : -INFINITY);
  }
#pragma unroll
  for (int rr = 0; rr < 2; ++rr) {
    mx[rr] = fmaxf(mx[rr], __shfl_xor_sync(0xffffffffu, mx[rr], 1));
    mx[rr] = fmaxf(mx[rr], __shfl_xor_sync(0xffffffffu, mx[rr], 2));
    const float m_new = fmaxf(m_row[rr], mx[rr] * scale2);
    alpha[rr] = ex2(m_row[rr] - m_new);  // ex2(-inf) = 0
    m_row[rr] = m_new;
  }
#pragma unroll
  for (int i = 0; i < 64; ++i) {
    const float x = ex2(fmaf(sc[i], scale2, -m_row[(i >> 1) & 1]));
    sc[i] = !MASKED || 8 * (i >> 2) + 2 * t + (i & 1) < lim ? x : 0.f;
    rs[(i >> 1) & 1] += sc[i];
  }
#pragma unroll
  for (int i = 0; i < 64; ++i) o[i] *= alpha[(i >> 1) & 1];
#pragma unroll
  for (int rr = 0; rr < 2; ++rr) l_row[rr] = l_row[rr] * alpha[rr] + rs[rr];
#pragma unroll
  for (int kk = 0; kk < 8; ++kk)
#pragma unroll
    for (int e = 0; e < 4; ++e)
      pa[kk][e] = pack_bf16(sc[8 * kk + 2 * e], sc[8 * kk + 2 * e + 1]);
}

// softmax_tile of a tile with lv valid keys (masked when lv < 128).
__device__ __forceinline__ void softmax_keys(float (&sc)[64],
                                             uint32_t (&pa)[8][4],
                                             float (&o)[64],
                                             float (&m_row)[2],
                                             float (&l_row)[2], float scale2,
                                             int lv, int t) {
  if (lv >= BN)
    softmax_tile<false>(sc, pa, o, m_row, l_row, scale2, BN, t);
  else
    softmax_tile<true>(sc, pa, o, m_row, l_row, scale2, lv, t);
}

__device__ __forceinline__ void release(uint64_t* bar, int lane) {
  __syncwarp();
  if (lane == 0) mbar_arrive(bar);
}

// Normalise and store this thread's two rows of query tile qt of (b, h)
// (rows >= Sq skipped), with the statistics where p.lse is not null; an
// empty sample (no valid key) stores zeros and lse = +inf. Threads t and
// t ^ 1 swap one packed pair per two 8-column blocks (one shuffle), so
// each writes 8 contiguous bytes and a warp's store covers whole 32-byte
// sectors: the accumulator layout alone gives 4-byte stores, half a sector
// each.
__device__ __forceinline__ void store_rows(const ShortParams& p, int b, int h,
                                           int qt, const float (&o)[64],
                                           const float (&l_row)[2],
                                           const float (&m_row)[2], int r0,
                                           int t, bool empty) {
  __nv_bfloat16* base = p.o + b * p.o_b + h * p.o_h;
  float* lse = p.lse == nullptr
                   ? nullptr
                   : p.lse + ((size_t)b * p.heads + h) * p.nqt * BM;
  const bool odd = t & 1;
#pragma unroll
  for (int rr = 0; rr < 2; ++rr) {
    float l = l_row[rr];
    l += __shfl_xor_sync(0xffffffffu, l, 1);
    l += __shfl_xor_sync(0xffffffffu, l, 2);
    const int row = qt * BM + r0 + 8 * rr;
    const bool keep = row < p.sq;
    const float inv = 1.f / l;
    if (keep && lse != nullptr && t == 0)
      lse[row] = empty ? INFINITY : m_row[rr] + log2f(l);
    __nv_bfloat16* orow = base + row * p.o_s;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      // blocks 2j and 2j + 1 (columns 16j .. 16j + 15): t keeps its pair
      // of the block it writes and hands t ^ 1 its pair of the other
      const int ev = 4 * (2 * j) + 2 * rr, od = 4 * (2 * j + 1) + 2 * rr;
      const uint32_t pe =
          empty ? 0u : pack_bf16(o[ev] * inv, o[ev + 1] * inv);
      const uint32_t po =
          empty ? 0u : pack_bf16(o[od] * inv, o[od + 1] * inv);
      const uint32_t got =
          __shfl_xor_sync(0xffffffffu, odd ? pe : po, 1);
      if (keep)
        *reinterpret_cast<uint2*>(orow + 16 * j + 2 * t + (odd ? 6 : 0)) =
            odd ? make_uint2(got, po) : make_uint2(pe, got);
    }
  }
}

// Step (h, qt) on to the next unit of the head-major walk.
__device__ __forceinline__ void next_unit(int& b, int& h, int& qt,
                                          const ShortParams& p) {
  if (++qt == p.nqt) {
    qt = 0;
    if (++h == p.heads) {
      h = 0;
      ++b;
    }
  }
}

// VRES: V resident (Skv <= 384). CL: the 16-key chunks of Skv's last key
// tile, rounded up to 1, 2, 4 or 8.
template <bool VRES, int CL>
__global__ void __launch_bounds__(THREADS, 1)
    dense_kernel_short(const __grid_constant__ CUtensorMap tq,
                       const __grid_constant__ CUtensorMap tk,
                       const __grid_constant__ CUtensorMap tv,
                       const ShortParams p) {
  using S = Slots<VRES>;
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  unsigned char* smem =
      smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  unsigned char* qs = smem + Q_OFF;
  unsigned char* ks = smem + K_OFF;
  unsigned char* vs = smem + S::V_OFF;
  uint64_t* kv_full = reinterpret_cast<uint64_t*>(smem + SBAR_OFF);
  uint64_t* kv_empty = kv_full + 1;
  uint64_t* q_full = kv_full + 2;
  uint64_t* q_empty = kv_full + 3;
  uint64_t* full = kv_full + 4;     // [STAGES] the V ring (V streamed)
  uint64_t* empty = full + STAGES;  // [STAGES]

  // this block's run of (batch, head, query tile) units, head-major:
  // `count` units from (b0, h0, qt0)
  const long long u0 = p.units * blockIdx.x / gridDim.x;
  const int count = (int)(p.units * (blockIdx.x + 1) / gridDim.x - u0);
  const int bh0 = (int)(u0 / p.nqt), qt0 = (int)(u0 % p.nqt);
  const int b0 = bh0 / p.heads, h0 = bh0 % p.heads;

  if (threadIdx.x == 0) {
    mbar_init(kv_full, 1);
    mbar_init(kv_empty, CONSUMER_WARPS);
    mbar_init(q_full, 1);
    mbar_init(q_empty, CONSUMER_WARPS);
#pragma unroll
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], CONSUMER_WARPS);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x < 128) {
    // ===== producer warpgroup: lane 0 of warp 0 issues every TMA =====
    regs_dealloc<24>();
    if (threadIdx.x != 0) return;
    int b = b0, h = h0, qt = qt0, nk = 0, hc = 0, j = 0;
    for (int n = 0; n < count; ++n, next_unit(b, h, qt, p)) {
      // this tile's Q once the consumers have copied the last one out
      mbar_wait(q_empty, (n & 1) ^ 1);
      mbar_expect_tx(q_full, TILE_BYTES);
      load_tile(qs, &tq, q_full, qt * BM, h, b);
      if (n == 0 || qt == 0) {
        // a new head's keys once the consumers are done with the last
        mbar_wait(kv_empty, (hc & 1) ^ 1);
        ++hc;
        nk = sample_keys<CL>(p, b).nk;
        if (nk == 0) {
          mbar_arrive(kv_full);
        } else {
          mbar_expect_tx(kv_full, nk * TILE_BYTES * (VRES ? 2 : 1));
          for (int kt = 0; kt < nk; ++kt) {
            load_tile(ks + kt * TILE_BYTES, &tk, kv_full, kt * BN, h, b);
            if (VRES)
              load_tile(vs + kt * TILE_BYTES, &tv, kv_full, kt * BN, h, b);
          }
        }
      }
      if constexpr (!VRES) {
        for (int kt = 0; kt < nk; ++kt, ++j) {
          const int s = j % STAGES;
          mbar_wait(&empty[s], ((j / STAGES) & 1) ^ 1);
          mbar_expect_tx(&full[s], TILE_BYTES);
          load_tile(vs + s * TILE_BYTES, &tv, &full[s], kt * BN, h, b);
        }
      }
    }
  } else {
    // ===== consumer warpgroups: 64 query rows each =====
    regs_alloc<240>();
    const int ct = threadIdx.x - 128;
    const int cw = ct / 128;                 // consumer warpgroup
    const int warp = (ct % 128) / 32, lane = ct % 32;
    const int t = lane & 3;                  // accumulator column pair
    const int qrow0 = cw * 64 + warp * 16;
    const int r0 = qrow0 + (lane >> 2);      // this thread's rows r0, r0 + 8
    if (cw == 1) pp_arrive(cw);              // warpgroup 0 goes first

    uint32_t qa[8][4], pa[8][4];
    float o[64], sc[64];
    float m_row[2] = {0.f, 0.f}, l_row[2] = {0.f, 0.f};
#pragma unroll
    for (int e = 0; e < 64; ++e) o[e] = 0.f;
    int b = b0, h = h0, qt = qt0, j = 0;
    Keys hk{0, 0, 0};
    for (int n = 0; n < count; ++n, next_unit(b, h, qt, p)) {
      // sc holds S of this tile's key tile 0 when the last tile of this
      // run was of the same head (its last step issued it)
      const bool have_s0 = n > 0 && qt > 0 && hk.nk > 0;
      if (n == 0 || qt == 0) {
        if (n > 0) release(kv_empty, lane);
        mbar_wait(kv_full, (b * p.heads + h - b0 * p.heads - h0) & 1);
        hk = sample_keys<CL>(p, b);
      }
      if (!have_s0) {
        take_q(qa, qs, q_full, q_empty, n, qrow0, lane, p.negate);
        if (hk.nk == 0) {
          store_rows(p, b, h, qt, o, l_row, m_row, r0, t, true);
          continue;
        }
        step<0>(o, pa, vs, sc, qa, ks, cw);
      }
      // key tile 0
      m_row[0] = m_row[1] = -INFINITY;
      l_row[0] = l_row[1] = 0.f;
#pragma unroll
      for (int e = 0; e < 64; ++e) o[e] = 0.f;
      softmax_keys(sc, pa, o, m_row, l_row, p.scale2,
                   hk.nk == 1 ? hk.lv : BN, t);
      // key tiles 1 .. nk - 1: P V of tile kt - 1 with S of tile kt
#pragma unroll 1
      for (int kt = 1; kt < hk.nk; ++kt) {
        const bool last = kt == hk.nk - 1;
        const unsigned char* vt = vs + (kt - 1) * TILE_BYTES;
        const int s = j % STAGES;
        if constexpr (!VRES) {
          mbar_wait(&full[s], (j / STAGES) & 1);
          vt = vs + s * TILE_BYTES;
        }
        step<TILE_CHUNKS>(o, pa, vt, sc, qa, ks + kt * TILE_BYTES, cw);
        if constexpr (!VRES) {
          release(&empty[s], lane);
          ++j;
        }
        softmax_keys(sc, pa, o, m_row, l_row, p.scale2, last ? hk.lv : BN,
                     t);
      }
      // the last step: P V of the last key tile, with S of the next tile's
      // key tile 0 on the next tile's Q when it is of the same head (its
      // keys are resident); otherwise that S, on this tile's Q, is a dead
      // copy (K stays until the consumers release it), as in P4, so the
      // step has one form
      const bool next = n + 1 < count && qt + 1 < p.nqt;
      if (next) take_q(qa, qs, q_full, q_empty, n + 1, qrow0, lane, p.negate);
      const unsigned char* vt = vs + (hk.nk - 1) * TILE_BYTES;
      const int s = j % STAGES;
      if constexpr (!VRES) {
        mbar_wait(&full[s], (j / STAGES) & 1);
        vt = vs + s * TILE_BYTES;
      }
      if (hk.c == TILE_CHUNKS)
        step<TILE_CHUNKS>(o, pa, vt, sc, qa, ks, cw);
      else
        step<CL>(o, pa, vt, sc, qa, ks, cw);
      if constexpr (!VRES) {
        release(&empty[s], lane);
        ++j;
      }
      store_rows(p, b, h, qt, o, l_row, m_row, r0, t, false);
    }
    // warpgroup 1's last arrive on warpgroup 0's barrier (its initial one
    // when the block ran no step) has its wait here
    if (cw == 0) pp_sync(cw);
  }
}

// A 4-D map over bf16 (D, rows, heads, batch) with the caller's element
// strides st = {row, head, sample}: 128-row x 64-column boxes, 128-byte
// swizzle; rows past `rows` read as zeros.
bool make_map4(CUtensorMap* map, const void* base, int rows, int heads,
               int batch, const long long* st) {
  const EncodeTiledFn fn = encode_tiled();
  if (fn == nullptr) return false;
  const cuuint64_t dims[4] = {(cuuint64_t)D, (cuuint64_t)rows,
                              (cuuint64_t)heads, (cuuint64_t)batch};
  const cuuint64_t strides[3] = {(cuuint64_t)st[0] * 2,
                                 (cuuint64_t)st[1] * 2,
                                 (cuuint64_t)st[2] * 2};
  const cuuint32_t box[4] = {BOX_COLS, BN, 1, 1};
  const cuuint32_t elem[4] = {1, 1, 1, 1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(base),
            dims, strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
            CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <bool VRES, int CL>
int launch(const CUtensorMap& tq, const CUtensorMap& tk,
           const CUtensorMap& tv, const ShortParams& p, int grid,
           cudaStream_t stream) {
  const auto kernel = dense_kernel_short<VRES, CL>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)SSMEM_BYTES);
  if (err != cudaSuccess) return (int)err;
  kernel<<<grid, THREADS, SSMEM_BYTES, stream>>>(tq, tk, tv, p);
  return (int)cudaGetLastError();
}

// The instance for Skv's last key tile of cl 16-key chunks.
template <bool VRES>
int launch_tail(const CUtensorMap& tq, const CUtensorMap& tk,
                const CUtensorMap& tv, const ShortParams& p, int grid,
                cudaStream_t stream, int cl) {
  if (cl <= 1) return launch<VRES, 1>(tq, tk, tv, p, grid, stream);
  if (cl <= 2) return launch<VRES, 2>(tq, tk, tv, p, grid, stream);
  if (cl <= 4) return launch<VRES, 4>(tq, tk, tv, p, grid, stream);
  return launch<VRES, TILE_CHUNKS>(tq, tk, tv, p, grid, stream);
}

}  // namespace

// q [B, H, Sq, 128], k and v [B, H, Skv, 128] and o [B, H, Sq, 128] in
// bf16, each addressed through `strides`: 12 element strides, (row, head,
// sample) of q, k, v and o in turn (the last dim contiguous; for q, k and
// v multiples of 8, the pointers 16-byte aligned). kv_len [B] int32 or
// null; lse [B*H, ceil(Sq / 128) * 128] f32 or null.
extern "C" int dense_attn_short_forward(const void* q, const void* k,
                                        const void* v, void* o,
                                        const void* kv_len, void* lse,
                                        int batch, int heads, int sq, int skv,
                                        const long long* strides,
                                        float sm_scale, void* stream) {
  if (batch < 1 || heads < 1 || sq < 1 || skv < 1 || skv > MAX_KEYS)
    return (int)cudaErrorInvalidValue;
  CUtensorMap tq, tk, tv;
  if (!make_map4(&tq, q, sq, heads, batch, strides) ||
      !make_map4(&tk, k, skv, heads, batch, strides + 3) ||
      !make_map4(&tv, v, skv, heads, batch, strides + 6))
    return (int)cudaErrorInvalidValue;
  ShortParams p{};
  p.o = static_cast<__nv_bfloat16*>(o);
  p.o_s = strides[9];
  p.o_h = strides[10];
  p.o_b = strides[11];
  p.kv_len = static_cast<const int*>(kv_len);
  p.lse = static_cast<float*>(lse);
  p.heads = heads;
  p.sq = sq;
  p.skv = skv;
  p.nqt = (sq + BM - 1) / BM;
  p.nkt = (skv + BN - 1) / BN;
  p.units = (long long)batch * heads * p.nqt;
  p.scale2 = fabsf(sm_scale) * LOG2E;
  p.negate = sm_scale < 0.f;
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return (int)err;
  const int grid = (int)(p.units < sms ? p.units : sms);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int cl = (skv - (p.nkt - 1) * BN + CHUNK - 1) / CHUNK;
  return p.nkt <= Slots<true>::K_TILES
             ? launch_tail<true>(tq, tk, tv, p, grid, st, cl)
             : launch_tail<false>(tq, tk, tv, p, grid, st, cl);
}

extern "C" const char* dense_attn_short_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// Resident-K cross-attention over 512 keys, for Hopper (sm_90a): probe
// kernel P4.
//
// Replaces the Pallas TPU probe `cross_resident`
// (tools/wan_overhead_probe2.py:122, body `_xkernel` :105, pallas_call
// :124): Wan's cross-attention, every query row attending all 512 text keys
// of its (batch, head), with no kv_len, no mask and no bias. No main path
// launches it; the port's probe times it against kernel D (dense_attn.cu)
// on the same operands, which answers the TPU probe's question: does a
// thread block that keeps the 512 keys resident beat a per-query-block
// flash kernel?
//
// Math (per query row i): s_ij = (q_i . k_j) * sm_scale * log2(e),
// o_i = sum_j exp2(s_ij - m_i) v_j / sum_j exp2(s_ij - m_i) over j < 512,
// the exact softmax: m_i is the running row max over the four 128-key
// tiles, so after the last tile it is the row's exact max (no fixed max,
// which can underflow a row).
//
// What bounds it on the card: a 128-row query tile does 4 x 128 x 512 x
// 128 = 33.6 MFLOP of tensor-core work against its own 32 KB of Q read and
// 32 KB of O written, ~510 FLOP/byte, above the H100's ~295 ridge: the
// tensor cores (989 TFLOP/s bf16) are the limit, 0.208 ms at Wan's shape
// (2 x 12 x 32,768 rows) against 0.122 ms for its 409 MB. With only four
// key tiles per query tile, a per-query-block kernel (D) pays its Q load,
// its pipeline fill and its store once every four tiles with nothing to
// hide them behind.
//
// Design, on the primitives of attn_sm90.cuh (not its mainloop, which
// loads K and V per 128-row query block): one thread block per (bq query
// rows, batch*head), looping over its bq / 128 query tiles; three
// warpgroups (384 threads).
//   * warpgroup 0, the producer, drops to 40 registers; lane 0 of warp 0
//     issues every TMA. K, all four 128-key tiles (8 boxes, 128 KB), is
//     loaded once per thread block under one barrier and stays resident.
//     For each query tile it loads Q (32 KB) into the one Q buffer and
//     streams the four V tiles through a 2-stage full/empty ring.
//   * warpgroups 1 and 2, the consumers, rise to 232 registers and own 64
//     query rows each. They copy a tile's Q out of its buffer into
//     registers (ldmatrix, 32 registers a thread) as soon as it lands and
//     release the buffer at once, so the next tile's Q loads during the
//     whole tile. S = Q K^T is wgmma m64n128k16 with Q from registers and
//     K from shared memory; the online softmax runs on the accumulator
//     registers; O += P V takes P from registers and V from shared memory
//     (transposed).
//   * Four steps per query tile: steps 1-3 issue P V of key tile kt - 1
//     and S of key tile kt together (K is resident, so S never waits for a
//     copy) and wait once, then run the softmax of tile kt; step 4 issues
//     P V of key tile 3 with S of the next query tile's key tile 0, so
//     the tile boundary costs no step of its own. Two named barriers make
//     the warpgroups take turns (ping-pong): one issues its step while the
//     other runs its softmax, so the tensor cores see both warpgroups'
//     products back to back.
//   * 3-D tensor maps over [B*H, rows, 128], 128-byte swizzle: Q rows past
//     sq are zero-filled within their head, never read from the next one,
//     and are not stored.
// Tried on the H100 and dropped as slower: Q read by wgmma
// from shared memory with its buffer released after the tile's last
// Q K^T, and the next S issued before this P V inside one warpgroup
// (ptxas serialised that one's wgmmas).
//
// Shared memory (the trap: K|V of 512 keys is 262,144 B, over the 232,448
// B a thread block may have, so only K stays resident):
//   Q, one 128 x 128 tile (its landing buffer)  32,768 B
//   K, four 128 x 128 tiles ................. 131,072 B
//   V ring, 2 stages x 128 x 128 ............  65,536 B
//   7 mbarriers (K, Q full/empty, ring) .....      64 B
//   slack to align to the 1024-byte atom ....   1,024 B
//   total ................................... 230,464 B
//
// Plain C interface (loaded with ctypes); the launch goes on the caller's
// stream and the function returns cudaGetLastError(), or
// cudaErrorInvalidValue for a bq it does not take or a tensor map that
// cannot be encoded.

#include "attn_sm90.cuh"

namespace {

using namespace sm90;

constexpr int NKEYS = 512;
constexpr int NKT = NKEYS / BN;                        // key tiles
constexpr uint32_t XQ_OFF = 0;
constexpr uint32_t XK_OFF = XQ_OFF + TILE_BYTES;
constexpr uint32_t XV_OFF = XK_OFF + NKT * TILE_BYTES;
constexpr uint32_t XBAR_OFF = XV_OFF + STAGES * TILE_BYTES;
constexpr size_t XSMEM_BYTES = XBAR_OFF + 64 + 1024;
static_assert(XK_OFF == 32768 && XV_OFF == 163840 && XBAR_OFF == 229376,
              "the layout written above");
static_assert(XSMEM_BYTES == 230464, "the layout written above");
static_assert(XSMEM_BYTES <= 232448, "227 KB per block on sm_90");

struct XParams {
  __nv_bfloat16* o;  // [BH, sq, D]
  int sq, tiles_per_block;
  float scale2;      // sm_scale * log2(e)
};

// S = Q K^T for this warpgroup's 64 rows and one resident key tile: 8
// k-steps of 16 dims, Q's A-fragments from registers, K from shared memory
// (K-major, 4 k-steps in each 64-column box). Issued and committed, not
// waited on.
__device__ __forceinline__ void issue_qk(float (&sc)[64],
                                         const uint32_t (&qa)[8][4],
                                         const unsigned char* ks) {
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    const uint32_t off = (kk / 4) * BOX_BYTES + (kk % 4) * 32;
    wgmma_rs_kmajor(sc, qa[kk], sw128_desc(ks + off, 16, 1024), kk > 0);
  }
  wg_commit();
}

// This warp's 16 query rows of the Q tile as wgmma A-fragments (the
// mma.m16n8k16 layout), one ldmatrix.x4 per k-step from the swizzled tile:
// lane l addresses row (l & 7) + 8 ((l >> 3) & 1), 16-byte chunk 2kk +
// (l >> 4), whose place in its 128-byte row is XORed with row % 8.
__device__ __forceinline__ void load_q(uint32_t (&qa)[8][4],
                                       const unsigned char* qs, int row0,
                                       int lane) {
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
}

// O += P V for one V stage: k-step kk is keys 16kk..16kk+15 (2 KB into each
// box); the two boxes (d 0-63, 64-127) are one lbo apart.
__device__ __forceinline__ void issue_pv(float (&o)[64],
                                         const uint32_t (&pa)[8][4],
                                         const unsigned char* vs) {
#pragma unroll
  for (int kk = 0; kk < 8; ++kk)
    wgmma_rs(o, pa[kk], sw128_desc(vs + kk * 16 * 128, BOX_BYTES, 1024));
  wg_commit();
}

// The online softmax of one key tile on the S accumulator: element i of sc
// is row r0 + 8 * ((i >> 1) & 1), key 8 * (i >> 2) + 2t + (i & 1). Leaves
// P = exp2(s * scale2 - m) in sc, the rescale of the earlier tiles in
// alpha and this thread's share of the row sums in rs. The max is taken
// over the raw s (scale2 > 0, checked at the launch), so the scale folds
// into one FMA per element. Every key is valid, so m is finite after the
// first tile.
__device__ __forceinline__ void softmax_tile(float (&sc)[64],
                                             float (&m_row)[2],
                                             float (&alpha)[2],
                                             float (&rs)[2], float scale2) {
  float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
  for (int i = 0; i < 64; ++i)
    mx[(i >> 1) & 1] = fmaxf(mx[(i >> 1) & 1], sc[i]);
#pragma unroll
  for (int rr = 0; rr < 2; ++rr) {
    mx[rr] = fmaxf(mx[rr], __shfl_xor_sync(0xffffffffu, mx[rr], 1));
    mx[rr] = fmaxf(mx[rr], __shfl_xor_sync(0xffffffffu, mx[rr], 2));
    const float m_new = fmaxf(m_row[rr], mx[rr] * scale2);
    alpha[rr] = ex2(m_row[rr] - m_new);  // ex2(-inf) = 0 on the first tile
    m_row[rr] = m_new;
    rs[rr] = 0.f;
  }
#pragma unroll
  for (int i = 0; i < 64; ++i) {
    sc[i] = ex2(fmaf(sc[i], scale2, -m_row[(i >> 1) & 1]));
    rs[(i >> 1) & 1] += sc[i];
  }
}

// P as bf16 A-fragments: k-step kk = keys 16kk..16kk+15 = accumulator
// n8-blocks 2kk and 2kk + 1.
__device__ __forceinline__ void pack_p(uint32_t (&pa)[8][4],
                                       const float (&sc)[64]) {
#pragma unroll
  for (int kk = 0; kk < 8; ++kk)
#pragma unroll
    for (int e = 0; e < 4; ++e)
      pa[kk][e] = pack_bf16(sc[8 * kk + 2 * e], sc[8 * kk + 2 * e + 1]);
}

__device__ __forceinline__ void rescale(float (&o)[64], float (&l_row)[2],
                                        const float (&alpha)[2],
                                        const float (&rs)[2]) {
#pragma unroll
  for (int i = 0; i < 64; ++i) o[i] *= alpha[(i >> 1) & 1];
#pragma unroll
  for (int rr = 0; rr < 2; ++rr) l_row[rr] = l_row[rr] * alpha[rr] + rs[rr];
}

__device__ __forceinline__ void release(uint64_t* bar, int lane) {
  __syncwarp();
  if (lane == 0) mbar_arrive(bar);
}

// Normalise and store this thread's two rows of a query tile, skipping
// rows >= q_valid.
__device__ __forceinline__ void store_rows(__nv_bfloat16* out,
                                           const float (&o)[64],
                                           const float (&l_row)[2], int r0,
                                           int t, int q_valid) {
#pragma unroll
  for (int rr = 0; rr < 2; ++rr) {
    float l = l_row[rr];
    l += __shfl_xor_sync(0xffffffffu, l, 1);
    l += __shfl_xor_sync(0xffffffffu, l, 2);
    const int r = r0 + 8 * rr;
    if (r >= q_valid) continue;
    const float inv = 1.f / l;
    __nv_bfloat16* orow = out + (size_t)r * D + 2 * t;
#pragma unroll
    for (int nb = 0; nb < 16; ++nb)
      *reinterpret_cast<__nv_bfloat162*>(orow + 8 * nb) =
          __floats2bfloat162_rn(o[4 * nb + 2 * rr] * inv,
                                o[4 * nb + 2 * rr + 1] * inv);
  }
}

// Named barriers 1 and 2 order the two consumer warpgroups' products
// (ping-pong): a warpgroup waits on its own before issuing and arrives on
// the other's after, so one issues while the other runs its softmax.
__device__ __forceinline__ void pp_sync(int cw) {
  asm volatile("bar.sync %0, 256;\n" ::"r"(1 + cw) : "memory");
}
__device__ __forceinline__ void pp_arrive(int cw, bool when = true) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %1, 0;\n@p bar.arrive %0, 256;\n}\n"
      ::"r"(2 - cw), "r"((int)when)
      : "memory");
}

__global__ void __launch_bounds__(THREADS, 1)
    xattn_kernel(const __grid_constant__ CUtensorMap tq,
                 const __grid_constant__ CUtensorMap tk,
                 const __grid_constant__ CUtensorMap tv, const XParams p) {
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  unsigned char* smem =
      smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  unsigned char* qs = smem + XQ_OFF;
  unsigned char* ks = smem + XK_OFF;
  unsigned char* vs = smem + XV_OFF;
  uint64_t* k_full = reinterpret_cast<uint64_t*>(smem + XBAR_OFF);
  uint64_t* q_full = k_full + 1;
  uint64_t* q_empty = q_full + 1;
  uint64_t* full = q_empty + 1;     // [STAGES]
  uint64_t* empty = full + STAGES;  // [STAGES]

  const int bh = blockIdx.y;
  const int tile0 = blockIdx.x * p.tiles_per_block;
  const int nt = min(p.tiles_per_block, (p.sq + BM - 1) / BM - tile0);

  if (threadIdx.x == 0) {
    mbar_init(k_full, 1);
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
    regs_dealloc<40>();
    if (threadIdx.x != 0) return;
    // one 128 x 128 tile: two 64-column boxes, completion counted on bar
    auto load_tile = [&](unsigned char* dst, const CUtensorMap* map,
                         uint64_t* bar, int row) {
      tma_load(dst, map, bar, 0, row, bh);
      tma_load(dst + BOX_BYTES, map, bar, BOX_COLS, row, bh);
    };
    // K, all four tiles, once for the thread block, under one barrier
    mbar_expect_tx(k_full, NKT * TILE_BYTES);
    for (int kt = 0; kt < NKT; ++kt)
      load_tile(ks + kt * TILE_BYTES, &tk, k_full, kt * BN);
    int j = 0;  // V tiles issued
    for (int i = 0; i < nt; ++i) {
      // this tile's Q once the consumers have copied the last one out
      mbar_wait(q_empty, (i & 1) ^ 1);
      mbar_expect_tx(q_full, TILE_BYTES);
      load_tile(qs, &tq, q_full, (tile0 + i) * BM);
      for (int kt = 0; kt < NKT; ++kt, ++j) {
        const int s = j % STAGES;
        mbar_wait(&empty[s], ((j / STAGES) & 1) ^ 1);
        mbar_expect_tx(&full[s], TILE_BYTES);
        load_tile(vs + s * TILE_BYTES, &tv, &full[s], kt * BN);
      }
    }
  } else {
    // ===== consumer warpgroups: 64 query rows each =====
    regs_alloc<232>();
    const int ct = threadIdx.x - 128;
    const int cw = ct / 128;                       // consumer warpgroup
    const int warp = (ct % 128) / 32, lane = ct % 32;
    const int g = lane >> 2, t = lane & 3;         // accumulator coordinates
    const int r0 = cw * 64 + warp * 16 + g;        // this thread's rows r0, r0 + 8
    if (cw == 1) pp_arrive(cw);                    // warpgroup 0 goes first

    mbar_wait(k_full, 0);
    int j = 0;  // V tiles consumed
    uint32_t qa[8][4], pa[8][4];
    float m_row[2], l_row[2], alpha[2], rs[2];
    float o[64], sc[64];
    const int qrow0 = cw * 64 + warp * 16;
    // S of the first tile's key tile 0; later tiles get theirs in the
    // step 4 of the tile before
    mbar_wait(q_full, 0);
    load_q(qa, qs, qrow0, lane);
    release(q_empty, lane);
    pp_sync(cw);
    reg_fence(qa);
    wg_fence();
    issue_qk(sc, qa, ks);
    pp_arrive(cw);
    wg_wait<0>();
    reg_fence(sc);
    reg_fence(qa);
    for (int i = 0; i < nt; ++i) {
      const int row0 = (tile0 + i) * BM;
      // key tile 0 of this tile is in sc
      m_row[0] = m_row[1] = -INFINITY;
#pragma unroll
      for (int e = 0; e < 64; ++e) o[e] = 0.f;
      softmax_tile(sc, m_row, alpha, rs, p.scale2);
      l_row[0] = rs[0];
      l_row[1] = rs[1];
      pack_p(pa, sc);
      // steps 1-3: P V of key tile kt - 1 with S of key tile kt
#pragma unroll 1
      for (int kt = 1; kt < NKT; ++kt, ++j) {
        const int s = j % STAGES;
        mbar_wait(&full[s], (j / STAGES) & 1);
        pp_sync(cw);
        reg_fence(o);
        reg_fence(pa);
        reg_fence(qa);
        wg_fence();
        issue_pv(o, pa, vs + s * TILE_BYTES);
        issue_qk(sc, qa, ks + kt * TILE_BYTES);
        pp_arrive(cw);
        wg_wait<0>();
        reg_fence(o);
        reg_fence(pa);
        reg_fence(sc);
        reg_fence(qa);
        release(&empty[s], lane);
        softmax_tile(sc, m_row, alpha, rs, p.scale2);
        rescale(o, l_row, alpha, rs);
        pack_p(pa, sc);
      }
      // step 4: P V of key tile 3 with S of the next tile's key tile 0,
      // on the next tile's Q (after the last tile, a dead copy of this
      // one, whose S is discarded)
      if (i + 1 < nt) mbar_wait(q_full, (i + 1) & 1);
      load_q(qa, qs, qrow0, lane);
      release(q_empty, lane);
      const int s = j % STAGES;
      mbar_wait(&full[s], (j / STAGES) & 1);
      pp_sync(cw);
      reg_fence(o);
      reg_fence(pa);
      reg_fence(qa);
      wg_fence();
      issue_pv(o, pa, vs + s * TILE_BYTES);
      issue_qk(sc, qa, ks);
      // warpgroup 1's last arrive would have no wait to match
      pp_arrive(cw, cw == 0 || i < nt - 1);
      wg_wait<0>();
      reg_fence(o);
      reg_fence(pa);
      reg_fence(sc);
      reg_fence(qa);
      release(&empty[s], lane);
      ++j;
      store_rows(p.o + ((size_t)bh * p.sq + row0) * D, o, l_row, r0, t,
                 min(BM, p.sq - row0));
    }
  }
}

}  // namespace

extern "C" int xattn_resident_forward(const void* q, const void* k,
                                      const void* v, void* o, int bh, int sq,
                                      int bq, float sm_scale, void* stream) {
  if (bq < BM || bq % BM || sq < 1 || bh < 1 || !(sm_scale > 0.f))
    return (int)cudaErrorInvalidValue;
  CUtensorMap tq, tk, tv;
  if (!make_map(&tq, q, bh, sq) || !make_map(&tk, k, bh, NKEYS) ||
      !make_map(&tv, v, bh, NKEYS))
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      xattn_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)XSMEM_BYTES);
  if (err != cudaSuccess) return (int)err;
  const XParams p{static_cast<__nv_bfloat16*>(o), sq, bq / BM,
                  sm_scale * LOG2E};
  xattn_kernel<<<dim3((sq + bq - 1) / bq, bh), THREADS, XSMEM_BYTES,
                 static_cast<cudaStream_t>(stream)>>>(tq, tk, tv, p);
  return (int)cudaGetLastError();
}

extern "C" const char* xattn_resident_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

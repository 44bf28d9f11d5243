// The attention mainloop of the port's block-sparse kernel (K1, K1m, K2:
// block_sparse_attn.cu), its dense kernel (D: dense_attn.cu) and the probe
// kernels P1/P2 (attn_probe.cu), for Hopper (sm_90a): a TMA producer warp
// feeding a shared-memory ring, two wgmma consumer warpgroups.
//
// Replaces, through those three files, the Pallas TPU kernels
//   * K1 `_kernel_grouped` (jenga_tpu/ops/block_sparse_attention.py:409,
//     pallas_call :777, entry `block_sparse_attention_grouped` :692), in
//     its all-member mode and as K1m (`all_member=False`);
//   * K2 `_kernel` (:49, pallas_call :368, entry `block_sparse_attention`
//     :284), the q_rows = 1 case;
//   * D, the stock Pallas flash kernel behind `dense_attention`
//     (jenga_tpu/ops/flash_attention.py:73, `pl_flash` :92);
//   * the probes P1 `variant` (tools/kernel_split_probe.py:140) and P2
//     `run_variant` (tools/epilogue_probe.py:250), as switched instances.
// The probe P4 (cross_attn_resident.cu) uses its primitives, not its
// mainloop.
//
// What bounds it: the tensor cores. At the HunyuanVideo main shape (1x24x
// 32,768, d 128, joint q8 lists at density ~0.33) a launch computes 4.31
// TFLOP of QK^T and PV, 4.36 ms at the H100's 989 TFLOP/s bf16, against
// 0.25 GB of q, k, v and o (0.08 ms at 3.35 TB/s); the K|V tiles a query
// block gathers are re-read by the 8 blocks of its group and come mostly
// from L2. Dense self-attention at Wan's shape is the same product over
// every tile.
//
// Design, one thread block per (batch*head, 128-row query block), three
// warpgroups (384 threads):
//   * warpgroup 0, the producer, drops to 40 registers (setmaxnreg); one
//     warp walks the tile's block list (a warp ballot per 32 entries keeps
//     the blocks whose membership bit is set, in list order, for K1m) and
//     its lane 0 issues every TMA: Q once, then K and V of each attended
//     block into a 2-stage ring guarded by full/empty mbarriers. The
//     block id of each stage goes into a shared slot before the stage's
//     full barrier completes, so the consumers see exactly the blocks the
//     producer loaded.
//   * warpgroups 1 and 2, the consumers, rise to 232 registers and own 64
//     query rows each. S = Q K^T is wgmma m64n128k16 with both operands in
//     shared memory (K-major, 128-byte swizzle); the softmax runs on the
//     accumulator registers; O += P V takes P from registers (bf16, the
//     accumulator layout is the A-fragment layout) and V from shared
//     memory with the transpose flag (V is [key][d], MN-major).
//   * Operands are 3-D tensor maps over [B*H, S, 128] with 128-byte
//     swizzle, each 128x128 tile two 64-column boxes; rows past S are
//     zero-filled by the TMA unit, never read from the next head.
// What this does about the limits the probes P1/P2 found in an mma.sync
// loop whose 256 threads both copied and computed: the gather overlaps
// the math (the producer refills one stage while the consumers compute on
// the other, and the two consumer warpgroups interleave their softmax and
// their products); the products run on wgmma, the only path to the full
// tensor-core rate; V's B operand is read by the tensor core through its
// descriptor, not by scalar shared loads; and the fixed-max epilogue is
// one FMA and one ex2 per element with no -inf guard (m is finite there),
// the key mask applied only in tiles that cross seqlen.
//
// Compile-time switches (the production kernels take the defaults, with
// kFixedMax or kOnline): the epilogue (online / fixed / constant max), the
// key mask (as needed / always / never), MATH (false: the consumers wait on
// and release every stage but skip the products: the gather alone) and
// GATHER (false: the producer loads the first attended block once and the
// consumers run the tile math n times over it: the math alone).

#pragma once

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace sm90 {

constexpr int BM = 128;                 // query rows per thread block
constexpr int BN = 128;                 // keys per K|V tile
constexpr int D = 128;                  // head dim
constexpr int BOX_COLS = 64;            // columns per TMA box (128 bytes)
constexpr int THREADS = 384;            // producer + 2 consumer warpgroups
constexpr int CONSUMER_WARPS = 8;
constexpr int STAGES = 2;               // K|V ring depth
constexpr uint32_t BOX_BYTES = BN * BOX_COLS * 2;     // 16 KB
constexpr uint32_t TILE_BYTES = 2 * BOX_BYTES;        // 128 x 128 bf16
constexpr uint32_t STAGE_BYTES = 2 * TILE_BYTES;      // K then V
constexpr uint32_t KV_OFF = TILE_BYTES;               // after Q
constexpr uint32_t BAR_OFF = KV_OFF + STAGES * STAGE_BYTES;
// Q, the ring, 5 mbarriers and 2 block-id slots, and the slack to align the
// dynamic shared memory to the 1024-byte swizzle atom
constexpr size_t SMEM_BYTES = BAR_OFF + 64 + 1024;
static_assert(SMEM_BYTES <= 232448, "227 KB per block on sm_90");
constexpr float LOG2E = 1.4426950408889634f;
constexpr float CONST_MAX = 20.f;

// How the row max m of the exp2(s - m) epilogue is set.
enum class Epilogue {
  kOnline,    // the running row max
  kFixedMax,  // the per-row Cauchy-Schwarz bound (the production default)
  kConstMax,  // the constant CONST_MAX (a probe floor: no max at all)
};

// Which tiles apply the key mask (keys >= kv_valid) and the text_amp bias.
enum class KeyMask {
  kAsNeeded,  // the bias always, the mask in tiles that cross kv_valid
  kAlways,    // the bias and the mask in every tile
  kNever,     // neither (the probes' "no masking" floor)
};

// Everything but the tensor maps. The block-sparse kernel reads the lists
// (group `query_block / q_rows`), the dense kernel kv_len; q_valid rows of
// a query block are stored. The dense kernel also stores each stored row's
// log-sum-exp of its base-2 logits, m + log2(l), where `lse` is not null
// (the backward's statistics; +inf for a row with no key), and leaves the
// padded rows of the last query block untouched.
struct Params {
  __nv_bfloat16* o;        // [BH, sq, D]
  const int* lists;        // [BH, ngroups, nkb]
  const int* counts;       // [BH, ngroups]
  const int* members;      // [BH, ngroups, nkb] or null (all-member)
  const int* seqlens;      // [B]
  const float* maxk;       // [BH] max key norm (fixed max)
  const int* kv_len;       // [B] or null (dense)
  float* lse;              // [BH, nqb * BM] base-2 log-sum-exp, or null
  int heads, sq, skv, nkb, ngroups, q_rows, tsb;
  float sm_scale, text_amp;
};

// ---- PTX wrappers ---------------------------------------------------------

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(
                   smem_u32(bar)),
               "r"(count));
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar,
                                               uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
          smem_u32(bar)),
      "r"(bytes)
      : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(
                   smem_u32(bar))
               : "memory");
}

// Wait until the barrier's phase `parity` has completed.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  asm volatile(
      "{\n"
      ".reg .pred P1;\n"
      "LAB_WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 P1, [%0], %1;\n"
      "@P1 bra DONE;\n"
      "bra LAB_WAIT;\n"
      "DONE:\n"
      "}\n" ::"r"(smem_u32(bar)),
      "r"(parity)
      : "memory");
}

// One box of a 3-D tensor map ({column, row, batch*head}) into shared
// memory; completion is counted in bytes on `bar`.
__device__ __forceinline__ void tma_load(void* dst, const CUtensorMap* map,
                                         uint64_t* bar, int c0, int c1,
                                         int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0),
      "r"(c1), "r"(c2)
      : "memory");
}

template <int R>
__device__ __forceinline__ void regs_dealloc() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(R));
}
template <int R>
__device__ __forceinline__ void regs_alloc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(R));
}

__device__ __forceinline__ void wg_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wg_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wg_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// Keep the compiler from moving accesses of wgmma registers across the
// fences and waits above.
template <int N>
__device__ __forceinline__ void reg_fence(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}
template <int M, int N>
__device__ __forceinline__ void reg_fence(uint32_t (&r)[M][N]) {
#pragma unroll
  for (int i = 0; i < M; ++i)
#pragma unroll
    for (int e = 0; e < N; ++e) asm volatile("" : "+r"(r[i][e])::"memory");
}

// Shared-memory matrix descriptor, 128-byte swizzle. K-major operands (Q,
// K: rows of 64 bf16 = 128 bytes) take sbo = 1024 (the 8-row swizzle atom)
// and an ignored lbo; the MN-major V takes lbo = the byte distance between
// its two 64-column boxes and sbo = 1024 (8 keys).
__device__ __forceinline__ uint64_t sw128_desc(const void* p, uint32_t lbo,
                                               uint32_t sbo) {
  return (uint64_t)((smem_u32(p) & 0x3FFFF) >> 4) |
         ((uint64_t)(lbo >> 4) << 16) | ((uint64_t)(sbo >> 4) << 32) |
         (1ull << 62);
}

#define SM90_ACC64                                                           \
  "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),    \
      "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]),           \
      "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),       \
      "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]),       \
      "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),       \
      "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]),       \
      "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),       \
      "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]),       \
      "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]),       \
      "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]), "+f"(d[50]),       \
      "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),       \
      "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]),       \
      "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
#define SM90_D64                                                             \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, " \
  "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "  \
  "%30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, "  \
  "%44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, "  \
  "%58, %59, %60, %61, %62, %63}"

// d (64 rows x 128 f32, the warpgroup's accumulator) = A B (+ d if
// accumulate), A and B K-major in shared memory.
__device__ __forceinline__ void wgmma_ss(float (&d)[64], uint64_t da,
                                         uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 " SM90_D64
      ", %64, %65, p, 1, 1, 0, 0;\n}\n"
      : SM90_ACC64
      : "l"(da), "l"(db), "r"(accumulate));
}

// d += A B with A (64 x 16 bf16) in registers, B MN-major in shared memory.
__device__ __forceinline__ void wgmma_rs(float (&d)[64], const uint32_t (&a)[4],
                                         uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 " SM90_D64
      ", {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : SM90_ACC64
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// d = A B (+ d if accumulate) with A in registers and B K-major in shared
// memory (P4's S = Q K^T with Q held in registers).
__device__ __forceinline__ void wgmma_rs_kmajor(float (&d)[64],
                                                const uint32_t (&a)[4],
                                                uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 " SM90_D64
      ", {%64, %65, %66, %67}, %68, p, 1, 1, 0;\n}\n"
      : SM90_ACC64
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(accumulate));
}

#undef SM90_ACC64
#undef SM90_D64

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// ---- the mainloop ---------------------------------------------------------

// Whether entry i of the group's list is attended by this query block:
// listed (i < n_list) and, with membership words, its bit set.
__device__ __forceinline__ bool attended(const int* memb, int i, int n_list,
                                         int bit) {
  return i < n_list && (memb == nullptr || ((memb[i] >> bit) & 1));
}

// The body of every kernel of this design. DENSE: block j is key tile j,
// for the tiles below kv_valid = min(kv_len[b], skv); otherwise the
// attended entries of the group's list, keys past seqlens[b] masked.
template <bool DENSE, Epilogue EPI, KeyMask MASK = KeyMask::kAsNeeded,
          bool MATH = true, bool GATHER = true>
__device__ __forceinline__ void attn_mainloop(const CUtensorMap& tq,
                                              const CUtensorMap& tk,
                                              const CUtensorMap& tv,
                                              const Params& p) {
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  unsigned char* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  uint64_t* q_full = reinterpret_cast<uint64_t*>(smem + BAR_OFF);
  uint64_t* full = q_full + 1;           // [STAGES]
  uint64_t* empty = full + STAGES;       // [STAGES]
  int* stage_blk = reinterpret_cast<int*>(empty + STAGES);  // [STAGES]

  const int qb = blockIdx.x, bh = blockIdx.y;
  const int* list = nullptr;
  const int* memb = nullptr;
  int n_list, kv_valid;
  if (DENSE) {
    kv_valid = p.skv;
    if (p.kv_len != nullptr)
      kv_valid = max(0, min(p.kv_len[bh / p.heads], p.skv));
    n_list = (kv_valid + BN - 1) / BN;
  } else {
    const int grp = qb / p.q_rows;
    const size_t row_off = ((size_t)bh * p.ngroups + grp) * p.nkb;
    list = p.lists + row_off;
    if (p.members != nullptr) memb = p.members + row_off;
    n_list = p.counts[(size_t)bh * p.ngroups + grp];
    kv_valid = p.seqlens[bh / p.heads];
  }
  const int bit = DENSE ? 0 : qb % p.q_rows;

  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
#pragma unroll
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], CONSUMER_WARPS);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x < 128) {
    // ===== producer warpgroup: warp 0 walks the list, lane 0 issues =====
    regs_dealloc<40>();
    if (threadIdx.x >= 32) return;
    const int lane = threadIdx.x;
    if (lane == 0) {
      mbar_expect_tx(q_full, TILE_BYTES);
      tma_load(smem, &tq, q_full, 0, qb * BM, bh);
      tma_load(smem + BOX_BYTES, &tq, q_full, BOX_COLS, qb * BM, bh);
    }
    int j = 0;  // tiles issued
    auto issue = [&](int blk) {
      if (lane == 0) {
        const int s = j % STAGES;
        mbar_wait(&empty[s], ((j / STAGES) & 1) ^ 1);
        stage_blk[s] = blk;
        mbar_expect_tx(&full[s], STAGE_BYTES);
        unsigned char* ks = smem + KV_OFF + s * STAGE_BYTES;
        unsigned char* vs = ks + TILE_BYTES;
        tma_load(ks, &tk, &full[s], 0, blk * BN, bh);
        tma_load(ks + BOX_BYTES, &tk, &full[s], BOX_COLS, blk * BN, bh);
        tma_load(vs, &tv, &full[s], 0, blk * BN, bh);
        tma_load(vs + BOX_BYTES, &tv, &full[s], BOX_COLS, blk * BN, bh);
      }
      ++j;
    };
    if (DENSE) {
      const int n = GATHER ? n_list : min(n_list, 1);
      for (int b = 0; b < n; ++b) issue(b);
    } else {
      for (int base = 0; base < n_list; base += 32) {
        const int i = base + lane;
        const int blk = i < n_list ? list[i] : 0;
        unsigned ball = __ballot_sync(0xffffffffu,
                                      attended(memb, i, n_list, bit));
        while (ball != 0u && (GATHER || j == 0)) {
          const int src = __ffs(ball) - 1;
          ball &= ball - 1u;
          issue(__shfl_sync(0xffffffffu, blk, src));
        }
        if (!GATHER && j > 0) break;
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

    // n: the tiles this query block attends (the producer's count)
    int n = n_list;
    if (!DENSE && memb != nullptr) {
      n = 0;
      for (int base = 0; base < n_list; base += 32)
        n += __popc(__ballot_sync(0xffffffffu,
                                  attended(memb, base + lane, n_list, bit)));
    }
    const float scale2 = p.sm_scale * LOG2E;
    const bool video_row = !DENSE && qb < p.tsb;

    mbar_wait(q_full, 0);
    float m_row[2], l_row[2] = {0.f, 0.f};
    if (EPI == Epilogue::kFixedMax) {
      // ||q_r|| in f32 from the swizzled Q tile: the 4 threads of a row
      // take 32 columns each
      const float amp_pos = DENSE ? 0.f : fmaxf(p.text_amp, 0.f);
      const float mk = p.maxk[bh];
#pragma unroll
      for (int rr = 0; rr < 2; ++rr) {
        const int r = r0 + 8 * rr;
        float ss = 0.f;
#pragma unroll
        for (int c4 = 0; c4 < 4; ++c4) {
          const int c = 4 * t + c4;  // 16-byte chunk of the row, 0..15
          const uint4 raw = *reinterpret_cast<const uint4*>(
              smem + (c / 8) * BOX_BYTES + r * 128 + (((c % 8) ^ (r % 8)) * 16));
          const __nv_bfloat162* h2 =
              reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const float2 f = __bfloat1622float2(h2[e]);
            ss += f.x * f.x + f.y * f.y;
          }
        }
        ss += __shfl_xor_sync(0xffffffffu, ss, 1);
        ss += __shfl_xor_sync(0xffffffffu, ss, 2);
        m_row[rr] = sqrtf(ss) * scale2 * mk + amp_pos - 63.f;
      }
    } else if (EPI == Epilogue::kConstMax) {
      m_row[0] = m_row[1] = CONST_MAX;
    } else {
      m_row[0] = m_row[1] = -INFINITY;
    }

    float o[64];
#pragma unroll
    for (int i = 0; i < 64; ++i) o[i] = 0.f;
    const unsigned char* q_rows_smem = smem + cw * 64 * 128;

    for (int j = 0; j < n; ++j) {
      const int s = GATHER ? j % STAGES : 0;
      if (GATHER || j == 0) mbar_wait(&full[s], GATHER ? (j / STAGES) & 1 : 0);
      if (MATH) {
        const int blk = stage_blk[s];
        const unsigned char* ks = smem + KV_OFF + s * STAGE_BYTES;
        const unsigned char* vs = ks + TILE_BYTES;

        // S = Q K^T, 8 k-steps of 16 dims: 4 in each 64-column box
        float sc[64];
        wg_fence();
#pragma unroll
        for (int kk = 0; kk < D / 16; ++kk) {
          const uint32_t off = (kk / 4) * BOX_BYTES + (kk % 4) * 32;
          wgmma_ss(sc, sw128_desc(q_rows_smem + off, 16, 1024),
                   sw128_desc(ks + off, 16, 1024), kk > 0);
        }
        wg_commit();
        wg_wait<0>();
        reg_fence(sc);

        // P = exp2(S * scale2 + bias - m): element i of sc is row
        // r0 + 8 * ((i >> 1) & 1), key 8 * (i >> 2) + 2t + (i & 1)
        const float bias = (MASK != KeyMask::kNever && video_row &&
                            blk >= p.tsb) ? p.text_amp : 0.f;
        const bool need_mask =
            MASK == KeyMask::kAlways ||
            (MASK == KeyMask::kAsNeeded && (blk + 1) * BN > kv_valid);
        const int lim = kv_valid - blk * BN - 2 * t;  // key index bound
        if (EPI == Epilogue::kOnline) {
          float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
          for (int i = 0; i < 64; ++i) {
            float x = fmaf(sc[i], scale2, bias);
            if (need_mask && 8 * (i >> 2) + (i & 1) >= lim) x = -INFINITY;
            sc[i] = x;
            mx[(i >> 1) & 1] = fmaxf(mx[(i >> 1) & 1], x);
          }
#pragma unroll
          for (int rr = 0; rr < 2; ++rr) {
            mx[rr] = fmaxf(mx[rr], __shfl_xor_sync(0xffffffffu, mx[rr], 1));
            mx[rr] = fmaxf(mx[rr], __shfl_xor_sync(0xffffffffu, mx[rr], 2));
            const float m_new = fmaxf(m_row[rr], mx[rr]);
            // guarded while the row has seen no key: m stays -inf
            const float alpha =
                m_new == -INFINITY ? 1.f : ex2(m_row[rr] - m_new);
            m_row[rr] = m_new;
            mx[rr] = m_new == -INFINITY ? 0.f : m_new;  // the m to subtract
            l_row[rr] *= alpha;
#pragma unroll
            for (int i = 0; i < 64; ++i)
              if (((i >> 1) & 1) == rr) o[i] *= alpha;
          }
#pragma unroll
          for (int i = 0; i < 64; ++i) sc[i] = ex2(sc[i] - mx[(i >> 1) & 1]);
        } else {
          const float c0 = bias - m_row[0], c1 = bias - m_row[1];
          if (need_mask) {
#pragma unroll
            for (int i = 0; i < 64; ++i) {
              const float x = ex2(fmaf(sc[i], scale2, (i & 2) ? c1 : c0));
              sc[i] = 8 * (i >> 2) + (i & 1) >= lim ? 0.f : x;
            }
          } else {
#pragma unroll
            for (int i = 0; i < 64; ++i)
              sc[i] = ex2(fmaf(sc[i], scale2, (i & 2) ? c1 : c0));
          }
        }

        // row sums in f32; P as bf16 A-fragments, k-step kk = keys
        // 16kk..16kk+15 = accumulator n8-blocks 2kk and 2kk + 1
        uint32_t pa[8][4];
#pragma unroll
        for (int kk = 0; kk < 8; ++kk) {
          l_row[0] += sc[8 * kk] + sc[8 * kk + 1] + sc[8 * kk + 4] +
                      sc[8 * kk + 5];
          l_row[1] += sc[8 * kk + 2] + sc[8 * kk + 3] + sc[8 * kk + 6] +
                      sc[8 * kk + 7];
#pragma unroll
          for (int e = 0; e < 4; ++e)
            pa[kk][e] = pack_bf16(sc[8 * kk + 2 * e], sc[8 * kk + 2 * e + 1]);
        }

        // O += P V: V's k-step kk is keys 16kk..16kk+15 (2 KB into each
        // box); the two boxes (d 0-63, 64-127) are one lbo apart
        reg_fence(o);
        reg_fence(pa);
        wg_fence();
#pragma unroll
        for (int kk = 0; kk < 8; ++kk)
          wgmma_rs(o, pa[kk], sw128_desc(vs + kk * 16 * 128, BOX_BYTES, 1024));
        wg_commit();
        wg_wait<0>();
        reg_fence(o);
        reg_fence(pa);
      }
      if (GATHER) {
        __syncwarp();
        if (lane == 0) mbar_arrive(&empty[s]);
      }
    }

    // normalise and store this thread's two rows; a row with no key
    // (l = 0) stores zeros
    const int q_valid = DENSE ? min(BM, p.sq - qb * BM) : BM;
    __nv_bfloat16* out = p.o + ((size_t)bh * p.sq + (size_t)qb * BM) * D;
#pragma unroll
    for (int rr = 0; rr < 2; ++rr) {
      float l = l_row[rr];
      l += __shfl_xor_sync(0xffffffffu, l, 1);
      l += __shfl_xor_sync(0xffffffffu, l, 2);
      const int r = r0 + 8 * rr;
      if (r >= q_valid) continue;
      const float inv = l == 0.f ? 0.f : 1.f / l;
      if (DENSE && p.lse != nullptr && t == 0)
        p.lse[((size_t)bh * gridDim.x + qb) * BM + r] =
            l == 0.f ? INFINITY : m_row[rr] + log2f(l);
      __nv_bfloat16* orow = out + (size_t)r * D + 2 * t;
#pragma unroll
      for (int nb = 0; nb < 16; ++nb)
        *reinterpret_cast<__nv_bfloat162*>(orow + 8 * nb) =
            __floats2bfloat162_rn(o[4 * nb + 2 * rr] * inv,
                                  o[4 * nb + 2 * rr + 1] * inv);
    }
  }
}

// ---- host side --------------------------------------------------------------

using EncodeTiledFn = CUresult (*)(CUtensorMap*, CUtensorMapDataType,
                                   cuuint32_t, void*, const cuuint64_t*,
                                   const cuuint64_t*, const cuuint32_t*,
                                   const cuuint32_t*, CUtensorMapInterleave,
                                   CUtensorMapSwizzle, CUtensorMapL2promotion,
                                   CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled through the runtime's driver entry point, so the
// library links no libcuda.
inline EncodeTiledFn encode_tiled() {
  static const EncodeTiledFn fn = [] {
    void* ptr = nullptr;
    cudaDriverEntryPointQueryResult res;
#if CUDART_VERSION >= 12050
    cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &ptr, 12000, cudaEnableDefault, &res);
#else
    cudaError_t err = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &ptr,
                                              cudaEnableDefault, &res);
#endif
    return (err == cudaSuccess && res == cudaDriverEntryPointSuccess)
               ? reinterpret_cast<EncodeTiledFn>(ptr)
               : nullptr;
  }();
  return fn;
}

// A 3-D map over bf16 [bh, rows, D] with box_rows x 64 boxes, 128-byte
// swizzle; rows past `rows` read as zeros.
inline bool make_map(CUtensorMap* map, const void* base, int bh, int rows,
                     int box_rows = BN) {
  const EncodeTiledFn fn = encode_tiled();
  if (fn == nullptr) return false;
  const cuuint64_t dims[3] = {(cuuint64_t)D, (cuuint64_t)rows,
                              (cuuint64_t)bh};
  const cuuint64_t strides[2] = {(cuuint64_t)D * 2,
                                 (cuuint64_t)rows * D * 2};
  const cuuint32_t box[3] = {BOX_COLS, (cuuint32_t)box_rows, 1};
  const cuuint32_t elem[3] = {1, 1, 1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, const_cast<void*>(base),
            dims, strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
            CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// Build the maps of q [bh, p.sq, D] and k, v [bh, skv, D] and launch
// `kernel` on a (query blocks, bh) grid on `stream`. Returns
// cudaGetLastError(), or cudaErrorInvalidValue if a map cannot be built.
template <class Kernel>
int attn_launch(Kernel kernel, const void* q, const void* k, const void* v,
                const Params& p, int bh, int nqb, void* stream) {
  CUtensorMap tq, tk, tv;
  if (!make_map(&tq, q, bh, p.sq) || !make_map(&tk, k, bh, p.skv) ||
      !make_map(&tv, v, bh, p.skv))
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)SMEM_BYTES);
  if (err != cudaSuccess) return (int)err;
  kernel<<<dim3(nqb, bh), THREADS, SMEM_BYTES,
           static_cast<cudaStream_t>(stream)>>>(tq, tk, tv, p);
  return (int)cudaGetLastError();
}

// The block-sparse kernel (K1, K1m, K2 and the probes P1/P2).
template <Epilogue EPI, KeyMask MASK = KeyMask::kAsNeeded, bool MATH = true,
          bool GATHER = true>
__global__ void __launch_bounds__(THREADS, 1)
    bsa_kernel(const __grid_constant__ CUtensorMap tq,
               const __grid_constant__ CUtensorMap tk,
               const __grid_constant__ CUtensorMap tv, const Params p) {
  attn_mainloop<false, EPI, MASK, MATH, GATHER>(tq, tk, tv, p);
}

// Launch one block-sparse instance (the bsa_forward argument list).
template <Epilogue EPI, KeyMask MASK = KeyMask::kAsNeeded, bool MATH = true,
          bool GATHER = true>
int bsa_launch(const void* q, const void* k, const void* v, void* o,
               const void* lists, const void* counts, const void* members,
               const void* seqlens, const void* maxk, int bh, int heads,
               int s, int skv, int nkb, int ngroups, int q_rows, int tsb,
               float sm_scale, float text_amp, void* stream) {
  Params p{};
  p.o = static_cast<__nv_bfloat16*>(o);
  p.lists = static_cast<const int*>(lists);
  p.counts = static_cast<const int*>(counts);
  p.members = static_cast<const int*>(members);
  p.seqlens = static_cast<const int*>(seqlens);
  p.maxk = static_cast<const float*>(maxk);
  p.heads = heads;
  p.sq = s;
  p.skv = skv;
  p.nkb = nkb;
  p.ngroups = ngroups;
  p.q_rows = q_rows;
  p.tsb = tsb;
  p.sm_scale = sm_scale;
  p.text_amp = text_amp;
  return attn_launch(bsa_kernel<EPI, MASK, MATH, GATHER>, q, k, v, p, bh,
                     s / BM, stream);
}

}  // namespace sm90

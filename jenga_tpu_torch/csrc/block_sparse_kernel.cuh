// The block-sparse attention kernel's loop, shared by the production
// library (block_sparse_attn.cu, which documents the math and the design)
// and the probe library (attn_probe.cu). The template switches pick the
// epilogue, the masking, whether the tile math runs and whether the K|V
// ring gathers each listed block; the defaults with kFixedMax or kOnline
// are the production kernels.

#pragma once

#include "attn_tile.cuh"

namespace attn {

// How the row max m of the exp2(s - m) epilogue is set.
enum class Epilogue {
  kOnline,    // the running row max
  kFixedMax,  // the per-row Cauchy-Schwarz bound (the production default)
  kConstMax,  // the constant CONST_MAX (a probe floor: no max at all)
};
constexpr float CONST_MAX = 20.f;

// Q tile, the K|V ring and the per-row norms; membership mode adds nkb
// ints for the compacted list.
constexpr size_t BSA_SMEM_BYTES =
    (Q_ELEMS + (size_t)STAGES * 2 * KV_ELEMS) * sizeof(__nv_bfloat16)
    + BM * sizeof(float);
constexpr size_t SMEM_LIMIT = 232448;  // 227 KB per block on sm_90

// GATHER = false is the compute-only probe: the group's first listed block
// is loaded once and the tile math runs `n` times over it.
template <Epilogue EPI, KeyMask MASK = KeyMask::kAsNeeded, bool MATH = true,
          bool GATHER = true>
__global__ void __launch_bounds__(THREADS, 1)
bsa_kernel(const __nv_bfloat16* __restrict__ q,
           const __nv_bfloat16* __restrict__ k,
           const __nv_bfloat16* __restrict__ v,
           __nv_bfloat16* __restrict__ o,
           const int* __restrict__ lists,     // [BH, ngroups, nkb]
           const int* __restrict__ counts,    // [BH, ngroups]
           const int* __restrict__ members,   // [BH, ngroups, nkb] or null
           const int* __restrict__ seqlens,   // [B]
           const float* __restrict__ maxk,    // [BH]
           int heads, int s, int skv, int nkb, int ngroups, int q_rows,
           int tsb, float sm_scale, float text_amp) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* sq = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* skv_base = sq + Q_ELEMS;  // [STAGES][K|V][BN][LDS]
  float* qnorm = reinterpret_cast<float*>(skv_base + STAGES * 2 * KV_ELEMS);
  int* own = reinterpret_cast<int*>(qnorm + BM);  // [nkb] member block ids
  __shared__ int own_n;

  const int qb = blockIdx.x;  // query block (128 rows)
  const int bh = blockIdx.y;
  const int grp = qb / q_rows;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane >> 2, t = lane & 3;  // mma fragment coordinates

  const size_t head_off = (size_t)bh * s * D;
  const size_t kv_off = (size_t)bh * skv * D;
  const size_t row_off = ((size_t)bh * ngroups + grp) * nkb;
  const int* list = lists + row_off;
  int n = counts[(size_t)bh * ngroups + grp];
  const int seqlen = seqlens[bh / heads];
  const bool video_row = qb < tsb;
  const float scale2 = sm_scale * LOG2E;

  auto k_stage = [&](int st) { return skv_base + (size_t)st * 2 * KV_ELEMS; };
  auto v_stage = [&](int st) { return k_stage(st) + KV_ELEMS; };

  load_tile(sq, q + head_off + (size_t)qb * BM * D, BM);
  if (members != nullptr) {
    // keep the listed blocks whose bit for this tile is set, in list order
    // (the Q copy above is in flight meanwhile)
    if (warp == 0) {
      const int* memb = members + row_off;
      const int bit = qb % q_rows;
      int m = 0;
      for (int base = 0; base < n; base += 32) {
        const int j = base + lane;
        const bool in = j < n && ((memb[j] >> bit) & 1);
        const unsigned ball = __ballot_sync(0xffffffffu, in);
        if (in) own[m + __popc(ball & ((1u << lane) - 1u))] = list[j];
        m += __popc(ball);
      }
      if (lane == 0) own_n = m;
    }
    __syncthreads();
    list = own;
    n = own_n;
  }
  if (n > 0) {
    const size_t blk0 = (size_t)list[0] * BN * D;
    load_tile(k_stage(0), k + kv_off + blk0, BN);
    load_tile(v_stage(0), v + kv_off + blk0, BN);
  }
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();

  const int r0 = warp * 16 + g;  // this thread's two rows: r0, r0 + 8
  const QSmem qf{sq, r0, t};
  float m_row[2], l_row[2] = {0.f, 0.f};
  float acc[D / 8][4];
#pragma unroll
  for (int i = 0; i < D / 8; ++i)
    acc[i][0] = acc[i][1] = acc[i][2] = acc[i][3] = 0.f;

  if (EPI == Epilogue::kFixedMax) {
    // ||q_r|| in f32: two threads per row, 64 dims each
    const int r = threadIdx.x >> 1, half = threadIdx.x & 1;
    float ss = 0.f;
    for (int c = half * 64; c < half * 64 + 64; ++c) {
      float x = __bfloat162float(sq[r * LDS + c]);
      ss += x * x;
    }
    ss += __shfl_xor_sync(0xffffffffu, ss, 1);
    if (half == 0) qnorm[r] = sqrtf(ss);
    __syncthreads();
    const float amp_pos = fmaxf(text_amp, 0.f);
    m_row[0] = qnorm[r0] * scale2 * maxk[bh] + amp_pos - 63.f;
    m_row[1] = qnorm[r0 + 8] * scale2 * maxk[bh] + amp_pos - 63.f;
  } else if (EPI == Epilogue::kConstMax) {
    m_row[0] = m_row[1] = CONST_MAX;
  } else {
    m_row[0] = m_row[1] = -INFINITY;
  }

  for (int j = 0; j < n; ++j) {
    const int st = GATHER ? j % STAGES : 0;
    if (GATHER) {
      if (j + 1 < n) {
        const size_t nb = (size_t)list[j + 1] * BN * D;
        load_tile(k_stage((j + 1) % STAGES), k + kv_off + nb, BN);
        load_tile(v_stage((j + 1) % STAGES), v + kv_off + nb, BN);
        cp_async_commit();
        cp_async_wait<1>();
      } else {
        cp_async_wait<0>();
      }
      __syncthreads();
    }

    const int blk = list[GATHER ? j : 0];
    const float bias = (video_row && blk >= tsb) ? text_amp : 0.f;
    attend_tile<EPI == Epilogue::kOnline, MASK, MATH>(
        qf, k_stage(st), v_stage(st), g, t, scale2, bias, blk * BN,
        (blk + 1) * BN > seqlen, seqlen, m_row, l_row, acc);
    if (GATHER) __syncthreads();  // stage st is refilled two iterations on
  }

  store_rows(o + head_off + (size_t)qb * BM * D, r0, t, BM, l_row, acc);
}

// Launch one instance on `stream`; returns cudaGetLastError(), or
// cudaErrorInvalidValue when the shared memory would pass 227 KB.
template <Epilogue EPI, KeyMask MASK = KeyMask::kAsNeeded, bool MATH = true,
          bool GATHER = true>
int bsa_launch(const void* q, const void* k, const void* v, void* o,
               const void* lists, const void* counts, const void* members,
               const void* seqlens, const void* maxk, int bh, int heads,
               int s, int skv, int nkb, int ngroups, int q_rows, int tsb,
               float sm_scale, float text_amp, void* stream) {
  auto kern = bsa_kernel<EPI, MASK, MATH, GATHER>;
  const size_t smem =
      BSA_SMEM_BYTES + (members != nullptr ? (size_t)nkb * sizeof(int) : 0);
  if (smem + sizeof(int) > SMEM_LIMIT) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid(s / BM, bh);
  kern<<<grid, THREADS, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<__nv_bfloat16*>(o),
      static_cast<const int*>(lists), static_cast<const int*>(counts),
      static_cast<const int*>(members), static_cast<const int*>(seqlens),
      static_cast<const float*>(maxk), heads, s, skv, nkb, ngroups, q_rows,
      tsb, sm_scale, text_amp);
  return (int)cudaGetLastError();
}

}  // namespace attn

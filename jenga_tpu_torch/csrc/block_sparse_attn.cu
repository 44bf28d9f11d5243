// Block-sparse attention over per-group KV block lists, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernels of jenga_tpu/ops/block_sparse_attention.py:
//   * K1 `_kernel_grouped` in its all-member (joint-selection) mode, reached
//     via `block_sparse_attention_grouped` / `grouped_attention_from_mask`;
//   * K1m, the same kernel with `all_member=False`: the group's list is the
//     union of its rows' selections and a membership word per listed block
//     says which rows (bit r = row r of the group) selected it;
//   * K2 `_kernel`, reached via `block_sparse_attention` (per-row lists).
// One launch serves all three: each 128-row query tile reads the list of
// its group, `group = query_block / q_rows` (q_rows = 1 is K2). Without
// membership words every row of the group attends the whole list; with
// them (q_rows <= 8) a tile attends only the listed blocks whose bit
// `query_block % q_rows` is set.
//
// Math (per query row i, over the attended 128-key blocks only):
//   s_ij = (q_i . k_j) * sm_scale * log2(e)
//          + text_amp   if row i is a video row and block(j) >= tsb
//   s_ij = -inf         if key j >= seqlen[batch]
//   o_i  = sum_j exp2(s_ij - m_i) v_j / sum_j exp2(s_ij - m_i), 0 if empty
// with m_i the per-row Cauchy-Schwarz bound
//   sm_scale*log2(e)*||q_i||*max_j||k_j|| + max(text_amp, 0) - 63
// (FIXED_MAX, the default, as on the TPU) or the running row max (the
// classic online softmax).
//
// What bounds it on the card: at the main path's density (Jenga-Base,
// ~25-35% of the key blocks per row) each 128x128 tile of S costs 4 MFLOP
// of tensor-core work against 64 KB of K|V gathered, ~64 FLOP/byte if
// nothing were reused: below the H100's ~295 FLOP/byte ridge, so the
// gather is the limit. The design answers with reuse rather than with
// Mosaic's DMA machinery: a whole 128-row query block shares one K|V tile
// in shared memory (8 warps x 16 rows), the q_rows=8 joint groups give the
// 8 tiles of a group one identical list so their gathers hit L2, and a
// 2-stage cp.async ring fetches block j+1 while block j computes. The
// matrix products are mma.sync m16n8k16 bf16 with f32 accumulators held
// in registers (wgmma and TMA are left for a later revision); the tile
// loop body is shared with the dense kernel (attn_tile.cuh).
//
// Membership mode keeps one thread block per query block: the block first
// compacts the ids of its own member blocks, in list order, into shared
// memory (a warp ballot per 32 list entries), then runs the same ring over
// that list, so the prefetch always fetches the next member block and no
// block is gathered that the tile does not use. Each tile thus gathers
// exactly its own selection, as K2 does; the TPU's saving, one DMA per
// union block for 8 rows, has its counterpart here only in L2 hits between
// the 8 tiles of a group that run side by side.
//
// Plain C interface (loaded with ctypes); the launch goes on the caller's
// stream and the function returns cudaGetLastError().

#include "attn_tile.cuh"

namespace {

using namespace attn;

// Q tile, the K|V ring and the per-row norms; membership mode adds nkb
// ints for the compacted list.
constexpr size_t SMEM_BYTES =
    (Q_ELEMS + (size_t)STAGES * 2 * KV_ELEMS) * sizeof(__nv_bfloat16)
    + BM * sizeof(float);
constexpr size_t SMEM_LIMIT = 232448;  // 227 KB per block on sm_90

template <bool FIXED_MAX>
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
  float m_row[2], l_row[2] = {0.f, 0.f};
  float acc[D / 8][4];
#pragma unroll
  for (int i = 0; i < D / 8; ++i)
    acc[i][0] = acc[i][1] = acc[i][2] = acc[i][3] = 0.f;

  if (FIXED_MAX) {
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
  } else {
    m_row[0] = m_row[1] = -INFINITY;
  }

  for (int j = 0; j < n; ++j) {
    const int st = j % STAGES;
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

    const int blk = list[j];
    const float bias = (video_row && blk >= tsb) ? text_amp : 0.f;
    attend_tile<!FIXED_MAX>(sq, k_stage(st), v_stage(st), r0, g, t, scale2,
                            bias, blk * BN, (blk + 1) * BN > seqlen, seqlen,
                            m_row, l_row, acc);
    __syncthreads();  // stage st is refilled two iterations on
  }

  store_rows(o + head_off + (size_t)qb * BM * D, r0, t, BM, l_row, acc);
}

}  // namespace

// `members` null: every row of a group attends its whole list (K1, K2).
extern "C" int bsa_forward(const void* q, const void* k, const void* v,
                           void* o, const void* lists, const void* counts,
                           const void* members, const void* seqlens,
                           const void* maxk, int bh, int heads, int s,
                           int skv, int nkb, int ngroups, int q_rows, int tsb,
                           float sm_scale, float text_amp, int fixed_max,
                           void* stream) {
  auto kern = fixed_max ? bsa_kernel<true> : bsa_kernel<false>;
  const size_t smem =
      SMEM_BYTES + (members != nullptr ? (size_t)nkb * sizeof(int) : 0);
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

extern "C" const char* bsa_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

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
// body is shared with the dense kernel (attn_tile.cuh), and the loop with
// the probe kernels (block_sparse_kernel.cuh).
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

#include "block_sparse_kernel.cuh"

using namespace attn;

// `members` null: every row of a group attends its whole list (K1, K2).
extern "C" int bsa_forward(const void* q, const void* k, const void* v,
                           void* o, const void* lists, const void* counts,
                           const void* members, const void* seqlens,
                           const void* maxk, int bh, int heads, int s,
                           int skv, int nkb, int ngroups, int q_rows, int tsb,
                           float sm_scale, float text_amp, int fixed_max,
                           void* stream) {
  if (fixed_max)
    return bsa_launch<Epilogue::kFixedMax>(
        q, k, v, o, lists, counts, members, seqlens, maxk, bh, heads, s, skv,
        nkb, ngroups, q_rows, tsb, sm_scale, text_amp, stream);
  return bsa_launch<Epilogue::kOnline>(
      q, k, v, o, lists, counts, members, seqlens, maxk, bh, heads, s, skv,
      nkb, ngroups, q_rows, tsb, sm_scale, text_amp, stream);
}

extern "C" const char* bsa_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

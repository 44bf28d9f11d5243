// Block-sparse attention over per-group KV block lists, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernels of jenga_tpu/ops/block_sparse_attention.py:
//   * K1 `_kernel_grouped` (:409) in its all-member (joint-selection) mode,
//     reached via `block_sparse_attention_grouped` (:692) /
//     `grouped_attention_from_mask`;
//   * K1m, the same kernel with `all_member=False`: the group's list is the
//     union of its rows' selections and a membership word per listed block
//     says which rows (bit r = row r of the group) selected it;
//   * K2 `_kernel` (:49), reached via `block_sparse_attention` (:284,
//     per-row lists).
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
// The kernel is the block-sparse instance of the Hopper mainloop in
// attn_sm90.cuh, which states what bounds it (the tensor cores: 4.36 ms
// for the 4.31 TFLOP of the HunyuanVideo main shape) and its design: a TMA
// producer warp walks the tile's list (in membership mode it keeps, with a
// warp ballot per 32 entries, only the tile's own member blocks, in list
// order) and feeds a 2-stage mbarrier ring of K|V tiles; two consumer
// warpgroups of 64 query rows run QK^T and PV on wgmma. The q_rows = 8
// joint groups give the 8 tiles of a group one identical list, so their
// gathers hit L2; in membership mode each tile gathers exactly its own
// selection, as K2 does.
//
// Plain C interface (loaded with ctypes); the launch goes on the caller's
// stream and the function returns cudaGetLastError().

#include "attn_sm90.cuh"

using namespace sm90;

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

// Dense non-causal attention with per-sample key lengths, for Hopper
// (sm_90a).
//
// Replaces the stock Pallas TPU flash-attention kernel that
// jenga_tpu/ops/flash_attention.py:73 (`dense_attention`, `pl_flash` :92)
// calls on the TPU. The model reaches it for Wan's cross-attention over 512
// text keys, Wan's dense self-attention warm-up steps (32,768 tokens at
// 832x480x81f) and HunyuanVideo's dense arm (the joint sequence with
// `kv_len`).
//
// Math (per query row i of one (batch, head)):
//   s_ij = (q_i . k_j) * sm_scale * log2(e),  j < min(kv_len[b], Skv)
//   o_i  = sum_j exp2(s_ij - m_i) v_j / sum_j exp2(s_ij - m_i)
// with m_i the running row max (online softmax, starting at -inf and
// guarded); a row with no valid key (kv_len <= 0) stores zeros, not NaN.
//
// What bounds it on the card: at 32k keys a 128x128 tile costs 8.4 MFLOP
// of tensor-core work per 64 KB K|V tile, and each K|V tile is read by all
// 256 query tiles of its head, so the reads come from L2 and the tensor
// cores are the limit (13.3 ms at Wan's self-attention); at 512 keys a
// query tile does 34 MFLOP against its own 64 KB of Q and O, ~500
// FLOP/byte, above the card's ~295 ridge. The kernel is the dense instance
// of the Hopper mainloop in attn_sm90.cuh (a TMA producer warp, a 2-stage
// mbarrier ring, two wgmma consumer warpgroups): block j is key tile j for
// the ceil(kv_valid / 128) tiles below kv_valid = min(kv_len[b], Skv), the
// online epilogue, no bias. Ragged edges: the 3-D tensor maps zero-fill
// query rows past Sq (not stored) and key rows past Skv (masked with the
// keys past kv_len), never reading the next head's rows.
//
// For the backward (dense_attn_bwd.cu) it also stores each row's
// log-sum-exp in the units of its exp2: lse_i = m_i + log2(l_i), +inf for
// a row with no valid key, into `lse` [bh, ceil(Sq / 128) * 128] when that
// pointer is not null (the residuals of the stock kernel's
// `_flash_attention_fwd`, flash_attention.py:234, which keeps l and m
// apart). Serving passes null and stores nothing more.
//
// Plain C interface (loaded with ctypes); the launch goes on the caller's
// stream and the function returns cudaGetLastError().

#include "attn_sm90.cuh"

using namespace sm90;

__global__ void __launch_bounds__(THREADS, 1)
    dense_kernel(const __grid_constant__ CUtensorMap tq,
                 const __grid_constant__ CUtensorMap tk,
                 const __grid_constant__ CUtensorMap tv, const Params p) {
  attn_mainloop<true, Epilogue::kOnline>(tq, tk, tv, p);
}

extern "C" int dense_attn_forward(const void* q, const void* k,
                                  const void* v, void* o, const void* kv_len,
                                  void* lse, int bh, int heads, int sq,
                                  int skv, float sm_scale, void* stream) {
  Params p{};
  p.o = static_cast<__nv_bfloat16*>(o);
  p.kv_len = static_cast<const int*>(kv_len);
  p.lse = static_cast<float*>(lse);
  p.heads = heads;
  p.sq = sq;
  p.skv = skv;
  p.sm_scale = sm_scale;
  return attn_launch(dense_kernel, q, k, v, p, bh, (sq + BM - 1) / BM,
                     stream);
}

extern "C" const char* dense_attn_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// Dense non-causal attention with per-sample key lengths, for Hopper
// (sm_90a).
//
// Replaces the stock Pallas TPU flash-attention kernel that
// jenga_tpu/ops/flash_attention.py:73 (`dense_attention`) calls on the TPU.
// The model reaches it for Wan's cross-attention over 512 text keys, Wan's
// dense self-attention warm-up steps (32,768 tokens at 832x480x81f) and
// HunyuanVideo's dense arm (the joint sequence with `kv_len`).
//
// Math (per query row i of one (batch, head)):
//   s_ij = (q_i . k_j) * sm_scale * log2(e),  j < min(kv_len[b], Skv)
//   o_i  = sum_j exp2(s_ij - m_i) v_j / sum_j exp2(s_ij - m_i)
// with m_i the running row max (online softmax, starting at -inf and
// guarded); a row with no valid key (kv_len <= 0) stores zeros, not NaN.
//
// What bounds it on the card: at 32k keys a 128x128 tile of S costs
// 4 MFLOP of tensor-core work per 64 KB K|V tile, and each K|V tile is
// read by all 256 query tiles of its head, so the reads come from L2 and
// the tensor cores are the limit; at 512 keys a query tile does 16 MFLOP
// against its own 64 KB of Q and O, ~256 FLOP/byte, near the card's ~295
// ridge, so both bounds are close. The design is the block-sparse
// kernel's, without lists: one thread block per (b*h, 128-row query
// tile), 8 warps x 16 rows, a 2-stage cp.async ring over 128-key tiles,
// mma.sync m16n8k16 bf16 with f32 accumulators (the tile body is shared,
// attn_tile.cuh). Ragged edges: query rows past Sq are
// zero-loaded and not stored; key rows past Skv are zero-filled and masked
// with the keys past kv_len. Only the tiles below kv_len are visited.
//
// Plain C interface (loaded with ctypes); the launch goes on the caller's
// stream and the function returns cudaGetLastError().

#include "attn_tile.cuh"

namespace {

using namespace attn;

constexpr size_t SMEM_BYTES =
    (Q_ELEMS + (size_t)STAGES * 2 * KV_ELEMS) * sizeof(__nv_bfloat16);

__global__ void __launch_bounds__(THREADS, 1)
dense_kernel(const __nv_bfloat16* __restrict__ q,
             const __nv_bfloat16* __restrict__ k,
             const __nv_bfloat16* __restrict__ v,
             __nv_bfloat16* __restrict__ o,
             const int* __restrict__ kv_len,  // [B], or null: all Skv keys
             int heads, int sq, int skv, float sm_scale) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* sq_s = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* kv_base = sq_s + Q_ELEMS;  // [STAGES][K|V][BN][LDS]

  const int row0 = blockIdx.x * BM;
  const int bh = blockIdx.y;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane >> 2, t = lane & 3;  // mma fragment coordinates

  const size_t q_off = ((size_t)bh * sq + row0) * D;
  const size_t kv_off = (size_t)bh * skv * D;
  const int q_valid = min(BM, sq - row0);
  int kv_valid = skv;
  if (kv_len != nullptr) kv_valid = max(0, min(kv_len[bh / heads], skv));
  const int n = (kv_valid + BN - 1) / BN;
  const float scale2 = sm_scale * LOG2E;

  auto k_stage = [&](int st) { return kv_base + (size_t)st * 2 * KV_ELEMS; };
  auto v_stage = [&](int st) { return k_stage(st) + KV_ELEMS; };

  load_tile(sq_s, q + q_off, q_valid);
  if (n > 0) {
    load_tile(k_stage(0), k + kv_off, min(BN, skv));
    load_tile(v_stage(0), v + kv_off, min(BN, skv));
  }
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();

  const int r0 = warp * 16 + g;  // this thread's two rows: r0, r0 + 8
  float m_row[2] = {-INFINITY, -INFINITY}, l_row[2] = {0.f, 0.f};
  float acc[D / 8][4];
#pragma unroll
  for (int i = 0; i < D / 8; ++i)
    acc[i][0] = acc[i][1] = acc[i][2] = acc[i][3] = 0.f;

  for (int j = 0; j < n; ++j) {
    const int st = j % STAGES;
    if (j + 1 < n) {
      const int key1 = (j + 1) * BN;
      const size_t nb = kv_off + (size_t)key1 * D;
      load_tile(k_stage((j + 1) % STAGES), k + nb, min(BN, skv - key1));
      load_tile(v_stage((j + 1) % STAGES), v + nb, min(BN, skv - key1));
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();

    attend_tile<true>(QSmem{sq_s, r0, t}, k_stage(st), v_stage(st), g, t,
                      scale2, 0.f, j * BN, (j + 1) * BN > kv_valid, kv_valid,
                      m_row, l_row, acc);
    __syncthreads();  // stage st is refilled two iterations on
  }

  store_rows(o + q_off, r0, t, q_valid, l_row, acc);
}

}  // namespace

extern "C" int dense_attn_forward(const void* q, const void* k,
                                  const void* v, void* o, const void* kv_len,
                                  int bh, int heads, int sq, int skv,
                                  float sm_scale, void* stream) {
  cudaError_t err = cudaFuncSetAttribute(
      dense_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)SMEM_BYTES);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((sq + BM - 1) / BM, bh);
  dense_kernel<<<grid, THREADS, SMEM_BYTES,
                 static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<__nv_bfloat16*>(o),
      static_cast<const int*>(kv_len), heads, sq, skv, sm_scale);
  return (int)cudaGetLastError();
}

extern "C" const char* dense_attn_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

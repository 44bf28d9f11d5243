// Resident-KV cross-attention over 512 keys, for Hopper (sm_90a): probe
// kernel P4.
//
// Replaces the Pallas TPU probe `cross_resident`
// (tools/wan_overhead_probe2.py:122, body `_xkernel` :105): Wan's
// cross-attention, every query row attending all 512 text keys of its
// (batch, head), with no kv_len and no mask. No main path launches it; the
// port's probe times it against kernel D (dense_attn.cu) on the same
// operands.
//
// Math (per query row i): s_ij = (q_i . k_j) * sm_scale * log2(e),
// o_i = sum_j exp2(s_ij - m_i) v_j / sum_j exp2(s_ij - m_i) over j < 512,
// the exact softmax (m_i the running row max over the four 128-key tiles;
// the shared tile body of attn_tile.cuh with its key mask switched off).
//
// Shared memory layout (the trap: K|V for 512 keys is 262,144 B, over the
// 232,448 B a thread block may have):
//   K resident, 512 rows x (D + 8) bf16 ........ 139,264 B
//   V ring, 2 stages x 128 rows x (D + 8) bf16 .  69,632 B
//   total ........................................ 208,896 B
// Q is not staged: each warp loads its 16 rows' mma A-fragments from
// global memory straight into registers (32 registers a thread), once per
// query tile.
//
// What bounds it on the card: a 128-row query tile does 4 x 128 x 512 x
// 128 x 2 = 67 MFLOP of tensor-core work against 64 KB of Q read and O
// written, ~1,000 FLOP/byte, so the tensor cores (989 TFLOP/s bf16) are
// the limit, not the 3.35 TB/s. "Resident" is what the design adds to
// kernel D: a thread block stays on one (b*h) across bq / 128 query tiles
// and loads K once for them, instead of once per query tile; V streams
// through the 2-stage cp.async ring from L2 (128 KB per head).
//
// Plain C interface (loaded with ctypes); the launch goes on the caller's
// stream and the function returns cudaGetLastError().

#include "attn_tile.cuh"

namespace {

using namespace attn;

constexpr int NKEYS = 512;
constexpr int NKT = NKEYS / BN;  // key tiles
constexpr size_t K_ELEMS = (size_t)NKEYS * LDS;
constexpr size_t SMEM_BYTES =
    (K_ELEMS + (size_t)STAGES * KV_ELEMS) * sizeof(__nv_bfloat16);
static_assert(SMEM_BYTES == 208896, "the layout written above");
static_assert(SMEM_BYTES <= 232448, "227 KB per block on sm_90");

// This thread's A-fragments of query rows r and r + 8 of the tile at
// `qt` (row stride D); rows >= valid are zeros.
__device__ __forceinline__ void load_qfrag(QRegs& qf,
                                           const __nv_bfloat16* qt, int r,
                                           int t, int valid) {
  const bool lo = r < valid, hi = r + 8 < valid;
  const unsigned* p0 = reinterpret_cast<const unsigned*>(qt + (size_t)r * D);
  const unsigned* p1 = p0 + 4 * D;  // row r + 8, in 32-bit words
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    const int w = kk * 8 + t;  // word of columns kk * 16 + 2t, + 1
    qf.f[kk][0] = lo ? __ldg(p0 + w) : 0u;
    qf.f[kk][1] = hi ? __ldg(p1 + w) : 0u;
    qf.f[kk][2] = lo ? __ldg(p0 + w + 4) : 0u;
    qf.f[kk][3] = hi ? __ldg(p1 + w + 4) : 0u;
  }
}

__global__ void __launch_bounds__(THREADS, 1)
xattn_kernel(const __nv_bfloat16* __restrict__ q,
             const __nv_bfloat16* __restrict__ k,
             const __nv_bfloat16* __restrict__ v,
             __nv_bfloat16* __restrict__ o, int sq, int tiles_per_block,
             float sm_scale) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* ks = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* vring = ks + K_ELEMS;  // [STAGES][BN][LDS]

  const int bh = blockIdx.y;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane >> 2, t = lane & 3;  // mma fragment coordinates
  const int r0 = warp * 16 + g;           // this thread's rows r0, r0 + 8
  const int tile0 = blockIdx.x * tiles_per_block;
  const int tile1 = min(tile0 + tiles_per_block, (sq + BM - 1) / BM);
  const int n = (tile1 - tile0) * NKT;    // (query tile, key tile) steps
  const size_t q_off = (size_t)bh * sq * D;
  const size_t kv_off = (size_t)bh * NKEYS * D;
  const float scale2 = sm_scale * LOG2E;

  // K for all 512 keys and the first V tile, one commit group
  for (int kt = 0; kt < NKT; ++kt)
    load_tile(ks + (size_t)kt * KV_ELEMS, k + kv_off + (size_t)kt * BN * D,
              BN);
  load_tile(vring, v + kv_off, BN);
  cp_async_commit();

  QRegs qf;
  float m_row[2], l_row[2];
  float acc[D / 8][4];
  for (int j = 0; j < n; ++j) {
    const int qt = tile0 + j / NKT, kt = j % NKT;
    const int row0 = qt * BM;
    if (kt == 0) {
      load_qfrag(qf, q + q_off + (size_t)row0 * D, r0, t, sq - row0);
      m_row[0] = m_row[1] = -INFINITY;
      l_row[0] = l_row[1] = 0.f;
#pragma unroll
      for (int i = 0; i < D / 8; ++i)
        acc[i][0] = acc[i][1] = acc[i][2] = acc[i][3] = 0.f;
    }
    if (j + 1 < n) {
      load_tile(vring + (size_t)((j + 1) % STAGES) * KV_ELEMS,
                v + kv_off + (size_t)((j + 1) % NKT) * BN * D, BN);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();

    attend_tile<true, KeyMask::kNever>(
        qf, ks + (size_t)kt * KV_ELEMS, vring + (size_t)(j % STAGES) * KV_ELEMS,
        g, t, scale2, 0.f, 0, false, NKEYS, m_row, l_row, acc);
    __syncthreads();  // stage j % STAGES is refilled two steps on

    if (kt == NKT - 1)
      store_rows(o + q_off + (size_t)row0 * D, r0, t, min(BM, sq - row0),
                 l_row, acc);
  }
}

}  // namespace

extern "C" int xattn_resident_forward(const void* q, const void* k,
                                      const void* v, void* o, int bh, int sq,
                                      int bq, float sm_scale, void* stream) {
  if (bq < BM || bq % BM || sq < 1) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      xattn_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)SMEM_BYTES);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((sq + bq - 1) / bq, bh);
  xattn_kernel<<<grid, THREADS, SMEM_BYTES,
                 static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<__nv_bfloat16*>(o), sq,
      bq / BM, sm_scale);
  return (int)cudaGetLastError();
}

extern "C" const char* xattn_resident_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

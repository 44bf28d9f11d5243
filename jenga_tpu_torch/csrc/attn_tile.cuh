// Device code of the resident cross-attention probe (P4,
// cross_attn_resident.cu), P4's own pre-Hopper design: tile constants,
// cp.async loads with a zero-filled ragged edge, the mma.sync m16n8k16
// product, one 128-key tile of base-2 online-softmax attention for a
// warp's 16 query rows, and the normalising store. (The production kernels
// and P1/P2 run the Hopper mainloop of attn_sm90.cuh.)
//
// Layout: a thread block of 8 warps owns 128 query rows (16 per warp);
// each K|V tile sits in shared memory with a row stride of D + 8 bf16 so
// the mma fragment loads hit distinct banks. Accumulators (S, O, the row
// max m and the row sum l) are f32 registers: thread (g = lane / 4,
// t = lane % 4) of a warp holds rows r0 = 16 * warp + g and r0 + 8.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace attn {

constexpr int BM = 128;        // query rows per thread block
constexpr int BN = 128;        // keys per K|V tile
constexpr int D = 128;         // head dim
constexpr int HALF = 64;       // keys per inner step (two per tile)
constexpr int WARPS = 8;       // 8 warps x 16 rows = BM
constexpr int THREADS = WARPS * 32;
constexpr int LDS = D + 8;     // smem row stride in bf16 (conflict-free frags)
constexpr int STAGES = 2;      // K|V ring depth
constexpr size_t KV_ELEMS = (size_t)BN * LDS;
constexpr float LOG2E = 1.4426950408889634f;

// 16-byte global -> shared copy; src_bytes = 0 writes zeros and reads
// nothing (the ragged edge of a tile).
__device__ __forceinline__ void cp_async16(void* smem, const void* gmem,
                                           int src_bytes = 16) {
  unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(gmem), "r"(src_bytes));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// D = A(16x16 bf16, row) * B(16x8 bf16, col) + D, f32 accumulators.
__device__ __forceinline__ void mma16816(float* d, const uint32_t* a,
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ uint32_t pack_raw(__nv_bfloat16 lo,
                                             __nv_bfloat16 hi) {
  __nv_bfloat162 v;
  v.x = lo;
  v.y = hi;
  return *reinterpret_cast<uint32_t*>(&v);
}

// Copy a 128-row tile of D bf16 from global (row stride D) into smem (row
// stride LDS); rows >= valid are zero-filled and their source never read.
__device__ __forceinline__ void load_tile(__nv_bfloat16* dst,
                                          const __nv_bfloat16* src,
                                          int valid) {
  constexpr int CHUNKS = D / 8;  // 16-byte chunks per row
  for (int c = threadIdx.x; c < BM * CHUNKS; c += THREADS) {
    const int r = c / CHUNKS, col = (c % CHUNKS) * 8;
    const bool in = r < valid;
    cp_async16(dst + r * LDS + col, in ? src + (size_t)r * D + col : src,
               in ? 16 : 0);
  }
}

// A warp's Q A-fragments (16 rows x 16 dims per k-step), filled once per
// query tile.
struct QRegs {
  uint32_t f[D / 16][4];
  __device__ __forceinline__ void frag(int kk, uint32_t (&a)[4]) const {
#pragma unroll
    for (int i = 0; i < 4; ++i) a[i] = f[kk][i];
  }
};

// One 128-key tile (ks, vs in smem) against this warp's 16 query rows:
// S = Q K^T * scale2 (base-2 logits, every key valid), then the online
// softmax: m is the running row max (acc and l rescaled when it grows,
// guarded while it is still -inf), acc += exp2(S - m) V and l += rowsum.
__device__ __forceinline__ void attend_tile(
    const QRegs& qf, const __nv_bfloat16* ks, const __nv_bfloat16* vs,
    int g, int t, float scale2, float (&m_row)[2], float (&l_row)[2],
    float (&acc)[D / 8][4]) {
#pragma unroll
  for (int h = 0; h < BN / HALF; ++h) {
    // S = Q K^T for 16 rows x 64 keys
    float sc[HALF / 8][4];
#pragma unroll
    for (int nt = 0; nt < HALF / 8; ++nt)
      sc[nt][0] = sc[nt][1] = sc[nt][2] = sc[nt][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      uint32_t a[4];
      qf.frag(kk, a);
#pragma unroll
      for (int nt = 0; nt < HALF / 8; ++nt) {
        const __nv_bfloat16* kb =
            ks + (h * HALF + nt * 8 + g) * LDS + kk * 16 + 2 * t;
        mma16816(sc[nt], a, *reinterpret_cast<const uint32_t*>(kb),
                 *reinterpret_cast<const uint32_t*>(kb + 8));
      }
    }
    // scale
#pragma unroll
    for (int nt = 0; nt < HALF / 8; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) sc[nt][e] *= scale2;
    // running max per row; rescale acc and l
#pragma unroll
    for (int rr = 0; rr < 2; ++rr) {
      float mx = -INFINITY;
#pragma unroll
      for (int nt = 0; nt < HALF / 8; ++nt)
        mx = fmaxf(mx, fmaxf(sc[nt][2 * rr], sc[nt][2 * rr + 1]));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      const float m_new = fmaxf(m_row[rr], mx);
      const float alpha =
          (m_new == -INFINITY) ? 1.f : exp2f(m_row[rr] - m_new);
      m_row[rr] = m_new;
      l_row[rr] *= alpha;
#pragma unroll
      for (int dt = 0; dt < D / 8; ++dt) {
        acc[dt][2 * rr] *= alpha;
        acc[dt][2 * rr + 1] *= alpha;
      }
    }
    // P = exp2(S - m), bf16 A-fragments for P V
    uint32_t pa[HALF / 16][4];
#pragma unroll
    for (int nt = 0; nt < HALF / 8; ++nt) {
      float p[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float m = m_row[e >> 1];
        p[e] = (m == -INFINITY) ? 0.f : exp2f(sc[nt][e] - m);
      }
      l_row[0] += p[0] + p[1];
      l_row[1] += p[2] + p[3];
      // C layout of n-tile nt -> A layout of k-step nt/2
      pa[nt >> 1][(nt & 1) * 2 + 0] = pack_bf16(p[0], p[1]);
      pa[nt >> 1][(nt & 1) * 2 + 1] = pack_bf16(p[2], p[3]);
    }
    // O += P V  (V row-major [key][dim]; B fragment gathers 2 keys)
#pragma unroll
    for (int kk = 0; kk < HALF / 16; ++kk) {
      const __nv_bfloat16* vk = vs + (h * HALF + kk * 16 + 2 * t) * LDS + g;
#pragma unroll
      for (int dt = 0; dt < D / 8; ++dt) {
        const __nv_bfloat16* vp = vk + dt * 8;
        const uint32_t b0 = pack_raw(vp[0], vp[LDS]);
        const uint32_t b1 = pack_raw(vp[8 * LDS], vp[9 * LDS]);
        mma16816(acc[dt], pa[kk], b0, b1);
      }
    }
  }
}

// Reduce l over the 4 lanes of each row, divide, and store this thread's
// two rows of the 128-row output tile o (row stride D) as bf16; rows >=
// valid are not stored, and a row with l == 0 (no key) stores zeros.
__device__ __forceinline__ void store_rows(__nv_bfloat16* o, int r0, int t,
                                           int valid, const float (&l_row)[2],
                                           const float (&acc)[D / 8][4]) {
#pragma unroll
  for (int rr = 0; rr < 2; ++rr) {
    float l = l_row[rr];
    l += __shfl_xor_sync(0xffffffffu, l, 1);
    l += __shfl_xor_sync(0xffffffffu, l, 2);
    const int r = r0 + 8 * rr;
    if (r >= valid) continue;
    const float inv = (l == 0.f) ? 0.f : 1.f / l;
    __nv_bfloat16* orow = o + (size_t)r * D + 2 * t;
#pragma unroll
    for (int dt = 0; dt < D / 8; ++dt) {
      *reinterpret_cast<__nv_bfloat162*>(orow + dt * 8) =
          __floats2bfloat162_rn(acc[dt][2 * rr] * inv,
                                acc[dt][2 * rr + 1] * inv);
    }
  }
}

}  // namespace attn

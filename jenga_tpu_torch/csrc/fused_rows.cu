// The DiT trunk's f32 elementwise chains as single-pass row kernels, for
// Hopper (sm_90a): LayerNorm or RMSNorm of a row with its optional f32
// affine, followed by the modulation x * (1 + scale) + shift or by
// interleaved RoPE, and the gated residual x + y * gate.
//
// Replaces no Pallas kernel: the JAX package leaves these chains
// (jenga_tpu/models/layers.py: layer_norm, rms_norm, modulate, apply_rope;
// the models' gated residuals) to XLA, which fuses each into one pass. In
// eager PyTorch each chain is some ten kernels, every one of which writes an
// f32 intermediate of the whole activation (ops/fused_rows.py has the
// callers and the rules by which an input takes these kernels).
//
// What bounds them on the card: bytes. Each reads its bf16 rows once and
// writes bf16 rows once, at a few operations per element: far below the
// ~295 FLOP/byte ridge. So the design keeps every intermediate in
// registers. A group of LANES threads (4 or 32) holds one
// row in registers as VPT 16-byte vectors of 8 bf16 per thread, loaded
// together (neighbouring threads on neighbouring vectors), reduces the
// row's statistics with warp shuffles inside the group, applies the whole
// chain in f32 and stores the row once. (LANES, VPT) follows the row
// length: a 128-element head row takes 4 threads of 4 vectors, 1536 takes
// a warp of 6, 3072 a warp of 12, 5120 (Wan-14B) a warp of 20, and a row
// of another length the first of these that holds it; longer rows, or a
// length that is not a multiple of 8, are not taken. What sets the
// pace is how many rows are in flight on an SM, so the registers of a
// thread are capped by the vectors it holds (kThreads below). The vectors
// of the affine and the modulation are small, read by every row and stay
// in L1; a token's RoPE table row is read by all its heads, and its first
// reader starts it for L1 while its own row loads. One group per row, as
// many blocks as the rows need: tens of thousands at the models' shapes,
// so all 132 SMs stay full.
//
// Numerics are those of the PyTorch chain: f32 arithmetic with every
// multiply and add rounded on its own (no contraction into an FMA), the
// centred variance mean((x - mean)^2), the same eps, and one bf16 rounding
// where the chain rounds: after the norm and its affine when a modulation
// or RoPE follows, and at the end. Only the order of the two sums differs.
//
// Plain C interface (loaded with ctypes); each launch goes on the caller's
// stream and the function returns cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

// Blocks of the row-norm kernel: 128 threads, with registers capped by
// the vectors a thread holds so that many blocks stay in flight on an SM
// (measured on the H100: occupancy, not instructions, sets these kernels'
// pace). Up to 6 vectors a thread: 56 registers, 9 blocks; 8: 72, 7
// blocks; past that 128, 4 blocks. The gated residual needs no cap.
constexpr int kThreads = 128;
constexpr int kGatedThreads = 256;

template <int VPT>
constexpr int min_blocks() {
  return 65536 / (kThreads * (VPT <= 6 ? 56 : VPT <= 8 ? 72 : 128));
}

struct NormArgs {
  const __nv_bfloat16* x;     // rows [B, S, G, R] at strides sb, ss, sg, 1
  __nv_bfloat16* out;         // [B, S, G, R], contiguous
  unsigned rows, S, G;        // rows = B * S * G
  int R;                      // row length, a multiple of 8
  long long sb, ss, sg;       // x's strides in elements
  int rms;                    // 1: RMSNorm, 0: LayerNorm
  float eps;
  const float* weight;        // [R] or null
  const float* bias;          // [R] or null
  const float* shift;         // [B or 1, R] at stride shift_sb, or null
  const float* scale;
  long long shift_sb, scale_sb;
  const float* cos;           // [>= rope_rows, hd / 2], or null: no RoPE
  const float* sin;
  int hmask, rope_rows;       // head length - 1 (a power of two - 1);
                              // tokens s < rope_rows rotate
};

struct GatedArgs {
  const __nv_bfloat16* x;     // [rows, R], contiguous
  const __nv_bfloat16* y;
  const float* gate;          // [B or 1, R] at stride gate_sb
  __nv_bfloat16* out;
  unsigned rows, rows_per_batch;
  int R;
  long long gate_sb;
};

__device__ __forceinline__ void unpack8(const uint4 u, float f[8]) {
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const float2 t = __bfloat1622float2(h[k]);
    f[2 * k] = t.x;
    f[2 * k + 1] = t.y;
  }
}

__device__ __forceinline__ uint4 pack8(const float f[8]) {
  uint4 u;
  __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&u);
#pragma unroll
  for (int k = 0; k < 4; ++k) h[k] = __floats2bfloat162_rn(f[2 * k], f[2 * k + 1]);
  return u;
}

__device__ __forceinline__ void load8(const float* p, float f[8]) {
  const float4 a = __ldg(reinterpret_cast<const float4*>(p));
  const float4 b = __ldg(reinterpret_cast<const float4*>(p) + 1);
  f[0] = a.x; f[1] = a.y; f[2] = a.z; f[3] = a.w;
  f[4] = b.x; f[5] = b.y; f[6] = b.z; f[7] = b.w;
}

__device__ __forceinline__ float round_bf16(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

// Sum over the LANES threads of a group (groups are aligned in the warp,
// and every thread of the warp takes part).
template <int LANES>
__device__ __forceinline__ float group_sum(float v) {
#pragma unroll
  for (int off = LANES / 2; off > 0; off >>= 1)
    v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

template <int LANES, int VPT>
__device__ __forceinline__ void norm_row(const NormArgs& a, unsigned group,
                                         int lane) {
  // a group past the last row computes the last row again (the shuffles
  // need the whole warp) and stores nothing
  const bool live = group < a.rows;
  const unsigned r = live ? group : a.rows - 1;
  const unsigned t = r / a.G, b = t / a.S;
  const unsigned g = r - t * a.G, s = t - b * a.S;
  const uint4* xr = reinterpret_cast<const uint4*>(
      a.x + b * a.sb + s * a.ss + g * a.sg);
  const int nvec = a.R / 8;
  uint4 raw[VPT];
#pragma unroll
  for (int i = 0; i < VPT; ++i) {
    const int c = lane + i * LANES;
    raw[i] = c < nvec ? __ldg(xr + c) : make_uint4(0u, 0u, 0u, 0u);
  }
  // the RoPE table row of this token, wanted after the sums: its lines
  // start for L1 now, while the row loads (a first touch comes from HBM)
  if (a.cos != nullptr && s < (unsigned)a.rope_rows) {
    const size_t at = (size_t)s * ((a.hmask + 1) / 2);
    for (int l = lane; l < (a.hmask + 1) / 64; l += LANES) {
      asm volatile("prefetch.global.L1 [%0];" ::"l"(a.cos + at + l * 32));
      asm volatile("prefetch.global.L1 [%0];" ::"l"(a.sin + at + l * 32));
    }
  }
  float mean = 0.f;
  if (!a.rms) {
    float sum = 0.f;
#pragma unroll
    for (int i = 0; i < VPT; ++i) {
      float f[8];
      unpack8(raw[i], f);
#pragma unroll
      for (int j = 0; j < 8; ++j) sum += f[j];
    }
    mean = group_sum<LANES>(sum) / (float)a.R;
  }
  float sq = 0.f;
#pragma unroll
  for (int i = 0; i < VPT; ++i) {
    if (lane + i * LANES < nvec) {
      float f[8];
      unpack8(raw[i], f);
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const float d = f[j] - mean;
        sq += d * d;
      }
    }
  }
  const float rstd = rsqrtf(group_sum<LANES>(sq) / (float)a.R + a.eps);
  if (!live) return;

  const bool rope = a.cos != nullptr && s < (unsigned)a.rope_rows;
  const bool round_mid = a.shift != nullptr || a.scale != nullptr || rope;
  const size_t rope_at = (size_t)s * ((a.hmask + 1) / 2);
  uint4* orow = reinterpret_cast<uint4*>(a.out + (size_t)r * a.R);
#pragma unroll
  for (int i = 0; i < VPT; ++i) {
    const int c = lane + i * LANES;
    if (c >= nvec) continue;
    const int col = c * 8;
    float f[8], v[8];
    unpack8(raw[i], f);
#pragma unroll
    for (int j = 0; j < 8; ++j)
      f[j] = a.rms ? __fmul_rn(f[j], rstd)
                   : __fmul_rn(__fsub_rn(f[j], mean), rstd);
    if (a.weight) {
      load8(a.weight + col, v);
#pragma unroll
      for (int j = 0; j < 8; ++j) f[j] = __fmul_rn(f[j], v[j]);
    }
    if (a.bias) {
      load8(a.bias + col, v);
#pragma unroll
      for (int j = 0; j < 8; ++j) f[j] = __fadd_rn(f[j], v[j]);
    }
    if (round_mid) {
#pragma unroll
      for (int j = 0; j < 8; ++j) f[j] = round_bf16(f[j]);
    }
    if (a.scale) {
      load8(a.scale + b * a.scale_sb + col, v);
#pragma unroll
      for (int j = 0; j < 8; ++j) f[j] = __fmul_rn(f[j], __fadd_rn(1.f, v[j]));
    }
    if (a.shift) {
      load8(a.shift + b * a.shift_sb + col, v);
#pragma unroll
      for (int j = 0; j < 8; ++j) f[j] = __fadd_rn(f[j], v[j]);
    }
    if (rope) {
      const size_t at = rope_at + ((col & a.hmask) >> 1);
      const float4 c4 = __ldg(reinterpret_cast<const float4*>(a.cos + at));
      const float4 s4 = __ldg(reinterpret_cast<const float4*>(a.sin + at));
      const float cs[4] = {c4.x, c4.y, c4.z, c4.w};
      const float sn[4] = {s4.x, s4.y, s4.z, s4.w};
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float xe = f[2 * j], xo = f[2 * j + 1];
        f[2 * j] = __fsub_rn(__fmul_rn(xe, cs[j]), __fmul_rn(xo, sn[j]));
        f[2 * j + 1] = __fadd_rn(__fmul_rn(xo, cs[j]), __fmul_rn(xe, sn[j]));
      }
    }
    orow[c] = pack8(f);
  }
}

template <int LANES, int VPT>
__global__ void __launch_bounds__(kThreads, min_blocks<VPT>())
row_norm_kernel(const NormArgs a) {
  norm_row<LANES, VPT>(a, blockIdx.x * (kThreads / LANES) +
                              threadIdx.x / LANES, threadIdx.x % LANES);
}

template <int LANES, int VPT>
__global__ void __launch_bounds__(kGatedThreads)
gated_residual_kernel(const GatedArgs a) {
  const unsigned r = blockIdx.x * (kGatedThreads / LANES) + threadIdx.x / LANES;
  if (r >= a.rows) return;    // no shuffles here
  const int lane = threadIdx.x % LANES;
  const int nvec = a.R / 8;
  const size_t base = (size_t)r * a.R;
  const uint4* xr = reinterpret_cast<const uint4*>(a.x + base);
  const uint4* yr = reinterpret_cast<const uint4*>(a.y + base);
  uint4 xv[VPT], yv[VPT];
#pragma unroll
  for (int i = 0; i < VPT; ++i) {
    const int c = lane + i * LANES;
    if (c < nvec) {
      xv[i] = __ldg(xr + c);
      yv[i] = __ldg(yr + c);
    }
  }
  const float* gate = a.gate + (r / a.rows_per_batch) * a.gate_sb;
  uint4* orow = reinterpret_cast<uint4*>(a.out + base);
#pragma unroll
  for (int i = 0; i < VPT; ++i) {
    const int c = lane + i * LANES;
    if (c >= nvec) continue;
    float fx[8], fy[8], gv[8];
    unpack8(xv[i], fx);
    unpack8(yv[i], fy);
    load8(gate + c * 8, gv);
#pragma unroll
    for (int k = 0; k < 8; ++k) fx[k] = __fadd_rn(fx[k], __fmul_rn(fy[k], gv[k]));
    orow[c] = pack8(fx);
  }
}

template <int LANES, int VPT>
int launch_norm(const NormArgs& a, cudaStream_t stream) {
  const unsigned blocks =
      (a.rows + kThreads / LANES - 1) / (kThreads / LANES);
  row_norm_kernel<LANES, VPT><<<blocks, kThreads, 0, stream>>>(a);
  return (int)cudaGetLastError();
}

template <int LANES, int VPT>
int launch_gated(const GatedArgs& a, cudaStream_t stream) {
  const unsigned blocks =
      (a.rows + kGatedThreads / LANES - 1) / (kGatedThreads / LANES);
  gated_residual_kernel<LANES, VPT><<<blocks, kGatedThreads, 0, stream>>>(a);
  return (int)cudaGetLastError();
}

// (LANES, VPT) for a row of n 8-element vectors: one shape for each row
// length the models use (a 128-element head, 1536, 3072 and 5120 wide);
// a row of another length takes the first shape that holds it.
#define FUSED_ROWS_PICK(n, LAUNCH)                   \
  do {                                               \
    if ((n) <= 16) return LAUNCH<4, 4>(a, stream);   \
    if ((n) <= 192) return LAUNCH<32, 6>(a, stream); \
    if ((n) <= 384) return LAUNCH<32, 12>(a, stream);\
    if ((n) <= 640) return LAUNCH<32, 20>(a, stream);\
    return (int)cudaErrorInvalidValue;               \
  } while (0)

}  // namespace

extern "C" int fused_rows_norm(
    const void* x, void* out, unsigned rows, unsigned S, unsigned G, int R,
    long long sb, long long ss, long long sg, int rms, float eps,
    const void* weight, const void* bias, const void* shift,
    long long shift_sb, const void* scale, long long scale_sb,
    const void* cos, const void* sin, int hd, int rope_rows, void* stream_) {
  if (R <= 0 || R % 8 ||
      (cos && (hd < 8 || (hd & (hd - 1)) || R % hd)))
    return (int)cudaErrorInvalidValue;
  if (rows == 0) return 0;
  const NormArgs a{static_cast<const __nv_bfloat16*>(x),
                   static_cast<__nv_bfloat16*>(out), rows, S, G, R, sb, ss,
                   sg, rms, eps, static_cast<const float*>(weight),
                   static_cast<const float*>(bias),
                   static_cast<const float*>(shift),
                   static_cast<const float*>(scale), shift_sb, scale_sb,
                   static_cast<const float*>(cos),
                   static_cast<const float*>(sin), hd - 1, rope_rows};
  cudaStream_t stream = static_cast<cudaStream_t>(stream_);
  FUSED_ROWS_PICK(R / 8, launch_norm);
}

extern "C" int fused_rows_gated(const void* x, const void* y,
                                const void* gate, void* out, unsigned rows,
                                unsigned rows_per_batch, int R,
                                long long gate_sb, void* stream_) {
  if (R <= 0 || R % 8 || rows_per_batch == 0)
    return (int)cudaErrorInvalidValue;
  if (rows == 0) return 0;
  const GatedArgs a{static_cast<const __nv_bfloat16*>(x),
                    static_cast<const __nv_bfloat16*>(y),
                    static_cast<const float*>(gate),
                    static_cast<__nv_bfloat16*>(out), rows, rows_per_batch,
                    R, gate_sb};
  cudaStream_t stream = static_cast<cudaStream_t>(stream_);
  FUSED_ROWS_PICK(R / 8, launch_gated);
}

extern "C" const char* fused_rows_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

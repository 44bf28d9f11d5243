// Block mean pooling, for Hopper (sm_90a): probe kernel P3.
//
// Replaces the Pallas TPU probe `pool_pallas` (tools/pool_probe.py:111,
// body `_pool_kernel` :105): the mean of each 128-token block of a head,
// bf16 [BH, S, D] -> f32 [BH, S/128, D], the planner's Q/K pooling
// (sparse/planner.py `_pool`). No main path launches it; the port's pool
// probe times it against the planner's own pooling.
//
// What bounds it on the card: bytes. It reads each bf16 element once and
// writes 1/64 as many f32 bytes (one row per 128), at one add per element:
// 0.5 FLOP/byte, far below the ~295 FLOP/byte ridge. The design keeps the
// loads coalesced and many in flight: a thread block of 256 threads covers
// `chunk` consecutive 128-row blocks of one (b*h); thread (phase p, column
// pair c) sums column pair c over rows [32p, 32p + 32) of a block with 32
// independent 4-byte loads (a warp reads 128 contiguous bytes of one row
// per load) and f32 accumulation, then the four phases' partial sums meet
// in shared memory and phase 0 writes the mean. The tail rows past the
// last whole block are not read, as in the planner.
//
// Plain C interface (loaded with ctypes); the launch goes on the caller's
// stream and the function returns cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int D = 128;              // head dim
constexpr int ROWS = 128;           // tokens per block
constexpr int PAIRS = D / 2;        // column pairs: one thread each
constexpr int PHASES = 4;           // row slices of a block
constexpr int THREADS = PAIRS * PHASES;
constexpr int SLICE = ROWS / PHASES;

__global__ void __launch_bounds__(THREADS)
pool_kernel(const __nv_bfloat16* __restrict__ x, float* __restrict__ out,
            int s, int nb, int chunk) {
  __shared__ float2 part[PHASES][PAIRS];
  const int bh = blockIdx.y;
  const int c = threadIdx.x % PAIRS, p = threadIdx.x / PAIRS;
  const int b0 = blockIdx.x * chunk;
  const int b1 = min(b0 + chunk, nb);
  for (int blk = b0; blk < b1; ++blk) {
    const __nv_bfloat162* src =
        reinterpret_cast<const __nv_bfloat162*>(
            x + ((size_t)bh * s + (size_t)blk * ROWS + p * SLICE) * D) + c;
    float sx = 0.f, sy = 0.f;
#pragma unroll
    for (int r = 0; r < SLICE; ++r) {
      const float2 f = __bfloat1622float2(__ldg(src + (size_t)r * PAIRS));
      sx += f.x;
      sy += f.y;
    }
    part[p][c] = make_float2(sx, sy);
    __syncthreads();
    if (p == 0) {
#pragma unroll
      for (int i = 1; i < PHASES; ++i) {
        sx += part[i][c].x;
        sy += part[i][c].y;
      }
      reinterpret_cast<float2*>(out + ((size_t)bh * nb + blk) * D)[c] =
          make_float2(sx * (1.f / ROWS), sy * (1.f / ROWS));
    }
    __syncthreads();  // part is rewritten for the next block
  }
}

}  // namespace

extern "C" int block_pool_forward(const void* x, void* out, int bh, int s,
                                  int chunk, void* stream) {
  const int nb = s / ROWS;
  if (chunk < 1 || nb < 1) return (int)cudaErrorInvalidValue;
  dim3 grid((nb + chunk - 1) / chunk, bh);
  pool_kernel<<<grid, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(x), static_cast<float*>(out), s, nb,
      chunk);
  return (int)cudaGetLastError();
}

extern "C" const char* block_pool_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// Probe kernels P1 and P2, for Hopper (sm_90a): instances of the
// production block-sparse loop (block_sparse_kernel.cuh) with parts of its
// work switched off at compile time, so that timing them splits the
// production kernel's time. No main path launches them.
//
// Replaces the Pallas TPU probes
//   * P1 `variant` (tools/kernel_split_probe.py:140, body `_kernel` :28):
//     the per-row gather kernel with `do_dma` / `do_compute` switches;
//   * P2 `run_variant` (tools/epilogue_probe.py:250, body
//     `_kernel_variant` :55): the joint grouped kernel with five epilogues.
//
// Variants (the `variant` argument):
//   0 both          the production kernel (fixed max); P1's function with
//                   text_amp 0 and seqlen = S, as P1 has no masks or bias
//   1 copy_only     the cp.async ring over exactly the same blocks, no tile
//                   math: the output is zeros (l = 0), as on the TPU
//   2 compute_only  the group's first listed block loaded once, then the
//                   tile math `n` times over it: attention over that block
//                   alone (the TPU version reads never-filled scratch; this
//                   one is deterministic)
//   3 base          online epilogue, key mask in every tile
//   4 condqk        online epilogue, key mask only in tiles that need it
//                   (the production online kernel)
//   5 fixedmax      the production default (= variant 0)
//   6 oracle        online epilogue, no key mask and no text_amp
//   7 nomax         the constant row max CONST_MAX, no mask, no text_amp
//
// What bounds them: as the production kernel (block_sparse_attn.cu): the
// gather at the main path's ~30% density, which copy_only isolates; the
// tile math, which compute_only isolates (its K|V stay in shared memory).
// The TPU swept its DMA group width (8-48 blocks per batch); the card's
// ring holds one 128-key block per stage and STAGES = 2 already takes
// 170 KB of the 227 KB, so there is no width to sweep.
//
// Plain C interface (loaded with ctypes); the launch goes on the caller's
// stream and the function returns cudaGetLastError().

#include "block_sparse_kernel.cuh"

using namespace attn;

extern "C" int attn_probe_forward(int variant, const void* q, const void* k,
                                  const void* v, void* o, const void* lists,
                                  const void* counts, const void* seqlens,
                                  const void* maxk, int bh, int heads, int s,
                                  int skv, int nkb, int ngroups, int q_rows,
                                  int tsb, float sm_scale, float text_amp,
                                  void* stream) {
#define PROBE_ARGS                                                         \
  q, k, v, o, lists, counts, nullptr, seqlens, maxk, bh, heads, s, skv, nkb, \
      ngroups, q_rows, tsb, sm_scale, text_amp, stream
  switch (variant) {
    case 0:
    case 5:
      return bsa_launch<Epilogue::kFixedMax>(PROBE_ARGS);
    case 1:
      return bsa_launch<Epilogue::kOnline, KeyMask::kAsNeeded, false>(
          PROBE_ARGS);
    case 2:
      return bsa_launch<Epilogue::kFixedMax, KeyMask::kAsNeeded, true,
                        false>(PROBE_ARGS);
    case 3:
      return bsa_launch<Epilogue::kOnline, KeyMask::kAlways>(PROBE_ARGS);
    case 4:
      return bsa_launch<Epilogue::kOnline>(PROBE_ARGS);
    case 6:
      return bsa_launch<Epilogue::kOnline, KeyMask::kNever>(PROBE_ARGS);
    case 7:
      return bsa_launch<Epilogue::kConstMax, KeyMask::kNever>(PROBE_ARGS);
    default:
      return (int)cudaErrorInvalidValue;
  }
#undef PROBE_ARGS
}

extern "C" const char* attn_probe_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

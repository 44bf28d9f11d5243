#!/usr/bin/env python3
"""Smoke test of the PyTorch port on one CUDA GPU.

Run from the root of a checkout:  python3 chip_smoke.py

Phases (each prints its seconds; any failure exits non-zero before the
result line):
  1. toolchain: torch/CUDA versions, nvcc, the card's name and power
     limit; builds all eight kernel sources from jenga_tpu_torch/csrc/ (one
     nvcc per source, started together; sm_90a) and prints ptxas' resource
     use; fails if ptxas reports spill stores or loads in a production
     instance (K1/K1m/K2 fixed and online max, D on both routes: the
     mainloop and the short-key kernel, D's backward on both routes: the
     dK|dV and dQ kernels and the short-key call's three) or in P4, which
     has its own Hopper design;
  2. kernels vs their plain torch versions on the card, max abs error
     <= 1e-2 in each case, each case timed against the plain version and
     beside its bound (the larger of its FLOPs over 989 TFLOP/s bf16 and
     its bytes, each operand read once, over 3.35 TB/s). The main cases
     also time one library call on the same operands: flex_attention
     (compiled) for K1 and K1m, SDPA (flash) for D's Wan cases.
     Block-sparse: random per-row lists (q_rows=1) with an empty row,
     joint q8 planner lists with a video/text boundary group, text_amp
     != 0, a seqlen that cuts into the last text block, both softmax
     epilogues, HunyuanVideo's main shape (joint q8 and per-row), and
     Wan's (joint q8 with first-frame forcing, no text blocks, the pad
     tail cut by seqlen). Membership mode (q8 union lists + membership
     words over per-row planner selections): (a) HunyuanVideo's main
     shape, timed beside the per-row mode on the same mask; (b) the
     HunyuanVideo Turbo stage-0 shape (142 blocks, tsb 140, seqlen 18,076,
     text_amp 0.431) with an empty row, both epilogues; (c) the Wan Turbo
     stage-0 shape (B=2, 141 blocks, first_frame_blocks 6, seqlen
     18,018). Dense (each record names the route it took, from the
     counters, and fails if that is not the one its key count selects):
     Wan self-attention and HunyuanVideo's joint dense shape with kv_len
     on the mainloop; on the short-key kernel (Skv <= 512) Wan
     cross-attention over 512 keys, a ragged small case with an empty
     sample (which must be all zeros), and Wan2.1-14B's two
     cross-attentions at 40 heads over 32,768 query rows: the 257 CLIP
     image keys (a ragged last key tile) and the 512 text keys, each with
     SDPA beside it; then the model's own calls, attention_bshd on [B, S,
     H, D] over 32,760 rows: Wan-1.3B's cross-attention and
     Wan2.1-I2V-14B's text + image pair on one q, summed, with SDPA on the
     same layout, each call running the short-key kernel once a pair (and
     one add), no copy. K1 also at Wan2.1-14B's self-attention shape (B=2, 40
     heads, 256 blocks, joint q8 with first-frame forcing), with flex.
     D's backward on the route of its key count (over 512 keys the dK|dV
     kernel, then the dQ kernel; up to 512 the short-key call, which
     computes di itself; both from the forward kernel's output and base-2
     statistics) against the plain backward at Wan's self-attention
     (2x12x32768) and HunyuanVideo's joint dense shape with kv_len below
     Skv (the first route), Wan 1.3B's cross-attention over 512 keys,
     Wan2.1-14B's image (2x40x32768 over 257 keys) and text (512 keys)
     cross-attention and kv_len 0 and past Skv over 32,760 rows (the
     second), then Wan's calls under autograd, attention_bshd's backward
     on [B, S, H, D] for Wan 1.3B and for the 14B text + image pair on one
     q (one short-key call a pair, no copy, [B, S, H, D] gradients): each
     gradient within 2e-2 relative L2 and its max abs error within 1e-2 of
     its largest element; each kernel, the call and the plain backward
     timed beside their bounds and the SDPA (flash) backward;
  3. main path, HunyuanVideo T2V at full width and depth (3072 hidden, 24
     heads, 20 double + 40 single blocks, bf16, seeded random init on the
     card, head perturbed) through HunyuanVideoSampler.predict with the
     Jenga-Base preset at 1280x720x33f for 8 steps; latents finite and
     non-zero, the block-sparse kernel launched exactly 7 x 60 times;
  3b. main path, the same model with the ProRes Turbo preset under
     --q-group 8 --no-joint-sel at 1280x720x33f for 8 steps: stage 0 at
     latent 16x9x66x120 (text_amp 0.431), the switch after step 4, stage
     1 at 16x9x90x160; latents finite and non-zero; the membership mode
     launched 60 x the computed steps of the host's skip schedule, and
     nothing else;
  4. main path, Wan2.1 T2V 1.3B at full width and depth (1536 dim, 12
     heads, 30 layers, bf16, seeded random init, head perturbed) through
     WanSampler.generate with the 1.3b-base preset at 832x480x81f; the
     step count is the smallest from 6 whose host schedule holds a dense
     warm-up, a carved and a TeaCache-skipped step. Latents (16, 21, 60,
     104) finite and non-zero; block-sparse launches = 30 x carved steps,
     dense launches = 30 x dense steps + 30 x computed steps, the latter
     (the cross-attention over 512 text keys) on the short-key kernel;
  4b. main path, the same model with the 1.3b-turbo preset (joint q8) at
     832x480x81f: the smallest step count from 6 and switch step whose
     host schedule holds a dense step, a carved step in each stage and,
     if 12 steps allow it, a skip; stage 0 at latent 16x21x44x78. Latents
     (16, 21, 60, 104) and launch counts as in phase 4;
  4c. main path, HunyuanVideo-I2V token_replace at full width and depth
     (in_channels 16, 20 + 40 blocks, bf16, seeded init, head perturbed)
     through HunyuanVideoSampler.predict_i2v with the options
     `hyvideo-i2v --preset base` builds, 1280x720x33f, 8 steps, seeded
     non-zero conditioning latents (one per stage); latents finite and
     non-zero, frame 0 equal to the conditioning latent bit for bit after
     every step, the block-sparse kernel launched 60 x the computed steps
     of the host's skip schedule;
  4d. the same for latent_concat (in_channels 33) at full width cut to
     2 + 2 blocks, 4 steps: latents and launches (4 x computed steps);
  4e. main path, Wan2.1-I2V-14B at full width and depth (5120 dim, 40
     heads, 40 layers, bf16, seeded init, head perturbed) through
     WanSampler.generate_i2v with the wan-i2v options at max_area 832x480
     (shift 3.0), latent 16x21x60x104 (32,760 tokens, CFG batch 2), seeded
     image latent, CLIP tokens and prompts; the step count is the smallest
     from 6 (ret-steps polynomial first, then the other) whose host plan
     holds a dense, a carved and a skipped step. Latents finite and
     non-zero; block-sparse launches = 40 x carved steps, dense launches =
     40 x dense steps + 80 x computed steps (text and image
     cross-attention, the 80 on the short-key kernel). Each full-width
     model is freed before the next is built, and each phase prints its
     peak memory;
  5. end to end, kernels vs plain attention (both dispatch points
     patched): HunyuanVideo at full width cut to 1 double + 1 single
     block, carved and dense (carve=None, the dense arm), and at the
     Turbo stage-0 grid with text_amp 0.431 in joint and per-row
     (membership) selection; Wan 1.3B at full width cut to 2 layers at
     832x480x81f, carved and dense fallback, and at the Turbo stage-0
     grid in per-row selection; HunyuanVideo-I2V token_replace cut to 1 +
     1 blocks, carved and dense; Wan2.1-I2V-14B cut to 2 layers at
     832x480x81f with y and CLIP tokens, carved and dense fallback. Each
     relative error within the stated bound;
  6. probes: the four probe tools' run() at their own shapes, with the
     launch counts set to 0 before and read after (each probe kernel must
     launch; phases 3-4b must have launched none): P1 (the gather/compute
     split, HY 1280x720x125f, K2 and K1 modes) and P2 (five epilogues,
     904 blocks, q_rows 4) with flex_attention beside them; P3 (block
     pooling at the Wan shape, each chunk within 1e-4 of its plain
     version) and P4 (resident cross-attention at bq 1024/2048/4096
     beside D and SDPA). Every P1/P2 variant's output at 115k tokens is
     held against its plain version 16 query blocks at a time (one
     head's logits over all keys would be 53 GB): P1 `both` and P2
     `fixedmax` over every row, the others over the first, middle and
     last 16 blocks. P1, P2 and P4 within 1e-2 max abs error and 2e-2
     relative (L2) error;
  7. the CLI's --tiny on the card: `hyvideo-t2v`, `wan-t2v`,
     `hyvideo-i2v` and `wan-i2v`, each `--tiny --latents-only` with the
     CLI's default device (the tiny models are bf16 with head dim 128
     there) through the CLI's entry point in a fresh process; exit 0,
     latents finite and non-zero, and the kernels launched (HunyuanVideo:
     the block-sparse kernel; Wan: it and D);
  8. HunyuanVideo T2V at full width and depth through
     HunyuanVideoSampler(use_fp8=True) (seeded init quantized in place on
     the card, 344 linears in e4m3): the e4m3 bytes and scale of the
     largest single-block weight and a refiner weight (from phase 3's
     identical seeded init) and of the head's seeded noise (the
     zero-initialised layers get quantized noise, as _perturb gives the
     bf16 model) equal the CPU's quantization of the same weights; the
     Jenga-Base preset at 1280x720x33f for 4 steps, latents finite and
     non-zero, the block-sparse kernel launched 60 x the computed steps;
     one carved velocity with fp8 weights (twice) and again after
     dequantize_tree_fp8 in place: bit-equal, or within the phase-5
     bound if cuBLAS picked another algorithm;
  9. Wan2.1 T2V 1.3B at full width and depth under dpm++ (the 1.3b-base
     preset with solver="dpm++"), at 832x480x81f with a dense, a carved
     and a skipped step, then (9b) the 1.3b-turbo preset under dpm++
     with the switch placed so that the fresh-state step after it is
     carved; latents and launch counts as in phase 4;
  10. one fidelity row of tools/fidelity.py: Wan-1.3B arch (port seeded
     init, head perturbed) at 832x480x33f over 20 steps, joint q8 carved
     against dense; relative error in (0, 0.10], the TPU's row beside it
     for reference; K1 launched 30 x the carved steps and D 30 x (2 x
     dense + carved) steps over both arms.
  11. the HunyuanVideo VAE (HYVAE_884_16C, seeded init, f32 with cuDNN's
     default TF32 convs) on a HunyuanVideo-I2V token_replace sampler at
     full width and depth: its decode_latents turns phase 3's final
     latents (16x9x90x160) into a [3, 33, 720, 1280] video by 28 spatial
     tiles (finite, in [-1, 1], not constant); then the tests' small
     config decodes a seeded 5x5x5 latent (2 temporal x 2x2 spatial
     tiles) on the card and on the CPU: relative L2 <= 2e-2;
  11b. on the same sampler, a seeded [3, 720, 1280] image through
     encode_image_latent to one [16, 1, 90, 160] latent per stage, the
     token_replace run of phase 4c on it (frame 0 bit-exact after every
     step, launches as there), decoded by the pipeline to [3, 33, 720,
     1280];
  12. the Wan VAE (WAN_VAE_16Z, seeded init, attention projections
     perturbed) on a Wan2.1-I2V-14B sampler at full width and depth: its
     decode_latents streams phase 4's final latents (16x21x60x104) one
     latent frame at a time to [3, 81, 480, 832]; the decode's memory above
     the resident sampler must stay under a third of the one-shot
     decode's largest tensor (24.8 GB); then the tests' small config
     decodes a seeded 4-frame latent on the card and on the CPU: relative
     L2 <= 2e-2;
  12b. on the same sampler, a seeded [3, 480, 832] image through
     encode_image_latent(img, 81, 60, 104) (first frame and 80 zero
     frames, streamed) to [16, 21, 60, 104] with the trunk resident, as
     ``y`` of phase 4e's run (its options and schedule; CLIP tokens zero),
     launches as there, decoded by the pipeline to [3, 81, 480, 832].
     Phases 11-12b print their seconds, peak memory and the card's name
     and power limit, and a ``vae:`` line gathers them.
  13. (after 11b, on its sampler) HunyuanVideo's encoders at published
     width, seeded on the card in f32 (the dtype from_pretrained loads):
     the llava LM (LlamaConfig: 4096 wide, 32 layers, GQA 8, vocab
     128320), its CLIP-L-336 tower and projector, and CLIP-L text, after
     a memory plan beside the resident sampler; a stand-in tokenizer in
     the sampler's slot (the card machine has no transformers: words to
     seeded ids, "\n\n" to 271, <image> to 128257); encode_prompt (351
     ids -> [256, 4096] and pooled [768]) and encode_prompt_i2v on the
     720x1280 image (934 spliced tokens), finite and not constant; 4
     token_replace steps on those states with the options `hyvideo-i2v
     --preset base` builds (the pipeline takes ceil(tokens / 128) text
     blocks; K1 60 x computed steps, frame 0 bit-exact); whether a
     1280x720x125f step fits beside the encoders;
  14. (after 12b, on its sampler) UMT5-XXL and the CLIP-H tower seeded on
     the card in f32; T5 on the prompt (trimmed) and CLIP on a seeded
     480x832 image ([257, 1280]); generate_image(image, prompt, opts)
     with phase 4e's options and plan to a decoded [3, 81, H, W] video,
     launches as in 4e;
  15. the smoke writes small-config checkpoint directories in the
     reference's layout to a temp dir (torch.save and its own
     safetensors writer: a deepspeed .pt, fp8 + scale map, vae/, a
     sharded safetensors llava with its index and config.json, a CLIP
     safetensors, Wan's sharded diffusion safetensors, VAE, T5 and CLIP
     .pth, a kohya LoRA), patches the published configs to those small
     ones and loads them with from_pretrained on the card and on the CPU:
     HunyuanVideo plain, use_fp8, lora_path and use_cpu_offload, Wan I2V
     plain and t5_on_host. Every module tensor bit-equal, placement as
     asked, each encoder output card vs CPU within 2e-2 relative L2, and
     a prompt through the encoders, 2 steps and the VAE to a video.
     Phases 13-15 print their seconds, peak memory and the card's name
     and power limit, and a ``prompt:`` line gathers them.
  16. LoRA fine-tuning through make_lora_train_step on Wan2.1-T2V-1.3B at
     full width and depth (seeded init, head perturbed), bf16: seeded
     latents 16x21x60x104 (832x480x81f, 32,760 tokens, B=1) written as
     .npy with JSON metadata and read through LatentDataset, seeded text
     states over 512 keys, rank-16 adapters on DEFAULT_TARGETS, remat,
     AdamW; 3 dense steps (D and its backward on self- and
     cross-attention: per step D 120, dK|dV 30 and dQ 30 on the
     self-attention, 30 short-key backward calls on the cross-attention),
     then 2 carved steps with the Base stage-1 carve (drop 0.75, p_remain
     0.9, joint q8; K1 60, D 60, 30 short-key backward calls: the
     recompute backward on the self-attention). Each step prints its seconds, loss, the LoRA
     gradient's norm, peak memory and launches, and fails unless loss and
     norm are finite and positive and the counts as stated. Then
     export_kohya -> merge_lora (on the CPU) -> a carved forward with the
     merged weights against the functional apply_lora forward, within
     2e-2 relative L2;
  16b. the same on HunyuanVideo-I2V token_replace at full width (3072,
     24 heads) cut to 2 + 4 blocks, 1280x720x33f, seeded conditioning and
     text (256 tokens, 40 padded): one carved step (the Base carve with
     the Turbo stage-0 text_amp 0.431, so the joint text rows and the
     bias are inside the recompute backward; K1 12) and one dense-fallback
     step (D 12, dK|dV 6, dQ 6 over the padded text's kv_len). A
     ``train:`` line gathers phases 16-16b.
  17. sequence parallelism (``jenga_tpu_torch/parallel``). In a 1-rank
     NCCL group (TCP store on 127.0.0.1, a free port; the card machine has
     one H100 and NCCL refuses two ranks on one device): (17a) phase 3's
     model and text (the same seeds), one carved Base step at
     1280x720x33f (joint q8) through forward(mesh=make_sp_mesh()) against
     the same forward without a mesh: the 60 planner masks equal, the
     output within 1e-3 relative L2, K1 launched 60 times and nothing
     else; (17b) the same for phase 4's Wan2.1-T2V-1.3B, one carved CFG
     step at 832x480x81f (30 masks, K1 and D 30 times each); (17c)
     ring_attention at HunyuanVideo's joint shape (2 x 24 heads, 32,400
     image tokens, 256 text keys, 216 valid in sample 0, none in sample
     1) against one D launch over the concatenated keys and, for sample
     1, over the image keys alone, within 1e-2 max abs and 2e-2 relative
     L2, D launched twice; (17d) each step timed plain, SP, SP, plain.
     Then (17e) two rank processes of this script on the one card in a
     gloo group (its all_to_all_single and all_gather_into_tensor take
     CUDA tensors; its point-to-point sends do not, so no ring): 17b's
     step through WanSampler(sp_degree=2) (FSDP weights, Ulysses), each
     rank's gathered output the same and within 2e-2 relative L2 of
     17b's, K1 and D 30 times on each rank. An ``sp:`` line gathers
     phase 17, with the card's name and power limit.
No module of jax or jenga_tpu may be loaded. The last two lines are the
kernels' JSON record and {"ok": true, "device": {...}}.
"""

import concurrent.futures
import contextlib
import dataclasses
import json
import math
import os
import re
import subprocess
import sys
import tempfile
import time
from unittest import mock

ROOT = os.path.dirname(os.path.abspath(__file__))
KERNEL_TOL = 1e-2   # max abs error, kernel vs plain, per case
# Phase 5 bound on ||v_kernel - v_plain|| / ||v_plain||. The kernels round
# P to bf16 before the P.V product and accumulate in another order, about
# 2^-9 relative per attention output; the blocks and the head compound it,
# and a bf16-level change in a block's q/k can flip a near-tied block of
# the next planner call. A masking or indexing fault changes whole rows
# and gives errors of order 1.
E2E_REL_TOL = 2e-2
POOL_TOL = 1e-4     # P3: f32 sums of 128 bf16 values, in another order
# Phase 2's K1/K1m/K2/D cases, and P1, P2, P4: besides KERNEL_TOL, a bound
# on ||out - plain|| / ||plain|| over the checked rows. At the main shapes a
# row attends 10k-35k keys of unit randn values and |o| is ~1e-2, so an
# absolute 1e-2 alone would pass a wrong block; the bf16 rounding of P and
# of the output is ~2^-9 relative (~0.3% in all), while one block dropped
# or added per row, or text_amp applied where it is not, moves a row by
# several percent.
KERNEL_REL_TOL = 2e-2
PROBE_REL_TOL = KERNEL_REL_TOL
# D's backward cases: besides KERNEL_REL_TOL, each gradient's max abs
# error within 1e-2 of its largest element. The gradients are sums over
# every query (dK, dV) or key (dQ), so their scale follows the shape (dK
# over 512 keys reaches |4| where bf16 storage alone rounds by 0.008);
# P and dS are rounded to bf16 before their products, ~2^-9 relative,
# while a masking or tiling fault moves whole rows by their own size.
BWD_ABS_TOL = 1e-2
PEAK_FLOPS = 989e12     # H100 SXM bf16 dense tensor-core peak
PEAK_F32 = 67e12        # H100 SXM f32 outside the tensor cores
PEAK_BYTES = 3.35e12    # H100 SXM HBM3
TILE_FLOP = 4 * 128 ** 3    # QK^T and PV of one 128x128 tile, d = 128
WAN_GRID = (21, 30, 52)     # 832x480x81f: 32,760 tokens, 256 blocks
WAN_GRID0 = (21, 22, 39)    # its Turbo stage 0: 18,018 tokens, 141 blocks
HY_GRID0 = (9, 33, 60)      # HY 1280x720x33f Turbo stage 0: 17,820 tokens
# the Turbo stage-0 text amplitude, -log2(sqrt(token ratio to full res))
HY_AMP0 = -math.log2(math.sqrt(33 * 60 / (45 * 80)))
# the design of K1/K1m/K2 and D (the kernels line's `design`)
DESIGN = ("sm_90a mainloop csrc/attn_sm90.cuh: a TMA producer warp "
          "(setmaxnreg 40) feeding a 2-stage mbarrier ring of K|V tiles "
          "(3-D tensor maps, 128-byte swizzle), two wgmma consumer "
          "warpgroups of 64 query rows (setmaxnreg 232), S = QK^T "
          "m64n128k16 from shared memory, O += PV with P from registers")
# the design of D's short-key kernel (the kernels line's `short_design`)
SHORT_DESIGN = ("sm_90a csrc/dense_attn_short.cu on the attn_sm90.cuh "
                "primitives (not its mainloop), for Skv <= 512: persistent "
                "blocks, one per SM, each walking a contiguous head-major run "
                "of (batch*head, 128-row query tile) units; K of all the "
                "head's keys resident in shared memory (loaded once per head "
                "under one barrier), V resident too up to 384 keys, else "
                "through a 2-stage ring; P V of the last key tile over its "
                "16-key chunks only (1, 2, 4 or 8, a template parameter); a "
                "TMA producer warp (setmaxnreg 24), two wgmma consumer "
                "warpgroups of 64 rows (setmaxnreg 240) copying Q into "
                "registers as it lands, the last P V of a tile issued with S "
                "of the next tile's first key tile, the warpgroups taking "
                "turns on two named barriers (ping-pong); exact online "
                "softmax, kv_len masking by select; 4-D tensor maps over the "
                "caller's strides, so [B, S, H, D] is read and written "
                "without a copy")
# the design of D's short-key backward (the kernels line's `design`)
BWD_SHORT_DESIGN = ("sm_90a csrc/dense_attn_bwd_short.cu on the attn_sm90.cuh "
                    "primitives, for Skv <= 512, one call of three kernels: "
                    "bwd_dq_short, persistent (one block per SM over a "
                    "head-major run of (batch*head, 128-row query tile) "
                    "units), K of the head resident, V resident up to 320 "
                    "keys else a 4-stage ring, 32-key sub-tiles, Q and dO "
                    "copied into registers as they land, di = rowsum(dO O) "
                    "from the dO tile and O rows prefetched into L2, S and dP "
                    "m64n32k16 and dQ += dS K m64n128k16 issued together, the "
                    "two consumer warpgroups taking turns on named barriers; "
                    "bwd_dkv_short over (128-key tile, query chunk, "
                    "batch*head) with the key tile fastest, the chunk count "
                    "set to fill the card's waves, K and V of the tile "
                    "resident, a 2-stage ring of 64-row Q, dO, lse and di, "
                    "S^T, dP^T m64n64k16 and dV, dK m64n128k16, ping-pong, a "
                    "last tile of <= 64 keys run by both warpgroups over two "
                    "query tiles a stage; bwd_dkv_reduce summing the f32 "
                    "partials in a fixed order; 4-D tensor maps over the "
                    "caller's strides, gradients written with the operands' "
                    "layouts")
# the design of P4 (its kernels-line `design`)
P4_DESIGN = ("sm_90a csrc/cross_attn_resident.cu on the attn_sm90.cuh "
             "primitives (not its mainloop): K of all 512 keys (128 KB) "
             "loaded once per thread block under one barrier and resident; "
             "a TMA producer warp (setmaxnreg 40) loading each query tile's "
             "Q into one buffer and V through a 2-stage mbarrier ring; two "
             "wgmma consumer warpgroups of 64 rows (setmaxnreg 232) copying "
             "Q into registers as it lands (the next Q loads during the "
             "whole tile), S = QK^T with Q from registers, four steps per "
             "query tile each issuing PV of key tile kt-1 with S of the next "
             "key tile (the last with the next query tile's first), the "
             "warpgroups taking turns on two named barriers (ping-pong); "
             "exact online softmax")


def fail(msg: str):
    print(f"FAIL: {msg}", flush=True)
    sys.exit(1)


def phase(name):
    print(f"== {name}", flush=True)
    return time.perf_counter()


def done(t0):
    print(f"   phase seconds: {time.perf_counter() - t0:.3f}", flush=True)


def gpu_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()


def bound(flop: float, nbytes: float, peak: float = PEAK_FLOPS):
    """(least ms the card could take, "operations" or "bytes")."""
    ops_ms, bytes_ms = flop / peak * 1e3, nbytes / PEAK_BYTES * 1e3
    return (max(ops_ms, bytes_ms),
            "operations" if ops_ms >= bytes_ms else "bytes")


def attn_bound(tiles: int, q, k):
    """Bound of an attention over ``tiles`` 128x128 (query, key) tiles:
    q, k, v read once, o written once."""
    return bound(tiles * TILE_FLOP,
                 2 * (q.numel() + k.numel()) * q.element_size())


def time_ms(fn, reps: int) -> float:
    """Mean ms of ``fn()`` on the card over at least ``reps`` calls after a
    warm-up (more for a short call; the probe tools' timer)."""
    import torch
    from jenga_tpu_torch.tools._common import time_ms as tools_time_ms
    return tools_time_ms(fn, reps, torch.device("cuda"))


def phase_toolchain():
    import torch
    from jenga_tpu_torch.ops import attention_probe as ap
    from jenga_tpu_torch.ops import block_pool as bp
    from jenga_tpu_torch.ops import block_sparse_attention as bsa
    from jenga_tpu_torch.ops import cross_attention_resident as xr
    from jenga_tpu_torch.ops import flash_attention as fa
    from torch.utils.cpp_extension import CUDA_HOME
    t0 = phase("1. toolchain")
    print(f"python {sys.version.split()[0]}  torch {torch.__version__}  "
          f"torch.version.cuda {torch.version.cuda}")
    nvcc = subprocess.run([os.path.join(CUDA_HOME, "bin", "nvcc"),
                           "--version"], capture_output=True, text=True)
    print(nvcc.stdout.strip().splitlines()[-1])
    print(f"gpu: {gpu_line()}")
    tb = time.perf_counter()
    # (source, build function, production): spills fail the production ones
    sources = [(m.KERNEL_SOURCE, m.build_kernel, m in (bsa, fa, xr))
               for m in (bsa, fa, ap, bp, xr)]
    sources.append((fa.SHORT_KERNEL_SOURCE, fa.build_short_kernel, True))
    sources.append((fa.BWD_KERNEL_SOURCE, fa.build_bwd_kernel, True))
    sources.append((fa.BWD_SHORT_KERNEL_SOURCE, fa.build_bwd_short_kernel,
                    True))
    with concurrent.futures.ThreadPoolExecutor(len(sources)) as pool:
        libs = list(pool.map(lambda e: e[1](), sources))
    print(f"built all {len(sources)} kernel sources in "
          f"{time.perf_counter() - tb:.3f} s")
    for (source, _, production), lib in zip(sources, libs):
        print(f"   {os.path.relpath(source, ROOT)} -> "
              f"{os.path.relpath(lib._name, ROOT)}")
        log = open(os.path.join(os.path.dirname(lib._name),
                                "ptxas.log")).read()
        for line in log.splitlines():
            if any(w in line for w in ("registers", "spill", "smem",
                                       "arning", "Performance")):
                print(f"   ptxas: {line.strip()}")
        spills = [(int(st), int(ld)) for st, ld in re.findall(
            r"(\d+) bytes spill stores, (\d+) bytes spill loads", log)]
        if production and (not spills or any(st or ld for st, ld
                                             in spills)):
            fail(f"{source.name}: ptxas reports spills (or no spill line) "
                 f"in a production or redesigned instance: {spills}")
    done(t0)


def _errors(name, out, ref):
    """{"max_abs_err", "rel_err"} of a kernel's output against its plain
    version; fails on a non-finite output. The bounds are checked by the
    caller, after the case's record is printed."""
    import torch
    from jenga_tpu_torch.tools._common import rel_err, sq_sums
    if not torch.isfinite(out).all():
        fail(f"{name}: non-finite kernel output")
    return {"max_abs_err": (out.float() - ref).abs().max().item(),
            "rel_err": rel_err(*sq_sums(out, ref))}


def _check(name, rec, rel_tol=KERNEL_REL_TOL):
    if not (rec["max_abs_err"] <= KERNEL_TOL and rec["rel_err"] <= rel_tol):
        fail(f"{name}: max abs error {rec['max_abs_err']} (bound "
             f"{KERNEL_TOL}), relative error {rec['rel_err']} (bound "
             f"{rel_tol})")


def _qkv(gen, b, h, s, d=128, skv=None):
    import torch
    return [torch.randn((b, h, n, d), generator=gen, device="cuda",
                        dtype=torch.bfloat16) for n in (s, skv or s,
                                                        skv or s)]


def _flex_ms(rec, out, q, k, v, idx, cnt, seqlens, **kw):
    """Time flex_attention (compiled) on the kernel's operands into rec:
    library_ms, its compile seconds and its max abs difference to the
    kernel. A yardstick only: a failure is recorded, not fatal."""
    from jenga_tpu_torch.tools.library_baseline import flex_block_sparse
    try:
        t0 = time.perf_counter()
        flex = flex_block_sparse(q, k, v, idx, cnt, seqlens, **kw)
        rec["library_max_abs_diff"] = (flex().float() - out.float()).abs() \
            .max().item()
        rec["library_compile_s"] = time.perf_counter() - t0
        rec["library_ms"] = time_ms(flex, 10)
    except Exception as e:
        rec["library_ms"] = None
        rec["library_error"] = f"{type(e).__name__}: {str(e)[:300]}"


def _case(name, q, k, v, idx, cnt, seqlens, q_rows, tsb, amp, fixed_max,
          members=None, library=False):
    import torch
    from jenga_tpu_torch.ops.block_sparse_attention import (
        block_sparse_attention, block_sparse_attention_plain, lists_to_mask)
    kw = dict(q_rows=q_rows, members=members, text_amp=amp,
              text_start_block=tsb, fixed_max=fixed_max)
    out = block_sparse_attention(q, k, v, idx, cnt, seqlens, **kw)
    torch.cuda.synchronize()
    ref = block_sparse_attention_plain(q.float(), k.float(), v.float(), idx,
                                       cnt, seqlens, **kw)
    errs = _errors(name, out, ref)
    del ref
    # density: the share of key blocks each query block attends
    rows = lists_to_mask(idx, cnt, q_rows, q.shape[2] // 128, members)
    rec = {"kernel": "block_sparse_attn", "case": name,
           "mode": "members" if members is not None else "all_member",
           "shape": list(q.shape), "q_rows": q_rows, "text_amp": amp,
           "fixed_max": fixed_max,
           "density": round(rows.float().mean().item(), 4),
           "list_density": round(cnt.float().mean().item() / idx.shape[-1],
                                 4),
           **errs}
    rec["ms"] = time_ms(lambda: block_sparse_attention(
        q, k, v, idx, cnt, seqlens, **kw), 10)
    rec["plain_ms"] = time_ms(lambda: block_sparse_attention_plain(
        q, k, v, idx, cnt, seqlens, **kw), 2)
    rec["bound_ms"], rec["bound_by"] = attn_bound(int(rows.sum().item()),
                                                  q, k)
    if library:
        _flex_ms(rec, out, q, k, v, idx, cnt, seqlens, q_rows=q_rows,
                 members=members, text_amp=amp, text_start_block=tsb)
    print(f"   {json.dumps(rec)}", flush=True)
    _check(name, rec)
    return rec, out


def _dense_case(name, q, k, v, kv_len=None, route=None):
    """D vs its plain version on one case, timed with its bound and SDPA;
    the record's ``route`` is the forward kernel the call launched (from
    the counters), which must be ``route`` and ``dense_route(Skv)``."""
    import torch
    from jenga_tpu_torch.ops.flash_attention import (dense_attention,
                                                     dense_attention_plain,
                                                     dense_route)
    from jenga_tpu_torch.tools.library_baseline import sdpa_flash
    short0 = dense_attention.short_launches
    out = dense_attention(q, k, v, kv_len=kv_len)
    torch.cuda.synchronize()
    took = ("short" if dense_attention.short_launches > short0
            else "mainloop")
    ref = dense_attention_plain(q.float(), k.float(), v.float(),
                                kv_len=kv_len)
    errs = _errors(name, out, ref)
    del ref
    b, h, sq, d = q.shape
    skv = k.shape[2]
    keys = b * skv if kv_len is None else sum(
        min(max(int(x), 0), skv) for x in kv_len.tolist())
    rec = {"kernel": "dense_attn", "case": name, "route": took,
           "q": list(q.shape), "kv": list(k.shape),
           "kv_len": None if kv_len is None else kv_len.tolist(),
           **errs}
    rec["ms"] = time_ms(lambda: dense_attention(q, k, v, kv_len=kv_len), 10)
    rec["plain_ms"] = time_ms(lambda: dense_attention_plain(
        q, k, v, kv_len=kv_len), 2)
    rec["tflops"] = 4.0 * h * sq * keys * d / (rec["ms"] * 1e-3) / 1e12
    rec["bound_ms"], rec["bound_by"] = bound(
        4.0 * h * sq * keys * d, 2 * (q.numel() + k.numel()) * 2)
    # SDPA has no per-sample key length on its flash backend
    rec["library_ms"] = (None if kv_len is not None else
                         time_ms(lambda: sdpa_flash(q, k, v), 10))
    print(f"   {json.dumps(rec)}", flush=True)
    _check(name, rec)
    if took != dense_route(skv) or (route is not None and took != route):
        fail(f"{name}: D took the {took} route, expected {route} "
             f"(dense_route: {dense_route(skv)})")
    return rec, out


def _device_kernels(fn):
    """Names of the CUDA kernels one call of fn() runs (torch.profiler)."""
    import torch
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        fn()
        torch.cuda.synchronize()
    return [e.name for e in prof.events()
            if e.device_type == torch.autograd.DeviceType.CUDA]


def _bshd_case(name, q, pairs):
    """attention_bshd as Wan's cross-attention calls it: q [B, S, H, D] from
    the model's projection, each (k, v) [B, Skv, H, D], the outputs summed
    (the I2V block adds the image keys' attention to the text keys') and
    reshaped to [B, S, H * D]. Against the plain version in f32, timed with
    its bound (q, each k and v read once, the sum written once) and SDPA
    (flash) on the same operands and layout; one call must run the
    short-key kernel once a pair and an add between, no copy, and the
    single attention's output must be contiguous [B, S, H, D] (the
    model's reshape a view)."""
    import torch
    from jenga_tpu_torch.ops.flash_attention import (attention_bshd,
                                                     dense_attention,
                                                     dense_attention_plain)
    from jenga_tpu_torch.tools.library_baseline import sdpa_flash
    b, s, h, d = q.shape

    def call(attn=attention_bshd):
        out = attn(q, *pairs[0])
        for k, v in pairs[1:]:
            out = out + attn(q, k, v)
        return out.reshape(b, s, h * d)

    def bhsd(fn, *xs):
        return fn(*(x.transpose(1, 2) for x in xs)).transpose(1, 2)
    short0 = dense_attention.short_launches
    got = call()
    torch.cuda.synchronize()
    shorts = dense_attention.short_launches - short0
    ref = sum(bhsd(dense_attention_plain, q.float(), k.float(), v.float())
              for k, v in pairs).reshape(b, s, h * d)
    rec = {"kernel": "dense_attn", "case": name, "route": "short",
           "call": "attention_bshd", "q": list(q.shape),
           "kv": [list(k.shape) for k, _ in pairs],
           **_errors(name, got, ref)}
    del ref, got
    kernels = _device_kernels(call)
    rec["device_kernels"] = len(kernels)
    rec["short_kernels"] = sum("dense_kernel_short" in n for n in kernels)
    single = attention_bshd(q, *pairs[0])
    rec["output_contiguous"] = single.is_contiguous()
    del single
    rec["ms"] = time_ms(call, 10)
    rec["plain_ms"] = time_ms(lambda: call(
        lambda *xs: bhsd(dense_attention_plain, *xs)), 2)
    flop = sum(4.0 * b * h * s * k.shape[1] * d for k, _ in pairs)
    nbytes = 2 * (2 * q.numel() + sum(k.numel() + v.numel()
                                      for k, v in pairs))
    rec["tflops"] = flop / (rec["ms"] * 1e-3) / 1e12
    rec["bound_ms"], rec["bound_by"] = bound(flop, nbytes)
    rec["library_ms"] = time_ms(lambda: call(
        lambda *xs: bhsd(sdpa_flash, *xs)), 10)
    print(f"   {json.dumps(rec)}", flush=True)
    _check(name, rec)
    if shorts != len(pairs) or rec["short_kernels"] != len(pairs) or \
            rec["device_kernels"] != 2 * len(pairs) - 1 or \
            not rec["output_contiguous"]:
        fail(f"{name}: attention_bshd ran {rec['device_kernels']} kernels, "
             f"{rec['short_kernels']} of them the short-key kernel "
             f"({shorts} counted), output contiguous "
             f"{rec['output_contiguous']}: expected {len(pairs)} short-key "
             f"launches, an add between, no copy")
    return rec


def _sdpa_bwd_ms(q, k, v, do):
    """ms of the SDPA (flash) backward alone on the same operands: dq, dk
    and dv from one retained graph. A yardstick only, never on the path."""
    import torch
    from jenga_tpu_torch.tools.library_baseline import sdpa_flash
    qg, kg, vg = (x.detach().requires_grad_() for x in (q, k, v))
    out = sdpa_flash(qg, kg, vg)
    return time_ms(lambda: torch.autograd.grad(
        out, (qg, kg, vg), do, retain_graph=True), 10)


def _kernel_device_ms(fn, reps: int = 5) -> dict:
    """{kernel name: device ms of one launch} from torch.profiler over
    ``reps`` calls of fn() after a warm-up, for a call that launches each
    of its kernels once (the short-key backward's three kernels run from
    one C call, so each is timed on the card by its own events). The mean
    over the launches the profiler recorded: after an earlier session in
    the process it has been seen to drop the first."""
    import torch
    fn()
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    times = {}
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            m = re.search(r"bwd_\w+", e.name)
            times.setdefault(m.group(0) if m else e.name, []).append(
                e.device_time / 1e3)
    return {k: sum(v) / len(v) for k, v in times.items()}


def _bwd_counts():
    from jenga_tpu_torch.ops.flash_attention import dense_attention_backward
    return (dense_attention_backward.dkv_launches,
            dense_attention_backward.dq_launches,
            dense_attention_backward.short_launches)


def _check_bwd_errors(name, errs):
    for g, e in errs.items():
        if not (e["max_abs_err"] <= BWD_ABS_TOL * e["ref_max"]
                and e["rel_err"] <= KERNEL_REL_TOL):
            fail(f"{name} {g}: max abs error {e['max_abs_err']} (bound "
                 f"{BWD_ABS_TOL} x {e['ref_max']}), relative error "
                 f"{e['rel_err']} (bound {KERNEL_REL_TOL})")


def _dense_bwd_case(name, gen, q, k, v, kv_len=None):
    """D's backward on the route of its key count against the plain
    backward on the card's own forward output and statistics: max abs and
    relative L2 error of each gradient, ms of the dK|dV and the dQ kernels
    (over 512 keys each kernel alone on the wrapper's operands, by CUDA
    events; up to 512 keys the short-key call's kernels by their device
    time, the chunks' sum counted with dK|dV) and of the pair through the
    wrapper (with di and, over 512 keys, the padded statistics), the plain
    backward's ms, the bounds, and the SDPA backward's ms where SDPA takes
    the case (no per-sample key length). The record's ``route`` is the one
    the counters show, which must be ``dense_route(Skv)``."""
    import torch
    from jenga_tpu_torch.ops import flash_attention as fa
    b, h, sq, d = q.shape
    skv = k.shape[2]
    o, lse = fa.dense_attention_forward(q, k, v, kv_len=kv_len,
                                        with_lse=True)
    do = torch.randn(q.shape, generator=gen, device="cuda",
                     dtype=torch.bfloat16)
    before = _bwd_counts()
    got = fa.dense_attention_backward(q, k, v, o, lse, do, kv_len=kv_len)
    torch.cuda.synchronize()
    counts = tuple(x - y for x, y in zip(_bwd_counts(), before))
    took = {(0, 0, 1): "short", (1, 1, 0): "mainloop"}.get(counts, counts)
    ref = fa.dense_attention_backward_plain(q.float(), k.float(), v.float(),
                                            o.float(), lse, do.float(),
                                            kv_len=kv_len)
    errs = {g: {**_errors(f"{name} {g}", x, y),
                "ref_max": y.abs().max().item()}
            for g, x, y in zip(("dq", "dk", "dv"), got, ref)}
    del got, ref
    keys = b * skv if kv_len is None else sum(
        min(max(int(x), 0), skv) for x in kv_len.tolist())
    pairs = h * sq * keys * d       # (query, valid key, dim) products
    rec = {"kernel": "dense_attn_bwd", "case": name, "route": took,
           "q": list(q.shape), "kv": list(k.shape),
           "kv_len": None if kv_len is None else kv_len.tolist(),
           "max_abs_err": max(e["max_abs_err"] for e in errs.values()),
           "rel_err": max(e["rel_err"] for e in errs.values()),
           "errors": errs}
    if took == "short":
        per = _kernel_device_ms(lambda: fa.dense_attention_backward(
            q, k, v, o, lse, do, kv_len=kv_len))
        rec["dq_ms"] = per.get("bwd_dq_short", 0.0)
        rec["dkv_ms"] = (per.get("bwd_dkv_short", 0.0)
                         + per.get("bwd_dkv_reduce", 0.0))
        rec["device_kernels"] = sorted(per)
    else:
        # each kernel alone on the wrapper's own operands
        sq_pad = -(-sq // 128) * 128
        lse_p = fa._padded_rows(lse, sq_pad, float("inf"))
        di_p = fa._padded_rows((do.float() * o.float()).sum(-1), sq_pad,
                               0.0)
        kl = fa._kv_len_int32(kv_len, b, q.device)
        dq, dk, dv = (torch.empty_like(x) for x in (q, k, v))
        lib = fa.build_bwd_kernel()
        stream = torch.cuda.current_stream().cuda_stream
        common = (q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
                  lse_p.data_ptr(), di_p.data_ptr(),
                  None if kl is None else kl.data_ptr())
        tail = (b * h, h, sq, skv, d ** -0.5, stream)
        rec["dkv_ms"] = time_ms(lambda: lib.dense_attn_bwd_dkv(
            *common, dk.data_ptr(), dv.data_ptr(), *tail), 10)
        rec["dq_ms"] = time_ms(lambda: lib.dense_attn_bwd_dq(
            *common, dq.data_ptr(), *tail), 10)
        del lse_p, di_p, dq, dk, dv
    rec["ms"] = time_ms(lambda: fa.dense_attention_backward(
        q, k, v, o, lse, do, kv_len=kv_len), 10)
    rec["plain_ms"] = time_ms(lambda: fa.dense_attention_backward_plain(
        q, k, v, o, lse, do, kv_len=kv_len), 2)
    # products and bf16 tensors read or written once: dkv S, dP, dV, dK
    # (q do k v -> dk dv); dq S, dP, dQ (q do k v -> dq); the pair S, dP,
    # dV, dK, dQ (q o do k v -> dq dk dv, o for di)
    nq, nk = q.numel(), k.numel()
    for key, gemms, tensors in (("dkv", 4, 2 * nq + 4 * nk),
                                ("dq", 3, 3 * nq + 2 * nk),
                                ("pair", 5, 4 * nq + 4 * nk)):
        rec[f"{key}_bound_ms"], rec[f"{key}_bound_by"] = bound(
            2.0 * gemms * pairs, 2 * tensors)
    rec["bound_ms"], rec["bound_by"] = rec["pair_bound_ms"], \
        rec["pair_bound_by"]
    rec["library_ms"] = (None if kv_len is not None else
                         _sdpa_bwd_ms(q, k, v, do))
    print(f"   {json.dumps(rec)}", flush=True)
    _check_bwd_errors(name, errs)
    if took != fa.dense_route(skv):
        fail(f"{name}: D's backward took {took} (dK|dV, dQ, short-key "
             f"launches), expected the {fa.dense_route(skv)} route")
    if kv_len is not None and kv_len.min().item() <= 0:
        i = int(kv_len.argmin())
        got = fa.dense_attention_backward(q, k, v, o, lse, do, kv_len=kv_len)
        if any(x[i].any() for x in got):
            fail(f"{name}: the kv_len 0 sample's gradients are not all 0")
    return rec


def _bshd_bwd_case(name, gen, q, pairs):
    """The backward of Wan's cross-attention as the model calls it:
    ``attention_bshd`` on q [B, S, H, D] over each (k, v) [B, Skv, H, D]
    pair, the outputs summed and reshaped to [B, S, H * D], under autograd.
    Against the plain forward and backward in f32: the gradients of q (the
    pairs' sum) and of each k and v; ms of the backward alone
    (``torch.autograd.grad`` on a retained graph), of the plain backward
    and of SDPA's (flash) on the same operands and layout; the bound (q, do
    and each o read once, k and v read once, every gradient written once;
    five products a pair). One backward must run the short-key call once a
    pair (the counters) and no copy kernel (the profiler), and give [B, S,
    H, D] gradients."""
    import torch
    from jenga_tpu_torch.ops import flash_attention as fa
    from jenga_tpu_torch.tools.library_baseline import sdpa_flash
    b, s, h, d = q.shape
    leaves = [q.requires_grad_()] + [x.requires_grad_() for kv in pairs
                                     for x in kv]
    g = torch.randn((b, s, h * d), generator=gen, device="cuda",
                    dtype=torch.bfloat16)

    def forward(attn):
        out = attn(q, *pairs[0])
        for k, v in pairs[1:]:
            out = out + attn(q, k, v)
        return out.reshape(b, s, h * d)

    def bhsd(fn, *xs):
        return fn(*(x.transpose(1, 2) for x in xs)).transpose(1, 2)
    out = forward(fa.attention_bshd)
    before = _bwd_counts()
    grads = torch.autograd.grad(out, leaves, g, retain_graph=True)
    torch.cuda.synchronize()
    counts = tuple(x - y for x, y in zip(_bwd_counts(), before))
    layouts = all(x.shape == y.shape and x.is_contiguous()
                  for x, y in zip(grads, leaves))
    # the plain reference: forward and backward in f32 per pair
    gt = g.reshape(b, s, h, d).transpose(1, 2).float()
    qt = q.detach().transpose(1, 2).float()
    ref = [torch.zeros_like(qt)]
    for k, v in pairs:
        kt, vt = (x.detach().transpose(1, 2).float() for x in (k, v))
        o, lse = fa._plain_forward(qt, kt, vt, d ** -0.5, None, True)
        dq, dk, dv = fa.dense_attention_backward_plain(qt, kt, vt, o, lse,
                                                       gt)
        ref[0] += dq
        ref += [dk, dv]
        del o, lse
    errs = {}
    names = ["dq"] + [f"{t}{i}" for i in range(len(pairs))
                      for t in ("dk", "dv")]
    for nm, x, y in zip(names, grads, ref):
        x = x.transpose(1, 2)
        errs[nm] = {**_errors(f"{name} {nm}", x, y),
                    "ref_max": y.abs().max().item()}
    del ref, grads
    # the kernels one backward runs, on the calling thread (the engine's
    # own device thread launches out of the profiler's sight); the
    # profiler has been seen to miss the short-key call's first kernel
    # after earlier sessions in the process, so the launches are checked
    # by the counters and the kernel names only for copies
    with torch.autograd.set_multithreading_enabled(False):
        kernels = _device_kernels(lambda: torch.autograd.grad(
            out, leaves, g, retain_graph=True))
    rec = {"kernel": "dense_attn_bwd", "case": name, "route": "short",
           "call": "attention_bshd", "q": list(q.shape),
           "kv": [list(k.shape) for k, _ in pairs],
           "max_abs_err": max(e["max_abs_err"] for e in errs.values()),
           "rel_err": max(e["rel_err"] for e in errs.values()),
           "errors": errs, "gradients_bshd": layouts,
           "device_kernels": sorted({re.sub(r"\(.*", "", n)[-60:]
                                     for n in kernels}),
           "copy_kernels": sum("copy" in n for n in kernels)}
    rec["ms"] = time_ms(lambda: torch.autograd.grad(
        out, leaves, g, retain_graph=True), 10)
    o_l = [fa.dense_attention_forward(q.detach().transpose(1, 2),
                                      k.detach().transpose(1, 2),
                                      v.detach().transpose(1, 2),
                                      with_lse=True) for k, v in pairs]
    gq = g.reshape(b, s, h, d).transpose(1, 2)
    rec["plain_ms"] = time_ms(lambda: [fa.dense_attention_backward_plain(
        q.detach().transpose(1, 2), k.detach().transpose(1, 2),
        v.detach().transpose(1, 2), o, lse, gq)
        for (k, v), (o, lse) in zip(pairs, o_l)], 2)
    del o_l
    flop = sum(10.0 * b * h * s * k.shape[1] * d for k, _ in pairs)
    nbytes = 2 * ((3 + len(pairs)) * q.numel()
                  + 4 * sum(k.numel() for k, _ in pairs))
    rec["tflops"] = flop / (rec["ms"] * 1e-3) / 1e12
    rec["bound_ms"], rec["bound_by"] = bound(flop, nbytes)
    s_out = forward(lambda *xs: bhsd(sdpa_flash, *xs))
    rec["library_ms"] = time_ms(lambda: torch.autograd.grad(
        s_out, leaves, g, retain_graph=True), 10)
    del s_out, out
    for x in leaves:
        x.requires_grad_(False)
    print(f"   {json.dumps(rec)}", flush=True)
    _check_bwd_errors(name, errs)
    if counts != (0, 0, len(pairs)) or rec["copy_kernels"] or not layouts:
        fail(f"{name}: the backward counted {counts} (dK|dV, dQ, short-key "
             f"launches) and ran {rec['copy_kernels']} copies, [B, S, H, D] "
             f"gradients {layouts}: expected {len(pairs)} short-key calls, "
             f"no copy")
    return rec


def _planner_mask(q, k, nkb, tsb, sel_group, **kw):
    """The planner's selection for the video rows (top_k at drop 0.75),
    with the text rows attending everything, as the HY model builds it."""
    import torch
    from jenga_tpu_torch.sparse.planner import build_block_mask
    m = build_block_mask(q[:, :, :tsb * 128], k, top_k=int(0.25 * tsb),
                         text_start_block=tsb, text_blocks=nkb - tsb,
                         sel_group=sel_group, **kw)
    full = torch.ones((*m.shape[:2], nkb - tsb, nkb), dtype=torch.bool,
                      device="cuda")
    return torch.cat([m, full], 2)


def _planner_lists(q, k, nkb, tsb, q_rows=8, **kw):
    """Joint q8 (or per-row q1) planner lists: (indices, counts)."""
    from jenga_tpu_torch.ops.sparse_dispatch import block_lists_from_mask
    idx, cnt, _ = block_lists_from_mask(
        _planner_mask(q, k, nkb, tsb, q_rows, **kw), q_rows, q_rows > 1)
    return idx, cnt


def _member_cases(name, q, k, v, mask, sl, tsb, amp, epilogues=(True,),
                  per_row=False, library=False):
    """Membership mode: the per-row mask packed as q8 union lists with
    membership words, vs the plain version; with ``per_row`` the per-row
    mode (q_rows=1) runs on the same mask, and the two outputs must be
    identical (each query block attends its own blocks in the same
    order)."""
    import torch
    from jenga_tpu_torch.ops.sparse_dispatch import block_lists_from_mask
    idx, cnt, mem = block_lists_from_mask(mask, 8)
    recs = []
    for fm in epilogues:
        rec, out = _case(name, q, k, v, idx, cnt, sl, 8, tsb, amp, fm, mem,
                         library=library and fm == epilogues[0])
        recs.append(rec)
        empty = ~mask.any(dim=-1)           # [B, H, nqb] rows with no block
        for bi, hi, r in empty.nonzero().tolist():
            if out[bi, hi, r * 128:(r + 1) * 128].any():
                fail(f"{name}: empty row {(bi, hi, r)} is not all zeros")
    if per_row:
        idx1, cnt1, _ = block_lists_from_mask(mask, 1)
        rec1, out1 = _case(name + "_per_row_mode", q, k, v, idx1, cnt1, sl,
                           1, tsb, amp, epilogues[0])
        if not torch.equal(out, out1):
            fail(f"{name}: membership and per-row modes differ on the same "
                 f"mask")
        recs[0]["k2_ms_same_mask"] = rec1["ms"]
        recs.append(rec1)
    return recs


def phase_kernel_cases():
    import torch
    from jenga_tpu_torch.models.wan import WAN_T2V_1_3B, make_wan_carve
    from jenga_tpu_torch.ops.sparse_dispatch import block_lists_from_mask
    t0 = phase("2. kernels vs plain on the card")
    gen = torch.Generator(device="cuda").manual_seed(0)
    recs = []

    # per-row random lists, one empty row, text_amp < 0, seqlen cut
    s, nkb, tsb = 4096, 32, 30
    q, k, v = _qkv(gen, 1, 2, s)
    mask = torch.rand((1, 2, nkb, nkb), generator=gen, device="cuda") < 0.3
    mask[..., tsb:] = True
    mask[:, :, tsb:] = True
    mask[0, 0, 5] = False
    idx, cnt, _ = block_lists_from_mask(mask, 1)
    sl = torch.tensor([s - 40], dtype=torch.int32, device="cuda")
    for fm in (True, False):
        recs.append(_case("q1_random_lists", q, k, v, idx, cnt, sl, 1, tsb,
                          -0.5, fm)[0])

    # joint q8 planner lists: group 7 mixes video blocks 56-61 with the
    # text blocks 62-63 (a boundary group); text_amp > 0; seqlen cut
    s, nkb, tsb = 8192, 64, 62
    q, k, v = _qkv(gen, 1, 24, s)
    idx, cnt = _planner_lists(q, k, nkb, tsb, p_remain=0.3,
                              block_neighbors=None)
    sl = torch.tensor([s - 100], dtype=torch.int32, device="cuda")
    for fm in (True, False):
        recs.append(_case("q8_joint_boundary", q, k, v, idx, cnt, sl, 8,
                          tsb, 0.7, fm)[0])

    # HunyuanVideo's main shape: 32400 video + 256 text tokens, 256 blocks
    s, nkb, tsb = 32768, 256, 254
    q, k, v = _qkv(gen, 1, 24, s)
    idx, cnt = _planner_lists(q, k, nkb, tsb, p_remain=0.3,
                              block_neighbors=None)
    sl = torch.tensor([32400 + 256], dtype=torch.int32, device="cuda")
    main = _case("q8_joint_main_shape", q, k, v, idx, cnt, sl, 8, tsb, 0.0,
                 True, library=True)[0]
    recs.append(main)
    recs.append(_case("q8_joint_main_shape", q, k, v, idx, cnt, sl, 8, tsb,
                      0.0, False)[0])
    idx, cnt = _planner_lists(q, k, nkb, tsb, q_rows=1, p_remain=0.3,
                              block_neighbors=None)
    recs.append(_case("q1_main_shape", q, k, v, idx, cnt, sl, 1, tsb, 0.0,
                      True, library=True)[0])

    # membership mode (a): per-row planner selections (sel_group 1, drop
    # 0.75, p_remain 0.3) at the main shape, K2 on the same mask beside it
    mask = _planner_mask(q, k, nkb, tsb, 1, p_remain=0.3,
                         block_neighbors=None)
    member = _member_cases("a_members_main_shape", q, k, v, mask, sl, tsb,
                           0.0, per_row=True, library=True)
    del mask

    # Wan's shape: B=2 (CFG), 12 heads, 32,760 tokens + 8 pad = 256 blocks,
    # no text blocks (tsb = nkb), first-frame forcing, the 1.3b-base
    # p_remain and the curve's block adjacency
    carve = make_wan_carve(WAN_T2V_1_3B, WAN_GRID, 0.75, 0.9, q_rows=8,
                           joint_sel=True, device="cuda")
    q, k, v = _qkv(gen, 2, 12, s)
    idx, cnt = _planner_lists(
        q, k, nkb, nkb, p_remain=carve.p_remain,
        block_neighbors=carve.block_neighbors,
        first_frame_blocks=carve.first_frame_blocks)
    sl = torch.full((2,), carve.seqlen, dtype=torch.int32, device="cuda")
    print(f"   wan carve: first_frame_blocks {carve.first_frame_blocks}, "
          f"seqlen {carve.seqlen}")
    recs.append(_case("wan_q8_joint_first_frame", q, k, v, idx, cnt, sl, 8,
                      nkb, 0.0, True)[0])
    del q, k, v

    # Wan2.1-14B's self-attention shape (T2V and I2V): the same grid and
    # carve at 40 heads
    extra = {}
    q, k, v = _qkv(gen, 2, 40, s)
    idx, cnt = _planner_lists(
        q, k, nkb, nkb, p_remain=carve.p_remain,
        block_neighbors=carve.block_neighbors,
        first_frame_blocks=carve.first_frame_blocks)
    extra["k1_wan14b"], _ = _case("wan14b_q8_joint_first_frame", q, k, v,
                                  idx, cnt, sl, 8, nkb, 0.0, True,
                                  library=True)
    recs.append(extra["k1_wan14b"])
    del q, k, v, idx, cnt

    # (b) HY Turbo stage 0: 17,820 video + 256 text tokens = 142 blocks,
    # tsb 140; a video row with no block at all; both epilogues
    s, nkb, tsb = 142 * 128, 142, 140
    q, k, v = _qkv(gen, 1, 24, s)
    mask = _planner_mask(q, k, nkb, tsb, 1, p_remain=0.3,
                         block_neighbors=None)
    mask[0, 5, 17] = False
    sl = torch.tensor([17820 + 256], dtype=torch.int32, device="cuda")
    member += _member_cases("b_members_hy_turbo_stage0", q, k, v, mask, sl,
                            tsb, HY_AMP0, epilogues=(True, False))
    del q, k, v, mask

    # (c) Wan Turbo stage 0: B=2, 18,018 tokens + 30 pad = 141 blocks, no
    # text blocks, first-frame forcing, the curve's adjacency
    carve0 = make_wan_carve(WAN_T2V_1_3B, WAN_GRID0, 0.75, 0.9, q_rows=8,
                            joint_sel=False, device="cuda")
    nkb = 141
    q, k, v = _qkv(gen, 2, 12, nkb * 128)
    mask = _planner_mask(q, k, nkb, nkb, 1, p_remain=carve0.p_remain,
                         block_neighbors=carve0.block_neighbors,
                         first_frame_blocks=carve0.first_frame_blocks)
    sl = torch.full((2,), carve0.seqlen, dtype=torch.int32, device="cuda")
    print(f"   wan stage-0 carve: first_frame_blocks "
          f"{carve0.first_frame_blocks}, seqlen {carve0.seqlen}")
    member += _member_cases("c_members_wan_turbo_stage0", q, k, v, mask, sl,
                            nkb, 0.0)
    del q, k, v, mask

    # dense: (a) Wan self-attention, (b) Wan cross-attention over 512 keys,
    # (c) HunyuanVideo's joint dense shape with kv_len, (d) ragged small
    # (a, c: over 512 keys, the mainloop; b, d-f: the short-key kernel)
    dense = []
    q, k, v = _qkv(gen, 2, 12, 32768)
    rec, _ = _dense_case("a_wan_self", q, k, v, route="mainloop")
    dense.append(rec)
    del k, v
    _, k, v = _qkv(gen, 2, 12, 512)
    rec, _ = _dense_case("b_wan_cross", q, k, v, route="short")
    dense.append(rec)
    del q, k, v
    s = 32656
    q, k, v = _qkv(gen, 1, 24, s)
    kl = torch.tensor([s - 40], dtype=torch.int32, device="cuda")
    rec, _ = _dense_case("c_hy_joint_dense", q, k, v, kl, route="mainloop")
    dense.append(rec)
    del q, k, v
    q, k, v = _qkv(gen, 2, 12, 1000, skv=300)
    kl = torch.tensor([0, 137], dtype=torch.int32, device="cuda")
    rec, out = _dense_case("d_ragged_small", q, k, v, kl, route="short")
    dense.append(rec)
    if out[0].any():
        fail("d_ragged_small: the kv_len=0 sample is not all zeros")
    del q, k, v, out
    # Wan2.1-I2V-14B's two cross-attentions per block, 40 heads over the
    # padded 32,768 query rows: (e) the 257 CLIP image keys (a ragged last
    # key tile of one key), (f) the 512 text keys
    q = _qkv(gen, 2, 40, 32768)[0]
    for name, skv in (("e_wan14b_image_cross", 257),
                      ("f_wan14b_text_cross", 512)):
        _, k, v = _qkv(gen, 2, 40, skv)
        extra[name], _ = _dense_case(name, q, k, v, route="short")
        dense.append(extra[name])
        del k, v
    del q
    # the model's calls, timed as it makes them (attention_bshd on its
    # [B, S, H, D] projections over Wan's 32,760 rows): (g) Wan-1.3B's
    # cross-attention over the 512 text keys, (h) Wan2.1-I2V-14B's text
    # (512) and image (257) cross-attention on one q, summed
    def bshd(*shape):
        return torch.randn(shape, generator=gen, device="cuda",
                           dtype=torch.bfloat16)
    q = bshd(2, 32760, 12, 128)
    extra["g_bshd_wan13_cross"] = _bshd_case(
        "g_bshd_wan13_cross", q, [(bshd(2, 512, 12, 128),
                                   bshd(2, 512, 12, 128))])
    q = bshd(2, 32760, 40, 128)
    extra["h_bshd_wan14_i2v_cross"] = _bshd_case(
        "h_bshd_wan14_i2v_cross", q,
        [(bshd(2, n, 40, 128), bshd(2, n, 40, 128)) for n in (512, 257)])
    dense += [extra["g_bshd_wan13_cross"], extra["h_bshd_wan14_i2v_cross"]]
    del q
    # D's backward, on the route of its key count: (a) Wan self-attention
    # and (d) HunyuanVideo's joint dense shape with kv_len below Skv (the
    # padded text) take the dK|dV and dQ kernels; (b) Wan 1.3B's
    # cross-attention over 512 keys, (c) Wan2.1-14B's image
    # cross-attention over 257 keys, (e) its text cross-attention over 512
    # keys and (f) ragged kv_len (0, past Skv) over 32,760 rows take the
    # short-key call; then the model's calls under autograd, (g) Wan 1.3B's
    # cross-attention and (h) Wan2.1-I2V-14B's text and image
    # cross-attention on one q
    bwd = []
    q, k, v = _qkv(gen, 2, 12, 32768)
    bwd.append(_dense_bwd_case("a_wan_self", gen, q, k, v))
    _, k, v = _qkv(gen, 2, 12, 512)
    bwd.append(_dense_bwd_case("b_wan_cross", gen, q, k, v))
    del q, k, v
    q, k, v = _qkv(gen, 2, 40, 32768, skv=257)
    bwd.append(_dense_bwd_case("c_wan14b_image_cross", gen, q, k, v))
    _, k, v = _qkv(gen, 2, 40, 512)
    bwd.append(_dense_bwd_case("e_wan14b_text_cross", gen, q, k, v))
    del q, k, v
    s = 32656
    q, k, v = _qkv(gen, 1, 24, s)
    kl = torch.tensor([s - 40], dtype=torch.int32, device="cuda")
    bwd.append(_dense_bwd_case("d_hy_joint_dense", gen, q, k, v, kl))
    del q, k, v
    q, k, v = _qkv(gen, 2, 12, 32760, skv=257)
    kl = torch.tensor([0, 700], dtype=torch.int32, device="cuda")
    bwd.append(_dense_bwd_case("f_ragged_kv_len", gen, q, k, v, kl))
    del q, k, v
    q = bshd(2, 32760, 12, 128)
    bwd.append(_bshd_bwd_case("g_bshd_wan13_cross_bwd", gen, q,
                              [(bshd(2, 512, 12, 128),
                                bshd(2, 512, 12, 128))]))
    q = bshd(2, 32760, 40, 128)
    bwd.append(_bshd_bwd_case(
        "h_bshd_wan14_i2v_cross_bwd", gen, q,
        [(bshd(2, n, 40, 128), bshd(2, n, 40, 128)) for n in (512, 257)]))
    del q
    extra["bwd"] = bwd
    torch.cuda.empty_cache()
    done(t0)
    return recs, main, member, dense, extra


def _perturb(model, gen, scale=0.02):
    """Seeded noise on the zero-initialised layers (final layer and the
    refiner's adaLN), or the velocity would be exactly 0."""
    import torch
    with torch.no_grad():
        layers = [model.final_layer.linear, model.final_layer.adaLN] + [
            blk.adaLN for blk in model.txt_in.blocks]
        for lin in layers:
            lin.w.copy_(torch.randn(lin.w.shape, generator=gen,
                                    device=lin.w.device) * scale)


def _perturb_wan(model, gen, scale=0.02):
    """Seeded noise on Wan's zero-initialised head."""
    import torch
    w = model.head_layer.linear.w
    with torch.no_grad():
        w.copy_(torch.randn(w.shape, generator=gen, device=w.device) * scale)


def _text(gen, cfg, n_pad):
    import torch
    n = 256
    txt = torch.randn((n, cfg.text_states_dim), generator=gen,
                      device="cuda")
    mask = torch.ones((n,), dtype=torch.int32, device="cuda")
    mask[n - n_pad:] = 0
    txt2 = torch.randn((cfg.text_states_dim_2,), generator=gen,
                       device="cuda")
    return txt, mask, txt2


PROBES = ("attn_probe_split", "attn_probe_epilogue", "block_pool",
          "cross_attn_resident")   # P1-P4: no main path launches them
BWD = ("dense_attn_bwd_dkv", "dense_attn_bwd_dq",
       "dense_attn_bwd_short")                       # only training does
NOT_SERVING = dict.fromkeys(PROBES + BWD, 0)


class _Launches:
    """The kernels' launch counts over one path's run: set to 0 on entry,
    read on exit. The block-sparse wrapper counts its all-member launches
    (K1/K2) and its membership-mode launches (K1m) apart, D its launches
    and, among them, those of the short-key kernel, the probe wrapper its
    P1 and P2 launches, D's backward its dK|dV and dQ launches (over 512
    keys) and its short-key calls."""

    def __enter__(self):
        from jenga_tpu_torch.ops.attention_probe import attention_probe
        from jenga_tpu_torch.ops.block_pool import block_pool
        from jenga_tpu_torch.ops.block_sparse_attention import (
            block_sparse_attention)
        from jenga_tpu_torch.ops.cross_attention_resident import (
            cross_attention_resident)
        from jenga_tpu_torch.ops.flash_attention import (
            dense_attention, dense_attention_backward)
        self.counters = {
            "block_sparse_attn": (block_sparse_attention, "launches"),
            "block_sparse_attn_members": (block_sparse_attention,
                                          "member_launches"),
            "dense_attn": (dense_attention, "launches"),
            "dense_attn_short": (dense_attention, "short_launches"),
            "dense_attn_bwd_dkv": (dense_attention_backward, "dkv_launches"),
            "dense_attn_bwd_dq": (dense_attention_backward, "dq_launches"),
            "dense_attn_bwd_short": (dense_attention_backward,
                                     "short_launches"),
            "attn_probe_split": (attention_probe, "split_launches"),
            "attn_probe_epilogue": (attention_probe, "epilogue_launches"),
            "block_pool": (block_pool, "launches"),
            "cross_attn_resident": (cross_attention_resident, "launches")}
        for fn, attr in self.counters.values():
            setattr(fn, attr, 0)
        return self

    def __exit__(self, *exc):
        self.counts = {name: getattr(fn, attr)
                       for name, (fn, attr) in self.counters.items()}


@contextlib.contextmanager
def _recorded_sparse_calls(records):
    """Record (sequence length, text_amp, membership mode, list density)
    of every block-sparse call the model makes, then make it."""
    from jenga_tpu_torch.ops import sparse_dispatch
    real = sparse_dispatch.block_sparse_attention

    def recording(q, k, v, indices, counts, *a, **kw):
        records.append((q.shape[2], kw.get("text_amp", 0.0),
                        kw.get("members") is not None,
                        counts.float().mean() / indices.shape[-1]))
        return real(q, k, v, indices, counts, *a, **kw)

    with mock.patch.object(sparse_dispatch, "block_sparse_attention",
                           recording):
        yield


class _StepTimer:
    def __init__(self):
        self.step_s = []
        self.last = time.perf_counter()

    def __call__(self, i, lat):
        import torch
        torch.cuda.synchronize()
        now = time.perf_counter()
        self.step_s.append(now - self.last)
        self.last = now


def _hy_sampler():
    import torch
    from jenga_tpu_torch.models.hyvideo import HUNYUAN_VIDEO_T2V
    from jenga_tpu_torch.runtime import HunyuanVideoSampler
    ti = time.perf_counter()
    sampler = HunyuanVideoSampler(HUNYUAN_VIDEO_T2V, device="cuda", seed=0)
    gen = torch.Generator(device="cuda").manual_seed(1)
    _perturb(sampler.model, gen)
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in sampler.model.parameters())
    print(f"   model: {n_params} params, "
          f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB, init "
          f"{time.perf_counter() - ti:.3f} s")
    return sampler, gen


def _check_latents(lat, expect_shape):
    import torch
    if tuple(lat.shape) != expect_shape:
        fail(f"latents shape {tuple(lat.shape)} != {expect_shape}")
    if not torch.isfinite(lat).all() or lat.abs().max().item() == 0.0:
        fail("latents are not finite and non-zero")
    print(f"   latents {tuple(lat.shape)} mean|x| "
          f"{lat.abs().mean().item():.6f}")


def _check_video(video, expect_shape):
    """A decoded video: the shape, finite, within [-1, 1], not constant."""
    import torch
    if tuple(video.shape) != expect_shape:
        fail(f"video shape {tuple(video.shape)} != {expect_shape}")
    if not torch.isfinite(video).all():
        fail("the decoded video is not finite")
    lo, hi = video.min().item(), video.max().item()
    if not (-1.0 <= lo < hi <= 1.0):
        fail(f"decoded video range [{lo}, {hi}] is constant or outside "
             f"[-1, 1]")
    print(f"   video {tuple(video.shape)} range [{lo:.4f}, {hi:.4f}] "
          f"mean|x| {video.abs().mean().item():.6f}")


def phase_hy_main_path():
    """Phases 3 and 3b on one model: Base, then ProRes Turbo with the
    membership mode."""
    import torch
    from jenga_tpu_torch.configs.presets import get_hy_preset
    t0 = phase("3. main path: HunyuanVideo T2V Jenga-Base, full width+depth")
    sampler, gen = _hy_sampler()
    cfg = sampler.cfg
    opts = get_hy_preset("base", size=(1280, 720), video_length=33,
                         num_inference_steps=8)
    txt, mask, txt2 = _text(gen, cfg, n_pad=40)
    torch.cuda.reset_peak_memory_stats()
    timer = _StepTimer()
    with _Launches() as run:
        lat = sampler.predict(txt, mask, txt2, opts, on_step=timer)
        torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() / 2**30
    print(f"   per-step seconds: {[round(x, 4) for x in timer.step_s]}")
    print(f"   peak memory: {peak:.2f} GiB; kernel launches: {run.counts}")
    _check_latents(lat, (16, 9, 90, 160))
    expect = 7 * (cfg.double_blocks + cfg.single_blocks)
    if run.counts["block_sparse_attn"] != expect:
        fail(f"block-sparse launches {run.counts['block_sparse_attn']} != "
             f"{expect} (7 computed steps x 60 blocks)")
    if any(run.counts[p] for p in PROBES):
        fail(f"a probe kernel ran on the main path: {run.counts}")
    done(t0)
    # phase 11 decodes these latents
    base = {"launches": run.counts, "step_s": timer.step_s,
            "peak_gib": peak, "latents": lat.cpu()}
    del lat
    turbo = phase_hy_turbo(sampler, txt, mask, txt2)
    # phase 8 holds the e4m3 bytes its sampler quantizes from the same
    # seeded init against the CPU's quantization of these bf16 weights
    ref = {name: sampler.model.get_submodule(name).w.cpu()
           for name in FP8_REF_LAYERS}
    del sampler
    torch.cuda.empty_cache()
    return base, turbo, ref


# phase 8: the largest single-block weight (3072 -> 21504) and a refiner
# weight, quantized on the card by the fp8 sampler
FP8_REF_LAYERS = ("single_blocks.0.linear1", "txt_in.blocks.0.qkv")


def phase_hy_turbo(sampler, txt, mask, txt2):
    import torch
    from jenga_tpu_torch.configs.presets import get_hy_preset
    t0 = phase("3b. main path: HunyuanVideo ProRes Turbo, --q-group 8 "
               "--no-joint-sel, full width+depth")
    cfg = sampler.cfg
    n = 8
    opts = get_hy_preset("turbo", size=(1280, 720), video_length=33,
                         num_inference_steps=n, q_group=8, joint_sel=False)
    splits = [int(n * r) for r in opts.step_rate_list]
    computed = int(sampler.pipeline.compute_schedule(opts).sum())
    print(f"   stage switch after step {splits[0]}; host skip schedule: "
          f"{computed} of {n} steps computed")
    calls = []
    torch.cuda.reset_peak_memory_stats()
    timer = _StepTimer()
    with _recorded_sparse_calls(calls), _Launches() as run:
        lat = sampler.predict(txt, mask, txt2, opts, on_step=timer)
        torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() / 2**30
    stage_s = [timer.step_s[:splits[0] + 1], timer.step_s[splits[0] + 1:]]
    amps = {}
    for seq, amp, _, _ in calls:
        amps.setdefault(seq, set()).add(amp)
    density = torch.stack([c[3] for c in calls]).mean().item()
    print(f"   per-step seconds, stage 0: {[round(x, 4) for x in stage_s[0]]}"
          f"; stage 1: {[round(x, 4) for x in stage_s[1]]}")
    print(f"   text_amp by sequence length: "
          f"{ {k: sorted(v) for k, v in amps.items()} } (stage 0 expects "
          f"{HY_AMP0:.6f})")
    print(f"   peak memory: {peak:.2f} GiB; kernel launches: {run.counts}; "
          f"union list density (mean over launches): {density:.4f}")
    _check_latents(lat, (16, 9, 90, 160))
    expect = {"block_sparse_attn": 0,
              "block_sparse_attn_members":
                  computed * (cfg.double_blocks + cfg.single_blocks),
              "dense_attn": 0, "dense_attn_short": 0, **NOT_SERVING}
    if run.counts != expect:
        fail(f"kernel launches {run.counts} != {expect} ({computed} "
             f"computed steps x 60 blocks, all in the membership mode)")
    if not all(members for _, _, members, _ in calls):
        fail("a block-sparse call went without membership words")
    stage0 = sorted(amps.get(142 * 128, ()))
    if not (len(stage0) == 1 and abs(stage0[0] - HY_AMP0) <= 1e-6
            and amps.get(256 * 128) == {0.0}):
        fail(f"text_amp by stage {amps}: expected {HY_AMP0} at 142 blocks "
             f"and 0 at 256")
    del lat
    done(t0)
    return {"launches": run.counts, "stage_step_s": stage_s,
            "peak_gib": peak, "computed": computed, "density": density}


def _wan_run(sampler, opts, kinds, ctx, null):
    """One Wan generation with launch counts, per-step times and the list
    density; checks the latents and the counts against the plan."""
    import torch
    cfg = sampler.cfg
    calls = []
    torch.cuda.reset_peak_memory_stats()
    timer = _StepTimer()
    with _recorded_sparse_calls(calls), _Launches() as run:
        lat = sampler.generate(ctx, null, opts, on_step=timer)
        torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() / 2**30
    density = (torch.stack([c[3] for c in calls]).mean().item()
               if calls else None)
    print(f"   per-step seconds: {[round(x, 4) for x in timer.step_s]}")
    print(f"   peak memory: {peak:.2f} GiB; kernel launches: {run.counts}; "
          f"block-sparse list density (mean over launches): {density}")
    _check_latents(lat, (16, 21, 60, 104))
    n_dense, n_carved = kinds.count("dense"), kinds.count("carved")
    # D per computed step: the cross-attention of every layer (512 text
    # keys: the short-key kernel); a dense step adds its self-attention
    expect = {"block_sparse_attn": cfg.num_layers * n_carved,
              "block_sparse_attn_members": 0,
              "dense_attn": cfg.num_layers * (2 * n_dense + n_carved),
              "dense_attn_short": cfg.num_layers * (n_dense + n_carved),
              **NOT_SERVING}
    if run.counts != expect:
        fail(f"kernel launches {run.counts} != {expect} ({n_dense} dense, "
             f"{n_carved} carved steps x {cfg.num_layers} layers)")
    return {"launches": run.counts, "step_s": timer.step_s,
            "peak_gib": peak, "schedule": kinds, "density": density,
            "latents": lat.cpu()}


def phase_wan_main_path():
    """Phases 4 and 4b on one model: 1.3b-base, then 1.3b-turbo."""
    import torch
    from jenga_tpu_torch.configs.presets import get_wan_preset
    from jenga_tpu_torch.models.wan import WAN_T2V_1_3B
    from jenga_tpu_torch.runtime import WanSampler
    t0 = phase("4. main path: Wan2.1 T2V 1.3B Jenga-Base, full width+depth")
    cfg = WAN_T2V_1_3B
    ti = time.perf_counter()
    sampler = WanSampler(cfg, device="cuda", seed=0)
    gen = torch.Generator(device="cuda").manual_seed(3)
    _perturb_wan(sampler.model, gen)
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in sampler.model.parameters())
    print(f"   model: {n_params} params, "
          f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB, init "
          f"{time.perf_counter() - ti:.3f} s")
    for steps in range(6, 13):
        opts = get_wan_preset("1.3b-base", size=(832, 480), frame_num=81,
                              sampling_steps=steps)
        kinds = sampler.pipeline.step_plan(opts)
        if {"dense", "carved", "skip"} <= set(kinds):
            break
    else:
        fail(f"no step count in 6..12 gives dense, carved and skipped "
             f"steps at teacache_thresh {opts.teacache_thresh}")
    print(f"   chose sampling_steps={steps} (teacache_thresh "
          f"{opts.teacache_thresh}): schedule {kinds}")
    ctx = torch.randn((64, cfg.text_dim), generator=gen, device="cuda")
    null = torch.randn((64, cfg.text_dim), generator=gen, device="cuda")
    base = _wan_run(sampler, opts, kinds, ctx, null)
    done(t0)

    t0 = phase("4b. main path: Wan2.1 T2V 1.3B Turbo (joint q8), full "
               "width+depth")
    chosen = None
    for steps in range(6, 13):
        for switch in range(1, steps - 1):
            opts = get_wan_preset("1.3b-turbo", size=(832, 480),
                                  frame_num=81, sampling_steps=steps,
                                  turbo_switch_step=switch)
            kinds = sampler.pipeline.step_plan(opts)
            if ("dense" in kinds and "carved" in kinds[:switch + 1]
                    and "carved" in kinds[switch + 1:]):
                if "skip" in kinds:
                    chosen = (opts, kinds)
                    break
                chosen = chosen or (opts, kinds)
        if chosen is not None and "skip" in chosen[1]:
            break
    if chosen is None:
        fail("no step count in 6..12 and switch step give a dense step and "
             "a carved step in each stage")
    opts, kinds = chosen
    print(f"   chose sampling_steps={opts.sampling_steps}, "
          f"turbo_switch_step={opts.turbo_switch_step}: schedule {kinds}")
    turbo = _wan_run(sampler, opts, kinds, ctx, null)
    turbo["switch"] = opts.turbo_switch_step
    del sampler
    torch.cuda.empty_cache()
    done(t0)
    return base, turbo


def _free():
    """Hand a full-width model's memory back before the next is built (the
    caller has deleted its references)."""
    import gc
    import torch
    gc.collect()
    torch.cuda.empty_cache()


def _hy_i2v_run(sampler, opts, img_lats, txt, mask, txt2, expect_shape,
                decode=False):
    """One HunyuanVideo-I2V generation with launch counts; under
    token_replace frame 0 must equal the stage's conditioning latent bit
    for bit after every step. Checks the latents (with ``decode``, the
    video the sampler's VAE decodes them to) and the counts against the
    host's skip schedule."""
    import torch
    cfg = sampler.cfg
    n = opts.num_inference_steps
    splits = [int(n * r) for r in opts.step_rate_list]
    computed = int(sampler.pipeline.compute_schedule(opts).sum())
    pinned = []
    torch.cuda.reset_peak_memory_stats()
    timer = _StepTimer()

    def on_step(i, lat):
        timer(i, lat)
        stage = sum(i >= s for s in splits[:-1])
        pinned.append(torch.equal(lat[:, :1], img_lats[stage]))

    with _Launches() as run:
        out = sampler.predict_i2v(img_lats, txt, mask, txt2, opts,
                                  on_step=on_step, decode=decode)
        torch.cuda.synchronize()
    decode_s = time.perf_counter() - timer.last
    peak = torch.cuda.max_memory_allocated() / 2**30
    print(f"   host skip schedule: {computed} of {n} steps computed; "
          f"per-step seconds: {[round(x, 4) for x in timer.step_s]}")
    print(f"   peak memory: {peak:.2f} GiB; kernel launches: {run.counts}")
    if decode:
        _check_video(out, expect_shape)
        print(f"   decode seconds: {decode_s:.3f}")
    else:
        _check_latents(out, expect_shape)
    if opts.i2v_condition_type == "token_replace":
        if not all(pinned) or (not decode and not torch.equal(
                out[:, :1], img_lats[-1])):
            fail(f"token_replace: frame 0 differs from the conditioning "
                 f"latent after steps {[i for i, p in enumerate(pinned) if not p]}")
        print(f"   frame 0 equals the conditioning latent after all {n} "
              f"steps")
    blocks = cfg.double_blocks + cfg.single_blocks
    expect = {"block_sparse_attn": computed * blocks,
              "block_sparse_attn_members": 0, "dense_attn": 0,
              "dense_attn_short": 0, **NOT_SERVING}
    if run.counts != expect:
        fail(f"kernel launches {run.counts} != {expect} ({computed} computed "
             f"steps x {blocks} blocks)")
    return {"launches": run.counts, "step_s": timer.step_s,
            "peak_gib": peak, "computed": computed, "decode_s": decode_s}


def phase_hy_i2v_main_path():
    """Phases 4c (token_replace, full depth) and 4d (latent_concat, cut to
    2 + 2 blocks)."""
    import torch
    from jenga_tpu_torch.configs.presets import get_hy_i2v_options
    from jenga_tpu_torch.models.hyvideo import hy_i2v_config
    from jenga_tpu_torch.runtime import HunyuanVideoSampler
    runs = {}
    for cond, depth, steps in (("token_replace", None, 8),
                               ("latent_concat", 2, 4)):
        letter = "c" if cond == "token_replace" else "d"
        t0 = phase(f"4{letter}. main path: HunyuanVideo-I2V {cond}, full "
                   f"width, {'full depth' if depth is None else '2 + 2 blocks'}")
        cfg = hy_i2v_config(cond)
        if depth is not None:
            cfg = dataclasses.replace(cfg, double_blocks=depth,
                                      single_blocks=depth)
        ti = time.perf_counter()
        sampler = HunyuanVideoSampler(cfg, device="cuda", seed=0, i2v=True)
        gen = torch.Generator(device="cuda").manual_seed(4)
        _perturb(sampler.model, gen)
        torch.cuda.synchronize()
        print(f"   model: in_channels {cfg.in_channels}, "
              f"{cfg.double_blocks} + {cfg.single_blocks} blocks, "
              f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB, init "
              f"{time.perf_counter() - ti:.3f} s")
        # the options `hyvideo-i2v --preset base` builds
        opts = get_hy_i2v_options("base", size=(1280, 720), video_length=33,
                                  num_inference_steps=steps,
                                  i2v_condition_type=cond)
        img_lats = [torch.randn((16, 1, lat[1], lat[2]), generator=gen,
                                device="cuda")
                    for lat, _ in sampler.pipeline._stage_shapes(opts)]
        txt, mask, txt2 = _text(gen, cfg, n_pad=40)
        runs[cond] = _hy_i2v_run(sampler, opts, img_lats, txt, mask, txt2,
                                 (16, 9, 90, 160))
        del sampler, img_lats
        _free()
        done(t0)
    return runs


def phase_wan_i2v_main_path():
    """Phase 4e: Wan2.1-I2V-14B at full width and depth."""
    import torch
    from jenga_tpu_torch.configs.presets import get_wan_i2v_options
    from jenga_tpu_torch.models.wan import CLIP_DIM
    from jenga_tpu_torch.runtime import WanSampler
    t0 = phase("4e. main path: Wan2.1-I2V-14B, full width+depth, 832x480 "
               "area")
    ti = time.perf_counter()
    sampler = WanSampler.from_task("i2v-14B", device="cuda", seed=0)
    cfg = sampler.cfg
    gen = torch.Generator(device="cuda").manual_seed(5)
    _perturb_wan(sampler.model, gen)
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in sampler.model.parameters())
    print(f"   model: {n_params} params, "
          f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB, init "
          f"{time.perf_counter() - ti:.3f} s; model_id "
          f"{sampler.pipeline.model_id}")
    # the wan-i2v options at max_area 832*480 (shift 3.0, q_group 8); the
    # smallest step count from 6, with the ret-steps polynomial first,
    # whose host plan holds a dense, a carved and a skipped step (under
    # random weights the time embedding changes by ~1 relative per step,
    # where the wan-i2v-720p ret-steps polynomial is ~1e4: no skip)
    chosen = None
    for ret in (True, False):
        for steps in range(6, 13):
            opts = get_wan_i2v_options(832 * 480, frame_num=81,
                                       sampling_steps=steps,
                                       use_ret_steps=ret)
            kinds = sampler.pipeline.step_plan(opts)
            if {"dense", "carved", "skip"} <= set(kinds):
                chosen = opts, kinds
                break
        if chosen:
            break
    if chosen is None:
        fail("no step count in 6..12 gives dense, carved and skipped I2V "
             "steps")
    opts, kinds = chosen
    print(f"   chose sampling_steps={opts.sampling_steps}, use_ret_steps="
          f"{opts.use_ret_steps} (shift {opts.shift}): schedule {kinds}")
    lat_h, lat_w, frames = 60, 104, 81      # 21 x 60 x 104 latents
    img_lat = torch.randn((16, 21, lat_h, lat_w), generator=gen,
                          device="cuda")
    clip = torch.randn((257, CLIP_DIM), generator=gen, device="cuda")
    ctx = torch.randn((64, cfg.text_dim), generator=gen, device="cuda")
    null = torch.randn((64, cfg.text_dim), generator=gen, device="cuda")
    out = _wan_i2v_run(
        sampler, opts, kinds,
        lambda **kw: sampler.generate_i2v(img_lat, clip, ctx, null, frames,
                                          lat_h, lat_w, opts, **kw),
        (16, 21, lat_h, lat_w))
    del sampler
    _free()
    done(t0)
    return out, (opts, kinds)


def _wan_i2v_run(sampler, opts, kinds, generate, expect_shape,
                 decode=False):
    """One Wan2.1-I2V generation at 832x480x81f, ``generate(on_step=,
    decode=)``, with launch counts and the list density; checks the
    latents (with ``decode``, the video the sampler's VAE decodes them to)
    and the counts against the plan."""
    import torch
    cfg = sampler.cfg
    calls = []
    torch.cuda.reset_peak_memory_stats()
    timer = _StepTimer()
    with _recorded_sparse_calls(calls), _Launches() as run:
        out = generate(on_step=timer, decode=decode)
        torch.cuda.synchronize()
    decode_s = time.perf_counter() - timer.last
    peak = torch.cuda.max_memory_allocated() / 2**30
    density = (torch.stack([c[3] for c in calls]).mean().item()
               if calls else None)
    print(f"   per-step seconds: {[round(x, 4) for x in timer.step_s]}")
    print(f"   peak memory: {peak:.2f} GiB; kernel launches: {run.counts}; "
          f"block-sparse list density (mean over launches): {density}")
    if decode:
        _check_video(out, expect_shape)
        print(f"   decode seconds: {decode_s:.3f}")
    else:
        _check_latents(out, expect_shape)
    n_dense, n_carved = kinds.count("dense"), kinds.count("carved")
    layers = cfg.num_layers
    # D per computed step: the text and the image cross-attention of
    # every layer (512 and 257 keys: the short-key kernel); a dense step
    # adds its self-attention
    expect = {"block_sparse_attn": layers * n_carved,
              "block_sparse_attn_members": 0,
              "dense_attn": layers * n_dense
              + 2 * layers * (n_dense + n_carved),
              "dense_attn_short": 2 * layers * (n_dense + n_carved),
              **NOT_SERVING}
    if run.counts != expect:
        fail(f"kernel launches {run.counts} != {expect} ({n_dense} dense, "
             f"{n_carved} carved steps x {layers} layers)")
    return {"launches": run.counts, "step_s": timer.step_s,
            "peak_gib": peak, "schedule": kinds, "density": density,
            "decode_s": decode_s}


def _kernel_vs_plain(fwd):
    """fwd() with the kernels, then with both dispatch points patched to
    the plain versions; the relative error of the velocity."""
    import torch
    from jenga_tpu_torch.ops import block_sparse_attention as bsa
    from jenga_tpu_torch.ops import flash_attention as fa
    from jenga_tpu_torch.ops import sparse_dispatch
    with torch.inference_mode():
        v_kernel = fwd()
        with mock.patch.object(sparse_dispatch, "block_sparse_attention",
                               bsa.block_sparse_attention_plain), \
                mock.patch.object(fa, "dense_attention",
                                  fa.dense_attention_plain):
            v_plain = fwd()
    torch.cuda.synchronize()
    if not torch.isfinite(v_kernel).all():
        fail("non-finite kernel velocity")
    return ((v_kernel - v_plain).norm() / v_plain.norm()).item()


def phase_end_to_end():
    import torch
    from jenga_tpu_torch.models.hyvideo import (HUNYUAN_VIDEO_T2V,
                                                HYVideoDiT, hy_i2v_config,
                                                init_hyvideo_, make_hy_carve)
    from jenga_tpu_torch.models.wan import (CLIP_DIM, WAN_I2V_14B,
                                            WAN_T2V_1_3B, WanDiT, init_wan_,
                                            make_wan_carve)
    t0 = phase("5. end to end: kernels vs plain attention")
    rel = {}
    cfg = dataclasses.replace(HUNYUAN_VIDEO_T2V, double_blocks=1,
                              single_blocks=1)
    gen = torch.Generator(device="cuda").manual_seed(2)
    model = init_hyvideo_(HYVideoDiT(cfg, device="cuda"), gen)
    _perturb(model, gen)
    grid = (9, 16, 32)              # 512x256x33f: 4608 video tokens
    carve = make_hy_carve(cfg, grid, 0.75, 0.3, q_rows=8, joint_sel=True,
                          device="cuda")
    x = torch.randn((1, 16, 9, 32, 64), generator=gen, device="cuda")
    t = torch.full((1,), 900.0, device="cuda")
    txt, mask, txt2 = _text(gen, cfg, n_pad=40)
    for name, c in (("hy_carved", carve), ("hy_dense", None)):
        rel[name] = _kernel_vs_plain(
            lambda: model(x, t, txt[None], mask[None], txt2[None], c))
    # the Turbo stage-0 grid (1280x720x33f at 0.75) with its text_amp, in
    # per-row (membership) and joint selection
    x = torch.randn((1, 16, 9, 66, 120), generator=gen, device="cuda")
    for name, joint in (("hy_turbo_stage0_rowsel", False),
                        ("hy_turbo_stage0_joint", True)):
        c = make_hy_carve(cfg, HY_GRID0, 0.7, 0.3, text_amp=HY_AMP0,
                          q_rows=8, joint_sel=joint, device="cuda")
        rel[name] = _kernel_vs_plain(
            lambda: model(x, t, txt[None], mask[None], txt2[None], c))
    del model
    # HunyuanVideo-I2V token_replace, cut to 1 + 1 blocks, carved and dense
    cfg = dataclasses.replace(hy_i2v_config("token_replace"),
                              double_blocks=1, single_blocks=1)
    model = init_hyvideo_(HYVideoDiT(cfg, device="cuda"), gen)
    _perturb(model, gen)
    x = torch.randn((1, 16, 9, 32, 64), generator=gen, device="cuda")
    for name, c in (("hy_i2v_tr_carved", carve), ("hy_i2v_tr_dense", None)):
        rel[name] = _kernel_vs_plain(
            lambda: model(x, t, txt[None], mask[None], txt2[None], c))
    del model

    cfg = dataclasses.replace(WAN_T2V_1_3B, num_layers=2)
    model = init_wan_(WanDiT(cfg, device="cuda"), gen)
    _perturb_wan(model, gen)
    carve = make_wan_carve(cfg, WAN_GRID, 0.75, 0.9, q_rows=8,
                           joint_sel=True, device="cuda")
    x = torch.randn((1, 16, 21, 60, 104), generator=gen, device="cuda")
    ctx = torch.randn((1, cfg.text_len, cfg.text_dim), generator=gen,
                      device="cuda")
    for name, c in (("wan_carved", carve),
                    ("wan_dense", dataclasses.replace(carve,
                                                      sa_drop_rate=0.0))):
        rel[name] = _kernel_vs_plain(lambda: model(x, t, ctx, carve=c))
    # the Turbo stage-0 grid in per-row (membership) selection
    x = torch.randn((1, 16, 21, 44, 78), generator=gen, device="cuda")
    c = make_wan_carve(cfg, WAN_GRID0, 0.75, 0.9, q_rows=8, joint_sel=False,
                       device="cuda")
    rel["wan_stage0_rowsel"] = _kernel_vs_plain(
        lambda: model(x, t, ctx, carve=c))
    del model
    # Wan2.1-I2V-14B cut to 2 layers at 832x480x81f: y, 257 CLIP tokens and
    # the image cross-attention; carved and the dense fallback
    cfg = dataclasses.replace(WAN_I2V_14B, num_layers=2)
    model = init_wan_(WanDiT(cfg, device="cuda"), gen)
    _perturb_wan(model, gen)
    carve = make_wan_carve(cfg, WAN_GRID, 0.75, 0.9, q_rows=8,
                           joint_sel=True, device="cuda")
    x = torch.randn((1, 16, 21, 60, 104), generator=gen, device="cuda")
    y = torch.randn((1, 20, 21, 60, 104), generator=gen, device="cuda")
    clip = torch.randn((1, 257, CLIP_DIM), generator=gen, device="cuda")
    for name, c in (("wan_i2v_carved", carve),
                    ("wan_i2v_dense", dataclasses.replace(carve,
                                                          sa_drop_rate=0.0))):
        rel[name] = _kernel_vs_plain(
            lambda: model(x, t, ctx, carve=c, clip_fea=clip, y=y))
    del model
    torch.cuda.empty_cache()
    for name, r in rel.items():
        print(f"   {name}: velocity relative error {r:.6f} "
              f"(bound {E2E_REL_TOL})")
        if not r <= E2E_REL_TOL:
            fail(f"{name}: end-to-end relative error {r} > {E2E_REL_TOL}")
    done(t0)
    return rel


def phase_probes():
    """Phase 6: the four probe tools at their own shapes, counted; then
    P1's and P2's numerics at the HY main shape, not counted."""
    from jenga_tpu_torch.tools import epilogue_probe as p2
    from jenga_tpu_torch.tools import kernel_split_probe as p1
    from jenga_tpu_torch.tools import pool_probe as p3
    from jenga_tpu_torch.tools import wan_overhead_probe2 as p4
    t0 = phase("6. probes: P1-P4 through their tools, at the tools' shapes")
    with _Launches() as run:
        r1 = p1.run(device="cuda", library=True, check=True)
        p1.print_table(r1)
        r2 = p2.run(device="cuda", library=True, check=True)
        p2.print_table(r2)
        r3 = p3.run(device="cuda")
        p3.print_table(r3)
        r4 = p4.run(device="cuda")
        p4.print_table(r4)
    print(f"   kernel launches: {run.counts}")
    idle = [p for p in PROBES if run.counts[p] == 0]
    if idle:
        fail(f"probe kernels {idle} were not launched by their tools")
    for c, err in r3["max_abs_err"].items():
        if not err <= POOL_TOL:
            fail(f"P3 chunk {c}: max abs error {err} > {POOL_TOL}")
    checks = [(f"P1 {m} {v}", r) for m, rec in r1["modes"].items()
              for v, r in rec["variants"].items()]
    checks += [(f"P2 {v}", r) for v, r in r2["variants"].items()]
    checks += [(f"P4 {v}", r) for v, r in r4["attn"].items()]
    for name, r in checks:
        _check(name, r, PROBE_REL_TOL)
    done(t0)
    return {"counts": run.counts, "p1": r1, "p2": r2, "p3": r3, "p4": r4}


STOCK_FLASH = "jax/experimental/pallas/ops/tpu/flash_attention.py"


def _bwd_entries(bwd, runs):
    """The kernels-line entries of D's backward: the dK|dV and dQ kernels
    of the route over 512 keys (errors over its phase-2 cases; ms, bounds,
    the plain backward's ms, which computes dq, dk and dv together, and the
    SDPA backward's at Wan's self-attention, each case's beside them) and
    the short-key call (errors over its cases; its ms those of the pair at
    Wan-14B's image cross-attention, with the dQ and dK|dV kernels' own)."""
    long_cases = [r for r in bwd if r["route"] == "mainloop"]
    short = [r for r in bwd if r["route"] == "short"]
    wan_self = long_cases[0]
    out = []
    for name, key, line, kernel_line, call_line in (
            ("dense_attn_bwd_dkv", "dkv", 941, 796, 1121),
            ("dense_attn_bwd_dq", "dq", 1287, 1146, 1456)):
        by_path = {path: c[name] for path, c in runs.items()}
        out.append({
            "name": name,
            "route": "cuda",
            "source": "jenga_tpu_torch/csrc/dense_attn_bwd.cu",
            "replaces": f"{STOCK_FLASH}:{line}",
            "replaces_kernel": f"{STOCK_FLASH}:{kernel_line}, pallas_call "
                               f":{call_line}, reached from "
                               f"jenga_tpu/ops/flash_attention.py:92",
            "of": "D's backward for Skv > 512",
            "launches": sum(by_path.values()),
            "launches_by_path": by_path,
            "max_abs_err": max(r["errors"][g]["max_abs_err"]
                               for r in long_cases
                               for g in (("dk", "dv") if key == "dkv"
                                         else ("dq",))),
            "rel_err": max(r["errors"][g]["rel_err"] for r in long_cases
                           for g in (("dk", "dv") if key == "dkv"
                                     else ("dq",))),
            "ms": wan_self[f"{key}_ms"],
            "ms_of": f"Wan self-attention {wan_self['q']}",
            "plain_ms": wan_self["plain_ms"],
            "bound_ms": wan_self[f"{key}_bound_ms"],
            "bound_by": wan_self[f"{key}_bound_by"],
            "library_ms": wan_self["library_ms"],
            "library_of": "SDPA (flash) backward, dq dk dv together",
            "pair_ms": wan_self["ms"],
            "pair_bound_ms": wan_self["pair_bound_ms"],
            "cases": {r["case"]: {k: r[k] for k in (
                f"{key}_ms", f"{key}_bound_ms", f"{key}_bound_by", "ms",
                "pair_bound_ms", "plain_ms", "library_ms")}
                for r in long_cases},
        })
    image = next(r for r in short if r["case"] == "c_wan14b_image_cross")
    by_path = {path: c["dense_attn_bwd_short"] for path, c in runs.items()}
    out.append({
        "name": "dense_attn_bwd_short",
        "route": "cuda",
        "source": "jenga_tpu_torch/csrc/dense_attn_bwd_short.cu",
        "replaces": f"{STOCK_FLASH}:1287",
        "also_replaces": f"{STOCK_FLASH}:941",
        "replaces_kernel": f"{STOCK_FLASH}:1146 and :796, pallas_call "
                           f":1456 and :1121, reached from "
                           f"jenga_tpu/ops/flash_attention.py:92",
        "of": "D's backward for Skv <= 512 (dQ with di, dK|dV, their sum)",
        "launches": sum(by_path.values()),
        "launches_by_path": by_path,
        "max_abs_err": max(r["max_abs_err"] for r in short),
        "rel_err": max(r["rel_err"] for r in short),
        "ms": image["ms"],
        "ms_of": f"Wan-14B image cross-attention {image['q']} x "
                 f"{image['kv'][2]} keys, the call (dq, dk, dv)",
        "plain_ms": image["plain_ms"],
        "bound_ms": image["bound_ms"],
        "bound_by": image["bound_by"],
        "library_ms": image["library_ms"],
        "library_of": "SDPA (flash) backward, dq dk dv together",
        "dq_ms": image["dq_ms"],
        "dkv_ms": image["dkv_ms"],
        "design": BWD_SHORT_DESIGN,
        "cases": {r["case"]: {k: r.get(k) for k in (
            "ms", "dq_ms", "dkv_ms", "bound_ms", "bound_by", "dq_bound_ms",
            "dkv_bound_ms", "plain_ms", "library_ms")} for r in short},
    })
    return out


def _probe_entries(probes, runs):
    """The kernels-line entries of P1-P4, all at the tools' own shapes: ms
    of each variant; max_abs_err and rel_err over every variant checked;
    plain_ms of the headline variant over every row (P1 `both` in K1
    mode, P2 `fixedmax`)."""
    counts = probes["counts"]

    def launches(name):
        return {**{path: c[name] for path, c in runs.items()},
                "probes": counts[name]}

    def worst(recs, key):
        return max(r[key] for r in recs)

    r1 = probes["p1"]
    k1 = r1["modes"]["k1_q8"]
    p1_recs = [r for rec in r1["modes"].values()
               for r in rec["variants"].values()]
    p1_bound = bound(k1["pairs"] * TILE_FLOP, 4 * math.prod(r1["shape"]) * 2)
    r2 = probes["p2"]
    p2_recs = list(r2["variants"].values())
    p2_bound = bound(r2["pairs"] * TILE_FLOP, 4 * math.prod(r2["shape"]) * 2)
    r3, r4 = probes["p3"], probes["p4"]
    p4_recs = [r for name, r in r4["attn"].items()
               if name.startswith("resident")]
    # one f32 add per bf16 element read; f32 means written, 1/64 the bytes
    p3_bound = bound(r3["bytes"] // 2, r3["bytes"] * (1 + 1 / 64), PEAK_F32)
    p4_bound = bound(r4["flop"], r4["bytes"])
    return [{
        "name": "attn_probe_split",
        "probe": "P1",
        "route": "cuda",
        "source": "jenga_tpu_torch/csrc/attn_probe.cu",
        "replaces": "tools/kernel_split_probe.py:140",
        "launches": counts["attn_probe_split"],
        "launches_by_path": launches("attn_probe_split"),
        "max_abs_err": worst(p1_recs, "max_abs_err"),
        "rel_err": worst(p1_recs, "rel_err"),
        "ms": k1["variants"]["both"]["ms"],
        "ms_of": f"both, k1_q8, {r1['shape']}",
        "variant_ms": {m: {v: r["ms"] for v, r in rec["variants"].items()}
                       for m, rec in r1["modes"].items()},
        "plain_ms": k1["variants"]["both"]["plain_ms"],
        "bound_ms": p1_bound[0], "bound_by": p1_bound[1],
        "library_ms": k1.get("library_ms"),
    }, {
        "name": "attn_probe_epilogue",
        "probe": "P2",
        "route": "cuda",
        "source": "jenga_tpu_torch/csrc/attn_probe.cu",
        "replaces": "tools/epilogue_probe.py:250",
        "launches": counts["attn_probe_epilogue"],
        "launches_by_path": launches("attn_probe_epilogue"),
        "max_abs_err": worst(p2_recs, "max_abs_err"),
        "rel_err": worst(p2_recs, "rel_err"),
        "ms": r2["variants"]["fixedmax"]["ms"],
        "ms_of": f"fixedmax, q_rows 4, {r2['shape']}",
        "variant_ms": {v: r["ms"] for v, r in r2["variants"].items()},
        "plain_ms": r2["variants"]["fixedmax"]["plain_ms"],
        "bound_ms": p2_bound[0], "bound_by": p2_bound[1],
        "library_ms": r2.get("library_ms"),
    }, {
        "name": "block_pool",
        "probe": "P3",
        "route": "cuda",
        "source": "jenga_tpu_torch/csrc/block_pool.cu",
        "replaces": "tools/pool_probe.py:111",
        "launches": counts["block_pool"],
        "launches_by_path": launches("block_pool"),
        "max_abs_err": max(r3["max_abs_err"].values()),
        "ms": r3["pool_ms"]["kernel c16"],
        "ms_of": f"q and k (two launches), chunk 16, {r3['shape']}",
        "variant_ms": {name: ms for name, ms in r3["pool_ms"].items()
                       if name.startswith("kernel")},
        "plain_ms": r3["pool_ms"]["plain"],
        "bound_ms": p3_bound[0], "bound_by": p3_bound[1],
        "library_ms": r3["pool_ms"]["torch mean"],
    }, {
        "name": "cross_attn_resident",
        "probe": "P4",
        "route": "cuda",
        "source": "jenga_tpu_torch/csrc/cross_attn_resident.cu",
        "replaces": "tools/wan_overhead_probe2.py:122",
        "launches": counts["cross_attn_resident"],
        "launches_by_path": launches("cross_attn_resident"),
        "max_abs_err": worst(p4_recs, "max_abs_err"),
        "rel_err": worst(p4_recs, "rel_err"),
        "ms": r4["attn"]["resident bq2048"]["ms"],
        "ms_of": f"bq 2048, q {r4['shape'][0]} x kv {r4['shape'][1]}",
        "variant_ms": {name: r["ms"] for name, r in r4["attn"].items()},
        "plain_ms": r4["plain_ms"],
        "bound_ms": p4_bound[0], "bound_by": p4_bound[1],
        "library_ms": r4["attn"]["sdpa"]["ms"],
        "design": P4_DESIGN,
        "d_same_operands_ms": r4["attn"]["D"]["ms"],
    }]


# phase 7: the CLI's entry point in a fresh process, then the launch counts
_CLI_CHILD = """
import json, sys
from jenga_tpu_torch import cli
from jenga_tpu_torch.ops.block_sparse_attention import block_sparse_attention
from jenga_tpu_torch.ops.flash_attention import dense_attention
cli.main(sys.argv[1:])
print(json.dumps({"block_sparse_attn": block_sparse_attention.launches,
                  "dense_attn": dense_attention.launches,
                  "dense_attn_short": dense_attention.short_launches}))
"""
CLI_TINY = (("hyvideo-t2v", ("block_sparse_attn",)),
            ("wan-t2v", ("block_sparse_attn", "dense_attn",
                         "dense_attn_short")),
            ("hyvideo-i2v", ("block_sparse_attn",)),
            ("wan-i2v", ("block_sparse_attn", "dense_attn",
                         "dense_attn_short")))


def phase_cli_tiny():
    """Phase 7: ``<cmd> --tiny --latents-only`` with the default device."""
    import numpy as np
    t0 = phase("7. CLI --tiny on the card, default device")
    with tempfile.TemporaryDirectory() as tmp:
        for cmd, kernels in CLI_TINY:
            path = os.path.join(tmp, f"{cmd}.npy")
            tc = time.perf_counter()
            proc = subprocess.run(
                [sys.executable, "-c", _CLI_CHILD, cmd, "--tiny",
                 "--latents-only", "--save-path", path],
                cwd=ROOT, capture_output=True, text=True, timeout=300)
            secs = time.perf_counter() - tc
            if proc.returncode:
                fail(f"{cmd} --tiny exited {proc.returncode}:\n"
                     f"{proc.stdout[-2000:]}\n{proc.stderr[-2000:]}")
            counts = json.loads(proc.stdout.strip().splitlines()[-1])
            lat = np.load(path)
            print(f"   {cmd} --tiny: {secs:.3f} s, latents {lat.shape}, "
                  f"kernel launches {counts}", flush=True)
            if not (np.isfinite(lat).all() and np.abs(lat).max() > 0):
                fail(f"{cmd} --tiny: latents are not finite and non-zero")
            idle = [k for k in kernels if not counts[k]]
            if idle:
                fail(f"{cmd} --tiny launched no {idle}")
    done(t0)


def phase_hy_fp8(ref_weights, bf16_peak):
    """Phase 8: HunyuanVideo T2V Base with ``use_fp8=True``, full width and
    depth."""
    import torch
    from jenga_tpu_torch.configs.presets import get_hy_preset
    from jenga_tpu_torch.models.fp8 import (dequantize_tree_fp8,
                                            quantize_linear_fp8)
    from jenga_tpu_torch.models.hyvideo import (HUNYUAN_VIDEO_T2V,
                                                make_hy_carve)
    from jenga_tpu_torch.models.layers import Affine
    from jenga_tpu_torch.runtime import HunyuanVideoSampler
    t0 = phase("8. HunyuanVideo T2V Jenga-Base with fp8 weights "
               "(use_fp8=True), full width+depth")
    torch.cuda.reset_peak_memory_stats()
    ti = time.perf_counter()
    sampler = HunyuanVideoSampler(HUNYUAN_VIDEO_T2V, device="cuda", seed=0,
                                  use_fp8=True)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - ti
    model, cfg = sampler.model, sampler.cfg
    fp8 = {n: m for n, m in model.named_modules()
           if isinstance(m, Affine) and m.w8 is not None}
    n_q = sum(m.w8.numel() for m in fp8.values())
    n_all = sum(p.numel() for p in model.parameters())
    w_gib = sum(p.numel() * p.element_size()
                for p in model.parameters()) / 2**30
    print(f"   model: {len(fp8)} fp8 layers holding {n_q} of {n_all} "
          f"params; weights {w_gib:.2f} GiB; init + quantization "
          f"{init_s:.3f} s, peak "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    # the zero-initialised layers (quantized zeros) get the quantization,
    # on the card, of seeded noise, as _perturb gives the bf16 model; then
    # the bytes quantized on the card against the CPU's quantization of
    # the same weights: two from phase 3's identical seeded init, and the
    # head's noise
    gen = torch.Generator(device="cuda").manual_seed(1)
    layers = [model.final_layer.linear, model.final_layer.adaLN] + [
        blk.adaLN for blk in model.txt_in.blocks]
    with torch.no_grad():
        for lin in layers:
            w = (torch.randn(lin.w8.shape, generator=gen, device="cuda")
                 * 0.02).to(lin.dtype)
            w8, sc = quantize_linear_fp8(w)
            lin.w8.copy_(w8)
            lin.scale.copy_(sc)
            if lin is model.final_layer.linear:
                ref_weights = {**ref_weights, "final_layer.linear": w.cpu()}
    for name, w in ref_weights.items():
        w8, sc = quantize_linear_fp8(w)
        mod = model.get_submodule(name)
        same = torch.equal(mod.w8.cpu().view(torch.uint8),
                           w8.view(torch.uint8))
        print(f"   {name} {tuple(w.shape)}: e4m3 bytes on the card == CPU "
              f"quantization: {same}; scale {mod.scale.item():.6e} vs "
              f"{sc.item():.6e}")
        if not same or mod.scale.item() != sc.item():
            fail(f"{name}: the card's fp8 quantization differs from the "
                 f"CPU's")

    n = 4
    opts = get_hy_preset("base", size=(1280, 720), video_length=33,
                         num_inference_steps=n)
    computed = int(sampler.pipeline.compute_schedule(opts).sum())
    txt, mask, txt2 = _text(gen, cfg, n_pad=40)
    torch.cuda.reset_peak_memory_stats()
    timer = _StepTimer()
    with _Launches() as run:
        lat = sampler.predict(txt, mask, txt2, opts, on_step=timer)
        torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() / 2**30
    print(f"   per-step seconds: {[round(x, 4) for x in timer.step_s]} "
          f"({computed} of {n} computed)")
    print(f"   peak memory: {peak:.2f} GiB (phase 3 in bf16: "
          f"{bf16_peak:.2f} GiB); kernel launches: {run.counts}")
    _check_latents(lat, (16, 9, 90, 160))
    layers_n = cfg.double_blocks + cfg.single_blocks
    expect = {"block_sparse_attn": computed * layers_n,
              "block_sparse_attn_members": 0, "dense_attn": 0,
              "dense_attn_short": 0, **NOT_SERVING}
    if run.counts != expect:
        fail(f"kernel launches {run.counts} != {expect} ({computed} "
             f"computed steps x {layers_n} blocks)")
    del lat

    # one carved velocity with the fp8 weights (twice: run-to-run), then
    # with the weights dequantized in place to bf16: the same GEMM operands
    lat_shape, grid = sampler.pipeline._stage_shapes(opts)[0]
    carve = make_hy_carve(cfg, grid, opts.sa_drop_rates[0], opts.p_remain,
                          q_rows=opts.q_group, joint_sel=opts.joint_sel,
                          device="cuda")
    x = torch.randn((1, cfg.in_channels, *lat_shape), generator=gen,
                    device="cuda")
    t = torch.full((1,), 900.0, device="cuda")
    def fwd():
        with torch.inference_mode():
            v = model(x, t, txt[None], mask[None], txt2[None], carve)
        torch.cuda.synchronize()
        return v

    v8, v8b = fwd(), fwd()
    td = time.perf_counter()
    dequantize_tree_fp8(model)
    torch.cuda.synchronize()
    deq_s = time.perf_counter() - td
    vb = fwd()
    rerun = ((v8 - v8b).norm() / v8.norm()).item()
    rel = ((v8 - vb).norm() / vb.norm()).item()
    exact = torch.equal(v8, vb)
    print(f"   velocity, fp8 vs the same weights dequantized in place to "
          f"bf16 ({deq_s:.3f} s): bit-equal {exact}, relative error "
          f"{rel:.3e} (fp8 run to run {rerun:.3e}; bound {E2E_REL_TOL} "
          f"where not bit-equal)")
    if not torch.isfinite(v8).all() or not (exact or rel <= E2E_REL_TOL):
        fail(f"fp8 velocity {rel} away from its bf16 dequant")
    del sampler, model, v8, v8b, vb
    _free()
    done(t0)
    return {"launches": run.counts, "step_s": timer.step_s,
            "peak_gib": peak, "weight_gib": w_gib, "fp8_layers": len(fp8),
            "fp8_params": n_q, "velocity_bit_equal": exact,
            "velocity_rel_err": rel}


def phase_wan_dpm():
    """Phase 9: Wan2.1 T2V 1.3B under DPM-Solver++, Base then Turbo."""
    import torch
    from jenga_tpu_torch.configs.presets import get_wan_preset
    from jenga_tpu_torch.models.wan import WAN_T2V_1_3B
    from jenga_tpu_torch.runtime import WanSampler
    t0 = phase("9. Wan2.1 T2V 1.3B Jenga-Base under dpm++, full width+depth")
    cfg = WAN_T2V_1_3B
    sampler = WanSampler(cfg, device="cuda", seed=0)
    gen = torch.Generator(device="cuda").manual_seed(3)
    _perturb_wan(sampler.model, gen)
    for steps in range(6, 13):
        opts = get_wan_preset("1.3b-base", size=(832, 480), frame_num=81,
                              sampling_steps=steps, solver="dpm++")
        kinds = sampler.pipeline.step_plan(opts)
        if {"dense", "carved", "skip"} <= set(kinds):
            break
    else:
        fail("no step count in 6..12 gives dense, carved and skipped dpm++ "
             "steps")
    print(f"   chose sampling_steps={steps}: schedule {kinds}")
    ctx = torch.randn((64, cfg.text_dim), generator=gen, device="cuda")
    null = torch.randn((64, cfg.text_dim), generator=gen, device="cuda")
    base = _wan_run(sampler, opts, kinds, ctx, null)
    done(t0)

    t0 = phase("9b. Wan2.1 T2V 1.3B Turbo under dpm++, full width+depth")
    chosen = None
    for steps in range(6, 13):
        for switch in range(1, steps - 1):
            opts = get_wan_preset("1.3b-turbo", size=(832, 480),
                                  frame_num=81, sampling_steps=steps,
                                  turbo_switch_step=switch, solver="dpm++")
            kinds = sampler.pipeline.step_plan(opts)
            if ("dense" in kinds and "carved" in kinds[:switch + 1]
                    and kinds[switch + 1] == "carved"):
                chosen = opts, kinds
                break
        if chosen:
            break
    if chosen is None:
        fail("no step count in 6..12 and switch step give a dense step, a "
             "carved stage-0 step and a carved fresh-state step")
    opts, kinds = chosen
    print(f"   chose sampling_steps={opts.sampling_steps}, "
          f"turbo_switch_step={opts.turbo_switch_step} (the fresh dpm++ "
          f"state at step {opts.turbo_switch_step + 1}): schedule {kinds}")
    turbo = _wan_run(sampler, opts, kinds, ctx, null)
    turbo["switch"] = opts.turbo_switch_step
    del sampler
    _free()
    done(t0)
    return base, turbo


def phase_fidelity():
    """Phase 10: one row of tools/fidelity.py, Wan-1.3B joint q8 carved vs
    dense at 832x480x33f over 20 steps."""
    import torch
    from jenga_tpu_torch.tools import fidelity
    t0 = phase("10. fidelity: Wan-1.3B arch 832x480x33f, 20 steps, joint q8 "
               "carved vs dense (tools/fidelity.py)")
    suite = fidelity.build_suite("wan", "cuda")
    plans = {arm: suite.sampler.pipeline.step_plan(suite.arms[arm])
             for arm in ("q8", "dense")}
    layers = suite.sampler.cfg.num_layers
    torch.cuda.reset_peak_memory_stats()
    with _Launches() as run:
        row, = fidelity.run_suite(suite, ["q8_vs_dense"], gpu_line())
    peak = torch.cuda.max_memory_allocated() / 2**30
    print(f"   {json.dumps(row)}")
    print(f"   relative_error {row['relative_error']:.6f}, final_mse "
          f"{row['final_mse']:.6e} (the TPU row, JAX init, for reference "
          f"only: 0.020879, FIDELITY.json); peak {peak:.2f} GiB; kernel "
          f"launches: {run.counts}")
    n_dense = sum(p.count("dense") for p in plans.values())
    n_carved = sum(p.count("carved") for p in plans.values())
    expect = {"block_sparse_attn": layers * n_carved,
              "block_sparse_attn_members": 0,
              "dense_attn": layers * (2 * n_dense + n_carved),
              "dense_attn_short": layers * (n_dense + n_carved),
              **NOT_SERVING}
    if run.counts != expect:
        fail(f"kernel launches {run.counts} != {expect} ({n_dense} dense, "
             f"{n_carved} carved steps x {layers} layers)")
    if not 0.0 < row["relative_error"] <= 0.10:
        fail(f"carved vs dense relative error {row['relative_error']} "
             f"outside (0, 0.10]")
    del suite
    _free()
    done(t0)
    return {"launches": run.counts, "row": row, "peak_gib": peak}


# phases 11-12: the tests' small VAE configs (tests/test_torch_vae.py),
# decoded on the card and on the CPU; cuDNN runs the f32 convs in TF32
# (PyTorch's default), ~1e-3 relative a conv, so the bound is 2e-2
HY_VAE_SMALL = dict(block_out_channels=(8, 16, 16, 16), norm_num_groups=4,
                    layers_per_block=1, sample_tsize=16, sample_size=32)
VAE_TF32_TOL = 2e-2


def _perturb_vae(vae, gen, scale=0.02):
    """Seeded noise on the Wan VAE's zero-initialised attention
    projections, or the mid-block attention would add nothing."""
    import torch
    from jenga_tpu_torch.codec.vae_wan import Attention
    with torch.no_grad():
        for mod in vae.modules():
            if isinstance(mod, Attention):
                w = mod.proj.w
                w.copy_(torch.randn(w.shape, generator=gen,
                                    device=w.device) * scale)


def _vae_card_vs_cpu(name, vae, decode, z):
    """``decode(vae, z)`` on the CPU, then with the module and the latent
    moved to the card: relative L2 within VAE_TF32_TOL."""
    import torch
    want = decode(vae, z)
    got = decode(vae.to("cuda"), z.to("cuda")).cpu()
    rel = ((got.double() - want.double()).norm()
           / want.double().norm()).item()
    print(f"   {name}: output {tuple(got.shape)}, card vs CPU relative L2 "
          f"{rel:.3e} (bound {VAE_TF32_TOL}, TF32 convs)")
    if not rel <= VAE_TF32_TOL:
        fail(f"{name}: card vs CPU relative L2 {rel} > {VAE_TF32_TOL}")
    return rel


def _decode_on(sampler, latents, expect_shape):
    """``sampler.decode_latents`` of host latents: (seconds, peak GiB, peak
    GiB above what was resident before)."""
    import torch
    torch.cuda.synchronize()
    resident = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    td = time.perf_counter()
    video = sampler.decode_latents(latents.to("cuda"))
    torch.cuda.synchronize()
    sec = time.perf_counter() - td
    peak = torch.cuda.max_memory_allocated()
    _check_video(video, expect_shape)
    del video
    return sec, peak / 2**30, (peak - resident) / 2**30


def phase_hy_vae(base_latents):
    """Phases 11 and 11b on one HunyuanVideo-I2V token_replace sampler at
    full width and depth with the published VAE attached."""
    import torch
    from jenga_tpu_torch.codec import vae_hy
    from jenga_tpu_torch.configs.presets import get_hy_i2v_options
    from jenga_tpu_torch.models.hyvideo import hy_i2v_config
    from jenga_tpu_torch.runtime import HunyuanVideoSampler
    t0 = phase("11. HunyuanVideo VAE decode: HYVAE_884_16C (f32, TF32 "
               "convs), phase 3's latents 16x9x90x160 -> 1280x720x33f")
    torch.backends.cudnn.allow_tf32 = True  # PyTorch's default
    gen = torch.Generator(device="cuda").manual_seed(11)
    ti = time.perf_counter()
    vae = vae_hy.init_hyvae_(vae_hy.HYVAE(vae_hy.HYVAE_884_16C,
                                          device="cuda"), gen)
    n_vae = sum(p.numel() for p in vae.parameters())
    sampler = HunyuanVideoSampler(hy_i2v_config("token_replace"),
                                  device="cuda", seed=0, i2v=True, vae=vae)
    _perturb(sampler.model, gen)
    torch.cuda.synchronize()
    print(f"   VAE {n_vae} params; HunyuanVideo-I2V token_replace "
          f"sampler {torch.cuda.memory_allocated() / 2**30:.2f} GiB, init "
          f"{time.perf_counter() - ti:.3f} s (decode through its "
          f"decode_latents: 28 spatial tiles of 9x32x32 latents)")
    dec_s, peak, extra = _decode_on(sampler, base_latents, (3, 33, 720, 1280))
    print(f"   decode seconds: {dec_s:.3f}; peak memory: {peak:.2f} GiB "
          f"({extra:.2f} GiB above the resident sampler)")
    small = vae_hy.HYVAEConfig(**HY_VAE_SMALL)
    cpu_gen = torch.Generator().manual_seed(12)
    rel = _vae_card_vs_cpu(
        "small HY config, latent 5x5x5 (2 temporal x 2x2 spatial tiles)",
        vae_hy.init_hyvae_(vae_hy.HYVAE(small), cpu_gen),
        vae_hy.vae_decode_tiled,
        torch.randn((1, 16, 5, 5, 5), generator=cpu_gen))
    print(f"   gpu: {gpu_line()}")
    done(t0)
    decode = {"seconds": time.perf_counter() - t0, "decode_s": dec_s,
              "peak_gib": peak, "peak_above_resident_gib": extra,
              "small_card_vs_cpu_rel_l2": rel}

    t0 = phase("11b. HunyuanVideo-I2V token_replace end to end: a seeded "
               "720x1280 image encoded, 8 steps at full width and depth, "
               "decoded")
    opts = get_hy_i2v_options("base", size=(1280, 720), video_length=33,
                              num_inference_steps=8,
                              i2v_condition_type="token_replace")
    img = torch.rand((3, 720, 1280), generator=gen, device="cuda")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    te = time.perf_counter()
    img_lats = [sampler.encode_image_latent(img, lat[1], lat[2])
                for lat, _ in sampler.pipeline._stage_shapes(opts)]
    torch.cuda.synchronize()
    enc_s = time.perf_counter() - te
    enc_peak = torch.cuda.max_memory_allocated() / 2**30
    for a in img_lats:
        if tuple(a.shape) != (16, 1, 90, 160) or not torch.isfinite(a).all():
            fail(f"encoded image latent {tuple(a.shape)} is not a finite "
                 f"(16, 1, 90, 160)")
    print(f"   encode seconds: {enc_s:.3f} ({len(img_lats)} stages, one "
          f"tiled encode each); peak memory {enc_peak:.2f} GiB; latent "
          f"mean|x| {img_lats[0].abs().mean().item():.6f}")
    txt, mask, txt2 = _text(gen, sampler.cfg, n_pad=40)
    run = _hy_i2v_run(sampler, opts, img_lats, txt, mask, txt2,
                      (3, 33, 720, 1280), decode=True)
    print(f"   gpu: {gpu_line()}")
    done(t0)
    run.update(seconds=time.perf_counter() - t0, encode_s=enc_s,
               encode_peak_gib=enc_peak)
    prompt = phase_hy_prompt(sampler, img, img_lats, gen)
    del sampler, vae, img_lats
    _free()
    return decode, run, prompt


def phase_wan_vae(base_latents, i2v_plan):
    """Phases 12 and 12b on one Wan2.1-I2V-14B sampler at full width and
    depth with the published VAE attached (the VAE of every Wan model)."""
    import torch
    from jenga_tpu_torch.codec import vae_wan
    from jenga_tpu_torch.runtime import WanSampler
    from jenga_tpu_torch.models.wan import CLIP_DIM
    t0 = phase("12. Wan VAE decode, streamed: WAN_VAE_16Z (f32, TF32 convs),"
               " phase 4's latents 16x21x60x104 -> 832x480x81f")
    torch.backends.cudnn.allow_tf32 = True  # PyTorch's default
    gen = torch.Generator(device="cuda").manual_seed(13)
    ti = time.perf_counter()
    vae = vae_wan.init_wanvae_(vae_wan.WanVAE(vae_wan.WAN_VAE_16Z,
                                              device="cuda"), gen)
    _perturb_vae(vae, gen)
    n_vae = sum(p.numel() for p in vae.parameters())
    sampler = WanSampler.from_task("i2v-14B", device="cuda", seed=0, vae=vae)
    _perturb_wan(sampler.model, gen)
    torch.cuda.synchronize()
    print(f"   VAE {n_vae} params; Wan2.1-I2V-14B sampler "
          f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB, init "
          f"{time.perf_counter() - ti:.3f} s (decode through its "
          f"decode_latents, one latent frame at a time)")
    dec_s, peak, extra = _decode_on(sampler, base_latents, (3, 81, 480, 832))
    # the one-shot decode's 192-channel f32 tensor after the third stage's
    # spatial upsample, 81 x 480 x 832
    one_shot_gb = 192 * 81 * 480 * 832 * 4 / 1e9
    print(f"   decode seconds: {dec_s:.3f}; peak memory: {peak:.2f} GiB, "
          f"{extra:.2f} GiB above the resident sampler; the one-shot "
          f"decode's largest single tensor: {one_shot_gb:.1f} GB")
    if not extra * 2**30 < one_shot_gb * 1e9 / 3:
        fail(f"the streamed decode took {extra:.2f} GiB above the resident "
             f"sampler: not far below the one-shot's {one_shot_gb:.1f} GB")
    small = vae_wan.WanVAEConfig(dim=8)
    cpu_gen = torch.Generator().manual_seed(14)
    small_vae = vae_wan.init_wanvae_(vae_wan.WanVAE(small), cpu_gen)
    _perturb_vae(small_vae, cpu_gen, scale=0.2)
    rel = _vae_card_vs_cpu(
        "small Wan config (dim 8), 4-frame latent 16x4x6x8", small_vae,
        vae_wan.wanvae_decode,
        torch.randn((1, 16, 4, 6, 8), generator=cpu_gen))
    print(f"   gpu: {gpu_line()}")
    done(t0)
    decode = {"seconds": time.perf_counter() - t0, "decode_s": dec_s,
              "peak_gib": peak, "peak_above_resident_gib": extra,
              "one_shot_tensor_gb": one_shot_gb,
              "small_card_vs_cpu_rel_l2": rel}

    t0 = phase("12b. Wan2.1-I2V-14B end to end: a seeded 480x832 image "
               "encoded with the trunk resident, phase 4e's run, decoded")
    opts, kinds = i2v_plan
    img = torch.rand((3, 480, 832), generator=gen, device="cuda")
    torch.cuda.synchronize()
    resident = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    te = time.perf_counter()
    img_lat = sampler.encode_image_latent(img, 81, 60, 104)
    torch.cuda.synchronize()
    enc_s = time.perf_counter() - te
    enc_peak = torch.cuda.max_memory_allocated()
    if (tuple(img_lat.shape) != (16, 21, 60, 104)
            or not torch.isfinite(img_lat).all()):
        fail(f"encoded image latent {tuple(img_lat.shape)} is not a finite "
             f"(16, 21, 60, 104)")
    print(f"   encode seconds: {enc_s:.3f} (81 frames, streamed 1 + 4 x "
          f"20); peak memory {enc_peak / 2**30:.2f} GiB, "
          f"{(enc_peak - resident) / 2**30:.2f} GiB above the resident "
          f"sampler; latent mean|x| {img_lat.abs().mean().item():.6f}")
    print(f"   schedule {kinds} (phase 4e's); clip_fea is zeros and the "
          f"text seeded noise (phase 14 runs T5 and the CLIP tower)")
    clip = torch.zeros((257, CLIP_DIM), device="cuda")
    ctx = torch.randn((64, sampler.cfg.text_dim), generator=gen,
                      device="cuda")
    null = torch.randn((64, sampler.cfg.text_dim), generator=gen,
                       device="cuda")
    run = _wan_i2v_run(
        sampler, opts, kinds,
        lambda **kw: sampler.generate_i2v(img_lat, clip, ctx, null, 81, 60,
                                          104, opts, **kw),
        (3, 81, 480, 832), decode=True)
    print(f"   gpu: {gpu_line()}")
    del img_lat
    done(t0)
    run.update(seconds=time.perf_counter() - t0, encode_s=enc_s,
               encode_peak_gib=enc_peak / 2**30,
               encode_peak_above_resident_gib=(enc_peak - resident) / 2**30)
    prompt = phase_wan_prompt(sampler, opts, kinds, gen)
    del sampler, vae
    _free()
    return decode, run, prompt


# ------------------------------------------------- phases 13-15: encoders

PROMPT = ("A cat walks on the grass, realistic style, soft evening light, "
          "the camera follows it slowly")
ENC_TOL = 2e-2      # card vs CPU relative L2 of an encoder output (TF32 off)


class StandInTokenizer:
    """A stand-in for the HF tokenizer in a sampler's tokenizer slot (the
    card machine has no ``transformers``): words to seeded ids, "\\n\\n" to
    271 (llama-3's, which the I2V crop anchors on), ``<image>`` to a fixed
    id, optional BOS/EOS around the text (CLIP's), padded with 0 to
    ``max_length``. ``.tok.convert_tokens_to_ids`` answers for
    ``<image>``."""

    def __init__(self, vocab_size, max_length, image_id=None, bos=None,
                 eos=None):
        self.vocab_size, self.max_length = vocab_size, max_length
        self.image_id, self.bos, self.eos = image_id, bos, eos
        self.tok = self

    def convert_tokens_to_ids(self, token):
        return self.image_id if token == "<image>" else None

    def _id(self, word):
        import zlib
        if word == "\n\n":
            return 271
        if word == "<image>":
            return self.image_id
        # words land in [300, min(vocab, 128000) - 20): clear of 271 and
        # of the image, BOS and EOS ids of every vocabulary used here
        lo, hi = 300, min(self.vocab_size, 128000) - 20
        return lo + zlib.crc32(word.encode()) % (hi - lo)

    def __call__(self, texts, max_length=None):
        import numpy as np
        n = max_length or self.max_length
        texts = texts if isinstance(texts, list) else [texts]
        ids = np.zeros((len(texts), n), np.int64)
        mask = np.zeros((len(texts), n), np.int64)
        for i, text in enumerate(texts):
            row = [self._id(w) for w in
                   re.findall(r"\n\n|<image>|\n|[^\s]+", text)]
            row = ([self.bos] if self.bos is not None else []) + row + (
                [self.eos] if self.eos is not None else [])
            row = row[:n]
            ids[i, :len(row)] = row
            mask[i, :len(row)] = 1
        return ids, mask


def _rel(a, b) -> float:
    a, b = a.double().cpu(), b.double().cpu()
    return ((a - b).norm() / b.norm()).item()


def _check_states(name, x, shape):
    """A published-width encoder output: the shape, finite, not constant."""
    import torch
    if tuple(x.shape) != shape:
        fail(f"{name}: shape {tuple(x.shape)} != {shape}")
    if not torch.isfinite(x).all() or x.float().std().item() == 0.0:
        fail(f"{name}: not finite, or constant")
    print(f"   {name}: {tuple(x.shape)} {x.dtype}, std "
          f"{x.float().std().item():.6f}")


def _params_gib(*modules):
    return sum(p.numel() * p.element_size() for m in modules
               for p in m.parameters()) / 2**30


def phase_hy_prompt(sampler, img, img_lats, gen):
    """Phase 13 on phase 11b's HunyuanVideo-I2V token_replace sampler (VAE
    attached): the llava LM (LlamaConfig's 4096 x 32, GQA 8), its CLIP-L
    336 tower and projector, and CLIP-L text, seeded on the card in f32
    (the dtype from_pretrained loads), encode_prompt (351 ids) and
    encode_prompt_i2v on the 720x1280 image (934 spliced tokens), then 4
    token_replace steps on those states; then whether a 125f step fits
    beside the resident encoders."""
    import numpy as np
    import torch
    from jenga_tpu_torch.configs.presets import get_hy_i2v_options
    from jenga_tpu_torch.pipelines.hyvideo_i2v import text_block_count
    from jenga_tpu_torch.text.clip import (CLIP_L_TEXT, CLIP_L_VISION_336,
                                          CLIPText, init_clip_text_)
    from jenga_tpu_torch.text.llama import LlamaConfig
    from jenga_tpu_torch.text.llava import (I2V_TEMPLATE_INFO, Llava,
                                           init_llava_)
    t0 = phase("13. HunyuanVideo prompt path at published widths: llava "
               "(f32) + CLIP-L text beside the HY-I2V sampler, encode, 4 "
               "steps")
    lcfg = LlamaConfig()
    torch.cuda.synchronize()
    resident = torch.cuda.memory_allocated() / 2**30
    total = torch.cuda.get_device_properties(0).total_memory / 2**30
    n_llava = (lcfg.vocab_size * lcfg.hidden_size + lcfg.num_layers * (
        2 * lcfg.hidden_size ** 2 + 2 * lcfg.hidden_size * lcfg.num_kv_heads
        * lcfg.head_dim + 3 * lcfg.hidden_size * lcfg.intermediate_size))
    enc_gib = (n_llava + 3.2e8 + 1.23e8) * 4 / 2**30
    print(f"   memory plan: resident sampler + VAE {resident:.2f} GiB + f32 "
          f"encoders ~{enc_gib:.2f} GiB + phase 11b's step working set "
          f"(~11.4 GiB) = {resident + enc_gib + 11.4:.2f} of {total:.2f} GiB"
          f": the encoders stay on the card")
    if resident + enc_gib + 11.4 > total:
        fail("the reckoned memory exceeds the card: run phase 13 under "
             "use_cpu_offload")
    ti = time.perf_counter()
    llava = init_llava_(Llava(lcfg, CLIP_L_VISION_336, "cuda",
                              dtype=torch.float32), gen)
    clip = init_clip_text_(CLIPText(CLIP_L_TEXT, "cuda"), gen)
    torch.cuda.synchronize()
    enc_gib = _params_gib(llava, clip)
    print(f"   encoders: llava {sum(p.numel() for p in llava.parameters())} "
          f"+ CLIP-L text {sum(p.numel() for p in clip.parameters())} "
          f"params, {enc_gib:.2f} GiB f32, init "
          f"{time.perf_counter() - ti:.3f} s; allocated "
          f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB")
    sampler.text_encoder = (StandInTokenizer(lcfg.vocab_size, 256,
                                             image_id=128257), lcfg, llava)
    sampler.text_encoder_2 = (StandInTokenizer(
        CLIP_L_TEXT.vocab_size, 77, bos=49406, eos=CLIP_L_TEXT.eos_token_id),
        CLIP_L_TEXT, clip)
    torch.cuda.reset_peak_memory_stats()
    te = time.perf_counter()
    txt, mask, txt2 = sampler.encode_prompt(PROMPT)
    torch.cuda.synchronize()
    t2v_s = time.perf_counter() - te
    _check_states("encode_prompt states", txt, (256, 4096))
    _check_states("encode_prompt pooled", txt2, (768,))
    te = time.perf_counter()
    txt, mask, txt2 = sampler.encode_prompt_i2v(PROMPT, img)
    torch.cuda.synchronize()
    i2v_s = time.perf_counter() - te
    enc_peak = torch.cuda.max_memory_allocated() / 2**30
    # 576 / 4 strided image tokens, then the text tokens from 678 without
    # the 4 assistant-header tokens before the last "\n\n". The stand-in
    # splits words, not BPE pieces, so its template is shorter than the
    # real tokenizer's 103 tokens and the anchor lands earlier: the count
    # follows extract_i2v_tokens' rule on the stand-in's ids
    ids, _ = sampler.text_encoder[0](
        I2V_TEMPLATE_INFO["video"]["template"].format(PROMPT), 256 + 103)
    last = int(np.nonzero(ids[0] == 271)[0][-1]) + 575
    n_text = max(0, last - 4 - 678) + 934 - last
    _check_states("encode_prompt_i2v states", txt, (144 + n_text, 4096))
    print(f"   encode seconds: T2V prompt {t2v_s:.3f} (351 ids), I2V prompt "
          f"{i2v_s:.3f} (934 spliced tokens); peak {enc_peak:.2f} GiB; "
          f"{int(mask.sum())} of {mask.numel()} tokens unmasked")
    # the options `hyvideo-i2v --preset base` builds (txt_block_num 2 from
    # the T2V preset): generate_i2v takes ceil(tokens / 128) text blocks
    # for the llava states (144 image + up to 256 text tokens), where 2
    # would leave the planner more video rows than video blocks
    opts = get_hy_i2v_options("base", size=(1280, 720), video_length=33,
                              num_inference_steps=4,
                              i2v_condition_type="token_replace")
    print(f"   text blocks: {text_block_count(txt)} for {txt.shape[0]} "
          f"tokens (the options carry {opts.txt_block_num})")
    run = _hy_i2v_run(sampler, opts, img_lats, txt, mask, txt2,
                      (16, 9, 90, 160))
    free = total - torch.cuda.memory_allocated() / 2**30
    # one carved step at 1280x720x125f takes 21.9 GiB above the resident
    # DiT (PERF.md section 5: 45.71 GiB peak with the 23.8 GiB DiT)
    need = 21.9
    fits = free >= need + 1.0
    print(f"   1280x720x125f with the encoders resident: {free:.2f} GiB "
          f"free, a 125f step needs ~{need} GiB above the resident DiT: "
          f"{'fits' if fits else 'does not fit'}"
          f"{'' if fits else ' (use_cpu_offload keeps the encoders on the CPU)'}")
    print(f"   gpu: {gpu_line()}")
    sampler.text_encoder = sampler.text_encoder_2 = None
    del llava, clip
    _free()
    done(t0)
    run.update(seconds=time.perf_counter() - t0, encode_t2v_s=t2v_s,
               encode_i2v_s=i2v_s, encoders_gib=enc_gib,
               encode_peak_gib=enc_peak, free_gib_125f=free, fits_125f=fits)
    return run


def phase_wan_prompt(sampler, opts, kinds, gen):
    """Phase 14 on phase 12's Wan2.1-I2V-14B sampler (VAE attached):
    UMT5-XXL and the CLIP-H tower seeded on the card in f32, then
    generate_image on a seeded 480x832 image with phase 4e's options."""
    import torch
    from jenga_tpu_torch.pipelines.wan_i2v import i2v_latent_size
    from jenga_tpu_torch.text.clip import (CLIP_H_VISION, CLIPVision,
                                          init_clip_vision_)
    from jenga_tpu_torch.text.t5 import UMT5_XXL, T5Encoder, init_t5_
    t0 = phase("14. Wan prompt path at published widths: UMT5-XXL + CLIP-H "
               "(f32) beside the Wan2.1-I2V-14B sampler, generate_image")
    ti = time.perf_counter()
    t5 = init_t5_(T5Encoder(UMT5_XXL, "cuda", dtype=torch.float32), gen)
    clip = init_clip_vision_(CLIPVision(CLIP_H_VISION, "cuda"), gen)
    torch.cuda.synchronize()
    enc_gib = _params_gib(t5, clip)
    print(f"   encoders: UMT5-XXL {sum(p.numel() for p in t5.parameters())} "
          f"+ CLIP-H {sum(p.numel() for p in clip.parameters())} params, "
          f"{enc_gib:.2f} GiB f32, init {time.perf_counter() - ti:.3f} s; "
          f"allocated {torch.cuda.memory_allocated() / 2**30:.2f} GiB")
    sampler.t5 = (StandInTokenizer(UMT5_XXL.vocab_size, 512, eos=1),
                  UMT5_XXL, t5)
    sampler.clip_vision = (CLIP_H_VISION, clip)
    img = torch.rand((3, 480, 832), generator=gen, device="cuda")
    te = time.perf_counter()
    ctx = sampler.encode_prompt(PROMPT)
    torch.cuda.synchronize()
    t5_s = time.perf_counter() - te
    _check_states("T5 prompt states (trimmed)", ctx, (17, 4096))
    te = time.perf_counter()
    fea = sampler.encode_image_clip(img)
    torch.cuda.synchronize()
    clip_s = time.perf_counter() - te
    _check_states("CLIP image tokens", fea, (257, 1280))
    print(f"   encode seconds: T5 {t5_s:.3f} (512 ids), CLIP {clip_s:.3f}")
    # the image's latent size by the reference's rule: (58, 104) at
    # 480x832 under max_area 832*480 (ROADMAP Queue 3)
    lat_h, lat_w = i2v_latent_size(480, 832, opts.max_area)
    run = _wan_i2v_run(
        sampler, opts, kinds,
        lambda **kw: sampler.generate_image(img, PROMPT, opts, **kw),
        (3, 81, lat_h * 8, lat_w * 8), decode=True)
    print(f"   gpu: {gpu_line()}")
    sampler.t5 = sampler.clip_vision = None
    del t5, clip
    _free()
    done(t0)
    run.update(seconds=time.perf_counter() - t0, encode_t5_s=t5_s,
               encode_clip_s=clip_s, encoders_gib=enc_gib)
    return run


# phase 15: small configs the card's kernels take (bf16 DiTs of head dim
# 128), in the reference's directory layout
def small_configs():
    from jenga_tpu_torch.codec import vae_hy, vae_wan
    from jenga_tpu_torch.models.hyvideo import HYVideoConfig
    from jenga_tpu_torch.models.wan import WanConfig
    from jenga_tpu_torch.text.clip import CLIPTextConfig, CLIPVisionConfig
    from jenga_tpu_torch.text.llama import LlamaConfig
    from jenga_tpu_torch.text.t5 import T5Config
    return {
        "hy": HYVideoConfig(hidden_size=256, heads_num=2, double_blocks=1,
                            single_blocks=1, rope_dim_list=(16, 56, 56),
                            text_states_dim=64, text_states_dim_2=32,
                            refiner_depth=1, dtype="bfloat16"),
        "llama": LlamaConfig(vocab_size=512, hidden_size=64,
                             intermediate_size=128, num_layers=3,
                             num_heads=4, num_kv_heads=2),
        "llava_vision": CLIPVisionConfig(image_size=28, patch_size=14,
                                         hidden_size=64,
                                         intermediate_size=128,
                                         num_layers=3, num_heads=4,
                                         act="quick_gelu"),
        "clip_text": CLIPTextConfig(vocab_size=512, hidden_size=32,
                                    intermediate_size=64, num_layers=2,
                                    num_heads=2, eos_token_id=511),
        "hy_vae": vae_hy.HYVAEConfig(**HY_VAE_SMALL),
        "wan_i2v": WanConfig(dim=256, ffn_dim=512, freq_dim=32,
                             num_heads=2, num_layers=2, text_dim=64,
                             text_len=32, dtype="bfloat16",
                             model_type="i2v", in_dim=36),
        "t5": T5Config(vocab_size=512, dim=64, dim_attn=64, dim_ffn=128,
                       num_heads=2, num_layers=2),
        "clip_h": CLIPVisionConfig(hidden_size=1280, intermediate_size=512,
                                   num_layers=2, num_heads=16),
        "wan_vae": vae_wan.WanVAEConfig(dim=8),
    }


@contextlib.contextmanager
def small_published_configs(cfgs):
    """The port's published configs patched to ``cfgs`` for the duration
    (as the tests do), so from_pretrained builds the small models."""
    from jenga_tpu_torch import runtime
    from jenga_tpu_torch.codec import vae_hy, vae_wan
    from jenga_tpu_torch.text import clip, t5
    with contextlib.ExitStack() as stack:
        for obj, name, value in (
                (runtime, "HUNYUAN_VIDEO_T2V", cfgs["hy"]),
                (vae_hy, "HYVAE_884_16C", cfgs["hy_vae"]),
                (vae_wan, "WAN_VAE_16Z", cfgs["wan_vae"]),
                (t5, "UMT5_XXL", cfgs["t5"]),
                (clip, "CLIP_H_VISION", cfgs["clip_h"]),
                (clip, "CLIP_L_VISION_336", cfgs["llava_vision"]),
                (runtime.HunyuanVideoSampler, "TEXT_LEN", 32)):
            stack.enter_context(mock.patch.object(obj, name, value))
        stack.enter_context(mock.patch.dict(
            runtime.WanSampler.CONFIGS, {"i2v-14B": cfgs["wan_i2v"]}))
        yield


class _RefSd(dict):
    """A reference-layout state dict filled from a seeded generator."""

    def __init__(self, seed):
        import torch
        super().__init__()
        self.gen = torch.Generator().manual_seed(seed)

    def add(self, name, *shape):
        import torch
        self[name] = torch.randn(*shape, generator=self.gen) * 0.1

    def lin(self, name, d_in, d_out, bias=True):
        self.add(f"{name}.weight", d_out, d_in)
        if bias:
            self.add(f"{name}.bias", d_out)

    def norm(self, name, d):
        self.add(f"{name}.weight", d)
        self.add(f"{name}.bias", d)


def hy_dit_ref(cfg, seed=0) -> dict:
    """HYVideoDiffusionTransformer's keys at ``cfg``."""
    sd = _RefSd(seed)
    d, hd, mh = cfg.hidden_size, cfg.head_dim, cfg.mlp_hidden
    for i in range(cfg.double_blocks):
        pre = f"double_blocks.{i}"
        for s in ("img", "txt"):
            sd.lin(f"{pre}.{s}_mod.linear", d, 6 * d)
            sd.lin(f"{pre}.{s}_attn_qkv", d, 3 * d)
            sd.add(f"{pre}.{s}_attn_q_norm.weight", hd)
            sd.add(f"{pre}.{s}_attn_k_norm.weight", hd)
            sd.lin(f"{pre}.{s}_attn_proj", d, d)
            sd.lin(f"{pre}.{s}_mlp.fc1", d, mh)
            sd.lin(f"{pre}.{s}_mlp.fc2", mh, d)
    for i in range(cfg.single_blocks):
        pre = f"single_blocks.{i}"
        sd.lin(f"{pre}.modulation.linear", d, 3 * d)
        sd.lin(f"{pre}.linear1", d, 3 * d + mh)
        sd.lin(f"{pre}.linear2", d + mh, d)
        sd.add(f"{pre}.q_norm.weight", hd)
        sd.add(f"{pre}.k_norm.weight", hd)
    for i in range(cfg.refiner_depth):
        pre = f"txt_in.individual_token_refiner.blocks.{i}"
        sd.norm(f"{pre}.norm1", d)
        sd.lin(f"{pre}.self_attn_qkv", d, 3 * d)
        sd.lin(f"{pre}.self_attn_proj", d, d)
        sd.norm(f"{pre}.norm2", d)
        sd.lin(f"{pre}.mlp.fc1", d, mh)
        sd.lin(f"{pre}.mlp.fc2", mh, d)
        sd.lin(f"{pre}.adaLN_modulation.1", d, 2 * d)
    sd.add("img_in.proj.weight", d, cfg.in_channels, *cfg.patch_size)
    sd.add("img_in.proj.bias", d)
    sd.lin("txt_in.input_embedder", cfg.text_states_dim, d)
    sd.lin("txt_in.t_embedder.mlp.0", 256, d)
    sd.lin("txt_in.t_embedder.mlp.2", d, d)
    sd.lin("txt_in.c_embedder.linear_1", cfg.text_states_dim, d)
    sd.lin("txt_in.c_embedder.linear_2", d, d)
    for emb in ("time_in", "guidance_in"):
        sd.lin(f"{emb}.mlp.0", 256, d)
        sd.lin(f"{emb}.mlp.2", d, d)
    sd.lin("vector_in.in_layer", cfg.text_states_dim_2, d)
    sd.lin("vector_in.out_layer", d, d)
    sd.lin("final_layer.linear", d,
           math.prod(cfg.patch_size) * cfg.out_channels)
    sd.lin("final_layer.adaLN_modulation.1", d, 2 * d)
    return dict(sd)


def wan_dit_ref(cfg, seed=0, norm3=True) -> dict:
    """WanModel's keys at ``cfg`` (I2V adds the image branch)."""
    sd = _RefSd(seed)
    d, fd = cfg.dim, cfg.ffn_dim
    sd.add("patch_embedding.weight", d, cfg.in_dim, *cfg.patch_size)
    sd.add("patch_embedding.bias", d)
    sd.lin("text_embedding.0", cfg.text_dim, d)
    sd.lin("text_embedding.2", d, d)
    sd.lin("time_embedding.0", cfg.freq_dim, d)
    sd.lin("time_embedding.2", d, d)
    sd.lin("time_projection.1", d, 6 * d)
    for i in range(cfg.num_layers):
        pre = f"blocks.{i}"
        for a in ("self_attn", "cross_attn"):
            for n in "qkvo":
                sd.lin(f"{pre}.{a}.{n}", d, d)
            sd.add(f"{pre}.{a}.norm_q.weight", d)
            sd.add(f"{pre}.{a}.norm_k.weight", d)
        if cfg.model_type == "i2v":
            sd.lin(f"{pre}.cross_attn.k_img", d, d)
            sd.lin(f"{pre}.cross_attn.v_img", d, d)
            sd.add(f"{pre}.cross_attn.norm_k_img.weight", d)
        if norm3:
            sd.norm(f"{pre}.norm3", d)
        sd.lin(f"{pre}.ffn.0", d, fd)
        sd.lin(f"{pre}.ffn.2", fd, d)
        sd.add(f"{pre}.modulation", 1, 6, d)
    sd.lin("head.head", d, math.prod(cfg.patch_size) * cfg.out_dim)
    sd.add("head.modulation", 1, 2, d)
    if cfg.model_type == "i2v":
        sd.norm("img_emb.proj.0", 1280)
        sd.lin("img_emb.proj.1", 1280, 1280)
        sd.lin("img_emb.proj.3", 1280, d)
        sd.norm("img_emb.proj.4", d)
    return dict(sd)


def hyvae_ref(cfg, seed=0) -> dict:
    """AutoencoderKLCausal3D's keys at ``cfg``."""
    sd = _RefSd(seed)

    def conv(name, ci, co, k=3):
        sd.add(f"{name}.conv.weight", co, ci, k, k, k)
        sd.add(f"{name}.conv.bias", co)

    def resnet(pre, ci, co):
        sd.norm(f"{pre}.norm1", ci)
        conv(f"{pre}.conv1", ci, co)
        sd.norm(f"{pre}.norm2", co)
        conv(f"{pre}.conv2", co, co)
        if ci != co:
            conv(f"{pre}.conv_shortcut", ci, co, k=1)

    def mid(pre, c):
        resnet(f"{pre}.resnets.0", c, c)
        resnet(f"{pre}.resnets.1", c, c)
        sd.norm(f"{pre}.attentions.0.group_norm", c)
        for nm in ("to_q", "to_k", "to_v", "to_out.0"):
            sd.lin(f"{pre}.attentions.0.{nm}", c, c)

    ch, lc = cfg.block_out_channels, cfg.latent_channels
    conv("encoder.conv_in", cfg.in_channels, ch[0])
    c_in = ch[0]
    for i, c_out in enumerate(ch):
        for j in range(cfg.layers_per_block):
            resnet(f"encoder.down_blocks.{i}.resnets.{j}",
                   c_in if j == 0 else c_out, c_out)
        if i != len(ch) - 1:
            conv(f"encoder.down_blocks.{i}.downsamplers.0.conv", c_out,
                 c_out)
        c_in = c_out
    mid("encoder.mid_block", ch[-1])
    sd.norm("encoder.conv_norm_out", ch[-1])
    conv("encoder.conv_out", ch[-1], 2 * lc)
    rch = list(reversed(ch))
    conv("decoder.conv_in", lc, ch[-1])
    mid("decoder.mid_block", ch[-1])
    c_in = rch[0]
    for i, c_out in enumerate(rch):
        for j in range(cfg.layers_per_block + 1):
            resnet(f"decoder.up_blocks.{i}.resnets.{j}",
                   c_in if j == 0 else c_out, c_out)
        if i != len(rch) - 1:
            conv(f"decoder.up_blocks.{i}.upsamplers.0.conv", c_out, c_out)
        c_in = c_out
    sd.norm("decoder.conv_norm_out", ch[0])
    conv("decoder.conv_out", ch[0], cfg.out_channels)
    sd.add("quant_conv.weight", 2 * lc, 2 * lc, 1, 1, 1)
    sd.add("quant_conv.bias", 2 * lc)
    sd.add("post_quant_conv.weight", lc, lc, 1, 1, 1)
    sd.add("post_quant_conv.bias", lc)
    return dict(sd)


def wanvae_ref(cfg, seed=0) -> dict:
    """WanVAE_'s keys at ``cfg`` (flat nn.Sequential indices)."""
    sd = _RefSd(seed)

    def c3(name, ci, co, k=(3, 3, 3)):
        sd.add(f"{name}.weight", co, ci, *k)
        sd.add(f"{name}.bias", co)

    def c2(name, ci, co, k=3):
        sd.add(f"{name}.weight", co, ci, k, k)
        sd.add(f"{name}.bias", co)

    def res(pre, ci, co):
        sd.add(f"{pre}.residual.0.gamma", ci, 1, 1, 1)
        c3(f"{pre}.residual.2", ci, co)
        sd.add(f"{pre}.residual.3.gamma", co, 1, 1, 1)
        c3(f"{pre}.residual.6", co, co)
        if ci != co:
            c3(f"{pre}.shortcut", ci, co, k=(1, 1, 1))

    def middle(pre, c):
        res(f"{pre}.0", c, c)
        sd.add(f"{pre}.1.norm.gamma", c, 1, 1)
        c2(f"{pre}.1.to_qkv", c, 3 * c, k=1)
        c2(f"{pre}.1.proj", c, c, k=1)
        res(f"{pre}.2", c, c)

    dims = [cfg.dim * u for u in (1,) + tuple(cfg.dim_mult)]
    c3("encoder.conv1", 3, dims[0])
    idx, c = 0, dims[0]
    for i, co in enumerate(dims[1:]):
        for _ in range(cfg.num_res_blocks):
            res(f"encoder.downsamples.{idx}", c, co)
            c, idx = co, idx + 1
        if i != len(cfg.dim_mult) - 1:
            pre = f"encoder.downsamples.{idx}"
            c2(f"{pre}.resample.1", co, co)
            if cfg.temporal_downsample[i]:
                c3(f"{pre}.time_conv", co, co, k=(3, 1, 1))
            idx += 1
    middle("encoder.middle", dims[-1])
    sd.add("encoder.head.0.gamma", dims[-1], 1, 1, 1)
    c3("encoder.head.2", dims[-1], 2 * cfg.z_dim)
    rdims = [cfg.dim * u for u in (cfg.dim_mult[-1],)
             + tuple(reversed(cfg.dim_mult))]
    t_up = tuple(reversed(cfg.temporal_downsample))
    c3("decoder.conv1", cfg.z_dim, rdims[0])
    middle("decoder.middle", rdims[0])
    idx = 0
    for i, co in enumerate(rdims[1:]):
        c = rdims[i] // 2 if i in (1, 2, 3) else rdims[i]
        for _ in range(cfg.num_res_blocks + 1):
            res(f"decoder.upsamples.{idx}", c, co)
            c, idx = co, idx + 1
        if i != len(cfg.dim_mult) - 1:
            pre = f"decoder.upsamples.{idx}"
            c2(f"{pre}.resample.1", co, co // 2)
            if t_up[i]:
                c3(f"{pre}.time_conv", co, 2 * co, k=(3, 1, 1))
            idx += 1
    sd.add("decoder.head.0.gamma", cfg.dim, 1, 1, 1)
    c3("decoder.head.2", cfg.dim, 3)
    c3("conv1", 2 * cfg.z_dim, 2 * cfg.z_dim, k=(1, 1, 1))
    c3("conv2", cfg.z_dim, cfg.z_dim, k=(1, 1, 1))
    return dict(sd)


def umt5_wan_ref(cfg, seed=0) -> dict:
    """Wan's own T5 layout at ``cfg``."""
    sd = _RefSd(seed)
    d, da, df = cfg.dim, cfg.dim_attn, cfg.dim_ffn
    sd.add("token_embedding.weight", cfg.vocab_size, d)
    sd.add("norm.weight", d)
    if cfg.shared_pos:
        sd.add("pos_embedding.embedding.weight", cfg.num_buckets,
               cfg.num_heads)
    for i in range(cfg.num_layers):
        pre = f"blocks.{i}"
        sd.add(f"{pre}.norm1.weight", d)
        sd.add(f"{pre}.norm2.weight", d)
        for n in "qkv":
            sd.lin(f"{pre}.attn.{n}", d, da, bias=False)
        sd.lin(f"{pre}.attn.o", da, d, bias=False)
        sd.lin(f"{pre}.ffn.gate.0", d, df, bias=False)
        sd.lin(f"{pre}.ffn.fc1", d, df, bias=False)
        sd.lin(f"{pre}.ffn.fc2", df, d, bias=False)
        if not cfg.shared_pos:
            sd.add(f"{pre}.pos_embedding.embedding.weight", cfg.num_buckets,
                   cfg.num_heads)
    return dict(sd)


def clip_wan_ref(vcfg, tcfg=None, seed=0) -> dict:
    """Wan XLMRobertaCLIP's keys: ``visual.*`` at ``vcfg`` and, with
    ``tcfg`` (an XLMRobertaConfig), ``textual.*``."""
    sd = _RefSd(seed)
    d, p = vcfg.hidden_size, vcfg.patch_size
    sd.add("visual.patch_embedding.weight", d, 3, p, p)
    sd.add("visual.cls_embedding", 1, 1, d)
    sd.add("visual.pos_embedding", 1, (vcfg.image_size // p) ** 2 + 1, d)
    sd.norm("visual.pre_norm", d)
    sd.norm("visual.post_norm", d)
    for i in range(vcfg.num_layers):
        pre = f"visual.transformer.{i}"
        sd.norm(f"{pre}.norm1", d)
        sd.norm(f"{pre}.norm2", d)
        sd.lin(f"{pre}.attn.to_qkv", d, 3 * d)
        sd.lin(f"{pre}.attn.proj", d, d)
        sd.lin(f"{pre}.mlp.0", d, vcfg.intermediate_size)
        sd.lin(f"{pre}.mlp.2", vcfg.intermediate_size, d)
    if tcfg is not None:
        t = tcfg.dim
        sd.add("textual.token_embedding.weight", tcfg.vocab_size, t)
        sd.add("textual.type_embedding.weight", tcfg.type_size, t)
        sd.add("textual.pos_embedding.weight", tcfg.max_positions, t)
        sd.norm("textual.norm", t)
        for i in range(tcfg.num_layers):
            pre = f"textual.blocks.{i}"
            for n in "qkvo":
                sd.lin(f"{pre}.attn.{n}", t, t)
            sd.norm(f"{pre}.norm1", t)
            sd.norm(f"{pre}.norm2", t)
            sd.lin(f"{pre}.ffn.0", t, tcfg.ffn_dim)
            sd.lin(f"{pre}.ffn.2", tcfg.ffn_dim, t)
    return dict(sd)


def _hf_encoder_layers(sd, pre, n, d, ffn):
    for i in range(n):
        p = f"{pre}.encoder.layers.{i}"
        sd.norm(f"{p}.layer_norm1", d)
        for nm in ("q_proj", "k_proj", "v_proj", "out_proj"):
            sd.lin(f"{p}.self_attn.{nm}", d, d)
        sd.norm(f"{p}.layer_norm2", d)
        sd.lin(f"{p}.mlp.fc1", d, ffn)
        sd.lin(f"{p}.mlp.fc2", ffn, d)


def hf_llava_ref(lcfg, vcfg, seed=0) -> dict:
    """LlavaForConditionalGeneration's keys (the pre-4.52 layout)."""
    sd = _RefSd(seed)
    v, d, p = vcfg.hidden_size, lcfg.hidden_size, vcfg.patch_size
    vt = "vision_tower.vision_model"
    sd.add(f"{vt}.embeddings.patch_embedding.weight", v, 3, p, p)
    sd.add(f"{vt}.embeddings.class_embedding", v)
    sd.add(f"{vt}.embeddings.position_embedding.weight",
           (vcfg.image_size // p) ** 2 + 1, v)
    sd.norm(f"{vt}.pre_layrnorm", v)
    _hf_encoder_layers(sd, vt, vcfg.num_layers, v, vcfg.intermediate_size)
    sd.norm(f"{vt}.post_layernorm", v)
    sd.lin("multi_modal_projector.linear_1", v, d)
    sd.lin("multi_modal_projector.linear_2", d, d)
    kvd = lcfg.num_kv_heads * lcfg.head_dim
    lm = "language_model.model"
    sd.add(f"{lm}.embed_tokens.weight", lcfg.vocab_size, d)
    for i in range(lcfg.num_layers):
        pre = f"{lm}.layers.{i}"
        sd.add(f"{pre}.input_layernorm.weight", d)
        sd.add(f"{pre}.post_attention_layernorm.weight", d)
        for nm, o in (("q_proj", d), ("k_proj", kvd), ("v_proj", kvd),
                      ("o_proj", d)):
            sd.lin(f"{pre}.self_attn.{nm}", d, o, bias=False)
        sd.lin(f"{pre}.mlp.gate_proj", d, lcfg.intermediate_size, bias=False)
        sd.lin(f"{pre}.mlp.up_proj", d, lcfg.intermediate_size, bias=False)
        sd.lin(f"{pre}.mlp.down_proj", lcfg.intermediate_size, d, bias=False)
    sd.add(f"{lm}.norm.weight", d)
    sd.add("language_model.lm_head.weight", lcfg.vocab_size, d)
    return dict(sd)


def hf_clip_text_ref(cfg, seed=0) -> dict:
    """CLIPTextModel's keys at ``cfg``."""
    sd = _RefSd(seed)
    d = cfg.hidden_size
    sd.add("text_model.embeddings.token_embedding.weight", cfg.vocab_size, d)
    sd.add("text_model.embeddings.position_embedding.weight",
           cfg.max_positions, d)
    _hf_encoder_layers(sd, "text_model", cfg.num_layers, d,
                       cfg.intermediate_size)
    sd.norm("text_model.final_layer_norm", d)
    return dict(sd)


_ST_TAGS = {"float32": "F32", "float16": "F16", "bfloat16": "BF16",
            "float8_e4m3fn": "F8_E4M3", "int64": "I64"}


def write_safetensors(path, tensors: dict):
    """The safetensors format, written by hand: an 8-byte little-endian
    header length, the JSON header (dtype, shape, data offsets), the raw
    bytes."""
    import struct
    import torch
    header, blobs, off = {}, [], 0
    for name, t in tensors.items():
        t = t.detach().cpu().contiguous()
        raw = t.reshape(-1).view(torch.uint8).numpy().tobytes()
        header[name] = {"dtype": _ST_TAGS[str(t.dtype).split(".")[-1]],
                        "shape": list(t.shape),
                        "data_offsets": [off, off + len(raw)]}
        blobs.append(raw)
        off += len(raw)
    head = json.dumps(header).encode()
    head += b" " * (-len(head) % 8)
    with open(path, "wb") as f:
        f.write(struct.pack("<Q", len(head)) + head)
        for raw in blobs:
            f.write(raw)


def _write_sharded(dirpath, sd: dict, stem: str, n: int = 2):
    """``sd`` over ``n`` shards with a ``<stem>.safetensors.index.json``."""
    keys = sorted(sd)
    weight_map = {}
    for s in range(n):
        name = f"{stem}-{s + 1:05d}-of-{n:05d}.safetensors"
        part = keys[s * len(keys) // n:(s + 1) * len(keys) // n]
        write_safetensors(os.path.join(dirpath, name),
                          {k: sd[k] for k in part})
        weight_map.update(dict.fromkeys(part, name))
    with open(os.path.join(dirpath, f"{stem}.safetensors.index.json"),
              "w") as f:
        json.dump({"weight_map": weight_map}, f)


def write_reference_dirs(root, cfgs) -> dict:
    """Two checkpoint directories in the reference's layout at ``cfgs``
    (``small_configs()``): ``hy`` (pytorch_model_module.pt in a deepspeed
    ``module`` wrapper, its fp8 copy with the scale map, vae/,
    text_encoder/ as a sharded safetensors llava with its index and
    config.json, text_encoder_2/ as a CLIP safetensors file), ``wan_i2v``
    (the sharded diffusion safetensors, Wan2.1_VAE.pth, the T5 and CLIP
    .pth files), and a kohya LoRA. Seeded; no tokenizer files."""
    import torch
    from jenga_tpu_torch.runtime import WanSampler
    hy, wan = os.path.join(root, "hy"), os.path.join(root, "wan_i2v")
    for d in (os.path.join(hy, "vae"), os.path.join(hy, "text_encoder"),
              os.path.join(hy, "text_encoder_2"), wan):
        os.makedirs(d, exist_ok=True)
    sd = hy_dit_ref(cfgs["hy"], seed=21)
    torch.save({"module": sd}, os.path.join(hy, "pytorch_model_module.pt"))
    fp8, scales = {}, {}
    for k, v in sd.items():
        if v.ndim == 2:
            s = v.abs().max() / 448.0
            fp8[k] = (v / s).to(torch.float8_e4m3fn)
            scales[k[:-len(".weight")]] = s
        else:
            fp8[k] = v
    torch.save(fp8, os.path.join(hy, "pytorch_model_module_fp8.pt"))
    torch.save(scales, os.path.join(hy, "pytorch_model_module_fp8_map.pt"))
    torch.save(hyvae_ref(cfgs["hy_vae"], seed=22),
               os.path.join(hy, "vae", "pytorch_model.pt"))
    lcfg, ccfg = cfgs["llama"], cfgs["clip_text"]
    _write_sharded(os.path.join(hy, "text_encoder"),
                   hf_llava_ref(lcfg, cfgs["llava_vision"], seed=23),
                   "model")
    with open(os.path.join(hy, "text_encoder", "config.json"), "w") as f:
        json.dump({"text_config": {
            "vocab_size": lcfg.vocab_size, "hidden_size": lcfg.hidden_size,
            "intermediate_size": lcfg.intermediate_size,
            "num_hidden_layers": lcfg.num_layers,
            "num_attention_heads": lcfg.num_heads,
            "num_key_value_heads": lcfg.num_kv_heads}}, f)
    write_safetensors(os.path.join(hy, "text_encoder_2", "model.safetensors"),
                      hf_clip_text_ref(ccfg, seed=24))
    with open(os.path.join(hy, "text_encoder_2", "config.json"), "w") as f:
        json.dump({"vocab_size": ccfg.vocab_size,
                   "hidden_size": ccfg.hidden_size,
                   "intermediate_size": ccfg.intermediate_size,
                   "num_hidden_layers": ccfg.num_layers,
                   "num_attention_heads": ccfg.num_heads,
                   "eos_token_id": ccfg.eos_token_id}, f)
    g = torch.Generator().manual_seed(25)
    d = cfgs["hy"].hidden_size
    lora = {}
    for name, (o, i) in {"double_blocks_0_img_attn_qkv": (3 * d, d),
                         "single_blocks_0_linear2":
                         (d, d + cfgs["hy"].mlp_hidden)}.items():
        key = f"Hunyuan_video_I2V_lora_{name}"
        lora[f"{key}.lora_down.weight"] = torch.randn(4, i, generator=g)
        lora[f"{key}.lora_up.weight"] = torch.randn(o, 4, generator=g) * 0.1
        lora[f"{key}.alpha"] = torch.tensor(2.0)
    write_safetensors(os.path.join(root, "lora.safetensors"), lora)
    _write_sharded(wan, wan_dit_ref(cfgs["wan_i2v"], seed=26),
                   "diffusion_pytorch_model")
    torch.save(wanvae_ref(cfgs["wan_vae"], seed=27),
               os.path.join(wan, "Wan2.1_VAE.pth"))
    torch.save(umt5_wan_ref(cfgs["t5"], seed=28),
               os.path.join(wan, WanSampler.T5_CKPT))
    torch.save(clip_wan_ref(cfgs["clip_h"], seed=29),
               os.path.join(wan, WanSampler.CLIP_CKPT))
    return {"hy": hy, "wan_i2v": wan,
            "lora": os.path.join(root, "lora.safetensors")}


def _same_tensors(name, a: dict, b: dict):
    """Two state dicts bit for bit (the card's copied to the CPU)."""
    import torch
    if sorted(a) != sorted(b):
        fail(f"{name}: the loads hold other names")
    for k in a:
        x, y = a[k].cpu(), b[k].cpu()
        if x.dtype != y.dtype or x.shape != y.shape or not torch.equal(
                x.reshape(-1).view(torch.uint8),
                y.reshape(-1).view(torch.uint8)):
            fail(f"{name}: {k} differs between the card's and the CPU's "
                 f"load")


def _placed(name, module, device):
    devs = {p.device.type for p in module.parameters()}
    if devs != {device}:
        fail(f"{name} is on {devs}, asked for {device}")


def _set_standins(hy=None, wan=None, cfgs=None):
    if hy is not None:
        lcfg = hy.text_encoder[1]
        hy.text_encoder = (StandInTokenizer(lcfg.vocab_size, 32,
                                            image_id=500),
                           *hy.text_encoder[1:])
        ccfg = hy.text_encoder_2[1]
        hy.text_encoder_2 = (StandInTokenizer(ccfg.vocab_size, 77,
                                              eos=ccfg.eos_token_id),
                             *hy.text_encoder_2[1:])
    if wan is not None:
        wan.t5 = (StandInTokenizer(wan.t5[1].vocab_size, 512, eos=1),
                  *wan.t5[1:])


def phase_checkpoints():
    """Phase 15: small reference-layout directories loaded on the card
    and on the CPU."""
    import shutil
    import torch
    from jenga_tpu_torch.configs.presets import (get_hy_preset,
                                                 get_wan_i2v_options)
    from jenga_tpu_torch.runtime import HunyuanVideoSampler, WanSampler
    t0 = phase("15. checkpoint directories on the card: small configs in "
               "the reference's layout, from_pretrained on the card vs the "
               "CPU")
    cfgs = small_configs()
    root = tempfile.mkdtemp(prefix="ckpt_")
    rels = {}
    torch.cuda.reset_peak_memory_stats()
    try:
        dirs = write_reference_dirs(root, cfgs)
        img = torch.rand((3, 40, 30), generator=torch.Generator()
                         .manual_seed(30))
        with small_published_configs(cfgs):
            for label, kw in (("plain", {}), ("use_fp8", {"use_fp8": True}),
                              ("lora", {"lora_path": dirs["lora"],
                                        "lora_alpha": 0.8}),
                              ("use_cpu_offload",
                               {"use_cpu_offload": True})):
                ti = time.perf_counter()
                card = HunyuanVideoSampler.from_pretrained(
                    dirs["hy"], device="cuda", **kw)
                load_s = time.perf_counter() - ti
                cpu = HunyuanVideoSampler.from_pretrained(
                    dirs["hy"], device="cpu", **kw)
                parts = {"DiT": (card.model, cpu.model), "VAE": (
                    card.vae, cpu.vae), "llava": (card.text_encoder[2],
                                                  cpu.text_encoder[2]),
                         "CLIP text": (card.text_encoder_2[2],
                                       cpu.text_encoder_2[2])}
                aux = "cpu" if label == "use_cpu_offload" else "cuda"
                for part, (a, b) in parts.items():
                    _same_tensors(f"HY {label} {part}", a.state_dict(),
                                  b.state_dict())
                    _placed(f"HY {label} {part}", a,
                            "cuda" if part == "DiT" else aux)
                _set_standins(hy=card)
                _set_standins(hy=cpu)
                for enc, args in (("encode_prompt", (PROMPT,)),
                                  ("encode_prompt_i2v", (PROMPT, img))):
                    got = getattr(card, enc)(*args)
                    want = getattr(cpu, enc)(*args)
                    for j, (g, w) in enumerate(zip(got, want)):
                        if j == 1:
                            if not torch.equal(g.cpu(), w):
                                fail(f"HY {label} {enc}: the masks differ")
                            continue
                        rels[f"hy_{label}_{enc}_{j}"] = r = _rel(g, w)
                        if not r <= ENC_TOL:
                            fail(f"HY {label} {enc} output {j}: card vs "
                                 f"CPU relative L2 {r} > {ENC_TOL}")
                opts = get_hy_preset("base", size=(256, 128),
                                     video_length=9, num_inference_steps=2)
                with _Launches() as run:
                    out = card.predict_prompt(PROMPT, opts)
                    torch.cuda.synchronize()
                _check_video(out, (3, 9, 128, 256))
                if run.counts["block_sparse_attn"] + run.counts[
                        "dense_attn"] == 0:
                    fail(f"HY {label}: no attention kernel launched")
                _placed(f"HY {label} VAE after decode", card.vae, aux)
                print(f"   HY {label}: loaded in {load_s:.3f} s, tensors "
                      f"equal to the CPU load, DiT on cuda, encoders and "
                      f"VAE on {aux}; prompt -> 2 steps -> video "
                      f"{tuple(out.shape)}; launches {run.counts}")
                del card, cpu, out
                _free()
            for label, kw in (("plain", {}), ("t5_on_host",
                                              {"t5_on_host": True})):
                card = WanSampler.from_pretrained(
                    "i2v-14B", dirs["wan_i2v"], device="cuda", **kw)
                cpu = WanSampler.from_pretrained(
                    "i2v-14B", dirs["wan_i2v"], device="cpu", **kw)
                t5_dev = "cpu" if label == "t5_on_host" else "cuda"
                for part, a, b, dev in (
                        ("DiT", card.model, cpu.model, "cuda"),
                        ("VAE", card.vae, cpu.vae, "cuda"),
                        ("T5", card.t5[2], cpu.t5[2], t5_dev),
                        ("CLIP", card.clip_vision[1], cpu.clip_vision[1],
                         "cuda")):
                    _same_tensors(f"Wan {label} {part}", a.state_dict(),
                                  b.state_dict())
                    _placed(f"Wan {label} {part}", a, dev)
                _set_standins(wan=card)
                _set_standins(wan=cpu)
                for enc, arg in (("encode_prompt", PROMPT),
                                 ("encode_image_clip", img)):
                    rels[f"wan_{label}_{enc}"] = r = _rel(
                        getattr(card, enc)(arg), getattr(cpu, enc)(arg))
                    if not r <= ENC_TOL:
                        fail(f"Wan {label} {enc}: card vs CPU relative L2 "
                             f"{r} > {ENC_TOL}")
                opts = get_wan_i2v_options(256 * 256, frame_num=9,
                                           sampling_steps=2)
                with _Launches() as run:
                    out = card.generate_image(img, PROMPT, opts)
                    torch.cuda.synchronize()
                if out.ndim != 4 or out.shape[:2] != (3, 9) or not \
                        torch.isfinite(out).all():
                    fail(f"Wan {label}: video {tuple(out.shape)} is not a "
                         f"finite [3, 9, H, W]")
                if run.counts["dense_attn"] == 0:
                    fail(f"Wan {label}: D did not launch")
                print(f"   Wan I2V {label}: tensors equal to the CPU load, "
                      f"T5 on {t5_dev}; image + prompt -> 2 steps -> video "
                      f"{tuple(out.shape)}; launches {run.counts}")
                del card, cpu, out
                _free()
    finally:
        shutil.rmtree(root, ignore_errors=True)
    peak = torch.cuda.max_memory_allocated() / 2**30
    print(f"   card vs CPU relative L2, max over the encoder outputs: "
          f"{max(rels.values()):.3e} (bound {ENC_TOL}); peak memory "
          f"{peak:.2f} GiB")
    print(f"   gpu: {gpu_line()}")
    done(t0)
    return {"seconds": time.perf_counter() - t0, "rel": rels,
            "peak_gib": peak}


# ------------------------------------------- phases 16-16b: LoRA training


def _counts(**nonzero):
    """Every counter of ``_Launches`` at 0 but the ones given."""
    return {"block_sparse_attn": 0, "block_sparse_attn_members": 0,
            "dense_attn": 0, "dense_attn_short": 0, **NOT_SERVING,
            **nonzero}


def _lora_grad_norm(lora) -> float:
    return math.sqrt(sum(float(x.grad.float().square().sum())
                         for ab in lora.values() for x in ab.values()
                         if x.grad is not None))


def _train_steps(label, step, lora, base, batch, gen, n, expect):
    """``n`` LoRA steps, each counted on its own: seconds, loss, the LoRA
    gradient's norm, peak memory and the launches per step; fails on a
    loss or norm that is not finite and positive, or on counts other than
    ``expect``."""
    import torch
    rows, total = [], dict.fromkeys(expect, 0)
    for i in range(n):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        ts = time.perf_counter()
        with _Launches() as run:
            loss = float(step(lora, base, batch, gen))
            torch.cuda.synchronize()
        secs = time.perf_counter() - ts
        norm = _lora_grad_norm(lora)
        peak = torch.cuda.max_memory_allocated() / 2**30
        counts = {k: v for k, v in run.counts.items() if v}
        print(f"   {label} step {i}: {secs:.3f} s, loss {loss:.6f}, LoRA "
              f"grad norm {norm:.6e}, peak {peak:.2f} GiB, launches "
              f"{counts}", flush=True)
        if not (math.isfinite(loss) and loss > 0 and math.isfinite(norm)
                and norm > 0):
            fail(f"{label} step {i}: loss {loss}, LoRA grad norm {norm}")
        if run.counts != expect:
            fail(f"{label} step {i}: launches {run.counts} != {expect}")
        rows.append({"s": secs, "loss": loss, "grad_norm": norm,
                     "peak_gib": peak})
        total = {k: total[k] + v for k, v in run.counts.items()}
    return {"steps": rows, "launches": total}


def phase_train_wan():
    """Phase 16: LoRA fine-tuning of Wan2.1-T2V-1.3B at full width and
    depth through make_lora_train_step: 3 dense steps, 2 carved steps,
    then the adapters exported to kohya and merged against the functional
    merge."""
    import numpy as np
    import torch
    from torch.func import functional_call
    from jenga_tpu_torch import convert as C
    from jenga_tpu_torch.models.wan import (WAN_T2V_1_3B, WanDiT, init_wan_,
                                            make_wan_carve)
    from jenga_tpu_torch.train import TransportConfig, make_lora_train_step
    from jenga_tpu_torch.train.dataset import LatentDataset
    from jenga_tpu_torch.train.lora import (apply_lora, export_kohya,
                                            init_lora, lora_param_count,
                                            lora_tensors)
    t0 = phase("16. LoRA fine-tuning: Wan2.1-T2V-1.3B, full width and depth,"
               " 832x480x81f, rank 16, remat, AdamW")
    cfg = WAN_T2V_1_3B
    gen = torch.Generator(device="cuda").manual_seed(16)
    model = init_wan_(WanDiT(cfg, device="cuda"), gen)
    _perturb_wan(model, gen)
    lat_shape = (16, 21, 60, 104)
    with tempfile.TemporaryDirectory() as tmp:
        rng = np.random.default_rng(16)
        jdir = os.path.join(tmp, "jsons")
        os.mkdir(jdir)
        npy = os.path.join(tmp, "clip0.npy")
        np.save(npy, rng.standard_normal(lat_shape).astype(np.float32))
        with open(os.path.join(jdir, "clip0.json"), "w") as f:
            json.dump({"video_id": "clip0", "latent_shape": list(lat_shape),
                       "prompt": PROMPT, "npy_save_path": npy}, f)
        data = next(LatentDataset(jdir).batches(1, np.random.default_rng(0)))
    batch = {"latents": torch.as_tensor(data["latents"], device="cuda"),
             "context": torch.randn((1, cfg.text_len, cfg.text_dim),
                                    generator=gen, device="cuda")}
    lora = init_lora(gen, model, rank=16)
    base = dict(model.named_parameters())
    opt = torch.optim.AdamW(lora_tensors(lora), lr=1e-4, weight_decay=1e-4)
    tcfg = TransportConfig(shift=5.0)
    print(f"   {len(lora)} adapters, {lora_param_count(lora)} LoRA "
          f"parameters on {sum(p.numel() for p in base.values())} frozen; "
          f"latents {tuple(batch['latents'].shape)} from LatentDataset, "
          f"{cfg.text_len} text keys", flush=True)
    layers = cfg.num_layers
    carve = make_wan_carve(cfg, WAN_GRID, 0.75, 0.9, q_rows=8,
                           joint_sel=True, device="cuda")
    runs = {}
    # with remat each block's forward runs twice: D on self and cross
    # attention (dense) or K1 on self and D on cross (carved), each
    # launched again in the recompute (the cross-attention's 512 keys on
    # the short-key kernel); the backward launches dkv and dq once per
    # dense self-attention and the short-key backward once per
    # cross-attention
    for label, cv, n, expect in (
            ("dense", None, 3, _counts(
                dense_attn=4 * layers, dense_attn_short=2 * layers,
                dense_attn_bwd_dkv=layers, dense_attn_bwd_dq=layers,
                dense_attn_bwd_short=layers)),
            ("carved", carve, 2, _counts(
                block_sparse_attn=2 * layers, dense_attn=2 * layers,
                dense_attn_short=2 * layers,
                dense_attn_bwd_short=layers))):
        def apply(p, xt, t, b, cv=cv):
            return functional_call(model, p, (xt, t, b["context"]),
                                   {"carve": cv, "remat": True})
        step = make_lora_train_step(apply, tcfg, opt)
        runs[label] = _train_steps(f"16 {label}", step, lora, base, batch,
                                   gen, n, expect)

    # the adapters through the reference's kohya layout and merge_lora
    # (on the CPU, as a checkpoint load merges) against apply_lora
    prefix = "Hunyuan_video_I2V"
    kohya = export_kohya(lora, prefix=prefix)
    keys = {name: C._kohya_to_module_key(
        f"{prefix}_lora_" + name.replace(".", "_"), prefix) + ".weight"
        for name in lora}
    sd = C.merge_lora({keys[name]: base[f"{name}.w"].detach().cpu()
                       for name in lora}, kohya, prefix=prefix)
    with torch.no_grad():
        merged = apply_lora(base, lora)
        loaded = dict(base)
        loaded.update({f"{name}.w": sd[keys[name]].to("cuda")
                       for name in lora})
        equal = sum(torch.equal(loaded[f"{n}.w"], merged[f"{n}.w"])
                    for n in lora)
        x = batch["latents"]
        tt = torch.full((1,), 500.0, device="cuda")
        want = functional_call(model, merged, (x, tt, batch["context"]),
                               {"carve": carve})
        got = functional_call(model, loaded, (x, tt, batch["context"]),
                              {"carve": carve})
    rel = _rel(got, want)
    print(f"   export_kohya -> merge_lora: {equal} of {len(lora)} merged "
          f"weights bit-equal to apply_lora's; carved forward relative L2 "
          f"{rel:.3e} (bound {E2E_REL_TOL})")
    if not (torch.isfinite(got).all() and rel <= E2E_REL_TOL):
        fail(f"16: the kohya-merged forward is {rel} from apply_lora's")
    print(f"   gpu: {gpu_line()}")
    del model, base, lora, opt, merged, loaded, sd, got, want, batch
    _free()
    done(t0)
    return {**runs, "merge_rel": rel, "merge_equal": equal,
            "seconds": time.perf_counter() - t0}


def phase_train_hy_i2v():
    """Phase 16b: LoRA fine-tuning of HunyuanVideo-I2V token_replace at
    full width cut to 2 + 4 blocks, 1280x720x33f: one carved step and one
    dense-fallback step."""
    import torch
    from torch.func import functional_call
    from jenga_tpu_torch.models.hyvideo import (HYVideoDiT, hy_i2v_config,
                                                init_hyvideo_, make_hy_carve)
    from jenga_tpu_torch.train import TransportConfig, make_lora_train_step
    from jenga_tpu_torch.train.lora import (init_lora, lora_param_count,
                                            lora_tensors)
    t0 = phase("16b. LoRA fine-tuning: HunyuanVideo-I2V token_replace, full "
               "width, 2 + 4 blocks, 1280x720x33f, rank 16, remat, AdamW")
    cfg = dataclasses.replace(hy_i2v_config("token_replace"),
                              double_blocks=2, single_blocks=4)
    gen = torch.Generator(device="cuda").manual_seed(17)
    model = init_hyvideo_(HYVideoDiT(cfg, device="cuda"), gen)
    _perturb(model, gen)
    lat = torch.randn((1, 16, 9, 90, 160), generator=gen, device="cuda")
    txt, mask, txt2 = _text(gen, cfg, n_pad=40)
    batch = {"latents": lat, "cond_latents": lat[:, :, :1],
             "txt": txt[None], "mask": mask[None], "txt2": txt2[None],
             "guidance": torch.full((1,), 6000.0, device="cuda")}
    lora = init_lora(gen, model, rank=16)
    base = dict(model.named_parameters())
    opt = torch.optim.AdamW(lora_tensors(lora), lr=1e-4, weight_decay=1e-4)
    print(f"   {len(lora)} adapters, {lora_param_count(lora)} LoRA "
          f"parameters; 32,400 video + 256 text tokens (216 valid)",
          flush=True)
    blocks = cfg.double_blocks + cfg.single_blocks
    # the Base preset's stage-1 selection with the Turbo stage-0 text
    # amplitude, so that text_amp is inside the recompute backward
    carve = make_hy_carve(cfg, (9, 45, 80), 0.75, 0.3, text_amp=HY_AMP0,
                          txt_block_num=2, q_rows=8, joint_sel=True,
                          device="cuda")
    runs = {}
    for label, cv, expect in (
            ("carved", carve, _counts(block_sparse_attn=2 * blocks)),
            ("dense", None, _counts(dense_attn=2 * blocks,
                                    dense_attn_bwd_dkv=blocks,
                                    dense_attn_bwd_dq=blocks))):
        def apply(p, xt, t, b, cv=cv):
            return functional_call(
                model, p, (xt, t, b["txt"], b["mask"], b["txt2"]),
                {"carve": cv, "guidance": b["guidance"], "remat": True})
        step = make_lora_train_step(apply, TransportConfig(shift=7.0), opt,
                                    i2v_condition_type="token_replace")
        runs[label] = _train_steps(f"16b {label}", step, lora, base, batch,
                                   gen, 1, expect)
    print(f"   gpu: {gpu_line()}")
    del model, base, lora, opt, batch
    _free()
    done(t0)
    return {**runs, "seconds": time.perf_counter() - t0}


# ------------------------------------------------------ 17: sequence parallel

SP_REL_TOL = 1e-3   # 17a/17b: the SP forward at world 1 against the plain


def _free_port() -> int:
    import socket
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


@contextlib.contextmanager
def _recorded_masks(masks):
    """Record every planner mask handed to the carved dispatch, from the
    single-device models and from the Ulysses path."""
    from jenga_tpu_torch.models import hyvideo, wan
    from jenga_tpu_torch.ops.sparse_dispatch import \
        sparse_attention_from_mask as real
    from jenga_tpu_torch.parallel import ulysses

    def recording(qt, kt, vt, mask, **kw):
        masks.append(mask.clone())
        return real(qt, kt, vt, mask, **kw)

    with mock.patch.object(hyvideo, "sparse_attention_from_mask",
                           recording), \
            mock.patch.object(wan, "sparse_attention_from_mask", recording), \
            mock.patch.object(ulysses, "sparse_attention_from_mask",
                              recording):
        yield


def _sp_step(label, fwd, mesh, layers, expect):
    """One step through ``fwd(mesh)`` and the same without a mesh: the
    planner masks equal, the outputs within SP_REL_TOL, the SP run's
    launches as ``expect``; then both timed in turns (plain, SP, SP,
    plain)."""
    import torch
    plain_masks, sp_masks = [], []
    with torch.inference_mode():
        with _recorded_masks(plain_masks):
            want = fwd(None)
            torch.cuda.synchronize()
        with _recorded_masks(sp_masks), _Launches() as run:
            got = fwd(mesh)
            torch.cuda.synchronize()
    rel = _rel(got, want)
    want = want.cpu()
    same = len(plain_masks) == len(sp_masks) == layers and all(
        torch.equal(a, b) for a, b in zip(plain_masks, sp_masks))
    print(f"   {label}: rel L2 {rel:.3e} (bound {SP_REL_TOL}); {layers} "
          f"planner masks equal: {same}; launches {run.counts}")
    if not torch.isfinite(got).all() or rel > SP_REL_TOL:
        fail(f"{label}: the SP output is not finite or {rel} > "
             f"{SP_REL_TOL} from the plain forward")
    if not same:
        fail(f"{label}: the SP path's planner masks differ from the plain "
             f"forward's ({len(sp_masks)} vs {len(plain_masks)} calls)")
    if run.counts != expect:
        fail(f"{label}: launches {run.counts} != {expect}")
    del plain_masks, sp_masks, got
    secs = {"plain": [], "sp": []}
    with torch.inference_mode():
        for kind in ("plain", "sp", "sp", "plain"):
            t1 = time.perf_counter()
            fwd(mesh if kind == "sp" else None)
            torch.cuda.synchronize()
            secs[kind].append(time.perf_counter() - t1)
    print(f"   {label} step seconds, plain then SP (world 1, in turns): "
          f"{secs}")
    return {"rel_err": rel, "masks_equal": same, "launches": run.counts,
            "plain_s": secs["plain"], "sp_s": secs["sp"], "out": want}


def _sp_hy(mesh):
    """17a: phase 3's model and text (the same seeds), one carved Base
    step at 1280x720x33f through forward(mesh=)."""
    import torch
    from jenga_tpu_torch.configs.presets import get_hy_preset
    from jenga_tpu_torch.diffusion.flow_match import flow_match_schedule
    from jenga_tpu_torch.models.hyvideo import make_hy_carve
    sampler, gen = _hy_sampler()
    model, cfg = sampler.model, sampler.cfg
    txt, mask, txt2 = _text(gen, cfg, n_pad=40)
    opts = get_hy_preset("base", size=(1280, 720), video_length=33,
                         num_inference_steps=8)
    carve = make_hy_carve(cfg, (9, 45, 80), opts.sa_drop_rates[0],
                          opts.p_remain, curve=opts.curve,
                          txt_block_num=opts.txt_block_num,
                          q_rows=opts.q_group, joint_sel=opts.joint_sel,
                          device="cuda")
    x = torch.randn((1, 16, 9, 90, 160), generator=gen, device="cuda")
    t = torch.full((1,), flow_match_schedule(8, shift=opts.flow_shift)
                   .timestep(0), device="cuda")
    g = torch.full((1,), opts.embedded_guidance_scale * 1000.0,
                   device="cuda")
    layers = cfg.double_blocks + cfg.single_blocks

    def fwd(mesh):
        return model(x, t, txt[None], mask[None], txt2[None], carve=carve,
                     guidance=g, mesh=mesh)
    return _sp_step("17a HunyuanVideo T2V Base, joint q8", fwd, mesh,
                    layers, _counts(block_sparse_attn=layers))


def _wan_sp_setup(sp_degree: int = 1):
    """Phase 4's model and prompts (the same seeds) and the inputs of one
    carved CFG step (batch 2) of the 1.3b-base preset at 832x480x81f:
    (sampler, model arguments). With ``sp_degree`` the sampler is built
    from the same weights on its mesh, with FSDP."""
    import torch
    from jenga_tpu_torch.configs.presets import get_wan_preset
    from jenga_tpu_torch.models.wan import WAN_T2V_1_3B, WanDiT, init_wan_
    from jenga_tpu_torch.runtime import WanSampler
    cfg = WAN_T2V_1_3B
    # WanSampler(seed=0)'s init, then phase 4's perturbation
    model = init_wan_(WanDiT(cfg, device="cuda"),
                      torch.Generator(device="cuda").manual_seed(0))
    gen = torch.Generator(device="cuda").manual_seed(3)
    _perturb_wan(model, gen)
    sampler = WanSampler(cfg, model.state_dict(), device="cuda",
                         sp_degree=sp_degree)
    del model
    ctx = torch.randn((64, cfg.text_dim), generator=gen, device="cuda")
    null = torch.randn((64, cfg.text_dim), generator=gen, device="cuda")
    opts = get_wan_preset("1.3b-base", size=(832, 480), frame_num=81,
                          sampling_steps=6)
    pipe = sampler.pipeline
    carve = pipe._carve((16, 21, 60, 104), opts)
    ctx2 = pipe._context2(ctx, null)
    x = torch.randn((1, 16, 21, 60, 104), generator=gen, device="cuda")
    x2 = torch.cat([x, x])
    t2 = torch.full((2,), pipe._schedules(opts)[0].timestep(3),
                    device="cuda")
    return sampler, (x2, t2, ctx2, carve)


def _sp_wan(mesh):
    """17b: one carved Wan2.1-T2V-1.3B CFG step (``_wan_sp_setup``)."""
    sampler, args = _wan_sp_setup()
    layers = sampler.cfg.num_layers

    def fwd(mesh):
        return sampler.model(*args, mesh=mesh)
    return _sp_step("17b Wan2.1-T2V-1.3B Base carved CFG step, joint q8",
                    fwd, mesh, layers,
                    _counts(block_sparse_attn=layers, dense_attn=layers,
                            dense_attn_short=layers))


SP_GLOO_RANKS = 2
SP_GLOO_REL_TOL = 2e-2  # 17e: each rank's bf16 GEMMs see half the tokens


def sp_gloo_rank(rank: int, store: str, out_dir: str):
    """17e, one rank (``chip_smoke.py --sp-gloo-rank``): a gloo group of
    SP_GLOO_RANKS processes on the one card (NCCL refuses two ranks on one
    device; gloo's all_to_all_single and all_gather_into_tensor take CUDA
    tensors), 17b's step at sp=2 through WanSampler(sp_degree=2): its
    mesh, FSDP weights and Ulysses. Writes the output and the launches."""
    import torch
    import torch.distributed as dist
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.cuda.set_device(0)
    dist.init_process_group("gloo", init_method=f"file://{store}",
                            world_size=SP_GLOO_RANKS, rank=rank)
    try:
        sampler, args = _wan_sp_setup(SP_GLOO_RANKS)
        with torch.inference_mode(), _Launches() as run:
            t1 = time.perf_counter()
            out = sampler.model(*args, mesh=sampler.mesh)
            torch.cuda.synchronize()
            secs = time.perf_counter() - t1
        torch.save({"out": out.cpu(), "launches": run.counts,
                    "seconds": secs}, os.path.join(out_dir, f"{rank}.pt"))
    finally:
        dist.destroy_process_group()
    print("SP_RANK_OK", flush=True)


def _sp_gloo(want):
    """17e: two rank processes of ``sp_gloo_rank`` on the card; each
    rank's gathered output against 17b's single-device one."""
    import torch
    with tempfile.TemporaryDirectory() as d:
        procs = [subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), "--sp-gloo-rank",
             str(r), os.path.join(d, "store"), d], stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True)
            for r in range(SP_GLOO_RANKS)]
        logs = []
        try:
            for p in procs:
                logs.append(p.communicate(timeout=300)[0])
        except subprocess.TimeoutExpired:
            fail("17e: a rank process did not finish within 300 s")
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.communicate()
        for r, (p, log) in enumerate(zip(procs, logs)):
            if p.returncode != 0 or "SP_RANK_OK" not in log:
                fail(f"17e rank {r} failed (rc {p.returncode}): "
                     f"{log[-3000:]}")
        ranks = [torch.load(os.path.join(d, f"{r}.pt"))
                 for r in range(SP_GLOO_RANKS)]
    layers = 30
    rec = {"rel_err": [_rel(r["out"], want) for r in ranks],
           "seconds": [r["seconds"] for r in ranks],
           "launches": {k: sum(r["launches"][k] for r in ranks)
                        for k in ranks[0]["launches"]},
           "ranks_equal": all(torch.equal(r["out"], ranks[0]["out"])
                              for r in ranks)}
    print(f"   17e Wan2.1-T2V-1.3B at sp=2 on gloo (two ranks, one card): "
          f"{rec}")
    if not rec["ranks_equal"]:
        fail("17e: the ranks' gathered outputs differ")
    if max(rec["rel_err"]) > SP_GLOO_REL_TOL:
        fail(f"17e: rel L2 {rec['rel_err']} > {SP_GLOO_REL_TOL}")
    for r in ranks:
        if r["launches"] != _counts(block_sparse_attn=layers,
                                    dense_attn=layers,
                                    dense_attn_short=layers):
            fail(f"17e: rank launches {r['launches']}: expected K1 and D "
                 f"{layers} times each")
    return rec


def _sp_ring(mesh):
    """17c: ring_attention at world 1 on HunyuanVideo's joint shape (24
    heads, 32,400 image tokens, 256 text keys, 216 of them valid in
    sample 0 and none in sample 1) against one D launch over the
    concatenated keys; sample 1 against D over the image keys alone."""
    import torch
    from jenga_tpu_torch.ops.flash_attention import dense_attention_forward
    from jenga_tpu_torch.parallel.ring import ring_attention
    gen = torch.Generator(device="cuda").manual_seed(17)

    def randn(*shape):
        return torch.randn(shape, generator=gen, device="cuda",
                           dtype=torch.bfloat16)
    q, k, v = (randn(2, 32400, 24, 128) for _ in range(3))
    jk, jv = randn(2, 256, 24, 128), randn(2, 256, 24, 128)
    jlen = torch.tensor([216, 0], dtype=torch.int32, device="cuda")

    def ring():
        return ring_attention(q, k, v, mesh, joint_k=jk, joint_v=jv,
                              joint_kv_len=jlen)
    with torch.inference_mode():
        with _Launches() as run:
            out = ring()
            torch.cuda.synchronize()
        if run.counts != _counts(dense_attn=2, dense_attn_short=1):
            fail(f"17c ring launches {run.counts}: expected D twice (the "
                 f"image chunk, the joint chunk; the joint chunk's 256 "
                 f"keys on the short-key kernel)")

        def bhsd(*xs):
            return (x.transpose(1, 2) for x in xs)
        kf, vf = torch.cat([k, jk], dim=1), torch.cat([v, jv], dim=1)
        ref = dense_attention_forward(*bhsd(q, kf, vf),
                                      kv_len=32400 + jlen)[0]
        img = dense_attention_forward(*bhsd(q[1:], k[1:], v[1:]))[0]
        rec = _errors("17c ring vs D over the joint keys", out.transpose(1,
                                                                     2),
                      ref.float())
        rec_img = _errors("17c zero joint keys vs D over the image keys",
                          out[1:].transpose(1, 2), img.float())
        rec["ms"] = time_ms(ring, 5)
        rec["d_ms"] = time_ms(lambda: dense_attention_forward(
            *bhsd(q, kf, vf), kv_len=32400 + jlen), 5)
    rec["zero_joint"] = rec_img
    print(f"   17c ring x world 1: {rec}")
    for r in (rec, rec_img):
        if r["max_abs_err"] > KERNEL_TOL or r["rel_err"] > KERNEL_REL_TOL:
            fail(f"17c: {r} outside {KERNEL_TOL} max abs / "
                 f"{KERNEL_REL_TOL} relative")
    rec["launches"] = run.counts
    return rec


def phase_sp():
    """Phase 17: sequence parallelism on the card, in a 1-rank NCCL
    group (the card machine has one H100; NCCL refuses two ranks on one
    device)."""
    import torch.distributed as dist
    from jenga_tpu_torch.parallel.mesh import init_distributed, make_sp_mesh
    t0 = phase("17. sequence parallelism: a 1-rank NCCL group (Ulysses on "
               "HunyuanVideo and Wan, ring), then Wan at sp=2 on gloo")
    init_distributed("cuda", init_method=f"tcp://127.0.0.1:{_free_port()}",
                     world_size=1, rank=0)
    try:
        mesh = make_sp_mesh(device="cuda")
        out = {}
        for key, fn in (("17a_hy", _sp_hy), ("17b_wan", _sp_wan),
                        ("17c_ring", _sp_ring)):
            out[key] = fn(mesh)
            _free()     # each model goes before the next is built
    finally:
        dist.destroy_process_group()
    out["17e_wan_gloo_sp2"] = _sp_gloo(out["17b_wan"]["out"])
    for key in ("17a_hy", "17b_wan"):
        del out[key]["out"]
    out["17d"] = {k: {"plain_s": out[k]["plain_s"], "sp_s": out[k]["sp_s"]}
                  for k in ("17a_hy", "17b_wan")}
    out["gpu"] = gpu_line()
    print(f"   17d SP step vs plain step at world 1 (seconds): "
          f"{out['17d']}; gpu: {out['gpu']}")
    done(t0)
    return out


def main():
    import torch
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False: this smoke test needs a "
             "CUDA GPU")
    if not os.path.isdir(os.path.join(ROOT, "jenga_tpu_torch")):
        fail("run from the root of a checkout: jenga_tpu_torch/ not found "
             f"next to {os.path.basename(__file__)}")
    sys.path.insert(0, ROOT)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t_all = time.perf_counter()
    phase_toolchain()
    recs, main_rec, member, dense, extra = phase_kernel_cases()
    hy, hy_turbo, fp8_ref = phase_hy_main_path()
    wan, wan_turbo = phase_wan_main_path()
    hy_i2v = phase_hy_i2v_main_path()
    wan_i2v, wan_i2v_plan = phase_wan_i2v_main_path()
    rel = phase_end_to_end()
    probes = phase_probes()
    phase_cli_tiny()
    hy_fp8 = phase_hy_fp8(fp8_ref, hy["peak_gib"])
    wan_dpm, wan_dpm_turbo = phase_wan_dpm()
    fid = phase_fidelity()
    hy_vae, hy_i2v_vae, hy_prompt = phase_hy_vae(hy.pop("latents"))
    wan_vae, wan_i2v_vae, wan_prompt = phase_wan_vae(wan.pop("latents"),
                                                     wan_i2v_plan)
    ckpt = phase_checkpoints()
    train = phase_train_wan()
    train_hy = phase_train_hy_i2v()
    sp = phase_sp()
    loaded = sorted(m for m in sys.modules if m in ("jax", "jenga_tpu")
                    or m.startswith(("jax.", "jenga_tpu.")))
    if loaded:
        fail(f"modules of jax or jenga_tpu were imported: {loaded[:8]}")
    runs = {"hyvideo_t2v_base": hy["launches"],
            "hyvideo_t2v_turbo_rowsel": hy_turbo["launches"],
            "wan_t2v_1.3b_base": wan["launches"],
            "wan_t2v_1.3b_turbo": wan_turbo["launches"],
            "hyvideo_i2v_token_replace": hy_i2v["token_replace"]["launches"],
            "hyvideo_i2v_latent_concat": hy_i2v["latent_concat"]["launches"],
            "wan_i2v_14b": wan_i2v["launches"],
            "hyvideo_t2v_base_fp8": hy_fp8["launches"],
            "wan_t2v_1.3b_base_dpm": wan_dpm["launches"],
            "wan_t2v_1.3b_turbo_dpm": wan_dpm_turbo["launches"],
            "fidelity_wan_1.3b_q8_vs_dense": fid["launches"],
            "hyvideo_i2v_token_replace_vae": hy_i2v_vae["launches"],
            "wan_i2v_14b_vae": wan_i2v_vae["launches"],
            "hyvideo_i2v_prompt": hy_prompt["launches"],
            "wan_i2v_14b_prompt": wan_prompt["launches"],
            "train_wan_1.3b_dense": train["dense"]["launches"],
            "train_wan_1.3b_carved": train["carved"]["launches"],
            "train_hyvideo_i2v_carved": train_hy["carved"]["launches"],
            "train_hyvideo_i2v_dense": train_hy["dense"]["launches"],
            "sp_hyvideo_t2v_world1": sp["17a_hy"]["launches"],
            "sp_wan_t2v_1.3b_world1": sp["17b_wan"]["launches"],
            "sp_ring_hy_joint_world1": sp["17c_ring"]["launches"],
            "sp_wan_t2v_1.3b_gloo_sp2": sp["17e_wan_gloo_sp2"]["launches"]}

    def launches(name):
        return {path: counts[name] for path, counts in runs.items()}

    wan_self, wan_cross = dense[0], dense[1]
    image_cross = extra["e_wan14b_image_cross"]
    short = [r for r in dense if r["route"] == "short"]
    short_cases = {r["case"]: {k: r[k] for k in (
        "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")}
        for r in short}
    member_main = member[0]
    k2_main = next(r for r in recs if r["case"] == "q1_main_shape")
    kernels = {"kernels": [{
        "name": "block_sparse_attn",
        "route": "cuda",
        "source": "jenga_tpu_torch/csrc/block_sparse_attn.cu",
        "replaces": "jenga_tpu/ops/block_sparse_attention.py:409",
        "also_replaces": "jenga_tpu/ops/block_sparse_attention.py:49",
        "launches": sum(launches("block_sparse_attn").values()),
        "launches_by_path": launches("block_sparse_attn"),
        "max_abs_err": max(r["max_abs_err"] for r in recs + member
                           if r["mode"] == "all_member"),
        "rel_err": max(r["rel_err"] for r in recs + member
                       if r["mode"] == "all_member"),
        "ms": main_rec["ms"],
        "plain_ms": main_rec["plain_ms"],
        "bound_ms": main_rec["bound_ms"],
        "bound_by": main_rec["bound_by"],
        "library_ms": main_rec["library_ms"],
        "design": DESIGN,
        "k2_ms": k2_main["ms"],
        "k2_library_ms": k2_main["library_ms"],
        "wan14b_ms": extra["k1_wan14b"]["ms"],
        "wan14b_plain_ms": extra["k1_wan14b"]["plain_ms"],
        "wan14b_bound_ms": extra["k1_wan14b"]["bound_ms"],
        "wan14b_library_ms": extra["k1_wan14b"]["library_ms"],
        "e2e_rel_err": max(rel["hy_carved"], rel["wan_carved"],
                           rel["hy_turbo_stage0_joint"],
                           rel["hy_i2v_tr_carved"], rel["wan_i2v_carved"]),
    }, {
        "name": "block_sparse_attn_members",
        "route": "cuda",
        "source": "jenga_tpu_torch/csrc/block_sparse_attn.cu",
        "replaces": "jenga_tpu/ops/block_sparse_attention.py:409",
        "mode": "all_member=False",
        "design": DESIGN,
        "launches": sum(launches("block_sparse_attn_members").values()),
        "launches_by_path": launches("block_sparse_attn_members"),
        "max_abs_err": max(r["max_abs_err"] for r in member
                           if r["mode"] == "members"),
        "rel_err": max(r["rel_err"] for r in member
                       if r["mode"] == "members"),
        "ms": member_main["ms"],
        "plain_ms": member_main["plain_ms"],
        "bound_ms": member_main["bound_ms"],
        "bound_by": member_main["bound_by"],
        "library_ms": member_main["library_ms"],
        "k2_ms_same_mask": member_main["k2_ms_same_mask"],
        "e2e_rel_err": max(rel["hy_turbo_stage0_rowsel"],
                           rel["wan_stage0_rowsel"]),
    }, {
        "name": "dense_attn",
        "route": "cuda",
        "source": "jenga_tpu_torch/csrc/dense_attn.cu",
        "replaces": "jenga_tpu/ops/flash_attention.py:73",
        "launches": sum(launches("dense_attn").values()),
        "launches_by_path": launches("dense_attn"),
        "max_abs_err": max(r["max_abs_err"] for r in dense),
        "rel_err": max(r["rel_err"] for r in dense),
        "ms": wan_self["ms"],
        "plain_ms": wan_self["plain_ms"],
        "bound_ms": wan_self["bound_ms"],
        "bound_by": wan_self["bound_by"],
        "library_ms": wan_self["library_ms"],
        "design": DESIGN,
        "cross_ms": wan_cross["ms"],
        "cross_plain_ms": wan_cross["plain_ms"],
        "cross_bound_ms": wan_cross["bound_ms"],
        "cross_library_ms": wan_cross["library_ms"],
        "image_cross_ms": extra["e_wan14b_image_cross"]["ms"],
        "image_cross_plain_ms": extra["e_wan14b_image_cross"]["plain_ms"],
        "image_cross_bound_ms": extra["e_wan14b_image_cross"]["bound_ms"],
        "image_cross_bound_by": extra["e_wan14b_image_cross"]["bound_by"],
        "image_cross_library_ms":
            extra["e_wan14b_image_cross"]["library_ms"],
        "cross14b_ms": extra["f_wan14b_text_cross"]["ms"],
        "cross14b_plain_ms": extra["f_wan14b_text_cross"]["plain_ms"],
        "cross14b_bound_ms": extra["f_wan14b_text_cross"]["bound_ms"],
        "cross14b_library_ms": extra["f_wan14b_text_cross"]["library_ms"],
        "e2e_rel_err": max(rel["hy_dense"], rel["wan_dense"],
                           rel["hy_i2v_tr_dense"], rel["wan_i2v_dense"]),
        "routes": {r["case"]: r["route"] for r in dense},
        "short_design": SHORT_DESIGN,
        "short_source": "jenga_tpu_torch/csrc/dense_attn_short.cu",
        "short_launches_by_path": launches("dense_attn_short"),
        "short_cases": short_cases,
    }, {
        "name": "dense_attn_short",
        "route": "cuda",
        "source": "jenga_tpu_torch/csrc/dense_attn_short.cu",
        "replaces": "jenga_tpu/ops/flash_attention.py:73",
        "of": "dense_attn (D) for Skv <= 512",
        "launches": sum(launches("dense_attn_short").values()),
        "launches_by_path": launches("dense_attn_short"),
        "max_abs_err": max(r["max_abs_err"] for r in short),
        "rel_err": max(r["rel_err"] for r in short),
        "ms": image_cross["ms"],
        "ms_of": f"Wan-14B image cross-attention {image_cross['q']} x "
                 f"{image_cross['kv'][2]} keys",
        "plain_ms": image_cross["plain_ms"],
        "bound_ms": image_cross["bound_ms"],
        "bound_by": image_cross["bound_by"],
        "library_ms": image_cross["library_ms"],
        "design": SHORT_DESIGN,
        "cases": short_cases,
    }] + _bwd_entries(extra["bwd"], runs) + _probe_entries(probes, runs)}
    vae = {name: {k: v for k, v in rec.items()
                  if k not in ("launches", "step_s", "schedule")}
           for name, rec in (("11_hy_decode", hy_vae),
                             ("11b_hy_i2v_encode_run_decode", hy_i2v_vae),
                             ("12_wan_decode", wan_vae),
                             ("12b_wan_i2v_encode_run_decode", wan_i2v_vae))}
    print("vae: " + json.dumps(vae))
    print("prompt: " + json.dumps({
        "13_hy_prompt": {k: v for k, v in hy_prompt.items()
                         if k not in ("launches", "step_s")},
        "14_wan_prompt": {k: v for k, v in wan_prompt.items()
                          if k not in ("launches", "step_s", "schedule")},
        "15_checkpoints": ckpt}))
    print("train: " + json.dumps({"16_wan_1.3b": train,
                                  "16b_hyvideo_i2v": train_hy}))
    print("sp: " + json.dumps(sp))
    print(f"total seconds: {time.perf_counter() - t_all:.3f}")
    print(f"gpu: {gpu_line()}")
    print(json.dumps(kernels))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    if sys.argv[1:2] == ["--sp-gloo-rank"]:
        sys.path.insert(0, ROOT)
        sp_gloo_rank(int(sys.argv[2]), sys.argv[3], sys.argv[4])
    else:
        main()

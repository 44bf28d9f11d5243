#!/usr/bin/env python3
"""Smoke test of the PyTorch port on one CUDA GPU.

Run from the root of a checkout:  python3 chip_smoke.py

Phases (each prints its seconds; any failure exits non-zero before the
result line):
  1. toolchain: torch/CUDA versions, nvcc, the card's name and power
     limit; builds all five kernel sources from jenga_tpu_torch/csrc/ (one
     nvcc per source, started together; sm_90a) and prints ptxas' resource
     use;
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
     18,018). Dense: Wan self-attention, Wan cross-attention over 512
     keys, HunyuanVideo's joint dense shape with kv_len, and a ragged
     small case with an empty sample (which must be all zeros);
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
     dense launches = 30 x dense steps + 30 x computed steps;
  4b. main path, the same model with the 1.3b-turbo preset (joint q8) at
     832x480x81f: the smallest step count from 6 and switch step whose
     host schedule holds a dense step, a carved step in each stage and,
     if 12 steps allow it, a skip; stage 0 at latent 16x21x44x78. Latents
     (16, 21, 60, 104) and launch counts as in phase 4;
  5. end to end, kernels vs plain attention (both dispatch points
     patched): HunyuanVideo at full width cut to 1 double + 1 single
     block, carved and dense (carve=None, the dense arm), and at the
     Turbo stage-0 grid with text_amp 0.431 in joint and per-row
     (membership) selection; Wan 1.3B at full width cut to 2 layers at
     832x480x81f, carved and dense fallback, and at the Turbo stage-0
     grid in per-row selection. Each relative error within the stated
     bound;
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
     relative (L2) error.
No module of jax or jenga_tpu may be loaded. The last two lines are the
kernels' JSON record and {"ok": true, "device": {...}}.
"""

import concurrent.futures
import contextlib
import dataclasses
import json
import math
import os
import subprocess
import sys
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
# P1, P2, P4: besides KERNEL_TOL, a bound on ||out - plain|| / ||plain||
# over the checked rows. At 115k tokens a row attends ~35k keys and |o| is
# ~1e-2, so an absolute 1e-2 alone would pass a wrong block; the bf16
# rounding of P and of the output is ~2^-9 relative (~0.3% in all), while
# one block dropped or added per row, or text_amp applied where it is not,
# moves a row by several percent.
PROBE_REL_TOL = 2e-2
PEAK_FLOPS = 989e12     # H100 SXM bf16 dense tensor-core peak
PEAK_F32 = 67e12        # H100 SXM f32 outside the tensor cores
PEAK_BYTES = 3.35e12    # H100 SXM HBM3
TILE_FLOP = 4 * 128 ** 3    # QK^T and PV of one 128x128 tile, d = 128
WAN_GRID = (21, 30, 52)     # 832x480x81f: 32,760 tokens, 256 blocks
WAN_GRID0 = (21, 22, 39)    # its Turbo stage 0: 18,018 tokens, 141 blocks
HY_GRID0 = (9, 33, 60)      # HY 1280x720x33f Turbo stage 0: 17,820 tokens
# the Turbo stage-0 text amplitude, -log2(sqrt(token ratio to full res))
HY_AMP0 = -math.log2(math.sqrt(33 * 60 / (45 * 80)))


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
    mods = (bsa, fa, ap, bp, xr)
    with concurrent.futures.ThreadPoolExecutor(len(mods)) as pool:
        libs = list(pool.map(lambda m: m.build_kernel(), mods))
    print(f"built all {len(mods)} kernel sources in "
          f"{time.perf_counter() - tb:.3f} s")
    for mod, lib in zip(mods, libs):
        print(f"   {os.path.relpath(mod.KERNEL_SOURCE, ROOT)} -> "
              f"{os.path.relpath(lib._name, ROOT)}")
        log = os.path.join(os.path.dirname(lib._name), "ptxas.log")
        for line in open(log).read().splitlines():
            if "registers" in line or "spill" in line or "smem" in line:
                print(f"   ptxas: {line.strip()}")
    done(t0)


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
    err = (out.float() - ref).abs().max().item()
    if not torch.isfinite(out).all():
        fail(f"{name}: non-finite kernel output")
    # density: the share of key blocks each query block attends
    rows = lists_to_mask(idx, cnt, q_rows, q.shape[2] // 128, members)
    rec = {"kernel": "block_sparse_attn", "case": name,
           "mode": "members" if members is not None else "all_member",
           "shape": list(q.shape), "q_rows": q_rows, "text_amp": amp,
           "fixed_max": fixed_max,
           "density": round(rows.float().mean().item(), 4),
           "list_density": round(cnt.float().mean().item() / idx.shape[-1],
                                 4),
           "max_abs_err": err}
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
    if not err <= KERNEL_TOL:
        fail(f"{name}: max abs error {err} > {KERNEL_TOL}")
    return rec, out


def _dense_case(name, q, k, v, kv_len=None):
    import torch
    from jenga_tpu_torch.ops.flash_attention import (dense_attention,
                                                     dense_attention_plain)
    from jenga_tpu_torch.tools.library_baseline import sdpa_flash
    out = dense_attention(q, k, v, kv_len=kv_len)
    torch.cuda.synchronize()
    ref = dense_attention_plain(q.float(), k.float(), v.float(),
                                kv_len=kv_len)
    err = (out.float() - ref).abs().max().item()
    if not torch.isfinite(out).all():
        fail(f"{name}: non-finite kernel output")
    b, h, sq, d = q.shape
    skv = k.shape[2]
    keys = b * skv if kv_len is None else sum(
        min(max(int(x), 0), skv) for x in kv_len.tolist())
    rec = {"kernel": "dense_attn", "case": name, "q": list(q.shape),
           "kv": list(k.shape),
           "kv_len": None if kv_len is None else kv_len.tolist(),
           "max_abs_err": err}
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
    if not err <= KERNEL_TOL:
        fail(f"{name}: max abs error {err} > {KERNEL_TOL}")
    return rec, out


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
    dense = []
    q, k, v = _qkv(gen, 2, 12, 32768)
    rec, _ = _dense_case("a_wan_self", q, k, v)
    dense.append(rec)
    del k, v
    _, k, v = _qkv(gen, 2, 12, 512)
    rec, _ = _dense_case("b_wan_cross", q, k, v)
    dense.append(rec)
    del q, k, v
    s = 32656
    q, k, v = _qkv(gen, 1, 24, s)
    kl = torch.tensor([s - 40], dtype=torch.int32, device="cuda")
    rec, _ = _dense_case("c_hy_joint_dense", q, k, v, kl)
    dense.append(rec)
    del q, k, v
    q, k, v = _qkv(gen, 2, 12, 1000, skv=300)
    kl = torch.tensor([0, 137], dtype=torch.int32, device="cuda")
    rec, out = _dense_case("d_ragged_small", q, k, v, kl)
    dense.append(rec)
    if out[0].any():
        fail("d_ragged_small: the kv_len=0 sample is not all zeros")
    del q, k, v, out
    torch.cuda.empty_cache()
    done(t0)
    return recs, main, member, dense


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
NO_PROBES = dict.fromkeys(PROBES, 0)


class _Launches:
    """The kernels' launch counts over one path's run: set to 0 on entry,
    read on exit. The block-sparse wrapper counts its all-member launches
    (K1/K2) and its membership-mode launches (K1m) apart, the probe
    wrapper its P1 and P2 launches."""

    def __enter__(self):
        from jenga_tpu_torch.ops.attention_probe import attention_probe
        from jenga_tpu_torch.ops.block_pool import block_pool
        from jenga_tpu_torch.ops.block_sparse_attention import (
            block_sparse_attention)
        from jenga_tpu_torch.ops.cross_attention_resident import (
            cross_attention_resident)
        from jenga_tpu_torch.ops.flash_attention import dense_attention
        self.counters = {
            "block_sparse_attn": (block_sparse_attention, "launches"),
            "block_sparse_attn_members": (block_sparse_attention,
                                          "member_launches"),
            "dense_attn": (dense_attention, "launches"),
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
    del lat
    done(t0)
    base = {"launches": run.counts, "step_s": timer.step_s,
            "peak_gib": peak}
    turbo = phase_hy_turbo(sampler, txt, mask, txt2)
    del sampler
    torch.cuda.empty_cache()
    return base, turbo


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
              "dense_attn": 0, **NO_PROBES}
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
    expect = {"block_sparse_attn": cfg.num_layers * n_carved,
              "block_sparse_attn_members": 0,
              "dense_attn": cfg.num_layers * (2 * n_dense + n_carved),
              **NO_PROBES}
    if run.counts != expect:
        fail(f"kernel launches {run.counts} != {expect} ({n_dense} dense, "
             f"{n_carved} carved steps x {cfg.num_layers} layers)")
    return {"launches": run.counts, "step_s": timer.step_s,
            "peak_gib": peak, "schedule": kinds, "density": density}


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
                                                HYVideoDiT, init_hyvideo_,
                                                make_hy_carve)
    from jenga_tpu_torch.models.wan import (WAN_T2V_1_3B, WanDiT, init_wan_,
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
        if not (r["max_abs_err"] <= KERNEL_TOL
                and r["rel_err"] <= PROBE_REL_TOL):
            fail(f"{name}: max abs error {r['max_abs_err']} (bound "
                 f"{KERNEL_TOL}), relative error {r['rel_err']} (bound "
                 f"{PROBE_REL_TOL})")
    done(t0)
    return {"counts": run.counts, "p1": r1, "p2": r2, "p3": r3, "p4": r4}


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
    }]


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
    recs, main_rec, member, dense = phase_kernel_cases()
    hy, hy_turbo = phase_hy_main_path()
    wan, wan_turbo = phase_wan_main_path()
    rel = phase_end_to_end()
    probes = phase_probes()
    loaded = sorted(m for m in sys.modules if m in ("jax", "jenga_tpu")
                    or m.startswith(("jax.", "jenga_tpu.")))
    if loaded:
        fail(f"modules of jax or jenga_tpu were imported: {loaded[:8]}")
    runs = {"hyvideo_t2v_base": hy["launches"],
            "hyvideo_t2v_turbo_rowsel": hy_turbo["launches"],
            "wan_t2v_1.3b_base": wan["launches"],
            "wan_t2v_1.3b_turbo": wan_turbo["launches"]}

    def launches(name):
        return {path: counts[name] for path, counts in runs.items()}

    wan_self = dense[0]
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
        "ms": main_rec["ms"],
        "plain_ms": main_rec["plain_ms"],
        "bound_ms": main_rec["bound_ms"],
        "bound_by": main_rec["bound_by"],
        "library_ms": main_rec["library_ms"],
        "k2_ms": k2_main["ms"],
        "k2_library_ms": k2_main["library_ms"],
        "e2e_rel_err": max(rel["hy_carved"], rel["wan_carved"],
                           rel["hy_turbo_stage0_joint"]),
    }, {
        "name": "block_sparse_attn_members",
        "route": "cuda",
        "source": "jenga_tpu_torch/csrc/block_sparse_attn.cu",
        "replaces": "jenga_tpu/ops/block_sparse_attention.py:409",
        "mode": "all_member=False",
        "launches": sum(launches("block_sparse_attn_members").values()),
        "launches_by_path": launches("block_sparse_attn_members"),
        "max_abs_err": max(r["max_abs_err"] for r in member
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
        "ms": wan_self["ms"],
        "plain_ms": wan_self["plain_ms"],
        "bound_ms": wan_self["bound_ms"],
        "bound_by": wan_self["bound_by"],
        "library_ms": wan_self["library_ms"],
        "e2e_rel_err": max(rel["hy_dense"], rel["wan_dense"]),
    }] + _probe_entries(probes, runs)}
    print(f"total seconds: {time.perf_counter() - t_all:.3f}")
    print(f"gpu: {gpu_line()}")
    print(json.dumps(kernels))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()

#!/usr/bin/env python3
"""Smoke test of the PyTorch port on one CUDA GPU.

Run from the root of a checkout:  python3 chip_smoke.py

Phases (each prints its seconds; any failure exits non-zero before the
result line):
  1. toolchain: torch/CUDA versions, nvcc, the card's name and power
     limit; builds both kernels from jenga_tpu_torch/csrc/ (one nvcc per
     source, started together; sm_90a) and prints ptxas' resource use;
  2. kernels vs their plain torch versions on the card, max abs error
     <= 1e-2 in each case, each case timed against the plain version.
     Block-sparse: random per-row lists (q_rows=1) with an empty row,
     joint q8 planner lists with a video/text boundary group, text_amp
     != 0, a seqlen that cuts into the last text block, both softmax
     epilogues, HunyuanVideo's main shape (joint q8 and per-row), and
     Wan's (joint q8 with first-frame forcing, no text blocks, the pad
     tail cut by seqlen). Dense: Wan self-attention, Wan cross-attention
     over 512 keys, HunyuanVideo's joint dense shape with kv_len, and a
     ragged small case with an empty sample (which must be all zeros);
  3. main path, HunyuanVideo T2V at full width and depth (3072 hidden, 24
     heads, 20 double + 40 single blocks, bf16, seeded random init on the
     card, head perturbed) through HunyuanVideoSampler.predict with the
     Jenga-Base preset at 1280x720x33f for 8 steps; latents finite and
     non-zero, the block-sparse kernel launched exactly 7 x 60 times;
  4. main path, Wan2.1 T2V 1.3B at full width and depth (1536 dim, 12
     heads, 30 layers, bf16, seeded random init, head perturbed) through
     WanSampler.generate with the 1.3b-base preset at 832x480x81f; the
     step count is the smallest from 6 whose host schedule holds a dense
     warm-up, a carved and a TeaCache-skipped step. Latents (16, 21, 60,
     104) finite and non-zero; block-sparse launches = 30 x carved steps,
     dense launches = 30 x dense steps + 30 x computed steps;
  5. end to end, kernels vs plain attention (both dispatch points
     patched): HunyuanVideo at full width cut to 1 double + 1 single
     block, carved and dense (carve=None, the dense arm); Wan 1.3B at
     full width cut to 2 layers at 832x480x81f, carved and dense
     fallback. Each relative error within the stated bound.
The last two lines are the kernels' JSON record and
{"ok": true, "device": {...}}.
"""

import concurrent.futures
import dataclasses
import json
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
WAN_GRID = (21, 30, 52)     # 832x480x81f: 32,760 tokens, 256 blocks


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


def time_ms(fn, reps: int) -> float:
    import torch
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def phase_toolchain():
    import torch
    from jenga_tpu_torch.ops import block_sparse_attention as bsa
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
    mods = (bsa, fa)
    with concurrent.futures.ThreadPoolExecutor(len(mods)) as pool:
        libs = list(pool.map(lambda m: m.build_kernel(), mods))
    print(f"built both kernels in {time.perf_counter() - tb:.3f} s")
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


def _case(name, q, k, v, idx, cnt, seqlens, q_rows, tsb, amp, fixed_max):
    import torch
    from jenga_tpu_torch.ops.block_sparse_attention import (
        block_sparse_attention, block_sparse_attention_plain)
    kw = dict(q_rows=q_rows, text_amp=amp, text_start_block=tsb,
              fixed_max=fixed_max)
    out = block_sparse_attention(q, k, v, idx, cnt, seqlens, **kw)
    torch.cuda.synchronize()
    ref = block_sparse_attention_plain(q.float(), k.float(), v.float(), idx,
                                       cnt, seqlens, **kw)
    err = (out.float() - ref).abs().max().item()
    if not torch.isfinite(out).all():
        fail(f"{name}: non-finite kernel output")
    rec = {"kernel": "block_sparse_attn", "case": name,
           "shape": list(q.shape), "q_rows": q_rows, "text_amp": amp,
           "fixed_max": fixed_max,
           "density": round(cnt.float().mean().item() / idx.shape[-1], 4),
           "max_abs_err": err}
    rec["ms"] = time_ms(lambda: block_sparse_attention(
        q, k, v, idx, cnt, seqlens, **kw), 10)
    rec["plain_ms"] = time_ms(lambda: block_sparse_attention_plain(
        q, k, v, idx, cnt, seqlens, **kw), 2)
    print(f"   {json.dumps(rec)}", flush=True)
    if not err <= KERNEL_TOL:
        fail(f"{name}: max abs error {err} > {KERNEL_TOL}")
    return rec


def _dense_case(name, q, k, v, kv_len=None):
    import torch
    from jenga_tpu_torch.ops.flash_attention import (dense_attention,
                                                     dense_attention_plain)
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
    print(f"   {json.dumps(rec)}", flush=True)
    if not err <= KERNEL_TOL:
        fail(f"{name}: max abs error {err} > {KERNEL_TOL}")
    return rec, out


def _planner_lists(q, k, nkb, tsb, q_rows=8, **kw):
    import torch
    from jenga_tpu_torch.ops.sparse_dispatch import block_lists_from_mask
    from jenga_tpu_torch.sparse.planner import build_block_mask
    m = build_block_mask(q[:, :, :tsb * 128], k, top_k=int(0.25 * tsb),
                         text_start_block=tsb, text_blocks=nkb - tsb,
                         sel_group=q_rows, **kw)
    full = torch.ones((*m.shape[:2], nkb - tsb, nkb), dtype=torch.bool,
                      device="cuda")
    return block_lists_from_mask(torch.cat([m, full], 2), q_rows,
                                 q_rows > 1)


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
    idx, cnt = block_lists_from_mask(mask, 1, False)
    sl = torch.tensor([s - 40], dtype=torch.int32, device="cuda")
    for fm in (True, False):
        recs.append(_case("q1_random_lists", q, k, v, idx, cnt, sl, 1, tsb,
                          -0.5, fm))

    # joint q8 planner lists: group 7 mixes video blocks 56-61 with the
    # text blocks 62-63 (a boundary group); text_amp > 0; seqlen cut
    s, nkb, tsb = 8192, 64, 62
    q, k, v = _qkv(gen, 1, 24, s)
    idx, cnt = _planner_lists(q, k, nkb, tsb, p_remain=0.3,
                              block_neighbors=None)
    sl = torch.tensor([s - 100], dtype=torch.int32, device="cuda")
    for fm in (True, False):
        recs.append(_case("q8_joint_boundary", q, k, v, idx, cnt, sl, 8,
                          tsb, 0.7, fm))

    # HunyuanVideo's main shape: 32400 video + 256 text tokens, 256 blocks
    s, nkb, tsb = 32768, 256, 254
    q, k, v = _qkv(gen, 1, 24, s)
    idx, cnt = _planner_lists(q, k, nkb, tsb, p_remain=0.3,
                              block_neighbors=None)
    sl = torch.tensor([32400 + 256], dtype=torch.int32, device="cuda")
    main = _case("q8_joint_main_shape", q, k, v, idx, cnt, sl, 8, tsb, 0.0,
                 True)
    recs.append(main)
    recs.append(_case("q8_joint_main_shape", q, k, v, idx, cnt, sl, 8, tsb,
                      0.0, False))
    idx, cnt = _planner_lists(q, k, nkb, tsb, q_rows=1, p_remain=0.3,
                              block_neighbors=None)
    recs.append(_case("q1_main_shape", q, k, v, idx, cnt, sl, 1, tsb, 0.0,
                      True))

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
                      nkb, 0.0, True))
    del q, k, v

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
    return recs, main, dense


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


class _Launches:
    """Both kernels' launch counts over one main-path run: set to 0 on
    entry, read on exit."""

    def __enter__(self):
        from jenga_tpu_torch.ops.block_sparse_attention import (
            block_sparse_attention)
        from jenga_tpu_torch.ops.flash_attention import dense_attention
        self.fns = {"block_sparse_attn": block_sparse_attention,
                    "dense_attn": dense_attention}
        for fn in self.fns.values():
            fn.launches = 0
        return self

    def __exit__(self, *exc):
        self.counts = {name: fn.launches for name, fn in self.fns.items()}


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


def phase_hy_main_path():
    import torch
    from jenga_tpu_torch.configs.presets import get_hy_preset
    from jenga_tpu_torch.models.hyvideo import HUNYUAN_VIDEO_T2V
    from jenga_tpu_torch.runtime import HunyuanVideoSampler
    t0 = phase("3. main path: HunyuanVideo T2V Jenga-Base, full width+depth")
    cfg = HUNYUAN_VIDEO_T2V
    ti = time.perf_counter()
    sampler = HunyuanVideoSampler(cfg, device="cuda", seed=0)
    gen = torch.Generator(device="cuda").manual_seed(1)
    _perturb(sampler.model, gen)
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in sampler.model.parameters())
    print(f"   model: {n_params} params, "
          f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB, init "
          f"{time.perf_counter() - ti:.3f} s")
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
    expect_shape = (16, 9, 90, 160)
    if tuple(lat.shape) != expect_shape:
        fail(f"latents shape {tuple(lat.shape)} != {expect_shape}")
    if not torch.isfinite(lat).all() or lat.abs().max().item() == 0.0:
        fail("latents are not finite and non-zero")
    expect = 7 * (cfg.double_blocks + cfg.single_blocks)
    if run.counts["block_sparse_attn"] != expect:
        fail(f"block-sparse launches {run.counts['block_sparse_attn']} != "
             f"{expect} (7 computed steps x 60 blocks)")
    print(f"   latents {tuple(lat.shape)} mean|x| "
          f"{lat.abs().mean().item():.6f}")
    del sampler, lat
    torch.cuda.empty_cache()
    done(t0)
    return {"launches": run.counts, "step_s": timer.step_s,
            "peak_gib": peak}


def phase_wan_main_path():
    import torch
    from jenga_tpu_torch.configs.presets import get_wan_preset
    from jenga_tpu_torch.models.wan import WAN_T2V_1_3B
    from jenga_tpu_torch.ops import sparse_dispatch
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

    densities = []
    real_bsa = sparse_dispatch.block_sparse_attention

    def recording_bsa(q, k, v, indices, counts, *a, **kw):
        densities.append(counts.float().mean() / indices.shape[-1])
        return real_bsa(q, k, v, indices, counts, *a, **kw)

    torch.cuda.reset_peak_memory_stats()
    timer = _StepTimer()
    with mock.patch.object(sparse_dispatch, "block_sparse_attention",
                           recording_bsa), _Launches() as run:
        lat = sampler.generate(ctx, null, opts, on_step=timer)
        torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() / 2**30
    density = torch.stack(densities).mean().item() if densities else None
    print(f"   per-step seconds: {[round(x, 4) for x in timer.step_s]}")
    print(f"   peak memory: {peak:.2f} GiB; kernel launches: {run.counts}; "
          f"block-sparse list density (mean over launches): {density}")
    expect_shape = (16, 21, 60, 104)
    if tuple(lat.shape) != expect_shape:
        fail(f"latents shape {tuple(lat.shape)} != {expect_shape}")
    if not torch.isfinite(lat).all() or lat.abs().max().item() == 0.0:
        fail("latents are not finite and non-zero")
    n_dense, n_carved = kinds.count("dense"), kinds.count("carved")
    expect = {"block_sparse_attn": cfg.num_layers * n_carved,
              "dense_attn": cfg.num_layers * (2 * n_dense + n_carved)}
    if run.counts != expect:
        fail(f"kernel launches {run.counts} != {expect} ({n_dense} dense, "
             f"{n_carved} carved steps x {cfg.num_layers} layers)")
    print(f"   latents {tuple(lat.shape)} mean|x| "
          f"{lat.abs().mean().item():.6f}")
    del sampler, lat
    torch.cuda.empty_cache()
    done(t0)
    return {"launches": run.counts, "step_s": timer.step_s,
            "peak_gib": peak, "schedule": kinds, "density": density}


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
    del model
    torch.cuda.empty_cache()
    for name, r in rel.items():
        print(f"   {name}: velocity relative error {r:.6f} "
              f"(bound {E2E_REL_TOL})")
        if not r <= E2E_REL_TOL:
            fail(f"{name}: end-to-end relative error {r} > {E2E_REL_TOL}")
    done(t0)
    return rel


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
    recs, main_rec, dense = phase_kernel_cases()
    hy = phase_hy_main_path()
    wan = phase_wan_main_path()
    rel = phase_end_to_end()
    if "jax" in sys.modules:
        fail("jax was imported")
    runs = {"hyvideo_t2v_base": hy["launches"],
            "wan_t2v_1.3b_base": wan["launches"]}

    def launches(name):
        return {path: counts[name] for path, counts in runs.items()}

    wan_self = dense[0]
    kernels = {"kernels": [{
        "name": "block_sparse_attn",
        "route": "cuda",
        "source": "jenga_tpu_torch/csrc/block_sparse_attn.cu",
        "replaces": "jenga_tpu/ops/block_sparse_attention.py:409",
        "also_replaces": "jenga_tpu/ops/block_sparse_attention.py:49",
        "launches": sum(launches("block_sparse_attn").values()),
        "launches_by_path": launches("block_sparse_attn"),
        "max_abs_err": max(r["max_abs_err"] for r in recs),
        "ms": main_rec["ms"],
        "plain_ms": main_rec["plain_ms"],
        "e2e_rel_err": max(rel["hy_carved"], rel["wan_carved"]),
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
        "e2e_rel_err": max(rel["hy_dense"], rel["wan_dense"]),
    }]}
    print(f"total seconds: {time.perf_counter() - t_all:.3f}")
    print(f"gpu: {gpu_line()}")
    print(json.dumps(kernels))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()

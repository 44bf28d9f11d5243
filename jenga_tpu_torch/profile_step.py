"""Time and profile one trunk step of the port's DiTs on a CUDA GPU.

    python -m jenga_tpu_torch.profile_step --video-length 33 125 \\
        --out profile_step.jsonl
    python -m jenga_tpu_torch.profile_step --model wan --out wan.jsonl
    python -m jenga_tpu_torch.profile_step --model hyvideo-i2v
    python -m jenga_tpu_torch.profile_step --model wan-i2v
    python -m jenga_tpu_torch.profile_step --use-fp8
    python -m jenga_tpu_torch.profile_step --model hy-vae
    python -m jenga_tpu_torch.profile_step --model wan-vae

``--model hyvideo`` (default) builds the full HunyuanVideo T2V DiT and,
for each video length at --video-size (default 1280x720), profiles one
carved trunk step: the Jenga-Base stage-0 carve (joint q8, drop 0.75),
random latents and 256 text tokens. ``--model wan`` builds the full
Wan2.1 T2V 1.3B DiT and, for each video length at --video-size (default
832x480, 81 frames), profiles one carved trunk step (the 1.3b-base carve,
joint q8, drop 0.75) and one dense warm-up trunk step (the carve's dense
fallback), on the CFG batch of 2 with a random 512-token context.
``--model hyvideo-i2v`` profiles the HunyuanVideo-I2V token_replace DiT
(first-frame tokens on the t=0 modulation) at 1280x720x33f, a carved and
a dense step (the carve's dense fallback). ``--model wan-i2v`` profiles
Wan2.1-I2V-14B at the 81-frame 832x480 latent 21x60x104 (the 480p-class
area), a carved and a dense warm-up step with random CLIP tokens (257)
and conditioning ``y``. Weights are a seeded random init on the card;
``--use-fp8`` (``--model hyvideo`` only) quantizes the large linear
weights to e4m3 as ``hyvideo-t2v --use-fp8`` does, so the dequant of each
weight before its product lands in "other".
``--model hy-vae`` profiles one decode of the HunyuanVideo VAE
(``HYVAE_884_16C``, seeded init, f32 with cuDNN's default TF32 convs) at
1280x720x125f (latent 16x32x90x160: 3 temporal x 28 spatial tiles);
``--model wan-vae`` one streamed decode of the Wan VAE at 832x480x81f and
at 1280x720x81f and one I2V image encode at 1280x720x81f (the first frame
and 80 zero frames). Each goes through a sampler's ``decode_latents`` /
``encode_image_latent`` (the DiT is the tiny bf16 one: only the VAE
runs): one warm-up at a short clip, one run timed with CUDA events (and
its peak memory), one with CUDA-event marks around each class's calls
for the device time by class (conv, norm, attention, copies, other) and
the convs' FLOPs (2 x multiply-adds from their shapes), and one under
torch.profiler for the device's idle share.
For each step:

  * the trunk's time (CUDA events; one warm-up run, then --reps runs),
  * one trunk run under torch.profiler, device time summed by kernel
    class: the block-sparse attention kernel, the dense attention kernel,
    matrix products (GEMM), and everything else (planner, norms, RoPE,
    modulation, copies), with the device's idle share of the profiled
    run's wall time,
  * the launches of the block-sparse kernel and of D, and among D's those
    of its short-key kernel (Wan's cross-attention: 30 a 1.3B trunk call,
    80 a 14B I2V one),
  * the peak device memory.

Prints one JSON line per step (and writes them to --out).
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import functools
import json
import subprocess
import time
from unittest import mock

import torch

from .configs.presets import (get_hy_i2v_options, get_hy_preset,
                              get_wan_i2v_options, get_wan_preset)
from .models.hyvideo import HUNYUAN_VIDEO_T2V, hy_i2v_config, make_hy_carve
from .models.wan import CLIP_DIM, WAN_T2V_1_3B, make_wan_carve
from .ops.block_sparse_attention import block_sparse_attention
from .ops.flash_attention import dense_attention
from .runtime import HunyuanVideoSampler, WanSampler

_GEMM_TAGS = ("gemm", "xmma", "cutlass", "nvjet", "cublas")
_CLASSES = ("block_sparse_kernel", "dense_kernel", "gemm", "other")


def _kernel_class(name: str) -> str:
    low = name.lower()
    if "bsa_kernel" in low:
        return "block_sparse_kernel"
    if "dense_kernel" in low:
        return "dense_kernel"
    if any(tag in low for tag in _GEMM_TAGS):
        return "gemm"
    return "other"


def _device_breakdown(prof) -> dict:
    """Device (kernel) time in ms by class, from the profiler's events."""
    out = dict.fromkeys(_CLASSES, 0.0)
    for evt in prof.events():
        if evt.device_type != torch.autograd.DeviceType.CUDA:
            continue
        out[_kernel_class(evt.name)] += evt.device_time_total / 1e3
    return out


def _profile(trunk, dev, reps: int) -> dict:
    """Time ``trunk()`` with CUDA events, then profile one run of it."""
    torch.cuda.reset_peak_memory_stats(dev)
    trunk()
    torch.cuda.synchronize(dev)
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        trunk()
    end.record()
    end.synchronize()
    trunk_ms = start.elapsed_time(end) / reps
    launches0 = (block_sparse_attention.launches, dense_attention.launches,
                 dense_attention.short_launches)
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU,
                        torch.profiler.ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        trunk()
        torch.cuda.synchronize(dev)
        wall_ms = (time.perf_counter() - t0) * 1e3
    by_class = _device_breakdown(prof)
    busy = sum(by_class.values())
    return {
        "trunk_ms": trunk_ms, "reps": reps, "profiled_wall_ms": wall_ms,
        "device_ms_by_class": by_class,
        "device_idle_share": (1.0 - busy / wall_ms) if busy else None,
        "block_sparse_launches": block_sparse_attention.launches
        - launches0[0],
        "dense_launches": dense_attention.launches - launches0[1],
        "dense_short_launches": dense_attention.short_launches
        - launches0[2],
        "peak_gib": torch.cuda.max_memory_allocated(dev) / 2**30,
    }


@torch.inference_mode()
def profile_hyvideo(sampler, size, video_length, reps, i2v=False):
    """The Base stage-0 carved trunk step; with ``i2v`` (token_replace)
    also the dense fallback step."""
    cfg, dev = sampler.cfg, sampler.device
    opts = (get_hy_i2v_options if i2v else get_hy_preset)(
        "base", size=size, video_length=video_length)
    lat, grid = sampler.pipeline._stage_shapes(opts)[0]
    carve = make_hy_carve(cfg, grid, opts.sa_drop_rates[0], opts.p_remain,
                          q_rows=opts.q_group, joint_sel=opts.joint_sel,
                          device=dev)
    gen = torch.Generator(device=dev).manual_seed(0)
    x = torch.randn((1, cfg.in_channels, *lat), generator=gen, device=dev)
    t = torch.full((1,), 900.0, device=dev)
    txt = torch.randn((1, sampler.TEXT_LEN, cfg.text_states_dim),
                      generator=gen, device=dev)
    mask = torch.ones((1, sampler.TEXT_LEN), dtype=torch.int32, device=dev)
    txt2 = torch.randn((1, cfg.text_states_dim_2), generator=gen, device=dev)
    model = sampler.model
    img, txth, aux = model.embed(x, t, txt, mask, txt2, carve)
    steps = [("carved", carve)]
    if i2v:
        steps.append(("dense", dataclasses.replace(carve, sa_drop_rate=0.0)))
    rows = []
    for step, c in steps:
        row = {"model": "hyvideo-i2v-token_replace" if i2v else "hyvideo",
               "step": step, "fp8": model.img_in.w8 is not None,
               "size": list(size),
               "video_length": video_length,
               "tokens": img.shape[1] + txth.shape[1],
               "blocks": -(-(img.shape[1] + txth.shape[1]) // 128)}
        row.update(_profile(lambda: model.trunk(img, txth, aux, c), dev,
                            reps))
        rows.append(row)
    return rows


@torch.inference_mode()
def profile_wan(sampler, size, frame_num, reps):
    """A carved and a dense warm-up trunk step; an I2V model (by its
    config) gets random CLIP tokens and conditioning ``y``, with the
    options the CLI builds for a 480p-class area."""
    cfg, dev = sampler.cfg, sampler.device
    i2v = cfg.model_type == "i2v"
    opts = (get_wan_i2v_options(832 * 480, size=size, frame_num=frame_num)
            if i2v else get_wan_preset("1.3b-base", size=size,
                                       frame_num=frame_num))
    pipe = sampler.pipeline
    lat = (16, *pipe._latent_shape(opts)[1:])
    carve = make_wan_carve(cfg, pipe._token_grid(lat), opts.sa_drop_rates[0],
                           opts.p_remain, curve=opts.curve,
                           q_rows=opts.q_group, joint_sel=opts.joint_sel,
                           device=dev)
    gen = torch.Generator(device=dev).manual_seed(0)
    x = torch.randn((2, *lat), generator=gen, device=dev)
    t = torch.full((2,), 900.0, device=dev)
    ctx = torch.randn((2, cfg.text_len, cfg.text_dim), generator=gen,
                      device=dev)
    cond = {}
    if i2v:
        cond = dict(clip_fea=torch.randn((2, 257, CLIP_DIM), generator=gen,
                                         device=dev),
                    y=torch.randn((2, cfg.in_dim - 16, *lat[1:]),
                                  generator=gen, device=dev))
    model = sampler.model
    h0, aux = model.embed(x, t, ctx, carve, **cond)
    rows = []
    for step, c in (("carved", carve),
                    ("dense", dataclasses.replace(carve, sa_drop_rate=0.0))):
        row = {"model": "wan-i2v-14b" if i2v else "wan-t2v-1.3b",
               "step": step, "size": list(size),
               "video_length": frame_num, "batch": 2, "tokens": carve.seqlen,
               "blocks": h0.shape[1] // 128}
        row.update(_profile(lambda: model.trunk(h0, aux, c), dev, reps))
        rows.append(row)
    return rows


class _ClassMarks:
    """Device ms by class from CUDA events recorded on the stream where
    each class's call starts and ends: the interval between two marks goes
    to the innermost class open there ("other" outside all). On one stream
    the intervals add up to the span of the run. (The profiler's link from
    a kernel to the op that launched it reuses correlation ids at this
    many events, so it attributes kernels to several ops.)"""

    def __init__(self):
        self.marks = []         # (event, class pushed, or None: pop)
        self.conv_flop = 0      # multiply-adds x 2 of the marked convs

    def _mark(self, cls):
        evt = torch.cuda.Event(enable_timing=True)
        evt.record()
        self.marks.append((evt, cls))

    def wrap(self, fn, cls):
        @functools.wraps(fn)
        def run(*a, **kw):
            self._mark(cls)
            try:
                return fn(*a, **kw)
            finally:
                self._mark(None)
        return run

    def count_conv(self, conv3d):
        @functools.wraps(conv3d)
        def run(x, w, *a, **kw):
            out = conv3d(x, w, *a, **kw)
            self.conv_flop += 2 * out.numel() * w[0].numel()
            return out
        return run

    def breakdown(self) -> dict:
        torch.cuda.synchronize()
        out = dict.fromkeys(_VAE_CLASSES, 0.0)
        stack = []
        for (evt, cls), (nxt, _) in zip(self.marks, self.marks[1:]):
            if cls is None:
                stack.pop()
            else:
                stack.append(cls)
            out[stack[-1] if stack else "other"] += evt.elapsed_time(nxt)
        return out


_VAE_CLASSES = ("conv", "norm", "attention", "copies", "other")


@contextlib.contextmanager
def _vae_class_marks():
    """The VAEs' convs, norms, attentions and copies (padding,
    concatenation, the nearest repeat, the carried frames) wrapped in
    class marks; yields the ``_ClassMarks``."""
    from .codec import vae_hy, vae_wan
    marks = _ClassMarks()
    patches = [(vae_hy, "group_norm", "norm"),
               (vae_hy, "_mid_attention", "attention"),
               (vae_wan, "_rms_norm", "norm"),
               (vae_wan, "_attention", "attention"),
               (torch.nn.functional, "conv3d", "conv"),
               (torch.nn.functional, "pad", "copies"),
               (torch, "cat", "copies"),
               (torch.Tensor, "repeat_interleave", "copies"),
               (torch.Tensor, "clone", "copies")]
    with contextlib.ExitStack() as stack:
        for owner, name, cls in patches:
            fn = getattr(owner, name)
            if cls == "conv":
                fn = marks.count_conv(fn)
            stack.enter_context(mock.patch.object(
                owner, name, marks.wrap(fn, cls)))
        yield marks


def _busy_ms(prof) -> float:
    """The union of the device events' intervals, ms."""
    spans = sorted((e.time_range.start, e.time_range.end)
                   for e in prof.events()
                   if e.device_type == torch.autograd.DeviceType.CUDA)
    busy, cur = 0.0, None
    for a, b in spans:
        if cur is None or a > cur[1]:
            busy += 0.0 if cur is None else cur[1] - cur[0]
            cur = [a, b]
        else:
            cur[1] = max(cur[1], b)
    return (busy + (cur[1] - cur[0] if cur else 0.0)) / 1e3


def _profile_vae(run, warmup, dev) -> dict:
    """``warmup()``; ``run()`` timed with CUDA events (and its peak
    memory); ``run()`` with the class marks; ``run()`` under the profiler
    for the device's idle share."""
    warmup()
    torch.cuda.synchronize(dev)
    torch.cuda.reset_peak_memory_stats(dev)
    resident = torch.cuda.memory_allocated(dev)
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    out = run()
    end.record()
    end.synchronize()
    shape = list(out.shape)
    del out
    ms = start.elapsed_time(end)
    peak = torch.cuda.max_memory_allocated(dev)
    with _vae_class_marks() as marks:
        run()
    by_class = marks.breakdown()
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU,
                        torch.profiler.ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize(dev)
        wall_ms = (time.perf_counter() - t0) * 1e3
    return {"output": shape, "ms": ms, "device_ms_by_class": by_class,
            "marked_ms": sum(by_class.values()),
            "conv_tflop": marks.conv_flop / 1e12,
            "conv_tflop_per_s": marks.conv_flop / by_class["conv"] / 1e9,
            "profiled_wall_ms": wall_ms,
            "device_idle_share": 1.0 - _busy_ms(prof) / wall_ms,
            "peak_gib": peak / 2**30,
            "peak_above_resident_gib": (peak - resident) / 2**30}


@torch.inference_mode()
def profile_vae(model: str, dev) -> list:
    """The VAE rows of ``--model hy-vae`` / ``wan-vae``."""
    from .cli import _tiny_config, _tiny_wan_config
    from .codec import vae_hy, vae_wan
    torch.backends.cudnn.allow_tf32 = True      # PyTorch's default
    gen = torch.Generator(device=dev).manual_seed(0)
    rows = []
    if model == "hy-vae":
        vae = vae_hy.init_hyvae_(vae_hy.HYVAE(vae_hy.HYVAE_884_16C,
                                              device=dev), gen)
        sampler = HunyuanVideoSampler(_tiny_config("cuda"), device=dev,
                                      vae=vae)
        z = torch.randn((16, 32, 90, 160), generator=gen, device=dev)
        row = {"model": "hy-vae", "step": "decode", "size": [1280, 720],
               "video_length": 125, "latent": list(z.shape)}
        row.update(_profile_vae(lambda: sampler.decode_latents(z),
                                lambda: sampler.decode_latents(z[:, :9]),
                                dev))
        return [row]
    vae = vae_wan.init_wanvae_(vae_wan.WanVAE(vae_wan.WAN_VAE_16Z,
                                              device=dev), gen)
    sampler = WanSampler(_tiny_wan_config("cuda"), device=dev, vae=vae)
    for (w, h) in ((832, 480), (1280, 720)):
        z = torch.randn((16, 21, h // 8, w // 8), generator=gen, device=dev)
        row = {"model": "wan-vae", "step": "decode", "size": [w, h],
               "video_length": 81, "latent": list(z.shape)}
        row.update(_profile_vae(lambda: sampler.decode_latents(z),
                                lambda: sampler.decode_latents(z[:, :2]),
                                dev))
        rows.append(row)
    img = torch.rand((3, 720, 1280), generator=gen, device=dev)
    row = {"model": "wan-vae", "step": "i2v_encode", "size": [1280, 720],
           "video_length": 81}
    row.update(_profile_vae(
        lambda: sampler.encode_image_latent(img, 81, 90, 160),
        lambda: sampler.encode_image_latent(img, 5, 90, 160), dev))
    rows.append(row)
    return rows


def main(argv=None):
    ap = argparse.ArgumentParser("jenga_tpu_torch.profile_step")
    ap.add_argument("--model", default="hyvideo",
                    choices=["hyvideo", "wan", "hyvideo-i2v", "wan-i2v",
                             "hy-vae", "wan-vae"])
    ap.add_argument("--video-size", type=int, nargs=2, default=None,
                    metavar=("W", "H"))
    ap.add_argument("--video-length", type=int, nargs="+", default=None)
    ap.add_argument("--reps", type=int, default=2)
    ap.add_argument("--use-fp8", action="store_true",
                    help="e4m3 weights (--model hyvideo)")
    ap.add_argument("--out", type=str, default=None)
    args = ap.parse_args(argv)
    if args.use_fp8 and args.model != "hyvideo":
        ap.error("--use-fp8 takes --model hyvideo")
    gpu = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    if args.model.endswith("-vae"):
        rows = profile_vae(args.model, torch.device("cuda"))
        for row in rows:
            row["gpu"] = gpu
            print(json.dumps(row), flush=True)
        if args.out:
            with open(args.out, "w") as f:
                f.write("\n".join(json.dumps(r) for r in rows) + "\n")
        return
    if args.model == "wan":
        sampler = WanSampler(WAN_T2V_1_3B, device="cuda")
        run, size, lengths = profile_wan, (832, 480), [81]
    elif args.model == "wan-i2v":
        sampler = WanSampler.from_task("i2v-14B", device="cuda")
        run, size, lengths = profile_wan, (832, 480), [81]
    elif args.model == "hyvideo-i2v":
        sampler = HunyuanVideoSampler(hy_i2v_config("token_replace"),
                                      device="cuda", i2v=True)
        run, size, lengths = functools.partial(profile_hyvideo, i2v=True), \
            (1280, 720), [33]
    else:
        sampler = HunyuanVideoSampler(HUNYUAN_VIDEO_T2V, device="cuda",
                                      use_fp8=args.use_fp8)
        run, size, lengths = profile_hyvideo, (1280, 720), [33]
    size = tuple(args.video_size or size)
    rows = []
    for vl in args.video_length or lengths:
        for row in run(sampler, size, vl, args.reps):
            row["gpu"] = gpu
            rows.append(row)
            print(json.dumps(row), flush=True)
    if args.out:
        with open(args.out, "w") as f:
            f.write("\n".join(json.dumps(r) for r in rows) + "\n")


if __name__ == "__main__":
    main()

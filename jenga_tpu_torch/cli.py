"""Command-line entry point of the port (the ``hyvideo-t2v``,
``hyvideo-i2v``, ``wan-t2v`` and ``wan-i2v`` subcommands of
``jenga_tpu.cli``, with the same flag names).

Usage:
  python -m jenga_tpu_torch.cli hyvideo-t2v --preset base --latents-only \
      --video-size 1280 720 --video-length 33 --infer-steps 8 \
      --save-path out.npy
  python -m jenga_tpu_torch.cli hyvideo-t2v --preset turbo --q-group 8 \
      --no-joint-sel --latents-only --video-length 33 --infer-steps 8
  python -m jenga_tpu_torch.cli hyvideo-i2v --i2v-condition-type \
      latent_concat --latents-only --video-length 33 --infer-steps 8
  python -m jenga_tpu_torch.cli hyvideo-t2v --use-fp8 --latents-only \
      --video-length 33 --infer-steps 8
  python -m jenga_tpu_torch.cli wan-t2v --preset 14b-base --latents-only \
      --save-path out.npy
  python -m jenga_tpu_torch.cli wan-t2v --sample-solver dpm++ --latents-only
  python -m jenga_tpu_torch.cli wan-i2v --max-area 399360 --latents-only

HunyuanVideo presets: base, turbo, flash, 3stage, accvideo (the last four
switch resolution between stages, ProRes); ``hyvideo-i2v`` takes base.
Wan presets: 1.3b-base, 1.3b-turbo (Wan2.1-T2V-1.3B), 14b-base and
14b-turbo (Wan2.1-T2V-14B); ``wan-i2v`` runs Wan2.1-I2V-14B.
``wan-t2v --task`` picks the model when given, else the preset does (the
JAX CLI's ``--task`` defaults to t2v-1.3B whatever the preset says);
``--sample-solver`` picks UniPC or DPM-Solver++. ``hyvideo-t2v --use-fp8``
stores the published model's large linear weights in e4m3; as in the JAX
CLI it does not act on ``--tiny``.

The port has no checkpoints, text encoders or image encoders yet: the DiT
runs from a seeded random init on the device, the text states are zero
embeddings (256 tokens for HunyuanVideo; 64 for Wan, padded to its
``text_len``), and no command builds a VAE (the samplers take one as
``vae=``, see ``runtime.py``; the CLI gets one with the checkpoints). So
each command saves its final latents (.npy), as the JAX CLI does without a
VAE in its checkpoint directory: the output rule is JAX's
(``_save_output``), a [3, F, H, W] video through ``utils.video`` and
anything else as .npy. ``hyvideo-i2v --i2v-image-path`` loads the image
and, without ``--video-size``, buckets the video size by its aspect at
``--i2v-resolution``; it encodes one conditioning latent per stage when the
sampler has a VAE, else (here) takes zero latents with JAX's message.
Without an image it needs ``--tiny``. ``wan-i2v`` runs on zero conditioning
(its image path needs T5 and CLIP); the would-be image is ``--video-size``
(default 832x480), and the latent size comes from its aspect under
``--max-area``; with ``--tiny`` and no ``--video-size`` the latent is 16x16
over 9 frames, the JAX smoke shape.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import time


def _q_group_arg(s: str) -> int:
    """Joint selection takes up to 16 rows per group; --no-joint-sel at
    most 8 (the membership words), which the pipeline build enforces."""
    v = int(s)
    if not 1 <= v <= 16:
        raise argparse.ArgumentTypeError(
            f"--q-group must be in [1, 16], got {v}")
    return v


def _common(p: argparse.ArgumentParser):
    p.add_argument("--infer-steps", type=int, default=None)
    p.add_argument("--video-size", type=int, nargs=2, default=None,
                   metavar=("W", "H"))
    p.add_argument("--video-length", type=int, default=None)
    p.add_argument("--sa-drop-rates", type=float, nargs="*", default=None,
                   help="drop rate per stage (first, last)")
    p.add_argument("--p-remain-rates", type=float, default=None,
                   help="top-p probability mass the block selection keeps")
    p.add_argument("--curve-type", type=str, default=None,
                   choices=["gilbert", "sliced", "transposed"],
                   help="space-filling curve for token reordering (the I2V "
                        "commands parse it and, as in the JAX CLI, ignore "
                        "it)")
    p.add_argument("--q-group", type=_q_group_arg, default=None,
                   help="query blocks that share one KV block list "
                        "(presets: 8; 1 = per-row selection)")
    p.add_argument("--no-joint-sel", action="store_true",
                   help="with --q-group > 1 (at most 8): each row keeps its "
                        "own block selection, gathered from its group's "
                        "union list with membership words")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--tiny", action="store_true",
                   help="tiny random model (smoke runs): bf16 with head "
                        "dim 128 on cuda, f32 with head dim 64 on cpu")
    p.add_argument("--latents-only", action="store_true",
                   help="skip the VAE decode and dump the latents (.npy)")
    p.add_argument("--save-path", type=str, default="output.npy")
    p.add_argument("--device", choices=["cuda", "cpu"], default="cuda")


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser("jenga_tpu_torch")
    sub = ap.add_subparsers(dest="cmd", required=True)
    h = sub.add_parser("hyvideo-t2v", help="HunyuanVideo text-to-video")
    h.add_argument("--preset", default="base",
                   choices=["base", "turbo", "flash", "3stage", "accvideo"])
    h.add_argument("--embedded-cfg-scale", type=float, default=6.0)
    h.add_argument("--use-fp8", action="store_true",
                   help="e4m3 storage of the large linear weights, "
                        "dequantized to bf16 in each product (not with "
                        "--tiny, as in the JAX CLI)")
    _common(h)
    i = sub.add_parser("hyvideo-i2v", help="HunyuanVideo image-to-video")
    i.add_argument("--preset", default="base", choices=["base"])
    i.add_argument("--i2v-condition-type", default="token_replace",
                   choices=["token_replace", "latent_concat"])
    i.add_argument("--i2v-stability", action="store_true", default=True,
                   help="blend the initial noise with the image latent "
                        "(always on, as in the JAX CLI)")
    i.add_argument("--i2v-resolution", default="720p",
                   choices=["720p", "540p", "360p"],
                   help="aspect-ratio bucket base for the conditioning image "
                        "when --video-size is not given")
    i.add_argument("--i2v-image-path", type=str, default=None,
                   help="the conditioning image (first frame)")
    _common(i)
    w = sub.add_parser("wan-t2v", help="Wan2.1 text-to-video")
    w.add_argument("--preset", default="1.3b-base",
                   choices=["1.3b-base", "1.3b-turbo", "14b-base",
                            "14b-turbo"])
    w.add_argument("--task", default=None, choices=["t2v-1.3B", "t2v-14B"],
                   help="the model (default: the preset's)")
    _common(w)
    w.add_argument("--sample-shift", type=float, default=None)
    w.add_argument("--enable-turbo", action="store_true")
    w.add_argument("--teacache-thresh", type=float, default=None)
    w.add_argument("--sample-solver", default=None,
                   choices=["unipc", "dpm++"])
    wi = sub.add_parser("wan-i2v", help="Wan2.1 image-to-video (14B)")
    wi.add_argument("--max-area", type=int, default=720 * 1280,
                    help="pixel budget of the video; <= 832*480 also sets "
                         "the flow shift 3.0")
    _common(wi)
    return ap


def _tiny_config(device: str):
    """The tiny HunyuanVideo model: f32 with head dim 64 on the CPU; on the
    card, where the attention kernels take only bf16 and head dim 128, bf16
    with two heads of 128 and the published RoPE split."""
    from .models.hyvideo import HYVideoConfig
    cfg = HYVideoConfig(hidden_size=128, heads_num=2, double_blocks=1,
                        single_blocks=1, rope_dim_list=(16, 24, 24),
                        text_states_dim=64, text_states_dim_2=24,
                        refiner_depth=1, dtype="float32")
    if device == "cuda":
        cfg = dataclasses.replace(cfg, hidden_size=256,
                                  rope_dim_list=(16, 56, 56),
                                  dtype="bfloat16")
    return cfg


def _tiny_wan_config(device: str, i2v: bool = False):
    """The tiny Wan model: f32 with head dim 64 on the CPU, bf16 with two
    heads of 128 on the card (see ``_tiny_config``); ``i2v`` takes the 36
    input channels and the image cross-attention."""
    from .models.wan import WanConfig
    cfg = WanConfig(dim=128, ffn_dim=256, freq_dim=32, num_heads=2,
                    num_layers=2, text_dim=64, text_len=16, dtype="float32",
                    model_type="i2v" if i2v else "t2v",
                    in_dim=36 if i2v else 16)
    if device == "cuda":
        cfg = dataclasses.replace(cfg, dim=256, dtype="bfloat16")
    return cfg


def _save_output(path, out, latents_only=False):
    """The JAX CLI's rule: ``.npy`` when ``latents_only`` or ``out`` is not
    a [3, F, H, W] video, else ``utils.video.save_video`` (mp4, or gif
    without an ffmpeg backend). Returns the path written."""
    import numpy as np
    if latents_only or out.ndim != 4 or out.shape[0] != 3:
        path = path.rsplit(".", 1)[0] + ".npy"
        np.save(path, np.asarray(out))
        print(f"saved latents to {path}")
    else:
        from .utils.video import save_video
        path = save_video(path, np.asarray(out))
        print(f"saved video to {path}")
    return path


def _save(args, out, t0):
    out = out.cpu()     # waits for the device
    print(json.dumps({"gen_time_s": round(time.time() - t0, 2)}))
    _save_output(args.save_path, out.numpy(), args.latents_only)


def _hy_overrides(args) -> dict:
    """The options both HunyuanVideo commands take from their flags."""
    over = {"seed": args.seed}
    if args.infer_steps:
        over["num_inference_steps"] = args.infer_steps
    if args.video_size:
        over["size"] = tuple(args.video_size)
    if args.video_length:
        over["video_length"] = args.video_length
    if args.sa_drop_rates:
        over["sa_drop_rates"] = tuple(args.sa_drop_rates)
    if args.p_remain_rates is not None:
        over["p_remain"] = args.p_remain_rates
    if args.q_group is not None:
        over["q_group"] = args.q_group
    if args.no_joint_sel:
        over["joint_sel"] = False
    return over


def _zero_hy_text(cfg, n):
    import numpy as np
    return (np.zeros((n, cfg.text_states_dim), np.float32),
            np.ones((n,), np.int32),
            np.zeros((cfg.text_states_dim_2,), np.float32))


def hy_t2v_options(args):
    """``hyvideo-t2v``'s options: the preset, then the flags."""
    from .configs.presets import get_hy_preset
    over = _hy_overrides(args)
    if args.curve_type:
        over["curve"] = args.curve_type
    over["embedded_guidance_scale"] = args.embedded_cfg_scale
    return get_hy_preset(args.preset, **over)


def run_hyvideo_t2v(args):
    from .models.hyvideo import HUNYUAN_VIDEO_T2V
    from .runtime import HunyuanVideoSampler

    opts = hy_t2v_options(args)
    cfg = _tiny_config(args.device) if args.tiny else HUNYUAN_VIDEO_T2V
    # --use-fp8 acts on the published model only, as in the JAX CLI
    sampler = HunyuanVideoSampler(cfg, device=args.device, seed=args.seed,
                                  use_fp8=args.use_fp8 and not args.tiny)
    text = _zero_hy_text(cfg, sampler.TEXT_LEN)
    t0 = time.time()
    _save(args, sampler.predict(*text, opts, decode=not args.latents_only),
          t0)


def hy_i2v_options(args):
    """``hyvideo-i2v``'s options, by the JAX CLI's rule (the T2V preset
    merged over the I2V defaults, then the flags; ``--curve-type`` is
    parsed and not applied)."""
    from .configs.presets import get_hy_i2v_options
    return get_hy_i2v_options(
        args.preset, i2v_condition_type=args.i2v_condition_type,
        i2v_stability=args.i2v_stability, **_hy_overrides(args))


def hy_i2v_bucket(image, resolution: str):
    """The video size (W, H) of the aspect-ratio bucket closest to the
    image's [3, H, W], at ``--i2v-resolution``'s base. The reference reads
    a bucket as (h, w) (its ratio is the first over the second, matched to
    H / W); the JAX CLI takes it as (w, h), which gives a landscape image a
    portrait video."""
    from .pipelines.hyvideo_i2v import (generate_crop_size_list,
                                        get_closest_ratio)
    bucket_base = {"720p": 960, "540p": 720, "360p": 480}[resolution]
    buckets = generate_crop_size_list(bucket_base, 32)
    ratios = [round(float(h) / float(w), 5) for h, w in buckets]
    (h, w), _ = get_closest_ratio(image.shape[1], image.shape[2], ratios,
                                  buckets)
    return (w, h)


def hy_i2v_image_latents(args, sampler, opts):
    """(options, one conditioning latent per stage) by the JAX CLI's rule:
    with ``--i2v-image-path`` the image, bucketed when ``--video-size`` is
    absent, encoded at each stage's latent size if the sampler has a VAE,
    else zero latents; without an image, zero latents."""
    import numpy as np
    image = None
    if args.i2v_image_path:
        from .runtime import load_image
        image = load_image(args.i2v_image_path)
        if not args.video_size:
            opts = dataclasses.replace(
                opts, size=hy_i2v_bucket(image, args.i2v_resolution))
    shapes = sampler.pipeline._stage_shapes(opts)
    if image is not None and sampler.vae is not None:
        return opts, [sampler.encode_image_latent(image, lat[1], lat[2])
                      for lat, _ in shapes]
    if image is not None:
        print("no VAE in ckpt dir: zero conditioning latents (smoke mode)")
    return opts, [np.zeros((16, 1, lat[1], lat[2]), np.float32)
                  for lat, _ in shapes]


def run_hyvideo_i2v(args):
    from .models.hyvideo import HUNYUAN_VIDEO_T2V, hy_i2v_config
    from .runtime import HunyuanVideoSampler

    if not args.i2v_image_path and not args.tiny:
        raise SystemExit("hyvideo-i2v requires --i2v-image-path (or --tiny "
                         "for a smoke run)")
    opts = hy_i2v_options(args)
    base = _tiny_config(args.device) if args.tiny else HUNYUAN_VIDEO_T2V
    cfg = hy_i2v_config(opts.i2v_condition_type, base)
    sampler = HunyuanVideoSampler(cfg, device=args.device, seed=args.seed,
                                  i2v=True)
    opts, image_latents = hy_i2v_image_latents(args, sampler, opts)
    text = _zero_hy_text(cfg, sampler.TEXT_LEN)
    t0 = time.time()
    _save(args, sampler.predict_i2v(image_latents, *text, opts,
                                    decode=not args.latents_only), t0)


def wan_t2v_options(args):
    """``wan-t2v``'s options: the preset, then the flags, as the JAX
    handler applies them."""
    from .configs.presets import get_wan_preset
    over = {"seed": args.seed}
    if args.infer_steps:
        over["sampling_steps"] = args.infer_steps
    if args.video_size:
        over["size"] = tuple(args.video_size)
    if args.video_length:
        over["frame_num"] = args.video_length
    if args.sa_drop_rates:
        over["sa_drop_rates"] = tuple(args.sa_drop_rates)
    if args.p_remain_rates is not None:
        over["p_remain"] = args.p_remain_rates
    if args.curve_type:
        over["curve"] = args.curve_type
    if args.sample_shift is not None:
        over["shift"] = args.sample_shift
    if args.q_group is not None:
        over["q_group"] = args.q_group
    if args.no_joint_sel:
        over["joint_sel"] = False
    if args.enable_turbo:
        over["enable_turbo"] = True
    if args.teacache_thresh is not None:
        over["teacache_thresh"] = args.teacache_thresh
    if args.sample_solver:
        over["solver"] = args.sample_solver
    return get_wan_preset(args.preset, **over)


def wan_t2v_task(args) -> str:
    """The published model ``wan-t2v`` builds: ``--task`` when given, else
    the preset's (the JAX CLI's ``--task`` defaults to t2v-1.3B whatever
    the preset)."""
    if args.task:
        return args.task
    return "t2v-14B" if args.preset.startswith("14b") else "t2v-1.3B"


def run_wan_t2v(args):
    import numpy as np
    from .runtime import WanSampler

    opts = wan_t2v_options(args)
    if args.tiny:
        sampler = WanSampler(_tiny_wan_config(args.device),
                             device=args.device, seed=args.seed)
    else:
        sampler = WanSampler.from_task(wan_t2v_task(args),
                                       device=args.device, seed=args.seed)
    ctx = np.zeros((64, sampler.cfg.text_dim), np.float32)
    t0 = time.time()
    _save(args, sampler.generate(ctx, np.zeros_like(ctx), opts,
                                 decode=not args.latents_only), t0)


def wan_i2v_inputs(args):
    """``wan-i2v``'s options, frame count and latent (h, w), by the JAX
    CLI's rule: ``--tiny`` without ``--video-size`` takes the JAX smoke
    shape (16x16 over ``--video-length`` or 9 frames); otherwise the latent
    size is ``i2v_latent_size`` of ``--video-size`` (default the options'
    832x480) under ``--max-area``."""
    from .configs.presets import get_wan_i2v_options
    from .pipelines.wan_i2v import i2v_latent_size

    over = {"seed": args.seed}
    if args.q_group is not None:
        over["q_group"] = args.q_group
    if args.no_joint_sel:
        over["joint_sel"] = False
    if args.infer_steps:
        over["sampling_steps"] = args.infer_steps
    if args.video_length:
        over["frame_num"] = args.video_length
    if args.sa_drop_rates:
        over["sa_drop_rates"] = tuple(args.sa_drop_rates)
    if args.p_remain_rates is not None:
        over["p_remain"] = args.p_remain_rates
    if args.tiny:
        over["frame_num"] = args.video_length or 9
    opts = get_wan_i2v_options(args.max_area, **over)
    if args.tiny and not args.video_size:
        return opts, opts.frame_num, 16, 16
    w, h = args.video_size or opts.size
    return (opts, opts.frame_num, *i2v_latent_size(h, w, args.max_area))


def run_wan_i2v(args):
    import numpy as np
    from .models.wan import CLIP_DIM
    from .runtime import WanSampler

    opts, frame_num, lat_h, lat_w = wan_i2v_inputs(args)
    if args.tiny:
        sampler = WanSampler(_tiny_wan_config(args.device, i2v=True),
                             device=args.device, seed=args.seed)
    else:
        sampler = WanSampler.from_task("i2v-14B", device=args.device,
                                       seed=args.seed)
    # no T5 or CLIP tower yet, so no image path: zero image latent and
    # CLIP tokens
    t_lat = (frame_num - 1) // 4 + 1
    img_lat = np.zeros((16, t_lat, lat_h, lat_w), np.float32)
    clip_fea = np.zeros((257, CLIP_DIM), np.float32)
    ctx = np.zeros((64, sampler.cfg.text_dim), np.float32)
    t0 = time.time()
    _save(args, sampler.generate_i2v(
        img_lat, clip_fea, ctx, np.zeros_like(ctx), frame_num, lat_h, lat_w,
        opts, decode=not args.latents_only), t0)


def main(argv=None):
    args = build_parser().parse_args(argv)
    {"hyvideo-t2v": run_hyvideo_t2v, "hyvideo-i2v": run_hyvideo_i2v,
     "wan-t2v": run_wan_t2v, "wan-i2v": run_wan_i2v}[args.cmd](args)


if __name__ == "__main__":
    main()

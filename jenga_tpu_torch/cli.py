"""Command-line entry point of the port (the ``hyvideo-t2v`` and
``wan-t2v`` subcommands of ``jenga_tpu.cli``, with the same flag names).

Usage:
  python -m jenga_tpu_torch.cli hyvideo-t2v --preset base --latents-only \
      --video-size 1280 720 --video-length 33 --infer-steps 8 \
      --save-path out.npy
  python -m jenga_tpu_torch.cli hyvideo-t2v --preset turbo --q-group 8 \
      --no-joint-sel --latents-only --video-length 33 --infer-steps 8
  python -m jenga_tpu_torch.cli wan-t2v --preset 1.3b-turbo --latents-only \
      --save-path out.npy

HunyuanVideo presets: base, turbo, flash, 3stage, accvideo (the last four
switch resolution between stages, ProRes); Wan presets: 1.3b-base and
1.3b-turbo (the 14B presets are refused).

The port has no checkpoints, text encoders or VAE yet: the DiT runs from
a seeded random init on the device, the text states are zero embeddings
(256 tokens for HunyuanVideo; 64 for Wan, padded to its ``text_len``),
and the output is the final latents (.npy).
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
                   help="dump latents .npy (the only output until the VAE "
                        "is ported)")
    p.add_argument("--save-path", type=str, default="output.npy")
    p.add_argument("--device", choices=["cuda", "cpu"], default="cuda")


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser("jenga_tpu_torch")
    sub = ap.add_subparsers(dest="cmd", required=True)
    h = sub.add_parser("hyvideo-t2v", help="HunyuanVideo text-to-video")
    h.add_argument("--preset", default="base",
                   choices=["base", "turbo", "flash", "3stage", "accvideo"])
    _common(h)
    w = sub.add_parser("wan-t2v", help="Wan2.1 text-to-video")
    w.add_argument("--preset", default="1.3b-base",
                   choices=["1.3b-base", "1.3b-turbo", "14b-base",
                            "14b-turbo"])
    _common(w)
    w.add_argument("--sa-drop-rates", type=float, nargs="+", default=None)
    w.add_argument("--teacache-thresh", type=float, default=None)
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


def _tiny_wan_config(device: str):
    """The tiny Wan model: f32 with head dim 64 on the CPU, bf16 with two
    heads of 128 on the card (see ``_tiny_config``)."""
    from .models.wan import WanConfig
    cfg = WanConfig(dim=128, ffn_dim=256, freq_dim=32, num_heads=2,
                    num_layers=2, text_dim=64, text_len=16, dtype="float32")
    if device == "cuda":
        cfg = dataclasses.replace(cfg, dim=256, dtype="bfloat16")
    return cfg


def _save_latents(args, out, t0):
    import numpy as np
    out = out.cpu()     # waits for the device
    print(json.dumps({"gen_time_s": round(time.time() - t0, 2)}))
    path = args.save_path.rsplit(".", 1)[0] + ".npy"
    np.save(path, out.numpy())
    print(f"saved latents to {path}")


def run_hyvideo_t2v(args):
    import numpy as np
    from .configs.presets import get_hy_preset
    from .models.hyvideo import HUNYUAN_VIDEO_T2V
    from .runtime import HunyuanVideoSampler

    over = {"seed": args.seed}
    if args.infer_steps:
        over["num_inference_steps"] = args.infer_steps
    if args.video_size:
        over["size"] = tuple(args.video_size)
    if args.video_length:
        over["video_length"] = args.video_length
    if args.q_group is not None:
        over["q_group"] = args.q_group
    if args.no_joint_sel:
        over["joint_sel"] = False
    opts = get_hy_preset(args.preset, **over)

    cfg = _tiny_config(args.device) if args.tiny else HUNYUAN_VIDEO_T2V
    sampler = HunyuanVideoSampler(cfg, device=args.device, seed=args.seed)
    n = sampler.TEXT_LEN
    txt = np.zeros((n, cfg.text_states_dim), np.float32)
    mask = np.ones((n,), np.int32)
    txt2 = np.zeros((cfg.text_states_dim_2,), np.float32)
    t0 = time.time()
    _save_latents(args, sampler.predict(txt, mask, txt2, opts), t0)


def run_wan_t2v(args):
    import numpy as np
    from .configs.presets import get_wan_preset
    from .models.wan import WAN_T2V_1_3B
    from .runtime import WanSampler

    over = {"seed": args.seed}
    if args.infer_steps:
        over["sampling_steps"] = args.infer_steps
    if args.video_size:
        over["size"] = tuple(args.video_size)
    if args.video_length:
        over["frame_num"] = args.video_length
    if args.sa_drop_rates:
        over["sa_drop_rates"] = tuple(args.sa_drop_rates)
    if args.q_group is not None:
        over["q_group"] = args.q_group
    if args.no_joint_sel:
        over["joint_sel"] = False
    if args.teacache_thresh is not None:
        over["teacache_thresh"] = args.teacache_thresh
    if args.preset.startswith("14b"):
        raise SystemExit("Wan 14B runs are not ported yet (1.3b presets "
                         "only)")
    opts = get_wan_preset(args.preset, **over)

    cfg = _tiny_wan_config(args.device) if args.tiny else WAN_T2V_1_3B
    sampler = WanSampler(cfg, device=args.device, seed=args.seed)
    ctx = np.zeros((64, cfg.text_dim), np.float32)
    t0 = time.time()
    _save_latents(args, sampler.generate(ctx, np.zeros_like(ctx), opts), t0)


def main(argv=None):
    args = build_parser().parse_args(argv)
    if args.cmd == "hyvideo-t2v":
        run_hyvideo_t2v(args)
    elif args.cmd == "wan-t2v":
        run_wan_t2v(args)


if __name__ == "__main__":
    main()

"""Carved-vs-dense fidelity of the port's samplers (port of the JAX tools
``tools/fidelity_run.py``, ``fidelity_hy.py``, ``fidelity_i2v.py`` and
``fidelity_wan14b.py``).

Each suite runs one seed through the dense configuration and the carved
ones and reports, per row, the final latents' MSE and relative error
(``pipelines/loss_eval.py``). The configurations follow the JAX tools
field for field:

  wan     Wan2.1-T2V-1.3B, 832x480x33f, 20 steps, no TeaCache, Jenga-Base
          drop .75/.85, p_remain .9: per-row carved vs dense, joint q4 and
          joint q8 each against dense and against per-row carving
  hy      HunyuanVideo at full width cut to 2 + 4 blocks, the ProRes Turbo
          trajectory at 960x512x33f over 20 steps (stage 0 at res .75 with
          text_amp, switch after step 10, fixed skips, 11 computed), drop
          .7/.8, p_remain .3: joint q8 and per-row each against dense, and
          q8 against per-row
  i2v     HunyuanVideo-I2V token_replace at full width cut to 2 + 4
          blocks, 960x512x33f, 20 steps, one full-resolution stage, drop
          .75/.85, p_remain .3, a seeded clean frame-0 latent: the same
          three rows; frame 0 must be the same pinned latent in every arm
  wan14b  Wan2.1-T2V-14B at full width cut to 4 of 40 layers, as ``wan``:
          joint q8 and per-row each against dense, q8 against per-row

Weights are the port's seeded init (``torch.Generator`` seed 0 on the
device), not the JAX init, with the zero-initialised head given 0.02 x
randn (seed 99) as the JAX tools do, or every velocity would be 0; text
states are randn (seed 1). Random weights make the pooled-QK selection
near random, the worst case for carving. ``--quick`` runs tiny models at
the JAX tools' smoke sizes.

    python -m jenga_tpu_torch.tools.fidelity [--suite wan hy i2v wan14b]
        [--out rows.jsonl] [--quick] [--device cuda|cpu]

Prints one JSON line per row, each with the card's name and power limit;
writes a file only with ``--out``.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import time

import torch

from .. import cli
from ..models.hyvideo import HUNYUAN_VIDEO_T2V, hy_i2v_config
from ..models.wan import WAN_T2V_1_3B, WAN_T2V_14B
from ..pipelines.hyvideo_i2v import HYI2VOptions
from ..pipelines.hyvideo_t2v import HYT2VOptions
from ..pipelines.loss_eval import fidelity_row
from ..pipelines.wan_t2v import WanT2VOptions
from ..runtime import HunyuanVideoSampler, WanSampler
from ._common import gpu_line, resolve_device

__all__ = ["SUITES", "Suite", "build_suite", "run_suite", "run", "main"]

SUITES = ("wan", "hy", "i2v", "wan14b")
HY_NON_SKIP = (0, 1, 2, 3, 4, 5, 10, 11, 12, 15, 19)


@dataclasses.dataclass
class Suite:
    """A sampler, its run (options -> final latents), the options of each
    arm, and the rows ``(row id, arm, reference arm, config)``."""
    name: str
    sampler: object
    run_arm: object         # options -> final latents
    arms: dict
    rows: list


def _perturb(lin, device, scale=0.02):
    """0.02 x randn (seed 99) on a zero-initialised linear layer."""
    gen = torch.Generator(device=device).manual_seed(99)
    with torch.no_grad():
        lin.w.copy_(torch.randn(lin.w.shape, generator=gen, device=device)
                    * scale)


def _randn(gen, shape, device):
    return torch.randn(shape, generator=gen, device=device)


def _wan_suite(name, device, quick):
    if quick:
        cfg = cli._tiny_wan_config(device.type)
    elif name == "wan14b":
        cfg = dataclasses.replace(WAN_T2V_14B, num_layers=4)
    else:
        cfg = WAN_T2V_1_3B
    sampler = WanSampler(cfg, device=device, seed=0)
    _perturb(sampler.model.head_layer.linear, device)
    gen = torch.Generator(device=device).manual_seed(1)
    ctx = _randn(gen, (77, cfg.text_dim), device)
    null = _randn(gen, (77, cfg.text_dim), device)
    size, frames, steps = ((128, 64), 5, 4) if quick else ((832, 480), 33, 20)
    base = WanT2VOptions(size=size, frame_num=frames, sampling_steps=steps,
                         teacache_thresh=None, seed=7)
    carved = dataclasses.replace(base, sa_drop_rates=(0.75, 0.85),
                                 p_remain=0.9)
    dense = dataclasses.replace(base, sa_drop_rates=(0.0, 0.0))
    q8 = dataclasses.replace(carved, q_group=8, joint_sel=True)
    if name == "wan":
        desc = (f"wan-1.3b-arch {size[0]}x{size[1]}x{frames}f {steps} steps, "
                "Jenga-Base drop .75/.85 p_remain .9, port seeded init, "
                "matched seed")
        arms = {"dense": dense, "per_row": carved, "q8": q8,
                "q4": dataclasses.replace(carved, q_group=4, joint_sel=True)}
        rows = [("per_row_vs_dense", "per_row", "dense", desc),
                ("q4_vs_dense", "q4", "dense",
                 "same, joint 4-row group selection (q_group=4)"),
                ("q4_vs_per_row", "q4", "per_row", "joint q_group=4 vs "
                 "per-row carving (granularity cost alone)"),
                ("q8_vs_dense", "q8", "dense",
                 "same, joint 8-row group selection (q_group=8)"),
                ("q8_vs_per_row", "q8", "per_row", "joint q_group=8 vs "
                 "per-row carving (granularity cost alone)")]
    else:
        desc = (f"wan-14b-arch (5120x40h, 4/40 trunk) {size[0]}x{size[1]}x"
                f"{frames}f {steps} steps, Jenga-Base drop .75/.85 p_remain "
                ".9, port seeded init, matched seed")
        arms = {"dense": dense, "q8": q8,
                "per_row": dataclasses.replace(q8, q_group=1,
                                               joint_sel=False)}
        rows = _three_rows(desc)
    return Suite(name, sampler,
                 lambda o: sampler.generate(ctx, null, o, decode=False),
                 arms, rows)


def _three_rows(desc):
    return [("q8_vs_dense", "q8", "dense",
             f"{desc} - joint q_group=8 vs dense"),
            ("per_row_vs_dense", "per_row", "dense",
             f"{desc} - per-row selection vs dense"),
            ("q8_vs_per_row", "q8", "per_row", "same - joint q_group=8 vs "
             "per-row (granularity cost alone)")]


def _hy_suite(name, device, quick):
    i2v = name == "i2v"
    base_cfg = (cli._tiny_config(device.type) if quick else
                dataclasses.replace(HUNYUAN_VIDEO_T2V, double_blocks=2,
                                    single_blocks=4))
    cfg = hy_i2v_config("token_replace", base_cfg) if i2v else base_cfg
    sampler = HunyuanVideoSampler(cfg, device=device, seed=0, i2v=i2v)
    _perturb(sampler.model.final_layer.linear, device)
    gen = torch.Generator(device=device).manual_seed(1)
    txt = _randn(gen, (100, cfg.text_states_dim), device)
    mask = torch.ones((100,), dtype=torch.int32, device=device)
    txt2 = _randn(gen, (cfg.text_states_dim_2,), device)
    size, frames, steps = ((384, 256), 5, 4) if quick else ((960, 512), 33,
                                                             20)
    non_skip = (0, 1, 3) if quick else HY_NON_SKIP
    if i2v:
        base = HYI2VOptions(
            size=size, video_length=frames, num_inference_steps=steps,
            sa_drop_rates=(0.75, 0.85), p_remain=0.3, res_rate_list=(1.0,),
            step_rate_list=(1.0,), scheduler_shift_list=(7.0,),
            txt_block_num=2, i2v_condition_type="token_replace",
            i2v_stability=True, enable_skip=True, non_skip_steps=non_skip,
            q_group=8, joint_sel=True, seed=7)
        img_lat = 0.5 * _randn(gen, (16, 1, size[1] // 8, size[0] // 8),
                               device)

        def run_arm(o):
            return sampler.predict_i2v([img_lat], txt, mask, txt2, o,
                                       decode=False)
        desc = (f"hy-i2v token_replace(3072x24h, 2+4 trunk) {size[0]}x"
                f"{size[1]}x{frames}f {steps} steps full-res stage, drop "
                ".75/.85 p_remain .3, fixed skips, i2v_stability, port "
                "seeded init + seeded clean frame-0 latent, matched seed")
    else:
        base = HYT2VOptions(
            size=size, video_length=frames, num_inference_steps=steps,
            sa_drop_rates=(0.7, 0.8), p_remain=0.3,
            res_rate_list=(0.75, 1.0), step_rate_list=(0.5, 1.0),
            scheduler_shift_list=(7.0, 9.0), scale_txt_amp=1.0,
            txt_block_num=2, enable_skip=True, non_skip_steps=non_skip,
            q_group=8, joint_sel=True, seed=7)

        def run_arm(o):
            return sampler.predict(txt, mask, txt2, o, decode=False)
        desc = (f"hy-arch(3072x24h, 2+4 trunk) turbo {size[0]}x{size[1]}x"
                f"{frames}f {steps} steps, stages res .75(text_amp on)/1.0, "
                "drop .7/.8 p_remain .3, fixed skips, port seeded init, "
                "matched seed")
    arms = {"q8": base,
            "per_row": dataclasses.replace(base, q_group=1, joint_sel=False),
            "dense": dataclasses.replace(base, sa_drop_rates=(0.0, 0.0),
                                         q_group=1, joint_sel=False)}
    return Suite(name, sampler, run_arm, arms, _three_rows(desc))


def build_suite(name: str, device, quick: bool = False) -> Suite:
    device = resolve_device(device)
    if name in ("wan", "wan14b"):
        return _wan_suite(name, device, quick)
    if name in ("hy", "i2v"):
        return _hy_suite(name, device, quick)
    raise ValueError(f"unknown suite {name!r} (one of {SUITES})")


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def run_suite(suite: Suite, rows=None, device_line=None) -> list[dict]:
    """Run the arms the chosen rows (default all) need, once each, and
    return the rows; an I2V suite's frame 0 must agree across arms."""
    chosen = [r for r in suite.rows if rows is None or r[0] in rows]
    if not chosen:
        raise ValueError(f"no rows {rows} in suite {suite.name}")
    lat, secs = {}, {}
    for arm in dict.fromkeys(a for r in chosen for a in r[1:3]):
        t0 = time.perf_counter()
        lat[arm] = suite.run_arm(suite.arms[arm])
        _sync(lat[arm].device)
        secs[arm] = time.perf_counter() - t0
    if suite.name == "i2v":
        f0 = {arm: x[:, :1] for arm, x in lat.items()}
        ref = next(iter(f0.values()))
        err = max((x - ref).norm().item() for x in f0.values())
        if err >= 1e-3:
            raise RuntimeError(f"frame-0 pin broken under carving: {err}")
    out = []
    for row, arm, ref_arm, config in chosen:
        rec = {"suite": suite.name, "row": row, **fidelity_row(
            lat[arm], lat[ref_arm]), "config": config,
            "arm_seconds": {arm: secs[arm], ref_arm: secs[ref_arm]},
            "device": device_line}
        out.append(rec)
    return out


def run(suites=SUITES, device="cuda", quick=False) -> list[dict]:
    """Every chosen suite's rows, each suite's model freed before the
    next is built."""
    device = resolve_device(device)
    line = gpu_line() if device.type == "cuda" else "cpu"
    out = []
    for name in suites:
        suite = build_suite(name, device, quick)
        for rec in run_suite(suite, device_line=line):
            print(json.dumps(rec), flush=True)
            out.append(rec)
        del suite
        if device.type == "cuda":
            torch.cuda.empty_cache()
    return out


def main(argv=None):
    ap = argparse.ArgumentParser("jenga_tpu_torch.tools.fidelity")
    ap.add_argument("--suite", nargs="+", choices=SUITES, default=SUITES)
    ap.add_argument("--quick", action="store_true",
                    help="tiny models at the JAX tools' smoke sizes")
    ap.add_argument("--device", choices=["cuda", "cpu"], default="cuda")
    ap.add_argument("--out", type=str, default=None,
                    help="also write the rows here, one JSON line each")
    args = ap.parse_args(argv)
    rows = run(args.suite, args.device, args.quick)
    if args.out:
        with open(args.out, "w") as f:
            f.write("".join(json.dumps(r) + "\n" for r in rows))


if __name__ == "__main__":
    main()

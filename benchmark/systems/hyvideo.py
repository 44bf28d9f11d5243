"""A HunyuanVideo T2V cell: the port's ``HunyuanVideoSampler`` driven
through ``pipeline.generate``, and its check against the plain reference.

The weights are the benchmark's (``traffic.weights``), with the
aligned-attention tie when the workload asks for it. Each clip takes
VAE-like initial latents, random LLM text states with a mask of the
workload's real token count, and a random pooled CLIP vector, drawn from
its own seed. The flow-matching Euler step carries no state: a step is
judged by the increment it gave the latents it was handed, against the
reference's velocity of those latents times the same sigma step.
"""

from __future__ import annotations

import dataclasses

import torch

from ..flops import hyvideo as hy_flops
from ..reference import common as RC
from ..reference import hyvideo as ref
from ..reference.curves.blocks import build_curve_plan
from ..traffic import aligned, latents
from . import compare
from .base import CellBase

MODEL_KEYS = ("patch_size", "in_channels", "out_channels", "hidden_size",
              "heads_num", "mlp_ratio", "double_blocks", "single_blocks",
              "rope_dim_list", "rope_theta", "qkv_bias", "guidance_embed",
              "text_states_dim", "text_states_dim_2", "refiner_depth",
              "dtype")


class Cell(CellBase):
    """One HunyuanVideo cell on one device."""

    reference = ref
    # fp8: the sampler's own fp8 weight path
    controls = ("fp8", "fp8ref")

    def __init__(self, config: dict, workload: dict, seed: int, device,
                 control: str | None = None):
        from jenga_tpu_torch.models.hyvideo import HYVideoConfig
        from jenga_tpu_torch.pipelines.hyvideo_t2v import HYT2VOptions
        from jenga_tpu_torch.runtime import HunyuanVideoSampler

        super().__init__(config, workload, seed, device, control)
        model_cfg = {k: config[k] for k in MODEL_KEYS}
        for key in ("patch_size", "rope_dim_list"):
            model_cfg[key] = tuple(model_cfg[key])
        self.model_cfg = HYVideoConfig(**model_cfg)
        # control "fp8": the program's own fp8 weight path
        self.sampler = HunyuanVideoSampler(
            self.model_cfg, params=self.all_weights(), device=self.device,
            use_fp8=control == "fp8")
        opts = {k: tuple(v) if isinstance(v, list) else v
                for k, v in workload["sampler"].items()}
        self.opts = HYT2VOptions(**opts)
        w, h = self.opts.size
        self.latent_shape = (config["in_channels"],
                             1 + (self.opts.video_length - 1) // 4,
                             h // 16 * 2, w // 16 * 2)
        self._last = None

    def tie(self, group):
        return aligned.tie_hyvideo(group, self.config["hidden_size"])

    def clip_inputs(self, clip: int):
        """(initial latents, text states [L, 4096], mask [L], pooled
        [768])."""
        gen = self.clip_generator(clip)
        x0 = latents.synth_latents(gen, (1, *self.latent_shape))[0]
        total, real = self.workload["text_tokens"]
        text = latents.text_states(gen, total, self.config["text_states_dim"])
        mask = (torch.arange(total, device=self.device) < real).to(
            torch.int32)
        pooled = latents.text_states(gen, 1,
                                     self.config["text_states_dim_2"])[0]
        return x0, text, mask, pooled

    def run_clip(self, clip: int, on_step):
        x0, text, mask, pooled = self.clip_inputs(clip)
        self.inputs[clip] = (x0, text, mask, pooled)
        self._last = x0

        def step(i, x):
            self.offer(dict(clip=clip, step=i, sample=self._last, out=x))
            self._last = x
            on_step(i)

        opts = dataclasses.replace(self.opts, seed=self.clip_seed(clip))
        self.sampler.pipeline.generate(text, mask, pooled, opts,
                                       on_step=step, initial_latents=x0,
                                       decode=False)

    def _text_len(self):
        return self.workload["text_tokens"][0]

    def facts(self) -> dict:
        return {"gemm_flop_per_step": hy_flops.gemm_flop(
                    self.config, self.latent_shape, self._text_len())}

    def _grid(self):
        p = self.config["patch_size"]
        _, f, h, w = self.latent_shape
        return (f // p[0], h // p[1], w // p[2])

    def _sigmas(self):
        return ref.flow_sigmas(self.opts.num_inference_steps,
                               self.opts.flow_shift)

    @torch.inference_mode()
    def density(self):
        """The planner's selected share of key blocks in the first double
        block on the sampled step's input (the program's own
        diagnostic)."""
        from jenga_tpu_torch.models.hyvideo import (hy_first_selection_mask,
                                                    make_hy_carve)
        rec = self.pick
        if rec is None:
            return None
        o = self.opts
        carve = make_hy_carve(self.model_cfg, self._grid(),
                              o.sa_drop_rates[0], o.p_remain, curve=o.curve,
                              txt_block_num=o.txt_block_num,
                              q_rows=o.q_group, joint_sel=o.joint_sel,
                              device=self.device)
        _, text, mask, pooled = self.inputs[rec["clip"]]
        t = float(self._sigmas()[rec["step"]] * 1000)
        g = (o.embedded_guidance_scale or 1.0) * 1000.0
        m = hy_first_selection_mask(
            self.sampler.model, rec["sample"][None],
            torch.full((1,), t, device=self.device), text[None],
            mask[None], pooled[None], carve,
            guidance=torch.full((1,), g, device=self.device))
        return float(m.float().mean())

    @torch.no_grad()
    def check(self) -> dict:
        """The numbers compared: the sampled window step."""
        rec = self.pick
        if rec is None:
            return {}
        group = self.weights_by_name()
        o = self.opts
        grid = self._grid()
        plan = ref.make_plan(self.config, grid,
                             build_curve_plan(grid, o.curve, 128),
                             drop=o.sa_drop_rates[0], p_remain=o.p_remain,
                             group=o.q_group, txt_blocks=o.txt_block_num)
        sig = self._sigmas()
        i = rec["step"]
        _, text, mask, pooled = self.inputs[rec["clip"]]
        x = rec["sample"].float()
        dt = float(sig[i + 1] - sig[i])

        def increment():
            return dt * ref.velocity(
                group, self.config, x, float(sig[i] * 1000), text, mask,
                pooled, plan, device=self.device,
                guidance=(o.embedded_guidance_scale or 1.0) * 1000.0)

        want = increment()
        if self.control == "fp8ref":
            # the reference in fp8 put in the program's place
            with RC.precision("fp8"):
                got = increment()
        else:
            got = rec["out"].float() - x
        return compare.step_numbers("step", got, want)

"""A Wan2.1 T2V cell: the port's ``WanSampler`` driven through
``pipeline.generate``, and its check against the plain reference.

The weights are the benchmark's (``traffic.weights``, one draw per group
on the card, in the configuration's dtype), with the aligned-attention
tie when the workload asks for it, handed to the sampler as its state
dict. Each clip takes VAE-like initial latents and random text states
(the prompt and the null prompt) drawn from its own seed.

The UniPC solver carries a state (the last x0 predictions) from step to
step. To judge a step, the solver's step function is observed: the
state, the velocity and the sample it is given and the sample it
returns. The reference then works out the guided velocity of the same
sample again and applies its own copy of the solver to the program's
state; the trajectory's start, step 0 from the benchmark's own initial
latents and a fresh state, is judged on its own.
"""

from __future__ import annotations

import dataclasses

import torch

from ..flops import wan as wan_flops
from ..reference import common as RC
from ..reference import unipc as ref_unipc
from ..reference import wan as ref
from ..reference.curves.blocks import build_curve_plan
from ..traffic import aligned, latents
from . import compare
from .base import CellBase

MODEL_KEYS = ("model_type", "patch_size", "text_len", "in_dim", "dim",
              "ffn_dim", "freq_dim", "text_dim", "out_dim", "num_heads",
              "num_layers", "qk_norm", "cross_attn_norm", "eps", "dtype")


class Cell(CellBase):
    """One Wan cell on one device."""

    reference = ref

    def __init__(self, config: dict, workload: dict, seed: int, device,
                 control: str | None = None):
        from jenga_tpu_torch.models.wan import WanConfig
        from jenga_tpu_torch.pipelines.wan_t2v import WanT2VOptions
        from jenga_tpu_torch.runtime import WanSampler

        super().__init__(config, workload, seed, device, control)
        model_cfg = {k: config[k] for k in MODEL_KEYS}
        model_cfg["patch_size"] = tuple(model_cfg["patch_size"])
        self.model_cfg = WanConfig(**model_cfg)
        self.sampler = WanSampler(self.model_cfg, params=self.all_weights(),
                                  device=self.device,
                                  model_id=config["model_id"])
        opts = dict(workload["sampler"])
        for key in ("size", "sa_drop_rates"):
            opts[key] = tuple(opts[key])
        self.opts = WanT2VOptions(**opts)
        w, h = self.opts.size
        self.latent_shape = (config["in_dim"], (self.opts.frame_num - 1) // 4
                             + 1, h // 8, w // 8)
        self.start = None       # step 0 of the first clip

    def tie(self, group):
        return aligned.tie_wan(group)

    def clip_inputs(self, clip: int):
        """(initial latents [C, F, H, W], prompt states, null states)."""
        gen = self.clip_generator(clip)
        x0 = latents.synth_latents(gen, (1, *self.latent_shape))[0]
        lc, ln = self.workload["text_tokens"]
        td = self.config["text_dim"]
        return (x0, latents.text_states(gen, lc, td),
                latents.text_states(gen, ln, td))

    def _context2(self, ctx, null):
        lt = self.config["text_len"]
        return torch.stack([torch.nn.functional.pad(
            c[:lt], (0, 0, 0, lt - c[:lt].shape[0])) for c in (ctx, null)])

    def run_clip(self, clip: int, on_step):
        """Run one clip through ``pipeline.generate``; ``on_step(i)`` after
        every step (it may raise to end the clip)."""
        from jenga_tpu_torch.diffusion import unipc as prog_unipc
        x0, ctx, null = self.clip_inputs(clip)
        self.inputs[clip] = (x0, ctx, null)
        original = prog_unipc.unipc_step

        def observed(schedule, state, velocity, sample):
            new_state, out = original(schedule, state, velocity, sample)
            rec = dict(clip=clip, step=state.step_index, state=state,
                       sample=sample, out=out)
            if clip == 0 and state.step_index == 0:
                self.start = rec
            self.offer(rec)
            return new_state, out

        opts = dataclasses.replace(self.opts, seed=self.clip_seed(clip))
        prog_unipc.unipc_step = observed
        try:
            self.sampler.pipeline.generate(
                ctx, null, opts, on_step=lambda i, _x: on_step(i),
                initial_latents=x0, decode=False)
        finally:
            prog_unipc.unipc_step = original

    # ----------------------------------------------------------- facts

    def facts(self) -> dict:
        return {"gemm_flop_per_step": wan_flops.gemm_flop(
                    self.config, self.latent_shape)}

    @torch.inference_mode()
    def density(self):
        """The planner's selected share of key blocks in the first block on
        the sampled step's input (the program's own diagnostic)."""
        from jenga_tpu_torch.models.wan import (make_wan_carve,
                                                wan_first_selection_mask)
        rec = self.pick
        if rec is None:
            return None
        carved, top_k = self._kind(rec["step"])
        if not carved:
            return None
        o = self.opts
        carve = make_wan_carve(self.model_cfg, self._grid(),
                               o.sa_drop_rates[0], o.p_remain, curve=o.curve,
                               q_rows=o.q_group, joint_sel=o.joint_sel,
                               device=self.device)
        x = rec["sample"][0]
        t = self._schedule().timestep(rec["step"])
        mask = wan_first_selection_mask(
            self.sampler.model, torch.stack([x, x]),
            torch.full((2,), t, device=self.device),
            self._context2(*self.inputs[rec["clip"]][1:]), carve, top_k)
        return float(mask.float().mean())

    # ----------------------------------------------------------- check

    def _grid(self):
        p = self.config["patch_size"]
        _, f, h, w = self.latent_shape
        return (f // p[0], h // p[1], w // p[2])

    def _schedule(self):
        return ref_unipc.unipc_schedule(self.opts.sampling_steps,
                                        shift=self.opts.shift)

    def _kind(self, step: int):
        g = self._grid()
        return ref.top_k_of(step, self.opts.sampling_steps,
                            self.opts.sa_drop_rates, g[0] * g[1] * g[2])

    @torch.no_grad()
    def check(self) -> dict:
        """The numbers compared: the sampled window step and the start."""
        group = self.weights_by_name()
        o = self.opts
        grid = self._grid()
        plan = ref.make_plan(self.config, grid,
                             build_curve_plan(grid, o.curve, RC.BLOCK),
                             p_remain=o.p_remain, group=o.q_group)
        sched = self._schedule()
        out = {}
        for tag, rec, fresh in (("step", self.pick, False),
                                ("start", self.start, True)):
            if rec is None:
                continue
            # the start takes the benchmark's own latents and a fresh state
            x = (self.inputs[rec["clip"]][0] if fresh
                 else rec["sample"][0]).float()
            ctx = self._context2(*self.inputs[rec["clip"]][1:])
            carved, top_k = self._kind(rec["step"])
            t = sched.timestep(rec["step"])
            state = ref_unipc.unipc_init(sched) if fresh else rec["state"]

            def increment():
                v = ref.velocity(group, self.config, x, t, ctx, plan,
                                 guide_scale=o.guide_scale, top_k=top_k,
                                 carved=carved, device=self.device)
                _, nxt = ref_unipc.unipc_step(sched, state, v[None], x[None])
                return nxt[0] - x

            want = increment()
            if self.control == "fp8ref":
                # the reference in fp8 put in the program's place
                with RC.precision("fp8"):
                    got = increment()
            else:
                got = rec["out"][0].float() - x
            out.update(compare.step_numbers(tag, got, want))
        return out

"""Wan2.1 text-to-video sampler: carved DiT + UniPC + TeaCache.

Port of ``jenga_tpu/pipelines/wan_t2v.py`` for the Base presets. CFG's
cond and uncond branches ride one batch of 2; every step's kind is fixed
on the host before the loop (``step_plan``):

  * ``dense``: the drop-rate warm-up (drop <= 0.25) runs the trunk with
    the carve's dense fallback, curve order kept;
  * ``carved``: the planner and the block-sparse kernel, with the
    warm-up's selection floor ``top_k = max(int(nb * (1 - drop)), 1)``;
  * ``skip``: TeaCache reuses the last computed trunk residual
    (``h1 - h0``, curve order) as ``head(embed + residual)``.

The TeaCache schedule is a pure function of the timestep sequence
(``jenga_tpu.diffusion.skip``); its metric is the relative L1 change of
the modulation embedding, computed here in torch. ``initial_latents`` and
``on_step`` let a test feed both implementations the same random draw and
watch the trajectory.

Not ported (each raises ``NotImplementedError``): Turbo's stage switch
(``enable_turbo``, with ProRes's trilinear resize) and the ``dpm++``
solver.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from jenga_tpu.configs.validate import validate_wan_options
from jenga_tpu.diffusion.skip import (TEACACHE_COEFFS,
                                      teacache_compute_schedule)

from ..diffusion.unipc import unipc_init, unipc_schedule, unipc_step
from ..models import wan as wan_lib

__all__ = ["WanT2VOptions", "WanT2VPipeline"]


@dataclasses.dataclass(frozen=True)
class WanT2VOptions:
    """Generation options (same fields and defaults as the JAX package)."""
    size: tuple[int, int] = (832, 480)      # (W, H) pixels
    frame_num: int = 81
    shift: float = 8.0
    sampling_steps: int = 50
    guide_scale: float = 6.0
    sa_drop_rates: tuple[float, ...] = (0.75, 0.85)
    p_remain: float = 0.9
    enable_turbo: bool = False
    turbo_switch_step: int = 25
    teacache_thresh: float | None = 0.15
    use_ret_steps: bool = True
    solver: str = "unipc"       # unipc | dpm++
    curve: str = "sliced"
    seed: int = 0
    q_group: int = 1    # >1: q_group query blocks share one block list
    joint_sel: bool = True  # q_group>1: one pooled selection per group


class WanT2VPipeline:
    """Sampler around a ``WanDiT``."""

    VAE_STRIDE = (4, 8, 8)

    def __init__(self, model: wan_lib.WanDiT):
        self.model = model
        self.cfg = model.cfg

    def _latent_shape(self, opts: WanT2VOptions):
        w, h = opts.size
        return (self.cfg.in_dim,
                (opts.frame_num - 1) // self.VAE_STRIDE[0] + 1,
                h // self.VAE_STRIDE[1], w // self.VAE_STRIDE[2])

    def _token_grid(self, latent_shape):
        _, f, h, w = latent_shape
        pt, ph, pw = self.cfg.patch_size
        return (f // pt, h // ph, w // pw)

    @staticmethod
    def _check(opts: WanT2VOptions):
        validate_wan_options(opts)
        if opts.enable_turbo:
            raise NotImplementedError(
                "Wan Turbo (a stage switch with a trilinear resize) is not "
                "ported yet")
        if opts.solver != "unipc":
            raise NotImplementedError(
                f"solver {opts.solver!r} is not ported (unipc only)")

    @torch.inference_mode()
    def _teacache_compute(self, timesteps, opts: WanT2VOptions):
        """Per-step compute (True) / skip (False) schedule."""
        if opts.teacache_thresh is None:
            return np.ones(len(timesteps), bool)
        model = self.model
        ts = torch.as_tensor(np.asarray(timesteps), dtype=torch.float32,
                             device=model.device)
        e = model.time_embed(ts)
        if opts.use_ret_steps:
            e = model.time_projection(torch.nn.functional.silu(e))
        embs = e.float().cpu().numpy()
        metrics = np.zeros(len(timesteps))
        for i in range(1, len(timesteps)):
            prev, cur = embs[i - 1], embs[i]
            metrics[i] = (np.abs(cur - prev).mean()
                          / max(np.abs(prev).mean(), 1e-12))
        # the 1.3B checkpoint's rescale polynomial (14B runs are not ported)
        coeffs = TEACACHE_COEFFS[("wan-t2v-1.3b", opts.use_ret_steps)]
        if opts.use_ret_steps:
            ret_steps, cutoff = 5, opts.sampling_steps
        else:
            ret_steps, cutoff = 1, opts.sampling_steps - 1
        return teacache_compute_schedule(metrics, opts.teacache_thresh,
                                         coeffs, ret_steps, cutoff)

    @staticmethod
    def _drop_rate(opts: WanT2VOptions, idx: int, n: int) -> float:
        """The warm-up ramp of the step's drop rate (the rate switches from
        the first to the last entry after ``turbo_switch_step``)."""
        rates = opts.sa_drop_rates
        base = rates[0] if idx <= opts.turbo_switch_step else rates[-1]
        return min(base, idx / max(n - 1, 1) * 10.0 * base)

    def step_plan(self, opts: WanT2VOptions) -> list[str]:
        """Each step's kind on the host: "dense", "carved" or "skip"."""
        self._check(opts)
        schedule = unipc_schedule(opts.sampling_steps, shift=opts.shift)
        n = schedule.num_steps
        compute = self._teacache_compute(
            [schedule.timestep(i) for i in range(n)], opts)
        kinds = []
        for idx in range(n):
            # a skip needs the residual of an earlier computed step
            if not compute[idx] and any(k != "skip" for k in kinds):
                kinds.append("skip")
            elif self._drop_rate(opts, idx, n) <= 0.25:
                kinds.append("dense")
            else:
                kinds.append("carved")
        return kinds

    @torch.inference_mode()
    def generate(self, context, context_null, opts: WanT2VOptions,
                 on_step=None, initial_latents=None):
        """Run the denoise loop; returns the final latents [C, F, H, W] f32.

        ``context`` / ``context_null`` are encoded prompts [L, text_dim]
        (unpadded; numpy or tensors). ``on_step(i, latents)`` is called
        after every step."""
        kinds = self.step_plan(opts)
        model, cfg = self.model, self.cfg
        dev = model.device
        latent_shape = self._latent_shape(opts)
        if initial_latents is not None:
            latents = torch.as_tensor(initial_latents, dtype=torch.float32,
                                      device=dev)[None]
        else:
            gen = torch.Generator(device=dev).manual_seed(opts.seed)
            latents = torch.randn((1, *latent_shape), generator=gen,
                                  device=dev)

        def pad_ctx(x):
            x = torch.as_tensor(x, dtype=torch.float32,
                                device=dev)[:cfg.text_len]
            return torch.nn.functional.pad(
                x, (0, 0, 0, cfg.text_len - x.shape[0]))
        ctx2 = torch.stack([pad_ctx(context), pad_ctx(context_null)])

        carve = wan_lib.make_wan_carve(
            cfg, self._token_grid(latent_shape), opts.sa_drop_rates[0],
            opts.p_remain, curve=opts.curve, q_rows=opts.q_group,
            joint_sel=opts.joint_sel, device=dev)
        dense_carve = dataclasses.replace(carve, sa_drop_rate=0.0)
        nb = math.ceil(carve.seqlen / 128)

        schedule = unipc_schedule(opts.sampling_steps, shift=opts.shift)
        state = unipc_init(schedule)
        n = schedule.num_steps
        residual = None
        for idx, kind in enumerate(kinds):
            t2 = torch.full((2,), schedule.timestep(idx), device=dev)
            x2 = torch.cat([latents, latents])
            h0, aux = model.embed(x2, t2, ctx2, carve)
            if kind == "skip":
                v2 = model.head(h0 + residual, aux, carve)
            else:
                if kind == "dense":
                    h1 = model.trunk(h0, aux, dense_carve)
                else:
                    drop = self._drop_rate(opts, idx, n)
                    top_k = max(int(nb * (1.0 - drop)), 1)
                    h1 = model.trunk(h0, aux, carve, top_k)
                residual = h1 - h0
                v2 = model.head(h1, aux, carve)
            v = v2[1:2] + opts.guide_scale * (v2[0:1] - v2[1:2])
            state, latents = unipc_step(schedule, state, v, latents)
            if on_step is not None:
                on_step(idx, latents[0])
        return latents[0]

"""Wan2.1 text-to-video sampler: carved DiT + UniPC + TeaCache + Turbo.

Port of ``jenga_tpu/pipelines/wan_t2v.py``. CFG's cond and uncond
branches ride one batch of 2; every step's kind is fixed on the host
before the loop (``step_plan``):

  * ``dense``: the drop-rate warm-up (drop <= 0.25) runs the trunk with
    the carve's dense fallback, curve order kept;
  * ``carved``: the planner and the block-sparse kernel, with the
    warm-up's selection floor ``top_k = max(int(nb * (1 - drop)), 1)``;
  * ``skip``: TeaCache reuses the last computed trunk residual
    (``h1 - h0``, curve order) as ``head(embed + residual)``.

Turbo (``enable_turbo``) runs the steps up to ``turbo_switch_step`` at
0.75 of the spatial size (rounded down to even), then reverts to x0 on
the current schedule, upsamples trilinearly, re-noises to the *current*
schedule's next sigma, and continues on a schedule shifted by 2 with a
fresh UniPC state (the reference's corrector reset). Each stage has its
own carve, both built with the first drop rate (the JAX quirk; ``top_k``
carries the step's real rate).

The TeaCache schedule is a pure function of the timesteps the model sees
(``diffusion/skip.py``), with the stage start forced; its metric
is the relative L1 change of the modulation embedding, computed here in
torch. ``initial_latents``, ``stage2_noise`` and ``on_step`` let a test
feed both implementations the same random draws and watch the trajectory.

Not ported: the ``dpm++`` solver (raises ``NotImplementedError``).
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from ..configs.validate import validate_wan_options
from ..diffusion.prores import trilinear_resize
from ..diffusion.skip import TEACACHE_COEFFS, teacache_compute_schedule
from ..diffusion.unipc import (unipc_add_noise, unipc_init, unipc_schedule,
                               unipc_step, unipc_step_to_zero)
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

    def _stage_latent_shapes(self, opts: WanT2VOptions):
        """The latent shape of each stage: Turbo's first stage runs at 0.75
        of the spatial size, rounded down to even."""
        c, f, lh, lw = self._latent_shape(opts)
        if not opts.enable_turbo:
            return [(c, f, lh, lw)]
        return [(c, f, int(lh * 0.75) // 2 * 2, int(lw * 0.75) // 2 * 2),
                (c, f, lh, lw)]

    def _token_grid(self, latent_shape):
        _, f, h, w = latent_shape
        pt, ph, pw = self.cfg.patch_size
        return (f // pt, h // ph, w // pw)

    @staticmethod
    def _check(opts: WanT2VOptions):
        validate_wan_options(opts)
        if opts.solver != "unipc":
            raise NotImplementedError(
                f"solver {opts.solver!r} is not ported (unipc only)")

    @staticmethod
    def _schedules(opts: WanT2VOptions):
        """The schedule of each stage (Turbo's second is shifted by 2)."""
        scheds = [unipc_schedule(opts.sampling_steps, shift=opts.shift)]
        if opts.enable_turbo:
            scheds.append(unipc_schedule(opts.sampling_steps,
                                         shift=opts.shift + 2))
        return scheds

    @torch.inference_mode()
    def _teacache_compute(self, timesteps, opts: WanT2VOptions,
                          stage_starts=()):
        """Per-step compute (True) / skip (False) schedule over the
        timesteps the model sees; ``stage_starts`` are forced."""
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
                                         coeffs, ret_steps, cutoff,
                                         stage_starts=stage_starts)

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
        scheds = self._schedules(opts)
        n = scheds[0].num_steps
        switch = opts.turbo_switch_step if opts.enable_turbo else None
        # after the switch the model sees the second schedule's timesteps
        realized = [scheds[-1 if switch is not None and i > switch else 0]
                    .timestep(i) for i in range(n)]
        compute = self._teacache_compute(
            realized, opts, stage_starts=() if switch is None
            else (switch + 1,))
        kinds = []
        residual = False    # a skip needs a residual computed in its stage
        for idx in range(n):
            if not compute[idx] and residual:
                kinds.append("skip")
            else:
                kinds.append("dense" if self._drop_rate(opts, idx, n) <= 0.25
                             else "carved")
                residual = True
            if idx == switch:
                residual = False
        return kinds

    @torch.inference_mode()
    def generate(self, context, context_null, opts: WanT2VOptions,
                 on_step=None, initial_latents=None, stage2_noise=None):
        """Run the denoise loop; returns the final latents [C, F, H, W] f32.

        ``context`` / ``context_null`` are encoded prompts [L, text_dim]
        (unpadded; numpy or tensors). ``on_step(i, latents)`` is called
        after every step. ``initial_latents`` (the first stage's shape)
        and, under Turbo, ``stage2_noise`` (the full shape) replace the
        draws from the generator seeded with ``opts.seed``, which draws
        the initial latents first and the switch's noise second."""
        kinds = self.step_plan(opts)
        model, cfg = self.model, self.cfg
        dev = model.device
        shapes = self._stage_latent_shapes(opts)
        switch = opts.turbo_switch_step if opts.enable_turbo else None
        gen = torch.Generator(device=dev).manual_seed(opts.seed)
        if initial_latents is not None:
            latents = torch.as_tensor(initial_latents, dtype=torch.float32,
                                      device=dev)[None]
        else:
            latents = torch.randn((1, *shapes[0]), generator=gen, device=dev)
        if switch is not None:
            if stage2_noise is not None:
                noise2 = torch.as_tensor(stage2_noise, dtype=torch.float32,
                                         device=dev)[None]
            else:
                noise2 = torch.randn((1, *shapes[1]), generator=gen,
                                     device=dev)

        def pad_ctx(x):
            x = torch.as_tensor(x, dtype=torch.float32,
                                device=dev)[:cfg.text_len]
            return torch.nn.functional.pad(
                x, (0, 0, 0, cfg.text_len - x.shape[0]))
        ctx2 = torch.stack([pad_ctx(context), pad_ctx(context_null)])

        carves = [wan_lib.make_wan_carve(
            cfg, self._token_grid(shape), opts.sa_drop_rates[0],
            opts.p_remain, curve=opts.curve, q_rows=opts.q_group,
            joint_sel=opts.joint_sel, device=dev) for shape in shapes]
        carve = carves[0]
        scheds = self._schedules(opts)
        schedule = scheds[0]
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
                    h1 = model.trunk(h0, aux, dataclasses.replace(
                        carve, sa_drop_rate=0.0))
                else:
                    drop = self._drop_rate(opts, idx, n)
                    nb = math.ceil(carve.seqlen / 128)
                    top_k = max(int(nb * (1.0 - drop)), 1)
                    h1 = model.trunk(h0, aux, carve, top_k)
                residual = h1 - h0
                v2 = model.head(h1, aux, carve)
            v = v2[1:2] + opts.guide_scale * (v2[0:1] - v2[1:2])
            if idx == switch:
                # x0, upsample, and re-noise on the first schedule's next
                # sigma; then the shifted schedule with a reset corrector
                clean = trilinear_resize(
                    unipc_step_to_zero(schedule, idx, v, latents),
                    shapes[1][1:])
                latents = unipc_add_noise(schedule, idx + 1, clean, noise2)
                schedule = scheds[1]
                state = dataclasses.replace(
                    unipc_init(schedule,
                               disable_corrector=tuple(range(24, 38))),
                    step_index=idx + 1)
                carve = carves[1]
                residual = None
            else:
                state, latents = unipc_step(schedule, state, v, latents)
            if on_step is not None:
                on_step(idx, latents[0])
        return latents[0]

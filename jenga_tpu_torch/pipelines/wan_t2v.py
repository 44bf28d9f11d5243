"""Wan2.1 text-to-video sampler: carved DiT + UniPC or DPM-Solver++ +
TeaCache + Turbo.

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
fresh solver state at the next step index: UniPC's with the reference's
corrector window ``disable_corrector=24..37``, DPM-Solver++'s with no
model outputs. Each stage has its own carve, both built with the first
drop rate (the JAX quirk; ``top_k`` carries the step's real rate).

``opts.solver`` picks the solver, ``unipc`` or ``dpm++`` (``_solver``).
The TeaCache schedule is a pure function of the timesteps the model sees
under that solver's schedules (``diffusion/skip.py``), with the stage
start forced; its metric is the relative L1 change of the modulation
embedding, computed here in torch, rescaled by the checkpoint's
polynomial, keyed by the pipeline's ``model_id`` and ``use_ret_steps``.
``initial_latents``, ``stage2_noise`` and ``on_step`` let a test feed both
implementations the same random draws and watch the trajectory. With a
sequence-parallel ``mesh`` every rank runs the loop on its slice of the
tokens (``WanDiT``'s ``mesh``); the TeaCache residual is the slice's, and
the velocity, the solver state and every draw are identical on every
rank.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from .. import obs
from ..configs.validate import validate_wan_options
from ..diffusion.prores import trilinear_resize
from ..diffusion.skip import TEACACHE_COEFFS, teacache_compute_schedule
from ..diffusion import dpm
from ..diffusion import unipc
from ..models import wan as wan_lib

__all__ = ["WanT2VOptions", "WanT2VPipeline"]


def _solver(name: str):
    """(schedule, init, step, step_to_zero, add_noise) of a solver name,
    ``unipc`` or ``dpm++`` (``dpm`` too, as in the JAX package)."""
    if name == "unipc":
        return (unipc.unipc_schedule, unipc.unipc_init, unipc.unipc_step,
                unipc.unipc_step_to_zero, unipc.unipc_add_noise)
    if name in ("dpm++", "dpm"):
        return (dpm.dpm_schedule, dpm.dpm_init, dpm.dpm_step,
                dpm.dpm_step_to_zero, dpm.dpm_add_noise)
    raise ValueError(f"unknown solver {name!r} (unipc | dpm++)")


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

    def __init__(self, model: wan_lib.WanDiT,
                 model_id: str = "wan-t2v-1.3b", vae_decode=None,
                 mesh=None):
        """``model_id`` names the checkpoint whose TeaCache polynomial the
        skip schedule uses (``TEACACHE_COEFFS``; an unknown id takes the
        1.3B one, as in the JAX package); ``vae_decode(latents)`` turns the
        final latents into the video that ``generate`` returns; ``mesh`` a
        sequence-parallel mesh (``parallel.make_sp_mesh``)."""
        self.model = model
        self.cfg = model.cfg
        self.model_id = model_id
        self.vae_decode = vae_decode
        self.mesh = mesh

    def _output(self, latents, decode: bool):
        """The decoded video when a VAE is attached and ``decode``, else
        the latents."""
        if decode and self.vae_decode is not None:
            return self.vae_decode(latents)
        return latents

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
    def _schedules(opts: WanT2VOptions):
        """The solver's schedule of each stage (Turbo's second is shifted
        by 2)."""
        mk_sched = _solver(opts.solver)[0]
        scheds = [mk_sched(opts.sampling_steps, shift=opts.shift)]
        if opts.enable_turbo:
            scheds.append(mk_sched(opts.sampling_steps, shift=opts.shift + 2))
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
        coeffs = self.teacache_coeffs(opts.use_ret_steps)
        if opts.use_ret_steps:
            ret_steps, cutoff = 5, opts.sampling_steps
        else:
            ret_steps, cutoff = 1, opts.sampling_steps - 1
        return teacache_compute_schedule(metrics, opts.teacache_thresh,
                                         coeffs, ret_steps, cutoff,
                                         stage_starts=stage_starts)

    def teacache_coeffs(self, use_ret_steps: bool):
        """The rescale polynomial of ``(model_id, use_ret_steps)``."""
        return TEACACHE_COEFFS.get(
            (self.model_id, use_ret_steps),
            TEACACHE_COEFFS[("wan-t2v-1.3b", use_ret_steps)])

    @staticmethod
    def _drop_rate(opts: WanT2VOptions, idx: int, n: int) -> float:
        """The warm-up ramp of the step's drop rate (the rate switches from
        the first to the last entry after ``turbo_switch_step``)."""
        rates = opts.sa_drop_rates
        base = rates[0] if idx <= opts.turbo_switch_step else rates[-1]
        return min(base, idx / max(n - 1, 1) * 10.0 * base)

    def step_plan(self, opts: WanT2VOptions) -> list[str]:
        """Each step's kind on the host: "dense", "carved" or "skip"."""
        validate_wan_options(opts)
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

    def _context2(self, context, context_null):
        """[2, text_len, text_dim]: the prompt and the null prompt, each
        cut or zero-padded to ``text_len``."""
        cfg, dev = self.cfg, self.model.device

        def pad_ctx(x):
            x = torch.as_tensor(x, dtype=torch.float32,
                                device=dev)[:cfg.text_len]
            return torch.nn.functional.pad(
                x, (0, 0, 0, cfg.text_len - x.shape[0]))
        return torch.stack([pad_ctx(context), pad_ctx(context_null)])

    def _carve(self, latent_shape, opts: WanT2VOptions):
        """A stage's carve, built with the first drop rate (the JAX quirk;
        ``top_k`` carries the step's real rate)."""
        return wan_lib.make_wan_carve(
            self.cfg, self._token_grid(latent_shape), opts.sa_drop_rates[0],
            opts.p_remain, curve=opts.curve, q_rows=opts.q_group,
            joint_sel=opts.joint_sel, device=self.model.device)

    @torch.inference_mode()
    def generate(self, context, context_null, opts: WanT2VOptions,
                 on_step=None, initial_latents=None, stage2_noise=None,
                 decode: bool = True):
        """Run the denoise loop; returns the final latents [C, F, H, W] f32,
        or with a VAE attached and ``decode`` the video [3, F', H', W'].

        ``context`` / ``context_null`` are encoded prompts [L, text_dim]
        (unpadded; numpy or tensors). ``on_step(i, latents)`` is called
        after every step. ``initial_latents`` (the first stage's shape)
        and, under Turbo, ``stage2_noise`` (the full shape) replace the
        draws from the generator seeded with ``opts.seed``, which draws
        the initial latents first and the switch's noise second."""
        kinds = self.step_plan(opts)
        dev = self.model.device
        shapes = self._stage_latent_shapes(opts)
        gen = torch.Generator(device=dev).manual_seed(opts.seed)
        if initial_latents is not None:
            latents = torch.as_tensor(initial_latents, dtype=torch.float32,
                                      device=dev)[None]
        else:
            latents = torch.randn((1, *shapes[0]), generator=gen, device=dev)
        noise2 = None
        if opts.enable_turbo:
            if stage2_noise is not None:
                noise2 = torch.as_tensor(stage2_noise, dtype=torch.float32,
                                         device=dev)[None]
            else:
                noise2 = torch.randn((1, *shapes[1]), generator=gen,
                                     device=dev)
        carves = [self._carve(shape, opts) for shape in shapes]
        return self._output(self._denoise(kinds, latents, self._context2(
            context, context_null), carves, opts, on_step, noise2), decode)

    def _denoise(self, kinds, latents, ctx2, carves, opts, on_step,
                 noise2=None, **cond):
        """The solver loop over the host's step plan, CFG on a batch of 2;
        ``cond`` holds the I2V inputs (``clip_fea``, ``y``, batch 2) that
        every embed takes."""
        model, mesh = self.model, self.mesh
        dev = model.device
        switch = opts.turbo_switch_step if opts.enable_turbo else None
        carve = carves[0]
        _, mk_init, do_step, to_zero, add_noise = _solver(opts.solver)
        scheds = self._schedules(opts)
        schedule = scheds[0]
        state = mk_init(schedule)
        n = schedule.num_steps
        residual = None
        clip = obs.next_clip()
        for idx, kind in enumerate(kinds):
            with obs.step(clip, idx, kind):
                t2 = torch.full((2,), schedule.timestep(idx), device=dev)
                x2 = torch.cat([latents, latents])
                h0, aux = model.embed(x2, t2, ctx2, carve, mesh=mesh, **cond)
                if kind == "skip":
                    v2 = model.head(h0 + residual, aux, carve, mesh)
                else:
                    if kind == "dense":
                        h1 = model.trunk(h0, aux, dataclasses.replace(
                            carve, sa_drop_rate=0.0), mesh=mesh)
                    else:
                        drop = self._drop_rate(opts, idx, n)
                        nb = math.ceil(carve.seqlen / 128)
                        top_k = max(int(nb * (1.0 - drop)), 1)
                        h1 = model.trunk(h0, aux, carve, top_k, mesh)
                    residual = h1 - h0
                    v2 = model.head(h1, aux, carve, mesh)
                with obs.span("guidance"):
                    v = v2[1:2] + opts.guide_scale * (v2[0:1] - v2[1:2])
                with obs.span("solver"):
                    if idx == switch:
                        # x0, upsample, and re-noise on the first schedule's
                        # next sigma; then the shifted schedule with a fresh
                        # state (UniPC with the reference's corrector window)
                        clean = trilinear_resize(
                            to_zero(schedule, idx, v, latents),
                            noise2.shape[2:])
                        latents = add_noise(schedule, idx + 1, clean, noise2)
                        schedule = scheds[1]
                        state = mk_init(schedule)
                        if opts.solver == "unipc":
                            state = dataclasses.replace(
                                state, disable_corrector=tuple(range(24, 38)))
                        state = dataclasses.replace(state,
                                                    step_index=idx + 1)
                        carve = carves[1]
                        residual = None
                    else:
                        state, latents = do_step(schedule, state, v, latents)
            if on_step is not None:
                on_step(idx, latents[0])
        return latents[0]

"""HunyuanVideo T2V sampler: ProRes stage machine + carved MMDiT + step
skipping.

Port of ``jenga_tpu/pipelines/hyvideo_t2v.py``. Each stage gets its own
curve plan and carving spec; fixed-list skipping caches the curve-ordered
image-stream trunk residual and stage starts force a compute step; the
text-amplitude bias is ``-log2(sqrt(token_diff)) * scale`` at reduced
resolution (stage 0 only) and 0 at full. A switch out of a reduced-
resolution stage (ProRes: Turbo, Flash, 3Stage, AccVideo) re-shifts the
schedule to the new stage's shift first, then reverts the latents to x0
on the new schedule, upsamples them trilinearly and re-noises them to the
next step's sigma, with no Euler step; a switch between full-resolution
stages (Base) takes the Euler step. The ``initial_latents`` and
``stage_noises`` hooks let a test feed both implementations the same
random draws. With a sequence-parallel ``mesh`` every rank runs the loop:
the model slices the image tokens after ``embed`` and gathers them before
``head``, so the cached residual is this rank's slice and the velocity,
the scheduler and every draw are identical on every rank.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from .. import obs
from ..configs.validate import validate_hy_options
from ..diffusion.flow_match import flow_match_schedule
from ..diffusion.prores import trilinear_resize
from ..diffusion.skip import HYVIDEO_NON_SKIP_STEPS, fixed_compute_schedule
from ..models import hyvideo as hy

__all__ = ["HYT2VOptions", "HYVideoT2VPipeline"]


@dataclasses.dataclass(frozen=True)
class HYT2VOptions:
    """Generation options (same fields and defaults as the JAX package)."""
    size: tuple[int, int] = (1280, 720)     # (W, H) pixels
    video_length: int = 125                 # frames (4k+1)
    num_inference_steps: int = 50
    flow_shift: float = 7.0
    embedded_guidance_scale: float | None = 6.0
    guidance_scale: float = 1.0             # CFG (off for distilled)
    sa_drop_rates: tuple[float, ...] = (0.75, 0.85)
    p_remain: float = 0.3
    res_rate_list: tuple[float, ...] = (1.0, 1.0)
    step_rate_list: tuple[float, ...] = (0.5, 1.0)
    scheduler_shift_list: tuple[float, ...] = (7.0, 7.0)
    scale_txt_amp: float = 1.0
    txt_block_num: int = 2
    enable_skip: bool = True
    non_skip_steps: tuple[int, ...] = HYVIDEO_NON_SKIP_STEPS
    curve: str = "gilbert"
    seed: int = 0
    q_group: int = 1        # >1: q_group query blocks share one block list
    joint_sel: bool = True  # q_group>1: one pooled selection per group


class HYVideoT2VPipeline:
    """Sampler around a ``HYVideoDiT``."""

    VAE_STRIDE = (4, 8, 8)  # the "884" causal VAE

    def __init__(self, model: hy.HYVideoDiT, vae_decode=None, mesh=None):
        """``vae_decode(latents)`` turns the final latents into the video
        that ``generate`` returns (the sampler's ``decode_latents``);
        ``mesh`` a sequence-parallel mesh (``parallel.make_sp_mesh``)."""
        self.model = model
        self.cfg = model.cfg
        self.vae_decode = vae_decode
        self.mesh = mesh

    def _output(self, latents, decode: bool):
        """The decoded video when a VAE is attached and ``decode``, else
        the latents."""
        if decode and self.vae_decode is not None:
            return self.vae_decode(latents)
        return latents

    def _stage_shapes(self, opts: HYT2VOptions):
        """Latent shape and token grid per stage."""
        w, h = opts.size
        lt = 1 + (opts.video_length - 1) // self.VAE_STRIDE[0]
        shapes = []
        for rate in opts.res_rate_list:
            ph, pw = int(h * rate), int(w * rate)
            shapes.append(((lt, ph // 16 * 2, pw // 16 * 2),
                           (lt, ph // 16, pw // 16)))
        return shapes

    @staticmethod
    def compute_schedule(opts: HYT2VOptions) -> np.ndarray:
        """Per-step compute (True) / skip (False) on the host: the fixed
        list, with every stage start forced (a switch happens after the
        forward at step s, so step s + 1 starts the stage)."""
        n = opts.num_inference_steps
        if not opts.enable_skip:
            return np.ones(n, bool)
        return fixed_compute_schedule(
            n, opts.non_skip_steps,
            stage_starts=[int(n * r) + 1 for r in opts.step_rate_list])

    @staticmethod
    def _step_kind(skip: bool, carve, grid, txt_len: int) -> str:
        """A step's kind for its span: skip, carved or dense."""
        if skip:
            return "skip"
        return "carved" if hy._carves(carve, math.prod(grid) + txt_len) \
            else "dense"

    @torch.inference_mode()
    def generate(self, text_states, text_mask, text_states_2,
                 opts: HYT2VOptions, negative=None, on_step=None,
                 initial_latents=None, stage_noises=None,
                 decode: bool = True):
        """Run the denoise loop; returns the final latents [C, F, H, W] f32,
        or with a VAE attached and ``decode`` the video [3, F', H', W'].

        ``text_states`` [L, 4096], ``text_mask`` [L], ``text_states_2``
        [768] (numpy or tensors); ``negative`` an optional matching triple
        for CFG. ``on_step(i, latents)`` is called after every step.
        ``initial_latents`` [C, F, H, W] replaces the stage-0 draw and
        ``stage_noises`` maps a stage index (1..) to its [C, F, H, W]
        re-noise draw; otherwise both come from one generator seeded with
        ``opts.seed``, the re-noise draws after the initial latents."""
        validate_hy_options(opts)
        # the first schedule uses flow_shift; scheduler_shift_list only
        # drives the re-shifts at ProRes switches
        return self._output(self._denoise(
            text_states, text_mask, text_states_2, opts, opts.flow_shift,
            negative, on_step, initial_latents, stage_noises), decode)

    def _denoise(self, text_states, text_mask, text_states_2, opts, shift0,
                 negative, on_step, initial_latents, stage_noises,
                 prepare=None, model_input=None, pin=None):
        """The Euler loop over the ProRes stages. Three hooks for I2V, each
        taking the stage index: ``prepare(latents, 0)`` once on the drawn
        latents, ``model_input(latents, stage)`` for the model's input,
        and ``pin(latents, stage)`` after each step and each re-noise."""
        model, cfg = self.model, self.cfg
        dev = model.device
        shapes = self._stage_shapes(opts)
        n = opts.num_inference_steps
        splits = [int(n * r) for r in opts.step_rate_list]
        cfg_on = negative is not None and opts.guidance_scale > 1.0
        batch = 2 if cfg_on else 1
        nc = cfg.out_channels   # the latents' channels

        def stack(pos, neg, dtype=None):
            a = torch.as_tensor(pos, device=dev, dtype=dtype)[None]
            if not cfg_on:
                return a
            b = torch.as_tensor(neg, device=dev, dtype=dtype)
            return torch.cat([b[None], a])

        txt = stack(text_states, negative[0] if cfg_on else None,
                    torch.float32)
        mask = stack(text_mask, negative[1] if cfg_on else None, torch.int32)
        txt2 = stack(text_states_2, negative[2] if cfg_on else None,
                     torch.float32)
        guidance = None
        if cfg.guidance_embed:
            g = (opts.embedded_guidance_scale or 1.0) * 1000.0
            guidance = torch.full((batch,), g, device=dev)

        full_grid = shapes[-1][1]
        token_full = full_grid[1] * full_grid[2]
        carves = []
        for si, (_, grid) in enumerate(shapes):
            token_diff = (grid[1] * grid[2]) / token_full
            text_amp = (0.0 if token_diff == 1.0 or si > 0 else
                        -math.log2(math.sqrt(token_diff))
                        * opts.scale_txt_amp)
            carves.append(hy.make_hy_carve(
                cfg, grid, opts.sa_drop_rates[min(si, len(
                    opts.sa_drop_rates) - 1)],
                opts.p_remain, curve=opts.curve, text_amp=text_amp,
                txt_block_num=opts.txt_block_num, q_rows=opts.q_group,
                joint_sel=opts.joint_sel, device=dev))

        compute = self.compute_schedule(opts)

        gen = torch.Generator(device=dev).manual_seed(opts.seed)
        if initial_latents is not None:
            latents = torch.as_tensor(initial_latents, dtype=torch.float32,
                                      device=dev)[None]
        else:
            latents = torch.randn((1, nc, *shapes[0][0]), generator=gen,
                                  device=dev)
        if prepare is not None:
            latents = prepare(latents, 0)

        schedule = flow_match_schedule(n, shift=shift0)
        stage_idx = 0
        residual = None
        carve = carves[0]
        clip = obs.next_clip()
        for i in range(n):
            skip = not compute[i] and residual is not None
            with obs.step(clip, i, self._step_kind(skip, carve, shapes[
                    stage_idx][1], txt.shape[1])):
                t = torch.full((batch,), schedule.timestep(i), device=dev)
                x = latents if model_input is None else model_input(
                    latents, stage_idx)
                x = x.expand(batch, *x.shape[1:])
                img, txth, aux = model.embed(x, t, txt, mask, txt2, carve,
                                             guidance, self.mesh)
                if skip:
                    v = model.head(img + residual, aux, carve, self.mesh)
                else:
                    img2 = model.trunk(img, txth, aux, carve, mesh=self.mesh)
                    residual = img2 - img
                    v = model.head(img2, aux, carve, self.mesh)
                if cfg_on:
                    with obs.span("guidance"):
                        v = v[0:1] + opts.guidance_scale * (v[1:2] - v[0:1])
                switch = i in splits and stage_idx + 1 < len(carves)
                if switch:
                    stage_idx += 1
                    carve = carves[stage_idx]
                    residual = None
                with obs.span("solver"):
                    if switch and opts.res_rate_list[stage_idx - 1] != 1.0:
                        # re-shift first: the x0 revert uses the new schedule
                        schedule = flow_match_schedule(
                            n, shift=opts.scheduler_shift_list[stage_idx])
                        lat_shape = (1, nc, *shapes[stage_idx][0])
                        if (stage_noises is not None
                                and stage_idx in stage_noises):
                            noise = torch.as_tensor(
                                stage_noises[stage_idx], dtype=torch.float32,
                                device=dev)[None]
                        else:
                            noise = torch.randn(lat_shape, generator=gen,
                                                device=dev)
                        clean = trilinear_resize(
                            schedule.predict_x0(i, latents, v), lat_shape[2:])
                        latents = schedule.renoise_to_step(i + 1, clean,
                                                           noise)
                    else:
                        latents = schedule.step(i, latents, v)
                if pin is not None:
                    latents = pin(latents, stage_idx)
            if on_step is not None:
                on_step(i, latents[0])
        return latents[0]

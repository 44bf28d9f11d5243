"""HunyuanVideo image-to-video sampler (token_replace and latent_concat).

Port of ``jenga_tpu/pipelines/hyvideo_i2v.py``. It runs the T2V ProRes
stage machine (``HYVideoT2VPipeline``: stage shapes, carves, fixed-list
skipping, the switch) with the I2V conditioning:

  * one clean conditioning latent [16, 1, h, w] per ProRes stage, at
    that stage's latent size;
  * ``token_replace``: the image latent is pinned as frame 0 after every
    Euler step and every re-noise (the solver's frame 0 is discarded),
    and the model gives the first frame's tokens the t=0 modulation;
  * ``latent_concat``: the image latent (frame 0, zeros after) and a
    one-channel first-frame mask ride along as input channels, 16 + 16 +
    1 = 33;
  * ``i2v_stability``: the initial noise is blended with the image latent
    (x = 0.999 n + 0.001 img).

The first schedule takes ``scheduler_shift_list[0]`` (T2V takes
``flow_shift``). The text block count follows the text states given:
``generate_i2v`` sets ``txt_block_num`` to ceil(text tokens / 128) (the
llava states of an image prompt are ~396 tokens under token_replace and
~540 under latent_concat, the zero states 256), where the JAX package
keeps the options' count and its planner fails on the longer states. The ``initial_latents`` / ``stage_noises`` hooks carry
the raw normal draws, before the stability blend and the pinning.

``generate_crop_size_list`` and ``get_closest_ratio`` (aspect-ratio
buckets) are copies of the JAX package's functions of the same names.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..configs.validate import validate_hy_options
from ..diffusion.skip import HYI2V_STEP_CALC
from .hyvideo_t2v import HYT2VOptions, HYVideoT2VPipeline

__all__ = ["HYI2VOptions", "HYVideoI2VPipeline", "get_closest_ratio",
           "generate_crop_size_list", "text_block_count"]


def generate_crop_size_list(base_size: int = 256, patch_size: int = 16,
                            max_ratio: float = 4.0):
    """Every (w, h) bucket with the base grid's patch count and an aspect
    ratio within ``max_ratio`` (copy of the JAX package's function)."""
    num_patches = round((base_size / patch_size) ** 2)
    if max_ratio < 1.0:
        raise ValueError(f"max_ratio {max_ratio} < 1")
    crop_size_list = []
    wp, hp = num_patches, 1
    while wp > 0:
        if max(wp, hp) / min(wp, hp) <= max_ratio:
            crop_size_list.append((wp * patch_size, hp * patch_size))
        if (hp + 1) * wp <= num_patches:
            hp += 1
        else:
            wp -= 1
    return crop_size_list


def get_closest_ratio(height: float, width: float, ratios, buckets):
    """The bucket whose aspect ratio is closest to height / width (copy of
    the JAX package's function)."""
    aspect = float(height) / float(width)
    idx = int(np.argmin([abs(aspect - r) for r in ratios]))
    return buckets[idx], ratios[idx]


def text_block_count(text_states, negative=None) -> int:
    """The joint sequence's text blocks for these text states:
    ceil(tokens / 128), the count at which the text rows cover every text
    token. The negative prompt's states (CFG) share the count, so they
    must have as many tokens; else this raises ``ValueError``."""
    n = int(text_states.shape[-2])
    if negative is not None and int(negative[0].shape[-2]) != n:
        raise ValueError(
            f"the negative text states have {int(negative[0].shape[-2])} "
            f"tokens and the positive {n}: one txt_block_num cannot serve "
            f"both")
    return -(-n // 128)


@dataclasses.dataclass(frozen=True)
class HYI2VOptions(HYT2VOptions):
    """Generation options (same fields and defaults as the JAX package)."""
    i2v_condition_type: str = "token_replace"   # | latent_concat
    i2v_stability: bool = True
    flow_shift: float = 5.0
    # the reference's i2v preset: initial shift 5.0, stage re-shifts 7 7
    scheduler_shift_list: tuple[float, ...] = (7.0, 7.0)
    non_skip_steps: tuple[int, ...] = HYI2V_STEP_CALC
    txt_block_num: int = 4      # generate_i2v sets it from the text states


class HYVideoI2VPipeline(HYVideoT2VPipeline):
    """I2V sampler around a ``HYVideoDiT`` whose config matches the
    condition type (``hy_i2v_config``)."""

    def _check_model(self, cond: str):
        cfg = self.cfg
        want = ((16, "token_replace") if cond == "token_replace"
                else (33, None))
        if (cfg.in_channels, cfg.i2v_condition_type) != want:
            raise ValueError(
                f"{cond} needs a model with in_channels={want[0]} and "
                f"i2v_condition_type={want[1]!r} (hy_i2v_config), got "
                f"{cfg.in_channels} and {cfg.i2v_condition_type!r}")

    @torch.inference_mode()
    def generate_i2v(self, image_latents, text_states, text_mask,
                     text_states_2, opts: HYI2VOptions, negative=None,
                     on_step=None, initial_latents=None, stage_noises=None,
                     decode: bool = True):
        """Run the denoise loop; returns the final latents [16, F, H, W], or
        with a VAE attached and ``decode`` the video [3, F', H', W'].

        ``image_latents``: one clean [16, 1, h, w] latent per ProRes stage,
        at that stage's latent size (numpy or tensors). The text inputs,
        ``negative``, ``on_step``, ``initial_latents`` and
        ``stage_noises`` are as in ``generate``; the two draws are taken
        before the stability blend. ``opts.txt_block_num`` is replaced by
        ``text_block_count`` of the text states."""
        opts = dataclasses.replace(
            opts, txt_block_num=text_block_count(text_states, negative))
        validate_hy_options(opts)
        cond = opts.i2v_condition_type
        self._check_model(cond)
        dev = self.model.device
        shapes = self._stage_shapes(opts)
        if len(image_latents) != len(shapes):
            raise ValueError(f"{len(image_latents)} conditioning latents for "
                             f"{len(shapes)} ProRes stages")
        img = []
        for (lat, _), il in zip(shapes, image_latents):
            il = torch.as_tensor(il, dtype=torch.float32, device=dev)[None]
            if tuple(il.shape) != (1, 16, 1, *lat[1:]):
                raise ValueError(f"conditioning latent {tuple(il.shape[1:])} "
                                 f"!= (16, 1, {lat[1]}, {lat[2]})")
            img.append(il)

        def pin(latents, stage):
            if cond != "token_replace":
                return latents
            return torch.cat([img[stage], latents[:, :, 1:]], dim=2)

        def prepare(latents, stage):
            if opts.i2v_stability:
                latents = latents * 0.999 + img[stage] * (1 - 0.999)
            return pin(latents, stage)

        def model_input(latents, stage):
            rep = torch.zeros_like(latents)
            rep[:, :, :1] = img[stage]
            m = torch.zeros_like(latents[:, :1])
            m[:, :, 0] = 1.0
            return torch.cat([latents, rep, m], dim=1)

        return self._output(self._denoise(
            text_states, text_mask, text_states_2, opts,
            opts.scheduler_shift_list[0], negative, on_step,
            initial_latents, stage_noises, prepare=prepare,
            model_input=model_input if cond == "latent_concat" else None,
            pin=pin), decode)

"""Wan2.1 image-to-video sampler: CLIP image tokens and the first-frame
conditioning ``y``.

Port of ``jenga_tpu/pipelines/wan_i2v.py``. The conditioning ``y``
concatenates a 4-channel temporal mask (the first frame 1, grouped by the
VAE's 4x temporal stride) with the image latent (the first frame's VAE
encoding, zero frames after it), so the DiT sees 16 + 4 + 16 = 36 input
channels; the CLIP ViT features of the image enter through the decoupled
image cross-attention. Carving, the dense warm-up and TeaCache are the
T2V sampler's (``WanT2VPipeline.step_plan`` and its loop), over one
stage: I2V has no Turbo switch. ``WanI2VOptions(solver=...)`` picks UniPC
or DPM-Solver++ as in T2V (the JAX ``wan-i2v`` command has no solver
flag, and neither has the port's).

``build_i2v_mask`` and ``i2v_latent_size`` are numpy copies of the JAX
package's functions of the same names, held to them value for value by
the tests.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .wan_t2v import WanT2VOptions, WanT2VPipeline

__all__ = ["WanI2VOptions", "WanI2VPipeline", "build_i2v_mask",
           "i2v_latent_size"]


@dataclasses.dataclass(frozen=True)
class WanI2VOptions(WanT2VOptions):
    """Generation options (same fields and defaults as the JAX package)."""
    max_area: int = 720 * 1280
    shift: float = 5.0          # 3.0 for 480p-class areas (the CLI's rule)
    sampling_steps: int = 40
    guide_scale: float = 5.0
    enable_turbo: bool = False


def i2v_latent_size(img_h: int, img_w: int, max_area: int,
                    vae_stride=(4, 8, 8), patch=(1, 2, 2)):
    """Latent (h, w) of an image under the max-area budget (copy of
    ``jenga_tpu.pipelines.wan_i2v.i2v_latent_size``)."""
    aspect = img_h / img_w
    lat_h = round(np.sqrt(max_area * aspect) // vae_stride[1] //
                  patch[1] * patch[1])
    lat_w = round(np.sqrt(max_area / aspect) // vae_stride[2] //
                  patch[2] * patch[2])
    return int(lat_h), int(lat_w)


def build_i2v_mask(frame_num: int, lat_h: int, lat_w: int,
                   t_stride: int = 4):
    """The 4-channel first-frame mask in latent time [t_stride, T_lat, h,
    w]: frame 0 repeated t_stride times, then zeros (copy of
    ``jenga_tpu.pipelines.wan_i2v.build_i2v_mask``)."""
    msk = np.ones((frame_num, lat_h, lat_w), np.float32)
    msk[1:] = 0.0
    msk = np.concatenate([np.repeat(msk[0:1], t_stride, axis=0), msk[1:]])
    t_lat = msk.shape[0] // t_stride
    msk = msk.reshape(t_lat, t_stride, lat_h, lat_w).transpose(1, 0, 2, 3)
    return msk


class WanI2VPipeline(WanT2VPipeline):
    """Sampler around an I2V ``WanDiT`` (``model_type="i2v"``, in_dim 36)."""

    @torch.inference_mode()
    def generate_i2v(self, image_latent, clip_fea, context, context_null,
                     frame_num: int, lat_h: int, lat_w: int,
                     opts: WanI2VOptions, on_step=None,
                     initial_latents=None, decode: bool = True):
        """Run the denoise loop; returns the final latents [16, T_lat,
        lat_h, lat_w] f32, or with a VAE attached and ``decode`` the video
        [3, frame_num, 8 lat_h, 8 lat_w].

        ``image_latent`` [16, T_lat, lat_h, lat_w] is the VAE encoding of
        the first frame followed by zero frames; ``clip_fea`` [257, 1280]
        the CLIP image tokens; ``context`` / ``context_null`` the encoded
        prompts [L, text_dim]. ``initial_latents`` [16, T_lat, lat_h,
        lat_w] replaces the draw from the generator seeded with
        ``opts.seed``."""
        if opts.enable_turbo:
            raise ValueError("the I2V sampler has no Turbo stage switch "
                             "(enable_turbo must be False)")
        if self.cfg.model_type != "i2v":
            raise ValueError("generate_i2v needs an I2V model "
                             "(model_type='i2v')")
        kinds = self.step_plan(opts)
        dev = self.model.device
        t_lat = (frame_num - 1) // self.VAE_STRIDE[0] + 1
        shape = (16, t_lat, lat_h, lat_w)
        if initial_latents is not None:
            latents = torch.as_tensor(initial_latents, dtype=torch.float32,
                                      device=dev)[None]
        else:
            gen = torch.Generator(device=dev).manual_seed(opts.seed)
            latents = torch.randn((1, *shape), generator=gen, device=dev)
        if tuple(latents.shape[1:]) != shape:
            raise ValueError(f"initial latents {tuple(latents.shape[1:])} "
                             f"!= {shape}")

        msk = torch.as_tensor(build_i2v_mask(frame_num, lat_h, lat_w),
                              device=dev)
        y = torch.cat([msk, torch.as_tensor(image_latent, dtype=torch.float32,
                                            device=dev)])
        clip = torch.as_tensor(clip_fea, dtype=torch.float32, device=dev)
        return self._output(self._denoise(
            kinds, latents, self._context2(context, context_null),
            [self._carve(shape, opts)], opts, on_step,
            y=torch.stack([y, y]), clip_fea=torch.stack([clip, clip])),
            decode)

"""Sampler entry points of the port.

``HunyuanVideoSampler(cfg, params=None, device=..., i2v=False,
use_fp8=False, vae=None)`` and ``WanSampler(cfg, params=None, device=...,
model_id=..., vae=None)`` build their DiT on ``device`` from a converted
state dict
(``convert.hyvideo_params_from_jax`` / ``convert.wan_params_from_jax``)
or, with ``params=None``, from a seeded random init on the device itself.
HunyuanVideo's ``use_fp8`` then quantizes the large linear weights to e4m3
in place (``models/fp8.py``); Wan has no such flag in the JAX package, and
its model takes ``quantize_tree_fp8`` directly.
``WanSampler.from_task`` builds a published Wan config by task name with
its TeaCache ``model_id``, as the JAX package's ``from_pretrained`` does.
``predict`` / ``predict_i2v`` / ``generate`` / ``generate_i2v`` take
pre-encoded text states (and, for I2V, conditioning latents and CLIP
features). ``vae`` is a VAE module on the sampler's device
(``codec.vae_hy.HYVAE`` / ``codec.vae_wan.WanVAE``, from a converted
state dict or a seeded init) or None: with one, the pipelines return the
decoded video [3, F, H, W] in [-1, 1] unless called with ``decode=False``,
and ``encode_image_latent`` gives the I2V conditioning latent of an image;
without one, ``decode_latents`` returns the latents, as in the JAX
package. ``load_image`` reads an image file (PIL). ``from_pretrained``,
the text encoders and the CLIP image tower wait until checkpoints are
part of the port.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from .codec import vae_hy, vae_wan
from .models import wan as wan_lib
from .models.fp8 import quantize_tree_fp8
from .models.hyvideo import HYVideoConfig, HYVideoDiT, init_hyvideo_
from .models.wan import WanConfig, WanDiT, init_wan_
from .pipelines.hyvideo_i2v import HYVideoI2VPipeline
from .pipelines.hyvideo_t2v import HYVideoT2VPipeline
from .pipelines.wan_i2v import WanI2VPipeline
from .pipelines.wan_t2v import WanT2VPipeline

__all__ = ["HunyuanVideoSampler", "WanSampler", "resolve_device",
           "load_image"]


def resolve_device(device) -> torch.device:
    """The device to run on; ``cuda`` without a card raises (there is no
    CPU fallback)."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("device 'cuda' requested but no CUDA device is "
                           "available (use --device cpu for a CPU run)")
    return device


def load_image(path: str) -> np.ndarray:
    """Image file -> [3, H, W] f32 in [0, 1] (RGB)."""
    from PIL import Image
    img = Image.open(path).convert("RGB")
    return np.asarray(img, np.float32).transpose(2, 0, 1) / 255.0


def _resize_chw(img, h: int, w: int, device) -> torch.Tensor:
    """[C, H, W] -> [C, h, w] f32 on ``device``: the counterpart of
    ``jax.image.resize(..., "cubic")`` (Keys cubic, a = -0.5, with the
    kernel widened when downsampling), which is torch's antialiased
    bicubic; without ``antialias`` torch's bicubic takes a = -0.75 and no
    widening."""
    x = torch.as_tensor(img, dtype=torch.float32, device=device)
    return F.interpolate(x[None], size=(h, w), mode="bicubic",
                         align_corners=False, antialias=True)[0]


def _build(model_cls, init_fn, cfg, params, device, seed):
    model = model_cls(cfg, device=device)
    if params is None:
        init_fn(model, torch.Generator(device=device).manual_seed(seed))
    else:
        model.load_state_dict(params, strict=True)
    return model


class HunyuanVideoSampler:
    """T2V (or, with ``i2v``, I2V) sampler for HunyuanVideo."""

    TEXT_LEN = 256

    def __init__(self, cfg: HYVideoConfig, params=None, device="cuda",
                 seed: int = 0, i2v: bool = False, use_fp8: bool = False,
                 vae: vae_hy.HYVAE | None = None):
        self.cfg = cfg
        self.vae = vae
        self.device = resolve_device(device)
        self.model = _build(HYVideoDiT, init_hyvideo_, cfg, params,
                            self.device, seed)
        if use_fp8:
            # after the init or load, as the JAX from_pretrained does
            quantize_tree_fp8(self.model)
        pipe_cls = HYVideoI2VPipeline if i2v else HYVideoT2VPipeline
        self.pipeline = pipe_cls(self.model, vae_decode=self.decode_latents)

    def decode_latents(self, latents):
        """latents [16, T, h, w] -> video [3, F, H, W] in [-1, 1] by the
        tiled decode; the latents themselves without a VAE."""
        if self.vae is None:
            return latents
        z = torch.as_tensor(latents, dtype=torch.float32,
                            device=self.vae.device)[None]
        video = vae_hy.vae_decode_tiled(self.vae,
                                        z / self.vae.cfg.scaling_factor)
        return video[0].clamp(-1.0, 1.0)

    def encode_image_latent(self, image, lat_h: int, lat_w: int):
        """[3, H, W] f32 in [0, 1] -> [16, 1, lat_h, lat_w] scaled latent
        (the I2V per-stage conditioning latent, the distribution's mode)."""
        if self.vae is None:
            raise RuntimeError("no VAE attached (HunyuanVideoSampler(..., "
                               "vae=...))")
        x = _resize_chw(image, lat_h * 8, lat_w * 8, self.vae.device)
        x = (x * 2.0 - 1.0)[None, :, None]      # [1, 3, 1, H, W]
        moments = vae_hy.vae_encode_tiled(self.vae, x)
        mean = vae_hy.gaussian_sample(moments)
        return mean[0] * self.vae.cfg.scaling_factor

    def predict(self, text_states, text_mask, text_states_2, opts,
                negative=None, **kw):
        """Pre-encoded entry point; returns final latents [C, F, H, W]."""
        return self.pipeline.generate(text_states, text_mask, text_states_2,
                                      opts, negative=negative, **kw)

    def predict_i2v(self, image_latents, text_states, text_mask,
                    text_states_2, opts, negative=None, **kw):
        """Pre-encoded I2V entry point (one conditioning latent per ProRes
        stage); returns final latents [16, F, H, W]."""
        return self.pipeline.generate_i2v(image_latents, text_states,
                                          text_mask, text_states_2, opts,
                                          negative=negative, **kw)


class WanSampler:
    """Sampler for Wan2.1, T2V or I2V by the config's ``model_type``;
    ``model_id`` keys the TeaCache polynomial."""

    CONFIGS = {"t2v-1.3B": wan_lib.WAN_T2V_1_3B,
               "t2v-14B": wan_lib.WAN_T2V_14B,
               "i2v-14B": wan_lib.WAN_I2V_14B}
    MODEL_IDS = {"t2v-1.3B": "wan-t2v-1.3b", "t2v-14B": "wan-t2v-14b",
                 "i2v-14B": "wan-i2v-720p"}

    def __init__(self, cfg: WanConfig, params=None, device="cuda",
                 seed: int = 0, model_id: str = "wan-t2v-1.3b",
                 vae: vae_wan.WanVAE | None = None):
        self.cfg = cfg
        self.vae = vae
        self.device = resolve_device(device)
        self.model = _build(WanDiT, init_wan_, cfg, params, self.device,
                            seed)
        pipe_cls = WanI2VPipeline if cfg.model_type == "i2v" \
            else WanT2VPipeline
        self.pipeline = pipe_cls(self.model, model_id=model_id,
                                 vae_decode=self.decode_latents)

    @classmethod
    def from_task(cls, task: str, params=None, device="cuda",
                  seed: int = 0, vae: vae_wan.WanVAE | None = None):
        """The published config of ``task`` (t2v-1.3B, t2v-14B, i2v-14B)
        with its ``model_id``."""
        return cls(cls.CONFIGS[task], params, device, seed,
                   model_id=cls.MODEL_IDS[task], vae=vae)

    def encode_image_latent(self, image, frame_num: int, lat_h: int,
                            lat_w: int):
        """[3, H, W] f32 in [0, 1] -> [16, T_lat, lat_h, lat_w]: the image
        resized to the latent size x 8 as the first frame, then
        ``frame_num - 1`` zero frames, through the streamed encoder."""
        if self.vae is None:
            raise RuntimeError("no VAE attached (WanSampler(..., vae=...))")
        h, w = lat_h * 8, lat_w * 8
        first = _resize_chw(image, h, w, self.vae.device) * 2.0 - 1.0
        frames = torch.cat([first[:, None],
                            first.new_zeros((3, frame_num - 1, h, w))], dim=1)
        return vae_wan.wanvae_encode(self.vae, frames[None])[0]

    def decode_latents(self, latents):
        """latents [16, T, h, w] -> video [3, F, H, W] in [-1, 1] by the
        streamed decode; the latents themselves without a VAE."""
        if self.vae is None:
            return latents
        z = torch.as_tensor(latents, dtype=torch.float32,
                            device=self.vae.device)[None]
        return vae_wan.wanvae_decode(self.vae, z)[0]

    def generate(self, context, context_null, opts, **kw):
        """Pre-encoded entry point (prompt embeddings [L, text_dim]);
        returns final latents [C, F, H, W]."""
        return self.pipeline.generate(context, context_null, opts, **kw)

    def generate_i2v(self, image_latent, clip_fea, context, context_null,
                     frame_num, lat_h, lat_w, opts, **kw):
        """Pre-encoded I2V entry point: the image latent [16, T_lat, lat_h,
        lat_w] and the CLIP tokens [257, 1280]; returns final latents."""
        return self.pipeline.generate_i2v(image_latent, clip_fea, context,
                                          context_null, frame_num, lat_h,
                                          lat_w, opts, **kw)

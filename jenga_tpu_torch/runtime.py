"""Sampler entry points of the port.

``HunyuanVideoSampler(cfg, params=None, device=..., i2v=False,
use_fp8=False)`` and
``WanSampler(cfg, params=None, device=..., model_id=...)`` build their DiT
on ``device`` from a converted state dict
(``convert.hyvideo_params_from_jax`` / ``convert.wan_params_from_jax``)
or, with ``params=None``, from a seeded random init on the device itself.
HunyuanVideo's ``use_fp8`` then quantizes the large linear weights to e4m3
in place (``models/fp8.py``); Wan has no such flag in the JAX package, and
its model takes ``quantize_tree_fp8`` directly.
``WanSampler.from_task`` builds a published Wan config by task name with
its TeaCache ``model_id``, as the JAX package's ``from_pretrained`` does.
``predict`` / ``predict_i2v`` / ``generate`` / ``generate_i2v`` take
pre-encoded text states (and, for I2V, conditioning latents and CLIP
features). ``from_pretrained``, the text encoders and the image encoders
wait until checkpoints are part of the port.
"""

from __future__ import annotations

import torch

from .models import wan as wan_lib
from .models.fp8 import quantize_tree_fp8
from .models.hyvideo import HYVideoConfig, HYVideoDiT, init_hyvideo_
from .models.wan import WanConfig, WanDiT, init_wan_
from .pipelines.hyvideo_i2v import HYVideoI2VPipeline
from .pipelines.hyvideo_t2v import HYVideoT2VPipeline
from .pipelines.wan_i2v import WanI2VPipeline
from .pipelines.wan_t2v import WanT2VPipeline

__all__ = ["HunyuanVideoSampler", "WanSampler", "resolve_device"]


def resolve_device(device) -> torch.device:
    """The device to run on; ``cuda`` without a card raises (there is no
    CPU fallback)."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("device 'cuda' requested but no CUDA device is "
                           "available (use --device cpu for a CPU run)")
    return device


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
                 seed: int = 0, i2v: bool = False, use_fp8: bool = False):
        self.cfg = cfg
        self.device = resolve_device(device)
        self.model = _build(HYVideoDiT, init_hyvideo_, cfg, params,
                            self.device, seed)
        if use_fp8:
            # after the init or load, as the JAX from_pretrained does
            quantize_tree_fp8(self.model)
        pipe_cls = HYVideoI2VPipeline if i2v else HYVideoT2VPipeline
        self.pipeline = pipe_cls(self.model)

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
                 seed: int = 0, model_id: str = "wan-t2v-1.3b"):
        self.cfg = cfg
        self.device = resolve_device(device)
        self.model = _build(WanDiT, init_wan_, cfg, params, self.device,
                            seed)
        pipe_cls = WanI2VPipeline if cfg.model_type == "i2v" \
            else WanT2VPipeline
        self.pipeline = pipe_cls(self.model, model_id=model_id)

    @classmethod
    def from_task(cls, task: str, params=None, device="cuda",
                  seed: int = 0):
        """The published config of ``task`` (t2v-1.3B, t2v-14B, i2v-14B)
        with its ``model_id``."""
        return cls(cls.CONFIGS[task], params, device, seed,
                   model_id=cls.MODEL_IDS[task])

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

"""Sampler entry points of the port.

``HunyuanVideoSampler(cfg, params=None, device=...)`` and
``WanSampler(cfg, params=None, device=...)`` build their DiT on ``device``
from a converted state dict (``convert.hyvideo_params_from_jax`` /
``convert.wan_params_from_jax``) or, with ``params=None``, from a seeded
random init on the device itself. ``predict`` / ``generate`` take
pre-encoded text states. ``from_pretrained`` and the text encoders wait
until checkpoints are part of the port.
"""

from __future__ import annotations

import torch

from .models.hyvideo import HYVideoConfig, HYVideoDiT, init_hyvideo_
from .models.wan import WanConfig, WanDiT, init_wan_
from .pipelines.hyvideo_t2v import HYVideoT2VPipeline
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
    """T2V sampler for HunyuanVideo."""

    TEXT_LEN = 256

    def __init__(self, cfg: HYVideoConfig, params=None, device="cuda",
                 seed: int = 0):
        self.cfg = cfg
        self.device = resolve_device(device)
        self.model = _build(HYVideoDiT, init_hyvideo_, cfg, params,
                            self.device, seed)
        self.pipeline = HYVideoT2VPipeline(self.model)

    def predict(self, text_states, text_mask, text_states_2, opts,
                negative=None, **kw):
        """Pre-encoded entry point; returns final latents [C, F, H, W]."""
        return self.pipeline.generate(text_states, text_mask, text_states_2,
                                      opts, negative=negative, **kw)


class WanSampler:
    """T2V sampler for Wan2.1."""

    def __init__(self, cfg: WanConfig, params=None, device="cuda",
                 seed: int = 0):
        self.cfg = cfg
        self.device = resolve_device(device)
        self.model = _build(WanDiT, init_wan_, cfg, params, self.device,
                            seed)
        self.pipeline = WanT2VPipeline(self.model)

    def generate(self, context, context_null, opts, **kw):
        """Pre-encoded entry point (prompt embeddings [L, text_dim]);
        returns final latents [C, F, H, W]."""
        return self.pipeline.generate(context, context_null, opts, **kw)

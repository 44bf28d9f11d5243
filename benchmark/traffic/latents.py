"""VAE-like latents and random text states, drawn from the seed.

``synth_latents`` follows ``bench.py``'s ``synth_latents`` (copied, not
imported): an upsampled low-resolution Gaussian field (the latents of
natural video are smooth in space and time) mixed with white noise at the
flow-matching ratio x = (1 - sigma) * smooth + sigma * noise, sigma 0.6.
Under random weights it restores the selection locality that trained
checkpoints show; the work the kernels do is exact for any selection.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def low_shape(shape):
    """The low-resolution field's shape for latents [B, C, T, H, W]."""
    b, c, t, h, w = shape
    return (b, c, max(1, t // 4), max(1, h // 8), max(1, w // 8))


def mix_latents(low, noise, sigma: float = 0.6):
    """The deterministic half of ``synth_latents``: ``low`` upsampled
    trilinearly to ``noise``'s shape, scaled to unit std, mixed with
    ``noise``."""
    smooth = F.interpolate(low, size=noise.shape[2:], mode="trilinear",
                           align_corners=False)
    smooth = smooth / (smooth.std(unbiased=False) + 1e-6)
    return (1.0 - sigma) * smooth + sigma * noise


def synth_latents(gen: torch.Generator, shape, sigma: float = 0.6):
    """Latents [B, C, T, H, W] float32 on ``gen``'s device."""
    dev = gen.device
    low = torch.randn(low_shape(shape), generator=gen, device=dev)
    noise = torch.randn(shape, generator=gen, device=dev)
    return mix_latents(low, noise, sigma)


def text_states(gen: torch.Generator, tokens: int, dim: int):
    """Random encoder states [tokens, dim] float32, N(0, 1)."""
    return torch.randn((tokens, dim), generator=gen, device=gen.device)

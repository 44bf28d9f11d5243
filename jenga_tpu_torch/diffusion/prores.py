"""ProRes stage-switch resize.

The counterpart of ``jax.image.resize(x, shape, method="trilinear")`` in
the JAX pipelines' stage switches (HunyuanVideo ProRes and Wan Turbo),
which XLA computes outside any Pallas kernel. Every switch upsamples; for
an upsample both are the half-pixel-centred linear interpolation along
each axis, i.e. ``F.interpolate(mode="trilinear", align_corners=False)``.
A downsample would differ (JAX antialiases), so it is refused.
"""

from __future__ import annotations

import torch

__all__ = ["trilinear_resize"]


def trilinear_resize(x, shape):
    """Resize ``x`` [B, C, F, H, W] to the grid ``shape`` (F', H', W'),
    each no smaller than the source; returns f32."""
    shape = tuple(int(s) for s in shape)
    src = tuple(x.shape[2:])
    if len(shape) != 3 or any(d < s for d, s in zip(shape, src)):
        raise ValueError(f"trilinear_resize upsamples only: {src} -> "
                         f"{shape}")
    return torch.nn.functional.interpolate(x.float(), size=shape,
                                           mode="trilinear",
                                           align_corners=False)

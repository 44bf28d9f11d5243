"""Bridge from the JAX parameter pytrees to the port's state dicts.

``hyvideo_params_from_jax(tree)`` and ``wan_params_from_jax(tree)`` take
the nested dict/list tree of ``init_hyvideo_params`` / ``init_wan_params``
(or a converted checkpoint) with numpy leaves and return a flat
``{name: tensor}`` dict for ``HYVideoDiT`` / ``WanDiT.load_state_dict``;
``hyvae_params_from_jax`` and ``wanvae_params_from_jax`` do the same for
the VAEs (``codec.vae_hy.HYVAE`` / ``codec.vae_wan.WanVAE``).
Names are the tree paths joined with dots; ``None`` leaves (Wan's
parameterless head norm) are dropped. JAX ``linear`` weights are
``[in, out]``; the port's are torch-style ``[out, in]``, and this is the
one place that transposes them, fp8 ``w8`` leaves too (a tree from
``quantize_tree_fp8`` loads into a port module quantized the same way).
Every leaf keeps its dtype (bf16 and e4m3 leaves arrive as ml_dtypes
arrays).
"""

from __future__ import annotations

import numpy as np
import torch

__all__ = ["hyvideo_params_from_jax", "wan_params_from_jax",
           "hyvae_params_from_jax", "wanvae_params_from_jax"]


def _to_tensor(a) -> torch.Tensor:
    """numpy array (incl. ml_dtypes bfloat16 and float8_e4m3fn) -> torch
    tensor, same dtype and bytes."""
    a = np.array(a)     # a writable copy (JAX hands out read-only views)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.uint16)).view(torch.bfloat16)
    if a.dtype.name == "float8_e4m3fn":
        return torch.from_numpy(a.view(np.uint8)).view(torch.float8_e4m3fn)
    return torch.from_numpy(a)


def _flatten(tree, prefix=""):
    if isinstance(tree, dict):
        items = tree.items()
    elif isinstance(tree, (list, tuple)):
        items = enumerate(tree)
    else:
        yield prefix, tree
        return
    for key, sub in items:
        yield from _flatten(sub, f"{prefix}{key}.")


def hyvideo_params_from_jax(tree) -> dict[str, torch.Tensor]:
    out = {}
    for name, leaf in _flatten(tree):
        if leaf is None:
            continue
        name = name[:-1]    # drop the trailing dot
        t = _to_tensor(leaf)
        if name.endswith((".w", ".w8")) and t.ndim == 2:
            t = t.T.contiguous()
        out[name] = t
    return out


def wan_params_from_jax(tree) -> dict[str, torch.Tensor]:
    """The Wan tree's ``head`` becomes the module ``head_layer``."""
    tree = dict(tree)
    tree["head_layer"] = tree.pop("head")
    return hyvideo_params_from_jax(tree)


def hyvae_params_from_jax(tree) -> dict[str, torch.Tensor]:
    """The HunyuanVideo VAE tree of ``init_hyvae_params``. Conv weights
    keep their ``[O, I, kt, kh, kw]`` layout; the mid-block attention's
    ``q/k/v/o.w`` are ``[in, out]`` in JAX and, being the tree's only 2-D
    ``.w`` leaves, are transposed by the same rule as the DiT's linears."""
    return hyvideo_params_from_jax(tree)


def wanvae_params_from_jax(tree) -> dict[str, torch.Tensor]:
    """The Wan VAE tree of ``init_wanvae_params``. Every weight is a conv
    and keeps its layout: ``[O, I, kt, kh, kw]``, or ``[O, I, kh, kw]`` for
    the per-frame 2-D convs, among them the attention's ``qkv``/``proj``
    (1x1, 4-D, so the 2-D rule never transposes them)."""
    return hyvideo_params_from_jax(tree)

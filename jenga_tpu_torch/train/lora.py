"""LoRA adapters over the port's DiT parameters.

Port of ``jenga_tpu/train/lora.py``: low-rank deltas on the DiT's 2-D
linear weights, trained while the base stays frozen. ``apply_lora`` gives
the effective weights functionally, ``W + scale * b @ a`` computed in f32
and cast to the base dtype, as JAX merges them; the model then runs under
``torch.func.functional_call`` with the merged weights, so gradients reach
``a`` and ``b`` through the merged weight (a peft-style ``x a^T b^T`` side
branch is the same math in f32 but rounds differently in bf16). The
port's linear weights are ``[out, in]`` where JAX's are ``[in, out]``, so
its delta is ``b @ a`` with no transpose; ``a`` [rank, in] and ``b`` [out,
rank] are the same tensors in both packages.

Adapters are keyed by module path (``blocks.0.self_attn.q``), the JAX
tree path with dots (``convert.lora_from_jax`` carries a JAX adapter tree
across). ``export_kohya`` writes the reference's kohya key layout, the
same keys and arrays as the JAX export.
"""

from __future__ import annotations

import re

import torch

__all__ = ["init_lora", "apply_lora", "lora_param_count", "lora_tensors",
           "export_kohya", "DEFAULT_TARGETS"]

# the attention and mlp linears of both block kinds (HunyuanVideo) and of
# Wan's blocks, as the JAX package's targets with dots for slashes
DEFAULT_TARGETS = (
    r"double_blocks\.\d+\.(img_qkv|txt_qkv|img_proj|txt_proj|img_mlp\.fc\d|"
    r"txt_mlp\.fc\d)",
    r"single_blocks\.\d+\.(linear1|linear2)",
    # Wan DiT
    r"blocks\.\d+\.(self_attn|cross_attn)\.(q|k|v|o)",
    r"blocks\.\d+\.ffn\.fc\d",
)


def _match(path: str, targets) -> bool:
    return any(re.search(t, path) for t in targets)


def _named(params):
    """{name: tensor} of a module or a dict."""
    if isinstance(params, torch.nn.Module):
        return dict(params.named_parameters())
    return dict(params)


def init_lora(generator: torch.Generator | None, params, rank: int = 16,
              targets=DEFAULT_TARGETS, dtype=torch.float32,
              device=None) -> dict:
    """Build {path: {"a": [rank, in], "b": [out, rank]}} for every targeted
    2-D linear weight ``<path>.w`` of ``params`` (a module or a {name:
    tensor} dict); ``a`` is N(0, 1) / rank, ``b`` zero (the delta starts at
    exactly zero). The tensors require grad."""
    lora = {}
    for name, w in _named(params).items():
        if not name.endswith(".w") or w.ndim != 2:
            continue
        base = name[:-2]
        if not _match(base, targets):
            continue
        d_out, d_in = w.shape
        dev = w.device if device is None else device
        a = torch.randn((rank, d_in), generator=generator, dtype=dtype,
                        device=dev) * (1.0 / rank)
        lora[base] = {"a": a.requires_grad_(),
                      "b": torch.zeros((d_out, rank), dtype=dtype,
                                       device=dev, requires_grad=True)}
    return lora


def apply_lora(params, lora: dict, scale: float = 1.0) -> dict:
    """{name: tensor} with ``W <- W + scale * (b @ a)`` per adapter, the
    product and the sum in f32, then cast to W's dtype; every other entry
    is ``params``'s own tensor."""
    out = _named(params)
    for base, ab in lora.items():
        name = base + ".w"
        w = out[name]
        delta = (ab["b"].float() @ ab["a"].float()) * scale
        out[name] = (w.float() + delta).to(w.dtype)
    return out


def lora_tensors(lora: dict) -> list:
    """The adapter tensors, for an optimizer."""
    return [t for ab in lora.values() for t in (ab["a"], ab["b"])]


def lora_param_count(lora: dict) -> int:
    return sum(ab["a"].numel() + ab["b"].numel() for ab in lora.values())


def export_kohya(lora: dict, prefix: str = "Hunyuan_video_I2V") -> dict:
    """The reference's kohya layout (``<prefix>_lora_<path with
    underscores>.lora_down/up.weight`` and ``.alpha`` = rank), f32 CPU
    tensors: the keys and arrays of the JAX export for the same adapters,
    and what ``convert.merge_lora`` reads."""
    out = {}
    for base, ab in lora.items():
        name = f"{prefix}_lora_" + base.replace(".", "_")
        rank = ab["a"].shape[0]
        out[f"{name}.lora_down.weight"] = ab["a"].detach().float().cpu()
        out[f"{name}.lora_up.weight"] = ab["b"].detach().float().cpu()
        out[f"{name}.alpha"] = torch.tensor(float(rank))
    return out

"""fp8 (e4m3) weight storage for the DiT linear layers.

Port of ``jenga_tpu/models/fp8.py``: a linear weight is stored as e4m3
with one f32 scale per tensor, ``max(max|w|, 1e-12) / 448``, and
dequantized to bf16 in ``layers.linear`` before each product, which stays
a bf16 (or f32) GEMM. ``quantize_tree_fp8`` quantizes exactly the layers
the JAX function does: the 2-D linear weights with at least ``min_size``
elements; norms, biases, modulation vectors and small linears stay as
they are.
"""

from __future__ import annotations

import torch
from torch import nn

from .layers import Affine

__all__ = ["E4M3_MAX", "quantize_linear_fp8", "quantize_tree_fp8",
           "dequantize_tree_fp8"]

E4M3_MAX = 448.0


def quantize_linear_fp8(w: torch.Tensor):
    """``(w8, scale)`` of a weight: the f32 per-tensor scale and the weight
    divided by it in f32, cast to e4m3. Both divisions are by a tensor on
    the weight's device: CUDA divides by a host scalar as a product with
    its reciprocal, one ulp off the CPU's (and JAX's) quotient."""
    wf = w.float()
    amax = wf.abs().max().clamp_min(1e-12)
    scale = amax / amax.new_tensor(E4M3_MAX)
    return (wf / scale).to(torch.float8_e4m3fn), scale


@torch.no_grad()
def quantize_tree_fp8(module: nn.Module, min_size: int = 2 ** 16) -> list:
    """Quantize in place every ``Affine`` whose weight has at least
    ``min_size`` elements; returns their names. Each layer's weight is
    released as soon as its fp8 copy exists, so the module never holds
    both copies of more than one layer."""
    names = []
    for name, mod in module.named_modules():
        if (isinstance(mod, Affine) and mod.w is not None
                and mod.w.numel() >= min_size):
            w8, scale = quantize_linear_fp8(mod.w)
            mod.w = None
            mod.w8 = nn.Parameter(w8, requires_grad=False)
            mod.scale = nn.Parameter(scale, requires_grad=False)
            names.append(name)
    return names


@torch.no_grad()
def dequantize_tree_fp8(module: nn.Module) -> None:
    """Undo ``quantize_tree_fp8`` in place: each fp8 layer gets back a
    weight in its own dtype holding the bf16 dequant ``linear`` computes,
    so the module computes what the fp8 one did."""
    for mod in module.modules():
        if isinstance(mod, Affine) and mod.w8 is not None:
            w = mod.w8.to(torch.bfloat16) * mod.scale.to(torch.bfloat16)
            mod.w8 = mod.scale = None
            mod.w = nn.Parameter(w.to(mod.dtype), requires_grad=False)

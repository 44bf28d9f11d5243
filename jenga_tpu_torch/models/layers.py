"""Shared building blocks for the DiT, as plain functions on tensors.

Port of ``jenga_tpu/models/layers.py`` with the same precision policy:
weights live in the model dtype, normalizations and modulation run in
f32 with the affine applied in f32 BEFORE the cast back (the order that
keeps q/k in bf16; the JAX side once leaked f32 into the attention
operands by multiplying after the cast), and RoPE tables are built on the
host in f64 and applied in f32.

Linear weights are stored torch-style, ``[out, in]``; the bridge from the
JAX ``[in, out]`` layout transposes them once (``convert.py``). A linear
layer may hold its weight in fp8 (``models/fp8.py``); ``linear``
dequantizes it before the product. The
parameter holders shared by the DiTs (``Affine``, ``Norm``, ``MLP``) and
their JAX-distributed random init live here too.

The DiT trunk calls its chains through ``norm_modulate``, ``rms_norm_rope``
and ``gated``: each launches one fused kernel (``ops/fused_rows.py``)
where the input suits it, and otherwise runs the chain of the plain
functions here (``layer_norm`` or ``rms_norm``, then ``modulate`` or
``apply_rope``; the gated residual in torch), which are also what the
JAX-parity tests hold. A kernel launches inside the span of the chain it
replaces: ``norm`` for the first two, ``modulate`` for ``gated``.
``norm_modulate_tokens`` (a modulation per token) is always the chain.
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from .. import obs
from ..ops import fused_rows as FR

__all__ = [
    "linear", "rms_norm", "layer_norm", "gelu_tanh", "silu",
    "sinusoidal_embedding", "modulate", "norm_modulate",
    "norm_modulate_tokens", "rms_norm_rope", "gated", "patchify_3d", "unpatchify_3d", "rope_table_1d",
    "rope_table_3d", "apply_rope", "param", "Affine", "Norm", "MLP",
    "init_affine_or_norm_", "remat_call",
]


def param(shape, dtype, device):
    """An uninitialised, frozen parameter (training adapts LoRA tensors
    beside it, ``train/lora.py``)."""
    return nn.Parameter(torch.empty(shape, dtype=dtype, device=device),
                        requires_grad=False)


class Affine(nn.Module):
    """Linear layer with params ``w`` [out, in] and optional ``b``; once
    quantized (``models/fp8.py``), ``w8`` (e4m3, [out, in]) and its f32
    per-tensor ``scale`` take the place of ``w``. ``dtype`` is the
    weight's own dtype; ``zero`` marks the JAX package's zero-initialised
    layers."""

    def __init__(self, d_in, d_out, dtype, device, bias=True, zero=False):
        super().__init__()
        self.zero = zero
        self.dtype = dtype
        self.w = param((d_out, d_in), dtype, device)
        self.register_parameter("w8", None)
        self.register_parameter("scale", None)
        self.b = param((d_out,), dtype, device) if bias else None

    def forward(self, x):
        return linear(self, x)


class Norm(nn.Module):
    """LayerNorm affine params (``w``, ``b``), f32."""

    def __init__(self, d, device):
        super().__init__()
        self.w = param((d,), torch.float32, device)
        self.b = param((d,), torch.float32, device)


class MLP(nn.Module):
    """Two affine layers ``fc1``, ``fc2`` (the activation is the caller's)."""

    def __init__(self, d_in, d_hidden, d_out, dtype, device):
        super().__init__()
        self.fc1 = Affine(d_in, d_hidden, dtype, device)
        self.fc2 = Affine(d_hidden, d_out, dtype, device)


@torch.no_grad()
def init_affine_or_norm_(mod: nn.Module, generator: torch.Generator) -> bool:
    """Init an ``Affine`` or ``Norm`` as the JAX inits do: linear weights
    U(-sqrt(6/(in+out)), +sqrt(6/(in+out))) or zero where the JAX init
    zeroes them, biases 0, norm scales 1 and shifts 0. Returns False for
    any other module."""
    if isinstance(mod, Affine):
        if mod.zero:
            mod.w.zero_()
        else:
            d_out, d_in = mod.w.shape
            bound = math.sqrt(6.0 / (d_in + d_out))
            mod.w.uniform_(-bound, bound, generator=generator)
        if mod.b is not None:
            mod.b.zero_()
        return True
    if isinstance(mod, Norm):
        mod.w.fill_(1.0)
        mod.b.zero_()
        return True
    return False


def linear(p, x):
    """Affine map with params ``p.w`` [out, in] and optional ``p.b``,
    computed in x's dtype (the weights share it). An fp8 layer's weight is
    dequantized first as the JAX ``linear`` does it: ``w8`` and ``scale``
    each to bf16, their product rounded in bf16, then taken to x's
    dtype."""
    if getattr(p, "w8", None) is None:
        return F.linear(x, p.w, p.b)
    w = p.w8.to(torch.bfloat16) * p.scale.to(torch.bfloat16)
    return F.linear(x, w.to(x.dtype), p.b)


@obs.spanned("norm")
def rms_norm(x, weight=None, eps: float = 1e-6):
    xf = x.float()
    y = xf * torch.rsqrt(xf.square().mean(dim=-1, keepdim=True) + eps)
    if weight is not None:
        y = y * weight.float()
    return y.to(x.dtype)


@obs.spanned("norm")
def layer_norm(x, weight=None, bias=None, eps: float = 1e-6):
    xf = x.float()
    mean = xf.mean(dim=-1, keepdim=True)
    var = (xf - mean).square().mean(dim=-1, keepdim=True)
    y = (xf - mean) * torch.rsqrt(var + eps)
    if weight is not None:
        y = y * weight.float()
    if bias is not None:
        y = y + bias.float()
    return y.to(x.dtype)


@obs.spanned("act")
def gelu_tanh(x):
    return F.gelu(x, approximate="tanh")


@obs.spanned("act")
def silu(x):
    return F.silu(x)


def sinusoidal_embedding(dim: int, position, max_period: float = 10000.0,
                         flip_sin_cos: bool = True):
    """1-D sinusoidal embedding; ``flip_sin_cos`` gives [cos | sin]."""
    half = dim // 2
    freqs = torch.exp(-math.log(max_period) * torch.arange(
        half, dtype=torch.float32, device=position.device) / half)
    args = position.float()[..., None] * freqs
    if flip_sin_cos:
        return torch.cat([torch.cos(args), torch.sin(args)], dim=-1)
    return torch.cat([torch.sin(args), torch.cos(args)], dim=-1)


@obs.spanned("modulate")
def modulate(x, shift=None, scale=None):
    """x * (1 + scale) + shift in f32, cast back to x's dtype."""
    y = x.float()
    if scale is not None:
        y = y * (1.0 + scale.float())
    if shift is not None:
        y = y + shift.float()
    return y.to(x.dtype)


def norm_modulate(x, weight=None, bias=None, shift=None, scale=None,
                  eps: float = 1e-6, rms: bool = False):
    """``modulate(layer_norm(x, weight, bias, eps), shift, scale)``, or
    ``rms_norm(x, weight, eps)`` with ``rms``; without ``shift`` and
    ``scale`` the norm alone. One kernel where ``fused_rows.row_refusal``
    takes the input, else that chain."""
    if FR.row_refusal(x, weight, bias, shift, scale) is None:
        with obs.span("norm"):
            return FR.launch_row_norm(x, weight, bias, shift, scale,
                                      eps=eps, rms=rms)
    FR.norm_modulate.fallbacks += x.is_cuda
    y = rms_norm(x, weight, eps) if rms else layer_norm(x, weight, bias, eps)
    if shift is None and scale is None:
        return y
    return modulate(y, shift, scale)


def norm_modulate_tokens(x, shift, scale, mask, shift_at, scale_at,
                         eps: float = 1e-6):
    """``layer_norm(x, eps)`` modulated by ``(shift_at, scale_at)`` at the
    tokens of ``mask`` ([S] bool) and by ``(shift, scale)`` elsewhere: a
    modulation per token, which the kernel does not take, so always the
    chain (a fallback on a CUDA device)."""
    FR.norm_modulate.fallbacks += x.is_cuda
    xn = layer_norm(x, eps=eps)
    y = modulate(xn, shift=shift, scale=scale)
    y_at = modulate(xn, shift=shift_at, scale=scale_at)
    return torch.where(mask[None, :, None], y_at, y)


def rms_norm_rope(x, weight, cos, sin, eps: float = 1e-6,
                  rope_rows: int | None = None):
    """``rms_norm(x, weight, eps)`` over the last dim, then ``apply_rope``
    on its heads (``2 * cos.shape[1]`` elements each) over the first
    ``rope_rows`` tokens (dim 1; all by default) by the rows of cos/sin;
    the later tokens are normed only. x [B, S, R] or a [B, S, G, R] view;
    the result is shaped as x. One kernel where
    ``fused_rows.row_refusal`` takes the input, else that chain."""
    s = x.shape[1]
    rope_rows = s if rope_rows is None else rope_rows
    if FR.row_refusal(x, weight, cos=cos, sin=sin,
                      rope_rows=rope_rows) is None:
        with obs.span("norm"):
            return FR.launch_row_norm(x, weight, cos=cos, sin=sin,
                                      rope_rows=rope_rows, eps=eps, rms=True)
    FR.rms_norm_rope.fallbacks += x.is_cuda
    y = rms_norm(x, weight, eps)
    heads = y.reshape(*y.shape[:2], -1, 2 * cos.shape[-1])
    out = apply_rope(heads[:, :rope_rows], cos[:rope_rows], sin[:rope_rows])
    if rope_rows < s:
        with obs.span("layout"):
            out = torch.cat([out, heads[:, rope_rows:]], dim=1)
    return out.reshape(y.shape)


@obs.spanned("modulate")
def gated(x, y, gate):
    """The gated residual ``x + y * gate`` in f32, cast to x's dtype: one
    kernel where ``fused_rows.gated_refusal`` takes the input, else in
    torch."""
    if FR.gated_refusal(x, y, gate) is None:
        return FR.launch_gated(x, y, gate)
    FR.gated_residual.fallbacks += x.is_cuda
    return (x.float() + y.float() * gate).to(x.dtype)


def patchify_3d(p, x, patch):
    """[B, C, F, H, W] -> ([B, L, dim], grid): block reshape + one matmul
    (``p`` an ``Affine`` with ``w`` [dim, C*pt*ph*pw]). It is called, not
    read, so that its forward hooks (FSDP's gather) run."""
    b, c, f, h, w = x.shape
    pt, ph, pw = patch
    gt, gh, gw = f // pt, h // ph, w // pw
    with obs.span("layout"):
        x = x.reshape(b, c, gt, pt, gh, ph, gw, pw)
        x = x.permute(0, 2, 4, 6, 1, 3, 5, 7)
        x = x.reshape(b, gt * gh * gw, c * pt * ph * pw)
    return p(x), (gt, gh, gw)


@obs.spanned("layout")
def unpatchify_3d(x, grid, patch, out_channels: int,
                  channel_last: bool = False):
    """Inverse of patchify: [B, L, C*pt*ph*pw] -> [B, C, F, H, W]. The
    per-token feature order is HunyuanVideo's (c, pt, ph, pw) by default
    and Wan's (pt, ph, pw, c) with ``channel_last``."""
    b = x.shape[0]
    gt, gh, gw = grid
    pt, ph, pw = patch
    if channel_last:
        x = x.reshape(b, gt, gh, gw, pt, ph, pw, out_channels)
        x = x.permute(0, 7, 1, 4, 2, 5, 3, 6)
    else:
        x = x.reshape(b, gt, gh, gw, out_channels, pt, ph, pw)
        x = x.permute(0, 4, 1, 5, 2, 6, 3, 7)
    return x.reshape(b, out_channels, gt * pt, gh * ph, gw * pw)


def rope_table_1d(positions: np.ndarray, dim: int, theta: float = 10000.0):
    """cos/sin tables [len(positions), dim/2] in f32 via f64 host math."""
    freqs = 1.0 / (theta ** (np.arange(0, dim, 2, dtype=np.float64) / dim))
    angles = np.outer(positions.astype(np.float64), freqs)
    return (np.cos(angles).astype(np.float32),
            np.sin(angles).astype(np.float32))


def rope_table_3d(grid, dims, theta: float = 10000.0,
                  order: np.ndarray | None = None):
    """Interleaved 3-D rope tables (numpy f32 [S, head_dim//2] each) for a
    (t, h, w) grid; ``order`` permutes tokens into curve order. (JAX's
    ``positions`` override, which no pipeline passes, is not ported.)"""
    t, h, w = grid
    cos_parts, sin_parts = [], []
    for axis, (size, dim) in enumerate(zip(grid, dims)):
        c, s = rope_table_1d(np.arange(size, dtype=np.float64), dim, theta)
        shape = [1, 1, 1, dim // 2]
        shape[axis] = size
        cos_parts.append(np.broadcast_to(c.reshape(shape), (t, h, w, dim // 2)))
        sin_parts.append(np.broadcast_to(s.reshape(shape), (t, h, w, dim // 2)))
    cos = np.concatenate(cos_parts, axis=-1).reshape(t * h * w, -1)
    sin = np.concatenate(sin_parts, axis=-1).reshape(t * h * w, -1)
    if order is not None:
        cos, sin = cos[order], sin[order]
    return cos.copy(), sin.copy()


@obs.spanned("rope")
def apply_rope(x, cos, sin):
    """Rotate interleaved (even, odd) pairs of x [B, S, H, D] by cos/sin
    [S, D/2], in f32."""
    xf = x.float()
    xe, xo = xf[..., 0::2], xf[..., 1::2]
    c, s = cos[:, None, :], sin[:, None, :]
    y = torch.stack([xe * c - xo * s, xo * c + xe * s], dim=-1)
    return y.flatten(-2).to(x.dtype)


def _call_with(block: nn.Module, params: dict, *args):
    return torch.func.functional_call(block, params, args)


def remat_call(block: nn.Module, *args):
    """``block(*args)`` under ``torch.utils.checkpoint`` (non-reentrant):
    its activations are recomputed in the backward. The block's parameters
    as they are now go in explicitly, so the recompute sees the same
    weights even when this forward ran under ``torch.func.functional_call``
    (the LoRA step's merged weights), which gives the module its own
    parameters back when it returns, before the backward."""
    return checkpoint(_call_with, block, dict(block.named_parameters()),
                      *args, use_reentrant=False)

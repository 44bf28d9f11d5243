"""UMT5-XXL text encoder (Wan).

Port of ``jenga_tpu/text/t5.py``: encoder only, relative position bias
per layer (umT5, ``shared_pos=False``) or shared, unscaled attention
logits, a tanh-GELU gated feed-forward and T5's RMS layernorm; the output
is f32. umt5-xxl: vocab 256384, dim 4096, ffn 10240, 64 heads, 24 layers,
32 buckets. Attention is a plain f32 matmul and softmax, as in the JAX
function. ``relative_position_bucket`` is a copy of the JAX package's
numpy helper.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch
from torch import nn

from ..models import layers as L

__all__ = ["T5Config", "UMT5_XXL", "T5Encoder", "init_t5_", "t5_encode",
           "relative_position_bucket"]

_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


@dataclasses.dataclass(frozen=True)
class T5Config:
    vocab_size: int = 256384
    dim: int = 4096
    dim_attn: int = 4096
    dim_ffn: int = 10240
    num_heads: int = 64
    num_layers: int = 24
    num_buckets: int = 32
    max_dist: int = 128
    shared_pos: bool = False
    eps: float = 1e-6
    dtype: str = "bfloat16"

    @property
    def head_dim(self) -> int:
        return self.dim_attn // self.num_heads


UMT5_XXL = T5Config()


def relative_position_bucket(rel_pos: np.ndarray, num_buckets: int,
                             max_dist: int, bidirectional: bool = True
                             ) -> np.ndarray:
    """T5 log-bucketed relative positions."""
    rel_pos = np.asarray(rel_pos)
    if bidirectional:
        half = num_buckets // 2
        buckets = (rel_pos > 0).astype(np.int64) * half
        rel = np.abs(rel_pos)
    else:
        half = num_buckets
        buckets = np.zeros_like(rel_pos)
        rel = -np.minimum(rel_pos, 0)
    max_exact = half // 2
    with np.errstate(divide="ignore"):
        large = max_exact + (
            np.log(np.maximum(rel, 1) / max_exact)
            / math.log(max_dist / max_exact) * (half - max_exact)
        ).astype(np.int64)
    large = np.minimum(large, half - 1)
    buckets = buckets + np.where(rel < max_exact, rel, large)
    return buckets


class T5Block(nn.Module):
    def __init__(self, cfg: T5Config, dtype, device):
        super().__init__()
        d, da, df, f32 = cfg.dim, cfg.dim_attn, cfg.dim_ffn, torch.float32
        self.norm1 = L.param((d,), f32, device)
        self.q = L.Affine(d, da, dtype, device, bias=False)
        self.k = L.Affine(d, da, dtype, device, bias=False)
        self.v = L.Affine(d, da, dtype, device, bias=False)
        self.o = L.Affine(da, d, dtype, device, bias=False)
        self.norm2 = L.param((d,), f32, device)
        self.gate = L.Affine(d, df, dtype, device, bias=False)
        self.fc1 = L.Affine(d, df, dtype, device, bias=False)
        self.fc2 = L.Affine(df, d, dtype, device, bias=False)
        if not cfg.shared_pos:
            self.rel_embedding = L.param((cfg.num_buckets, cfg.num_heads),
                                         f32, device)


class T5Encoder(nn.Module):
    """``embed``, ``blocks``, ``final_norm`` and, with ``shared_pos``, one
    ``rel_embedding`` [buckets, heads] for all blocks."""

    def __init__(self, cfg: T5Config = UMT5_XXL, device="cpu", dtype=None):
        super().__init__()
        dtype = dtype or _DTYPES[cfg.dtype]
        self.embed = L.param((cfg.vocab_size, cfg.dim), dtype, device)
        self.blocks = nn.ModuleList(T5Block(cfg, dtype, device)
                                    for _ in range(cfg.num_layers))
        self.final_norm = L.param((cfg.dim,), torch.float32, device)
        if cfg.shared_pos:
            self.rel_embedding = L.param((cfg.num_buckets, cfg.num_heads),
                                         torch.float32, device)


@torch.no_grad()
def init_t5_(model: T5Encoder, generator: torch.Generator) -> T5Encoder:
    """Seeded init with the JAX init's distributions: linears uniform, the
    embedding N(0, 1), the relative bias N(0, 1 / (2 * buckets * heads)),
    norms 1."""
    for mod in model.modules():
        L.init_affine_or_norm_(mod, generator)
    model.embed.normal_(0.0, 1.0, generator=generator)
    for name, p in model.named_parameters():
        if name.endswith("rel_embedding"):
            p.normal_(0.0, (2 * p.numel()) ** -0.5, generator=generator)
        elif name.endswith("norm1") or name.endswith("norm2") \
                or name == "final_norm":
            p.fill_(1.0)
    return model


def _t5_norm(x, w, eps):
    """RMS without mean subtraction, scale only, in f32."""
    xf = x.float()
    y = xf * torch.rsqrt(xf.square().mean(dim=-1, keepdim=True) + eps)
    return (y * w).to(x.dtype)


def t5_encode(model: T5Encoder, cfg: T5Config, token_ids, attention_mask):
    """ids [B, L], mask [B, L] -> token states [B, L, dim] (f32)."""
    b, s = token_ids.shape
    n, hd = cfg.num_heads, cfg.head_dim
    h = model.embed[token_ids]
    rel = np.arange(s)[None, :] - np.arange(s)[:, None]
    buckets = torch.from_numpy(relative_position_bucket(
        rel, cfg.num_buckets, cfg.max_dist)).to(h.device)
    mask_bias = torch.where(attention_mask.bool()[:, None, None, :],
                            0.0, -1e30)
    for blk in model.blocks:
        table = model.rel_embedding if cfg.shared_pos else blk.rel_embedding
        pos_bias = table[buckets].permute(2, 0, 1)[None]    # [1, H, S, S]
        x = _t5_norm(h, blk.norm1, cfg.eps)
        q = blk.q(x).reshape(b, s, n, hd)
        k = blk.k(x).reshape(b, s, n, hd)
        v = blk.v(x).reshape(b, s, n, hd)
        # T5 attention is unscaled
        logits = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float())
        a = torch.softmax(logits + pos_bias + mask_bias, dim=-1)
        attn = torch.einsum("bhqk,bkhd->bqhd", a, v.float())
        h = h + blk.o(attn.reshape(b, s, n * hd).to(h.dtype))
        x = _t5_norm(h, blk.norm2, cfg.eps)
        h = h + blk.fc2(blk.fc1(x) * L.gelu_tanh(blk.gate(x)))
    return _t5_norm(h, model.final_norm, cfg.eps).float()

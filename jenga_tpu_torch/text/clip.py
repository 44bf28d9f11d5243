"""CLIP text encoder (HunyuanVideo's pooled conditioning) and vision tower
(Wan I2V image features; llava's tower).

Port of ``jenga_tpu/text/clip.py``: the CLIP text transformer (causal
mask, learned positions, quick-GELU) pooled at the first EOS token, and a
ViT with pre-norm blocks whose ``clip_vision_encode`` taps the raw block
outputs (``use_31_block`` stops one block early, ``feature_layer`` counts
from the end; no post-LN on any path). Attention is a plain f32 matmul
and softmax, as in the JAX functions. Parameter names follow the JAX
pytree; linear weights (the patch embedding's too, ``[d, 3*p*p]``) are
``[out, in]``.
"""

from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F
from torch import nn

from ..models import layers as L

__all__ = ["CLIPTextConfig", "CLIP_L_TEXT", "CLIPText", "init_clip_text_",
           "clip_text_encode", "CLIPVisionConfig", "CLIP_H_VISION",
           "CLIP_L_VISION_336", "CLIPVision", "init_clip_vision_",
           "clip_vision_encode"]

_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


@dataclasses.dataclass(frozen=True)
class CLIPTextConfig:
    vocab_size: int = 49408
    hidden_size: int = 768
    intermediate_size: int = 3072
    num_layers: int = 12
    num_heads: int = 12
    max_positions: int = 77
    eos_token_id: int = 49407
    dtype: str = "float32"


CLIP_L_TEXT = CLIPTextConfig()


@dataclasses.dataclass(frozen=True)
class CLIPVisionConfig:
    image_size: int = 224
    patch_size: int = 14
    hidden_size: int = 1280
    intermediate_size: int = 5120
    num_layers: int = 32
    num_heads: int = 16
    act: str = "gelu"        # gelu (Wan ViT-H) | quick_gelu (HF CLIP-L)
    dtype: str = "float32"


CLIP_H_VISION = CLIPVisionConfig()
# llava's vision tower (CLIP ViT-L/14-336, HF layout)
CLIP_L_VISION_336 = CLIPVisionConfig(
    image_size=336, hidden_size=1024, intermediate_size=4096,
    num_layers=24, num_heads=16, act="quick_gelu")


class EncoderBlock(nn.Module):
    """Pre-LN block: ``ln1``, ``q/k/v/o``, ``ln2``, ``fc1``, ``fc2``."""

    def __init__(self, d, ffn, dtype, device):
        super().__init__()
        self.ln1 = L.Norm(d, device)
        self.q = L.Affine(d, d, dtype, device)
        self.k = L.Affine(d, d, dtype, device)
        self.v = L.Affine(d, d, dtype, device)
        self.o = L.Affine(d, d, dtype, device)
        self.ln2 = L.Norm(d, device)
        self.fc1 = L.Affine(d, ffn, dtype, device)
        self.fc2 = L.Affine(ffn, d, dtype, device)


def quick_gelu(x):
    return x * torch.sigmoid(1.702 * x)


def _encoder_block(p: EncoderBlock, h, n, mask_bias=None, act=None):
    b, s, d = h.shape
    hd = d // n
    x = L.layer_norm(h, p.ln1.w, p.ln1.b, eps=1e-5)
    q = p.q(x).reshape(b, s, n, hd)
    k = p.k(x).reshape(b, s, n, hd)
    v = p.v(x).reshape(b, s, n, hd)
    logits = torch.einsum("bqhd,bkhd->bhqk", q.float(),
                          k.float()) * hd ** -0.5
    if mask_bias is not None:
        logits = logits + mask_bias
    a = torch.softmax(logits, dim=-1)
    attn = torch.einsum("bhqk,bkhd->bqhd", a, v.float()).reshape(b, s, d)
    h = h + p.o(attn.to(h.dtype))
    x = L.layer_norm(h, p.ln2.w, p.ln2.b, eps=1e-5)
    return h + p.fc2(act(p.fc1(x)))


@torch.no_grad()
def _init_blocks_(model, generator):
    for mod in model.modules():
        L.init_affine_or_norm_(mod, generator)


class CLIPText(nn.Module):
    """``token_embed``, ``pos_embed``, ``blocks``, ``final_ln``."""

    def __init__(self, cfg: CLIPTextConfig = CLIP_L_TEXT, device="cpu",
                 dtype=None):
        super().__init__()
        dtype = dtype or _DTYPES[cfg.dtype]
        d = cfg.hidden_size
        self.token_embed = L.param((cfg.vocab_size, d), dtype, device)
        self.pos_embed = L.param((cfg.max_positions, d), dtype, device)
        self.blocks = nn.ModuleList(
            EncoderBlock(d, cfg.intermediate_size, dtype, device)
            for _ in range(cfg.num_layers))
        self.final_ln = L.Norm(d, device)


@torch.no_grad()
def init_clip_text_(model: CLIPText, generator: torch.Generator):
    """Seeded init with the JAX init's distributions."""
    _init_blocks_(model, generator)
    model.token_embed.normal_(0.0, 0.02, generator=generator)
    model.pos_embed.normal_(0.0, 0.01, generator=generator)
    return model


def clip_text_encode(model: CLIPText, cfg: CLIPTextConfig, token_ids):
    """ids [B, L<=77] -> (token states [B, L, d], pooled [B, d]): pooled is
    the final-LN state at the first EOS token (HF CLIPTextModel's
    pooler)."""
    b, s = token_ids.shape
    h = model.token_embed[token_ids] + model.pos_embed[:s]
    causal = torch.ones((s, s), dtype=torch.bool,
                        device=h.device).tril()
    bias = torch.where(causal, 0.0, -1e30)[None, None]
    for blk in model.blocks:
        h = _encoder_block(blk, h, cfg.num_heads, bias, act=quick_gelu)
    h = L.layer_norm(h, model.final_ln.w, model.final_ln.b, eps=1e-5)
    eos_pos = (token_ids == cfg.eos_token_id).int().argmax(dim=-1)
    return h, h[torch.arange(b, device=h.device), eos_pos]


class CLIPVision(nn.Module):
    """``patch_embed`` (a bias-free linear over (C, ph, pw) patches),
    ``cls_token`` [1, 1, d], ``pos_embed`` [1 + P, d], ``pre_ln``,
    ``blocks``, ``post_ln`` (kept for the checkpoints; no path applies
    it)."""

    def __init__(self, cfg: CLIPVisionConfig = CLIP_H_VISION, device="cpu",
                 dtype=None):
        super().__init__()
        dtype = dtype or _DTYPES[cfg.dtype]
        d = cfg.hidden_size
        n_patches = (cfg.image_size // cfg.patch_size) ** 2
        self.patch_embed = L.Affine(3 * cfg.patch_size ** 2, d, dtype,
                                    device, bias=False)
        self.cls_token = L.param((1, 1, d), dtype, device)
        self.pos_embed = L.param((n_patches + 1, d), dtype, device)
        self.pre_ln = L.Norm(d, device)
        self.blocks = nn.ModuleList(
            EncoderBlock(d, cfg.intermediate_size, dtype, device)
            for _ in range(cfg.num_layers))
        self.post_ln = L.Norm(d, device)


@torch.no_grad()
def init_clip_vision_(model: CLIPVision, generator: torch.Generator):
    """Seeded init: linears uniform, the patch embedding N(0, 0.02^2), the
    class token 0 and the positions N(0, 0.01^2), as the JAX init."""
    _init_blocks_(model, generator)
    model.patch_embed.w.normal_(0.0, 0.02, generator=generator)
    model.cls_token.zero_()
    model.pos_embed.normal_(0.0, 0.01, generator=generator)
    return model


def clip_vision_encode(model: CLIPVision, cfg: CLIPVisionConfig, images,
                       use_31_block: bool = False,
                       feature_layer: int | None = None):
    """images [B, 3, H, W] (normalized) -> token features [B, 1+P, d], the
    class token first. ``use_31_block`` stops before the last block (how
    Wan taps its features); ``feature_layer`` (negative, HF's
    ``vision_feature_layer``) taps ``hidden_states[feature_layer]``
    (llava: -2). Every path returns raw block output (no post-LN)."""
    b, c, hh, ww = images.shape
    p = cfg.patch_size
    gh, gw = hh // p, ww // p
    x = images.reshape(b, c, gh, p, gw, p).permute(0, 2, 4, 1, 3, 5)
    x = x.reshape(b, gh * gw, c * p * p)
    h = F.linear(x.to(model.patch_embed.w.dtype), model.patch_embed.w)
    cls = model.cls_token.expand(b, 1, h.shape[-1])
    h = torch.cat([cls, h], dim=1) + model.pos_embed[:h.shape[1] + 1]
    h = L.layer_norm(h, model.pre_ln.w, model.pre_ln.b, eps=1e-5)
    # exact-erf GELU for Wan's ViT-H (torch nn.GELU() in the reference)
    act = quick_gelu if cfg.act == "quick_gelu" else F.gelu
    n_blocks = len(model.blocks)
    if use_31_block:
        n_blocks -= 1
    elif feature_layer is not None:
        # hidden_states[-1] = after all blocks; [-2] = one block earlier
        n_blocks += feature_layer + 1
    for blk in model.blocks[:n_blocks]:
        h = _encoder_block(blk, h, cfg.num_heads, act=act)
    return h

"""XLM-Roberta text encoder (the text tower of Wan's CLIP-H).

Port of ``jenga_tpu/text/xlm_roberta.py``. Wan inference calls only the
CLIP visual tower; the text tower ships in the same checkpoint and its
converter is ``convert.encoders.convert_xlm_roberta_wan``. Post-LN
transformer with learned positions (counted from ``pad_id + 1`` over the
real tokens), padding-masked bidirectional attention (plain f32 matmul
and softmax) and an exact-erf GELU MLP.
"""

from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F
from torch import nn

from ..models import layers as L

__all__ = ["XLMRobertaConfig", "XLMRoberta", "init_xlm_roberta_",
           "xlm_roberta_encode"]

_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


@dataclasses.dataclass(frozen=True)
class XLMRobertaConfig:
    vocab_size: int = 250002
    max_positions: int = 514
    type_size: int = 1
    pad_id: int = 1
    dim: int = 1024
    num_heads: int = 16
    num_layers: int = 24
    ffn_dim: int = 4096
    eps: float = 1e-5
    dtype: str = "float32"


class XLMRobertaBlock(nn.Module):
    def __init__(self, cfg: XLMRobertaConfig, dtype, device):
        super().__init__()
        d = cfg.dim
        self.q = L.Affine(d, d, dtype, device)
        self.k = L.Affine(d, d, dtype, device)
        self.v = L.Affine(d, d, dtype, device)
        self.o = L.Affine(d, d, dtype, device)
        self.ln1 = L.Norm(d, device)
        self.fc1 = L.Affine(d, cfg.ffn_dim, dtype, device)
        self.fc2 = L.Affine(cfg.ffn_dim, d, dtype, device)
        self.ln2 = L.Norm(d, device)


class XLMRoberta(nn.Module):
    """``token_embed``, ``type_embed``, ``pos_embed``, ``embed_ln``,
    ``blocks``."""

    def __init__(self, cfg: XLMRobertaConfig, device="cpu", dtype=None):
        super().__init__()
        dtype = dtype or _DTYPES[cfg.dtype]
        d = cfg.dim
        self.token_embed = L.param((cfg.vocab_size, d), dtype, device)
        self.type_embed = L.param((cfg.type_size, d), dtype, device)
        self.pos_embed = L.param((cfg.max_positions, d), dtype, device)
        self.embed_ln = L.Norm(d, device)
        self.blocks = nn.ModuleList(XLMRobertaBlock(cfg, dtype, device)
                                    for _ in range(cfg.num_layers))


@torch.no_grad()
def init_xlm_roberta_(model: XLMRoberta, generator: torch.Generator):
    """Seeded init with the JAX init's distributions."""
    for mod in model.modules():
        L.init_affine_or_norm_(mod, generator)
    model.token_embed.normal_(0.0, 0.02, generator=generator)
    model.type_embed.zero_()
    model.pos_embed.normal_(0.0, 0.02, generator=generator)
    return model


def xlm_roberta_encode(model: XLMRoberta, cfg: XLMRobertaConfig,
                       token_ids):
    """ids [B, L] (``pad_id`` padding) -> token states [B, L, dim]."""
    b, s = token_ids.shape
    mask = token_ids != cfg.pad_id
    pos = torch.cumsum(mask.long(), dim=1) * mask + cfg.pad_id
    h = (model.token_embed[token_ids]
         + model.type_embed[torch.zeros_like(token_ids)]
         + model.pos_embed[pos])
    h = L.layer_norm(h, model.embed_ln.w, model.embed_ln.b, eps=cfg.eps)
    n = cfg.num_heads
    hd = cfg.dim // n
    bias = torch.where(mask[:, None, None, :], 0.0, -1e30)
    for blk in model.blocks:
        q = blk.q(h).reshape(b, s, n, hd)
        k = blk.k(h).reshape(b, s, n, hd)
        v = blk.v(h).reshape(b, s, n, hd)
        logits = torch.einsum("bqhd,bkhd->bhqk", q.float(),
                              k.float()) * hd ** -0.5 + bias
        a = torch.softmax(logits, dim=-1)
        attn = torch.einsum("bhqk,bkhd->bqhd", a, v.float())
        attn = attn.reshape(b, s, cfg.dim).to(h.dtype)
        h = L.layer_norm(h + blk.o(attn), blk.ln1.w, blk.ln1.b, eps=cfg.eps)
        y = blk.fc2(F.gelu(blk.fc1(h)))
        h = L.layer_norm(h + y, blk.ln2.w, blk.ln2.b, eps=cfg.eps)
    return h

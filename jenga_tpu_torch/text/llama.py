"""Llama-style causal LM encoder for HunyuanVideo's LLM text conditioning.

Port of ``jenga_tpu/text/llama.py`` (RMSNorm, half-rotate RoPE, GQA,
SwiGLU): ``llama_hidden_states`` returns the hidden state after each
block, as HF's ``hidden_states`` does, and stops at ``num_layers`` when
asked to (HunyuanVideo reads ``hidden_states[-(skip + 1)]``). Attention
is a plain f32 matmul and softmax with the ``-1e30`` causal and padding
bias, as in the JAX function (no attention kernel: the JAX package runs
this product outside any Pallas kernel).

Parameter names follow the JAX pytree (``blocks.3.q.w``); linear weights
are ``[out, in]``. The module's dtype is the caller's (``from_pretrained``
loads f32, as the JAX converter gives). The decode functions
(``llama_prefill`` / ``llama_decode_step`` / ``llama_generate``), whose
one caller is prompt extension, are not ported.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch
from torch import nn

from ..models import layers as L

__all__ = ["LlamaConfig", "Llama", "init_llama_", "llama_hidden_states",
           "PROMPT_TEMPLATE_VIDEO", "PROMPT_TEMPLATE_IMAGE",
           "NEGATIVE_PROMPT", "CROP_START"]

# reference templates (hyvideo/constants.py)
PROMPT_TEMPLATE_IMAGE = (
    "<|start_header_id|>system<|end_header_id|>\n\nDescribe the image by "
    "detailing the color, shape, size, texture, quantity, text, spatial "
    "relationships of the objects and background:<|eot_id|>"
    "<|start_header_id|>user<|end_header_id|>\n\n{}<|eot_id|>")
PROMPT_TEMPLATE_VIDEO = (
    "<|start_header_id|>system<|end_header_id|>\n\nDescribe the video by "
    "detailing the following aspects: "
    "1. The main content and theme of the video."
    "2. The color, shape, size, texture, quantity, text, and spatial "
    "relationships of the objects."
    "3. Actions, events, behaviors temporal relationships, physical "
    "movement changes of the objects."
    "4. background environment, light, style and atmosphere."
    "5. camera angles, movements, and transitions used in the video:"
    "<|eot_id|><|start_header_id|>user<|end_header_id|>\n\n{}<|eot_id|>")
NEGATIVE_PROMPT = (
    "Aerial view, aerial view, overexposed, low quality, deformation, a "
    "poor composition, bad hands, bad teeth, bad eyes, bad limbs, "
    "distortion")
CROP_START = {"image": 36, "video": 95}

_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


@dataclasses.dataclass(frozen=True)
class LlamaConfig:
    vocab_size: int = 128320
    hidden_size: int = 4096
    intermediate_size: int = 14336
    num_layers: int = 32
    num_heads: int = 32
    num_kv_heads: int = 8
    rope_theta: float = 500000.0
    rms_eps: float = 1e-5
    dtype: str = "bfloat16"

    @property
    def head_dim(self) -> int:
        return self.hidden_size // self.num_heads


class LlamaBlock(nn.Module):
    def __init__(self, cfg: LlamaConfig, dtype, device, bias: bool):
        super().__init__()
        d, kvd = cfg.hidden_size, cfg.num_kv_heads * cfg.head_dim
        ffn, f32 = cfg.intermediate_size, torch.float32
        self.input_norm = L.param((d,), f32, device)
        self.q = L.Affine(d, d, dtype, device, bias=bias)
        self.k = L.Affine(d, kvd, dtype, device, bias=bias)
        self.v = L.Affine(d, kvd, dtype, device, bias=bias)
        self.o = L.Affine(d, d, dtype, device, bias=bias)
        self.post_norm = L.param((d,), f32, device)
        self.gate = L.Affine(d, ffn, dtype, device, bias=False)
        self.up = L.Affine(d, ffn, dtype, device, bias=False)
        self.down = L.Affine(ffn, d, dtype, device, bias=False)


class Llama(nn.Module):
    """``embed`` [vocab, d], ``blocks``, ``final_norm`` and, for an untied
    checkpoint, ``lm_head``; ``bias`` gives q/k/v/o biases (Qwen2-style
    checkpoints). ``dtype`` defaults to the config's."""

    def __init__(self, cfg: LlamaConfig, device="cpu", dtype=None,
                 bias: bool = False, lm_head: bool = False):
        super().__init__()
        dtype = dtype or _DTYPES[cfg.dtype]
        d = cfg.hidden_size
        self.embed = L.param((cfg.vocab_size, d), dtype, device)
        self.blocks = nn.ModuleList(LlamaBlock(cfg, dtype, device, bias)
                                    for _ in range(cfg.num_layers))
        self.final_norm = L.param((d,), torch.float32, device)
        if lm_head:
            self.lm_head = L.Affine(d, cfg.vocab_size, dtype, device,
                                    bias=False)


@torch.no_grad()
def init_llama_(model: Llama, generator: torch.Generator) -> Llama:
    """Seeded init with the JAX init's distributions: linears
    U(+-sqrt(6/(in+out))), the embedding N(0, 0.02^2), norms 1."""
    for mod in model.modules():
        L.init_affine_or_norm_(mod, generator)
    model.embed.normal_(0.0, 0.02, generator=generator)
    for blk in model.blocks:
        blk.input_norm.fill_(1.0)
        blk.post_norm.fill_(1.0)
    model.final_norm.fill_(1.0)
    return model


def _rope_half(x, cos, sin):
    """Llama convention: rotate (first half, second half) pairs, in f32."""
    hd = x.shape[-1]
    x1, x2 = x[..., :hd // 2].float(), x[..., hd // 2:].float()
    c, s = cos[None, :, None, :], sin[None, :, None, :]
    return torch.cat([x1 * c - x2 * s, x2 * c + x1 * s], dim=-1).to(x.dtype)


def llama_hidden_states(model: Llama, cfg: LlamaConfig, token_ids,
                        attention_mask, num_layers: int | None = None,
                        inputs_embeds=None):
    """Run the causal LM; returns the hidden state after each block as a
    list (index 0 = the embeddings). ``num_layers`` truncates the stack;
    at full depth the last entry is the final-normed output (HF's
    convention), else every entry is a raw block output.
    ``inputs_embeds`` replaces the embedding lookup (llava's splice)."""
    h = (inputs_embeds if inputs_embeds is not None
         else model.embed[token_ids])
    b, s, d = h.shape
    n, nkv, hd = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    cos, sin = (torch.from_numpy(a).to(h.device)
                for a in L.rope_table_1d(np.arange(s), hd,
                                         theta=cfg.rope_theta))
    mask = attention_mask.bool()
    causal = torch.ones((s, s), dtype=torch.bool, device=h.device).tril()
    bias = torch.where(causal[None] & mask[:, None, :], 0.0, -1e30)

    states = [h]
    depth = num_layers if num_layers is not None else cfg.num_layers
    for blk in model.blocks[:depth]:
        x = L.rms_norm(h, blk.input_norm, cfg.rms_eps)
        q = _rope_half(blk.q(x).reshape(b, s, n, hd), cos, sin)
        k = _rope_half(blk.k(x).reshape(b, s, nkv, hd), cos, sin)
        v = blk.v(x).reshape(b, s, nkv, hd)
        if nkv != n:
            k = k.repeat_interleave(n // nkv, dim=2)
            v = v.repeat_interleave(n // nkv, dim=2)
        logits = torch.einsum("bqhd,bkhd->bhqk", q.float(),
                              k.float()) * hd ** -0.5
        a = torch.softmax(logits + bias[:, None], dim=-1)
        attn = torch.einsum("bhqk,bkhd->bqhd", a, v.float())
        h = h + blk.o(attn.reshape(b, s, d).to(h.dtype))
        x = L.rms_norm(h, blk.post_norm, cfg.rms_eps)
        h = h + blk.down(L.silu(blk.gate(x)) * blk.up(x))
        states.append(h)
    if depth == cfg.num_layers:
        states[-1] = L.rms_norm(h, model.final_norm, cfg.rms_eps)
    return states

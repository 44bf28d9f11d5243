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
loads f32, as the JAX converter gives). Attention biases follow the
checkpoint: Qwen2 has q/k/v biases and none on o, HF Llama with
``attention_bias`` all four (``bias_flags`` reads them from a converted
state dict).

Decoding with a KV cache (``init_kv_cache``, ``llama_prefill``,
``llama_decode_step``, ``llama_generate``; the local prompt expanders'
path) runs eagerly, as the JAX functions compute: an f32 cache
``[B, max_len, kv_heads, head_dim]`` per layer, right-padded prompts,
f32 einsum + softmax attention with the ``-1e30`` bias, the head tied to
``embed`` unless an ``lm_head`` is present, and Gumbel-max sampling from
an explicit ``torch.Generator``.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..models import layers as L

__all__ = ["LlamaConfig", "Llama", "init_llama_", "bias_flags",
           "llama_hidden_states", "init_kv_cache", "llama_prefill",
           "llama_decode_step", "llama_generate", "PROMPT_TEMPLATE_VIDEO",
           "PROMPT_TEMPLATE_IMAGE", "NEGATIVE_PROMPT", "CROP_START"]

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
    def __init__(self, cfg: LlamaConfig, dtype, device, qkv_bias: bool,
                 o_bias: bool):
        super().__init__()
        d, kvd = cfg.hidden_size, cfg.num_kv_heads * cfg.head_dim
        ffn, f32 = cfg.intermediate_size, torch.float32
        self.input_norm = L.param((d,), f32, device)
        self.q = L.Affine(d, d, dtype, device, bias=qkv_bias)
        self.k = L.Affine(d, kvd, dtype, device, bias=qkv_bias)
        self.v = L.Affine(d, kvd, dtype, device, bias=qkv_bias)
        self.o = L.Affine(d, d, dtype, device, bias=o_bias)
        self.post_norm = L.param((d,), f32, device)
        self.gate = L.Affine(d, ffn, dtype, device, bias=False)
        self.up = L.Affine(d, ffn, dtype, device, bias=False)
        self.down = L.Affine(ffn, d, dtype, device, bias=False)


class Llama(nn.Module):
    """``embed`` [vocab, d], ``blocks``, ``final_norm`` and, for an untied
    checkpoint, ``lm_head``; ``qkv_bias`` gives q/k/v biases (Qwen2 and
    HF Llama with ``attention_bias``), ``o_bias`` the o bias (HF Llama
    with ``attention_bias`` only). ``dtype`` defaults to the config's."""

    def __init__(self, cfg: LlamaConfig, device="cpu", dtype=None,
                 qkv_bias: bool = False, o_bias: bool = False,
                 lm_head: bool = False):
        super().__init__()
        dtype = dtype or _DTYPES[cfg.dtype]
        d = cfg.hidden_size
        self.embed = L.param((cfg.vocab_size, d), dtype, device)
        self.blocks = nn.ModuleList(
            LlamaBlock(cfg, dtype, device, qkv_bias, o_bias)
            for _ in range(cfg.num_layers))
        self.final_norm = L.param((d,), torch.float32, device)
        if lm_head:
            self.lm_head = L.Affine(d, cfg.vocab_size, dtype, device,
                                    bias=False)


def bias_flags(tree: dict, prefix: str = "") -> dict:
    """``Llama``'s ``qkv_bias``/``o_bias``/``lm_head`` for a converted
    state dict (``prefix`` "llm." for a llava's): each bias as the tree
    holds it, as JAX's converter keeps a bias only where the checkpoint
    has one."""
    return {"qkv_bias": f"{prefix}blocks.0.q.b" in tree,
            "o_bias": f"{prefix}blocks.0.o.b" in tree,
            "lm_head": f"{prefix}lm_head.w" in tree}


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


def _rope_tables(cfg: LlamaConfig, max_len: int, device):
    return tuple(torch.from_numpy(a).to(device) for a in L.rope_table_1d(
        np.arange(max_len), cfg.head_dim, theta=cfg.rope_theta))


def _ffn(blk, cfg: LlamaConfig, h):
    """The block's SwiGLU half with its residual."""
    x = L.rms_norm(h, blk.post_norm, cfg.rms_eps)
    return h + blk.down(L.silu(blk.gate(x)) * blk.up(x))


def _block(blk, cfg: LlamaConfig, h, cos, sin, bias, layer=None):
    """One block over a whole [B, s, d] sequence under ``bias``; with a
    cache ``layer`` its k/v (after RoPE, before the GQA repeat) are
    written into the layer's first s entries, in f32."""
    b, s, _ = h.shape
    n, nkv, hd = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    x = L.rms_norm(h, blk.input_norm, cfg.rms_eps)
    q = _rope_half(blk.q(x).reshape(b, s, n, hd), cos, sin)
    k = _rope_half(blk.k(x).reshape(b, s, nkv, hd), cos, sin)
    v = blk.v(x).reshape(b, s, nkv, hd)
    if layer is not None:
        layer["k"][:, :s] = k.float()
        layer["v"][:, :s] = v.float()
    if nkv != n:
        k = k.repeat_interleave(n // nkv, dim=2)
        v = v.repeat_interleave(n // nkv, dim=2)
    logits = torch.einsum("bqhd,bkhd->bhqk", q.float(),
                          k.float()) * hd ** -0.5
    a = torch.softmax(logits + bias[:, None], dim=-1)
    attn = torch.einsum("bhqk,bkhd->bqhd", a, v.float())
    return _ffn(blk, cfg, h + blk.o(attn.reshape(b, s, -1).to(h.dtype)))


def _causal_bias(attention_mask, s: int):
    """The ``-1e30`` causal + padding bias [B, s, s] of a [B, s] mask."""
    causal = torch.ones((s, s), dtype=torch.bool,
                        device=attention_mask.device).tril()
    return torch.where(causal[None] & attention_mask.bool()[:, None, :],
                       0.0, -1e30)


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
    s = h.shape[1]
    cos, sin = _rope_tables(cfg, s, h.device)
    bias = _causal_bias(attention_mask, s)

    states = [h]
    depth = num_layers if num_layers is not None else cfg.num_layers
    for blk in model.blocks[:depth]:
        h = _block(blk, cfg, h, cos, sin, bias)
        states.append(h)
    if depth == cfg.num_layers:
        states[-1] = L.rms_norm(h, model.final_norm, cfg.rms_eps)
    return states


# ------------------------------------------------------------- generation


def init_kv_cache(cfg: LlamaConfig, batch: int, max_len: int, device):
    """Per-layer KV cache tensors [B, max_len, kv_heads, head_dim] (f32)
    on ``device``, the device of the model they serve."""
    shape = (batch, max_len, cfg.num_kv_heads, cfg.head_dim)
    return [{"k": torch.zeros(shape, dtype=torch.float32, device=device),
             "v": torch.zeros(shape, dtype=torch.float32, device=device)}
            for _ in range(cfg.num_layers)]


def _logits(model: Llama, h):
    """The head over the final-normed states, in f32: ``lm_head`` when the
    checkpoint has one, else tied to ``embed``."""
    head = getattr(model, "lm_head", None)
    out = head(h) if head is not None else F.linear(h, model.embed)
    return out.float()


def _attn_with_cache(q, k_cache, v_cache, n, nkv, valid_len):
    """q [B, Tq, n, hd] against the cache's first ``valid_len`` [B]
    entries."""
    b, tq, _, hd = q.shape
    max_len = k_cache.shape[1]
    if nkv != n:
        k_cache = k_cache.repeat_interleave(n // nkv, dim=2)
        v_cache = v_cache.repeat_interleave(n // nkv, dim=2)
    logits = torch.einsum("bqhd,bkhd->bhqk", q.float(), k_cache) * hd ** -0.5
    pos_k = torch.arange(max_len, device=q.device)[None, None, None, :]
    mask = pos_k < valid_len.reshape(-1, 1, 1, 1)
    a = torch.softmax(torch.where(mask, logits, -1e30), dim=-1)
    out = torch.einsum("bhqk,bkhd->bqhd", a, v_cache)
    return out.reshape(b, tq, n * hd)


@torch.no_grad()
def llama_prefill(model: Llama, cfg: LlamaConfig, token_ids, attention_mask,
                  max_len: int, inputs_embeds=None):
    """Run the prompt through the LM, filling a KV cache of ``max_len``.

    Returns (logits at each sample's last real token [B, vocab] f32,
    cache, lengths [B]). Prompts are right-padded (positions = arange);
    ``inputs_embeds`` replaces the embedding lookup (llava's splice;
    ``token_ids`` may then be None)."""
    h = (inputs_embeds if inputs_embeds is not None
         else model.embed[token_ids])
    b, s = h.shape[:2]
    cos, sin = (t[:s] for t in _rope_tables(cfg, max_len, h.device))
    lengths = attention_mask.int().sum(-1)
    bias = _causal_bias(attention_mask, s)

    cache = init_kv_cache(cfg, b, max_len, h.device)
    for blk, layer in zip(model.blocks, cache):
        h = _block(blk, cfg, h, cos, sin, bias, layer)
    h = L.rms_norm(h, model.final_norm, cfg.rms_eps)
    last = h[torch.arange(b, device=h.device), lengths.long() - 1]
    return _logits(model, last), cache, lengths


def _rope_pointwise(x, cos, sin):
    hd = x.shape[-1]
    x1, x2 = x[..., :hd // 2].float(), x[..., hd // 2:].float()
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin],
                     dim=-1).to(x.dtype)


@torch.no_grad()
def llama_decode_step(model: Llama, cfg: LlamaConfig, token, pos, cache,
                      rope_cos, rope_sin):
    """One decode step: ``token`` [B] at position ``pos`` [B] (0-based),
    against ``cache``, which it updates in place. Returns (logits
    [B, vocab] f32, cache)."""
    b = token.shape[0]
    n, nkv, hd = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    pos = pos.long()
    cos = rope_cos[pos][:, None, None, :]   # [B, 1, 1, hd/2] per sample
    sin = rope_sin[pos][:, None, None, :]
    rows = torch.arange(b, device=pos.device)

    h = model.embed[token][:, None]         # [B, 1, d]
    for blk, layer in zip(model.blocks, cache):
        x = L.rms_norm(h, blk.input_norm, cfg.rms_eps)
        q = _rope_pointwise(blk.q(x).reshape(b, 1, n, hd), cos, sin)
        k = _rope_pointwise(blk.k(x).reshape(b, 1, nkv, hd), cos, sin)
        v = blk.v(x).reshape(b, 1, nkv, hd)
        # k/v at pos per sample: REPLACE, never add. In a ragged
        # right-padded batch the prefill left pad-token k/v there, and
        # adding on top corrupts every shorter sample's cache
        layer["k"][rows, pos] = k[:, 0].float()
        layer["v"][rows, pos] = v[:, 0].float()
        attn = _attn_with_cache(q, layer["k"], layer["v"], n, nkv, pos + 1)
        h = _ffn(blk, cfg, h + blk.o(attn.to(h.dtype)))
    h = L.rms_norm(h, model.final_norm, cfg.rms_eps)[:, 0]
    return _logits(model, h), cache


def gumbel(generator: torch.Generator, shape, device):
    """Gumbel(0, 1) draws from ``generator``, as ``jax.random.gumbel``
    makes them from uniforms in [tiny, 1)."""
    tiny = torch.finfo(torch.float32).tiny
    u = torch.rand(shape, generator=generator, device=device)
    return -torch.log(-torch.log(u.clamp_min(tiny)))


@torch.no_grad()
def llama_generate(model: Llama, cfg: LlamaConfig, token_ids,
                   attention_mask, max_new_tokens: int = 128,
                   eos_token_id=None, temperature: float = 0.0,
                   generator: torch.Generator | None = None,
                   inputs_embeds=None, noise=None):
    """Greedy (or sampled) decoding with a KV cache.

    ``token_ids`` [B, S] right-padded prompts (None with
    ``inputs_embeds``). Returns a list of generated token-id lists (without
    the prompt), each stopped at ``eos_token_id``. With ``temperature >
    0`` and a ``generator`` each step draws by Gumbel-max, ``argmax(logits
    / temperature + g)``, as ``jax.random.categorical`` does; ``noise(t,
    shape)`` gives step t's Gumbel draws in place of the generator's.
    Without a generator it is greedy, as JAX is without a key."""
    lead = inputs_embeds if inputs_embeds is not None else token_ids
    b, s = lead.shape[:2]
    max_len = s + max_new_tokens
    cos, sin = _rope_tables(cfg, max_len, lead.device)
    logits, cache, lengths = llama_prefill(
        model, cfg, token_ids, attention_mask, max_len,
        inputs_embeds=inputs_embeds)
    out = [[] for _ in range(b)]
    done = [False] * b
    pos = lengths.long()    # next write position per sample
    for t in range(max_new_tokens):
        if temperature > 0.0 and (generator is not None or noise is not None):
            g = (noise(t, logits.shape) if noise is not None
                 else gumbel(generator, logits.shape, logits.device))
            token = torch.argmax(logits / temperature + g.to(logits.device),
                                 dim=-1)
        else:
            token = torch.argmax(logits, dim=-1)
        tok_host = token.tolist()
        for i in range(b):
            if not done[i]:
                if eos_token_id is not None and tok_host[i] == eos_token_id:
                    done[i] = True
                else:
                    out[i].append(int(tok_host[i]))
        if all(done):
            break
        logits, cache = llama_decode_step(model, cfg, token, pos, cache,
                                          cos, sin)
        pos = pos + 1
    return out

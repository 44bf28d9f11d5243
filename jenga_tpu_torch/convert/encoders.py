"""Text and image encoder checkpoints -> the port's encoder state dicts.

Port of ``jenga_tpu/convert/encoders.py``, written as direct converters
like the DiT's (``convert/__init__.py``): each reference key goes straight
to the port module's name in ``[out, in]`` layout, with the dtype the JAX
converter gives (norm scales f32, the rest ``dtype``).

  * llama/llava LLM (HunyuanVideo ``text_encoder``, HF layout)
  * CLIP-L text (HunyuanVideo ``text_encoder_2``, HF CLIPTextModel)
  * UMT5-XXL (Wan ``models_t5_umt5-xxl-enc-bf16.pth``, the reference's
    own module layout, and the HF UMT5EncoderModel layout)
  * CLIP ViT-H vision and XLM-Roberta text towers (Wan I2V
    ``models_clip_open-clip-xlm-roberta-large-vit-huge-14.pth``)
"""

from __future__ import annotations

import torch

from . import _cast, _patch, _Writer

__all__ = ["strip_prefix", "convert_llama", "convert_clip_text",
           "convert_umt5_wan", "convert_umt5_hf", "convert_clip_vision_wan",
           "convert_xlm_roberta_wan", "convert_clip_vision_hf",
           "convert_llava"]


def strip_prefix(sd: dict, *prefixes: str) -> dict:
    """The sub-dict under the first prefix any key carries (the dict itself
    when none does): llava's ``language_model.``, CLIP's ``text_model.`` /
    ``visual.``."""
    for pre in prefixes:
        hit = {k[len(pre):]: v for k, v in sd.items() if k.startswith(pre)}
        if hit:
            return hit
    return sd


def _prefixed(out: dict, prefix: str) -> dict:
    return {f"{prefix}{k}": v for k, v in out.items()}


def convert_llama(sd: dict, cfg, dtype=torch.float32) -> dict:
    """HF LlamaModel / llava ``language_model`` state dict -> ``Llama``
    state dict (q/k/v/o biases kept when present; the LM head, which
    lives outside ``model.*`` in ForCausalLM dicts, when present)."""
    head = next((k for k in ("lm_head.weight",
                             "language_model.lm_head.weight") if k in sd),
                None)
    o = _Writer(strip_prefix(sd, "language_model.model.", "language_model.",
                             "model."), dtype)
    if head is not None:
        o.out["lm_head.w"] = _cast(sd[head], dtype)
    for i in range(cfg.num_layers):
        src, dst = f"layers.{i}", f"blocks.{i}"
        o.vec(f"{dst}.input_norm", f"{src}.input_layernorm.weight")
        for lin in ("q", "k", "v", "o"):
            o.big(f"{dst}.{lin}", f"{src}.self_attn.{lin}_proj")
        o.vec(f"{dst}.post_norm", f"{src}.post_attention_layernorm.weight")
        for lin in ("gate", "up", "down"):
            o.vec(f"{dst}.{lin}.w", f"{src}.mlp.{lin}_proj.weight", dtype)
    o.vec("embed", "embed_tokens.weight", dtype)
    o.vec("final_norm", "norm.weight")
    return o.out


def _clip_blocks(o: _Writer, n: int, src_pre: str, names: dict):
    for i in range(n):
        src, dst = f"{src_pre}.{i}", f"blocks.{i}"
        for ours, ref in names.items():
            if ours.startswith("ln"):
                o.norm(f"{dst}.{ours}", f"{src}.{ref}")
            else:
                o.big(f"{dst}.{ours}", f"{src}.{ref}")


_HF_BLOCK = {"ln1": "layer_norm1", "q": "self_attn.q_proj",
             "k": "self_attn.k_proj", "v": "self_attn.v_proj",
             "o": "self_attn.out_proj", "ln2": "layer_norm2",
             "fc1": "mlp.fc1", "fc2": "mlp.fc2"}


def convert_clip_text(sd: dict, cfg, dtype=torch.float32) -> dict:
    """HF CLIPTextModel state dict -> ``CLIPText`` state dict."""
    o = _Writer(strip_prefix(sd, "text_model."), dtype)
    _clip_blocks(o, cfg.num_layers, "encoder.layers", _HF_BLOCK)
    o.vec("token_embed", "embeddings.token_embedding.weight", dtype)
    o.vec("pos_embed", "embeddings.position_embedding.weight", dtype)
    o.norm("final_ln", "final_layer_norm")
    return o.out


def _t5(o: _Writer, cfg, block_pre: str, names: dict, rel_key,
        embed: str, final: str):
    dtype = o.dtype
    for i in range(cfg.num_layers):
        src, dst = f"{block_pre}.{i}", f"blocks.{i}"
        o.vec(f"{dst}.norm1", f"{src}.{names['norm1']}")
        o.vec(f"{dst}.norm2", f"{src}.{names['norm2']}")
        for lin in ("q", "k", "v", "o", "gate", "fc1", "fc2"):
            o.vec(f"{dst}.{lin}.w", f"{src}.{names[lin]}", dtype)
        if not cfg.shared_pos:
            o.vec(f"{dst}.rel_embedding", f"{src}.{names['rel']}")
    o.vec("embed", embed, dtype)
    o.vec("final_norm", final)
    if cfg.shared_pos:
        o.vec("rel_embedding", rel_key)
    return o.out


def convert_umt5_wan(sd: dict, cfg, dtype=torch.float32) -> dict:
    """Wan's own T5 module layout (``models_t5_umt5-xxl-enc-bf16.pth``) ->
    ``T5Encoder`` state dict."""
    names = {"norm1": "norm1.weight", "norm2": "norm2.weight",
             "q": "attn.q.weight", "k": "attn.k.weight",
             "v": "attn.v.weight", "o": "attn.o.weight",
             "gate": "ffn.gate.0.weight", "fc1": "ffn.fc1.weight",
             "fc2": "ffn.fc2.weight",
             "rel": "pos_embedding.embedding.weight"}
    return _t5(_Writer(sd, dtype), cfg, "blocks", names,
               "pos_embedding.embedding.weight", "token_embedding.weight",
               "norm.weight")


def convert_umt5_hf(sd: dict, cfg, dtype=torch.float32) -> dict:
    """HF UMT5EncoderModel state dict -> ``T5Encoder`` state dict."""
    att, ffn = "layer.0.SelfAttention", "layer.1.DenseReluDense"
    names = {"norm1": "layer.0.layer_norm.weight",
             "norm2": "layer.1.layer_norm.weight",
             "q": f"{att}.q.weight", "k": f"{att}.k.weight",
             "v": f"{att}.v.weight", "o": f"{att}.o.weight",
             "gate": f"{ffn}.wi_0.weight", "fc1": f"{ffn}.wi_1.weight",
             "fc2": f"{ffn}.wo.weight",
             "rel": f"{att}.relative_attention_bias.weight"}
    embed = ("encoder.embed_tokens.weight"
             if "encoder.embed_tokens.weight" in sd else "shared.weight")
    return _t5(_Writer(sd, dtype), cfg, "encoder.block", names,
               f"encoder.block.0.{att}.relative_attention_bias.weight",
               embed, "encoder.final_layer_norm.weight")


def convert_clip_vision_wan(sd: dict, cfg, dtype=torch.float32) -> dict:
    """Wan XLMRobertaCLIP ``visual.*`` -> ``CLIPVision`` state dict (the
    fused ``to_qkv`` split into q, k, v)."""
    o = _Writer(strip_prefix(sd, "visual."), dtype)
    d = cfg.hidden_size
    for i in range(cfg.num_layers):
        src, dst = f"transformer.{i}", f"blocks.{i}"
        o.norm(f"{dst}.ln1", f"{src}.norm1")
        for j, lin in enumerate(("q", "k", "v")):
            part = slice(j * d, (j + 1) * d)
            o.vec(f"{dst}.{lin}.w", f"{src}.attn.to_qkv.weight", dtype,
                  fn=lambda t, part=part: t[part])
            o.vec(f"{dst}.{lin}.b", f"{src}.attn.to_qkv.bias", dtype,
                  fn=lambda t, part=part: t[part])
        o.big(f"{dst}.o", f"{src}.attn.proj")
        o.norm(f"{dst}.ln2", f"{src}.norm2")
        o.big(f"{dst}.fc1", f"{src}.mlp.0")
        o.big(f"{dst}.fc2", f"{src}.mlp.2")
    o.vec("patch_embed.w", "patch_embedding.weight", dtype, fn=_patch)
    o.vec("cls_token", "cls_embedding", dtype)
    o.vec("pos_embed", "pos_embedding", dtype, fn=lambda t: t[0])
    o.norm("pre_ln", "pre_norm")
    o.norm("post_ln", "post_norm")
    return o.out


def convert_xlm_roberta_wan(sd: dict, cfg, dtype=torch.float32) -> dict:
    """Wan XLMRobertaCLIP ``textual.*`` -> ``XLMRoberta`` state dict."""
    o = _Writer(strip_prefix(sd, "textual."), dtype)
    _clip_blocks(o, cfg.num_layers, "blocks",
                 {"q": "attn.q", "k": "attn.k", "v": "attn.v",
                  "o": "attn.o", "ln1": "norm1", "fc1": "ffn.0",
                  "fc2": "ffn.2", "ln2": "norm2"})
    o.vec("token_embed", "token_embedding.weight", dtype)
    o.vec("type_embed", "type_embedding.weight", dtype)
    o.vec("pos_embed", "pos_embedding.weight", dtype)
    o.norm("embed_ln", "norm")
    return o.out


def convert_clip_vision_hf(sd: dict, cfg, dtype=torch.float32) -> dict:
    """HF CLIPVisionModel (``vision_model.*``, llava's tower) ->
    ``CLIPVision`` state dict."""
    o = _Writer(strip_prefix(sd, "vision_model."), dtype)
    _clip_blocks(o, cfg.num_layers, "encoder.layers", _HF_BLOCK)
    o.vec("patch_embed.w", "embeddings.patch_embedding.weight", dtype,
          fn=_patch)
    o.vec("cls_token", "embeddings.class_embedding", dtype,
          fn=lambda t: t.reshape(1, 1, -1))
    o.vec("pos_embed", "embeddings.position_embedding.weight", dtype)
    o.norm("pre_ln", "pre_layrnorm")      # HF's spelling
    o.norm("post_ln", "post_layernorm")
    return o.out


def convert_llava(sd: dict, llm_cfg, vision_cfg,
                  dtype=torch.float32) -> dict:
    """HF LlavaForConditionalGeneration state dict -> ``Llava`` state dict
    (``vision.*``, ``projector.*``, ``llm.*``)."""
    # transformers >= 4.52 moved the weights under model.*
    if any(k.startswith("model.language_model.") for k in sd):
        sd = {k[len("model."):] if k.startswith("model.") else k: v
              for k, v in sd.items()}
    proj = _Writer(strip_prefix(sd, "multi_modal_projector."), dtype)
    proj.big("fc1", "linear_1")
    proj.big("fc2", "linear_2")
    return {**_prefixed(convert_clip_vision_hf(
                strip_prefix(sd, "vision_tower."), vision_cfg, dtype),
                "vision."),
            **_prefixed(proj.out, "projector."),
            **_prefixed(convert_llama(sd, llm_cfg, dtype), "llm.")}

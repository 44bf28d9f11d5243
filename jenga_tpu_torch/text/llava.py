"""Llava multimodal encoder for HunyuanVideo-I2V prompt conditioning.

Port of ``jenga_tpu/text/llava.py``: the CLIP ViT-L/336 tower (features at
hidden layer -2, the class token dropped) -> a two-layer MLP projector ->
the 576 image embeddings spliced in at the ``<image>`` token -> the llama
LM; then ``extract_i2v_tokens`` takes the interleave-strided image tokens
[5:581] and the template-cropped text tokens and concatenates them.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from ..models import layers as L
from .clip import (CLIP_L_VISION_336, CLIPVision, clip_vision_encode,
                   init_clip_vision_)
from .llama import Llama, LlamaConfig, init_llama_, llama_hidden_states

__all__ = ["PROMPT_TEMPLATE_I2V_IMAGE", "PROMPT_TEMPLATE_I2V_VIDEO",
           "NEGATIVE_PROMPT_I2V", "I2V_TEMPLATE_INFO", "Llava", "init_llava_",
           "llava_encode", "llava_splice", "extract_i2v_tokens"]

# reference templates (hyvideo_i2v/constants.py)
PROMPT_TEMPLATE_I2V_IMAGE = (
    "<|start_header_id|>system<|end_header_id|>\n\n<image>\nDescribe the "
    "image by detailing the color, shape, size, texture, "
    "quantity, text, spatial relationships of the objects and background:"
    "<|eot_id|>"
    "<|start_header_id|>user<|end_header_id|>\n\n{}<|eot_id|>"
    "<|start_header_id|>assistant<|end_header_id|>\n\n")
PROMPT_TEMPLATE_I2V_VIDEO = (
    "<|start_header_id|>system<|end_header_id|>\n\n<image>\nDescribe the "
    "video by detailing the following aspects according to the reference "
    "image: "
    "1. The main content and theme of the video."
    "2. The color, shape, size, texture, quantity, text, and spatial "
    "relationships of the objects."
    "3. Actions, events, behaviors temporal relationships, physical "
    "movement changes of the objects."
    "4. background environment, light, style and atmosphere."
    "5. camera angles, movements, and transitions used in the video:"
    "<|eot_id|>\n\n"
    "<|start_header_id|>user<|end_header_id|>\n\n{}<|eot_id|>"
    "<|start_header_id|>assistant<|end_header_id|>\n\n")
NEGATIVE_PROMPT_I2V = ("deformation, a poor composition and deformed "
                       "video, bad teeth, bad eyes, bad limbs")

# crop/splice geometry per template; expected_double_returns: the "\n\n"
# tokens the full video template yields (fewer means the prompt was
# truncated, and the sequence end becomes the crop anchor)
I2V_TEMPLATE_INFO = {
    "image": {"template": PROMPT_TEMPLATE_I2V_IMAGE, "crop_start": 36,
              "image_emb_start": 5, "image_emb_end": 581,
              "image_emb_len": 576, "double_return_token_id": 271},
    "video": {"template": PROMPT_TEMPLATE_I2V_VIDEO, "crop_start": 103,
              "image_emb_start": 5, "image_emb_end": 581,
              "image_emb_len": 576, "double_return_token_id": 271,
              "expected_double_returns": 4},
}


class Llava(nn.Module):
    """``vision`` (CLIPVision), ``projector`` (``fc1``, ``fc2``) and
    ``llm`` (Llama)."""

    def __init__(self, llm_cfg: LlamaConfig, vision_cfg=CLIP_L_VISION_336,
                 device="cpu", dtype=None, bias: bool = False,
                 lm_head: bool = False):
        super().__init__()
        self.vision = CLIPVision(vision_cfg, device, dtype)
        dt = self.vision.pos_embed.dtype
        self.projector = L.MLP(vision_cfg.hidden_size, llm_cfg.hidden_size,
                               llm_cfg.hidden_size, dt, device)
        self.llm = Llama(llm_cfg, device, dtype, bias=bias, lm_head=lm_head)


@torch.no_grad()
def init_llava_(model: Llava, generator: torch.Generator) -> Llava:
    init_clip_vision_(model.vision, generator)
    for mod in model.projector.modules():
        L.init_affine_or_norm_(mod, generator)
    init_llama_(model.llm, generator)
    return model


def llava_splice(model: Llava, token_ids, attention_mask, pixel_values,
                 image_token_pos: int, vision_cfg=CLIP_L_VISION_336):
    """Vision tower + projector + splice: the ``(inputs_embeds, mask)`` pair
    in which the one ``<image>`` token at ``image_token_pos`` becomes the
    projected patch embeddings."""
    feats = clip_vision_encode(model.vision, vision_cfg, pixel_values,
                               feature_layer=-2)[:, 1:]   # drop the class
    pr = model.projector
    img = pr.fc2(F.gelu(pr.fc1(feats)))
    embeds = model.llm.embed[token_ids]
    b, p = embeds.shape[0], image_token_pos
    spliced = torch.cat([embeds[:, :p], img.to(embeds.dtype),
                         embeds[:, p + 1:]], dim=1)
    mask = torch.cat([attention_mask[:, :p],
                      attention_mask.new_ones((b, img.shape[1])),
                      attention_mask[:, p + 1:]], dim=1)
    return spliced, mask


def llava_encode(model: Llava, llm_cfg, token_ids, attention_mask,
                 pixel_values, image_token_pos: int,
                 num_layers: int | None = None,
                 vision_cfg=CLIP_L_VISION_336):
    """Full llava forward on ``pixel_values`` [B, 3, 336, 336]
    (normalized): the llama hidden-states list over the spliced sequence,
    and its mask."""
    spliced, mask = llava_splice(model, token_ids, attention_mask,
                                 pixel_values, image_token_pos, vision_cfg)
    states = llama_hidden_states(model.llm, llm_cfg, None, mask,
                                 num_layers=num_layers,
                                 inputs_embeds=spliced)
    return states, mask


def extract_i2v_tokens(hidden, mask, mode: str = "video",
                       image_embed_interleave: int = 4, token_ids=None):
    """Llava hidden states -> DiT conditioning: the strided image tokens
    [start:end:interleave] and the template-cropped text tokens,
    concatenated. ``image_embed_interleave`` is 4 for token_replace, 2 for
    latent_concat. With ``token_ids`` (the unspliced prompt ids) the four
    assistant-header tokens before the last "\\n\\n" token (id 271) leave
    the text span too; a truncated template (fewer "\\n\\n" than expected)
    anchors at the sequence end. Tensors or numpy in, tensors out."""
    info = I2V_TEMPLATE_INFO[mode]
    s, e = info["image_emb_start"], info["image_emb_end"]
    text_start = info["crop_start"] - 1 + info["image_emb_len"]
    hidden, mask = torch.as_tensor(hidden), torch.as_tensor(mask)
    img_h = hidden[:, s:e:image_embed_interleave]
    img_m = mask[:, s:e:image_embed_interleave]
    if token_ids is None:
        return (torch.cat([img_h, hidden[:, text_start:]], dim=1),
                torch.cat([img_m, mask[:, text_start:]], dim=1))
    ids = torch.as_tensor(token_ids)
    out_h, out_m = [], []
    shift = info["image_emb_len"] - 1     # <image> -> 576 embeddings
    expected = info.get("expected_double_returns")
    for i in range(hidden.shape[0]):
        hits = torch.nonzero(ids[i] == info["double_return_token_id"])
        if len(hits) == 0 or (expected and len(hits) < expected):
            last = ids.shape[1]
        else:
            last = int(hits[-1, 0])
        acs, ace = last + shift - 4, last + shift   # spliced coordinates
        out_h.append(torch.cat([hidden[i, text_start:acs], hidden[i, ace:]]))
        out_m.append(torch.cat([mask[i, text_start:acs], mask[i, ace:]]))
    return (torch.cat([img_h, torch.stack(out_h)], dim=1),
            torch.cat([img_m, torch.stack(out_m)], dim=1))

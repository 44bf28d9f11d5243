"""Text conditioning: prompt templates, the tokenizer adapter, encoders.

Port of ``jenga_tpu/text/__init__.py``. The encoders (llama/llava, CLIP,
UMT5, XLM-Roberta) are ``nn.Module`` parameter holders with functional
forwards in this package; tokenization is HF's, on the host, and needs
the ``transformers`` package, which ``HFTokenizerAdapter`` imports on its
first use, never at import time: a sampler loads its checkpoints without
it, and tokenizing a prompt without it raises an ``ImportError`` that
names the package. Nothing here substitutes another tokenizer.
"""

from __future__ import annotations

import os

from .llama import (CROP_START, NEGATIVE_PROMPT, PROMPT_TEMPLATE_IMAGE,
                    PROMPT_TEMPLATE_VIDEO)

__all__ = ["apply_hyvideo_template", "crop_encoder_output",
           "HFTokenizerAdapter", "NEGATIVE_PROMPT",
           "PROMPT_TEMPLATE_IMAGE", "PROMPT_TEMPLATE_VIDEO", "CROP_START"]


def apply_hyvideo_template(prompt: str, mode: str = "video") -> str:
    """Wrap a user prompt in the instruct template whose tokens are later
    cropped."""
    template = (PROMPT_TEMPLATE_VIDEO if mode == "video"
                else PROMPT_TEMPLATE_IMAGE)
    return template.format(prompt)


def crop_encoder_output(hidden_states, mask, mode: str = "video"):
    """Strip the instruction-template tokens from the LLM states [B, L, d]
    and mask [B, L]."""
    crop = CROP_START[mode]
    return hidden_states[:, crop:], mask[:, crop:]


class HFTokenizerAdapter:
    """An HF tokenizer directory, loaded on first use: ``adapter(texts,
    max_length)`` -> ``(input_ids, attention_mask)`` numpy [B, L], padded
    to ``max_length``; ``adapter.tok`` is the HF tokenizer."""

    def __init__(self, path: str, max_length: int = 256):
        self.path = path
        self.max_length = max_length
        self._tok = None

    @property
    def tok(self):
        if self._tok is None:
            try:
                from transformers import AutoTokenizer
            except ImportError as e:
                raise ImportError(
                    f"tokenizing a prompt needs the 'transformers' package, "
                    f"which is not installed (tokenizer directory "
                    f"{self.path})") from e
            if not os.path.isdir(self.path):
                raise FileNotFoundError(
                    f"tokenizer directory {self.path} not found (the port "
                    f"reads tokenizers from disk only)")
            self._tok = AutoTokenizer.from_pretrained(
                self.path, local_files_only=True)
        return self._tok

    def __call__(self, texts, max_length: int | None = None):
        out = self.tok(
            texts if isinstance(texts, list) else [texts],
            padding="max_length", truncation=True,
            max_length=max_length or self.max_length,
            return_tensors="np")
        return out["input_ids"], out["attention_mask"]

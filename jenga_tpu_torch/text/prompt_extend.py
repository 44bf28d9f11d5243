"""Prompt extension / rewriting.

Port of ``jenga_tpu/text/prompt_extend.py``, the counterpart of the
reference's prompt expanders (DashScope API and local Qwen expanders) and
the HunyuanVideo rewrite templates. The five system prompts,
``PromptExpander`` and ``APIExpander`` (stdlib ``urllib``, numpy, PIL)
are the original's, line for line. The local expanders load an HF
checkpoint directory through the port's own readers and converters
(``convert``) into ``text.llama.Llama`` / ``text.llava.Llava`` on
``device`` and decode with ``text.llama.llama_generate`` (eager, f32
attention over an f32 KV cache). Their tokenizer is HF's, loaded from the
directory on first use (``transformers``, imported then, never at import
time); a caller may put another in the ``tok`` slot.
"""

from __future__ import annotations

import dataclasses
import json
import os

import numpy as np
import torch

__all__ = ["T2V_EXTEND_SYSTEM_PROMPT", "I2V_EXTEND_SYSTEM_PROMPT",
           "VL_EXTEND_SYSTEM_PROMPT",
           "REWRITE_NORMAL_SYSTEM_PROMPT", "REWRITE_MASTER_SYSTEM_PROMPT",
           "PromptExpander", "LocalLLMExpander", "LocalVLExpander",
           "APIExpander"]

T2V_EXTEND_SYSTEM_PROMPT = (
    "You are a prompt engineer for a text-to-video model. Expand the "
    "user's short prompt into a single detailed paragraph that specifies: "
    "the main subjects and their appearance (color, shape, size, texture, "
    "count), the actions and their temporal order, the background and "
    "lighting, the artistic style and atmosphere, and the camera angle "
    "and movement. Keep every element of the original prompt, invent only "
    "plausible supporting detail, and answer with the expanded prompt "
    "only.")

I2V_EXTEND_SYSTEM_PROMPT = (
    "You are a prompt engineer for an image-to-video model. Given an "
    "input image description and a user instruction, write one detailed "
    "paragraph describing how the scene evolves over time: motion of each "
    "subject, camera movement, lighting changes, and atmosphere, staying "
    "strictly consistent with the visible content of the image. Answer "
    "with the expanded prompt only.")

VL_EXTEND_SYSTEM_PROMPT = (
    "You are a prompt engineer for an image-to-video model and you can "
    "see the user's conditioning image. Rewrite the user's short "
    "instruction into one detailed English paragraph that is grounded in "
    "the actual image content: name the visible subjects and their "
    "colors, shapes, textures and positions, then describe how they move "
    "and how the camera moves over the course of the clip, plus lighting "
    "and atmosphere. Never contradict the image, keep every element of "
    "the user's instruction, and answer with the expanded prompt only.")

REWRITE_NORMAL_SYSTEM_PROMPT = (
    "Rewrite the user's video prompt so it is concrete and unambiguous: "
    "resolve pronouns, name the subjects explicitly, state spatial "
    "relations, and keep the original intent and all constraints. Output "
    "only the rewritten prompt.")

REWRITE_MASTER_SYSTEM_PROMPT = (
    "Rewrite the user's video prompt in a cinematic 'master shot' style: "
    "add professional cinematography vocabulary (lens, framing, movement, "
    "lighting design, color palette) while preserving the original "
    "content exactly. Output only the rewritten prompt.")


@dataclasses.dataclass
class PromptExpander:
    """Expand/rewrite prompts through a pluggable chat function."""

    chat_fn: object                   # callable(system, user) -> str
    mode: str = "t2v"                 # t2v | i2v | vl | rewrite | master

    def __call__(self, prompt: str, image_description: str = "",
                 image=None) -> str:
        system = {
            "t2v": T2V_EXTEND_SYSTEM_PROMPT,
            "i2v": I2V_EXTEND_SYSTEM_PROMPT,
            "vl": VL_EXTEND_SYSTEM_PROMPT,
            "rewrite": REWRITE_NORMAL_SYSTEM_PROMPT,
            "master": REWRITE_MASTER_SYSTEM_PROMPT,
        }[self.mode]
        user = prompt if not image_description else (
            f"Image: {image_description}\nInstruction: {prompt}")
        if image is not None:
            # vision-language chat_fn (e.g. LocalVLExpander) sees the image
            out = self.chat_fn(system, user, image=image)
        else:
            out = self.chat_fn(system, user)
        return out.strip() or prompt


class APIExpander:
    """Remote-API prompt expander — counterpart of the reference's
    ``DashScopePromptExpander`` (the reference's `wan/utils/
    prompt_extend.py:101-161`: DashScope ``Generation``/
    ``MultiModalConversation`` calls with retry). Speaks the
    OpenAI-compatible chat-completions JSON dialect that DashScope, vLLM,
    and most hosted LLM endpoints expose, over stdlib ``urllib`` (no SDK
    dependency). Plugs into :class:`PromptExpander` as ``chat_fn``.

    ``transport`` is the seam for tests / exotic backends: a callable
    ``(url, headers: dict, body: bytes, timeout: float) -> bytes``
    returning the raw JSON response. The default posts over HTTPS.
    """

    def __init__(self, model: str = "qwen-plus", url: str | None = None,
                 api_key: str | None = None, timeout: float = 30.0,
                 retries: int = 4, transport=None):
        import os

        self.model = model
        self.url = url or os.environ.get(
            "PROMPT_EXTEND_API_URL",
            "https://dashscope.aliyuncs.com/compatible-mode/v1"
            "/chat/completions")
        self.api_key = api_key if api_key is not None else (
            os.environ.get("DASH_API_KEY")        # reference env var name
            or os.environ.get("DASHSCOPE_API_KEY")
            or os.environ.get("OPENAI_API_KEY"))
        self.timeout = timeout
        self.retries = max(1, int(retries))
        self.transport = transport or self._http_post

    @staticmethod
    def _http_post(url, headers, body, timeout):
        import urllib.request

        req = urllib.request.Request(url, data=body, headers=headers,
                                     method="POST")
        with urllib.request.urlopen(req, timeout=timeout) as resp:
            return resp.read()

    @staticmethod
    def _image_part(image):
        """Image path / [3,H,W] uint8-able array -> data-URL content part
        (the reference uploads a local file to the multimodal endpoint;
        the OpenAI dialect inlines it as a base64 data URL)."""
        import base64

        if isinstance(image, str):
            with open(image, "rb") as f:
                raw = f.read()
            mime = ("image/png" if image.lower().endswith(".png")
                    else "image/jpeg")
        else:
            import io

            arr = np.asarray(image)
            if arr.ndim == 3 and arr.shape[0] in (1, 3):   # CHW -> HWC
                arr = np.moveaxis(arr, 0, -1)
            if arr.dtype != np.uint8:
                arr = np.clip(arr, 0, 255).astype(np.uint8)
            buf = io.BytesIO()
            try:
                from PIL import Image as _Image
                _Image.fromarray(arr.squeeze()).save(buf, format="PNG")
            except ImportError:
                # minimal fallback: raw npy payload (accepted by our own
                # transport seam in tests; real endpoints want PNG/JPEG)
                np.save(buf, arr)
            raw, mime = buf.getvalue(), "image/png"
        b64 = base64.b64encode(raw).decode("ascii")
        return {"type": "image_url",
                "image_url": {"url": f"data:{mime};base64,{b64}"}}

    def __call__(self, system: str, user: str, image=None) -> str:
        import json
        import time

        if image is None:
            user_content = user
        else:
            user_content = [{"type": "text", "text": user},
                            self._image_part(image)]
        body = json.dumps({
            "model": self.model,
            "messages": [{"role": "system", "content": system},
                         {"role": "user", "content": user_content}],
        }).encode("utf-8")
        headers = {"Content-Type": "application/json"}
        if self.api_key:
            headers["Authorization"] = f"Bearer {self.api_key}"
        err = None
        for attempt in range(self.retries):
            try:
                raw = self.transport(self.url, headers, body, self.timeout)
                resp = json.loads(raw)
                # OpenAI/DashScope-compatible dialect first, then the
                # native DashScope shape (output.choices / output.text)
                if "choices" in resp:
                    return resp["choices"][0]["message"]["content"]
                out = resp["output"]
                if "choices" in out:
                    return out["choices"][0]["message"]["content"]
                return out["text"]
            except Exception as e:  # noqa: BLE001 - retry any transport
                err = e             # or schema error, like the reference
                time.sleep(min(2.0 ** attempt * 0.5, 4.0))
        raise RuntimeError(
            f"prompt-extend API failed after {self.retries} attempts: "
            f"{type(err).__name__}: {err}") from err


def _read_config(model_dir: str) -> dict:
    with open(os.path.join(model_dir, "config.json")) as f:
        return json.load(f)


def _llama_config(hf: dict, dtype: str):
    """The expander's reading of an HF LM config: ``rope_theta`` 10000.0
    and ``rms_norm_eps`` 1e-6 by default (not the HunyuanVideo text
    encoder's), ``num_key_value_heads`` falling back to the head
    count."""
    from .llama import LlamaConfig
    return LlamaConfig(
        vocab_size=hf["vocab_size"],
        hidden_size=hf["hidden_size"],
        intermediate_size=hf["intermediate_size"],
        num_layers=hf["num_hidden_layers"],
        num_heads=hf["num_attention_heads"],
        num_kv_heads=hf.get("num_key_value_heads",
                            hf["num_attention_heads"]),
        rope_theta=hf.get("rope_theta", 10000.0),
        rms_eps=hf.get("rms_norm_eps", 1e-6),
        dtype=dtype)


def _state_dict(model_dir: str) -> dict:
    """The directory's weights: safetensors, else pytorch_model.bin."""
    from ..convert import load_safetensors_state_dict, load_torch_state_dict
    try:
        return load_safetensors_state_dict(model_dir)
    except FileNotFoundError:
        return load_torch_state_dict(
            os.path.join(model_dir, "pytorch_model.bin"))


def _chat_text(tok, system: str, user: str) -> str:
    """The tokenizer's chat template with a generation prompt, or
    ``f"{system}\\n\\n{user}\\n"`` where it has none."""
    messages = [{"role": "system", "content": system},
                {"role": "user", "content": user}]
    try:
        return tok.apply_chat_template(messages, tokenize=False,
                                       add_generation_prompt=True)
    except Exception:
        return f"{system}\n\n{user}\n"


class _LocalExpander:
    """The local expanders' common part: the model on ``device``, the
    tokenizer slot and the decoding settings."""

    def __init__(self, model_dir, max_new_tokens, temperature, device):
        from ..runtime import resolve_device
        self.model_dir = model_dir
        self.device = resolve_device(device)
        self.max_new_tokens = max_new_tokens
        self.temperature = temperature
        self._tok = None

    @property
    def tok(self):
        """The HF tokenizer of ``model_dir``, loaded on first use."""
        if self._tok is None:
            from . import HFTokenizerAdapter
            self._tok = HFTokenizerAdapter(self.model_dir).tok
        return self._tok

    @tok.setter
    def tok(self, value):
        self._tok = value

    def _load(self, make, tree):
        from ..runtime import _load_module
        return _load_module(make, tree, self.device)

    def _ids(self, text: str):
        ids = torch.tensor([self.tok.encode(text)], dtype=torch.long,
                           device=self.device)
        return ids, torch.ones_like(ids)

    def _generate(self, model, token_ids, mask, inputs_embeds=None) -> str:
        from .llama import llama_generate
        gen = (torch.Generator(device=self.device).manual_seed(0)
               if self.temperature > 0 else None)
        out = llama_generate(
            model, self.cfg, token_ids, mask,
            max_new_tokens=self.max_new_tokens,
            eos_token_id=self.tok.eos_token_id,
            temperature=self.temperature, generator=gen,
            inputs_embeds=inputs_embeds)
        return self.tok.decode(out[0], skip_special_tokens=True)


class LocalLLMExpander(_LocalExpander):
    """Local prompt-expander model (reference ``QwenPromptExpander``):
    loads any llama/Qwen2-architecture HF checkpoint dir (Qwen2's q/k/v
    biases and untied head included) into the port's LM on ``device`` and
    generates the expanded prompt with the KV cache."""

    def __init__(self, model_dir: str, max_new_tokens: int = 256,
                 temperature: float = 0.0, dtype: str = "bfloat16",
                 device="cuda"):
        from ..convert.encoders import convert_llama
        from .llama import _DTYPES, Llama, bias_flags
        super().__init__(model_dir, max_new_tokens, temperature, device)
        self.cfg = _llama_config(_read_config(model_dir), dtype)
        tree = convert_llama(_state_dict(model_dir), self.cfg,
                             dtype=_DTYPES[dtype])
        self.model = self._load(
            lambda dev: Llama(self.cfg, dev, **bias_flags(tree)), tree)

    @torch.inference_mode()
    def __call__(self, system: str, user: str) -> str:
        ids, mask = self._ids(_chat_text(self.tok, system, user))
        return self._generate(self.model, ids, mask)


class LocalVLExpander(_LocalExpander):
    """Image-conditioned prompt expander (reference ``QwenPromptExpander``
    with ``is_vl=True``): loads any llava-format HF checkpoint dir (vision
    tower + projector + llama) and expands the prompt while *seeing* the
    I2V conditioning image: the image's projected patches spliced in at
    the one ``<image>`` token, then KV-cache decoding."""

    def __init__(self, model_dir: str, max_new_tokens: int = 256,
                 temperature: float = 0.0, dtype: str = "bfloat16",
                 device="cuda"):
        from ..convert.encoders import convert_llava
        from .clip import CLIP_L_VISION_336 as L336
        from .clip import CLIPVisionConfig
        from .llama import _DTYPES, bias_flags
        from .llava import Llava
        super().__init__(model_dir, max_new_tokens, temperature, device)
        hf = _read_config(model_dir)
        self._image_token_id = hf.get("image_token_index", None)
        self.cfg = _llama_config(hf.get("text_config", hf), dtype)
        vis = hf.get("vision_config")
        self.vision_cfg = CLIPVisionConfig(
            image_size=vis.get("image_size", L336.image_size),
            patch_size=vis.get("patch_size", L336.patch_size),
            hidden_size=vis.get("hidden_size", L336.hidden_size),
            intermediate_size=vis.get("intermediate_size",
                                      L336.intermediate_size),
            num_layers=vis.get("num_hidden_layers", L336.num_layers),
            num_heads=vis.get("num_attention_heads", L336.num_heads),
            act=vis.get("hidden_act", L336.act),
        ) if vis else L336
        tree = convert_llava(_state_dict(model_dir), self.cfg,
                             self.vision_cfg, dtype=_DTYPES[dtype])
        self.model = self._load(
            lambda dev: Llava(self.cfg, self.vision_cfg, dev,
                              **bias_flags(tree, "llm.")), tree)

    @property
    def image_token_id(self):
        """``image_token_index`` of the config, else the tokenizer's
        ``<image>``."""
        if self._image_token_id is None:
            self._image_token_id = self.tok.convert_tokens_to_ids("<image>")
        return self._image_token_id

    def _pixel_values(self, image):
        """Image path / [3,H,W] array -> normalized [1,3,336,336] on the
        device: the bicubic resize and CLIP normalization of the
        samplers' image path."""
        from ..runtime import _clip_normalize, load_image
        if isinstance(image, str):
            image = load_image(image)
        return _clip_normalize(np.asarray(image, np.float32),
                               self.vision_cfg.image_size, self.device)

    @torch.inference_mode()
    def __call__(self, system: str, user: str, image=None) -> str:
        from .llava import llava_splice

        if image is None:
            raise ValueError("LocalVLExpander requires an image; use "
                             "LocalLLMExpander for text-only expansion")
        ids, mask = self._ids(_chat_text(self.tok, system,
                                         f"<image>\n{user}"))
        pos = torch.nonzero(ids[0] == self.image_token_id)[:, 0]
        if pos.numel() != 1:
            raise ValueError(
                f"prompt must contain exactly one <image> token "
                f"(id {self.image_token_id}), found {pos.numel()}")
        embeds, full_mask = llava_splice(
            self.model, ids, mask, self._pixel_values(image), int(pos[0]),
            vision_cfg=self.vision_cfg)
        return self._generate(self.model.llm, None, full_mask,
                              inputs_embeds=embeds)

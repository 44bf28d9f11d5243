"""Sampler entry points of the port: prompt (and image) to video.

``HunyuanVideoSampler.from_pretrained(ckpt_dir, ...)`` and
``WanSampler.from_pretrained(task, ckpt_dir, ...)`` build every component
from a checkpoint directory in the reference's layout, converted on the
fly (``convert``), or, without a directory, the DiT from a seeded random
init on the device and nothing else:

  hunyuan: pytorch_model_module.pt (deepspeed, or bare; also
           mp_rank_00_model_states.pt / pytorch_model_ema.pt), or with
           ``use_fp8`` pytorch_model_module_fp8.pt + its _fp8_map.pt,
           vae/pytorch_model.pt, text_encoder/ (HF llama or llava dir,
           safetensors or pytorch_model.bin, with config.json and its
           tokenizer), text_encoder_2/ (HF CLIP text dir)
  wan:     diffusion_pytorch_model.pth, or .safetensors (sharded with an
           index), Wan2.1_VAE.pth, models_t5_umt5-xxl-enc-bf16.pth with
           the google/umt5-xxl/ tokenizer dir, and for I2V
           models_clip_open-clip-xlm-roberta-large-vit-huge-14.pth

The DiT is held in the module's dtype (the JAX converter's ``dtype``
argument gives the same leaves); the encoders and VAEs in f32, as the
JAX loader holds them. ``predict_prompt`` / ``generate_prompt`` /
``generate_image`` go from a prompt to video; ``predict`` /
``predict_i2v`` / ``generate`` / ``generate_i2v`` take pre-encoded text
states (and, for I2V, conditioning latents and CLIP features).
``HunyuanVideoSampler(cfg, params=None, device=..., ...)`` and
``WanSampler(cfg, ...)`` build a sampler from a converted state dict or a
seeded init, with ``vae=`` and the encoders as modules; ``from_task``
builds a published Wan config by task name.

Offload: HunyuanVideo's ``use_cpu_offload`` keeps the text encoders and
the VAE weights on the CPU; the prompt is encoded there, and the VAE's
weights go to the card for one decode or encode and back after it. Wan's
``t5_on_host`` keeps UMT5 on the CPU. Tokenizing a prompt needs the
``transformers`` package (``text.HFTokenizerAdapter``); loading does not.
"""

from __future__ import annotations

import contextlib
import dataclasses
import json
import os

import numpy as np
import torch
import torch.nn.functional as F

from . import convert as C
from .codec import vae_hy, vae_wan
from .models import wan as wan_lib
from .models.fp8 import quantize_tree_fp8
from .models.hyvideo import (HUNYUAN_VIDEO_T2V, HYVideoConfig, HYVideoDiT,
                             hy_i2v_config, init_hyvideo_)
from .models.wan import WanConfig, WanDiT, init_wan_
from .pipelines.hyvideo_i2v import HYVideoI2VPipeline
from .pipelines.hyvideo_t2v import HYVideoT2VPipeline
from .pipelines.wan_i2v import WanI2VPipeline, i2v_latent_size
from .pipelines.wan_t2v import WanT2VPipeline

__all__ = ["HunyuanVideoSampler", "WanSampler", "resolve_device",
           "load_image", "WAN_DEFAULT_NEGATIVE_PROMPT"]

# CLIP image preprocessing constants
CLIP_MEAN = (0.48145466, 0.4578275, 0.40821073)
CLIP_STD = (0.26862954, 0.26130258, 0.27577711)

# the negative prompt Wan uses when none is given (the reference's
# sample_neg_prompt)
WAN_DEFAULT_NEGATIVE_PROMPT = (
    "色调艳丽，过曝，静态，细节模糊不清，字幕，风格，作品，画作，画面，静止，"
    "整体发灰，最差质量，低质量，JPEG压缩残留，丑陋的，残缺的，多余的手指，"
    "画得不好的手部，画得不好的脸部，畸形的，毁容的，形态畸形的肢体，"
    "手指融合，静止不动的画面，杂乱的背景，三条腿，背景人很多，倒着走")


def resolve_device(device) -> torch.device:
    """The device to run on; ``cuda`` without a card raises (there is no
    CPU fallback)."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("device 'cuda' requested but no CUDA device is "
                           "available (use --device cpu for a CPU run)")
    return device


def load_image(path: str) -> np.ndarray:
    """Image file -> [3, H, W] f32 in [0, 1] (RGB)."""
    from PIL import Image
    img = Image.open(path).convert("RGB")
    return np.asarray(img, np.float32).transpose(2, 0, 1) / 255.0


def _find(path, *names):
    for n in names:
        p = os.path.join(path, n)
        if os.path.exists(p):
            return p
    return None


def _resize_chw(img, h: int, w: int, device) -> torch.Tensor:
    """[C, H, W] -> [C, h, w] f32 on ``device``: the counterpart of
    ``jax.image.resize(..., "cubic")`` (Keys cubic, a = -0.5, with the
    kernel widened when downsampling), which is torch's antialiased
    bicubic; without ``antialias`` torch's bicubic takes a = -0.75 and no
    widening."""
    x = torch.as_tensor(img, dtype=torch.float32, device=device)
    return F.interpolate(x[None], size=(h, w), mode="bicubic",
                         align_corners=False, antialias=True)[0]


def _clip_normalize(img, size: int, device) -> torch.Tensor:
    """[3, H, W] in [0, 1] -> [1, 3, size, size], CLIP-normalized."""
    x = _resize_chw(img, size, size, device)
    mean = x.new_tensor(CLIP_MEAN)[:, None, None]
    std = x.new_tensor(CLIP_STD)[:, None, None]
    return ((x - mean) / std)[None]


def _build(model_cls, init_fn, cfg, params, device, seed):
    model = model_cls(cfg, device=device)
    if params is None:
        init_fn(model, torch.Generator(device=device).manual_seed(seed))
    else:
        model.load_state_dict(params, strict=True)
    return model


def _load_module(make, sd: dict, device) -> torch.nn.Module:
    """``make(device)`` built on the meta device, holding ``sd``'s tensors
    in their dtypes (the converter's), then placed on ``device``."""
    module = make("meta")
    module.load_state_dict(sd, strict=True, assign=True)
    return module.to(device)


def _device_of(module) -> torch.device:
    return next(module.parameters()).device


@contextlib.contextmanager
def _resident(vae, device):
    """The VAE for one call: as it is (``device`` None), or under offload
    moved to ``device`` for the call and back to the CPU after it."""
    if device is None:
        yield vae
        return
    vae.to(device)
    try:
        yield vae
    finally:
        vae.to("cpu")


def _ids(tok_out, device):
    return tuple(torch.as_tensor(np.asarray(a), device=device)
                 for a in tok_out)


class HunyuanVideoSampler:
    """T2V (or, with ``i2v``, I2V) sampler for HunyuanVideo.
    ``text_encoder`` is ``(tokenizer, LlamaConfig, Llama or Llava)``,
    ``text_encoder_2`` ``(tokenizer, CLIPTextConfig, CLIPText)``; with
    ``offload`` they and the VAE stay on the CPU."""

    TEXT_LEN = 256          # --text-len default
    SKIP_LAYER = 2          # --hidden-state-skip-layer default

    def __init__(self, cfg: HYVideoConfig, params=None, device="cuda",
                 seed: int = 0, i2v: bool = False, use_fp8: bool = False,
                 vae: vae_hy.HYVAE | None = None, text_encoder=None,
                 text_encoder_2=None, offload: bool = False):
        self.cfg = cfg
        self.device = resolve_device(device)
        self.offload = offload
        if offload:
            for part in (vae, text_encoder and text_encoder[2],
                         text_encoder_2 and text_encoder_2[2]):
                if part is not None:
                    part.to("cpu")
        self.vae = vae
        self.text_encoder = text_encoder
        self.text_encoder_2 = text_encoder_2
        self.model = _build(HYVideoDiT, init_hyvideo_, cfg, params,
                            self.device, seed)
        if use_fp8:
            # after the init or load, as the JAX from_pretrained does
            quantize_tree_fp8(self.model)
        pipe_cls = HYVideoI2VPipeline if i2v else HYVideoT2VPipeline
        self.pipeline = pipe_cls(self.model, vae_decode=self.decode_latents)

    @classmethod
    def from_pretrained(cls, ckpt_dir: str | None = None, i2v: bool = False,
                        seed: int = 0, dtype: str = "bfloat16",
                        use_fp8: bool = False, lora_path: str | None = None,
                        lora_alpha: float = 1.0,
                        use_cpu_offload: bool = False, device="cuda",
                        i2v_condition_type: str = "token_replace"):
        """The published model (``hy_i2v_config(i2v_condition_type)`` with
        ``i2v``) from ``ckpt_dir``: the DiT (``use_fp8`` prefers the fp8
        file, dequantized, then quantizes the loaded weights to e4m3 as
        without a checkpoint; ``lora_path`` merges a kohya LoRA first), the
        VAE and both text encoders where their files are; the DiT from a
        seeded init where its file is not, or without ``ckpt_dir``. A DiT
        whose ``img_in`` takes another channel count than the config
        raises."""
        device = resolve_device(device)
        base = dataclasses.replace(HUNYUAN_VIDEO_T2V, dtype=dtype)
        cfg = hy_i2v_config(i2v_condition_type, base) if i2v else base
        params = vae = text_encoder = text_encoder_2 = None
        aux = torch.device("cpu") if use_cpu_offload else device
        if ckpt_dir:
            fp8_path = _find(ckpt_dir, "pytorch_model_module_fp8.pt",
                             "pytorch_model_fp8.pt")
            dit_path = _find(ckpt_dir, "pytorch_model_module.pt",
                             "mp_rank_00_model_states.pt",
                             "pytorch_model_ema.pt")
            sd = None
            if use_fp8 and fp8_path:
                sd = C.load_fp8_state_dict(fp8_path)
            elif dit_path:
                sd = C.load_torch_state_dict(dit_path)
            if sd is not None:
                if lora_path:
                    sd = C.merge_lora(sd, lora_path, alpha=lora_alpha,
                                      prefix="Hunyuan_video_I2V")
                channels = sd["img_in.proj.weight"].shape[1]
                if channels != cfg.in_channels:
                    raise ValueError(
                        f"the checkpoint's img_in takes {channels} channels;"
                        f" the {cfg.i2v_condition_type or 'T2V'} config "
                        f"takes {cfg.in_channels}")
                params = C.convert_hyvideo_dit(sd, cfg, cfg.torch_dtype)
                del sd
            vae_path = _find(os.path.join(ckpt_dir, "vae"),
                             "pytorch_model.pt")
            if vae_path:
                vae = _load_module(
                    lambda dev: vae_hy.HYVAE(vae_hy.HYVAE_884_16C, dev),
                    C.convert_hyvae(C.load_torch_state_dict(vae_path),
                                    vae_hy.HYVAE_884_16C), aux)
            text_encoder = cls._load_llm(
                os.path.join(ckpt_dir, "text_encoder"), aux)
            text_encoder_2 = cls._load_clip(
                os.path.join(ckpt_dir, "text_encoder_2"), aux)
        return cls(cfg, params, device, seed, i2v=i2v, use_fp8=use_fp8,
                   vae=vae, text_encoder=text_encoder,
                   text_encoder_2=text_encoder_2, offload=use_cpu_offload)

    # ---------------------------------------------------------- encoders

    @staticmethod
    def _hf_state_dict(path):
        """An HF model directory's weights (safetensors first)."""
        if _find(path, "model.safetensors", "model.safetensors.index.json"):
            return C.load_safetensors_state_dict(path)
        pt = _find(path, "pytorch_model.bin", "pytorch_model.pt")
        return C.load_torch_state_dict(pt) if pt else None

    @classmethod
    def _load_llm(cls, path, device):
        """``(tokenizer, LlamaConfig, module)`` of an HF llama dir, or of a
        llava dir (with its vision tower and projector, for I2V prompts);
        None without one."""
        if not os.path.isdir(path):
            return None
        sd = cls._hf_state_dict(path)
        if sd is None:
            return None
        from .convert import encoders as E
        from .text import HFTokenizerAdapter
        from .text.clip import CLIP_L_VISION_336
        from .text.llama import Llama
        from .text.llava import Llava
        cfg = cls._llama_cfg_from_dir(path)
        tok = HFTokenizerAdapter(path, max_length=cls.TEXT_LEN)
        if any("vision_tower" in k for k in sd):
            tree = E.convert_llava(sd, cfg, CLIP_L_VISION_336)
            make = lambda dev: Llava(  # noqa: E731
                cfg, CLIP_L_VISION_336, dev, bias="llm.blocks.0.q.b" in tree,
                lm_head="llm.lm_head.w" in tree)
        else:
            tree = E.convert_llama(sd, cfg)
            make = lambda dev: Llama(  # noqa: E731
                cfg, dev, bias="blocks.0.q.b" in tree,
                lm_head="lm_head.w" in tree)
        del sd
        return (tok, cfg, _load_module(make, tree, device))

    @staticmethod
    def _llama_cfg_from_dir(path):
        from .text.llama import LlamaConfig
        cfg_path = os.path.join(path, "config.json")
        if not os.path.exists(cfg_path):
            return LlamaConfig()
        with open(cfg_path) as f:
            hf = json.load(f)
        hf = hf.get("text_config", hf)      # llava wrapper
        return LlamaConfig(
            vocab_size=hf.get("vocab_size", 128320),
            hidden_size=hf.get("hidden_size", 4096),
            intermediate_size=hf.get("intermediate_size", 14336),
            num_layers=hf.get("num_hidden_layers", 32),
            num_heads=hf.get("num_attention_heads", 32),
            num_kv_heads=hf.get("num_key_value_heads", 8),
            rope_theta=hf.get("rope_theta", 500000.0),
            rms_eps=hf.get("rms_norm_eps", 1e-5))

    @classmethod
    def _load_clip(cls, path, device):
        """``(tokenizer, CLIPTextConfig, CLIPText)`` of an HF CLIP text dir;
        None without one."""
        if not os.path.isdir(path):
            return None
        sd = cls._hf_state_dict(path)
        if sd is None:
            return None
        from .convert import encoders as E
        from .text import HFTokenizerAdapter
        from .text.clip import CLIPText, CLIPTextConfig
        ccfg = CLIPTextConfig()
        cfg_path = os.path.join(path, "config.json")
        if os.path.exists(cfg_path):
            with open(cfg_path) as f:
                hf = json.load(f)
            hf = hf.get("text_config", hf)
            ccfg = CLIPTextConfig(
                vocab_size=hf.get("vocab_size", ccfg.vocab_size),
                hidden_size=hf.get("hidden_size", ccfg.hidden_size),
                intermediate_size=hf.get("intermediate_size",
                                         ccfg.intermediate_size),
                num_layers=hf.get("num_hidden_layers", ccfg.num_layers),
                num_heads=hf.get("num_attention_heads", ccfg.num_heads),
                max_positions=hf.get("max_position_embeddings",
                                     ccfg.max_positions),
                eos_token_id=hf.get("eos_token_id", ccfg.eos_token_id))
        module = _load_module(lambda dev: CLIPText(ccfg, dev),
                              E.convert_clip_text(sd, ccfg), device)
        return (HFTokenizerAdapter(path, max_length=77), ccfg, module)

    def _pooled(self, prompt: str):
        """CLIP-L's pooled vector of the bare prompt; zeros without
        ``text_encoder_2``."""
        if self.text_encoder_2 is None:
            return torch.zeros((self.cfg.text_states_dim_2,))
        from .text.clip import clip_text_encode
        tok, ccfg, clip = self.text_encoder_2
        ids, _ = _ids(tok(prompt, max_length=77), _device_of(clip))
        return clip_text_encode(clip, ccfg, ids)[1][0]

    @torch.inference_mode()
    def encode_prompt(self, prompt: str, mode: str = "video"):
        """prompt -> (text_states [L, d], mask [L], pooled [768]): the
        instruct template, the LLM's ``hidden_states[-(skip + 1)]`` with
        the template tokens cropped, and CLIP-L's pooled vector, on the
        encoders' device."""
        if self.text_encoder is None:
            raise RuntimeError(
                "no text encoder loaded: pass a ckpt_dir with text_encoder/ "
                "(HF llava dir) or feed pre-encoded embeddings to predict()")
        from .text import apply_hyvideo_template, crop_encoder_output
        from .text.llama import CROP_START, llama_hidden_states
        from .text.llava import Llava
        tok, lcfg, llm = self.text_encoder
        if isinstance(llm, Llava):      # llava checkpoint: text-only path
            llm = llm.llm
        crop = CROP_START[mode]
        ids, mask = _ids(tok(apply_hyvideo_template(prompt, mode),
                             max_length=self.TEXT_LEN + crop),
                         _device_of(llm))
        states = llama_hidden_states(
            llm, lcfg, ids, mask, num_layers=lcfg.num_layers - self.SKIP_LAYER)
        hidden, mask = crop_encoder_output(states[-1], mask, mode)
        return hidden[0], mask[0], self._pooled(prompt)

    @torch.inference_mode()
    def encode_prompt_i2v(self, prompt: str, image, mode: str = "video",
                          i2v_condition_type: str = "token_replace"):
        """I2V prompt + image [3, H, W] in [0, 1] -> (states, mask,
        pooled): the image at 336px through llava's tower and projector,
        spliced at the ``<image>`` token, then the interleave-strided image
        tokens (4 for token_replace, 2 for latent_concat) beside the
        cropped text tokens."""
        from .text.llava import Llava
        if self.text_encoder is None:
            raise RuntimeError("no text encoder loaded")
        tok, lcfg, llava = self.text_encoder
        if not isinstance(llava, Llava):
            raise RuntimeError(
                "I2V prompt encoding needs a llava checkpoint (with "
                "vision_tower weights) in text_encoder/")
        from .text.clip import CLIP_L_VISION_336 as vc
        from .text.llava import (I2V_TEMPLATE_INFO, extract_i2v_tokens,
                                 llava_encode)
        info = I2V_TEMPLATE_INFO[mode]
        out = tok(info["template"].format(prompt),
                  max_length=self.TEXT_LEN + info["crop_start"])
        pos = np.nonzero(np.asarray(out[0])[0]
                         == tok.tok.convert_tokens_to_ids("<image>"))[0]
        if len(pos) != 1:
            raise ValueError("template must contain exactly one <image> "
                             "token in the tokenizer vocabulary")
        dev = _device_of(llava)
        ids, mask = _ids(out, dev)
        states, full_mask = llava_encode(
            llava, lcfg, ids, mask, _clip_normalize(image, vc.image_size, dev),
            image_token_pos=int(pos[0]),
            num_layers=lcfg.num_layers - self.SKIP_LAYER, vision_cfg=vc)
        hidden, out_mask = extract_i2v_tokens(
            states[-1], full_mask, mode,
            image_embed_interleave=(2 if i2v_condition_type == "latent_concat"
                                    else 4), token_ids=ids)
        return hidden[0], out_mask[0], self._pooled(prompt)

    # --------------------------------------------------------------- VAE

    def decode_latents(self, latents):
        """latents [16, T, h, w] -> video [3, F, H, W] in [-1, 1] by the
        tiled decode; the latents themselves without a VAE."""
        if self.vae is None:
            return latents
        with _resident(self.vae,
                       self.device if self.offload else None) as vae:
            z = torch.as_tensor(latents, dtype=torch.float32,
                                device=vae.device)[None]
            video = vae_hy.vae_decode_tiled(vae, z / vae.cfg.scaling_factor)
            return video[0].clamp(-1.0, 1.0)

    def encode_image_latent(self, image, lat_h: int, lat_w: int):
        """[3, H, W] f32 in [0, 1] -> [16, 1, lat_h, lat_w] scaled latent
        (the I2V per-stage conditioning latent, the distribution's mode)."""
        if self.vae is None:
            raise RuntimeError("no VAE attached (HunyuanVideoSampler(..., "
                               "vae=...))")
        with _resident(self.vae,
                       self.device if self.offload else None) as vae:
            x = _resize_chw(image, lat_h * 8, lat_w * 8, vae.device)
            x = (x * 2.0 - 1.0)[None, :, None]      # [1, 3, 1, H, W]
            mean = vae_hy.gaussian_sample(vae_hy.vae_encode_tiled(vae, x))
            return mean[0] * vae.cfg.scaling_factor

    # ----------------------------------------------------------- predict

    def predict(self, text_states, text_mask, text_states_2, opts,
                negative=None, **kw):
        """Pre-encoded entry point; returns final latents [C, F, H, W]."""
        return self.pipeline.generate(text_states, text_mask, text_states_2,
                                      opts, negative=negative, **kw)

    def predict_prompt(self, prompt: str, opts, negative_prompt=None, **kw):
        """Prompt -> video (or latents): both encoders, then ``predict``."""
        enc = self.encode_prompt(prompt)
        neg = (self.encode_prompt(negative_prompt)
               if negative_prompt else None)
        return self.pipeline.generate(*enc, opts, negative=neg, **kw)

    def predict_i2v(self, image_latents, text_states, text_mask,
                    text_states_2, opts, negative=None, **kw):
        """Pre-encoded I2V entry point (one conditioning latent per ProRes
        stage); returns final latents [16, F, H, W]."""
        return self.pipeline.generate_i2v(image_latents, text_states,
                                          text_mask, text_states_2, opts,
                                          negative=negative, **kw)


class WanSampler:
    """Sampler for Wan2.1, T2V or I2V by the config's ``model_type``;
    ``model_id`` keys the TeaCache polynomial. ``t5`` is ``(tokenizer,
    T5Config, T5Encoder)``, ``clip_vision`` ``(CLIPVisionConfig,
    CLIPVision)``."""

    CONFIGS = {"t2v-1.3B": wan_lib.WAN_T2V_1_3B,
               "t2v-14B": wan_lib.WAN_T2V_14B,
               "i2v-14B": wan_lib.WAN_I2V_14B}
    MODEL_IDS = {"t2v-1.3B": "wan-t2v-1.3b", "t2v-14B": "wan-t2v-14b",
                 "i2v-14B": "wan-i2v-720p"}
    T5_CKPT = "models_t5_umt5-xxl-enc-bf16.pth"
    T5_TOKENIZER = "google/umt5-xxl"
    CLIP_CKPT = "models_clip_open-clip-xlm-roberta-large-vit-huge-14.pth"

    def __init__(self, cfg: WanConfig, params=None, device="cuda",
                 seed: int = 0, model_id: str = "wan-t2v-1.3b",
                 vae: vae_wan.WanVAE | None = None, t5=None,
                 clip_vision=None):
        self.cfg = cfg
        self.vae = vae
        self.t5 = t5
        self.clip_vision = clip_vision
        self.device = resolve_device(device)
        self.model = _build(WanDiT, init_wan_, cfg, params, self.device,
                            seed)
        pipe_cls = WanI2VPipeline if cfg.model_type == "i2v" \
            else WanT2VPipeline
        self.pipeline = pipe_cls(self.model, model_id=model_id,
                                 vae_decode=self.decode_latents)

    @classmethod
    def from_task(cls, task: str, params=None, device="cuda",
                  seed: int = 0, vae: vae_wan.WanVAE | None = None):
        """The published config of ``task`` (t2v-1.3B, t2v-14B, i2v-14B)
        with its ``model_id``."""
        return cls(cls.CONFIGS[task], params, device, seed,
                   model_id=cls.MODEL_IDS[task], vae=vae)

    @classmethod
    def from_pretrained(cls, task: str = "t2v-1.3B",
                        ckpt_dir: str | None = None, seed: int = 0,
                        dtype: str = "bfloat16", t5_on_host: bool = False,
                        device="cuda"):
        """The published model of ``task`` from ``ckpt_dir``: the DiT
        (which must be there: a directory without one raises
        ``FileNotFoundError`` rather than run random weights), the VAE, T5
        (on the CPU with ``t5_on_host``) and, for I2V, the CLIP image
        tower, where their files are. Without ``ckpt_dir``, the DiT from a
        seeded init and nothing else."""
        device = resolve_device(device)
        cfg = dataclasses.replace(cls.CONFIGS[task], dtype=dtype)
        params = vae = t5 = clip_vision = None
        if ckpt_dir:
            sd = cls._dit_state_dict(ckpt_dir)
            if sd is None:
                raise FileNotFoundError(
                    f"no DiT checkpoint (.pth or .safetensors) in "
                    f"{ckpt_dir}; refusing to silently run random weights")
            params = C.convert_wan_dit(sd, cfg, cfg.torch_dtype)
            del sd
            vp = _find(ckpt_dir, "Wan2.1_VAE.pth", "vae_step_411000.pth")
            if vp:
                vae = _load_module(
                    lambda dev: vae_wan.WanVAE(vae_wan.WAN_VAE_16Z, dev),
                    C.convert_wanvae(C.load_torch_state_dict(vp),
                                     vae_wan.WAN_VAE_16Z), device)
            t5 = cls._load_t5(ckpt_dir, torch.device("cpu") if t5_on_host
                              else device)
            if cfg.model_type == "i2v":
                clip_vision = cls._load_clip_vision(ckpt_dir, device)
        return cls(cfg, params, device, seed, model_id=cls.MODEL_IDS[task],
                   vae=vae, t5=t5, clip_vision=clip_vision)

    @staticmethod
    def _dit_state_dict(ckpt_dir):
        pth = _find(ckpt_dir, "diffusion_pytorch_model.pth")
        if pth:
            return C.load_torch_state_dict(pth)
        if any(n.endswith(".safetensors") for n in os.listdir(ckpt_dir)):
            return C.load_safetensors_state_dict(ckpt_dir)
        return None

    @classmethod
    def _load_t5(cls, ckpt_dir, device):
        from .convert import encoders as E
        from .text import HFTokenizerAdapter
        from .text.t5 import UMT5_XXL, T5Encoder
        path = _find(ckpt_dir, cls.T5_CKPT)
        if path is None:
            return None
        module = _load_module(
            lambda dev: T5Encoder(UMT5_XXL, dev),
            E.convert_umt5_wan(C.load_torch_state_dict(path), UMT5_XXL),
            device)
        tok = HFTokenizerAdapter(os.path.join(ckpt_dir, cls.T5_TOKENIZER),
                                 max_length=512)
        return (tok, UMT5_XXL, module)

    @classmethod
    def _load_clip_vision(cls, ckpt_dir, device):
        from .convert import encoders as E
        from .text.clip import CLIP_H_VISION, CLIPVision
        path = _find(ckpt_dir, cls.CLIP_CKPT)
        if path is None:
            return None
        module = _load_module(
            lambda dev: CLIPVision(CLIP_H_VISION, dev),
            E.convert_clip_vision_wan(C.load_torch_state_dict(path),
                                      CLIP_H_VISION), device)
        return (CLIP_H_VISION, module)

    @torch.inference_mode()
    def encode_prompt(self, prompt: str):
        """prompt -> [L_real, 4096] f32 token states, trimmed to the real
        tokens, on T5's device."""
        if self.t5 is None:
            raise RuntimeError(
                f"no T5 loaded: ckpt dir must contain {self.T5_CKPT}")
        from .text.t5 import t5_encode
        tok, tcfg, t5 = self.t5
        ids, mask = _ids(tok(prompt), _device_of(t5))
        states = t5_encode(t5, tcfg, ids, mask)
        return states[0, :int(mask.sum())]

    @torch.inference_mode()
    def encode_image_clip(self, image):
        """[3, H, W] f32 in [0, 1] -> [257, 1280] ViT features (resize to
        224, normalize, the tower up to its 31st block)."""
        if self.clip_vision is None:
            raise RuntimeError(
                f"no CLIP loaded: ckpt dir must contain {self.CLIP_CKPT}")
        from .text.clip import clip_vision_encode
        ccfg, clip = self.clip_vision
        x = _clip_normalize(image, ccfg.image_size, _device_of(clip))
        return clip_vision_encode(clip, ccfg, x, use_31_block=True)[0]

    def encode_image_latent(self, image, frame_num: int, lat_h: int,
                            lat_w: int):
        """[3, H, W] f32 in [0, 1] -> [16, T_lat, lat_h, lat_w]: the image
        resized to the latent size x 8 as the first frame, then
        ``frame_num - 1`` zero frames, through the streamed encoder."""
        if self.vae is None:
            raise RuntimeError("no VAE attached (WanSampler(..., vae=...))")
        h, w = lat_h * 8, lat_w * 8
        first = _resize_chw(image, h, w, self.vae.device) * 2.0 - 1.0
        frames = torch.cat([first[:, None],
                            first.new_zeros((3, frame_num - 1, h, w))], dim=1)
        return vae_wan.wanvae_encode(self.vae, frames[None])[0]

    def decode_latents(self, latents):
        """latents [16, T, h, w] -> video [3, F, H, W] in [-1, 1] by the
        streamed decode; the latents themselves without a VAE."""
        if self.vae is None:
            return latents
        z = torch.as_tensor(latents, dtype=torch.float32,
                            device=self.vae.device)[None]
        return vae_wan.wanvae_decode(self.vae, z)[0]

    def generate(self, context, context_null, opts, **kw):
        """Pre-encoded entry point (prompt embeddings [L, text_dim]);
        returns final latents [C, F, H, W]."""
        return self.pipeline.generate(context, context_null, opts, **kw)

    def generate_i2v(self, image_latent, clip_fea, context, context_null,
                     frame_num, lat_h, lat_w, opts, **kw):
        """Pre-encoded I2V entry point: the image latent [16, T_lat, lat_h,
        lat_w] and the CLIP tokens [257, 1280]; returns final latents."""
        return self.pipeline.generate_i2v(image_latent, clip_fea, context,
                                          context_null, frame_num, lat_h,
                                          lat_w, opts, **kw)

    def generate_prompt(self, prompt: str, opts, negative_prompt: str = "",
                        **kw):
        """Prompt -> video (T2V); the default negative prompt when none is
        given."""
        ctx = self.encode_prompt(prompt)
        null = self.encode_prompt(negative_prompt
                                  or WAN_DEFAULT_NEGATIVE_PROMPT)
        return self.pipeline.generate(ctx, null, opts, **kw)

    def generate_image(self, image, prompt: str, opts,
                       negative_prompt: str = "", **kw):
        """Image [3, H, W] in [0, 1] + prompt -> video (I2V): T5 on the
        prompt and the negative prompt, CLIP on the image, the image
        latent over ``opts.frame_num`` frames at ``i2v_latent_size`` of the
        image under ``opts.max_area``."""
        ctx = self.encode_prompt(prompt)
        null = self.encode_prompt(negative_prompt
                                  or WAN_DEFAULT_NEGATIVE_PROMPT)
        lat_h, lat_w = i2v_latent_size(image.shape[1], image.shape[2],
                                       opts.max_area)
        clip_fea = self.encode_image_clip(image)
        img_lat = self.encode_image_latent(image, opts.frame_num, lat_h,
                                           lat_w)
        return self.pipeline.generate_i2v(
            img_lat, clip_fea, ctx, null, opts.frame_num, lat_h, lat_w,
            opts, **kw)

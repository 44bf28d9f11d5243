"""Prompt to latents through both packages' samplers, from checkpoint
directories in the reference's layout, at tiny configs.

The published configs are patched to tiny ones in both packages (the DiTs,
the VAEs, UMT5, the CLIP towers), and one set of directories is written:
HunyuanVideo's (a deepspeed ``pytorch_model_module.pt``, its fp8 copy with
a scale map, ``vae/``, a tiny llava in ``text_encoder/`` and CLIP in
``text_encoder_2/`` saved by ``transformers`` with a ``tokenizers``
WordLevel tokenizer, a kohya LoRA), one with a plain llama, and Wan's (a
sharded safetensors DiT with its index, or a ``.pth``, ``Wan2.1_VAE.pth``,
the T5 ``.pth`` with its tokenizer dir, the CLIP ``.pth``). Both
packages' ``from_pretrained`` load them: every module tensor equal bit
for bit, the prompt encodes within 1e-5 relative L2, and prompt to
latents over 2 steps within 1e-4. The CLI's new flags build the calls the
JAX handlers build, and ``wan-i2v`` without an image exits as JAX's does.
"""

import dataclasses
import functools
import json
from unittest import mock

import jax
import numpy as np
import pytest
import torch

from jenga_tpu import cli as jcli
from jenga_tpu import runtime as jrt
from jenga_tpu.codec import vae_hy as jvae_hy
from jenga_tpu.codec import vae_wan as jvae_wan
from jenga_tpu.configs import presets as jpresets
from jenga_tpu.models import hyvideo as jhy
from jenga_tpu.models import wan as jwan
from jenga_tpu import text as jtext
from jenga_tpu.pipelines import hyvideo_i2v as jhy_i2v
from jenga_tpu.text import clip as jclip
from jenga_tpu.text import t5 as jt5
from jenga_tpu_torch import cli as tcli
from jenga_tpu_torch import convert as C
from jenga_tpu_torch import runtime as trt
from jenga_tpu_torch.codec import vae_hy as tvae_hy
from jenga_tpu_torch.codec import vae_wan as tvae_wan
from jenga_tpu_torch.configs import presets as tpresets
from jenga_tpu_torch.models import hyvideo as thy
from jenga_tpu_torch.models import wan as twan
from jenga_tpu_torch.text import clip as tclip
from jenga_tpu_torch.text import llama as tllama
from jenga_tpu_torch.text import llava as tllava
from jenga_tpu_torch.text import t5 as tt5

import _torch_ckpt as K
from _torch_parity import rel_err

TOL = 1e-5
HY_VAE = dict(block_out_channels=(8, 16, 16, 16), norm_num_groups=4,
              layers_per_block=1)
WAN_VAE = dict(dim=8)
TEXT_LEN = 32
IMAGE_TOKEN = 63
PROMPT = "a cat walks on the grass"


def _png(path, h=40, w=30):
    from PIL import Image
    rgb = np.random.default_rng(0).uniform(0, 255, (h, w, 3)).astype(
        np.uint8)
    Image.fromarray(rgb).save(path)
    return str(path)


@pytest.fixture(scope="module")
def dirs(tmp_path_factory):
    from safetensors.torch import save_file
    root = tmp_path_factory.mktemp("ckpt")
    hy = root / "hy"
    vae = hy / "vae"
    vae.mkdir(parents=True)
    sd = K.hy_dit_ref(thy.HYVideoConfig(**K.HY_TINY), seed=1)
    torch.save({"module": sd, "step": 7},
               str(hy / "pytorch_model_module.pt"))
    fp8 = {k: (v.to(torch.float8_e4m3fn) if v.ndim == 2 else v)
           for k, v in sd.items()}
    scales = {k[:-len(".weight")]: torch.tensor(0.5 + i / 7)
              for i, (k, v) in enumerate(sd.items()) if v.ndim == 2}
    torch.save(fp8, str(hy / "pytorch_model_module_fp8.pt"))
    torch.save(scales, str(hy / "pytorch_model_module_fp8_map.pt"))
    torch.save(K.hyvae_ref(jvae_hy.HYVAEConfig(**HY_VAE)),
               str(vae / "pytorch_model.pt"))
    vocab = dict(K.VOCAB, **{"<image>": IMAGE_TOKEN})
    K.hf_llava(image_token=IMAGE_TOKEN).save_pretrained(
        str(hy / "text_encoder"))
    K.make_tokenizer(str(hy / "text_encoder"), vocab, special=["<image>"])
    K.hf_clip_text().save_pretrained(str(hy / "text_encoder_2"))
    K.make_tokenizer(str(hy / "text_encoder_2"))
    g = torch.Generator().manual_seed(2)
    lora = {}
    for name, (o, i) in {"double_blocks_0_img_attn_qkv": (96, 32),
                         "single_blocks_0_linear2": (32, 160)}.items():
        key = f"Hunyuan_video_I2V_lora_{name}"
        lora[f"{key}.lora_down.weight"] = torch.randn(2, i, generator=g)
        lora[f"{key}.lora_up.weight"] = torch.randn(o, 2, generator=g)
    save_file(lora, str(root / "lora.safetensors"))

    hyl = root / "hy_llama"
    K.hf_llama(seed=3).save_pretrained(str(hyl / "text_encoder"))
    K.make_tokenizer(str(hyl / "text_encoder"))

    wan = root / "wan"
    wan.mkdir()
    wcfg = twan.WanConfig(**K.WAN_TINY)
    wsd = K.wan_dit_ref(wcfg, seed=4)
    keys = sorted(wsd)
    shards = {"diffusion_pytorch_model-00001-of-00002.safetensors":
              keys[:len(keys) // 2],
              "diffusion_pytorch_model-00002-of-00002.safetensors":
              keys[len(keys) // 2:]}
    for name, part in shards.items():
        save_file({k: wsd[k].contiguous() for k in part}, str(wan / name))
    (wan / "diffusion_pytorch_model.safetensors.index.json").write_text(
        json.dumps({"weight_map": {k: n for n, part in shards.items()
                                   for k in part}}))
    torch.save(K.wanvae_ref(jvae_wan.WanVAEConfig(**WAN_VAE)),
               str(wan / "Wan2.1_VAE.pth"))
    t5_sd = K.umt5_wan_ref(tt5.T5Config(**K.T5_TINY), seed=5)
    torch.save(t5_sd, str(wan / trt.WanSampler.T5_CKPT))
    K.make_tokenizer(str(wan / "google" / "umt5-xxl"))

    wani = root / "wan_i2v"
    wani.mkdir()
    icfg = twan.WanConfig(**dict(K.WAN_TINY, model_type="i2v", in_dim=36))
    torch.save(K.wan_dit_ref(icfg, seed=6),
               str(wani / "diffusion_pytorch_model.pth"))
    torch.save(t5_sd, str(wani / trt.WanSampler.T5_CKPT))
    K.make_tokenizer(str(wani / "google" / "umt5-xxl"))
    torch.save(K.clip_wan_ref(
        tclip.CLIPVisionConfig(**K.CLIP_H_TINY), seed=7),
        str(wani / trt.WanSampler.CLIP_CKPT))
    return {"root": root, "hy": str(hy), "hy_llama": str(hyl),
            "wan": str(wan), "wan_i2v": str(wani),
            "lora": str(root / "lora.safetensors"),
            "image": _png(root / "image.png")}


@pytest.fixture(scope="module")
def tiny():
    """The published configs of both packages patched to tiny ones."""
    wan_t2v = dict(K.WAN_TINY)
    wan_i2v = dict(K.WAN_TINY, model_type="i2v", in_dim=36)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jhy, "HUNYUAN_VIDEO_T2V", jhy.HYVideoConfig(**K.HY_TINY))
        mp.setattr(trt, "HUNYUAN_VIDEO_T2V", thy.HYVideoConfig(**K.HY_TINY))
        mp.setattr(jvae_hy, "HYVAE_884_16C", jvae_hy.HYVAEConfig(**HY_VAE))
        mp.setattr(tvae_hy, "HYVAE_884_16C", tvae_hy.HYVAEConfig(**HY_VAE))
        mp.setattr(jvae_wan, "WAN_VAE_16Z", jvae_wan.WanVAEConfig(**WAN_VAE))
        mp.setattr(tvae_wan, "WAN_VAE_16Z", tvae_wan.WanVAEConfig(**WAN_VAE))
        mp.setattr(jt5, "UMT5_XXL", jt5.T5Config(**K.T5_TINY))
        mp.setattr(tt5, "UMT5_XXL", tt5.T5Config(**K.T5_TINY))
        mp.setattr(jclip, "CLIP_H_VISION",
                   jclip.CLIPVisionConfig(**K.CLIP_H_TINY))
        mp.setattr(tclip, "CLIP_H_VISION",
                   tclip.CLIPVisionConfig(**K.CLIP_H_TINY))
        mp.setattr(jclip, "CLIP_L_VISION_336",
                   jclip.CLIPVisionConfig(**K.LLAVA_VIS))
        mp.setattr(tclip, "CLIP_L_VISION_336",
                   tclip.CLIPVisionConfig(**K.LLAVA_VIS))
        for cls in (jrt.HunyuanVideoSampler, trt.HunyuanVideoSampler):
            mp.setattr(cls, "TEXT_LEN", TEXT_LEN)
        for cls, mod in ((jrt.WanSampler, jwan), (trt.WanSampler, twan)):
            mp.setitem(cls.CONFIGS, "t2v-1.3B", mod.WanConfig(**wan_t2v))
            mp.setitem(cls.CONFIGS, "i2v-14B", mod.WanConfig(**wan_i2v))
        yield


@pytest.fixture(scope="module")
def hy(dirs, tiny):
    return (jrt.HunyuanVideoSampler.from_pretrained(dirs["hy"],
                                                    dtype="float32"),
            trt.HunyuanVideoSampler.from_pretrained(dirs["hy"],
                                                    dtype="float32",
                                                    device="cpu"))


@pytest.fixture(scope="module")
def wan(dirs, tiny):
    return (jrt.WanSampler.from_pretrained("t2v-1.3B", dirs["wan"],
                                           dtype="float32"),
            trt.WanSampler.from_pretrained("t2v-1.3B", dirs["wan"],
                                           dtype="float32", device="cpu"))


def _bits_equal(a: dict, b: dict):
    assert sorted(a) == sorted(b)
    for k in a:
        assert a[k].dtype == b[k].dtype and a[k].shape == b[k].shape, k
        assert torch.equal(a[k].view(torch.uint8) if a[k].dtype ==
                           torch.float8_e4m3fn else a[k],
                           b[k].view(torch.uint8) if b[k].dtype ==
                           torch.float8_e4m3fn else b[k]), k


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def test_hy_modules_load_as_jax(hy):
    """The DiT, the VAE, the llava and the CLIP text encoder, tensor for
    tensor, against the JAX loader's trees through the bridges."""
    jax_s, port = hy
    _bits_equal(port.model.state_dict(),
                C.hyvideo_params_from_jax(_np(jax_s.params)))
    _bits_equal(port.vae.state_dict(),
                C.hyvae_params_from_jax(_np(jax_s.vae_params)))
    assert isinstance(port.text_encoder[2], tllava.Llava)
    assert port.text_encoder[1] == tllama.LlamaConfig(
        **K.LLAMA_HF, rope_theta=jax_s.text_encoder[1].rope_theta)
    _bits_equal(port.text_encoder[2].state_dict(),
                C.llava_params_from_jax(_np(jax_s.text_encoder[2])))
    _bits_equal(port.text_encoder_2[2].state_dict(),
                C.clip_text_params_from_jax(_np(jax_s.text_encoder_2[2])))
    assert vars(port.text_encoder_2[1]) == vars(jax_s.text_encoder_2[1])


@pytest.mark.parametrize("kind", ["fp8", "lora"])
def test_hy_dit_variants_load_as_jax(dirs, tiny, kind):
    """The fp8 file with its scale map (dequantized, then quantized as the
    sampler quantizes), and the base file with the kohya LoRA merged."""
    kw = {"use_fp8": True} if kind == "fp8" else {"lora_path": dirs["lora"],
                                                  "lora_alpha": 0.6}
    jax_s = jrt.HunyuanVideoSampler.from_pretrained(dirs["hy"],
                                                    dtype="float32", **kw)
    port = trt.HunyuanVideoSampler.from_pretrained(
        dirs["hy"], dtype="float32", device="cpu", **kw)
    _bits_equal(port.model.state_dict(),
                C.hyvideo_params_from_jax(_np(jax_s.params)))
    plain = torch.load(dirs["hy"] + "/pytorch_model_module.pt")["module"]
    w = port.model.double_blocks[0].img_qkv.w
    assert not torch.equal(w, plain["double_blocks.0.img_attn_qkv.weight"])


def test_hy_i2v_refuses_another_img_in(dirs, tiny):
    """latent_concat takes 33 input channels; the checkpoint's img_in has
    16: refused, never reshaped."""
    with pytest.raises(ValueError, match="img_in takes 16 channels"):
        trt.HunyuanVideoSampler.from_pretrained(
            dirs["hy"], i2v=True, i2v_condition_type="latent_concat",
            dtype="float32", device="cpu")
    s = trt.HunyuanVideoSampler.from_pretrained(
        dirs["hy"], i2v=True, dtype="float32", device="cpu")
    assert s.cfg.i2v_condition_type == "token_replace"


@pytest.mark.parametrize("mode", ["video", "image"])
def test_hy_encode_prompt_matches_jax(hy, mode):
    jax_s, port = hy
    want = jax_s.encode_prompt(PROMPT, mode=mode)
    got = port.encode_prompt(PROMPT, mode=mode)
    assert got[0].shape == want[0].shape == (TEXT_LEN, 24)
    assert rel_err(got[0], want[0]) <= TOL
    assert np.array_equal(got[1].numpy(), np.asarray(want[1]))
    assert rel_err(got[2], want[2]) <= TOL


def test_hy_encode_prompt_plain_llama_matches_jax(dirs, tiny):
    """A plain HF llama dir (no CLIP: pooled zeros)."""
    jax_s = jrt.HunyuanVideoSampler.from_pretrained(dirs["hy_llama"],
                                                    dtype="float32")
    port = trt.HunyuanVideoSampler.from_pretrained(
        dirs["hy_llama"], dtype="float32", device="cpu")
    assert isinstance(port.text_encoder[2], tllama.Llama)
    _bits_equal(port.text_encoder[2].state_dict(),
                C.llama_params_from_jax(_np(jax_s.text_encoder[2])))
    want = jax_s.encode_prompt("a dog runs")
    got = port.encode_prompt("a dog runs")
    assert rel_err(got[0], want[0]) <= TOL
    assert not got[2].any() and not np.asarray(want[2]).any()


@pytest.mark.parametrize("cond", ["token_replace", "latent_concat"])
def test_hy_encode_prompt_i2v_matches_jax(hy, cond):
    """The llava path: the image at the tower's size, spliced at
    <image>, the strided image tokens beside the cropped text."""
    jax_s, port = hy
    image = np.random.default_rng(8).uniform(0, 1, (3, 40, 30)).astype(
        np.float32)
    want = jax_s.encode_prompt_i2v(PROMPT, image, i2v_condition_type=cond)
    got = port.encode_prompt_i2v(PROMPT, image, i2v_condition_type=cond)
    assert got[0].shape == want[0].shape
    assert rel_err(got[0], want[0]) <= TOL
    assert np.array_equal(got[1].numpy(), np.asarray(want[1]))
    assert rel_err(got[2], want[2]) <= TOL


def test_hy_prompt_to_latents_matches_jax(hy):
    """predict_prompt with a negative prompt (CFG off at the base preset's
    guidance 1.0, as in JAX), 2 steps from JAX's own initial draw."""
    jax_s, port = hy
    kw = dict(size=(64, 64), video_length=5, num_inference_steps=2)
    jopts = jpresets.get_hy_preset("base", **kw)
    lat0 = np.asarray(jax.random.normal(jax.random.PRNGKey(0),
                                        (16, 2, 8, 8)))
    want = jax_s.predict_prompt(PROMPT, jopts, negative_prompt="a dog",
                                decode=False, initial_latents=lat0)
    got = port.predict_prompt(PROMPT, tpresets.get_hy_preset("base", **kw),
                              negative_prompt="a dog", decode=False,
                              initial_latents=lat0)
    assert got.shape == want.shape == (16, 2, 8, 8)
    assert rel_err(got, want) <= 1e-4


def test_wan_modules_load_as_jax(wan):
    jax_s, port = wan
    _bits_equal(port.model.state_dict(),
                C.wan_params_from_jax(_np(jax_s.params)))
    _bits_equal(port.vae.state_dict(),
                C.wanvae_params_from_jax(_np(jax_s.vae_params)))
    _bits_equal(port.t5[2].state_dict(),
                C.t5_params_from_jax(_np(jax_s.t5[2])))


def test_wan_encode_prompt_trims_as_jax(wan):
    jax_s, port = wan
    for prompt in (PROMPT, trt.WAN_DEFAULT_NEGATIVE_PROMPT):
        want = jax_s.encode_prompt(prompt)
        got = port.encode_prompt(prompt)
        assert got.shape == want.shape and got.shape[1] == 24
        assert rel_err(got, want) <= TOL
    assert port.encode_prompt(PROMPT).shape[0] == 6


def test_wan_prompt_to_latents_matches_jax(wan):
    """generate_prompt with the default negative prompt, 2 steps."""
    jax_s, port = wan
    kw = dict(size=(64, 64), frame_num=5, sampling_steps=2)
    lat0 = np.asarray(jax.random.normal(jax.random.PRNGKey(1),
                                        (16, 2, 8, 8)))
    want = jax_s.generate_prompt(PROMPT, jpresets.get_wan_preset(
        "1.3b-base", **kw), decode=False, initial_latents=lat0)
    got = port.generate_prompt(PROMPT, tpresets.get_wan_preset(
        "1.3b-base", **kw), decode=False, initial_latents=lat0)
    assert got.shape == want.shape == (16, 2, 8, 8)
    assert rel_err(got, want) <= 1e-4


@pytest.mark.parametrize("t5_on_host", [False, True])
def test_wan_i2v_encoders_match_jax(dirs, tiny, t5_on_host):
    """The .pth DiT, T5 (on the host with t5_on_host) and the CLIP image
    tower: 5 tokens of width 32 from a 40x30 image, within 1e-5."""
    jax_s = jrt.WanSampler.from_pretrained("i2v-14B", dirs["wan_i2v"],
                                           dtype="float32",
                                           t5_on_host=t5_on_host)
    port = trt.WanSampler.from_pretrained("i2v-14B", dirs["wan_i2v"],
                                          dtype="float32",
                                          t5_on_host=t5_on_host,
                                          device="cpu")
    _bits_equal(port.model.state_dict(),
                C.wan_params_from_jax(_np(jax_s.params)))
    _bits_equal(port.clip_vision[1].state_dict(),
                C.clip_vision_params_from_jax(_np(jax_s.clip_vision[1])))
    image = np.random.default_rng(9).uniform(0, 1, (3, 40, 30)).astype(
        np.float32)
    want = jax_s.encode_image_clip(image)
    got = port.encode_image_clip(image)
    assert got.shape == want.shape == (5, 32)
    assert rel_err(got, want) <= TOL
    assert rel_err(port.encode_prompt("a dog runs"),
                   jax_s.encode_prompt("a dog runs")) <= TOL


def test_wan_dir_without_dit_raises(tmp_path):
    (tmp_path / "Wan2.1_VAE.pth").write_bytes(b"")
    with pytest.raises(FileNotFoundError, match="refusing"):
        trt.WanSampler.from_pretrained("t2v-1.3B", str(tmp_path),
                                       device="cpu")
    with pytest.raises(FileNotFoundError):
        jrt.WanSampler.from_pretrained("t2v-1.3B", str(tmp_path))


def test_tokenizer_loads_on_first_use(dirs):
    """The adapter reads nothing until it tokenizes; a missing directory
    fails then, naming it (no hub download)."""
    from jenga_tpu_torch.text import HFTokenizerAdapter
    tok = HFTokenizerAdapter(str(dirs["root"] / "missing"))
    assert tok._tok is None
    with pytest.raises(FileNotFoundError, match="missing"):
        tok("a cat")
    ids, mask = HFTokenizerAdapter(dirs["hy_llama"] + "/text_encoder",
                                   max_length=8)("a cat")
    assert ids.tolist() == [[2, 3, 0, 0, 0, 0, 0, 0]]
    assert mask.tolist() == [[1, 1, 0, 0, 0, 0, 0, 0]]


def _jax_cfg(cls, cfg):
    return cls(**dataclasses.asdict(cfg))


def test_smoke_reference_dirs_load_as_jax(tmp_path):
    """The directories the smoke's phase 15 writes (chip_smoke.py, by hand:
    torch.save and its own safetensors writer) load in both packages with
    the published configs patched to its small ones, tensor for tensor, and
    its stand-in tokenizer encodes through both alike."""
    import chip_smoke
    cfgs = chip_smoke.small_configs()
    dirs = chip_smoke.write_reference_dirs(str(tmp_path), cfgs)
    hy_cfg = dataclasses.replace(cfgs["hy"], dtype="float32")
    with chip_smoke.small_published_configs(cfgs), \
            pytest.MonkeyPatch.context() as mp:
        mp.setattr(jhy, "HUNYUAN_VIDEO_T2V", _jax_cfg(jhy.HYVideoConfig,
                                                      hy_cfg))
        mp.setattr(jvae_hy, "HYVAE_884_16C",
                   _jax_cfg(jvae_hy.HYVAEConfig, cfgs["hy_vae"]))
        mp.setattr(jvae_wan, "WAN_VAE_16Z",
                   _jax_cfg(jvae_wan.WanVAEConfig, cfgs["wan_vae"]))
        mp.setattr(jt5, "UMT5_XXL", _jax_cfg(jt5.T5Config, cfgs["t5"]))
        mp.setattr(jclip, "CLIP_H_VISION",
                   _jax_cfg(jclip.CLIPVisionConfig, cfgs["clip_h"]))
        mp.setattr(jclip, "CLIP_L_VISION_336",
                   _jax_cfg(jclip.CLIPVisionConfig, cfgs["llava_vision"]))
        mp.setattr(jrt.HunyuanVideoSampler, "TEXT_LEN", 32)
        # the directories hold no tokenizer files; JAX reads them on load
        mp.setattr(jtext, "HFTokenizerAdapter", lambda *a, **kw: None)
        mp.setitem(jrt.WanSampler.CONFIGS, "i2v-14B",
                   _jax_cfg(jwan.WanConfig, dataclasses.replace(
                       cfgs["wan_i2v"], dtype="float32")))
        for kw in ({}, {"use_fp8": True},
                   {"lora_path": dirs["lora"], "lora_alpha": 0.8}):
            jax_s = jrt.HunyuanVideoSampler.from_pretrained(
                dirs["hy"], dtype="float32", **kw)
            port = trt.HunyuanVideoSampler.from_pretrained(
                dirs["hy"], dtype="float32", device="cpu", **kw)
            _bits_equal(port.model.state_dict(),
                        C.hyvideo_params_from_jax(_np(jax_s.params)))
        _bits_equal(port.vae.state_dict(),
                    C.hyvae_params_from_jax(_np(jax_s.vae_params)))
        _bits_equal(port.text_encoder[2].state_dict(),
                    C.llava_params_from_jax(_np(jax_s.text_encoder[2])))
        _bits_equal(port.text_encoder_2[2].state_dict(),
                    C.clip_text_params_from_jax(_np(jax_s.text_encoder_2[2])))
        chip_smoke._set_standins(hy=port)
        jax_s.text_encoder = (port.text_encoder[0],
                              *jax_s.text_encoder[1:])
        jax_s.text_encoder_2 = (port.text_encoder_2[0],
                                *jax_s.text_encoder_2[1:])
        image = np.random.default_rng(10).uniform(0, 1, (3, 40, 30)).astype(
            np.float32)
        for got, want in ((port.encode_prompt(chip_smoke.PROMPT),
                           jax_s.encode_prompt(chip_smoke.PROMPT)),
                          (port.encode_prompt_i2v(chip_smoke.PROMPT, image),
                           jax_s.encode_prompt_i2v(chip_smoke.PROMPT,
                                                   image))):
            assert rel_err(got[0], want[0]) <= TOL
            assert np.array_equal(got[1].numpy(), np.asarray(want[1]))
            assert rel_err(got[2], want[2]) <= TOL
        jax_w = jrt.WanSampler.from_pretrained("i2v-14B", dirs["wan_i2v"],
                                               dtype="float32")
        port_w = trt.WanSampler.from_pretrained(
            "i2v-14B", dirs["wan_i2v"], dtype="float32", device="cpu")
    _bits_equal(port_w.model.state_dict(),
                C.wan_params_from_jax(_np(jax_w.params)))
    _bits_equal(port_w.vae.state_dict(),
                C.wanvae_params_from_jax(_np(jax_w.vae_params)))
    _bits_equal(port_w.t5[2].state_dict(),
                C.t5_params_from_jax(_np(jax_w.t5[2])))
    _bits_equal(port_w.clip_vision[1].state_dict(),
                C.clip_vision_params_from_jax(_np(jax_w.clip_vision[1])))
    chip_smoke._set_standins(wan=port_w)
    jax_w.t5 = (port_w.t5[0], *jax_w.t5[1:])
    got = port_w.encode_prompt(chip_smoke.PROMPT)
    assert got.shape == (17, 64)
    assert rel_err(got, jax_w.encode_prompt(chip_smoke.PROMPT)) <= TOL


# ------------------------------------------------------------------ CLI


class _Captured(Exception):
    pass


class _Stub:
    """A sampler that records the calls a handler makes; the generating
    call raises ``_Captured``."""

    def __init__(self, seen, port, llava=True, encoders=True):
        self.seen = seen
        self.cfg = (thy if port else jhy).HYVideoConfig(
            text_states_dim=8, text_states_dim_2=4)
        self.TEXT_LEN = 8
        self.vae = self.vae_params = None
        llm = {"llm": {}} if llava else {}
        if port:
            llm = (tllava.Llava(tllama.LlamaConfig(**K.LLAMA_HF),
                                tclip.CLIPVisionConfig(**K.LLAVA_VIS),
                                device="meta") if llava else object())
        self.text_encoder = (None, None, llm) if encoders else None
        self.t5 = object() if encoders else None
        self.pipeline = _Pipe(seen, port)

    def _rec(self, name, *a, **kw):
        self.seen.setdefault("calls", []).append((name, a, kw))

    def predict_prompt(self, prompt, opts, negative_prompt=None, **kw):
        self._rec("predict_prompt", prompt, negative_prompt=negative_prompt,
                  **kw)
        raise _Captured

    def encode_prompt(self, prompt, mode="video"):
        self._rec("encode_prompt", prompt, mode=mode)
        return np.zeros((8, 8)), np.ones(8), np.zeros(4)

    def encode_prompt_i2v(self, prompt, image, mode="video",
                          i2v_condition_type="token_replace"):
        self._rec("encode_prompt_i2v", prompt, np.asarray(image).shape,
                  mode=mode, i2v_condition_type=i2v_condition_type)
        return np.zeros((8, 8)), np.ones(8), np.zeros(4)

    def predict_i2v(self, *a, **kw):
        self._rec("generate_i2v", decode=kw.get("decode"))
        raise _Captured

    def generate_prompt(self, prompt, opts, negative_prompt="", **kw):
        self._rec("generate_prompt", prompt,
                  negative_prompt=negative_prompt, **kw)
        raise _Captured

    def generate_image(self, image, prompt, opts, negative_prompt="", **kw):
        self._rec("generate_image", np.asarray(image).shape, prompt,
                  negative_prompt=negative_prompt, **kw)
        raise _Captured


class _Pipe:
    def __init__(self, seen, port):
        cls = trt.HYVideoI2VPipeline if port else jhy_i2v.HYVideoI2VPipeline
        self.VAE_STRIDE = cls.VAE_STRIDE
        self._stage_shapes = functools.partial(cls._stage_shapes, self)
        self.seen = seen

    def generate_i2v(self, *a, **kw):
        self.seen.setdefault("calls", []).append(
            ("generate_i2v", (), {"decode": kw.get("decode")}))
        raise _Captured


SAMPLER_KW = ("i2v", "seed", "use_fp8", "lora_path", "use_cpu_offload",
              "t5_on_host")


def _calls(cli, rt, argv, port, **stub_kw):
    """(from_pretrained's arguments, the sampler calls) of one command."""
    seen = {}

    def from_pretrained(*a, **kw):
        seen["load"] = (a, {k: v for k, v in kw.items() if k in SAMPLER_KW})
        return _Stub(seen, port, **stub_kw)

    cls = rt.WanSampler if argv[0].startswith("wan") \
        else rt.HunyuanVideoSampler
    args = cli.build_parser().parse_args(argv)
    with mock.patch.object(cls, "from_pretrained",
                           staticmethod(from_pretrained)), \
            mock.patch.object(jcli, "_apply_backend"), \
            pytest.raises(_Captured):
        getattr(cli, {"hyvideo-t2v": "run_hyvideo_t2v",
                      "hyvideo-i2v": "run_hyvideo_i2v",
                      "wan-t2v": "run_wan_t2v",
                      "wan-i2v": "run_wan_i2v"}[argv[0]])(args)
    return seen["load"], seen["calls"]


CLI_CASES = [
    (["hyvideo-t2v", "--prompt", "a dog runs", "--neg-prompt", "blurry",
      "--ckpt-dir", "CKPT", "--use-cpu-offload"], {}),
    (["hyvideo-t2v", "--ckpt-dir", "CKPT", "--latents-only"], {}),
    (["hyvideo-i2v", "--i2v-image-path", "IMG", "--prompt", "a dog runs",
      "--ckpt-dir", "CKPT", "--lora-path", "L.safetensors",
      "--use-cpu-offload"], {}),
    (["hyvideo-i2v", "--i2v-image-path", "IMG", "--ckpt-dir", "CKPT",
      "--i2v-condition-type", "latent_concat"], {}),
    (["hyvideo-i2v", "--i2v-image-path", "IMG", "--ckpt-dir", "CKPT"],
     {"llava": False}),
    (["hyvideo-i2v", "--i2v-image-path", "IMG", "--ckpt-dir", "CKPT"],
     {"encoders": False}),
    (["wan-t2v", "--prompt", "a dog runs", "--neg-prompt", "blurry",
      "--ckpt-dir", "CKPT", "--t5-cpu"], {}),
    (["wan-t2v", "--ckpt-dir", "CKPT", "--seed", "3"], {}),
    (["wan-i2v", "--image", "IMG", "--prompt", "a dog runs", "--ckpt-dir",
      "CKPT", "--neg-prompt", "blurry"], {}),
]


@pytest.mark.parametrize("argv,stub_kw", CLI_CASES,
                         ids=[" ".join(c[0]) for c in CLI_CASES])
def test_cli_prompt_flags_build_jax_calls(dirs, argv, stub_kw):
    """``--prompt``, ``--neg-prompt``, ``--ckpt-dir``, ``--use-cpu-offload``,
    ``--lora-path``, ``--t5-cpu`` and ``--image``: the checkpoint directory
    and sampler options each handler hands to ``from_pretrained``, and the
    prompt calls it makes (the llava path with an image, image mode with
    another LLM, zeros without encoders), equal the JAX handler's."""
    argv = [dict(IMG=dirs["image"]).get(a, a) for a in argv]
    want = _calls(jcli, jrt, argv, port=False, **stub_kw)
    got = _calls(tcli, trt, argv + ["--device", "cpu"], port=True, **stub_kw)
    assert got == want
    names = [c[0] for c in got[1]]
    assert names[-1] in ("predict_prompt", "generate_i2v", "generate_prompt",
                         "generate_image")


@pytest.mark.parametrize("argv,t5", [
    (["wan-i2v"], True), (["wan-i2v", "--ckpt-dir", "CKPT"], True),
    (["wan-i2v", "--image", "IMG"], False),
    (["wan-i2v", "--image", "IMG", "--ckpt-dir", "CKPT"], False)])
def test_wan_i2v_without_image_exits_as_jax(dirs, argv, t5):
    """Without --image, or without a T5 in the checkpoint directory, and
    without --tiny, both CLIs exit with the same message (the port before
    it builds the model when it can tell)."""
    argv = [dict(IMG=dirs["image"]).get(a, a) for a in argv]
    exits = []
    for cli, rt, port in ((jcli, jrt, False), (tcli, trt, True)):
        stub = _Stub({}, port, encoders=t5)
        with mock.patch.object(rt.WanSampler, "from_pretrained",
                               staticmethod(lambda *a, **kw: stub)), \
                mock.patch.object(jcli, "_apply_backend"), \
                pytest.raises(SystemExit) as e:
            cli.run_wan_i2v(cli.build_parser().parse_args(argv))
        exits.append(str(e.value))
    assert exits[0] == exits[1]
    assert "--image" in exits[1]

"""The port's checkpoint layer (``jenga_tpu_torch.convert``) against the
JAX package's (``jenga_tpu.convert``).

Every converter, on a synthetic state dict in the reference's layout,
gives key for key and bit for bit what the JAX converter gives after the
bridge (``*_params_from_jax``), in f32 and in bf16, and loads strictly
into the port module; at a bf16 DiT config the converted dtypes are the
module's. The port's safetensors reader equals the ``safetensors``
package on a file and on a sharded index; the fp8 loader, the LoRA merge
and the deepspeed unwrap equal JAX's; the error cases raise.
"""

import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from jenga_tpu import convert as JC
from jenga_tpu.codec import vae_hy as jvae_hy
from jenga_tpu.codec import vae_wan as jvae_wan
from jenga_tpu.convert import encoders as JE
from jenga_tpu.models import hyvideo as jhy
from jenga_tpu.models import wan as jwan
from jenga_tpu.text import clip as jclip
from jenga_tpu.text import llama as jllama
from jenga_tpu.text import t5 as jt5
from jenga_tpu.text import xlm_roberta as jxlmr
from jenga_tpu_torch import convert as C
from jenga_tpu_torch.codec import vae_hy, vae_wan
from jenga_tpu_torch.convert import encoders as E
from jenga_tpu_torch.models import hyvideo as thy
from jenga_tpu_torch.models import wan as twan
from jenga_tpu_torch.models.fp8 import quantize_tree_fp8
from jenga_tpu_torch.text import clip as tclip
from jenga_tpu_torch.text import llama as tllama
from jenga_tpu_torch.text import llava as tllava
from jenga_tpu_torch.text import t5 as tt5
from jenga_tpu_torch.text import xlm_roberta as txlmr

import _torch_ckpt as K

DTYPES = {"f32": (torch.float32, np.float32),
          "bf16": (torch.bfloat16, jnp.bfloat16)}


def _bits(t):
    return t.contiguous().view(torch.uint8 if t.element_size() == 1 else
                               {2: torch.int16, 4: torch.int32,
                                8: torch.int64}[t.element_size()])


def assert_same(got: dict, want: dict):
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k].dtype == want[k].dtype, k
        assert got[k].shape == want[k].shape, k
        assert torch.equal(_bits(got[k]), _bits(want[k])), k


HY_VAE = dict(block_out_channels=(8, 16, 16, 16), norm_num_groups=4,
              latent_channels=4, layers_per_block=1)
WAN_VAE = dict(dim=8, z_dim=4, dim_mult=(1, 2, 2, 2), num_res_blocks=1)


def _hy_case(dtype):
    cfg = thy.HYVideoConfig(**K.HY_TINY)
    sd = K.hy_dit_ref(cfg)
    return (C.convert_hyvideo_dit(sd, cfg, dtype[0]),
            C.hyvideo_params_from_jax(JC.convert_hyvideo_dit(
                sd, jhy.HYVideoConfig(**K.HY_TINY), dtype[1])),
            lambda: thy.HYVideoDiT(cfg))


def _wan_case(dtype, i2v=False, norm3=True):
    kw = dict(K.WAN_TINY, model_type="i2v" if i2v else "t2v",
              in_dim=36 if i2v else 16)
    cfg = twan.WanConfig(**kw)
    sd = K.wan_dit_ref(cfg, norm3=norm3)
    return (C.convert_wan_dit(sd, cfg, dtype[0]),
            C.wan_params_from_jax(JC.convert_wan_dit(
                sd, jwan.WanConfig(**kw), dtype[1])),
            lambda: twan.WanDiT(cfg))


def _hyvae_case(dtype):
    jcfg = jvae_hy.HYVAEConfig(**HY_VAE)
    sd = K.hyvae_ref(jcfg)
    cfg = vae_hy.HYVAEConfig(**HY_VAE)
    return (C.convert_hyvae(sd, cfg, dtype[0]),
            C.hyvae_params_from_jax(JC.convert_hyvae(sd, jcfg, dtype[1])),
            lambda: vae_hy.HYVAE(cfg))


def _wanvae_case(dtype):
    jcfg = jvae_wan.WanVAEConfig(**WAN_VAE)
    sd = K.wanvae_ref(jcfg)
    cfg = vae_wan.WanVAEConfig(**WAN_VAE)
    return (C.convert_wanvae(sd, cfg, dtype[0]),
            C.wanvae_params_from_jax(JC.convert_wanvae(sd, jcfg, dtype[1])),
            lambda: vae_wan.WanVAE(cfg))


def _llama_case(dtype, causal_lm=False):
    sd = K.hf_llama(causal_lm=causal_lm).state_dict()
    cfg = tllama.LlamaConfig(**K.LLAMA_HF)
    return (E.convert_llama(sd, cfg, dtype[0]),
            C.llama_params_from_jax(JE.convert_llama(
                sd, jllama.LlamaConfig(**K.LLAMA_HF), dtype[1])),
            lambda: tllama.Llama(cfg, lm_head=causal_lm))


def _clip_text_case(dtype):
    sd = K.hf_clip_text().state_dict()
    kw = dict(vocab_size=64, hidden_size=12, intermediate_size=24,
              num_layers=2, num_heads=2)
    cfg = tclip.CLIPTextConfig(**kw)
    return (E.convert_clip_text(sd, cfg, dtype[0]),
            C.clip_text_params_from_jax(JE.convert_clip_text(
                sd, jclip.CLIPTextConfig(**kw), dtype[1])),
            lambda: tclip.CLIPText(cfg))


def _clip_vision_hf_case(dtype):
    sd = K.hf_clip_vision().state_dict()
    cfg = tclip.CLIPVisionConfig(**K.LLAVA_VIS)
    return (E.convert_clip_vision_hf(sd, cfg, dtype[0]),
            C.clip_vision_params_from_jax(JE.convert_clip_vision_hf(
                sd, jclip.CLIPVisionConfig(**K.LLAVA_VIS), dtype[1])),
            lambda: tclip.CLIPVision(cfg))


def _llava_case(dtype):
    sd = K.hf_llava().state_dict()
    lcfg = tllama.LlamaConfig(**K.LLAMA_HF)
    vcfg = tclip.CLIPVisionConfig(**K.LLAVA_VIS)
    return (E.convert_llava(sd, lcfg, vcfg, dtype[0]),
            C.llava_params_from_jax(JE.convert_llava(
                sd, jllama.LlamaConfig(**K.LLAMA_HF),
                jclip.CLIPVisionConfig(**K.LLAVA_VIS), dtype[1])),
            lambda: tllava.Llava(lcfg, vcfg, lm_head=True))


def _umt5_wan_case(dtype, shared_pos=False):
    cfg = tt5.T5Config(shared_pos=shared_pos, **K.T5_TINY)
    sd = K.umt5_wan_ref(cfg)
    return (E.convert_umt5_wan(sd, cfg, dtype[0]),
            C.t5_params_from_jax(JE.convert_umt5_wan(
                sd, jt5.T5Config(shared_pos=shared_pos, **K.T5_TINY),
                dtype[1])),
            lambda: tt5.T5Encoder(cfg))


def _umt5_hf_case(dtype):
    sd = K.hf_umt5().state_dict()
    kw = dict(vocab_size=64, dim=24, dim_attn=24, dim_ffn=48, num_heads=2,
              num_layers=2, dtype="float32")
    cfg = tt5.T5Config(**kw)
    return (E.convert_umt5_hf(sd, cfg, dtype[0]),
            C.t5_params_from_jax(JE.convert_umt5_hf(
                sd, jt5.T5Config(**kw), dtype[1])),
            lambda: tt5.T5Encoder(cfg))


def _clip_vision_wan_case(dtype):
    cfg = tclip.CLIPVisionConfig(**K.CLIP_H_TINY)
    sd = K.clip_wan_ref(cfg)
    return (E.convert_clip_vision_wan(sd, cfg, dtype[0]),
            C.clip_vision_params_from_jax(JE.convert_clip_vision_wan(
                sd, jclip.CLIPVisionConfig(**K.CLIP_H_TINY), dtype[1])),
            lambda: tclip.CLIPVision(cfg))


def _xlmr_wan_case(dtype):
    cfg = txlmr.XLMRobertaConfig(**K.XLMR_TINY)
    sd = K.clip_wan_ref(tclip.CLIPVisionConfig(**K.CLIP_H_TINY), cfg)
    return (E.convert_xlm_roberta_wan(sd, cfg, dtype[0]),
            C.xlm_roberta_params_from_jax(JE.convert_xlm_roberta_wan(
                sd, jxlmr.XLMRobertaConfig(**K.XLMR_TINY), dtype[1])),
            lambda: txlmr.XLMRoberta(cfg))


CASES = {
    "hyvideo_dit": _hy_case, "wan_dit": _wan_case,
    "wan_i2v_dit": lambda d: _wan_case(d, i2v=True),
    "wan_dit_no_norm3": lambda d: _wan_case(d, norm3=False),
    "hyvae": _hyvae_case, "wanvae": _wanvae_case,
    "llama": _llama_case,
    "llama_causal_lm": lambda d: _llama_case(d, causal_lm=True),
    "clip_text": _clip_text_case, "clip_vision_hf": _clip_vision_hf_case,
    "llava": _llava_case, "umt5_wan": _umt5_wan_case,
    "umt5_wan_shared_pos": lambda d: _umt5_wan_case(d, shared_pos=True),
    "umt5_hf": _umt5_hf_case, "clip_vision_wan": _clip_vision_wan_case,
    "xlm_roberta_wan": _xlmr_wan_case,
}


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("name", list(CASES))
def test_converter_equals_jax_then_bridge(name, dtype):
    """Key for key and bit for bit against the JAX converter + bridge; the
    result loads strictly into the port module."""
    got, want, make = CASES[name](DTYPES[dtype])
    assert_same(got, want)
    make().load_state_dict(got, strict=True)


@pytest.mark.parametrize("model", ["hy", "wan_i2v"])
def test_dit_converter_gives_the_module_dtypes(model):
    """At a bf16 config, ``dtype=cfg.torch_dtype`` gives every leaf the
    dtype the module (and the JAX init) holds it in."""
    if model == "hy":
        cfg = thy.HYVideoConfig(**dict(K.HY_TINY, dtype="bfloat16"))
        got = C.convert_hyvideo_dit(K.hy_dit_ref(cfg), cfg,
                                    cfg.torch_dtype)
        module = thy.HYVideoDiT(cfg)
    else:
        cfg = twan.WanConfig(**dict(K.WAN_TINY, dtype="bfloat16",
                                    model_type="i2v", in_dim=36))
        got = C.convert_wan_dit(K.wan_dit_ref(cfg), cfg,
                                cfg.torch_dtype)
        module = twan.WanDiT(cfg)
    want = module.state_dict()
    assert {k: v.dtype for k, v in got.items()} == \
        {k: v.dtype for k, v in want.items()}
    assert {torch.bfloat16, torch.float32} == {v.dtype for v in got.values()}


# ---------------------------------------------------------------- files


def _st_tensors(seed=0):
    g = torch.Generator().manual_seed(seed)
    return {"a.f32": torch.randn(3, 5, generator=g),
            "b.f16": torch.randn(7, generator=g).half(),
            "c.bf16": torch.randn(2, 3, 4, generator=g).bfloat16(),
            "d.e4m3": (torch.randn(4, 4, generator=g) * 10).to(
                torch.float8_e4m3fn),
            "e.i64": torch.arange(6).reshape(2, 3),
            "f.scalar": torch.tensor(2.5)}


def test_safetensors_reader_equals_package(tmp_path):
    from safetensors.torch import load_file, save_file
    path = str(tmp_path / "one.safetensors")
    save_file(_st_tensors(), path, metadata={"format": "pt"})
    assert_same(C.read_safetensors(path), load_file(path))
    assert_same(C.load_safetensors_state_dict(path), load_file(path))


@pytest.mark.parametrize("indexed", [True, False])
def test_safetensors_sharded_equals_package(tmp_path, indexed):
    """A directory of two shards, with a ``*.safetensors.index.json`` (a
    third file outside the index is ignored) or without one."""
    from safetensors.torch import load_file, save_file
    parts = [_st_tensors(1), {f"x.{k}": v for k, v in
                              _st_tensors(2).items()}]
    names = ["model-00001-of-00002.safetensors",
             "model-00002-of-00002.safetensors"]
    want = {}
    for part, name in zip(parts, names):
        save_file(part, str(tmp_path / name))
        want.update(load_file(str(tmp_path / name)))
    if indexed:
        (tmp_path / "model.safetensors.index.json").write_text(json.dumps(
            {"weight_map": {k: n for part, n in zip(parts, names)
                            for k in part}}))
        save_file({"stray": torch.zeros(1)},
                  str(tmp_path / "other.safetensors"))
    assert_same(C.load_safetensors_state_dict(str(tmp_path)), want)


def test_safetensors_empty_dir_raises(tmp_path):
    with pytest.raises(FileNotFoundError):
        C.load_safetensors_state_dict(str(tmp_path))


def test_load_torch_state_dict_unwraps_as_jax(tmp_path):
    sd = {"w": torch.randn(3, 4), "b": torch.randn(4).bfloat16()}
    for key in ("module", "ema", "state_dict", "model", None):
        path = str(tmp_path / f"{key}.pt")
        torch.save(sd if key is None else {key: sd, "step": 3}, path)
        assert_same(C.load_torch_state_dict(path),
                    JC.load_torch_state_dict(path))


def test_fp8_state_dict_equals_jax(tmp_path):
    g = torch.Generator().manual_seed(3)
    sd = {"double_blocks.0.img_attn_qkv.weight":
          (torch.randn(8, 4, generator=g) * 50).to(torch.float8_e4m3fn),
          "double_blocks.0.img_attn_qkv.bias": torch.randn(8, generator=g),
          "final_layer.linear.weight":
          (torch.randn(4, 4, generator=g) * 50).to(torch.float8_e4m3fn)}
    scales = {"double_blocks.0.img_attn_qkv": torch.tensor(0.013),
              "final_layer.linear": torch.tensor(0.2).bfloat16()}
    path = str(tmp_path / "pytorch_model_module_fp8.pt")
    torch.save({"module": sd}, path)
    torch.save(scales, path.replace(".pt", "_map.pt"))
    got = C.load_fp8_state_dict(path)
    assert_same(got, JC.load_fp8_state_dict(path))
    assert got["final_layer.linear.weight"].dtype == torch.float32


def test_fp8_missing_map_raises(tmp_path):
    path = str(tmp_path / "pytorch_model_fp8.pt")
    torch.save({"w": torch.zeros(2)}, path)
    with pytest.raises(FileNotFoundError, match="fp8 scale map"):
        C.load_fp8_state_dict(path)


def _lora(g, prefix="Hunyuan_video_I2V"):
    out = {}
    for name, (o, i) in {"double_blocks_0_img_attn_qkv": (12, 4),
                         "single_blocks_1_linear2": (4, 6),
                         "double_blocks_0_txt_mlp_fc1": (8, 4)}.items():
        key = f"{prefix}_lora_{name}"
        out[f"{key}.lora_down.weight"] = torch.randn(2, i, generator=g)
        out[f"{key}.lora_up.weight"] = torch.randn(o, 2, generator=g)
        out[f"{key}.alpha"] = torch.tensor(4.0)
    return out


def _base(g):
    return {"double_blocks.0.img_attn_qkv.weight":
            torch.randn(12, 4, generator=g).bfloat16(),
            "single_blocks.1.linear2.weight": torch.randn(4, 6, generator=g),
            "double_blocks.0.txt_mlp.fc1.weight":
            torch.randn(8, 4, generator=g)}


@pytest.mark.parametrize("from_file", [True, False])
def test_merge_lora_equals_jax(tmp_path, from_file):
    from safetensors.torch import save_file
    g = torch.Generator().manual_seed(4)
    lora, base = _lora(g), _base(g)
    src = lora
    if from_file:
        src = str(tmp_path / "lora.safetensors")
        save_file(lora, src)
    got = C.merge_lora({k: v.clone() for k, v in base.items()}, src,
                       alpha=0.7, prefix="Hunyuan_video_I2V")
    want = JC.merge_lora({k: v.clone() for k, v in base.items()}, src,
                         alpha=0.7, prefix="Hunyuan_video_I2V")
    assert_same(got, want)
    assert not torch.equal(got["single_blocks.1.linear2.weight"],
                           base["single_blocks.1.linear2.weight"])


def test_merge_lora_unknown_target_raises():
    g = torch.Generator().manual_seed(5)
    base = _base(g)
    del base["single_blocks.1.linear2.weight"]
    with pytest.raises(KeyError, match="single_blocks.1.linear2.weight"):
        C.merge_lora(base, _lora(g), prefix="Hunyuan_video_I2V")


def test_save_load_params_roundtrip(tmp_path):
    """bf16 and e4m3 go through the .npz as uint views and come back with
    their dtypes and bytes."""
    cfg = thy.HYVideoConfig(**dict(K.HY_TINY, dtype="bfloat16"))
    module = thy.HYVideoDiT(cfg)
    thy.init_hyvideo_(module, torch.Generator().manual_seed(0))
    quantize_tree_fp8(module, min_size=1024)
    path = str(tmp_path / "params.npz")
    C.save_params(path, module)
    sd = module.state_dict()
    assert {v.dtype for v in sd.values()} == {
        torch.bfloat16, torch.float32, torch.float8_e4m3fn}
    assert_same(C.load_params(path, module), sd)
    like = dict(sd, **{"img_in.b": sd["img_in.b"].double()})
    with pytest.raises(ValueError, match="expected torch.float64"):
        C.load_params(path, like)

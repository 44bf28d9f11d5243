"""Checkpoint loading and conversion: reference torch checkpoints to the
port's state dicts, and the bridge from the JAX parameter pytrees.

Loaders (``torch`` only; no ``safetensors`` package): a torch file with
its deepspeed ``module``/``ema``/``state_dict``/``model`` wrapper
(``load_torch_state_dict``), a reference fp8 DiT with its scale map
(``load_fp8_state_dict``), safetensors files (a file, a directory, or a
sharded ``*.safetensors.index.json``) through the port's own reader
(``read_safetensors`` / ``load_safetensors_state_dict``), and a kohya
LoRA merged into a state dict (``merge_lora``).

Converters (``convert_hyvideo_dit``, ``convert_wan_dit``,
``convert_hyvae``, ``convert_wanvae``; the encoders' are in
``convert.encoders``) map each reference key straight to the port
module's name, tensor by tensor, in torch ``[out, in]`` layout: a linear
weight is never transposed. Each leaf takes the dtype that
``jenga_tpu.convert``'s converter gives it for the same ``dtype``
argument (norm scales, modulation and embedder layers f32, the rest
``dtype``), so ``convert_x(sd)`` equals
``x_params_from_jax(jenga_tpu.convert.convert_x(sd))`` bit for bit.

Bridges: ``hyvideo_params_from_jax(tree)`` and ``wan_params_from_jax(tree)``
take the nested dict/list tree of ``init_hyvideo_params`` /
``init_wan_params`` (or a converted checkpoint) with numpy leaves and
return a flat ``{name: tensor}`` dict for ``HYVideoDiT`` /
``WanDiT.load_state_dict``; ``hyvae_params_from_jax``,
``wanvae_params_from_jax`` and the encoders' ``*_params_from_jax`` do the
same for the VAEs and the text and image encoders. Names are the tree
paths joined with dots; ``None`` leaves (Wan's parameterless head norm)
are dropped. JAX ``linear`` weights are ``[in, out]``; the port's are
torch-style ``[out, in]``, and the bridge transposes every 2-D ``w`` /
``w8`` leaf, fp8 ``w8`` leaves too (a tree from ``quantize_tree_fp8``
loads into a port module quantized the same way). Every leaf keeps its
dtype (bf16 and e4m3 leaves arrive as ml_dtypes arrays).

``lora_from_jax`` carries a JAX LoRA adapter tree (``jenga_tpu.train``'s
``{path: {"a", "b"}}``) across to the port's module paths, so that both
packages can train the same adapters.

``save_params`` / ``load_params`` keep a module's state dict in an
``.npz`` (bf16 as a uint16 view, e4m3 as a uint8 view). The JAX
package's orbax pair is not ported (orbax is JAX's checkpoint library).
"""

from __future__ import annotations

import json
import os
import struct
import zipfile

import numpy as np
import torch

__all__ = ["hyvideo_params_from_jax", "wan_params_from_jax",
           "hyvae_params_from_jax", "wanvae_params_from_jax",
           "llama_params_from_jax", "clip_text_params_from_jax",
           "clip_vision_params_from_jax", "llava_params_from_jax",
           "t5_params_from_jax", "xlm_roberta_params_from_jax",
           "load_torch_state_dict", "read_safetensors",
           "load_safetensors_state_dict", "load_fp8_state_dict",
           "merge_lora", "lora_from_jax", "convert_hyvideo_dit", "convert_wan_dit",
           "convert_hyvae", "convert_wanvae", "save_params", "load_params"]


# ------------------------------------------------------------------ bridges


def _to_tensor(a) -> torch.Tensor:
    """numpy array (incl. ml_dtypes bfloat16 and float8_e4m3fn) -> torch
    tensor, same dtype and bytes."""
    a = np.array(a)     # a writable copy (JAX hands out read-only views)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.uint16)).view(torch.bfloat16)
    if a.dtype.name == "float8_e4m3fn":
        return torch.from_numpy(a.view(np.uint8)).view(torch.float8_e4m3fn)
    return torch.from_numpy(a)


def _flatten(tree, prefix=""):
    if isinstance(tree, dict):
        items = tree.items()
    elif isinstance(tree, (list, tuple)):
        items = enumerate(tree)
    else:
        yield prefix, tree
        return
    for key, sub in items:
        yield from _flatten(sub, f"{prefix}{key}.")


def hyvideo_params_from_jax(tree) -> dict[str, torch.Tensor]:
    out = {}
    for name, leaf in _flatten(tree):
        if leaf is None:
            continue
        name = name[:-1]    # drop the trailing dot
        t = _to_tensor(leaf)
        if name.endswith((".w", ".w8")) and t.ndim == 2:
            t = t.T.contiguous()
        out[name] = t
    return out


def wan_params_from_jax(tree) -> dict[str, torch.Tensor]:
    """The Wan tree's ``head`` becomes the module ``head_layer``."""
    tree = dict(tree)
    tree["head_layer"] = tree.pop("head")
    return hyvideo_params_from_jax(tree)


def hyvae_params_from_jax(tree) -> dict[str, torch.Tensor]:
    """The HunyuanVideo VAE tree of ``init_hyvae_params``. Conv weights
    keep their ``[O, I, kt, kh, kw]`` layout; the mid-block attention's
    ``q/k/v/o.w`` are ``[in, out]`` in JAX and, being the tree's only 2-D
    ``.w`` leaves, are transposed by the same rule as the DiT's linears."""
    return hyvideo_params_from_jax(tree)


def wanvae_params_from_jax(tree) -> dict[str, torch.Tensor]:
    """The Wan VAE tree of ``init_wanvae_params``. Every weight is a conv
    and keeps its layout: ``[O, I, kt, kh, kw]``, or ``[O, I, kh, kw]`` for
    the per-frame 2-D convs, among them the attention's ``qkv``/``proj``
    (1x1, 4-D, so the 2-D rule never transposes them)."""
    return hyvideo_params_from_jax(tree)


def lora_from_jax(tree) -> dict:
    """A JAX adapter tree -> the port's ``{module path: {"a", "b"}}``: the
    path's slashes become dots (Wan's ``head`` the module ``head_layer``);
    ``a`` [rank, in] and ``b`` [out, rank] carry over unchanged, as leaf
    tensors that require grad."""
    out = {}
    for path, ab in tree.items():
        name = path.replace("/", ".")
        if name.split(".")[0] == "head":
            name = "head_layer" + name[len("head"):]
        out[name] = {k: _to_tensor(v).requires_grad_()
                     for k, v in ab.items()}
    return out


# The encoder trees (``jenga_tpu.text``) follow the same rule: every 2-D
# ``w`` is a linear (the CLIP patch embedding's too, ``[3*p*p, d]`` in
# JAX); embeddings, position tables and T5's relative bias are not ``w``.
llama_params_from_jax = hyvideo_params_from_jax
clip_text_params_from_jax = hyvideo_params_from_jax
clip_vision_params_from_jax = hyvideo_params_from_jax
llava_params_from_jax = hyvideo_params_from_jax
t5_params_from_jax = hyvideo_params_from_jax
xlm_roberta_params_from_jax = hyvideo_params_from_jax


# ------------------------------------------------------------------ loaders


def load_torch_state_dict(path: str) -> dict:
    """Load a torch checkpoint file on the CPU (memory-mapped when it is
    a zip archive), unwrapping a deepspeed container: the first of
    ``module``, ``ema``, ``state_dict``, ``model`` that holds a dict."""
    ckpt = torch.load(path, map_location="cpu", weights_only=True,
                      mmap=zipfile.is_zipfile(path))
    for key in ("module", "ema", "state_dict", "model"):
        if isinstance(ckpt, dict) and key in ckpt \
                and isinstance(ckpt[key], dict):
            ckpt = ckpt[key]
            break
    return ckpt


# safetensors dtype tags -> torch dtypes
_ST_DTYPES = {"F64": torch.float64, "F32": torch.float32,
              "F16": torch.float16, "BF16": torch.bfloat16,
              "F8_E4M3": torch.float8_e4m3fn, "F8_E5M2": torch.float8_e5m2,
              "I64": torch.int64, "I32": torch.int32, "I16": torch.int16,
              "I8": torch.int8, "U8": torch.uint8, "BOOL": torch.bool}


def read_safetensors(path: str) -> dict[str, torch.Tensor]:
    """One ``.safetensors`` file -> ``{name: tensor}`` on the CPU: an
    8-byte little-endian header length, a JSON header of ``dtype``,
    ``shape`` and ``data_offsets`` (relative to the end of the header),
    then the raw little-endian bytes, read tensor by tensor."""
    out = {}
    with open(path, "rb") as f:
        (n,) = struct.unpack("<Q", f.read(8))
        header = json.loads(f.read(n))
        base = 8 + n
        for name, info in header.items():
            if name == "__metadata__":
                continue
            dtype = _ST_DTYPES[info["dtype"]]
            start, end = info["data_offsets"]
            if end == start:
                out[name] = torch.empty(info["shape"], dtype=dtype)
                continue
            f.seek(base + start)
            buf = bytearray(f.read(end - start))
            if len(buf) != end - start:
                raise ValueError(f"{path}: {name} is truncated")
            out[name] = torch.frombuffer(buf, dtype=dtype).reshape(
                info["shape"])
    return out


def load_safetensors_state_dict(path: str) -> dict[str, torch.Tensor]:
    """A safetensors checkpoint: a single file, a directory with a
    ``*.safetensors.index.json`` (the shards its ``weight_map`` names, as
    Wan 14B ships its DiT), or a directory of ``.safetensors`` files."""
    if not os.path.isdir(path):
        return read_safetensors(path)
    names = sorted(os.listdir(path))
    idx = [n for n in names if n.endswith(".safetensors.index.json")]
    if idx:
        with open(os.path.join(path, idx[0])) as f:
            shards = sorted(set(json.load(f)["weight_map"].values()))
    else:
        shards = [n for n in names if n.endswith(".safetensors")]
        if not shards:
            raise FileNotFoundError(f"no .safetensors under {path}")
    sd = {}
    for s in shards:
        sd.update(read_safetensors(os.path.join(path, s)))
    return sd


def load_fp8_state_dict(dit_path: str) -> dict:
    """A reference fp8 DiT (``*_fp8.pt``: weights in float8_e4m3fn, with
    ``*_fp8_map.pt`` holding one scale per layer) dequantized to f32, so
    the normal converters apply; other tensors pass through."""
    map_path = dit_path.replace(".pt", "_map.pt")
    if not os.path.exists(map_path):
        raise FileNotFoundError(f"fp8 scale map not found: {map_path}")
    sd = load_torch_state_dict(dit_path)
    fp8_map = torch.load(map_path, map_location="cpu", weights_only=True)
    out = {}
    for k, v in sd.items():
        if isinstance(v, torch.Tensor) and v.dtype == torch.float8_e4m3fn:
            mkey = k[:-len(".weight")] if k.endswith(".weight") else k
            out[k] = v.to(torch.float32) * fp8_map[mkey].to(torch.float32)
        else:
            out[k] = v
    return out


def _kohya_to_module_key(key: str, prefix: str) -> str:
    """kohya LoRA key -> reference module path, e.g.
    ``<pre>_lora_double_blocks_0_img_attn_qkv`` ->
    ``double_blocks.0.img_attn_qkv``."""
    name = key.split(".")[0]
    if prefix and name.startswith(prefix + "_lora_"):
        name = name[len(prefix) + 6:]
    elif name.startswith("lora_"):
        name = name[5:]
    for pat, rep in (
        ("single_blocks_", "single_blocks."),
        ("double_blocks_", "double_blocks."),
        ("_individual_token_refiner_blocks_",
         ".individual_token_refiner.blocks."),
        ("_img_attn_proj", ".img_attn_proj"),
        ("_img_attn_qkv", ".img_attn_qkv"),
        ("_img_mlp_fc", ".img_mlp.fc"),
        ("_txt_mlp_fc", ".txt_mlp.fc"),
        ("_img_mod", ".img_mod"),
        ("_txt", ".txt"),
        ("_modulation", ".modulation"),
        ("_linear", ".linear"),
        ("_mlp_fc", ".mlp.fc"),
    ):
        name = name.replace(pat, rep)
    # remaining single-word underscore segments after a block index
    # (e.g. ``0_self_attn_qkv``) become dots
    fixed = []
    for p in name.split("."):
        if "_" in p and p.split("_")[0].isdigit():
            fixed.extend(p.split("_", 1))
        else:
            fixed.append(p)
    return ".".join(fixed)


def merge_lora(sd: dict, lora, alpha: float = 1.0, prefix: str = "") -> dict:
    """Merge a kohya-format LoRA into a torch state dict in place:
    ``W += alpha * a / rank * up @ down`` per adapted linear, in f32, cast
    back to W's dtype. ``lora`` is a safetensors path or a dict with
    ``<name>.lora_down.weight`` / ``<name>.lora_up.weight`` / optional
    ``<name>.alpha`` entries; a target missing from ``sd`` raises."""
    if isinstance(lora, str):
        lora = read_safetensors(lora)
    downs = {k: v for k, v in lora.items() if k.endswith("lora_down.weight")}
    for dk, down in downs.items():
        base = dk[:-len(".lora_down.weight")]
        up = lora[f"{base}.lora_up.weight"]
        rank = down.shape[0]
        a = float(lora.get(f"{base}.alpha", rank))
        target = _kohya_to_module_key(base, prefix) + ".weight"
        if target not in sd:
            raise KeyError(f"LoRA target {target} not in base state dict")
        w = sd[target]
        delta = (alpha * a / rank) * (up.to(torch.float32)
                                      @ down.to(torch.float32))
        sd[target] = (w.to(torch.float32) + delta).to(w.dtype)
    return sd


# --------------------------------------------------------------- converters


def _cast(t, dtype) -> torch.Tensor:
    """A reference tensor in ``dtype``, rounded as the JAX converter rounds
    it (through f32); returned as is when it has the dtype already."""
    t = torch.as_tensor(t)
    if t.dtype == dtype:
        return t
    return t.to(torch.float32).to(dtype)


class _Writer:
    """Collects the port's ``{name: tensor}`` from a reference state dict.
    ``lin`` takes a linear (``w`` [out, in] and ``b`` if present), ``norm``
    an affine norm (``w``, ``b``, f32), ``vec`` one tensor."""

    def __init__(self, sd: dict, dtype):
        self.sd, self.dtype, self.out = sd, dtype, {}

    def has(self, key: str) -> bool:
        return key in self.sd

    def vec(self, dst: str, src: str, dtype=torch.float32, fn=None):
        t = self.sd[src]
        self.out[dst] = _cast(t if fn is None else fn(torch.as_tensor(t)),
                              dtype)

    def lin(self, dst: str, src: str, dtype=torch.float32,
            weight_fn=None):
        self.vec(f"{dst}.w", f"{src}.weight", dtype, weight_fn)
        if f"{src}.bias" in self.sd:
            self.vec(f"{dst}.b", f"{src}.bias", dtype)

    def big(self, dst: str, src: str):
        """A linear in the converter's ``dtype``."""
        self.lin(dst, src, self.dtype)

    def norm(self, dst: str, src: str):
        self.vec(f"{dst}.w", f"{src}.weight")
        self.vec(f"{dst}.b", f"{src}.bias")


def _patch(w):
    """Conv(kernel == stride) weight [d, C, *k] -> matmul weight
    [d, C*prod(k)] (the port's patch embedding is a linear)."""
    return w.reshape(w.shape[0], -1)


def convert_wan_dit(sd: dict, cfg, dtype=torch.float32) -> dict:
    """WanModel state dict -> ``WanDiT`` state dict."""
    o = _Writer(sd, dtype)
    for i in range(cfg.num_layers):
        pre, dst = f"blocks.{i}", f"blocks.{i}"
        for attn in ("self_attn", "cross_attn"):
            for lin in ("q", "k", "v", "o"):
                o.big(f"{dst}.{attn}.{lin}", f"{pre}.{attn}.{lin}")
            o.vec(f"{dst}.{attn}.norm_q", f"{pre}.{attn}.norm_q.weight")
            o.vec(f"{dst}.{attn}.norm_k", f"{pre}.{attn}.norm_k.weight")
        if o.has(f"{pre}.cross_attn.k_img.weight"):
            o.big(f"{dst}.cross_attn.k_img", f"{pre}.cross_attn.k_img")
            o.big(f"{dst}.cross_attn.v_img", f"{pre}.cross_attn.v_img")
            o.vec(f"{dst}.cross_attn.norm_k_img",
                  f"{pre}.cross_attn.norm_k_img.weight")
        if o.has(f"{pre}.norm3.weight"):
            o.norm(f"{dst}.norm3", f"{pre}.norm3")
        else:
            o.out[f"{dst}.norm3.w"] = torch.ones(cfg.dim)
            o.out[f"{dst}.norm3.b"] = torch.zeros(cfg.dim)
        o.big(f"{dst}.ffn.fc1", f"{pre}.ffn.0")
        o.big(f"{dst}.ffn.fc2", f"{pre}.ffn.2")
        o.vec(f"{dst}.modulation", f"{pre}.modulation", fn=lambda t: t[0])
    o.lin("patch_embedding", "patch_embedding", dtype, weight_fn=_patch)
    o.big("text_embedding.fc1", "text_embedding.0")
    o.big("text_embedding.fc2", "text_embedding.2")
    o.lin("time_embedding.fc1", "time_embedding.0")
    o.lin("time_embedding.fc2", "time_embedding.2")
    o.lin("time_projection", "time_projection.1")
    o.big("head_layer.linear", "head.head")
    o.vec("head_layer.modulation", "head.modulation", fn=lambda t: t[0])
    if o.has("img_emb.proj.0.weight"):
        o.norm("img_emb.norm_in", "img_emb.proj.0")
        o.big("img_emb.fc1", "img_emb.proj.1")
        o.big("img_emb.fc2", "img_emb.proj.3")
        o.norm("img_emb.norm_out", "img_emb.proj.4")
    return o.out


def convert_hyvideo_dit(sd: dict, cfg, dtype=torch.float32) -> dict:
    """HYVideoDiffusionTransformer state dict -> ``HYVideoDiT`` state
    dict."""
    o = _Writer(sd, dtype)
    for i in range(cfg.double_blocks):
        pre = f"double_blocks.{i}"
        o.lin(f"{pre}.img_mod", f"{pre}.img_mod.linear")
        o.lin(f"{pre}.txt_mod", f"{pre}.txt_mod.linear")
        for s in ("img", "txt"):
            o.big(f"{pre}.{s}_qkv", f"{pre}.{s}_attn_qkv")
            o.vec(f"{pre}.{s}_q_norm", f"{pre}.{s}_attn_q_norm.weight")
            o.vec(f"{pre}.{s}_k_norm", f"{pre}.{s}_attn_k_norm.weight")
            o.big(f"{pre}.{s}_proj", f"{pre}.{s}_attn_proj")
            o.big(f"{pre}.{s}_mlp.fc1", f"{pre}.{s}_mlp.fc1")
            o.big(f"{pre}.{s}_mlp.fc2", f"{pre}.{s}_mlp.fc2")
    for i in range(cfg.single_blocks):
        pre = f"single_blocks.{i}"
        o.lin(f"{pre}.modulation", f"{pre}.modulation.linear")
        o.big(f"{pre}.linear1", f"{pre}.linear1")
        o.big(f"{pre}.linear2", f"{pre}.linear2")
        o.vec(f"{pre}.q_norm", f"{pre}.q_norm.weight")
        o.vec(f"{pre}.k_norm", f"{pre}.k_norm.weight")
    for i in range(cfg.refiner_depth):
        pre = f"txt_in.individual_token_refiner.blocks.{i}"
        dst = f"txt_in.blocks.{i}"
        o.norm(f"{dst}.norm1", f"{pre}.norm1")
        o.big(f"{dst}.qkv", f"{pre}.self_attn_qkv")
        o.big(f"{dst}.proj", f"{pre}.self_attn_proj")
        o.norm(f"{dst}.norm2", f"{pre}.norm2")
        o.big(f"{dst}.mlp.fc1", f"{pre}.mlp.fc1")
        o.big(f"{dst}.mlp.fc2", f"{pre}.mlp.fc2")
        o.lin(f"{dst}.adaLN", f"{pre}.adaLN_modulation.1")
    o.lin("img_in", "img_in.proj", dtype, weight_fn=_patch)
    o.big("txt_in.input_embedder", "txt_in.input_embedder")
    o.lin("txt_in.t_embedder.fc1", "txt_in.t_embedder.mlp.0")
    o.lin("txt_in.t_embedder.fc2", "txt_in.t_embedder.mlp.2")
    o.big("txt_in.c_embedder.fc1", "txt_in.c_embedder.linear_1")
    o.big("txt_in.c_embedder.fc2", "txt_in.c_embedder.linear_2")
    o.lin("time_in.fc1", "time_in.mlp.0")
    o.lin("time_in.fc2", "time_in.mlp.2")
    o.lin("vector_in.fc1", "vector_in.in_layer")
    o.lin("vector_in.fc2", "vector_in.out_layer")
    o.big("final_layer.linear", "final_layer.linear")
    o.lin("final_layer.adaLN", "final_layer.adaLN_modulation.1")
    if o.has("guidance_in.mlp.0.weight"):
        o.lin("guidance_in.fc1", "guidance_in.mlp.0")
        o.lin("guidance_in.fc2", "guidance_in.mlp.2")
    return o.out


def convert_hyvae(sd: dict, cfg, dtype=torch.float32) -> dict:
    """AutoencoderKLCausal3D state dict -> ``codec.vae_hy.HYVAE`` state
    dict."""
    o = _Writer(sd, dtype)

    def conv(dst, src):
        o.vec(f"{dst}.w", f"{src}.conv.weight", dtype)
        o.vec(f"{dst}.b", f"{src}.conv.bias", dtype)

    def resnet(dst, src):
        o.norm(f"{dst}.norm1", f"{src}.norm1")
        conv(f"{dst}.conv1", f"{src}.conv1")
        o.norm(f"{dst}.norm2", f"{src}.norm2")
        conv(f"{dst}.conv2", f"{src}.conv2")
        if o.has(f"{src}.conv_shortcut.conv.weight"):
            conv(f"{dst}.shortcut", f"{src}.conv_shortcut")

    def mid(dst, src):
        resnet(f"{dst}.resnet0", f"{src}.resnets.0")
        resnet(f"{dst}.resnet1", f"{src}.resnets.1")
        a = f"{src}.attentions.0"
        o.norm(f"{dst}.attn.norm", f"{a}.group_norm")
        for lin, ref in (("q", "to_q"), ("k", "to_k"), ("v", "to_v"),
                         ("o", "to_out.0")):
            o.lin(f"{dst}.attn.{lin}", f"{a}.{ref}")

    for i in range(len(cfg.block_out_channels)):
        src, dst = f"encoder.down_blocks.{i}", f"encoder.blocks.{i}"
        for j in range(cfg.layers_per_block):
            resnet(f"{dst}.resnets.{j}", f"{src}.resnets.{j}")
        if o.has(f"{src}.downsamplers.0.conv.conv.weight"):
            conv(f"{dst}.down", f"{src}.downsamplers.0.conv")
        src, dst = f"decoder.up_blocks.{i}", f"decoder.blocks.{i}"
        for j in range(cfg.layers_per_block + 1):
            resnet(f"{dst}.resnets.{j}", f"{src}.resnets.{j}")
        if o.has(f"{src}.upsamplers.0.conv.conv.weight"):
            conv(f"{dst}.up.conv", f"{src}.upsamplers.0.conv")
    for part in ("encoder", "decoder"):
        conv(f"{part}.conv_in", f"{part}.conv_in")
        mid(f"{part}.mid", f"{part}.mid_block")
        o.norm(f"{part}.norm_out", f"{part}.conv_norm_out")
        conv(f"{part}.conv_out", f"{part}.conv_out")
    for name in ("quant_conv", "post_quant_conv"):
        o.vec(f"{name}.w", f"{name}.weight", dtype)
        o.vec(f"{name}.b", f"{name}.bias", dtype)
    return o.out


def convert_wanvae(sd: dict, cfg, dtype=torch.float32) -> dict:
    """WanVAE_ state dict (flat nn.Sequential indices) ->
    ``codec.vae_wan.WanVAE`` state dict."""
    o = _Writer(sd, dtype)

    def conv(dst, src):
        o.vec(f"{dst}.w", f"{src}.weight", dtype)
        o.vec(f"{dst}.b", f"{src}.bias", dtype)

    def rms(dst, src):
        o.vec(f"{dst}.g", f"{src}.gamma", fn=lambda t: t.reshape(-1))

    def resblock(dst, src):
        rms(f"{dst}.norm1", f"{src}.residual.0")
        conv(f"{dst}.conv1", f"{src}.residual.2")
        rms(f"{dst}.norm2", f"{src}.residual.3")
        conv(f"{dst}.conv2", f"{src}.residual.6")
        if o.has(f"{src}.shortcut.weight"):
            conv(f"{dst}.shortcut", f"{src}.shortcut")

    def mid(dst, src):
        resblock(f"{dst}.res0", f"{src}.0")
        rms(f"{dst}.attn.norm", f"{src}.1.norm")
        conv(f"{dst}.attn.qkv", f"{src}.1.to_qkv")
        conv(f"{dst}.attn.proj", f"{src}.1.proj")
        resblock(f"{dst}.res1", f"{src}.2")

    n_stage = len(cfg.dim_mult)
    t_up = tuple(reversed(cfg.temporal_downsample))
    for part, stages, n_res, temporal in (
            ("encoder", "down", cfg.num_res_blocks, cfg.temporal_downsample),
            ("decoder", "up", cfg.num_res_blocks + 1, t_up)):
        ref = "downsamples" if stages == "down" else "upsamples"
        conv(f"{part}.conv1", f"{part}.conv1")
        mid(f"{part}.mid", f"{part}.middle")
        rms(f"{part}.head_norm", f"{part}.head.0")
        conv(f"{part}.head_conv", f"{part}.head.2")
        idx = 0
        for i in range(n_stage):
            dst = f"{part}.{stages}.{i}"
            for j in range(n_res):
                resblock(f"{dst}.res.{j}", f"{part}.{ref}.{idx}")
                idx += 1
            if i != n_stage - 1:
                src = f"{part}.{ref}.{idx}"
                conv(f"{dst}.sample.conv", f"{src}.resample.1")
                if temporal[i]:
                    conv(f"{dst}.sample.time_conv", f"{src}.time_conv")
                idx += 1
    conv("conv1", "conv1")
    conv("conv2", "conv2")
    return o.out


# ---------------------------------------------------------------- npz files

# dtypes an .npz cannot hold, stored as an unsigned view of their bytes
_VIEWS = {torch.bfloat16: torch.uint16, torch.float8_e4m3fn: torch.uint8}


def save_params(path: str, params) -> None:
    """A module's state dict (or a ``{name: tensor}`` dict) -> ``.npz``;
    bf16 and e4m3 tensors go in as uint16 / uint8 views of their bytes."""
    sd = params.state_dict() if isinstance(params, torch.nn.Module) \
        else params
    flat = {}
    for name, t in sd.items():
        t = t.detach().cpu().contiguous()
        if t.dtype in _VIEWS:
            t = t.view(_VIEWS[t.dtype])
        flat[name] = t.numpy()
    np.savez(path, **flat)


def load_params(path: str, like) -> dict[str, torch.Tensor]:
    """An ``.npz`` of ``save_params`` -> ``{name: tensor}`` with the names,
    shapes and dtypes of ``like`` (a module or a state dict), on the CPU;
    a uint view is read back as the dtype ``like`` has."""
    sd = like.state_dict() if isinstance(like, torch.nn.Module) else like
    data = np.load(path)
    out = {}
    for name, ref in sd.items():
        t = torch.from_numpy(np.array(data[name]))
        if ref.dtype in _VIEWS and t.dtype == _VIEWS[ref.dtype]:
            t = t.view(ref.dtype)
        if t.dtype != ref.dtype or tuple(t.shape) != tuple(ref.shape):
            raise ValueError(f"{path}: {name} is {t.dtype} "
                             f"{tuple(t.shape)}, expected {ref.dtype} "
                             f"{tuple(ref.shape)}")
        out[name] = t
    return out

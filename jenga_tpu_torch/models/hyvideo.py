"""HunyuanVideo MMDiT as an ``nn.Module``, with first-class carving.

Port of ``jenga_tpu/models/hyvideo.py``: 20 double-stream blocks (separate
img/txt streams, joint attention) + 40 single-stream blocks, hidden 3072 /
24 heads, 3-D RoPE (16, 56, 56) at theta 256, an LLM-token refiner and a
CLIP pooled vector in the modulation, and the guidance embedding. Image
tokens are gilbert-reordered once at embed time (the RoPE tables follow
the reorder) and every block's joint attention goes through the planner
and the block-sparse kernel. The ``embed`` / ``trunk`` / ``head`` split is
kept because the fixed-list skip residual lives on the trunk.

Parameter names follow the JAX pytree (``double_blocks.3.img_qkv.w``), so
``convert.hyvideo_params_from_jax`` gives a state dict for
``load_state_dict``. Linear weights are torch-style ``[out, in]``.

Not ported (each raises ``NotImplementedError`` when asked for): the
token-replace (I2V) branches, the sequence-parallel mesh, ``sel_mask``
selection replay, and ``scan``/``remat``.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch
from torch import nn

from ..curves.blocks import build_curve_plan
from ..ops.flash_attention import attention_bshd
from ..ops.sparse_dispatch import sparse_attention_from_mask
from ..sparse.planner import build_block_mask
from . import layers as L

__all__ = ["HYVideoConfig", "HYCarve", "HYVideoDiT", "make_hy_carve",
           "hy_rope_tables", "HUNYUAN_VIDEO_T2V", "init_hyvideo_"]

_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


@dataclasses.dataclass(frozen=True)
class HYVideoConfig:
    """Architecture hyperparameters (same fields as the JAX config)."""
    patch_size: tuple[int, int, int] = (1, 2, 2)
    in_channels: int = 16
    out_channels: int = 16
    hidden_size: int = 3072
    heads_num: int = 24
    mlp_ratio: float = 4.0
    double_blocks: int = 20
    single_blocks: int = 40
    rope_dim_list: tuple[int, int, int] = (16, 56, 56)
    rope_theta: float = 256.0
    qkv_bias: bool = True
    guidance_embed: bool = True
    text_states_dim: int = 4096
    text_states_dim_2: int = 768
    refiner_depth: int = 2
    i2v_condition_type: str | None = None
    dtype: str = "bfloat16"

    @property
    def head_dim(self) -> int:
        return self.hidden_size // self.heads_num

    @property
    def mlp_hidden(self) -> int:
        return int(self.hidden_size * self.mlp_ratio)

    @property
    def torch_dtype(self) -> torch.dtype:
        return _DTYPES[self.dtype]


HUNYUAN_VIDEO_T2V = HYVideoConfig()


@dataclasses.dataclass(frozen=True)
class HYCarve:
    """Per-stage carving spec: curve order, adjacency and curve-permuted
    RoPE tables as device tensors, plus the selection scalars."""
    curve_order: torch.Tensor       # [S_img] int64
    inverse_order: torch.Tensor     # [S_img] int64
    block_neighbors: torch.Tensor   # [nb, nb] bool over video blocks
    rope_cos: torch.Tensor          # [S_img, head_dim//2] f32
    rope_sin: torch.Tensor
    sa_drop_rate: float
    p_remain: float
    text_amp: float = 0.0
    txt_block_num: int = 2
    q_rows: int = 1
    joint_sel: bool = False
    sel_mask: object = None         # selection replay: not ported


def hy_rope_tables(cfg: HYVideoConfig, grid, order=None):
    """3-D RoPE tables at theta 256 (numpy f32, built in f64)."""
    return L.rope_table_3d(grid, cfg.rope_dim_list, theta=cfg.rope_theta,
                           order=order)


def make_hy_carve(cfg: HYVideoConfig, grid, sa_drop_rate: float,
                  p_remain: float, curve: str = "gilbert",
                  text_amp: float = 0.0, txt_block_num: int = 2,
                  q_rows: int = 1, joint_sel: bool = False,
                  device="cpu") -> HYCarve:
    """Carving spec for a (t, h, w) token grid. The curve plan (order and
    block adjacency) comes from the port's copy of the JAX package's numpy
    ``build_curve_plan``, so both packages carve identically."""
    if q_rows > 8 and not joint_sel:
        raise ValueError(f"q_rows={q_rows} requires joint selection")
    plan = build_curve_plan(tuple(grid), curve, 128)
    cos, sin = hy_rope_tables(cfg, plan.grid, order=plan.curve_order)

    def dev(a, dtype):
        return torch.as_tensor(np.asarray(a), dtype=dtype, device=device)

    return HYCarve(curve_order=dev(plan.curve_order, torch.int64),
                   inverse_order=dev(plan.linear_to_curve, torch.int64),
                   block_neighbors=dev(plan.block_neighbors, torch.bool),
                   rope_cos=dev(cos, torch.float32),
                   rope_sin=dev(sin, torch.float32),
                   sa_drop_rate=float(sa_drop_rate),
                   p_remain=float(p_remain), text_amp=float(text_amp),
                   txt_block_num=int(txt_block_num), q_rows=int(q_rows),
                   joint_sel=bool(joint_sel))


# --------------------------------------------------------------- modules


def _timestep_embedder(p: L.MLP, t):
    """sinusoidal(256, cos-first) -> Linear -> SiLU -> Linear, f32."""
    emb = L.sinusoidal_embedding(256, t, flip_sin_cos=True)
    return p.fc2(L.silu(p.fc1(emb))).float()


def _mlp_embedder(p: L.MLP, x):
    return p.fc2(L.silu(p.fc1(x)))


class RefinerBlock(nn.Module):
    def __init__(self, cfg: HYVideoConfig, device):
        super().__init__()
        d, mh, dt = cfg.hidden_size, cfg.mlp_hidden, cfg.torch_dtype
        self.norm1 = L.Norm(d, device)
        self.qkv = L.Affine(d, 3 * d, dt, device)
        self.proj = L.Affine(d, d, dt, device)
        self.norm2 = L.Norm(d, device)
        self.mlp = L.MLP(d, mh, d, dt, device)
        self.adaLN = L.Affine(d, 2 * d, torch.float32, device, zero=True)


class TokenRefiner(nn.Module):
    """Cross-modal refiner for the LLM text states."""

    def __init__(self, cfg: HYVideoConfig, device):
        super().__init__()
        d, dt = cfg.hidden_size, cfg.torch_dtype
        self.cfg = cfg
        self.input_embedder = L.Affine(cfg.text_states_dim, d, dt, device)
        self.t_embedder = L.MLP(256, d, d, torch.float32, device)
        self.c_embedder = L.MLP(cfg.text_states_dim, d, d, dt, device)
        self.blocks = nn.ModuleList(RefinerBlock(cfg, device)
                                    for _ in range(cfg.refiner_depth))

    def forward(self, txt, t, mask):
        cfg = self.cfg
        dtype = cfg.torch_dtype
        t_emb = _timestep_embedder(self.t_embedder, t)
        if mask is None:
            pooled = txt.mean(dim=1)
        else:
            mf = mask.float()[..., None]
            pooled = (txt * mf).sum(dim=1) / mf.sum(dim=1).clamp_min(1.0)
        c = t_emb + _mlp_embedder(self.c_embedder, pooled.to(dtype)).float()
        x = self.input_embedder(txt.to(dtype))

        b, s, d = x.shape
        n, hd = cfg.heads_num, cfg.head_dim
        attn_mask = None
        if mask is not None:
            m = mask.bool()
            attn_mask = m[:, None, :] & m[:, :, None]
            attn_mask[:, :, 0] = True
        for blk in self.blocks:
            gate = blk.adaLN(L.silu(c)).float()
            gate_msa, gate_mlp = gate[:, None, :d], gate[:, None, d:]
            nx = L.layer_norm(x, blk.norm1.w, blk.norm1.b)
            qkv = blk.qkv(nx).reshape(b, s, 3, n, hd)
            q, k, v = qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2]
            logits = torch.einsum("bqhd,bkhd->bhqk", q.float(),
                                  k.float()) * hd ** -0.5
            if attn_mask is not None:
                logits = logits.masked_fill(~attn_mask[:, None],
                                            float("-inf"))
            pa = torch.softmax(logits, dim=-1)
            attn = torch.einsum("bhqk,bkhd->bqhd", pa, v.float())
            attn = attn.reshape(b, s, d).to(x.dtype)
            x = (x.float() + blk.proj(attn).float() * gate_msa).to(x.dtype)
            y = L.layer_norm(x, blk.norm2.w, blk.norm2.b)
            y = blk.mlp.fc2(L.silu(blk.mlp.fc1(y)))
            x = (x.float() + y.float() * gate_mlp).to(x.dtype)
        return x


def _gated(x, y, gate):
    return (x.float() + y.float() * gate).to(x.dtype)


def _joint_attention(q, k, v, carve: HYCarve | None, img_len: int, seqlen):
    """Joint img+txt attention: sparse video rows and dense text rows in
    one kernel launch; dense fallback when there is no carving or the
    sequence is too short to leave a video block before the text blocks.
    q/k/v [B, S, H, D] -> [B, S, H*D]."""
    b, s, n, hd = q.shape
    s_pad = -(-s // 128) * 128
    carved = not (carve is None or carve.sa_drop_rate == 0.0
                  or s_pad // 128 <= carve.txt_block_num)
    if carve is not None and carve.sel_mask is not None:
        raise NotImplementedError("HYCarve.sel_mask selection replay is "
                                  "not ported")
    if not carved:
        return attention_bshd(q, k, v, kv_len=seqlen).reshape(b, s, n * hd)

    pad = s_pad - s
    qt, kt, vt = (torch.nn.functional.pad(x, (0, 0, 0, 0, 0, pad))
                  .transpose(1, 2) for x in (q, k, v))
    num_blocks = s_pad // 128
    tsb = num_blocks - carve.txt_block_num
    top_k = int((1.0 - carve.sa_drop_rate) * (img_len // 128))
    qr = max(1, int(carve.q_rows))
    joint = qr > 1 and carve.joint_sel
    mask = build_block_mask(
        qt[:, :, :tsb * 128], kt, top_k=top_k, p_remain=carve.p_remain,
        text_start_block=tsb, text_blocks=carve.txt_block_num,
        block_neighbors=carve.block_neighbors,
        sel_group=qr if joint else 1)
    full = torch.ones((b, n, num_blocks - tsb, num_blocks), dtype=torch.bool,
                      device=q.device)
    mask = torch.cat([mask, full], dim=2)
    out = sparse_attention_from_mask(
        qt, kt, vt, mask, seqlens=seqlen, text_start_block=tsb,
        text_amp=carve.text_amp, q_rows=qr, joint=joint)
    return out.transpose(1, 2)[:, :s].reshape(b, s, n * hd)


class DoubleBlock(nn.Module):
    """MMDoubleStreamBlock: separate img/txt streams, joint attention."""

    def __init__(self, cfg: HYVideoConfig, device):
        super().__init__()
        d, hd, mh = cfg.hidden_size, cfg.head_dim, cfg.mlp_hidden
        dt, f32, bias = cfg.torch_dtype, torch.float32, cfg.qkv_bias
        self.cfg = cfg
        self.img_mod = L.Affine(d, 6 * d, f32, device)
        self.txt_mod = L.Affine(d, 6 * d, f32, device)
        self.img_qkv = L.Affine(d, 3 * d, dt, device, bias=bias)
        self.txt_qkv = L.Affine(d, 3 * d, dt, device, bias=bias)
        for name in ("img_q_norm", "img_k_norm", "txt_q_norm", "txt_k_norm"):
            setattr(self, name, L.param((hd,), f32, device))
        self.img_proj = L.Affine(d, d, dt, device, bias=bias)
        self.txt_proj = L.Affine(d, d, dt, device, bias=bias)
        self.img_mlp = L.MLP(d, mh, d, dt, device)
        self.txt_mlp = L.MLP(d, mh, d, dt, device)

    def forward(self, img, txt, vec, carve, rope_cos, rope_sin, seqlen):
        b, si, d = img.shape
        st = txt.shape[1]
        n, hd = self.cfg.heads_num, self.cfg.head_dim
        im = self.img_mod(L.silu(vec)).float()[:, None].chunk(6, dim=-1)
        tm = self.txt_mod(L.silu(vec)).float()[:, None].chunk(6, dim=-1)

        img_mod = L.modulate(L.layer_norm(img), shift=im[0], scale=im[1])
        img_qkv = self.img_qkv(img_mod).reshape(b, si, 3, n, hd)
        img_q = L.rms_norm(img_qkv[:, :, 0], self.img_q_norm)
        img_k = L.rms_norm(img_qkv[:, :, 1], self.img_k_norm)
        img_q = L.apply_rope(img_q, rope_cos, rope_sin)
        img_k = L.apply_rope(img_k, rope_cos, rope_sin)

        txt_mod = L.modulate(L.layer_norm(txt), shift=tm[0], scale=tm[1])
        txt_qkv = self.txt_qkv(txt_mod).reshape(b, st, 3, n, hd)
        txt_q = L.rms_norm(txt_qkv[:, :, 0], self.txt_q_norm)
        txt_k = L.rms_norm(txt_qkv[:, :, 1], self.txt_k_norm)

        q = torch.cat([img_q, txt_q], dim=1)
        k = torch.cat([img_k, txt_k], dim=1)
        v = torch.cat([img_qkv[:, :, 2], txt_qkv[:, :, 2]], dim=1)
        attn = _joint_attention(q, k, v, carve, si, seqlen)
        img_attn, txt_attn = attn[:, :si], attn[:, si:]

        img = _gated(img, self.img_proj(img_attn), im[2])
        y = L.modulate(L.layer_norm(img), shift=im[3], scale=im[4])
        y = self.img_mlp.fc2(L.gelu_tanh(self.img_mlp.fc1(y)))
        img = _gated(img, y, im[5])

        txt = _gated(txt, self.txt_proj(txt_attn), tm[2])
        y = L.modulate(L.layer_norm(txt), shift=tm[3], scale=tm[4])
        y = self.txt_mlp.fc2(L.gelu_tanh(self.txt_mlp.fc1(y)))
        txt = _gated(txt, y, tm[5])
        return img, txt


class SingleBlock(nn.Module):
    """MMSingleStreamBlock: fused qkv + MLP projections."""

    def __init__(self, cfg: HYVideoConfig, device):
        super().__init__()
        d, hd, mh, dt = (cfg.hidden_size, cfg.head_dim, cfg.mlp_hidden,
                         cfg.torch_dtype)
        self.cfg = cfg
        self.modulation = L.Affine(d, 3 * d, torch.float32, device)
        self.linear1 = L.Affine(d, 3 * d + mh, dt, device)
        self.linear2 = L.Affine(d + mh, d, dt, device)
        self.q_norm = L.param((hd,), torch.float32, device)
        self.k_norm = L.param((hd,), torch.float32, device)

    def forward(self, x, vec, carve, rope_cos, rope_sin, txt_len, seqlen):
        b, s, d = x.shape
        n, hd = self.cfg.heads_num, self.cfg.head_dim
        shift, scale, gate = self.modulation(L.silu(vec)).float()[:, None] \
            .chunk(3, dim=-1)
        x_mod = L.modulate(L.layer_norm(x), shift=shift, scale=scale)
        y = self.linear1(x_mod)
        qkv, mlp = y[..., :3 * d], y[..., 3 * d:]
        qkv = qkv.reshape(b, s, 3, n, hd)
        q = L.rms_norm(qkv[:, :, 0], self.q_norm)
        k = L.rms_norm(qkv[:, :, 1], self.k_norm)
        v = qkv[:, :, 2]
        img_len = s - txt_len
        q = torch.cat([L.apply_rope(q[:, :img_len], rope_cos, rope_sin),
                       q[:, img_len:]], dim=1)
        k = torch.cat([L.apply_rope(k[:, :img_len], rope_cos, rope_sin),
                       k[:, img_len:]], dim=1)
        attn = _joint_attention(q, k, v, carve, img_len, seqlen)
        out = self.linear2(torch.cat([attn, L.gelu_tanh(mlp)], dim=-1))
        return _gated(x, out, gate)


class FinalLayer(nn.Module):
    def __init__(self, cfg: HYVideoConfig, device):
        super().__init__()
        d = cfg.hidden_size
        self.linear = L.Affine(d,
                               math.prod(cfg.patch_size) * cfg.out_channels,
                               cfg.torch_dtype, device, zero=True)
        self.adaLN = L.Affine(d, 2 * d, torch.float32, device, zero=True)


class HYVideoDiT(nn.Module):
    """The HunyuanVideo MMDiT. Parameters are allocated uninitialised on
    ``device``: load a converted state dict or call ``init_hyvideo_``."""

    def __init__(self, cfg: HYVideoConfig, device="cpu"):
        super().__init__()
        if cfg.i2v_condition_type is not None:
            raise NotImplementedError("the token-replace (I2V) branches are "
                                      "not ported")
        d, dt, f32 = cfg.hidden_size, cfg.torch_dtype, torch.float32
        self.cfg = cfg
        patch_in = cfg.in_channels * math.prod(cfg.patch_size)
        self.img_in = L.Affine(patch_in, d, dt, device)
        self.txt_in = TokenRefiner(cfg, device)
        self.time_in = L.MLP(256, d, d, f32, device)
        self.vector_in = L.MLP(cfg.text_states_dim_2, d, d, f32, device)
        self.double_blocks = nn.ModuleList(
            DoubleBlock(cfg, device) for _ in range(cfg.double_blocks))
        self.single_blocks = nn.ModuleList(
            SingleBlock(cfg, device) for _ in range(cfg.single_blocks))
        self.final_layer = FinalLayer(cfg, device)
        if cfg.guidance_embed:
            self.guidance_in = L.MLP(256, d, d, f32, device)

    @property
    def device(self):
        return self.img_in.w.device

    def embed(self, x, t, text_states, text_mask, text_states_2,
              carve: HYCarve | None = None, guidance=None):
        """Patchify + curve reorder + refiner + modulation vector."""
        cfg = self.cfg
        b = x.shape[0]
        img, grid = L.patchify_3d(self.img_in, x.to(cfg.torch_dtype),
                                  cfg.patch_size)
        vec = _timestep_embedder(self.time_in, t)
        vec = vec + _mlp_embedder(self.vector_in, text_states_2.float())
        if cfg.guidance_embed:
            if guidance is None:
                guidance = torch.full((b,), 1000.0, device=x.device)
            vec = vec + _timestep_embedder(self.guidance_in, guidance)
        vec = vec.float()
        txt = self.txt_in(text_states, t, text_mask)
        if carve is not None:
            img = img[:, carve.curve_order]
            rope_cos, rope_sin = carve.rope_cos, carve.rope_sin
        else:
            rope_cos, rope_sin = (torch.as_tensor(a, device=x.device)
                                  for a in hy_rope_tables(cfg, grid))
        # valid joint lengths: img tokens + real text tokens
        if text_mask is not None:
            seqlens = img.shape[1] + text_mask.to(torch.int32).sum(dim=-1)
        else:
            seqlens = torch.full((b,), img.shape[1] + txt.shape[1],
                                 device=x.device)
        aux = dict(vec=vec, grid=grid, rope_cos=rope_cos, rope_sin=rope_sin,
                   txt_len=txt.shape[1], seqlens=seqlens.to(torch.int32))
        return img, txt, aux

    def trunk(self, img, txt, aux, carve: HYCarve | None = None,
              remat: bool = False, scan: bool = False):
        """Double + single block stack; img is curve-ordered in and out."""
        if remat or scan:
            raise NotImplementedError("remat/scan are JAX compile devices "
                                      "and are not ported")
        vec, seqlen = aux["vec"], aux["seqlens"]
        rope_cos, rope_sin = aux["rope_cos"], aux["rope_sin"]
        for blk in self.double_blocks:
            img, txt = blk(img, txt, vec, carve, rope_cos, rope_sin, seqlen)
        x = torch.cat([img, txt], dim=1)
        for blk in self.single_blocks:
            x = blk(x, vec, carve, rope_cos, rope_sin, aux["txt_len"],
                    seqlen)
        return x[:, :img.shape[1]]

    def head(self, img, aux, carve: HYCarve | None = None):
        """Inverse curve + modulated final layer + unpatchify (f32 out)."""
        cfg = self.cfg
        if carve is not None:
            img = img[:, carve.inverse_order]
        fl = self.final_layer
        m = fl.adaLN(L.silu(aux["vec"])).float()
        d = cfg.hidden_size
        out = L.modulate(L.layer_norm(img), shift=m[:, None, :d],
                         scale=m[:, None, d:])
        out = fl.linear(out)
        return L.unpatchify_3d(out.float(), aux["grid"], cfg.patch_size,
                               cfg.out_channels)

    def forward(self, x, t, text_states, text_mask=None, text_states_2=None,
                carve: HYCarve | None = None, guidance=None, mesh=None):
        """Velocity prediction. x [B, C, F, H, W]; text_states [B, L, 4096];
        text_states_2 [B, 768]."""
        if mesh is not None:
            raise NotImplementedError("sequence parallelism is not ported")
        if text_states_2 is None:
            text_states_2 = torch.zeros(
                (x.shape[0], self.cfg.text_states_dim_2), device=x.device)
        img, txt, aux = self.embed(x, t, text_states, text_mask,
                                   text_states_2, carve, guidance)
        img = self.trunk(img, txt, aux, carve)
        return self.head(img, aux, carve)


@torch.no_grad()
def init_hyvideo_(model: HYVideoDiT, generator: torch.Generator):
    """Random init on the model's device, distribution for distribution as
    ``jenga_tpu.models.hyvideo.init_hyvideo_params``: affine and norm
    layers as ``layers.init_affine_or_norm_``, q/k RMS-norm scales 1."""
    for mod in model.modules():
        if L.init_affine_or_norm_(mod, generator):
            continue
        if isinstance(mod, (DoubleBlock, SingleBlock)):
            for p in mod.parameters(recurse=False):
                p.fill_(1.0)   # the q/k RMS-norm scales
    return model

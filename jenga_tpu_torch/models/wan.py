"""Wan2.1 DiT as an ``nn.Module``, with first-class carving.

Port of ``jenga_tpu/models/wan.py``: a single-stream DiT (30 layers / dim
1536 / 12 heads for 1.3B) where every block runs self-attention over
curve-ordered video tokens (carved block-sparse when ``sa_drop_rate >
0.25``, dense otherwise), dense cross-attention over the 512 text tokens,
and a GELU MLP, all modulated by a 6-chunk f32 time embedding. The
``embed`` / ``trunk`` / ``head`` split is kept because the TeaCache skip
residual lives on the trunk, in curve order.

Parity points with the JAX package: q/k RMS norms run over the full
``dim`` (HunyuanVideo's are per head); the dense self-attention fallback
attends the zero pad tokens of the last block (no ``kv_len``), while the
carved branch masks them through ``carve.seqlen``; cross-attention
attends all ``text_len`` keys of the zero-padded context; the head is
zero-initialised and emits Wan's (pt, ph, pw, c) feature order.

Parameter names follow the JAX pytree (``blocks.3.self_attn.q.w``), except
that the tree's ``head`` is the module ``head_layer`` (``head`` is the
method); ``convert.wan_params_from_jax`` gives the state dict.

Not ported (each raises ``NotImplementedError``): the I2V inputs
(``clip_fea``, ``y``, image tokens), the sequence-parallel ``mesh``,
``sel_mask`` selection replay, and ``remat``.
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

__all__ = ["WanConfig", "WanCarve", "WanDiT", "make_wan_carve",
           "wan_rope_tables", "init_wan_", "WAN_T2V_1_3B", "WAN_T2V_14B"]

_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


@dataclasses.dataclass(frozen=True)
class WanConfig:
    """Architecture hyperparameters (same fields as the JAX config)."""
    model_type: str = "t2v"
    patch_size: tuple[int, int, int] = (1, 2, 2)
    text_len: int = 512
    in_dim: int = 16
    dim: int = 2048
    ffn_dim: int = 8192
    freq_dim: int = 256
    text_dim: int = 4096
    out_dim: int = 16
    num_heads: int = 16
    num_layers: int = 32
    qk_norm: bool = True
    cross_attn_norm: bool = True
    eps: float = 1e-6
    dtype: str = "bfloat16"

    @property
    def head_dim(self) -> int:
        return self.dim // self.num_heads

    @property
    def rope_dims(self) -> tuple[int, int, int]:
        # real sub-dims per (t, h, w) axis: c - 2*(c//3), c//3, c//3 complex
        # pairs with c = head_dim // 2
        c = self.head_dim // 2
        return (2 * (c - 2 * (c // 3)), 2 * (c // 3), 2 * (c // 3))

    @property
    def torch_dtype(self) -> torch.dtype:
        return _DTYPES[self.dtype]


WAN_T2V_1_3B = WanConfig(dim=1536, ffn_dim=8960, num_heads=12, num_layers=30)
WAN_T2V_14B = WanConfig(dim=5120, ffn_dim=13824, num_heads=40, num_layers=40)


@dataclasses.dataclass(frozen=True)
class WanCarve:
    """Carving spec for one resolution stage: curve order over the real
    tokens, curve-permuted RoPE tables padded to a block multiple (identity
    rotations on the pad), block adjacency, and the selection scalars."""
    curve_order: torch.Tensor       # [S] int64
    inverse_order: torch.Tensor     # [S] int64
    block_neighbors: torch.Tensor   # [nb, nb] bool
    rope_cos: torch.Tensor          # [S_pad, head_dim//2] f32, curve order
    rope_sin: torch.Tensor
    sa_drop_rate: float
    p_remain: float
    first_frame_blocks: int
    seqlen: int                     # real (unpadded) token count
    q_rows: int = 1
    joint_sel: bool = False
    sel_mask: object = None         # selection replay: not ported


def wan_rope_tables(cfg: WanConfig, grid, order=None, pad_to=None):
    """3-D RoPE tables at theta 1e4 (numpy f32, built in f64), optionally
    curve-permuted and padded with identity rotations to ``pad_to`` rows."""
    cos, sin = L.rope_table_3d(grid, cfg.rope_dims, theta=10000.0,
                               order=order)
    if pad_to is not None and pad_to > cos.shape[0]:
        pad = pad_to - cos.shape[0]
        cos = np.concatenate([cos, np.ones((pad, cos.shape[1]), np.float32)])
        sin = np.concatenate([sin, np.zeros((pad, sin.shape[1]), np.float32)])
    return cos, sin


def make_wan_carve(cfg: WanConfig, grid, sa_drop_rate: float,
                   p_remain: float, curve: str = "sliced", q_rows: int = 1,
                   joint_sel: bool = False, device="cpu") -> WanCarve:
    """Carving spec for a (t, h, w) token grid from ``build_curve_plan``
    (the port's copy of the JAX package's). ``first_frame_blocks =
    num_blocks // 21`` keeps the first-frame blocks mutually visible."""
    if q_rows > 8 and not joint_sel:
        raise ValueError(f"q_rows={q_rows} requires joint selection")
    plan = build_curve_plan(tuple(grid), curve, 128)
    s = plan.seq_len
    s_pad = -(-s // 128) * 128
    cos, sin = wan_rope_tables(cfg, plan.grid, order=plan.curve_order,
                               pad_to=s_pad)

    def dev(a, dtype):
        return torch.as_tensor(np.asarray(a), dtype=dtype, device=device)

    return WanCarve(curve_order=dev(plan.curve_order, torch.int64),
                    inverse_order=dev(plan.linear_to_curve, torch.int64),
                    block_neighbors=dev(plan.block_neighbors, torch.bool),
                    rope_cos=dev(cos, torch.float32),
                    rope_sin=dev(sin, torch.float32),
                    sa_drop_rate=float(sa_drop_rate),
                    p_remain=float(p_remain),
                    first_frame_blocks=(s_pad // 128) // 21, seqlen=s,
                    q_rows=int(q_rows), joint_sel=bool(joint_sel))


# --------------------------------------------------------------- modules


class WanAttention(nn.Module):
    """q/k/v/o projections with full-``dim`` q/k RMS-norm scales."""

    def __init__(self, cfg: WanConfig, device):
        super().__init__()
        d, dt = cfg.dim, cfg.torch_dtype
        self.q = L.Affine(d, d, dt, device)
        self.k = L.Affine(d, d, dt, device)
        self.v = L.Affine(d, d, dt, device)
        self.o = L.Affine(d, d, dt, device)
        self.norm_q = L.param((d,), torch.float32, device)
        self.norm_k = L.param((d,), torch.float32, device)


def _self_attention(p: WanAttention, x, cfg: WanConfig,
                    carve: WanCarve | None, rope_cos, rope_sin, top_k=None):
    """Carved (or dense-fallback) self-attention over curve-ordered tokens.
    ``top_k`` overrides the drop rate's selection floor (warm-up steps)."""
    b, s, d = x.shape
    n, hd = cfg.num_heads, cfg.head_dim
    q = L.rms_norm(p.q(x), p.norm_q, cfg.eps).reshape(b, s, n, hd)
    k = L.rms_norm(p.k(x), p.norm_k, cfg.eps).reshape(b, s, n, hd)
    v = p.v(x).reshape(b, s, n, hd)
    q = L.apply_rope(q, rope_cos, rope_sin)
    k = L.apply_rope(k, rope_cos, rope_sin)

    if carve is not None and carve.sel_mask is not None:
        raise NotImplementedError("WanCarve.sel_mask selection replay is "
                                  "not ported")
    if carve is None or carve.sa_drop_rate <= 0.25:
        # no kv_len: the pad tokens of the last block are attended
        out = attention_bshd(q, k, v)
    else:
        qt, kt, vt = (x_.transpose(1, 2) for x_ in (q, k, v))
        num_blocks = s // 128
        if top_k is None:
            top_k = int(num_blocks * (1.0 - carve.sa_drop_rate))
        qr = max(1, int(carve.q_rows))
        joint = qr > 1 and carve.joint_sel
        mask = build_block_mask(
            qt, kt, top_k=top_k, p_remain=carve.p_remain,
            text_start_block=num_blocks, text_blocks=0,
            block_neighbors=carve.block_neighbors,
            first_frame_blocks=carve.first_frame_blocks,
            sel_group=qr if joint else 1)
        out = sparse_attention_from_mask(
            qt, kt, vt, mask, seqlens=carve.seqlen,
            text_start_block=num_blocks, q_rows=qr,
            joint=joint).transpose(1, 2)
    return p.o(out.reshape(b, s, d))


def _cross_attention(p: WanAttention, x, context, cfg: WanConfig):
    """Dense cross-attention over every key of the padded text context."""
    b, s, d = x.shape
    n, hd = cfg.num_heads, cfg.head_dim
    q = L.rms_norm(p.q(x), p.norm_q, cfg.eps).reshape(b, s, n, hd)
    k = L.rms_norm(p.k(context), p.norm_k, cfg.eps).reshape(b, -1, n, hd)
    v = p.v(context).reshape(b, -1, n, hd)
    return p.o(attention_bshd(q, k, v).reshape(b, s, d))


def _gated(x, y, gate):
    return (x.float() + y.float() * gate).to(x.dtype)


class WanBlock(nn.Module):
    """WanAttentionBlock: 6-way modulation, self-attention, cross-attention,
    GELU MLP."""

    def __init__(self, cfg: WanConfig, device):
        super().__init__()
        d, dt = cfg.dim, cfg.torch_dtype
        self.cfg = cfg
        self.self_attn = WanAttention(cfg, device)
        self.cross_attn = WanAttention(cfg, device)
        self.norm3 = L.Norm(d, device)
        self.ffn = L.MLP(d, cfg.ffn_dim, d, dt, device)
        self.modulation = L.param((6, d), torch.float32, device)

    def forward(self, x, e6, context, carve, rope_cos, rope_sin, top_k=None):
        cfg = self.cfg
        e = self.modulation[None].float() + e6            # [B, 6, d] f32
        e0, e1, e2, e3, e4, e5 = (e[:, i:i + 1] for i in range(6))
        y = L.modulate(L.layer_norm(x, eps=cfg.eps), shift=e0, scale=e1)
        y = _self_attention(self.self_attn, y, cfg, carve, rope_cos,
                            rope_sin, top_k)
        x = _gated(x, y, e2)
        y = L.layer_norm(x, self.norm3.w, self.norm3.b, cfg.eps) \
            if cfg.cross_attn_norm else x
        x = x + _cross_attention(self.cross_attn, y, context, cfg)
        y = L.modulate(L.layer_norm(x, eps=cfg.eps), shift=e3, scale=e4)
        y = self.ffn.fc2(L.gelu_tanh(self.ffn.fc1(y)))
        return _gated(x, y, e5)


class WanHead(nn.Module):
    def __init__(self, cfg: WanConfig, device):
        super().__init__()
        self.linear = L.Affine(cfg.dim,
                               math.prod(cfg.patch_size) * cfg.out_dim,
                               cfg.torch_dtype, device, zero=True)
        self.modulation = L.param((2, cfg.dim), torch.float32, device)


class WanDiT(nn.Module):
    """The Wan2.1 T2V DiT. Parameters are allocated uninitialised on
    ``device``: load a converted state dict or call ``init_wan_``."""

    def __init__(self, cfg: WanConfig, device="cpu"):
        super().__init__()
        if cfg.model_type != "t2v":
            raise NotImplementedError("Wan I2V (clip_fea, y, k_img/v_img) is "
                                      "not ported")
        d, dt, f32 = cfg.dim, cfg.torch_dtype, torch.float32
        self.cfg = cfg
        self.patch_embedding = L.Affine(
            cfg.in_dim * math.prod(cfg.patch_size), d, dt, device)
        self.text_embedding = L.MLP(cfg.text_dim, d, d, dt, device)
        self.time_embedding = L.MLP(cfg.freq_dim, d, d, f32, device)
        self.time_projection = L.Affine(d, 6 * d, f32, device)
        self.blocks = nn.ModuleList(WanBlock(cfg, device)
                                    for _ in range(cfg.num_layers))
        self.head_layer = WanHead(cfg, device)

    @property
    def device(self):
        return self.patch_embedding.w.device

    def time_embed(self, t):
        """f32 time embedding ``e`` [B, dim] (also the TeaCache metric)."""
        temb = L.sinusoidal_embedding(self.cfg.freq_dim, t,
                                      flip_sin_cos=True)
        te = self.time_embedding
        return te.fc2(L.silu(te.fc1(temb))).float()

    def embed(self, x, t, context, carve: WanCarve | None = None,
              clip_fea=None, y=None):
        """Patchify, curve reorder (zero pad to a block multiple), time and
        text embeddings. Returns ``(h0, aux)``."""
        if clip_fea is not None or y is not None:
            raise NotImplementedError("Wan I2V inputs (clip_fea, y) are not "
                                      "ported")
        cfg = self.cfg
        h, grid = L.patchify_3d(self.patch_embedding,
                                x.to(cfg.torch_dtype), cfg.patch_size)
        b, s, d = h.shape
        e = self.time_embed(t)
        e6 = self.time_projection(L.silu(e)).reshape(b, 6, d).float()
        te = self.text_embedding
        ctx = te.fc2(L.gelu_tanh(te.fc1(context.to(cfg.torch_dtype))))
        if carve is not None:
            h = h[:, carve.curve_order]
            s_pad = -(-s // 128) * 128
            h = torch.nn.functional.pad(h, (0, 0, 0, s_pad - s))
        aux = dict(e=e, e6=e6, ctx=ctx, grid=grid, seq=s)
        return h, aux

    def trunk(self, h, aux, carve: WanCarve | None = None, top_k=None,
              mesh=None, remat: bool = False):
        """The block stack over curve-ordered hidden states (the TeaCache
        residual ``h_out - h_in`` lives in this space)."""
        if mesh is not None:
            raise NotImplementedError("sequence parallelism is not ported")
        if remat:
            raise NotImplementedError("remat is a JAX training device and is "
                                      "not ported")
        if carve is not None:
            rope_cos, rope_sin = carve.rope_cos, carve.rope_sin
        else:
            rope_cos, rope_sin = (torch.as_tensor(a, device=h.device)
                                  for a in wan_rope_tables(self.cfg,
                                                           aux["grid"]))
        for blk in self.blocks:
            h = blk(h, aux["e6"], aux["ctx"], carve, rope_cos, rope_sin,
                    top_k)
        return h

    def head(self, h, aux, carve: WanCarve | None = None):
        """Inverse curve order (dropping the pad), modulated zero-init head,
        unpatchify in Wan's feature order (f32 out)."""
        cfg = self.cfg
        if carve is not None:
            h = h[:, carve.inverse_order]
        hl = self.head_layer
        hm = hl.modulation[None].float() + aux["e"][:, None, :]
        out = L.modulate(L.layer_norm(h, eps=cfg.eps), shift=hm[:, 0:1],
                         scale=hm[:, 1:2])
        out = hl.linear(out)
        return L.unpatchify_3d(out.float(), aux["grid"], cfg.patch_size,
                               cfg.out_dim, channel_last=True)

    def forward(self, x, t, context, carve: WanCarve | None = None,
                clip_fea=None, y=None, top_k=None, mesh=None,
                remat: bool = False):
        """Velocity prediction. x [B, C, F, H, W]; t [B]; context
        [B, text_len, text_dim] padded text embeddings. f32 out."""
        h, aux = self.embed(x, t, context, carve, clip_fea, y)
        h = self.trunk(h, aux, carve, top_k, mesh, remat)
        return self.head(h, aux, carve)


@torch.no_grad()
def init_wan_(model: WanDiT, generator: torch.Generator):
    """Random init on the model's device, distribution for distribution as
    ``jenga_tpu.models.wan.init_wan_params``: affine and norm layers as
    ``layers.init_affine_or_norm_`` (the head linear zero), q/k RMS-norm
    scales 1, modulation tables N(0, 1) / sqrt(dim)."""
    d = model.cfg.dim
    for mod in model.modules():
        if L.init_affine_or_norm_(mod, generator):
            continue
        if isinstance(mod, WanAttention):
            mod.norm_q.fill_(1.0)
            mod.norm_k.fill_(1.0)
        elif isinstance(mod, (WanBlock, WanHead)):
            mod.modulation.normal_(generator=generator).div_(d ** 0.5)
    return model

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

Image-to-video (``model_type="i2v"``, ``WAN_I2V_14B``): the conditioning
``y`` (a 4-channel first-frame mask and the image latent) joins the
latents on the channel axis (``in_dim`` 36); the CLIP image tokens go
through ``img_emb`` (LayerNorm, fc1, tanh GELU, fc2, LayerNorm) and sit
ahead of the text context, and each block's cross-attention adds a second
dense attention over those ``image_tokens`` keys (``k_img``, ``v_img``,
``norm_k_img``) to the one over the text keys.

Training: ``trunk(remat=True)`` runs each block under
``torch.utils.checkpoint`` (its activations are recomputed in the
backward), and the carved self-attention is differentiable
(``ops/sparse_dispatch``). ``WanCarve.sel_mask`` replays a recorded
selection [B, H, nb, nb] in every layer instead of the planner, with the
JAX package's guards: on the dense fallback it raises, and a mask of
another grid fails its shape check.

``wan_first_selection_mask`` gives the first block's planner mask without
running attention, through the same q/k and planner code as the forward:
the selection density a run realizes.

Sequence parallelism (``mesh=``, ``parallel/``): the tokens are sliced
over the ``sp`` axis alone and copied over any other (``ring``, ``dp``),
as in the JAX package. ``embed`` keeps this rank's slice of the
curve-ordered, 128-padded tokens, each layer's self-attention runs under
Ulysses with full-sequence RoPE tables (carved only when
``sa_drop_rate > 0.25``, as on one device), or as dense ring attention
over ``sp`` when the heads do not divide it (a carved layer then raises
``ValueError``, as in the JAX package). Cross-attention needs no
collective: each rank's queries attend the whole context. ``head``
gathers the slices first, so the TeaCache residual lives in the sliced
space.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch
from torch import nn

from .. import obs
from ..curves.blocks import build_curve_plan
from ..ops.flash_attention import attention_bshd
from ..ops.sparse_dispatch import sparse_attention_from_mask
from ..parallel.mesh import (gather_tokens, mesh_dims, shard_tokens,
                             token_mesh, token_range, ulysses_fits)
from ..parallel.ring import ring_attention
from ..parallel.ulysses import ulysses_self_attention
from ..sparse.planner import build_block_mask
from . import layers as L

__all__ = ["WanConfig", "WanCarve", "WanDiT", "make_wan_carve",
           "wan_rope_tables", "init_wan_", "WAN_T2V_1_3B", "WAN_T2V_14B",
           "WAN_I2V_14B", "CLIP_DIM", "wan_first_selection_mask"]

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
WAN_I2V_14B = dataclasses.replace(WAN_T2V_14B, model_type="i2v", in_dim=36)
CLIP_DIM = 1280     # width of the CLIP ViT-H image tokens (clip_fea)


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
    sel_mask: object = None         # [B, H, nb, nb] bool: replayed, not
                                    # planned (same q_rows / joint_sel)


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
    """q/k/v/o projections with full-``dim`` q/k RMS-norm scales; with
    ``image`` (I2V cross-attention) also the image keys' ``k_img``,
    ``v_img`` and ``norm_k_img``."""

    def __init__(self, cfg: WanConfig, device, image: bool = False):
        super().__init__()
        d, dt = cfg.dim, cfg.torch_dtype
        self.q = L.Affine(d, d, dt, device)
        self.k = L.Affine(d, d, dt, device)
        self.v = L.Affine(d, d, dt, device)
        self.o = L.Affine(d, d, dt, device)
        self.norm_q = L.param((d,), torch.float32, device)
        self.norm_k = L.param((d,), torch.float32, device)
        if image:
            self.k_img = L.Affine(d, d, dt, device)
            self.v_img = L.Affine(d, d, dt, device)
            self.norm_k_img = L.param((d,), torch.float32, device)


class ImageEmbedding(nn.Module):
    """CLIP image tokens to the model width: LayerNorm, fc1, GELU (tanh),
    fc2, LayerNorm."""

    def __init__(self, cfg: WanConfig, device):
        super().__init__()
        dt = cfg.torch_dtype
        self.norm_in = L.Norm(CLIP_DIM, device)
        self.fc1 = L.Affine(CLIP_DIM, CLIP_DIM, dt, device)
        self.fc2 = L.Affine(CLIP_DIM, cfg.dim, dt, device)
        self.norm_out = L.Norm(cfg.dim, device)

    def forward(self, clip_fea):
        x = L.layer_norm(clip_fea.float(), self.norm_in.w, self.norm_in.b)
        # the JAX package's jax.nn.gelu, whose default is the tanh form
        x = self.fc2(L.gelu_tanh(self.fc1(x.to(self.fc1.dtype))))
        return L.layer_norm(x, self.norm_out.w, self.norm_out.b)


def _token_mesh(mesh):
    """Wan's tokens are sliced over ``sp`` and copied over ``ring``."""
    return token_mesh(mesh, ("sp",))


def _sp_attention(q, k, v, cfg: WanConfig, carve: WanCarve | None,
                  rope_cos, rope_sin, top_k, mesh, length: int):
    """Self-attention of this rank's token slice (of ``length`` tokens) on
    the ``("sp",)`` token mesh: Ulysses when the heads divide it, else
    dense ring attention."""
    if carve is not None and carve.sel_mask is not None:
        raise NotImplementedError(
            "WanCarve.sel_mask (selection replay) is single-device only — "
            "the sequence-parallel paths have no planner-bypass plumbing")
    n = cfg.num_heads
    sparse = carve is not None and carve.sa_drop_rate > 0.25
    if ulysses_fits(n, mesh):
        kw = dict(sparse=False)
        if sparse:
            if top_k is None:
                top_k = int(length // 128 * (1.0 - carve.sa_drop_rate))
            kw = dict(sparse=True, block_neighbors=carve.block_neighbors,
                      top_k=top_k, p_remain=carve.p_remain,
                      seqlen=carve.seqlen,
                      first_frame_blocks=carve.first_frame_blocks,
                      q_rows=carve.q_rows, joint_sel=carve.joint_sel)
        return ulysses_self_attention(q, k, v, rope_cos, rope_sin, mesh,
                                      length=length, **kw)
    nu = mesh_dims(mesh)[2]
    if sparse and n % nu:
        raise ValueError(
            f"carved attention requires num_heads ({n}) divisible by the "
            f"sp mesh ({nu}) — the planner needs the full sequence per "
            f"device (Ulysses); use more heads or a smaller mesh, or "
            f"disable carving for ring attention")
    start, stop = token_range(length, mesh)
    q = L.apply_rope(q, rope_cos[start:stop], rope_sin[start:stop])
    k = L.apply_rope(k, rope_cos[start:stop], rope_sin[start:stop])
    return ring_attention(q, k, v, mesh, length=length)


def _self_qkv(p: WanAttention, x, cfg: WanConfig, rope_cos=None,
              rope_sin=None):
    """The self-attention's q, k, v [B, S, H, D] from its input x: q and
    k RMS-normed over ``dim``, then rotated when the RoPE tables are
    given. Shared by ``_self_attention`` and
    ``wan_first_selection_mask``."""
    b, s, d = x.shape
    n, hd = cfg.num_heads, cfg.head_dim
    if rope_cos is None:
        q = L.norm_modulate(p.q(x), p.norm_q, eps=cfg.eps, rms=True)
        k = L.norm_modulate(p.k(x), p.norm_k, eps=cfg.eps, rms=True)
    else:
        q = L.rms_norm_rope(p.q(x), p.norm_q, rope_cos, rope_sin, cfg.eps)
        k = L.rms_norm_rope(p.k(x), p.norm_k, rope_cos, rope_sin, cfg.eps)
    v = p.v(x).reshape(b, s, n, hd)
    return q.reshape(b, s, n, hd), k.reshape(b, s, n, hd), v


@obs.spanned("planner")
def _self_mask(qt, kt, carve: WanCarve, top_k=None):
    """The planner's selection [B, H, nb, nb] bool over [B, H, S_pad, D]
    q and k: the top ``top_k`` blocks (by default ``(1 - sa_drop_rate)``
    of them), the top-p rest, the curve neighbours and the first-frame
    blocks, per group of ``q_rows`` query blocks under joint selection."""
    num_blocks = qt.shape[2] // 128
    if top_k is None:
        top_k = int(num_blocks * (1.0 - carve.sa_drop_rate))
    qr = max(1, int(carve.q_rows))
    joint = qr > 1 and carve.joint_sel
    return build_block_mask(
        qt, kt, top_k=top_k, p_remain=carve.p_remain,
        text_start_block=num_blocks, text_blocks=0,
        block_neighbors=carve.block_neighbors,
        first_frame_blocks=carve.first_frame_blocks,
        sel_group=qr if joint else 1)


def _self_attention(p: WanAttention, x, cfg: WanConfig,
                    carve: WanCarve | None, rope_cos, rope_sin, top_k=None,
                    mesh=None, length: int | None = None):
    """Carved (or dense-fallback) self-attention over curve-ordered tokens.
    ``top_k`` overrides the drop rate's selection floor (warm-up steps).
    On a ``mesh``, x is this rank's slice of ``length`` tokens and the
    RoPE tables cover all of them (``_sp_attention``)."""
    b, s, d = x.shape
    n = cfg.num_heads
    if mesh is not None:
        q, k, v = _self_qkv(p, x, cfg)
        out = _sp_attention(q, k, v, cfg, carve, rope_cos, rope_sin, top_k,
                            mesh, length)
        return p.o(out.reshape(b, s, d))
    q, k, v = _self_qkv(p, x, cfg, rope_cos, rope_sin)

    if carve is None or carve.sa_drop_rate <= 0.25:
        if carve is not None and carve.sel_mask is not None:
            # a recorded selection must run on the sparse kernel, not be
            # silently dropped for dense attention
            raise ValueError(
                "WanCarve.sel_mask is set but sa_drop_rate "
                f"{carve.sa_drop_rate} <= 0.25 takes the dense fallback "
                "— the recorded selection would be silently ignored. "
                "Raise sa_drop_rate or clear sel_mask.")
        # no kv_len: the pad tokens of the last block are attended
        out = attention_bshd(q, k, v)
    else:
        qt, kt, vt = (x_.transpose(1, 2) for x_ in (q, k, v))
        num_blocks = s // 128
        qr = max(1, int(carve.q_rows))
        if carve.sel_mask is not None:
            # its layout depends on q_rows / joint_sel: replay it with the
            # ones it was recorded under
            mask = carve.sel_mask
            expect = (b, n, num_blocks, num_blocks)
            if tuple(mask.shape) != expect:
                raise ValueError(
                    f"WanCarve.sel_mask shape {tuple(mask.shape)} != "
                    f"{expect} expected for this stage (B, H, nqb, nkb) "
                    "— was it recorded on a different grid?")
        else:
            mask = _self_mask(qt, kt, carve, top_k)
        out = sparse_attention_from_mask(
            qt, kt, vt, mask, seqlens=carve.seqlen,
            text_start_block=num_blocks, q_rows=qr,
            joint=qr > 1 and carve.joint_sel).transpose(1, 2)
    with obs.span("layout"):
        # the transposes are views: their copy is made here (the carved
        # and the mainloop dense outputs) and in the kernels' wrappers
        out = out.reshape(b, s, d)
    return p.o(out)


def _cross_attention(p: WanAttention, x, context, cfg: WanConfig,
                     image_tokens: int = 0):
    """Dense cross-attention over every key of the padded text context;
    the first ``image_tokens`` context tokens (I2V) are the image keys, a
    second attention through ``k_img``/``v_img`` whose output adds to the
    text attention's."""
    b, s, d = x.shape
    n, hd = cfg.num_heads, cfg.head_dim
    q = L.norm_modulate(p.q(x), p.norm_q, eps=cfg.eps,
                        rms=True).reshape(b, s, n, hd)
    ctx_img, ctx = context[:, :image_tokens], context[:, image_tokens:]
    k = L.norm_modulate(p.k(ctx), p.norm_k, eps=cfg.eps,
                        rms=True).reshape(b, -1, n, hd)
    v = p.v(ctx).reshape(b, -1, n, hd)
    out = attention_bshd(q, k, v)
    if image_tokens:
        k_img = L.norm_modulate(p.k_img(ctx_img), p.norm_k_img, eps=cfg.eps,
                                rms=True).reshape(b, -1, n, hd)
        v_img = p.v_img(ctx_img).reshape(b, -1, n, hd)
        out = out + attention_bshd(q, k_img, v_img)
    return p.o(out.reshape(b, s, d))


class WanBlock(nn.Module):
    """WanAttentionBlock: 6-way modulation, self-attention, cross-attention,
    GELU MLP."""

    def __init__(self, cfg: WanConfig, device):
        super().__init__()
        d, dt = cfg.dim, cfg.torch_dtype
        self.cfg = cfg
        self.self_attn = WanAttention(cfg, device)
        self.cross_attn = WanAttention(cfg, device,
                                       image=cfg.model_type == "i2v")
        self.norm3 = L.Norm(d, device)
        self.ffn = L.MLP(d, cfg.ffn_dim, d, dt, device)
        self.modulation = L.param((6, d), torch.float32, device)

    def modulations(self, e6):
        """The six modulation chunks [B, 1, d] (f32) of time embedding
        ``e6``."""
        e = self.modulation[None].float() + e6            # [B, 6, d] f32
        return tuple(e[:, i:i + 1] for i in range(6))

    def self_attn_input(self, x, e0, e1):
        """The self-attention's input: x layer-normed and modulated."""
        return L.norm_modulate(x, shift=e0, scale=e1, eps=self.cfg.eps)

    @obs.spanned("block")
    def forward(self, x, e6, context, carve, rope_cos, rope_sin, top_k=None,
                image_tokens: int = 0, mesh=None, length=None):
        """On a ``mesh``, x is this rank's slice of ``length`` tokens."""
        cfg = self.cfg
        e0, e1, e2, e3, e4, e5 = self.modulations(e6)
        y = self.self_attn_input(x, e0, e1)
        y = _self_attention(self.self_attn, y, cfg, carve, rope_cos,
                            rope_sin, top_k, mesh, length)
        x = L.gated(x, y, e2)
        y = L.norm_modulate(x, self.norm3.w, self.norm3.b, eps=cfg.eps) \
            if cfg.cross_attn_norm else x
        x = x + _cross_attention(self.cross_attn, y, context, cfg,
                                 image_tokens)
        y = L.norm_modulate(x, shift=e3, scale=e4, eps=cfg.eps)
        y = self.ffn.fc2(L.gelu_tanh(self.ffn.fc1(y)))
        return L.gated(x, y, e5)


class WanHead(nn.Module):
    def __init__(self, cfg: WanConfig, device):
        super().__init__()
        self.linear = L.Affine(cfg.dim,
                               math.prod(cfg.patch_size) * cfg.out_dim,
                               cfg.torch_dtype, device, zero=True)
        self.modulation = L.param((2, cfg.dim), torch.float32, device)


class WanDiT(nn.Module):
    """The Wan2.1 DiT (T2V, or I2V with ``model_type="i2v"``). Parameters
    are allocated uninitialised on ``device``: load a converted state dict
    or call ``init_wan_``."""

    def __init__(self, cfg: WanConfig, device="cpu"):
        super().__init__()
        if cfg.model_type not in ("t2v", "i2v"):
            raise ValueError(f"model_type {cfg.model_type!r} is not t2v or "
                             f"i2v")
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
        if cfg.model_type == "i2v":
            self.img_emb = ImageEmbedding(cfg, device)

    @property
    def device(self):
        return next(self.parameters()).device

    def time_embed(self, t):
        """f32 time embedding ``e`` [B, dim] (also the TeaCache metric)."""
        temb = L.sinusoidal_embedding(self.cfg.freq_dim, t,
                                      flip_sin_cos=True)
        te = self.time_embedding
        return te.fc2(L.silu(te.fc1(temb))).float()

    @obs.spanned("embed")
    def embed(self, x, t, context, carve: WanCarve | None = None,
              clip_fea=None, y=None, mesh=None):
        """Patchify, curve reorder (zero pad to a block multiple), time and
        text embeddings. Returns ``(h0, aux)``. I2V: ``y`` [B, 20, F, H, W]
        joins ``x`` on the channel axis; ``clip_fea`` [B, 257, 1280]
        becomes the image tokens ahead of the text context. With a
        ``mesh``, h0 is this rank's slice of the (padded) tokens, and
        ``aux["seq_total"]`` their whole count."""
        cfg = self.cfg
        if y is not None:
            x = torch.cat([x, y], dim=1)
        h, grid = L.patchify_3d(self.patch_embedding,
                                x.to(cfg.torch_dtype), cfg.patch_size)
        b, s, d = h.shape
        e = self.time_embed(t)
        e6 = self.time_projection(L.silu(e)).reshape(b, 6, d).float()
        te = self.text_embedding
        ctx = te.fc2(L.gelu_tanh(te.fc1(context.to(cfg.torch_dtype))))
        image_tokens = 0
        if clip_fea is not None:
            img = self.img_emb(clip_fea).to(cfg.torch_dtype)
            ctx = torch.cat([img, ctx], dim=1)
            image_tokens = clip_fea.shape[1]
        if carve is not None:
            with obs.span("layout"):
                h = h[:, carve.curve_order]
                s_pad = -(-s // 128) * 128
                h = torch.nn.functional.pad(h, (0, 0, 0, s_pad - s))
        aux = dict(e=e, e6=e6, ctx=ctx, grid=grid, seq=s,
                   image_tokens=image_tokens, seq_total=h.shape[1])
        if mesh is not None:
            h = shard_tokens(h, _token_mesh(mesh))
        return h, aux

    @obs.spanned("trunk")
    def trunk(self, h, aux, carve: WanCarve | None = None, top_k=None,
              mesh=None, remat: bool = False):
        """The block stack over curve-ordered hidden states (the TeaCache
        residual ``h_out - h_in`` lives in this space; on a ``mesh``, in
        this rank's slice of it). ``remat`` checkpoints each block: the
        backward recomputes its forward (kernels included) instead of
        keeping its activations."""
        if mesh is not None:
            mesh = _token_mesh(mesh)
        if carve is not None:
            rope_cos, rope_sin = carve.rope_cos, carve.rope_sin
        else:
            rope_cos, rope_sin = (torch.as_tensor(a, device=h.device)
                                  for a in wan_rope_tables(self.cfg,
                                                           aux["grid"]))
        for blk in self.blocks:
            args = (h, aux["e6"], aux["ctx"], carve, rope_cos, rope_sin,
                    top_k, aux["image_tokens"], mesh, aux["seq_total"])
            h = L.remat_call(blk, *args) if remat else blk(*args)
        return h

    @obs.spanned("head")
    def head(self, h, aux, carve: WanCarve | None = None, mesh=None):
        """Inverse curve order (dropping the pad), modulated zero-init head,
        unpatchify in Wan's feature order (f32 out). On a ``mesh`` the
        ranks' slices are gathered first."""
        cfg = self.cfg
        if mesh is not None:
            h = gather_tokens(h, _token_mesh(mesh), aux["seq_total"])
        if carve is not None:
            with obs.span("layout"):
                h = h[:, carve.inverse_order]
        hl = self.head_layer
        hm = hl.modulation[None].float() + aux["e"][:, None, :]
        out = L.norm_modulate(h, shift=hm[:, 0:1], scale=hm[:, 1:2],
                              eps=cfg.eps)
        out = hl.linear(out)
        return L.unpatchify_3d(out.float(), aux["grid"], cfg.patch_size,
                               cfg.out_dim, channel_last=True)

    def forward(self, x, t, context, carve: WanCarve | None = None,
                clip_fea=None, y=None, top_k=None, mesh=None,
                remat: bool = False):
        """Velocity prediction. x [B, C, F, H, W]; t [B]; context
        [B, text_len, text_dim] padded text embeddings; I2V: ``clip_fea``
        and ``y`` (see ``embed``); ``mesh`` (``parallel.make_sp_mesh``)
        slices the tokens over its ``sp`` ranks. f32 out."""
        h, aux = self.embed(x, t, context, carve, clip_fea, y, mesh)
        h = self.trunk(h, aux, carve, top_k, mesh, remat)
        return self.head(h, aux, carve, mesh)


def wan_first_selection_mask(model: WanDiT, x, t, context,
                             carve: WanCarve, top_k=None):
    """Diagnostic: the carving planner's selection mask for the FIRST
    block, [B, H, nb, nb] bool, with no attention run. q and k come from
    the block's own ``modulations``, ``self_attn_input`` and
    ``_self_qkv``, the mask from the forward's ``_self_mask``, so it is
    the mask a carved forward's first block plans on the same inputs
    (there ``sa_drop_rate > 0.25``). ``top_k`` defaults to ``(1 -
    sa_drop_rate)`` of the blocks; ``carve.sel_mask`` is not consulted.
    Port of ``jenga_tpu.models.wan.wan_first_selection_mask``."""
    h, aux = model.embed(x, t, context, carve)
    blk = model.blocks[0]
    e = blk.modulations(aux["e6"])
    q, k, _ = _self_qkv(blk.self_attn, blk.self_attn_input(h, e[0], e[1]),
                        model.cfg, carve.rope_cos, carve.rope_sin)
    return _self_mask(q.transpose(1, 2), k.transpose(1, 2), carve, top_k)


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
            if hasattr(mod, "norm_k_img"):
                mod.norm_k_img.fill_(1.0)
        elif isinstance(mod, (WanBlock, WanHead)):
            mod.modulation.normal_(generator=generator).div_(d ** 0.5)
    return model

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

Image-to-video: with ``i2v_condition_type="token_replace"`` the first
frame's tokens take the modulation of timestep 0 (shift, scale and gate,
in every block), through a mask over the curve-ordered image tokens; the
latent_concat conditioning needs only the 33 input channels
(``hy_i2v_config``).

Training: ``trunk(remat=True)`` (and ``forward(remat=True)``, so that a
LoRA step can run the model under ``torch.func.functional_call``) runs
each double and single block under ``torch.utils.checkpoint``, and the
carved joint attention is differentiable (``ops/sparse_dispatch``).
``HYCarve.sel_mask`` replays a recorded selection [B, H, nb, nb] (text
rows included) in every block instead of the planner, with the JAX
package's guards: on any non-carved call it raises, and a mask of another
grid fails its shape check.

``hy_first_selection_mask`` gives the first double block's planner mask
(video query rows) without running attention, through the same q/k and
planner code as the forward: the selection density a run realizes.

Sequence parallelism (``mesh=``, ``parallel/``): ``embed`` keeps this
rank's slice of the curve-ordered image tokens (with their RoPE rows and
token-replace mask; sliced over ``ring`` x ``sp``, copied over any other
axis such as ``dp``), the text stream stays whole on every rank, every
block's joint attention runs under Ulysses (carved, or dense D), or, when
the heads do not divide the ``sp`` axis or the mesh has a ``ring`` axis,
as dense ring (x Ulysses) attention after the carving-disabled warning,
and ``head`` gathers the slices first. ``sel_mask`` on a mesh raises, as
in the JAX package.

Not ported (raises ``NotImplementedError``): ``scan`` (a ``lax.scan``
over stacked block parameters, a compile device of XLA's; torch runs the
stack eagerly).
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
from ..parallel.mesh import (gather_tokens, token_mesh, token_range,
                             ulysses_fits, warn_carving_disabled)
from ..parallel.ring import ring_attention, ring_ulysses_attention
from ..parallel.ulysses import ulysses_joint_attention
from ..sparse.planner import build_block_mask
from . import layers as L

__all__ = ["HYVideoConfig", "HYCarve", "HYVideoDiT", "make_hy_carve",
           "hy_rope_tables", "hy_i2v_config", "HUNYUAN_VIDEO_T2V",
           "init_hyvideo_", "hy_first_selection_mask"]

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


def hy_i2v_config(condition_type: str,
                  base: HYVideoConfig = HUNYUAN_VIDEO_T2V) -> HYVideoConfig:
    """The I2V model for a condition type: ``token_replace`` takes the 16
    latent channels and the t=0 modulation of the first frame;
    ``latent_concat`` takes 33 channels (latents, image latent, first-frame
    mask) and no token replacement. The JAX package's
    ``HUNYUAN_VIDEO_I2V`` pairs 33 channels with token_replace, which its
    own pipeline cannot run (it feeds 16 channels under token_replace)."""
    if condition_type == "token_replace":
        return dataclasses.replace(base, in_channels=16,
                                   i2v_condition_type="token_replace")
    if condition_type == "latent_concat":
        return dataclasses.replace(base, in_channels=33,
                                   i2v_condition_type=None)
    raise ValueError(f"i2v condition type {condition_type!r} is not "
                     f"token_replace or latent_concat")


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
    sel_mask: object = None         # [B, H, nb, nb] bool: replayed, not
                                    # planned (same q_rows / joint_sel)


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


def _mod_tr(x, shift, scale, tr, which):
    """Layer-norm and modulate; under token replacement (the plain chain)
    the first-frame tokens (``tr``'s mask) take the t=0 (shift, scale)
    pair ``tr[which]``."""
    if tr is None:
        return L.norm_modulate(x, shift=shift, scale=scale)
    return L.norm_modulate_tokens(x, shift, scale, tr["mask"], *tr[which])


def _gate_tr(x, y, gate, tr, which):
    """Gated residual add; under token replacement the first-frame tokens
    take the t=0 gate ``tr[which]``: a gate per token, which the kernel
    does not take."""
    g = gate.float()
    if tr is not None:
        g = torch.where(tr["mask"][None, :, None], tr[which].float(), g)
    return L.gated(x, y, g)


def _tr_chunks(mod: L.Affine, tr_vec, n: int):
    """The t=0 modulation of one block, as n chunks [B, 1, d] (f32)."""
    return mod(L.silu(tr_vec)).float()[:, None].chunk(n, dim=-1)


def _carves(carve: HYCarve | None, s: int) -> bool:
    """Whether a joint sequence of ``s`` tokens takes the carved path: a
    drop rate, and a video block left before the text blocks."""
    return not (carve is None or carve.sa_drop_rate == 0.0
                or -(-s // 128) <= carve.txt_block_num)


def _joint_attention_sp(q, k, v, carve: HYCarve | None, img_len: int,
                        seqlen, mesh, img_total: int):
    """``_joint_attention`` on a mesh: q/k/v are [this rank's image slice
    (``img_len`` of ``img_total`` tokens) | the whole text]; the output
    has the same rows, the text rows identical on every rank."""
    b, s, n, hd = q.shape
    if carve is not None and carve.sel_mask is not None:
        raise NotImplementedError(
            "HYCarve.sel_mask (selection replay) is single-device only — "
            "the sequence-parallel paths have no planner-bypass plumbing")
    st = s - img_len
    img = (q[:, :img_len], k[:, :img_len], v[:, :img_len])
    txt = (q[:, img_len:], k[:, img_len:], v[:, img_len:])
    if ulysses_fits(n, mesh):
        kw = dict(sparse=False, seqlen=seqlen)
        if _carves(carve, img_total + st):
            nb = -(-(img_total + st) // 128)
            kw.update(sparse=True, block_neighbors=carve.block_neighbors,
                      top_k=int((1.0 - carve.sa_drop_rate)
                                * (img_total // 128)),
                      p_remain=carve.p_remain,
                      text_start_block=nb - carve.txt_block_num,
                      text_blocks=carve.txt_block_num,
                      text_amp=carve.text_amp, q_rows=carve.q_rows,
                      joint_sel=carve.joint_sel)
        img_out, txt_out = ulysses_joint_attention(
            *img, *txt, mesh, length=img_total, **kw)
    else:
        # dense ring (x Ulysses on a ring axis) over the image tokens with
        # the text K|V folded in last; the text query rows attend every
        # key, so the image K|V is gathered for them once
        ring = ring_ulysses_attention if "ring" in mesh.mesh_dim_names \
            else ring_attention
        img_out = ring(
            *img, mesh, joint_k=txt[1], joint_v=txt[2],
            joint_kv_len=seqlen - img_total, length=img_total)
        kv = gather_tokens(torch.cat(img[1:], dim=-1), mesh, img_total)
        txt_out = attention_bshd(
            txt[0], torch.cat([kv[..., :hd], txt[1]], dim=1),
            torch.cat([kv[..., hd:], txt[2]], dim=1), kv_len=seqlen)
    return torch.cat([img_out, txt_out], dim=1).reshape(b, s, n * hd)


@obs.spanned("layout")
def _cat(xs, dim: int):
    """``torch.cat``, a copy of the layout."""
    return torch.cat(xs, dim=dim)


@obs.spanned("layout")
def _to_blocks(x, s_pad: int):
    """[B, S, H, D] -> [B, H, s_pad, D] with zero rows past S."""
    return torch.nn.functional.pad(
        x, (0, 0, 0, 0, 0, s_pad - x.shape[1])).transpose(1, 2)


def _video_mask(qt, kt, carve: HYCarve, img_len: int, top_k=None):
    """The planner's selection for the video query rows of a carved joint
    sequence, [B, H, tsb, nkb] bool, from the padded [B, H, S_pad, D] q
    and k: the top ``top_k`` (by default ``(1 - sa_drop_rate)`` of the
    ``img_len`` video tokens' blocks) plus the top-p rest, the text
    blocks and the curve neighbours, per group of ``q_rows`` query blocks
    under joint selection."""
    num_blocks = qt.shape[2] // 128
    tsb = num_blocks - carve.txt_block_num
    if top_k is None:
        top_k = int((1.0 - carve.sa_drop_rate) * (img_len // 128))
    qr = max(1, int(carve.q_rows))
    joint = qr > 1 and carve.joint_sel
    return build_block_mask(
        qt[:, :, :tsb * 128], kt, top_k=top_k, p_remain=carve.p_remain,
        text_start_block=tsb, text_blocks=carve.txt_block_num,
        block_neighbors=carve.block_neighbors,
        sel_group=qr if joint else 1)


def _joint_attention(q, k, v, carve: HYCarve | None, img_len: int, seqlen,
                     mesh=None, img_total: int | None = None):
    """Joint img+txt attention: sparse video rows and dense text rows in
    one kernel launch; dense fallback when there is no carving or the
    sequence is too short to leave a video block before the text blocks.
    q/k/v [B, S, H, D] -> [B, S, H*D]. On a mesh, ``_joint_attention_sp``
    (``img_len`` is this rank's slice of ``img_total`` image tokens)."""
    if mesh is not None:
        return _joint_attention_sp(q, k, v, carve, img_len, seqlen, mesh,
                                   img_total)
    b, s, n, hd = q.shape
    s_pad = -(-s // 128) * 128
    carved = _carves(carve, s)
    if carve is not None and carve.sel_mask is not None and not carved:
        # a recorded selection must run on the sparse kernel, not be
        # silently dropped for dense attention
        raise NotImplementedError(
            "HYCarve.sel_mask (selection replay) is set but this call "
            "does not take the carved path (dense fallback) — the "
            "recorded selection would be silently ignored")
    if not carved:
        return attention_bshd(q, k, v, kv_len=seqlen).reshape(b, s, n * hd)

    qt, kt, vt = (_to_blocks(x, s_pad) for x in (q, k, v))
    num_blocks = s_pad // 128
    tsb = num_blocks - carve.txt_block_num
    qr = max(1, int(carve.q_rows))
    joint = qr > 1 and carve.joint_sel
    if carve.sel_mask is not None:
        # its layout depends on q_rows / joint_sel: replay it with the
        # ones it was recorded under
        mask = carve.sel_mask
        expect = (b, n, num_blocks, num_blocks)
        if tuple(mask.shape) != expect:
            raise ValueError(
                f"HYCarve.sel_mask shape {tuple(mask.shape)} != {expect} "
                "expected (B, H, nqb, nkb incl. text rows) — was it "
                "recorded on a different grid?")
    else:
        with obs.span("planner"):
            mask = _video_mask(qt, kt, carve, img_len)
            full = torch.ones((b, n, num_blocks - tsb, num_blocks),
                              dtype=torch.bool, device=q.device)
            mask = torch.cat([mask, full], dim=2)
    out = sparse_attention_from_mask(
        qt, kt, vt, mask, seqlens=seqlen, text_start_block=tsb,
        text_amp=carve.text_amp, q_rows=qr, joint=joint)
    with obs.span("layout"):
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

    def modulations(self, vec, tr=None):
        """The image and text streams' six modulation chunks [B, 1, d]
        (f32) and, under token replacement, the image stream's t=0 ones
        with the first-frame mask (else None)."""
        im = self.img_mod(L.silu(vec)).float()[:, None].chunk(6, dim=-1)
        tm = self.txt_mod(L.silu(vec)).float()[:, None].chunk(6, dim=-1)
        tr_img = None
        if tr is not None:
            trm = _tr_chunks(self.img_mod, tr["vec"], 6)
            tr_img = {"mask": tr["mask_img"], "mod1": (trm[0], trm[1]),
                      "gate1": trm[2], "mod2": (trm[3], trm[4]),
                      "gate2": trm[5]}
        return im, tm, tr_img

    def joint_qkv(self, img, txt, im, tm, tr_img, rope_cos, rope_sin):
        """The joint attention's q, k, v [B, S_img + S_txt, H, D]: each
        stream modulated, projected and q/k RMS-normed, RoPE on the image
        rows. Shared by ``forward`` and ``hy_first_selection_mask``."""
        b, si, _ = img.shape
        st = txt.shape[1]
        n, hd = self.cfg.heads_num, self.cfg.head_dim
        img_mod = _mod_tr(img, im[0], im[1], tr_img, "mod1")
        img_qkv = self.img_qkv(img_mod).reshape(b, si, 3, n, hd)
        img_q = L.rms_norm_rope(img_qkv[:, :, 0], self.img_q_norm, rope_cos,
                                rope_sin)
        img_k = L.rms_norm_rope(img_qkv[:, :, 1], self.img_k_norm, rope_cos,
                                rope_sin)

        txt_mod = L.norm_modulate(txt, shift=tm[0], scale=tm[1])
        txt_qkv = self.txt_qkv(txt_mod).reshape(b, st, 3, n, hd)
        txt_q = L.norm_modulate(txt_qkv[:, :, 0], self.txt_q_norm, rms=True)
        txt_k = L.norm_modulate(txt_qkv[:, :, 1], self.txt_k_norm, rms=True)

        q = _cat([img_q, txt_q], dim=1)
        k = _cat([img_k, txt_k], dim=1)
        v = _cat([img_qkv[:, :, 2], txt_qkv[:, :, 2]], dim=1)
        return q, k, v

    @obs.spanned("block")
    def forward(self, img, txt, vec, carve, rope_cos, rope_sin, seqlen,
                tr=None, mesh=None, img_total=None):
        """``tr``: None, or the token replacement's ``vec`` (the t=0
        modulation vector) and ``mask_img`` (first-frame image tokens).
        On a ``mesh``, img is this rank's slice of ``img_total`` tokens."""
        si = img.shape[1]
        im, tm, tr_img = self.modulations(vec, tr)
        q, k, v = self.joint_qkv(img, txt, im, tm, tr_img, rope_cos,
                                 rope_sin)
        attn = _joint_attention(q, k, v, carve, si, seqlen, mesh,
                                img_total)
        img_attn, txt_attn = attn[:, :si], attn[:, si:]

        img = _gate_tr(img, self.img_proj(img_attn), im[2], tr_img, "gate1")
        y = _mod_tr(img, im[3], im[4], tr_img, "mod2")
        y = self.img_mlp.fc2(L.gelu_tanh(self.img_mlp.fc1(y)))
        img = _gate_tr(img, y, im[5], tr_img, "gate2")

        txt = L.gated(txt, self.txt_proj(txt_attn), tm[2])
        y = L.norm_modulate(txt, shift=tm[3], scale=tm[4])
        y = self.txt_mlp.fc2(L.gelu_tanh(self.txt_mlp.fc1(y)))
        txt = L.gated(txt, y, tm[5])
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

    @obs.spanned("block")
    def forward(self, x, vec, carve, rope_cos, rope_sin, txt_len, seqlen,
                tr=None, mesh=None, img_total=None):
        """``tr``: None, or the token replacement's ``vec`` and
        ``mask_full`` (first-frame tokens of the joint sequence). On a
        ``mesh``, x is [this rank's image slice | the whole text]."""
        b, s, d = x.shape
        n, hd = self.cfg.heads_num, self.cfg.head_dim
        shift, scale, gate = self.modulation(L.silu(vec)).float()[:, None] \
            .chunk(3, dim=-1)
        tr_full = None
        if tr is not None:
            trm = _tr_chunks(self.modulation, tr["vec"], 3)
            tr_full = {"mask": tr["mask_full"], "mod": (trm[0], trm[1]),
                       "gate": trm[2]}
        x_mod = _mod_tr(x, shift, scale, tr_full, "mod")
        y = self.linear1(x_mod)
        qkv, mlp = y[..., :3 * d], y[..., 3 * d:]
        qkv = qkv.reshape(b, s, 3, n, hd)
        img_len = s - txt_len
        q = L.rms_norm_rope(qkv[:, :, 0], self.q_norm, rope_cos, rope_sin,
                            rope_rows=img_len)
        k = L.rms_norm_rope(qkv[:, :, 1], self.k_norm, rope_cos, rope_sin,
                            rope_rows=img_len)
        v = qkv[:, :, 2]
        attn = _joint_attention(q, k, v, carve, img_len, seqlen, mesh,
                                img_total)
        out = self.linear2(_cat([attn, L.gelu_tanh(mlp)], dim=-1))
        return _gate_tr(x, out, gate, tr_full, "gate")


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
        if cfg.i2v_condition_type not in (None, "token_replace"):
            raise ValueError(f"i2v_condition_type "
                             f"{cfg.i2v_condition_type!r}: the model knows "
                             f"only token_replace (None for T2V and "
                             f"latent_concat)")
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
        return next(self.parameters()).device

    @obs.spanned("embed")
    def embed(self, x, t, text_states, text_mask, text_states_2,
              carve: HYCarve | None = None, guidance=None, mesh=None):
        """Patchify + curve reorder + refiner + modulation vector. With a
        ``mesh``, img comes back as this rank's slice of the curve-ordered
        tokens, with its rows of the RoPE tables and of the token-replace
        mask; ``aux["img_len"]`` is the whole count either way."""
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
        tr = None
        if cfg.i2v_condition_type == "token_replace":
            # the t=0 embedding plus the vector embedding (no guidance),
            # for the first frame's tokens: the mask follows the curve
            # reorder, and is False over the text
            tr_vec = _timestep_embedder(self.time_in, torch.zeros_like(t))
            tr_vec = tr_vec + _mlp_embedder(self.vector_in,
                                            text_states_2.float())
            mask_img = torch.arange(img.shape[1], device=x.device) \
                < grid[1] * grid[2]
            if carve is not None:
                mask_img = mask_img[carve.curve_order]
            mask_full = torch.cat([mask_img, torch.zeros(
                txt.shape[1], dtype=torch.bool, device=x.device)])
            tr = dict(vec=tr_vec.float(), mask_img=mask_img,
                      mask_full=mask_full)
        if carve is not None:
            with obs.span("layout"):
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
                   txt_len=txt.shape[1], seqlens=seqlens.to(torch.int32),
                   tr=tr, img_len=img.shape[1])
        if mesh is not None:
            start, stop = token_range(img.shape[1], token_mesh(mesh))
            img = img[:, start:stop].clone()
            aux["rope_cos"] = rope_cos[start:stop]
            aux["rope_sin"] = rope_sin[start:stop]
            if tr is not None:
                mask_img = tr["mask_img"][start:stop]
                tr.update(mask_img=mask_img, mask_full=torch.cat(
                    [mask_img, tr["mask_full"][aux["img_len"]:]]))
        return img, txt, aux

    @obs.spanned("trunk")
    def trunk(self, img, txt, aux, carve: HYCarve | None = None,
              remat: bool = False, scan: bool = False, mesh=None):
        """Double + single block stack; img is curve-ordered in and out
        (on a ``mesh``, this rank's slice of it, as ``embed`` gives it).
        ``remat`` checkpoints each block: the backward recomputes its
        forward (kernels included) instead of keeping its activations."""
        if scan:
            raise NotImplementedError("scan is an XLA compile device and is "
                                      "not ported")
        if mesh is not None:
            mesh = token_mesh(mesh)
        vec, seqlen, tr = aux["vec"], aux["seqlens"], aux["tr"]
        rope_cos, rope_sin = aux["rope_cos"], aux["rope_sin"]
        sp = (mesh, aux["img_len"]) if mesh is not None else (None, None)
        if mesh is not None and not ulysses_fits(self.cfg.heads_num, mesh) \
                and _carves(carve, aux["img_len"] + aux["txt_len"]):
            warn_carving_disabled(self.cfg.heads_num, mesh)

        def run(blk, *args):
            return L.remat_call(blk, *args) if remat else blk(*args)

        for blk in self.double_blocks:
            img, txt = run(blk, img, txt, vec, carve, rope_cos, rope_sin,
                           seqlen, tr, *sp)
        x = _cat([img, txt], dim=1)
        for blk in self.single_blocks:
            x = run(blk, x, vec, carve, rope_cos, rope_sin, aux["txt_len"],
                    seqlen, tr, *sp)
        return x[:, :img.shape[1]]

    @obs.spanned("head")
    def head(self, img, aux, carve: HYCarve | None = None, mesh=None):
        """Inverse curve + modulated final layer + unpatchify (f32 out). On
        a ``mesh`` the ranks' slices are gathered first: every rank
        returns the same velocity."""
        cfg = self.cfg
        if mesh is not None:
            img = gather_tokens(img, token_mesh(mesh), aux["img_len"])
        if carve is not None:
            with obs.span("layout"):
                img = img[:, carve.inverse_order]
        fl = self.final_layer
        m = fl.adaLN(L.silu(aux["vec"])).float()
        d = cfg.hidden_size
        out = L.norm_modulate(img, shift=m[:, None, :d],
                              scale=m[:, None, d:])
        out = fl.linear(out)
        return L.unpatchify_3d(out.float(), aux["grid"], cfg.patch_size,
                               cfg.out_channels)

    def forward(self, x, t, text_states, text_mask=None, text_states_2=None,
                carve: HYCarve | None = None, guidance=None, mesh=None,
                remat: bool = False):
        """Velocity prediction. x [B, C, F, H, W]; text_states [B, L, 4096];
        text_states_2 [B, 768]; ``remat`` as in ``trunk``. With a ``mesh``
        (``parallel.make_sp_mesh``) the image tokens are sliced over its
        ranks after ``embed`` and gathered before ``head``."""
        if text_states_2 is None:
            text_states_2 = torch.zeros(
                (x.shape[0], self.cfg.text_states_dim_2), device=x.device)
        img, txt, aux = self.embed(x, t, text_states, text_mask,
                                   text_states_2, carve, guidance, mesh)
        img = self.trunk(img, txt, aux, carve, remat=remat, mesh=mesh)
        return self.head(img, aux, carve, mesh)


def hy_first_selection_mask(model: HYVideoDiT, x, t, text_states,
                            text_mask, text_states_2, carve: HYCarve,
                            guidance=None, top_k=None):
    """Diagnostic: the carving planner's selection mask for the FIRST
    double block's video query rows, [B, H, tsb, nkb] bool, with no
    attention run. q and k come from the block's own ``modulations`` and
    ``joint_qkv`` (token replacement included) and the mask from the
    forward's ``_video_mask``, so it is the mask a carved forward's first
    block plans on the same inputs. ``top_k`` defaults to ``(1 -
    sa_drop_rate)`` of the video blocks; ``carve.sel_mask`` is not
    consulted. Port of ``jenga_tpu.models.hyvideo.hy_first_selection_mask``
    (the JAX bench's ``density`` and ``q4_union_frac``)."""
    img, txt, aux = model.embed(x, t, text_states, text_mask, text_states_2,
                                carve, guidance)
    blk = model.double_blocks[0]
    im, tm, tr_img = blk.modulations(aux["vec"], aux["tr"])
    q, k, _ = blk.joint_qkv(img, txt, im, tm, tr_img, aux["rope_cos"],
                            aux["rope_sin"])
    s_pad = -(-q.shape[1] // 128) * 128
    return _video_mask(_to_blocks(q, s_pad), _to_blocks(k, s_pad), carve,
                       img.shape[1], top_k)


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

"""Wan2.1 video VAE (z_dim 16, stride (4, 8, 8)), streamed over time.

Port of ``jenga_tpu/codec/vae_wan.py``. The JAX package runs each layer
once over the whole clip with zero-front-padded causal convolutions; at
Wan's sizes one such tensor reaches tens of GB (832x480x81f: 24.8 GB for
the 192-channel tensor after the third decoder stage's spatial upsample).
This port streams the clip instead, as the reference's ``feat_cache``
does: the decoder takes one latent frame at a time (and its stages after
the last temporal upsample one output frame at a time), the encoder pixel
chunks of 1, 4, 4, ... frames, and every temporal op carries what it needs
from the previous chunk. The result is the same function, because every
op is local in time apart from these:

  * a causal conv (kernel depth kt) sees ``2*(kt//2)`` earlier input
    frames, zeros before frame 0: it keeps the last ones of each chunk;
  * ``upsample3d``'s ``time_conv``: frame 0 passes through and is never
    doubled; frames 1.. go through a 2c-channel causal conv (two zero
    frames ahead of frame 1, carried like any causal conv) whose channel
    halves interleave into doubled frames;
  * ``downsample3d``'s ``time_conv``: frame 0 passes through; a VALID
    stride-2 conv over windows [f0,f1,f2], [f2,f3,f4], ... keeps the
    frames of a window not yet complete (one frame, between chunks of an
    even length).

The norms are channel-RMS per location and the attention is per frame,
so neither needs state. ``_conv2d`` is a per-frame 2-D conv (weights
``[O, I, kh, kw]``); downsample pads right and bottom by 1 before its
stride-2 VALID conv. The module tree carries the JAX parameter names
(``encoder.down.0.res.0.norm1.g``, ``decoder.up.0.sample.time_conv.w``,
``conv1.w`` ...), so ``convert.wanvae_params_from_jax`` is the tree
flattened. Everything runs in f32.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..models.layers import param

__all__ = ["WanVAEConfig", "WAN_VAE_16Z", "WanVAE", "init_wanvae_",
           "wanvae_encode", "wanvae_decode", "WAN_LATENT_MEAN",
           "WAN_LATENT_STD"]


@dataclasses.dataclass(frozen=True)
class WanVAEConfig:
    dim: int = 96
    z_dim: int = 16
    dim_mult: tuple[int, ...] = (1, 2, 4, 4)
    num_res_blocks: int = 2
    temporal_downsample: tuple[bool, ...] = (False, True, True)


WAN_VAE_16Z = WanVAEConfig()

# per-channel latent normalization (the reference's ``WanVAE.__init__``)
WAN_LATENT_MEAN = np.array([
    -0.7571, -0.7089, -0.9113, 0.1075, -0.1745, 0.9653, -0.1517, 1.5508,
    0.4134, -0.0715, 0.5517, -0.3632, -0.1922, -0.9497, 0.2503, -0.2921],
    np.float32)
WAN_LATENT_STD = np.array([
    2.8184, 1.4541, 2.3275, 2.6558, 1.2196, 1.7708, 2.6052, 2.0743,
    3.2687, 2.1526, 2.8652, 1.5579, 1.6382, 1.1253, 2.8251, 1.9160],
    np.float32)


# ------------------------------------------------------------------ modules


class Conv(nn.Module):
    """Conv params ``w`` [O, I, *kernel] (3-D or 2-D kernel), ``b`` [O]."""

    def __init__(self, c_in, c_out, kernel, device):
        super().__init__()
        self.w = param((c_out, c_in, *kernel), torch.float32, device)
        self.b = param((c_out,), torch.float32, device)


class RMSNorm(nn.Module):
    def __init__(self, c, device):
        super().__init__()
        self.g = param((c,), torch.float32, device)


class ResBlock(nn.Module):
    def __init__(self, c_in, c_out, device):
        super().__init__()
        self.norm1 = RMSNorm(c_in, device)
        self.conv1 = Conv(c_in, c_out, (3, 3, 3), device)
        self.norm2 = RMSNorm(c_out, device)
        self.conv2 = Conv(c_out, c_out, (3, 3, 3), device)
        self.shortcut = (Conv(c_in, c_out, (1, 1, 1), device)
                         if c_in != c_out else None)


class Attention(nn.Module):
    def __init__(self, c, device):
        super().__init__()
        self.norm = RMSNorm(c, device)
        self.qkv = Conv(c, 3 * c, (1, 1), device)
        self.proj = Conv(c, c, (1, 1), device)


class Mid(nn.Module):
    def __init__(self, c, device):
        super().__init__()
        self.res0 = ResBlock(c, c, device)
        self.attn = Attention(c, device)
        self.res1 = ResBlock(c, c, device)


class Resample(nn.Module):
    """A spatial ``conv`` (2-D) and, for a temporal resample, a
    ``time_conv`` (3x1x1; 2x the channels when it upsamples)."""

    def __init__(self, c, c_out, time_out, device):
        super().__init__()
        self.conv = Conv(c, c_out, (3, 3), device)
        self.time_conv = (Conv(c, time_out, (3, 1, 1), device)
                          if time_out else None)


class Stage(nn.Module):
    def __init__(self, res, sample):
        super().__init__()
        self.res = nn.ModuleList(res)
        self.sample = sample


class Encoder(nn.Module):
    def __init__(self, cfg: WanVAEConfig, device):
        super().__init__()
        dims = [cfg.dim * u for u in (1,) + tuple(cfg.dim_mult)]
        self.conv1 = Conv(3, dims[0], (3, 3, 3), device)
        stages = []
        for i, (ci, co) in enumerate(zip(dims[:-1], dims[1:])):
            res = [ResBlock(ci if j == 0 else co, co, device)
                   for j in range(cfg.num_res_blocks)]
            sample = None
            if i != len(cfg.dim_mult) - 1:
                sample = Resample(co, co, co if cfg.temporal_downsample[i]
                                  else 0, device)
            stages.append(Stage(res, sample))
        self.down = nn.ModuleList(stages)
        self.mid = Mid(dims[-1], device)
        self.head_norm = RMSNorm(dims[-1], device)
        self.head_conv = Conv(dims[-1], 2 * cfg.z_dim, (3, 3, 3), device)


class Decoder(nn.Module):
    def __init__(self, cfg: WanVAEConfig, device):
        super().__init__()
        rdims = [cfg.dim * u for u in (cfg.dim_mult[-1],)
                 + tuple(reversed(cfg.dim_mult))]
        t_up = tuple(reversed(cfg.temporal_downsample))
        self.conv1 = Conv(cfg.z_dim, rdims[0], (3, 3, 3), device)
        self.mid = Mid(rdims[0], device)
        stages = []
        for i, (ci, co) in enumerate(zip(rdims[:-1], rdims[1:])):
            if i in (1, 2, 3):
                ci = ci // 2    # the upsample conv halved the channels
            res = [ResBlock(ci if j == 0 else co, co, device)
                   for j in range(cfg.num_res_blocks + 1)]
            sample = None
            if i != len(cfg.dim_mult) - 1:
                sample = Resample(co, co // 2, 2 * co if t_up[i] else 0,
                                  device)
            stages.append(Stage(res, sample))
        self.up = nn.ModuleList(stages)
        self.head_norm = RMSNorm(cfg.dim, device)
        self.head_conv = Conv(cfg.dim, 3, (3, 3, 3), device)


class WanVAE(nn.Module):
    """``encoder``, ``decoder`` and the 1x1x1 ``conv1`` (after the
    encoder) and ``conv2`` (before the decoder); holds its ``cfg``."""

    def __init__(self, cfg: WanVAEConfig = WAN_VAE_16Z, device="cpu"):
        super().__init__()
        self.cfg = cfg
        self.encoder = Encoder(cfg, device)
        self.decoder = Decoder(cfg, device)
        self.conv1 = Conv(2 * cfg.z_dim, 2 * cfg.z_dim, (1, 1, 1), device)
        self.conv2 = Conv(cfg.z_dim, cfg.z_dim, (1, 1, 1), device)

    @property
    def device(self) -> torch.device:
        return self.conv1.w.device


@torch.no_grad()
def init_wanvae_(vae: WanVAE, generator: torch.Generator) -> WanVAE:
    """Random init on the module's device, distribution for distribution
    as ``jenga_tpu.codec.vae_wan.init_wanvae_params``: conv weights
    U(+-1/sqrt(fan_in)) but the attention's zero ``proj``, biases 0, norm
    gains 1."""
    projs = {id(m.proj) for m in vae.modules() if isinstance(m, Attention)}
    for mod in vae.modules():
        if isinstance(mod, Conv):
            if id(mod) in projs:
                mod.w.zero_()
            else:
                bound = 1.0 / math.sqrt(mod.w[0].numel())
                mod.w.uniform_(-bound, bound, generator=generator)
            mod.b.zero_()
        elif isinstance(mod, RMSNorm):
            mod.g.fill_(1.0)
    return vae


# ------------------------------------------------------------------ ops
#
# ``state`` maps a temporal op (its module) to what it carries between
# chunks of one streamed pass; a fresh dict starts a pass.


def _conv3d(p: Conv, x, state: dict):
    """Causal 3-D conv: ``2*(kt//2)`` earlier input frames in front (zeros
    before frame 0, then the end of the previous chunk), zero spatial
    padding."""
    kt, kh, kw = p.w.shape[2:]
    n = 2 * (kt // 2)
    if n:
        prev = state.get(p)
        if prev is None:
            prev = x.new_zeros((*x.shape[:2], n, *x.shape[3:]))
        x = torch.cat([prev, x], dim=2)
        state[p] = x[:, :, -n:].clone()
    return F.conv3d(x, p.w, p.b, padding=(0, kh // 2, kw // 2))


def _conv2d(p: Conv, x, stride=(1, 1), same=True):
    """Per-frame 2-D conv on [B, C, T, H, W]: "SAME" padding, or none."""
    kh, kw = p.w.shape[2:]
    pad = (0, kh // 2, kw // 2) if same else 0
    return F.conv3d(x, p.w[:, :, None], p.b, stride=(1, *stride),
                    padding=pad)


def _rms_norm(p: RMSNorm, x):
    """Channel-RMS per location: x / ||x|| * sqrt(C) * gamma."""
    c = x.shape[1]
    n = x * torch.rsqrt(x.square().sum(dim=1, keepdim=True) + 1e-12)
    return n.mul_(math.sqrt(c) * p.g.reshape(1, -1, 1, 1, 1))


def _norm_silu(p: RMSNorm, x):
    return F.silu(_rms_norm(p, x), inplace=True)


def _resblock(p: ResBlock, x, state):
    h = _conv3d(p.conv1, _norm_silu(p.norm1, x), state)
    h = _conv3d(p.conv2, _norm_silu(p.norm2, h), state)
    if p.shortcut is not None:
        x = _conv3d(p.shortcut, x, state)
    return h.add_(x)


def _attention(p: Attention, x):
    """Per-frame single-head spatial attention."""
    b, c, t, h, w = x.shape
    qkv = _conv2d(p.qkv, _rms_norm(p.norm, x)).reshape(b, 3, c, t, h * w)
    q = qkv[:, 0].permute(0, 2, 3, 1)               # [B, T, HW, C]
    k = qkv[:, 1].permute(0, 2, 1, 3)               # [B, T, C, HW]
    v = qkv[:, 2].permute(0, 2, 3, 1)               # [B, T, HW, C]
    a = torch.softmax(torch.matmul(q, k) * (c ** -0.5), dim=-1)
    del q, k, qkv
    out = torch.matmul(a, v).permute(0, 3, 1, 2).reshape(b, c, t, h, w)
    return x + _conv2d(p.proj, out)


def _mid(p: Mid, x, state):
    x = _resblock(p.res0, x, state)
    x = _attention(p.attn, x)
    return _resblock(p.res1, x, state)


def _downsample(p: Resample, x, state):
    """Spatial stride-2 conv of every frame; then, if temporal, frame 0
    passes through and the stride-2 time_conv runs over the complete
    windows, keeping the frames of the next incomplete one."""
    xs = _conv2d(p.conv, F.pad(x, (0, 1, 0, 1)), stride=(2, 2), same=False)
    if p.time_conv is None:
        return xs
    first = p not in state
    buf = xs if first else torch.cat([state[p], xs], dim=2)
    n_out = max((buf.shape[2] - 3) // 2 + 1, 0)
    state[p] = buf[:, :, 2 * n_out:].clone()
    rest = F.conv3d(buf[:, :, :2 * n_out + 1], p.time_conv.w,
                    p.time_conv.b, stride=(2, 1, 1)) if n_out else None
    parts = ([xs[:, :, :1]] if first else []) + ([rest] if n_out else [])
    return torch.cat(parts, dim=2)


def _upsample(p: Resample, x, state):
    """If temporal: frame 0 passes through, later frames go through the
    causal 2c-channel time_conv and become two frames each; then a
    nearest 2x spatial upsample and the per-frame conv to c/2."""
    if p.time_conv is not None:
        first = p not in state
        state[p] = True
        head, tail = (x[:, :, :1], x[:, :, 1:]) if first else (None, x)
        parts = [head] if head is not None else []
        t = tail.shape[2]
        if t:
            b, c, _, h, w = tail.shape
            y = _conv3d(p.time_conv, tail, state)   # [B, 2C, t, H, W]
            y = y.reshape(b, 2, c, t, h, w).permute(0, 2, 3, 1, 4, 5)
            parts.append(y.reshape(b, c, 2 * t, h, w))
        x = torch.cat(parts, dim=2)
    x = x.repeat_interleave(2, dim=3).repeat_interleave(2, dim=4)
    return _conv2d(p.conv, x)


def _encode_chunk(p: Encoder, cfg, x, state):
    h = _conv3d(p.conv1, x, state)
    for stage in p.down:
        for rb in stage.res:
            h = _resblock(rb, h, state)
        if stage.sample is not None:
            h = _downsample(stage.sample, h, state)
    h = _mid(p.mid, h, state)
    return _conv3d(p.head_conv, _norm_silu(p.head_norm, h), state)


def _up_stage(stage: Stage, h, state):
    for rb in stage.res:
        h = _resblock(rb, h, state)
    if stage.sample is not None:
        h = _upsample(stage.sample, h, state)
    return h


def _decode_chunk(p: Decoder, z, state):
    h = _conv3d(p.conv1, z, state)
    h = _mid(p.mid, h, state)
    # the stages after the last temporal upsample (the largest tensors)
    # take the chunk's frames one at a time, which the carried causal
    # caches make the same function in a quarter of the working memory
    last_t = max(i for i, stage in enumerate(p.up) if stage.sample
                 is not None and stage.sample.time_conv is not None)
    for stage in p.up[:last_t + 1]:
        h = _up_stage(stage, h, state)
    frames = []
    for f in range(h.shape[2]):
        x = h[:, :, f:f + 1]
        for stage in p.up[last_t + 1:]:
            x = _up_stage(stage, x, state)
        frames.append(_conv3d(p.head_conv, _norm_silu(p.head_norm, x),
                              state))
    return torch.cat(frames, dim=2)


def _norm_stats(z):
    mean = torch.as_tensor(WAN_LATENT_MEAN, device=z.device)
    std = torch.as_tensor(WAN_LATENT_STD, device=z.device)
    return mean.reshape(1, -1, 1, 1, 1), std.reshape(1, -1, 1, 1, 1)


@torch.inference_mode()
def wanvae_encode(vae: WanVAE, x, normalize: bool = True):
    """x [B, 3, F, H, W] in [-1, 1], F = 1 + 4k -> (normalized) latent
    mean [B, z, 1 + k, H/8, W/8], streamed in pixel chunks of 1, 4, 4,
    ... frames."""
    f = x.shape[2]
    if (f - 1) % 4:
        raise ValueError(f"the Wan VAE encodes 1 + 4k frames, got {f}")
    state = {}
    mu = []
    for s in [0] + list(range(1, f, 4)):
        chunk = x[:, :, s:s + (1 if s == 0 else 4)]
        moments = _conv3d(vae.conv1, _encode_chunk(
            vae.encoder, vae.cfg, chunk, state), state)
        mu.append(moments[:, :vae.cfg.z_dim])
    mu = torch.cat(mu, dim=2)
    if normalize:
        mean, std = _norm_stats(mu)
        mu = (mu - mean) / std
    return mu


@torch.inference_mode()
def wanvae_decode(vae: WanVAE, z, normalize: bool = True):
    """z [B, z, T, h, w] (normalized) latents -> video [B, 3, 1 + 4(T-1),
    8h, 8w] clamped to [-1, 1], streamed one latent frame at a time."""
    if normalize:
        mean, std = _norm_stats(z)
        z = z * std + mean
    state = {}
    frames = []
    for i in range(z.shape[2]):
        h = _conv3d(vae.conv2, z[:, :, i:i + 1], state)
        frames.append(_decode_chunk(vae.decoder, h, state).clamp_(-1.0, 1.0))
    return torch.cat(frames, dim=2)

"""HunyuanVideo causal 3-D VAE ("884": 4x temporal / 8x spatial, 16ch).

Port of ``jenga_tpu/codec/vae_hy.py``, op for op, in f32:

  * ``causal_conv3d``: replicate ("edge") padding, time front-padded by
    kt-1 only (``nn.Conv3d(padding_mode="replicate")`` would pad both ends
    of time), so each output frame sees only itself and earlier frames;
  * ``group_norm``: f32 statistics over (C/G, T, H, W) of the whole input,
    which is why this VAE is tiled rather than streamed;
  * encoder: conv_in -> 4 down blocks -> mid (resnet, frame-causal
    single-head attention, resnet) -> groupnorm -> conv_out (2x latent);
  * decoder mirrors it with nearest-neighbour upsampling in which the
    first frame is upsampled in space only;
  * spatial + temporal tiled encode/decode with linear seam blending, each
    tile blended against its already-blended neighbour, with JAX's loop
    bounds and crops.

The module tree carries the JAX parameter names (``encoder.conv_in.w``,
``decoder.blocks.0.resnets.0.norm1.w``, ``quant_conv.b`` ...), so
``convert.hyvae_params_from_jax`` is the tree flattened; the attention's
``q/k/v/o`` are ``layers.Affine`` ([out, in]). The mid-block attention is
plain f32 matmul + softmax, as the JAX package computes it.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..models.layers import Affine, Norm, param

__all__ = ["HYVAEConfig", "HYVAE", "init_hyvae_", "vae_encode",
           "vae_decode", "vae_decode_tiled", "vae_encode_tiled",
           "gaussian_sample", "HYVAE_884_16C"]


@dataclasses.dataclass(frozen=True)
class HYVAEConfig:
    in_channels: int = 3
    out_channels: int = 3
    latent_channels: int = 16
    block_out_channels: tuple[int, ...] = (128, 256, 512, 512)
    layers_per_block: int = 2
    norm_num_groups: int = 32
    time_compression_ratio: int = 4
    spatial_compression_ratio: int = 8
    scaling_factor: float = 0.476986
    sample_tsize: int = 64          # temporal tile (video frames)
    sample_size: int = 256          # spatial tile (pixels)
    tile_overlap_factor: float = 0.25


HYVAE_884_16C = HYVAEConfig()


# ------------------------------------------------------------------ modules


class Conv(nn.Module):
    """3-D conv params: ``w`` [O, I, k, k, k] and ``b`` [O], f32."""

    def __init__(self, c_in, c_out, k, device):
        super().__init__()
        self.w = param((c_out, c_in, k, k, k), torch.float32, device)
        self.b = param((c_out,), torch.float32, device)


class Resnet(nn.Module):
    def __init__(self, c_in, c_out, device):
        super().__init__()
        self.norm1 = Norm(c_in, device)
        self.conv1 = Conv(c_in, c_out, 3, device)
        self.norm2 = Norm(c_out, device)
        self.conv2 = Conv(c_out, c_out, 3, device)
        self.shortcut = (Conv(c_in, c_out, 1, device) if c_in != c_out
                         else None)


class Attention(nn.Module):
    def __init__(self, c, device):
        super().__init__()
        self.norm = Norm(c, device)
        for name in ("q", "k", "v", "o"):
            setattr(self, name, Affine(c, c, torch.float32, device))


class MidBlock(nn.Module):
    def __init__(self, c, device):
        super().__init__()
        self.resnet0 = Resnet(c, c, device)
        self.attn = Attention(c, device)
        self.resnet1 = Resnet(c, c, device)


class Up(nn.Module):
    def __init__(self, c, device):
        super().__init__()
        self.conv = Conv(c, c, 3, device)


class Block(nn.Module):
    """``resnets``, then ``down`` (a strided conv, encoder) or ``up``
    (decoder), or neither."""

    def __init__(self, c_in, c_out, n_resnets, device, down=False,
                 up=False):
        super().__init__()
        self.resnets = nn.ModuleList(
            Resnet(c_in if j == 0 else c_out, c_out, device)
            for j in range(n_resnets))
        self.down = Conv(c_out, c_out, 3, device) if down else None
        self.up = Up(c_out, device) if up else None


class Coder(nn.Module):
    """The encoder or the decoder: ``conv_in`` (``c_in`` -> ``c_first``),
    ``blocks``, ``mid``, ``norm_out``, ``conv_out``."""

    def __init__(self, c_in, c_first, blocks, c_mid, c_norm, c_out, device):
        super().__init__()
        self.conv_in = Conv(c_in, c_first, 3, device)
        self.blocks = nn.ModuleList(blocks)
        self.mid = MidBlock(c_mid, device)
        self.norm_out = Norm(c_norm, device)
        self.conv_out = Conv(c_norm, c_out, 3, device)


class HYVAE(nn.Module):
    """``encoder``, ``decoder``, ``quant_conv``, ``post_quant_conv``; holds
    its ``cfg``."""

    def __init__(self, cfg: HYVAEConfig = HYVAE_884_16C, device="cpu"):
        super().__init__()
        self.cfg = cfg
        ch = cfg.block_out_channels
        lp = cfg.layers_per_block
        strides = _down_strides(cfg)
        blocks, c_in = [], ch[0]
        for i, c_out in enumerate(ch):
            blocks.append(Block(c_in, c_out, lp, device,
                                down=strides[i] is not None))
            c_in = c_out
        self.encoder = Coder(cfg.in_channels, ch[0], blocks, ch[-1], ch[-1],
                             2 * cfg.latent_channels, device)
        rch = list(reversed(ch))
        blocks, c_in = [], rch[0]
        for i, c_out in enumerate(rch):
            blocks.append(Block(c_in, c_out, lp + 1, device,
                                up=strides[i] is not None))
            c_in = c_out
        self.decoder = Coder(cfg.latent_channels, ch[-1], blocks, ch[-1],
                             ch[0], cfg.out_channels, device)
        lc = cfg.latent_channels
        self.quant_conv = Conv(2 * lc, 2 * lc, 1, device)
        self.post_quant_conv = Conv(lc, lc, 1, device)

    @property
    def device(self) -> torch.device:
        return self.quant_conv.w.device


def _down_strides(cfg: HYVAEConfig):
    """Per-block downsample stride (None = no downsample); 884 layout:
    spatial on blocks 0..2, temporal on 1..2. The decoder's upsample
    factors follow the same rule."""
    n = len(cfg.block_out_channels)
    ns = int(np.log2(cfg.spatial_compression_ratio))
    nt = int(np.log2(cfg.time_compression_ratio))
    out = []
    for i in range(n):
        sp = i < ns
        tm = (i >= n - 1 - nt) and (i != n - 1)
        if not sp and not tm:
            out.append(None)
        else:
            out.append((2 if tm else 1, 2 if sp else 1, 2 if sp else 1))
    return out


@torch.no_grad()
def init_hyvae_(vae: HYVAE, generator: torch.Generator) -> HYVAE:
    """Random init on the module's device, distribution for distribution
    as ``jenga_tpu.codec.vae_hy.init_hyvae_params``: conv weights
    U(+-1/sqrt(fan_in)), attention linears U(+-1/sqrt(in)), biases 0, norm
    scales 1 and shifts 0."""
    for mod in vae.modules():
        if isinstance(mod, Conv):
            bound = 1.0 / math.sqrt(mod.w[0].numel())
            mod.w.uniform_(-bound, bound, generator=generator)
            mod.b.zero_()
        elif isinstance(mod, Affine):
            bound = 1.0 / math.sqrt(mod.w.shape[1])
            mod.w.uniform_(-bound, bound, generator=generator)
            mod.b.zero_()
        elif isinstance(mod, Norm):
            mod.w.fill_(1.0)
            mod.b.zero_()
    return vae


# ------------------------------------------------------------------ ops


def causal_conv3d(p: Conv, x, stride=(1, 1, 1)):
    """Replicate-padded causal 3-D conv; time padded in front by kt-1."""
    kt, kh, kw = p.w.shape[2:]
    x = F.pad(x, (kw // 2, kw // 2, kh // 2, kh // 2, kt - 1, 0),
              mode="replicate")
    return F.conv3d(x, p.w, p.b, stride=stride)


def group_norm(p: Norm, x, groups: int, eps: float = 1e-6):
    """GroupNorm over the channels of [B, C, T, H, W], f32 statistics."""
    return F.group_norm(x, groups, p.w, p.b, eps)


def _norm_silu(p: Norm, x, groups: int):
    return F.silu(group_norm(p, x, groups), inplace=True)


def _resnet(p: Resnet, x, groups):
    """GroupNorm-SiLU-conv x2 with (projected) residual."""
    h = causal_conv3d(p.conv1, _norm_silu(p.norm1, x, groups))
    h = causal_conv3d(p.conv2, _norm_silu(p.norm2, h, groups))
    if p.shortcut is not None:
        x = causal_conv3d(p.shortcut, x)
    return h.add_(x)


def _mid_attention(p: Attention, x, groups):
    """Single-head frame-causal attention over the T*H*W tokens: a token
    attends every token of its own and earlier frames."""
    b, c, t, hh, ww = x.shape
    tok = group_norm(p.norm, x, groups).reshape(b, c, t * hh * ww)
    tok = tok.transpose(1, 2)                       # [B, S, C]
    q, k, v = p.q(tok), p.k(tok), p.v(tok)
    del tok
    logits = torch.matmul(q, k.transpose(1, 2)) * (c ** -0.5)
    del q, k
    frame = torch.arange(t * hh * ww, device=x.device) // (hh * ww)
    logits.masked_fill_(frame[:, None] < frame[None, :], -math.inf)
    out = torch.matmul(torch.softmax(logits, dim=-1), v)
    del logits, v
    out = p.o(out).transpose(1, 2).reshape(b, c, t, hh, ww)
    return out.add_(x)


def _mid_block(p: MidBlock, x, groups):
    x = _resnet(p.resnet0, x, groups)
    x = _mid_attention(p.attn, x, groups)
    return _resnet(p.resnet1, x, groups)


def _repeat(x, factors):
    """Nearest-neighbour upsample of dims 2, 3, 4 by integer factors."""
    for dim, f in zip((2, 3, 4), factors):
        if f > 1:
            x = x.repeat_interleave(f, dim=dim)
    return x


def _upsample(p: Up, x, factor):
    """Nearest-neighbour upsample; the first frame is never duplicated in
    time (causal), then a conv."""
    ft, fh, fw = factor
    if ft > 1 and x.shape[2] > 1:
        x = torch.cat([_repeat(x[:, :, :1], (1, fh, fw)),
                       _repeat(x[:, :, 1:], factor)], dim=2)
    else:
        x = _repeat(x, (1, fh, fw))
    return causal_conv3d(p.conv, x)


def _encoder(p: Coder, cfg, x):
    g = cfg.norm_num_groups
    h = causal_conv3d(p.conv_in, x)
    for blk, stride in zip(p.blocks, _down_strides(cfg)):
        for r in blk.resnets:
            h = _resnet(r, h, g)
        if stride is not None:
            h = causal_conv3d(blk.down, h, stride=stride)
    h = _mid_block(p.mid, h, g)
    return causal_conv3d(p.conv_out, _norm_silu(p.norm_out, h, g))


def _decoder(p: Coder, cfg, z):
    g = cfg.norm_num_groups
    h = causal_conv3d(p.conv_in, z)
    h = _mid_block(p.mid, h, g)
    for blk, factor in zip(p.blocks, _down_strides(cfg)):
        for r in blk.resnets:
            h = _resnet(r, h, g)
        if factor is not None:
            h = _upsample(blk.up, h, factor)
    return causal_conv3d(p.conv_out, _norm_silu(p.norm_out, h, g))


@torch.inference_mode()
def vae_encode(vae: HYVAE, x):
    """x [B, 3, F, H, W] in [-1, 1] -> moments [B, 2*latent, f, h, w]."""
    return causal_conv3d(vae.quant_conv, _encoder(vae.encoder, vae.cfg, x))


def gaussian_sample(moments, generator: torch.Generator | None = None):
    """Sample of the diagonal gaussian from ``generator``, or its mode (the
    mean) when ``generator`` is None."""
    mean, logvar = torch.chunk(moments, 2, dim=1)
    if generator is None:
        return mean
    std = torch.exp(0.5 * logvar.clamp(-30.0, 20.0))
    return mean + std * torch.randn(mean.shape, generator=generator,
                                    device=mean.device, dtype=mean.dtype)


@torch.inference_mode()
def vae_decode(vae: HYVAE, z):
    """z [B, latent, f, h, w] (already un-scaled) -> video [B, 3, F, H, W]."""
    z = causal_conv3d(vae.post_quant_conv, z)
    return _decoder(vae.decoder, vae.cfg, z)


# ------------------------------------------------------------- tiling


def _blend(a, b, extent, dim):
    """``b`` with its first n slices along ``dim`` ramped in from ``a``'s
    last n, n = min(a's size, b's size, extent)."""
    n = min(a.shape[dim], b.shape[dim], extent)
    if n <= 0:
        return b
    shape = [1] * b.ndim
    shape[dim] = n
    ramp = (torch.arange(n, dtype=b.dtype, device=b.device) / n).reshape(
        shape)
    blended = (a.narrow(dim, a.shape[dim] - n, n) * (1 - ramp)
               + b.narrow(dim, 0, n) * ramp)
    return torch.cat([blended, b.narrow(dim, n, b.shape[dim] - n)], dim=dim)


def _blend_tiles(rows, blend):
    """Blend each tile against its already-blended upper and left
    neighbours (the reference blends in place), row by row."""
    done = [[None] * len(r) for r in rows]
    for i, row in enumerate(rows):
        for j, tile in enumerate(row):
            if i > 0:
                tile = _blend(done[i - 1][j], tile, blend, -2)
            if j > 0:
                tile = _blend(done[i][j - 1], tile, blend, -1)
            done[i][j] = tile
    return done


def _spatial_tiled_decode_raw(vae: HYVAE, z):
    """Spatially tiled decode with linear seam blending; ``z`` already
    went through post_quant_conv."""
    cfg = vae.cfg
    tile_latent = cfg.sample_size // cfg.spatial_compression_ratio
    overlap = max(int(tile_latent * (1 - cfg.tile_overlap_factor)), 1)
    blend = int(cfg.sample_size * cfg.tile_overlap_factor)
    row_limit = cfg.sample_size - blend
    rows = [[_decoder(vae.decoder, cfg,
                      z[:, :, :, i:i + tile_latent, j:j + tile_latent])
             for j in range(0, z.shape[-1], overlap)]
            for i in range(0, z.shape[-2], overlap)]
    done = _blend_tiles(rows, blend)
    return torch.cat([torch.cat([t[..., :row_limit] for t in row], dim=-1)
                      [..., :row_limit, :] for row in done], dim=-2)


def _temporal_tiles(one, x, tile, overlap, blend, limit):
    """Tiles of ``tile + 1`` frames every ``overlap`` frames through
    ``one``; every tile after the first drops its first output frame, is
    blended against the previous (blended) tile and cut to ``limit``
    frames, the first to ``limit + 1``."""
    parts, prev = [], None
    for start in range(0, x.shape[2], overlap):
        out = one(x[:, :, start:start + tile + 1])
        if start > 0:
            out = _blend(prev, out[:, :, 1:], blend, 2)
            parts.append(out[:, :, :limit])
        else:
            parts.append(out[:, :, :limit + 1])
        prev = out
    return torch.cat(parts, dim=2)


@torch.inference_mode()
def vae_decode_tiled(vae: HYVAE, z, temporal: bool = True):
    """Temporal + spatial tiled decode. z [B, latent, f, h, w]."""
    cfg = vae.cfg
    tile_latent_t = cfg.sample_tsize // cfg.time_compression_ratio
    tile_latent_s = cfg.sample_size // cfg.spatial_compression_ratio

    def decode_one(tile):
        if tile.shape[-1] > tile_latent_s or tile.shape[-2] > tile_latent_s:
            tile = causal_conv3d(vae.post_quant_conv, tile)
            return _spatial_tiled_decode_raw(vae, tile)
        return vae_decode(vae, tile)

    if not temporal or z.shape[2] <= tile_latent_t:
        return decode_one(z)
    overlap = max(int(tile_latent_t * (1 - cfg.tile_overlap_factor)), 1)
    blend = int(cfg.sample_tsize * cfg.tile_overlap_factor)
    return _temporal_tiles(decode_one, z, tile_latent_t, overlap, blend,
                           cfg.sample_tsize - blend)


def _encode_raw(vae: HYVAE, x):
    """encoder + quant_conv (no tiling): x -> moments."""
    return causal_conv3d(vae.quant_conv, _encoder(vae.encoder, vae.cfg, x))


def _spatial_tiled_encode_raw(vae: HYVAE, x):
    """Spatially tiled encode: pixel tiles of ``sample_size`` stepped by
    the pixel overlap, blended and cropped in latent space. Returns
    moments."""
    cfg = vae.cfg
    tile_px = cfg.sample_size
    overlap_px = int(tile_px * (1 - cfg.tile_overlap_factor))
    tile_lat = tile_px // cfg.spatial_compression_ratio
    blend = int(tile_lat * cfg.tile_overlap_factor)
    row_limit = tile_lat - blend
    rows = [[_encode_raw(vae, x[:, :, :, i:i + tile_px, j:j + tile_px])
             for j in range(0, x.shape[-1], overlap_px)]
            for i in range(0, x.shape[-2], overlap_px)]
    done = _blend_tiles(rows, blend)
    return torch.cat([torch.cat([t[..., :row_limit, :row_limit]
                                 for t in row], dim=-1) for row in done],
                     dim=-2)


@torch.inference_mode()
def vae_encode_tiled(vae: HYVAE, x, temporal: bool = True):
    """Temporal + spatial tiled encode. x [B, 3, F, H, W] in [-1, 1] ->
    moments [B, 2*latent, f, h, w]."""
    cfg = vae.cfg

    def encode_one(tile):
        if (tile.shape[-1] > cfg.sample_size
                or tile.shape[-2] > cfg.sample_size):
            return _spatial_tiled_encode_raw(vae, tile)
        return _encode_raw(vae, tile)

    if not temporal or x.shape[2] <= cfg.sample_tsize:
        return encode_one(x)
    overlap = int(cfg.sample_tsize * (1 - cfg.tile_overlap_factor))
    tile_lat_t = cfg.sample_tsize // cfg.time_compression_ratio
    blend = int(tile_lat_t * cfg.tile_overlap_factor)
    return _temporal_tiles(encode_one, x, cfg.sample_tsize, overlap, blend,
                           tile_lat_t - blend)

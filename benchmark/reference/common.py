"""Plain float32 building blocks of the reference DiTs.

Everything here is straightforward PyTorch in float32 (the caller turns
TF32 off): affine maps, norms, the sinusoidal embedding, 3-D RoPE tables
built in float64 on the host, the carving planner (mean-pooled q/k block
scores, top-p with a top-k floor, curve neighbours, first-frame blocks,
8-row joint groups) and attention, dense or over the selected 128-token
blocks. It imports nothing of the program under test: the planner's and
the attention's semantics are written out again from the published
Jenga description and the port's documented behaviour (pad keys past
``seqlen`` masked on the carved path, attended on Wan's dense path; a
joint group's rows attend the union of their selections).
"""

from __future__ import annotations

import contextlib
import math

import numpy as np
import torch
import torch.nn.functional as F

BLOCK = 128
# "fp8": every GEMM's operands and the attention's q, k, v rounded to
# e4m3 (a per-tensor scale to 448) before float32 arithmetic; the
# precision control of a bf16 configuration
PRECISION = {"mode": "float32"}


@contextlib.contextmanager
def precision(mode: str):
    """Compute the reference in ``mode`` ("float32" or "fp8") inside."""
    old, PRECISION["mode"] = PRECISION["mode"], mode
    try:
        yield
    finally:
        PRECISION["mode"] = old


def _round(x):
    x = x.float()
    if PRECISION["mode"] != "fp8":
        return x
    scale = x.abs().amax().clamp_min(1e-12) / 448.0
    return (x / scale).to(torch.float8_e4m3fn).float() * scale


def linear(x, w, b=None):
    """x @ w.T + b in float32 (``w`` [out, in], any dtype)."""
    y = _round(x) @ _round(w).T
    return y if b is None else y + b.float()


def layer_norm(x, w=None, b=None, eps: float = 1e-6):
    x = x.float()
    mean = x.mean(dim=-1, keepdim=True)
    var = (x - mean).square().mean(dim=-1, keepdim=True)
    y = (x - mean) * torch.rsqrt(var + eps)
    if w is not None:
        y = y * w.float()
    if b is not None:
        y = y + b.float()
    return y


def rms_norm(x, w=None, eps: float = 1e-6):
    x = x.float()
    y = x * torch.rsqrt(x.square().mean(dim=-1, keepdim=True) + eps)
    return y if w is None else y * w.float()


def gelu_tanh(x):
    return F.gelu(x, approximate="tanh")


def sinusoidal(dim: int, t, max_period: float = 10000.0):
    """[cos | sin] embedding of the timesteps ``t`` [B]."""
    half = dim // 2
    freqs = torch.exp(-math.log(max_period) * torch.arange(
        half, dtype=torch.float32, device=t.device) / half)
    args = t.float()[:, None] * freqs
    return torch.cat([torch.cos(args), torch.sin(args)], dim=-1)


def rope_tables(grid, dims, theta: float, order=None, pad_to=None):
    """cos/sin tables [S(, padded), head_dim/2] float32 of a (t, h, w)
    grid: each axis gets ``dims[axis] / 2`` frequencies theta^(-2j/dim) of
    its own coordinate, computed in float64; rows follow ``order`` (the
    curve) and pad rows rotate by nothing."""
    t, h, w = grid
    coords = np.stack(np.meshgrid(np.arange(t), np.arange(h), np.arange(w),
                                  indexing="ij"), axis=-1).reshape(-1, 3)
    angles = []
    for axis, dim in enumerate(dims):
        freqs = 1.0 / theta ** (np.arange(0, dim, 2, dtype=np.float64) / dim)
        angles.append(np.outer(coords[:, axis].astype(np.float64), freqs))
    ang = np.concatenate(angles, axis=-1)
    if order is not None:
        ang = ang[np.asarray(order)]
    if pad_to is not None and pad_to > ang.shape[0]:
        ang = np.concatenate([ang, np.zeros((pad_to - ang.shape[0],
                                             ang.shape[1]))])
    return (torch.as_tensor(np.cos(ang), dtype=torch.float32),
            torch.as_tensor(np.sin(ang), dtype=torch.float32))


def rope(x, cos, sin):
    """Rotate the interleaved (even, odd) pairs of x [B, S, H, D]."""
    x = x.float()
    xe, xo = x[..., 0::2], x[..., 1::2]
    c, s = cos[:, None, :], sin[:, None, :]
    return torch.stack([xe * c - xo * s, xo * c + xe * s], dim=-1).flatten(-2)


def select_blocks(q, k, *, top_k: int, p_remain: float, video_blocks: int,
                  text_blocks: int = 0, neighbors=None,
                  first_frame_blocks: int = 0, group: int = 1):
    """The carving planner: a bool selection [B, H, nq, nk] of key blocks
    for the query blocks of q [B, H, nq*128, D] over k [B, H, nk*128, D].

    Query and key blocks are mean-pooled (query blocks again over groups
    of ``group`` rows); the softmax of the pooled scores over the
    ``video_blocks`` video key blocks keeps the fewest blocks whose mass
    reaches ``p_remain``, at least ``top_k`` of them, and every block as
    probable as the last one kept; the curve ``neighbors`` (a group takes
    its rows' union) and the first-frame blocks are added, and the text
    key blocks are always on."""
    b, h, sq, d = q.shape
    nq, nk = sq // BLOCK, k.shape[2] // BLOCK
    qp = q.float().reshape(b, h, nq, BLOCK, d).mean(dim=3)
    kp = k.float()[:, :, :nk * BLOCK].reshape(b, h, nk, BLOCK, d).mean(dim=3)
    ng = -(-nq // group)
    if group > 1:
        # a ragged last group averages its real rows only
        real = (torch.arange(ng * group, device=q.device) < nq).float()
        qp = F.pad(qp, (0, 0, 0, ng * group - nq)).reshape(
            b, h, ng, group, d).sum(3)
        qp = qp / real.reshape(ng, group).sum(1)[:, None]
    scores = torch.einsum("bhqd,bhkd->bhqk", qp, kp)[..., :video_blocks] \
        / math.sqrt(d)
    probs = torch.softmax(scores, dim=-1)
    ranked = torch.sort(probs, dim=-1, descending=True).values
    need = (torch.cumsum(ranked, dim=-1) <= p_remain).sum(-1) + 1
    need = need.clamp(min=top_k, max=video_blocks)
    kth = torch.gather(ranked, -1, need[..., None] - 1)
    sel = probs >= kth
    if neighbors is not None:
        nb = neighbors.to(q.device)[:nq, :video_blocks]
        if group > 1:
            nb = F.pad(nb, (0, 0, 0, ng * group - nq)).reshape(
                ng, group, -1).any(dim=1)
        sel = sel | nb
    if first_frame_blocks and group > 1:
        sel[:, :, :-(-first_frame_blocks // group), :first_frame_blocks] = True
    if group > 1:
        sel = sel.repeat_interleave(group, dim=2)[:, :, :nq]
    out = torch.zeros((b, h, nq, nk), dtype=torch.bool, device=q.device)
    out[..., :video_blocks] = sel
    if first_frame_blocks and group == 1:
        out[:, :, :first_frame_blocks, :first_frame_blocks] = True
    if text_blocks:
        out[..., video_blocks:video_blocks + text_blocks] = True
    return out


def sparse_attention(q, k, v, mask, *, seqlen, group: int = 1,
                     text_start_block: int | None = None,
                     text_amp: float = 0.0):
    """Attention of q [B, H, S, D] over the selected 128-key blocks of k, v
    [B, H, S, D], ``mask`` [B, H, S/128, S/128]; the rows of a group of
    ``group`` query blocks attend the union of their selections; keys at
    or past ``seqlen`` (an int, or one per batch row) are masked; video
    query rows add ``text_amp`` to their base-2 logits of the text key
    blocks (those from ``text_start_block`` on). The selected blocks are
    gathered, one query group at a time over all heads, so the work
    follows the selection.
    Returns float32 [B, H, S, D]."""
    b, h, s, d = q.shape
    q, k, v = _round(q), _round(k), _round(v)
    nq, nk = mask.shape[2], mask.shape[3]
    ng = -(-nq // group)
    union = F.pad(mask, (0, 0, 0, ng * group - nq)).reshape(
        b, h, ng, group, nk).any(dim=3)
    kb = k.float().reshape(b, h, nk, BLOCK, d)
    vb = v.float().reshape(b, h, nk, BLOCK, d)
    scale = d ** -0.5
    out = torch.empty((b, h, s, d), dtype=torch.float32, device=q.device)
    kpos = torch.arange(BLOCK, device=q.device)
    lens = [int(x) for x in torch.as_tensor(seqlen).reshape(-1).expand(b)]
    for bi in range(b):
        for g in range(ng):
            r0, r1 = g * group * BLOCK, min((g + 1) * group, nq) * BLOCK
            sel = union[bi, :, g]                               # [H, nk]
            n = int(sel.sum(dim=-1).max())
            ids = torch.sort(torch.where(sel, torch.arange(
                nk, device=q.device), nk + torch.arange(
                nk, device=q.device)), dim=-1).values[:, :n]
            valid = ids < nk                                    # [H, n]
            ids = torch.where(valid, ids, ids - nk)
            hidx = torch.arange(h, device=q.device)[:, None]
            kg = kb[bi][hidx, ids].reshape(h, n * BLOCK, d)
            vg = vb[bi][hidx, ids].reshape(h, n * BLOCK, d)
            logits = torch.matmul(q[bi, :, r0:r1].float(),
                                  kg.transpose(1, 2)) * scale
            keypos = (ids[..., None] * BLOCK + kpos).reshape(h, n * BLOCK)
            ok = valid.repeat_interleave(BLOCK, dim=1) & (keypos < lens[bi])
            if text_amp and text_start_block is not None:
                # a base-2 bias b on the logits is b * ln 2 in base e
                amp = (keypos >= text_start_block * BLOCK).float() \
                    * (text_amp * math.log(2.0))
                qrow = torch.arange(r0, r1, device=q.device) // BLOCK
                video = (qrow < text_start_block).float()
                logits = logits + video[None, :, None] * amp[:, None, :]
            logits = logits.masked_fill(~ok[:, None, :], float("-inf"))
            p = torch.softmax(logits, dim=-1).nan_to_num(0.0)
            out[bi, :, r0:r1] = torch.matmul(p, vg)
    return out


def dense_attention(q, k, v, kv_len=None, chunk: int = 4096):
    """Softmax attention of q [B, H, Sq, D] over k, v [B, H, Skv, D]
    (keys at or past ``kv_len`` [B] masked), float32, ``chunk`` query rows
    at a time."""
    b, h, sq, d = q.shape
    q, k, v = _round(q), _round(k), _round(v)
    out = torch.empty((b, h, sq, d), dtype=torch.float32, device=q.device)
    kpos = torch.arange(k.shape[2], device=q.device)
    for bi in range(b):
        kf, vf = k[bi].float(), v[bi].float()
        for r in range(0, sq, chunk):
            logits = torch.matmul(q[bi, :, r:r + chunk].float(),
                                  kf.transpose(1, 2)) * d ** -0.5
            if kv_len is not None:
                logits = logits.masked_fill(
                    (kpos >= int(kv_len[bi]))[None, None], float("-inf"))
            out[bi, :, r:r + chunk] = torch.matmul(
                torch.softmax(logits, dim=-1), vf)
    return out

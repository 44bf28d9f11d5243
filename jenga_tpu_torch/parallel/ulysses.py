"""Ulysses sequence parallelism: all-to-all between token and head slices.

Port of ``jenga_tpu/parallel/ulysses.py`` (the reference's xfuser/yunchang
Ulysses, ``SeqAllToAll4D`` over NCCL). Outside, activations are token
slices ``[B, S_local, H, D]`` (the package's layout); one
``all_to_all_single`` over the ``sp`` group gives each rank the **full
sequence** for ``H / sp`` heads, so the planner and the block-sparse
kernel run per rank on its local heads exactly as on one device (block
selection is per head), and a second all-to-all gives the token slices
back. RoPE is applied inside, after the gather, with full-sequence tables
(Wan); HunyuanVideo rotates q/k before it (``rope_cos=None``).

``ulysses_joint_attention`` is HunyuanVideo's joint form: the text
stream is whole on every rank, so each rank appends its local heads'
text q/k/v behind the gathered image sequence (then pads to 128, as one
device does), runs the joint attention with full lists for the text
query rows, and all-gathers the text rows' output over the heads, so
that the text stream stays identical on every rank.
"""

from __future__ import annotations

import torch
import torch.distributed as dist
import torch.nn.functional as F

from ..models.layers import apply_rope
from ..ops.flash_attention import attention_bshd
from ..ops.sparse_dispatch import sparse_attention_from_mask
from ..sparse.planner import build_block_mask
from .mesh import all_gather, mesh_dims, shard_sizes

__all__ = ["ulysses_self_attention", "ulysses_joint_attention",
           "tokens_to_heads", "heads_to_tokens", "sp_sizes"]


def sp_sizes(length: int, mesh) -> list[int]:
    """The token counts of the ``sp`` group this rank belongs to (its
    ring's slices, in Ulysses order)."""
    nr, r, nu, _ = mesh_dims(mesh)
    return shard_sizes(length, nr * nu)[r * nu:(r + 1) * nu]


def tokens_to_heads(x, mesh, sizes):
    """[B, S_local, H, D] token slice -> [B, sum(sizes), H/sp, D]: scatter
    the heads, gather the tokens (``sizes``: every rank's slice)."""
    group = mesh.get_group("sp")
    n = len(sizes)
    if n == 1:
        return x
    b, sl, h, d = x.shape
    send = x.reshape(b, sl, n, h // n, d).permute(2, 1, 0, 3, 4) \
        .reshape(n * sl, b, h // n, d).contiguous()
    recv = x.new_empty((sum(sizes), b, h // n, d))
    dist.all_to_all_single(recv, send, output_split_sizes=sizes,
                           input_split_sizes=[sl] * n, group=group)
    return recv.permute(1, 0, 2, 3)


def heads_to_tokens(x, mesh, sizes):
    """[B, sum(sizes), H/sp, D] -> this rank's [B, S_local, H, D]."""
    group = mesh.get_group("sp")
    n = len(sizes)
    if n == 1:
        return x
    b, _, hl, d = x.shape
    sl = sizes[mesh.get_local_rank("sp")]
    send = x.permute(1, 0, 2, 3).contiguous()
    recv = x.new_empty((n * sl, b, hl, d))
    dist.all_to_all_single(recv, send, output_split_sizes=[sl] * n,
                           input_split_sizes=sizes, group=group)
    return recv.reshape(n, sl, b, hl, d).permute(2, 1, 0, 3, 4) \
        .reshape(b, sl, n * hl, d)


def _heads_of(x, mesh):
    """This rank's ``H / sp`` heads of a whole [B, S, H, D] tensor."""
    _, _, nu, u = mesh_dims(mesh)
    hl = x.shape[2] // nu
    return x[:, :, u * hl:(u + 1) * hl]


def _gather_heads(x, mesh):
    """[B, S, H/sp, D] on every rank -> [B, S, H, D] on every rank."""
    nu = mesh_dims(mesh)[2]
    if nu == 1:
        return x
    xt = x.permute(2, 0, 1, 3).contiguous()      # heads first
    out = xt.new_empty((nu * xt.shape[0], *xt.shape[1:]))
    all_gather(out, xt, mesh.get_group("sp"))
    return out.permute(1, 2, 0, 3)


def _attend(q, k, v, *, sparse, dense_kv_len, block_neighbors, top_k,
            p_remain, seqlen, text_start_block, text_blocks, text_amp,
            first_frame_blocks, q_rows, joint_sel):
    """Attention of the local heads over the full sequence, [B, S, Hl, D]
    in and out: the planner and K1 (q_rows 1) or the grouped K1 / K1m
    (``sparse_dispatch``), or D. Sparse needs S a multiple of 128."""
    qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
    if not sparse:
        return attention_bshd(q, k, v, kv_len=dense_kv_len)
    nkb = qt.shape[2] // 128
    tsb = nkb if text_start_block is None else text_start_block
    joint = q_rows > 1 and joint_sel
    mask = build_block_mask(
        qt[:, :, :tsb * 128], kt, top_k=top_k, p_remain=p_remain,
        text_start_block=tsb, text_blocks=text_blocks,
        block_neighbors=block_neighbors,
        first_frame_blocks=first_frame_blocks,
        sel_group=q_rows if joint else 1)
    if tsb < nkb:
        # text query rows attend densely: full index lists
        full = torch.ones((*mask.shape[:2], nkb - tsb, nkb),
                          dtype=torch.bool, device=mask.device)
        mask = torch.cat([mask, full], dim=2)
    out = sparse_attention_from_mask(
        qt, kt, vt, mask, seqlens=seqlen, text_start_block=tsb,
        text_amp=text_amp, q_rows=q_rows, joint=joint)
    return out.transpose(1, 2)


def _carve_kw(sparse=True, block_neighbors=None, top_k=None,
              p_remain=1.0, seqlen=None, text_start_block=None,
              text_blocks=0, text_amp=0.0, first_frame_blocks=0,
              q_rows=1, joint_sel=False):
    if sparse and top_k is None:
        top_k = 1
    return dict(sparse=sparse, block_neighbors=block_neighbors,
                top_k=top_k, p_remain=p_remain, seqlen=seqlen,
                text_start_block=text_start_block, text_blocks=text_blocks,
                text_amp=text_amp, first_frame_blocks=first_frame_blocks,
                q_rows=max(1, int(q_rows)), joint_sel=bool(joint_sel))


def ulysses_self_attention(q, k, v, rope_cos, rope_sin, mesh, *,
                           length: int | None = None, **carve):
    """Sequence-parallel (carved) self-attention: q/k/v ``[B, S_local, H,
    D]`` token slices of a ``length``-token sequence (default: even
    slices) -> the same slices of the output. ``rope_cos``/``rope_sin``
    [length, D/2] are applied after the gather, or None when q/k are
    rotated already. ``carve``: ``sparse`` (default True; dense D
    otherwise, with no ``kv_len``, as JAX's island), ``block_neighbors``,
    ``top_k``, ``p_remain``, ``seqlen`` (valid keys), ``text_start_block``,
    ``text_blocks``, ``text_amp``, ``first_frame_blocks``, ``q_rows``,
    ``joint_sel``. A 1-rank mesh runs the same path with no collective."""
    nr, _, nu, _ = mesh_dims(mesh)
    if length is None:
        length = q.shape[1] * nr * nu
    sizes = sp_sizes(length, mesh)
    q_, k_, v_ = (tokens_to_heads(x, mesh, sizes) for x in (q, k, v))
    if rope_cos is not None:
        q_ = apply_rope(q_, rope_cos, rope_sin)
        k_ = apply_rope(k_, rope_cos, rope_sin)
    out = _attend(q_, k_, v_, dense_kv_len=None, **_carve_kw(**carve))
    return heads_to_tokens(out, mesh, sizes)


def ulysses_joint_attention(q, k, v, jq, jk, jv, mesh, *,
                            length: int | None = None, **carve):
    """HunyuanVideo's joint attention under Ulysses: q/k/v ``[B, S_local,
    H, D]`` image-token slices (rotated) of a ``length``-token stream,
    ``jq``/``jk``/``jv`` the whole text stream ``[B, St, H, D]``, the same
    on every rank. Returns (the image slices' output, the text rows'
    output ``[B, St, H, D]``, identical on every rank). The joint sequence
    ``[image | text]`` is padded to a 128 multiple for the carved kernel;
    ``carve`` as in ``ulysses_self_attention`` with ``seqlen`` the valid
    joint keys, which the dense path (``sparse=False``) masks too."""
    nr, _, nu, _ = mesh_dims(mesh)
    if length is None:
        length = q.shape[1] * nr * nu
    sizes = sp_sizes(length, mesh)
    st = jq.shape[1]
    s = sum(sizes) + st
    pad = -s % 128 if carve.get("sparse", True) else 0
    parts = []
    for x, j in ((q, jq), (k, jk), (v, jv)):
        y = torch.cat([tokens_to_heads(x, mesh, sizes), _heads_of(j, mesh)],
                      dim=1)
        parts.append(F.pad(y, (0, 0, 0, 0, 0, pad)) if pad else y)
    kw = _carve_kw(**carve)
    out = _attend(*parts, dense_kv_len=kw["seqlen"], **kw)
    img = heads_to_tokens(out[:, :sum(sizes)], mesh, sizes)
    return img, _gather_heads(out[:, sum(sizes):s], mesh)

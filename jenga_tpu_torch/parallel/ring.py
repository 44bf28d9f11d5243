"""Ring attention over the sequence-parallel mesh.

Port of ``jenga_tpu/parallel/ring.py`` (the reference's ring path:
``RingComm.send_recv`` K|V rotation and ``update_out_and_lse`` merges).
Each rank holds its token slice of q/k/v; the K|V slices travel around
the ring with ``batch_isend_irecv`` while each rank attends its queries
to the chunk it holds, and the partial results merge through their
log-sum-exps. Joint (text) K|V, whole on every rank, is folded in last,
as the reference's last-step joint handling does.

Each partial is one launch of the dense kernel D with its row
statistics (``dense_attention_forward(..., with_lse=True)``); JAX
computes it with f32 ``einsum``s, whose logits would not fit at real
width (HunyuanVideo 125f at sp=4: 24 x 28,800^2 x 4 B = 80 GB for one
step). On the CPU it is D's plain version. Two conventions meet here:
D's statistics are **base 2** (``log2 sum 2^(s log2 e)``) and mark a row
with no valid key with ``+inf`` (the backward's convention), while the
merge needs the natural log-sum-exp and ``-inf`` for a chunk with no key
(``_partial_attn`` converts both). Empty chunks (uneven slices) are
skipped: they carry no weight.
"""

from __future__ import annotations

import math

import torch
import torch.distributed as dist

from ..ops.flash_attention import dense_attention_forward
from .mesh import mesh_dims, shard_sizes
from .ulysses import heads_to_tokens, sp_sizes, tokens_to_heads

__all__ = ["ring_attention", "ring_ulysses_attention"]

_LN2 = math.log(2.0)


def _partial_attn(q, k, v, scale, kv_len=None):
    """(out, lse) of one K|V chunk: q [B, H, Sq, D], k/v [B, H, Sk, D] ->
    out [B, H, Sq, D] f32 normalized by its own softmax, lse [B, H, Sq]
    the natural log-sum-exp of the scaled logits, -inf for a row with no
    valid key (keys at or past ``kv_len`` [B] are masked)."""
    out, lse2 = dense_attention_forward(q, k, v, sm_scale=scale,
                                        kv_len=kv_len, with_lse=True)
    lse = torch.where(torch.isposinf(lse2), float("-inf"), lse2 * _LN2)
    return out.float(), lse


def _merge(o1, lse1, o2, lse2):
    """Merge two normalized partials through their log-sum-exps; a pair
    with no key at all stays (0, -inf)."""
    m = torch.maximum(lse1, lse2)
    m = torch.where(torch.isfinite(m), m, 0.0)
    w1, w2 = torch.exp(lse1 - m), torch.exp(lse2 - m)
    denom = w1 + w2
    safe = torch.where(denom == 0.0, 1.0, denom)
    out = o1 * (w1 / safe)[..., None] + o2 * (w2 / safe)[..., None]
    return out, torch.where(denom == 0.0, float("-inf"), m + torch.log(safe))


class _Acc:
    """The running (out, lse) of one rank's queries."""

    def __init__(self, q, scale):
        self.q, self.scale = q.contiguous(), scale
        self.out = self.lse = None

    def fold(self, k, v, kv_len=None):
        if self.q.shape[2] == 0 or k.shape[2] == 0:
            return
        o, lse = _partial_attn(self.q, k, v, self.scale, kv_len)
        if self.out is None:
            self.out, self.lse = o, lse
        else:
            self.out, self.lse = _merge(self.out, self.lse, o, lse)

    def result(self, dtype):
        if self.out is None:
            return torch.zeros_like(self.q, dtype=dtype)
        return self.out.to(dtype)


def _rotate(kv, group, recv_len: int):
    """Send this rank's K|V chunk to the next rank of the ring and receive
    the previous rank's (``recv_len`` tokens)."""
    n, me = dist.get_world_size(group), dist.get_rank(group)
    recv = kv.new_empty((*kv.shape[:2], recv_len, kv.shape[3]))
    ops = [dist.P2POp(dist.isend, kv, dist.get_global_rank(
               group, (me + 1) % n), group),
           dist.P2POp(dist.irecv, recv, dist.get_global_rank(
               group, (me - 1) % n), group)]
    for work in dist.batch_isend_irecv(ops):
        work.wait()
    return recv


def _ring(acc, kt, vt, group, chunk_lens, me):
    """Attend ``acc``'s queries to every chunk of the ring, starting with
    this rank's own; ``chunk_lens[i]`` is rank i's chunk length."""
    n = len(chunk_lens)
    d = kt.shape[-1]
    kv = torch.cat([kt, vt], dim=-1).contiguous()
    for step in range(n):
        if step:
            kv = _rotate(kv, group, chunk_lens[(me - step) % n])
        acc.fold(kv[..., :d], kv[..., d:])


def _joint_len(joint_kv_len, b, device):
    if joint_kv_len is None:
        return None
    return torch.as_tensor(joint_kv_len, device=device).to(
        torch.int32).reshape(-1).expand(b)


def ring_attention(q, k, v, mesh, *, axis: str = "sp", joint_k=None,
                   joint_v=None, sm_scale=None, joint_kv_len=None,
                   length: int | None = None):
    """Sequence-sliced dense attention by K|V rotation over the mesh axis.

    q/k/v: ``[B, S_local, H, D]`` token slices over ``axis`` of a
    ``length``-token sequence (default: even slices); joint_k/joint_v:
    optional ``[B, S_txt, H, D]`` text K|V, the same on every rank,
    appended for every query, with ``joint_kv_len`` [B] valid joint keys
    (padded text masked). Returns the slices of the output in q's
    dtype."""
    group = mesh.get_group(axis)
    n, me = dist.get_world_size(group), dist.get_rank(group)
    if length is None:
        length = q.shape[1] * n
    scale = sm_scale if sm_scale is not None else q.shape[-1] ** -0.5
    qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
    acc = _Acc(qt, scale)
    _ring(acc, kt, vt, group, shard_sizes(length, n), me)
    if joint_k is not None:
        acc.fold(joint_k.transpose(1, 2), joint_v.transpose(1, 2),
                 _joint_len(joint_kv_len, q.shape[0], q.device))
    return acc.result(q.dtype).transpose(1, 2)


def ring_ulysses_attention(q, k, v, mesh, *, ring_axis: str = "ring",
                           ulysses_axis: str = "sp", joint_k=None,
                           joint_v=None, sm_scale=None, joint_kv_len=None,
                           length: int | None = None):
    """2-D sequence parallelism, ``world == ring x ulysses``: tokens are
    sliced over both axes (ring-major); an all-to-all over the Ulysses
    axis trades the slice for ``H / ulysses`` heads over this ring
    index's tokens, K|V rotate around the ring axis as in
    ``ring_attention``, the joint K|V is folded in last on the local heads
    (the reference's per-rank text head slice), and a second all-to-all
    gives the token slices back. Dense, as the reference's ring path. H
    must be a multiple of the Ulysses size."""
    names = mesh.mesh_dim_names
    nu = mesh.shape[names.index(ulysses_axis)]
    b, _, h, d = q.shape
    if h % nu:
        raise ValueError(f"heads ({h}) must divide the ulysses axis ({nu})")
    nr, r, _, u = mesh_dims(mesh)
    if length is None:
        length = q.shape[1] * nr * nu
    scale = sm_scale if sm_scale is not None else d ** -0.5
    sizes = shard_sizes(length, nr * nu)
    ring_lens = [sum(sizes[i * nu:(i + 1) * nu]) for i in range(nr)]
    local = sp_sizes(length, mesh)
    qt, kt, vt = (tokens_to_heads(x, mesh, local).transpose(1, 2)
                  for x in (q, k, v))
    acc = _Acc(qt, scale)
    _ring(acc, kt, vt, mesh.get_group(ring_axis), ring_lens, r)
    if joint_k is not None:
        hl = h // nu
        acc.fold(joint_k[:, :, u * hl:(u + 1) * hl].transpose(1, 2),
                 joint_v[:, :, u * hl:(u + 1) * hl].transpose(1, 2),
                 _joint_len(joint_kv_len, b, q.device))
    out = acc.result(q.dtype).transpose(1, 2)
    return heads_to_tokens(out, mesh, local)

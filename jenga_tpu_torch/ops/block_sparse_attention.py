"""Block-sparse attention over per-group KV block lists: the CUDA kernel's
wrapper, its plain torch version and its launch counter.

The kernel (``csrc/block_sparse_attn.cu``) replaces the JAX package's
Pallas TPU kernels ``_kernel_grouped`` and the per-row ``_kernel``:
``q_rows`` adjacent 128-row query blocks share one ascending list of
128-key blocks (``q_rows == 1`` is the per-row kernel). Without
``members`` every row of a group attends the whole list (the all-member,
joint-selection mode); with ``members`` (int32 words aligned with the
list, ``q_rows <= 8``) query block ``i`` attends only the listed blocks
whose bit ``i % q_rows`` is set (the membership mode, ``all_member=False``
in JAX). It is built at first use by ``cuda_build.build_library``
(``nvcc`` for ``sm_90a``, a plain C interface loaded with ``ctypes``).

``block_sparse_attention`` launches the kernel for CUDA tensors and uses
the plain version only for CPU tensors; there is no fallback between the
two. ``block_sparse_attention.launches`` counts all-member launches and
``block_sparse_attention.member_launches`` membership-mode launches.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from .. import obs
from ..sparse.planner import MAX_MEMBER_ROWS
from .attention_ref import block_sparse_attention_reference
from .cuda_build import CSRC, build_library

__all__ = ["block_sparse_attention", "block_sparse_attention_plain",
           "lists_to_mask", "max_key_norms", "build_kernel", "KERNEL_SOURCE"]

_BLOCK = 128
_HEAD_DIM = 128
KERNEL_SOURCE = CSRC / "block_sparse_attn.cu"


@functools.lru_cache(maxsize=1)
def build_kernel() -> ctypes.CDLL:
    """Build (once per source hash) and load the kernel library."""
    lib = build_library(KERNEL_SOURCE)
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.bsa_forward.argtypes = [p, p, p, p, p, p, p, p, p, i, i, i, i, i, i,
                                i, i, f, f, i, p]
    lib.bsa_forward.restype = ctypes.c_int
    lib.bsa_error_string.argtypes = [ctypes.c_int]
    lib.bsa_error_string.restype = ctypes.c_char_p
    return lib


def max_key_norms(k):
    """[B*H] f32 max key L2 norm per (batch, head): the fixed-max
    epilogue's Cauchy-Schwarz bound input (``_max_key_norms`` in the JAX
    package, an XLA op there too)."""
    b, h, skv, d = k.shape
    return torch.linalg.vector_norm(k.float(), dim=-1).amax(dim=-1) \
        .reshape(b * h).contiguous()


def lists_to_mask(indices, counts, q_rows: int, nqb: int, members=None):
    """Per-group lists -> the per-row one-hot mask [B, H, nqb, nkb] they
    realize: every row of a group attends the group's list, or with
    ``members`` only the listed blocks whose bit for the row is set."""
    nkb = indices.shape[-1]
    pos = torch.arange(nkb, device=indices.device)
    listed = pos < counts[..., None].long()             # [B, H, G, nkb]
    row = torch.arange(q_rows, device=indices.device)[:, None]
    if members is None:
        sel = listed[..., None, :].expand(*listed.shape[:-1], q_rows, nkb)
    else:
        sel = listed[..., None, :] & (
            (members[..., None, :] >> row) & 1).bool()  # [B, H, G, q_rows, nkb]
    hits = torch.zeros(sel.shape, dtype=torch.int32, device=indices.device)
    hits.scatter_add_(-1, indices[..., None, :].expand(sel.shape).long(),
                      sel.int())
    return (hits > 0).flatten(2, 3)[:, :, :nqb]


def block_sparse_attention_plain(q, k, v, indices, counts, seqlens, *,
                                 q_rows: int = 1, members=None,
                                 sm_scale=None, text_amp: float = 0.0,
                                 text_start_block: int = 0,
                                 fixed_max: bool = True):
    """The kernel's plain version: the oracle over the mask the lists (and
    membership words) realize. ``fixed_max`` only changes the kernel's
    rounding (both epilogues compute the same softmax), so it is accepted
    and unused."""
    del fixed_max
    mask = lists_to_mask(indices, counts, q_rows, q.shape[2] // _BLOCK,
                         members)
    return block_sparse_attention_reference(
        q, k, v, mask, sm_scale=sm_scale, text_amp=text_amp,
        text_start_block=text_start_block, seqlen=seqlens)


def _check_operands(q, k, v, indices, counts, members, seqlens, q_rows):
    if not (q.is_cuda and k.is_cuda and v.is_cuda and indices.is_cuda
            and counts.is_cuda and seqlens.is_cuda
            and (members is None or members.is_cuda)):
        raise ValueError("block_sparse_attention: every operand must lie on "
                         "the same CUDA device")
    for name, x in (("q", q), ("k", k), ("v", v)):
        if x.dtype != torch.bfloat16:
            raise TypeError(f"block_sparse_attention: {name} must be "
                            f"bfloat16, got {x.dtype} (on CUDA build the "
                            f'model with dtype="bfloat16")')
    b, h, s, d = q.shape
    skv = k.shape[2]
    if k.shape != (b, h, skv, d) or v.shape != k.shape:
        raise ValueError(f"shape mismatch q{tuple(q.shape)} "
                         f"k{tuple(k.shape)} v{tuple(v.shape)}")
    if s % _BLOCK or skv % _BLOCK:
        raise ValueError(f"sequence lengths must be multiples of {_BLOCK}, "
                         f"got {s=} {skv=}")
    if d > _HEAD_DIM:
        raise ValueError(f"head dim {d} > {_HEAD_DIM} is not supported")
    nkb = skv // _BLOCK
    ngroups = -(-(s // _BLOCK) // q_rows)
    if indices.shape != (b, h, ngroups, nkb) or indices.dtype != torch.int32:
        raise ValueError(f"indices must be int32 {(b, h, ngroups, nkb)}, "
                         f"got {indices.dtype} {tuple(indices.shape)}")
    if counts.shape != (b, h, ngroups) or counts.dtype != torch.int32:
        raise ValueError(f"counts must be int32 {(b, h, ngroups)}, got "
                         f"{counts.dtype} {tuple(counts.shape)}")
    if members is not None:
        if members.shape != indices.shape or members.dtype != torch.int32:
            raise ValueError(f"members must be int32 {(b, h, ngroups, nkb)}"
                             f", got {members.dtype} "
                             f"{tuple(members.shape)}")
        if not 1 <= q_rows <= MAX_MEMBER_ROWS:
            raise ValueError(f"membership words cover at most "
                             f"{MAX_MEMBER_ROWS} rows, got {q_rows=}")
    if seqlens.shape != (b,) or seqlens.dtype != torch.int32:
        raise ValueError(f"seqlens must be int32 ({b},), got "
                         f"{seqlens.dtype} {tuple(seqlens.shape)}")
    for name, x in (("indices", indices), ("counts", counts),
                    ("members", members), ("seqlens", seqlens)):
        if x is not None and not x.is_contiguous():
            raise ValueError(f"{name} must be contiguous")


def block_sparse_attention(q, k, v, indices, counts, seqlens, *,
                           q_rows: int = 1, members=None, sm_scale=None,
                           text_amp: float = 0.0, text_start_block: int = 0,
                           fixed_max: bool = True):
    """Block-sparse attention, [B, H, S, D] operands (S, Skv multiples of
    128), ``indices`` int32 [B, H, ngroups, nkb] ascending block ids of
    which the first ``counts`` [B, H, ngroups] are read, ``seqlens`` int32
    [B] valid key counts. Query block ``i`` reads group ``i // q_rows``;
    ``members`` (None, or int32 like ``indices``) restricts it to the
    listed blocks whose bit ``i % q_rows`` is set. Returns [B, H, S, D] in
    q's dtype.

    CPU tensors take the plain version; CUDA tensors launch the kernel or
    raise. The kernel takes bfloat16 q, k and v with a head dim of at most
    128 (a ``TypeError`` or ``ValueError`` otherwise): a model run on the
    card must be built with ``dtype="bfloat16"``, which every published
    config has."""
    if sm_scale is None:
        sm_scale = q.shape[-1] ** -0.5
    if not q.is_cuda:
        return block_sparse_attention_plain(
            q, k, v, indices, counts, seqlens, q_rows=q_rows,
            members=members, sm_scale=sm_scale, text_amp=text_amp,
            text_start_block=text_start_block, fixed_max=fixed_max)
    _check_operands(q, k, v, indices, counts, members, seqlens, q_rows)
    b, h, s, d = q.shape
    skv = k.shape[2]
    with obs.span("layout"):
        if d < _HEAD_DIM:
            # zero q/k pad lanes leave the logits unchanged; zero v pad
            # lanes are sliced off (sm_scale is already fixed from the
            # true d)
            pad = (0, _HEAD_DIM - d)
            q, k, v = (torch.nn.functional.pad(x, pad) for x in (q, k, v))
        q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
        for x in (q, k, v):
            if x.data_ptr() % 16:
                raise ValueError("block_sparse_attention: operands must be "
                                 "16-byte aligned")
        maxk = max_key_norms(k)
    out = torch.empty_like(q)
    lib = build_kernel()
    err = lib.bsa_forward(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        indices.data_ptr(), counts.data_ptr(),
        None if members is None else members.data_ptr(), seqlens.data_ptr(),
        maxk.data_ptr(), b * h, h, s, skv, skv // _BLOCK,
        indices.shape[2], int(q_rows), int(text_start_block),
        float(sm_scale), float(text_amp), int(bool(fixed_max)),
        torch.cuda.current_stream(q.device).cuda_stream)
    if err != 0:
        raise RuntimeError("block_sparse_attention launch failed: "
                           + lib.bsa_error_string(err).decode())
    if members is None:
        block_sparse_attention.launches += 1
    else:
        block_sparse_attention.member_launches += 1
    return out[..., :d] if d < _HEAD_DIM else out


block_sparse_attention.launches = 0
block_sparse_attention.member_launches = 0

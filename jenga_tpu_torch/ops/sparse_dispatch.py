"""Forward dispatch from a one-hot block mask to the block-sparse kernel.

Port of the forward half of ``jenga_tpu/ops/sparse_autodiff.py``
(``sparse_attention_from_mask`` and ``_effective_mask``). In joint mode
(planner ``sel_group == q_rows``) every row of a group attends the union
of the group's rows, so rows in a video/text boundary group, and padded
rows, attend a superset of their own selection, exactly as the JAX
``grouped_attention_from_mask`` does. Without joint selection and with
``q_rows > 1`` (``--no-joint-sel``) each group's union list carries
membership words and every row attends exactly its own selection. The
recompute backward is not ported: this package serves and does not train.
"""

from __future__ import annotations

import torch

from ..sparse.planner import (mask_to_block_lists,
                              mask_to_block_lists_grouped)
from .block_sparse_attention import block_sparse_attention

__all__ = ["sparse_attention_from_mask", "block_lists_from_mask",
           "effective_mask"]


def _pad_rows(mask, q_rows: int):
    """Empty rows up to a ``q_rows`` multiple (they are no query block)."""
    nqb = mask.shape[2]
    return torch.nn.functional.pad(mask, (0, 0, 0, -nqb % q_rows))


def _group_union(mask, q_rows: int):
    m = _pad_rows(mask, q_rows)
    b, h, nb_pad, nkb = m.shape
    return m.reshape(b, h, nb_pad // q_rows, q_rows, nkb).any(dim=3)


def effective_mask(mask, q_rows: int, joint: bool):
    """The per-row pattern the kernel realizes: joint mode expands each
    group's union back over its member rows; every other mode is exact."""
    if not (joint and q_rows > 1):
        return mask
    nqb = mask.shape[2]
    return _group_union(mask, q_rows).repeat_interleave(
        q_rows, dim=2)[:, :, :nqb]


def block_lists_from_mask(mask, q_rows: int, joint: bool = False):
    """The kernel's (indices, counts, members) for a one-hot mask: one
    list per row (``q_rows == 1``), or per group of ``q_rows`` rows (their
    union), with ``members`` None in joint mode (every row attends the
    union) and the groups' membership words otherwise."""
    if q_rows == 1:
        return (*mask_to_block_lists(mask), None)
    if joint:
        return (*mask_to_block_lists(_group_union(mask, q_rows)), None)
    return mask_to_block_lists_grouped(_pad_rows(mask, q_rows), q_rows)


def sparse_attention_from_mask(qt, kt, vt, mask, *, seqlens=None,
                               text_start_block: int = 0,
                               text_amp: float = 0.0, q_rows: int = 1,
                               joint: bool = False):
    """Block-sparse attention from a one-hot mask. ``[B, H, S, D]``
    operands, ``[B, H, S//128, Skv//128]`` bool mask, ``seqlens`` None or
    [B] valid key counts."""
    b = qt.shape[0]
    skv = kt.shape[2]
    if seqlens is None:
        sl = torch.full((b,), skv, dtype=torch.int32, device=qt.device)
    else:
        sl = torch.as_tensor(seqlens, device=qt.device).to(
            torch.int32).reshape(-1).expand(b).contiguous()
    q_rows = max(1, int(q_rows))
    indices, counts, members = block_lists_from_mask(mask, q_rows, joint)
    return block_sparse_attention(
        qt, kt, vt, indices, counts, sl, q_rows=q_rows, members=members,
        text_amp=text_amp, text_start_block=text_start_block)

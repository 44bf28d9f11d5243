"""Block-sparse attention from a one-hot block mask, differentiable in q,
k and v.

Port of ``jenga_tpu/ops/sparse_autodiff.py`` (``sparse_attention_from_mask``
and ``_effective_mask``). In joint mode (planner ``sel_group == q_rows``)
every row of a group attends the union of the group's rows, so rows in a
video/text boundary group, and padded rows, attend a superset of their own
selection, exactly as the JAX ``grouped_attention_from_mask`` does.
Without joint selection and with ``q_rows > 1`` (``--no-joint-sel``) each
group's union list carries membership words and every row attends exactly
its own selection.

The forward launches the block-sparse kernel (K1, K1m or K2). Under
autograd the backward recomputes through the dense oracle
(``ops/attention_ref.py``) masked by the pattern the forward realized
(``effective_mask``), one (batch, head) slice at a time: each slice's
logits are built, differentiated and freed before the next, so the memory
is O(S * Skv) for one head, not for all of them (JAX ``lax.map``s a
``vjp`` per slice the same way). The gradients are exact for the
masked-softmax attention the kernel computes; the mask and the key
lengths get none (the selection is piecewise constant in q and k).
"""

from __future__ import annotations

import torch

from .. import obs
from ..sparse.planner import (mask_to_block_lists,
                              mask_to_block_lists_grouped)
from .attention_ref import block_sparse_attention_reference
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


@obs.spanned("planner")
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


def _forward(qt, kt, vt, mask, sl, text_start_block, text_amp, q_rows,
             joint):
    indices, counts, members = block_lists_from_mask(mask, q_rows, joint)
    return block_sparse_attention(
        qt, kt, vt, indices, counts, sl, q_rows=q_rows, members=members,
        text_amp=text_amp, text_start_block=text_start_block)


def _slice_grads(q, k, v, mask, g, seqlen, text_start_block, text_amp):
    """(dq, dk, dv) of one (batch, head) slice [1, 1, S, D] through the
    oracle: its logits live only inside this call."""
    with torch.enable_grad():
        q, k, v = (x.detach().requires_grad_() for x in (q, k, v))
        out = block_sparse_attention_reference(
            q, k, v, mask, text_amp=text_amp,
            text_start_block=text_start_block, seqlen=seqlen)
        return torch.autograd.grad(out, (q, k, v), g.to(out.dtype))


class _SparseAttention(torch.autograd.Function):
    """The kernel forward, the per-slice recompute backward."""

    @staticmethod
    def forward(ctx, qt, kt, vt, mask, sl, text_start_block, text_amp,
                q_rows, joint):
        ctx.save_for_backward(qt, kt, vt, mask, sl)
        ctx.static = (text_start_block, text_amp, q_rows, joint)
        return _forward(qt, kt, vt, mask, sl, text_start_block, text_amp,
                        q_rows, joint)

    @staticmethod
    def backward(ctx, g):
        qt, kt, vt, mask, sl = ctx.saved_tensors
        tsb, amp, q_rows, joint = ctx.static
        eff = effective_mask(mask, q_rows, joint)
        dq, dk, dv = (torch.empty_like(x) for x in (qt, kt, vt))
        b, h = qt.shape[:2]
        for bi in range(b):
            for hi in range(h):
                s1 = (slice(bi, bi + 1), slice(hi, hi + 1))
                dq[s1], dk[s1], dv[s1] = _slice_grads(
                    qt[s1], kt[s1], vt[s1], eff[s1], g[s1],
                    sl[bi:bi + 1], tsb, amp)
        return dq, dk, dv, None, None, None, None, None, None


def sparse_attention_from_mask(qt, kt, vt, mask, *, seqlens=None,
                               text_start_block: int = 0,
                               text_amp: float = 0.0, q_rows: int = 1,
                               joint: bool = False):
    """Block-sparse attention from a one-hot mask. ``[B, H, S, D]``
    operands, ``[B, H, S//128, Skv//128]`` bool mask, ``seqlens`` None or
    [B] valid key counts. Differentiable in q, k and v (the recompute
    backward above)."""
    b = qt.shape[0]
    skv = kt.shape[2]
    with obs.span("layout"):
        if seqlens is None:
            sl = torch.full((b,), skv, dtype=torch.int32, device=qt.device)
        else:
            sl = torch.as_tensor(seqlens, device=qt.device).to(
                torch.int32).reshape(-1).expand(b).contiguous()
    static = (int(text_start_block), float(text_amp), max(1, int(q_rows)),
              bool(joint))
    if torch.is_grad_enabled() and any(x.requires_grad
                                       for x in (qt, kt, vt)):
        return _SparseAttention.apply(qt, kt, vt, mask, sl, *static)
    return _forward(qt, kt, vt, mask, sl, *static)

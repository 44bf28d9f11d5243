"""Library yardsticks for the port's kernels: one PyTorch call that
computes the same function on the same operands, timed beside the kernel
and used on no path of the port.

  K1, K1m, K2  ``flex_attention`` under ``torch.compile`` with a
               ``BlockMask`` built from the kernel's lists (blocks wholly
               below seqlen as full blocks, the block that seqlen cuts as
               a partial one with a ``kv_idx < seqlen`` mask_mod) and
               text_amp as a ``score_mod`` (``amp * ln 2``: the kernel's
               logits are base 2)
  D, P4        ``scaled_dot_product_attention`` on the flash backend
  P3           ``mean(dtype=float32)`` over each 128-token block

``chip_smoke.py`` and the probe tools time them; this module has no entry
point of its own.
"""

from __future__ import annotations

import functools
import math

import torch

from ..ops.block_sparse_attention import lists_to_mask
from ..sparse.planner import mask_to_block_lists

__all__ = ["flex_block_sparse", "sdpa_flash", "torch_block_mean"]

_BLOCK = 128


def sdpa_flash(q, k, v):
    """``F.scaled_dot_product_attention`` on the flash backend."""
    from torch.nn.attention import SDPBackend, sdpa_kernel
    with sdpa_kernel(SDPBackend.FLASH_ATTENTION):
        return torch.nn.functional.scaled_dot_product_attention(q, k, v)


def torch_block_mean(x):
    """f32 mean of each whole 128-token block, one torch call."""
    b, h, s, d = x.shape
    nb = s // _BLOCK
    return x[:, :, :nb * _BLOCK].reshape(b, h, nb, _BLOCK, d).mean(
        3, dtype=torch.float32)


@functools.cache
def _compiled_flex():
    from torch.nn.attention.flex_attention import flex_attention
    return torch.compile(flex_attention, dynamic=False)


def flex_block_sparse(q, k, v, indices, counts, seqlens, *, q_rows=1,
                      members=None, text_amp=0.0, text_start_block=0):
    """A zero-argument callable running ``flex_attention`` (compiled once
    per process, and again for each new shape) over the attention the
    kernel's lists realize."""
    from torch.nn.attention.flex_attention import BlockMask
    nqb, nkb = q.shape[2] // _BLOCK, k.shape[2] // _BLOCK
    rows = lists_to_mask(indices, counts, q_rows, nqb, members)
    whole = (torch.arange(1, nkb + 1, device=q.device) * _BLOCK
             <= seqlens[:, None])[:, None, None]    # [B, 1, 1, nkb]
    part_idx, part_cnt = mask_to_block_lists(rows & ~whole)
    full_idx, full_cnt = mask_to_block_lists(rows & whole)
    sl = seqlens.long()

    def mask_mod(b, h, q_idx, kv_idx):
        return kv_idx < sl[b]

    block_mask = BlockMask.from_kv_blocks(
        part_cnt, part_idx, full_cnt, full_idx, BLOCK_SIZE=_BLOCK,
        mask_mod=mask_mod, seq_lengths=(q.shape[2], k.shape[2]))
    score_mod = None
    if text_amp != 0.0:
        bias = text_amp * math.log(2.0)
        tsb = int(text_start_block)

        def score_mod(score, b, h, q_idx, kv_idx):
            amp = (q_idx // _BLOCK < tsb) & (kv_idx // _BLOCK >= tsb)
            return torch.where(amp, score + bias, score)

    flex = _compiled_flex()
    return lambda: flex(q, k, v, score_mod=score_mod, block_mask=block_mask)


"""Dense torch oracle for block-sparse attention (tests + the kernel's
plain version).

Port of ``jenga_tpu/ops/attention_ref.py``: logits in exp2 space
(``qk * sm_scale * log2(e)``), the text amplitude bias added to the base-2
logits of text key blocks for video query rows, keys at or past the
per-sample ``seqlen`` masked, and a row with no selected key gives 0, not
NaN. It materializes one (batch, head) slice of logits at a time, so its
memory is O(S * Skv) per head, not per batch.
"""

from __future__ import annotations

import torch

_LOG2E = 1.4426950408889634
_LN2 = 0.6931471805599453
_BLOCK = 128

__all__ = ["block_sparse_attention_reference"]


def block_sparse_attention_reference(q, k, v, mask, *, sm_scale=None,
                                     text_amp: float = 0.0,
                                     text_start_block: int | None = None,
                                     seqlen=None, q_start_block: int = 0):
    """``q, k, v`` [B, H, S, D] (S a multiple of 128), ``mask`` bool
    [B, H, S//128, Skv//128]. ``seqlen``: None, an int or a [B] tensor of
    valid key counts. ``q`` may be the rows of a longer query from block
    ``q_start_block`` on (it places the text_amp boundary). Returns
    [B, H, S, D] in q's dtype."""
    b, h, s, d = q.shape
    skv = k.shape[2]
    if sm_scale is None:
        sm_scale = d ** -0.5
    if seqlen is None:
        seqlen = skv
    sl = torch.as_tensor(seqlen, dtype=torch.int64,
                         device=q.device).reshape(-1).expand(b)
    kpos = torch.arange(skv, device=q.device)
    bias = None
    if text_amp != 0.0 and text_start_block is not None:
        qblk = torch.arange(s, device=q.device) // _BLOCK + q_start_block
        amp = ((qblk[:, None] < text_start_block)
               & (kpos[None, :] // _BLOCK >= text_start_block))
        bias = torch.where(amp, text_amp, 0.0)
    out = torch.empty_like(q)
    for bi in range(b):
        kvalid = kpos < sl[bi]
        for hi in range(h):
            logits = (q[bi, hi].float() @ k[bi, hi].float().T) \
                * (sm_scale * _LOG2E)
            if bias is not None:
                logits = logits + bias
            tok = mask[bi, hi].repeat_interleave(_BLOCK, 0) \
                .repeat_interleave(_BLOCK, 1) & kvalid[None, :]
            logits = logits.masked_fill(~tok, float("-inf"))
            # softmax base 2 == softmax of (logits * ln 2)
            p = torch.softmax(logits * _LN2, dim=-1)
            p = torch.nan_to_num(p, nan=0.0)  # rows with no selected key
            out[bi, hi] = (p @ v[bi, hi].float()).to(q.dtype)
    return out

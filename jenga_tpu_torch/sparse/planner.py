"""Attention carving planner: data-dependent block selection in torch.

Port of ``jenga_tpu/sparse/planner.py`` (``build_block_mask`` and
``mask_to_block_lists``). Per attention layer and denoise step it

  1. mean-pools Q and K per 128-token block (and, with ``sel_group > 1``,
     pools the query blocks again per group of ``sel_group`` rows),
  2. scores pooled query blocks against pooled key blocks,
  3. takes the softmax over *video* key blocks and keeps the top-p set
     with a top-k floor (``probs >= kth``, the JAX rule; ties may select
     a block more, never fewer),
  4. ORs in the 26-neighbourhood block adjacency (a group-level union in
     joint mode),
  5. forces the text (condition) blocks on, and with
     ``first_frame_blocks`` makes the first-frame blocks mutually visible
     (Wan; a group-level union in joint mode).

The JAX package's 1024-aligned packed rows (``packed_row_size``,
``pack_block_lists*``) exist for the TPU's SMEM DMA tiling and are not
ported: the CUDA kernel takes plain ``[B, H, ngroups, nkb]`` index lists
with ``[B, H, ngroups]`` counts, and for the membership mode
(``mask_to_block_lists_grouped``, the content of
``pack_block_lists_grouped``) ``[B, H, ngroups, nkb]`` membership words
aligned with the ids.
"""

from __future__ import annotations

import torch

__all__ = ["build_block_mask", "mask_to_block_lists",
           "mask_to_block_lists_grouped"]

MAX_MEMBER_ROWS = 8     # a membership word covers at most 8 rows


def _pool(x, nb: int, block_size: int):
    b, h, _, d = x.shape
    xb = x[:, :, :nb * block_size].reshape(b, h, nb, block_size, d)
    if x.dtype == torch.bfloat16:
        # the JAX bf16 branch pools as a matmul with f32 accumulation
        return xb.sum(dim=3, dtype=torch.float32) * (1.0 / block_size)
    # f32 inputs: the exact elementwise mean (bit-parity with JAX)
    return xb.float().mean(dim=3)


def build_block_mask(q, k, *, top_k: int, p_remain: float,
                     text_start_block: int, text_blocks: int,
                     block_neighbors=None, block_size: int = 128,
                     first_frame_blocks: int = 0, sel_group: int = 1):
    """One-hot selection mask ``[B, H, nqb, nkb]`` (bool).

    ``q`` [B, H, nqb*block, D] video queries, ``k`` [B, H, Skv, D] padded
    keys, ``block_neighbors`` an [nb, nb] bool tensor over video blocks (or
    None). Semantics are ``jenga_tpu.sparse.planner.build_block_mask``'s.
    """
    b, h, sq, d = q.shape
    nqb = sq // block_size
    nkb = k.shape[2] // block_size
    q_pool = _pool(q, nqb, block_size)
    k_pool = _pool(k, nkb, block_size)

    g = max(1, int(sel_group))
    ngq = -(-nqb // g)
    if g > 1:
        # group-pool; a ragged tail group averages only its real rows
        pad = ngq * g - nqb
        qp = torch.nn.functional.pad(q_pool, (0, 0, 0, pad))
        cnt = (nqb - torch.arange(ngq, device=q.device) * g).clamp(1, g) \
            .float()
        q_pool = qp.reshape(b, h, ngq, g, d).sum(dim=3) / cnt[:, None]

    scores = torch.einsum("bhqd,bhkd->bhqk", q_pool, k_pool) * (d ** -0.5)

    video_scores = scores[..., :text_start_block]
    probs = torch.softmax(video_scores, dim=-1)
    sorted_probs = torch.sort(probs, dim=-1, descending=True).values
    cumsum = torch.cumsum(sorted_probs, dim=-1)
    needed = (cumsum <= p_remain).sum(dim=-1) + 1
    needed = needed.clamp(min=top_k).clamp(max=text_start_block)
    kth = torch.gather(sorted_probs, -1, needed[..., None] - 1)
    video_mask = probs >= kth

    if block_neighbors is not None:
        neighbor = torch.as_tensor(block_neighbors, device=q.device)[
            :nqb, :text_start_block].bool()
        if g > 1:
            # group-level adjacency: union of the member rows' neighbours
            neighbor = torch.nn.functional.pad(
                neighbor, (0, 0, 0, ngq * g - nqb))
            neighbor = neighbor.reshape(ngq, g, -1).any(dim=1)
        video_mask = video_mask | neighbor[None, None]

    if first_frame_blocks > 0 and g > 1:
        # every group holding a first-frame row sees all first-frame blocks
        ff_rows = -(-first_frame_blocks // g)
        video_mask[:, :, :ff_rows, :first_frame_blocks] = True

    if g > 1:
        video_mask = video_mask.repeat_interleave(g, dim=2)[:, :, :nqb]

    mask = torch.zeros((b, h, nqb, nkb), dtype=torch.bool, device=q.device)
    mask[..., :text_start_block] = video_mask

    if first_frame_blocks > 0 and g == 1:
        mask[:, :, :first_frame_blocks, :first_frame_blocks] = True

    if text_blocks > 0:
        hi = min(text_start_block + text_blocks, nkb)
        mask[..., text_start_block:hi] = True
    return mask


def mask_to_block_lists(mask):
    """One-hot mask [..., nkb] -> (indices int32 [..., nkb], counts int32
    [...]). ``indices[..., :counts]`` are the selected block ids in
    ascending order; the tail holds valid ids the kernel never reads."""
    nkb = mask.shape[-1]
    cols = torch.arange(nkb, dtype=torch.int32, device=mask.device)
    keys = torch.where(mask, cols, cols + nkb)
    order = torch.sort(keys, dim=-1).values
    indices = torch.where(order < nkb, order, order - nkb)
    counts = mask.sum(dim=-1, dtype=torch.int32)
    return indices.contiguous(), counts.contiguous()


def mask_to_block_lists_grouped(mask, group_q: int):
    """One union list per group of ``group_q`` query rows, with membership
    words: (indices, counts, members), int32 ``[B, H, nqb/group_q, nkb]``,
    ``[B, H, nqb/group_q]`` and ``[B, H, nqb/group_q, nkb]``.

    ``indices[..., :counts]`` are the union's block ids in ascending order
    (the tail the other ids, ascending); ``members[..., j]`` has bit r set
    when row ``group * group_q + r`` selected ``indices[..., j]`` (0 in the
    tail). Same content as JAX's ``pack_block_lists_grouped`` (its ids and
    membership halves), including its one composite-key sort."""
    b, h, nqb, nkb = mask.shape
    if nqb % group_q:
        raise ValueError(f"query blocks ({nqb}) must divide into groups "
                         f"of {group_q}")
    if group_q > MAX_MEMBER_ROWS:
        raise ValueError(f"membership words hold at most {MAX_MEMBER_ROWS} "
                         f"rows per group, got {group_q}")
    g = mask.reshape(b, h, nqb // group_q, group_q, nkb)
    union = g.any(dim=3)
    weights = 1 << torch.arange(group_q, dtype=torch.int32,
                                device=mask.device)
    memb = (g.int() * weights[:, None]).sum(dim=3, dtype=torch.int32)
    cols = torch.arange(nkb, dtype=torch.int32, device=mask.device)
    keys = torch.where(union, cols, cols + nkb)
    packed = torch.sort((keys << 8) | memb, dim=-1).values
    sorted_keys = packed >> 8
    indices = torch.where(sorted_keys < nkb, sorted_keys, sorted_keys - nkb)
    counts = union.sum(dim=-1, dtype=torch.int32)
    return indices.contiguous(), counts.contiguous(), \
        (packed & 0xFF).contiguous()

"""The aligned-attention init: each self-attention's key projection tied
to its query projection.

Follows ``bench.py``'s ``tie_qk_projections`` (HunyuanVideo: the k rows
of the double blocks' ``img_qkv`` and of the single blocks' ``linear1``
set equal to the q rows) and ``tools/bench_wan.py``'s ``_tie_qk`` (Wan:
each block's ``self_attn.k`` set equal to ``self_attn.q``), copied, not
imported, for weights in the torch layout [out, in]. Trained DiTs have
aligned q and k, which is why their attention is local in RoPE position;
independent random projections erase that, and the planner then selects
nearly every block. The timed work per selected block is unchanged; the
selection becomes the one trained checkpoints make. The q/k norm scales
are tied with them, so that q and k stay equal up to RoPE.
"""

from __future__ import annotations


def tie_wan(group: dict) -> dict:
    """Tie ``blocks.<i>.self_attn.k`` (and its norm) to ``.q`` in place."""
    for name in [n for n in group if ".self_attn.q." in n]:
        group[name.replace(".q.", ".k.")].copy_(group[name])
    for name in [n for n in group if n.endswith(".self_attn.norm_q")]:
        group[name[:-1] + "k"].copy_(group[name])
    return group


def tie_hyvideo(group: dict, hidden: int) -> dict:
    """Tie the k rows of ``img_qkv`` / ``linear1`` (and the k norms) to
    the q rows in place."""
    d = hidden
    for name, t in group.items():
        if name.endswith(".img_qkv.w") or name.endswith(".linear1.w"):
            t[d:2 * d].copy_(t[:d])
        elif name.endswith(".img_qkv.b") or name.endswith(".linear1.b"):
            t[d:2 * d].copy_(t[:d])
    for name in list(group):
        if name.endswith(".img_q_norm"):
            group[name.replace("_q_", "_k_")].copy_(group[name])
        elif name.endswith(".q_norm") and "single_blocks" in name:
            group[name[:-6] + "k_norm"].copy_(group[name])
    return group

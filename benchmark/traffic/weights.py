"""Seeded weights, made on the device in a few large draws.

A model's parameters come in groups (the embeddings, each block, the
head; ``reference.<family>.param_groups``). Each group is drawn from a
generator of its own, seeded from the run's seed and the group's index,
with one ``randn`` per dtype over the whole group, then cut into tensors
and scaled by kind:

  * ``w``: a linear weight [out, in], N(0, 2 / (in + out)) (Glorot);
  * ``b``: a bias or a norm's shift, N(0, 0.02^2);
  * ``ln``: a norm's scale, 1 + N(0, 0.05^2);
  * ``mod``: a modulation table, N(0, 1 / dim), as the published init.

The same call on the same device gives the same tensors, so the program
is handed the whole set once and the reference draws each group again
when it needs it.
"""

from __future__ import annotations

import torch

_MIX = (0x9E3779B97F4A7C15, 0xBF58476D1CE4E5B9)


def group_seed(seed: int, index: int) -> int:
    return (int(seed) * _MIX[0] + (index + 1) * _MIX[1]) % (2 ** 63)


@torch.no_grad()
def make_group(specs, seed: int, index: int, dtype, device) -> dict:
    """The tensors of one group: ``specs`` [(name, shape, kind, f32)],
    ``dtype`` the dtype of the parameters not marked f32."""
    gen = torch.Generator(device=device).manual_seed(group_seed(seed, index))
    out = {}
    for f32, dt in ((True, torch.float32), (False, dtype)):
        part = [s for s in specs if s[3] == f32]
        if not part:
            continue
        sizes = [torch.Size(s[1]).numel() for s in part]
        flat = torch.randn(sum(sizes), generator=gen, device=device,
                           dtype=dt)
        for (name, shape, kind, _), piece in zip(
                part, torch.split(flat, sizes)):
            t = piece.view(shape)
            if kind == "w":
                t.mul_((2.0 / (shape[0] + shape[1])) ** 0.5)
            elif kind == "b":
                t.mul_(0.02)
            elif kind == "ln":
                t.mul_(0.05).add_(1.0)
            elif kind == "mod":
                t.mul_(shape[-1] ** -0.5)
            else:
                raise ValueError(f"unknown parameter kind {kind!r}")
            out[name] = t
    return out

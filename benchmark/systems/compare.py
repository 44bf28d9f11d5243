"""The numbers that decide ``correct``: how far a step the program took
lies from the step the plain reference takes from the same input.

A step moves the latents [C, F, H, W] by an increment. Two numbers judge
the program's increment against the reference's: the relative L2 gap
over the whole tensor, and the worst latent position, the L2 gap over
its channels against the root mean square of the reference's increment
per position, which a fault in one token cannot hide in.
"""

from __future__ import annotations


def step_numbers(tag: str, prog, ref) -> dict:
    """{"<tag>_rel_l2", "<tag>_worst_token"} of increments [C, F, H, W]."""
    prog, ref = prog.double(), ref.double()
    gap = prog - ref
    tok_ref = ref.square().sum(dim=0).mean().sqrt()
    return {f"{tag}_rel_l2": float(gap.norm() / ref.norm()),
            f"{tag}_worst_token": float(gap.square().sum(dim=0).sqrt().max()
                                        / tok_ref)}

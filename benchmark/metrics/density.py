"""density (%): the selected share of key blocks in the first block's
planner mask on the input of the window's sampled step, from the
program's own ``*_first_selection_mask``."""

UNIT = "%"


def read(ctx):
    d = ctx.get("density")
    return None if d is None else 100.0 * d

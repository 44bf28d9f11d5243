"""idle_share.step (%): the share of the traced window in which no
operation ran on the device, 1 - busy / wall, where busy is the union of
the profiler's device events over the window's steps."""

UNIT = "%"


def read(ctx):
    if ctx["busy_s"] <= 0:
        return None
    return 100.0 * (1.0 - ctx["busy_s"] / ctx["window_s"])

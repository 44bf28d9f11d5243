"""other_ms (ms): device milliseconds per step outside K1, D and the
GEMMs: norms, modulation, RoPE, copies, the planner."""

UNIT = "ms"


def read(ctx):
    if ctx["busy_s"] <= 0 or not ctx["steps"]:
        return None
    return ctx["device_ms"]["other"] / ctx["steps"]

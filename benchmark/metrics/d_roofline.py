"""d_roofline (%): the dense kernel D's bound over its device time in the
window, over both routes (the short-key cross-attention and, on a dense
step, the self-attention over every token). Each launch is bounded at its
own shape, as the probe observed it: the larger of its operations over
989 TFLOP/s and its bytes over 3.35 TB/s. None where the launches
observed are not the program's counted ones."""

UNIT = "%"


def read(ctx):
    t = ctx["device_ms"]["dense_kernel"] / 1e3
    if not ctx["launches"]["d"] or t <= 0 or ctx["d_bound_s"] is None:
        return None
    return 100.0 * ctx["d_bound_s"] / t

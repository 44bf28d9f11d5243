"""k1_roofline (%): the block-sparse kernel's bound over its device time
in the window. The bound of a launch is the larger of its operations (the
128 x 128 tiles of the blocks it was given) over 989 TFLOP/s and its
bytes (q, k, v read once, o written once) over 3.35 TB/s."""

UNIT = "%"


def read(ctx):
    t = ctx["device_ms"]["block_sparse_kernel"] / 1e3
    if not ctx["launches"]["k1"] or t <= 0:
        return None
    return 100.0 * ctx["k1_bound_s"] / t

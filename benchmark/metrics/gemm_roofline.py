"""gemm_roofline (%): the GEMMs' operations at the cell's shapes over
their device time in the window, as a share of 989 TFLOP/s."""

UNIT = "%"


def read(ctx):
    t = ctx["device_ms"]["gemm"] / 1e3
    if t <= 0:
        return None
    return 100.0 * ctx["gemm_flop"] / ctx["peak_flops"] / t

"""step_mfu (%): the useful operations of the window's steps over the
window's seconds, as a share of the card's bf16 peak (989 TFLOP/s). The
operations are the GEMMs at the cell's shapes, the self-attention over
the blocks K1 was given, and D's attention at each launch's own shape
(cross-attention, and the dense fallback's self-attention). The seconds
are the traced window's by the host clock, the profiler's own cost in
them. None where D's launches could not be priced."""

UNIT = "%"


def read(ctx):
    if ctx["busy_s"] <= 0 or ctx["d_flop"] is None:
        return None
    flop = ctx["gemm_flop"] + ctx["k1_flop"] + ctx["d_flop"]
    return 100.0 * flop / (ctx["window_s"] * ctx["peak_flops"])

"""layout_ms (ms): device milliseconds a window step of the kernels whose
innermost program span is ``layout``: the pads, gathers, concatenations
and contiguous copies around the attention kernels and the curve order
(``jenga_tpu_torch.obs``); none where the window holds no program
span."""

from benchmark import spans

UNIT = "ms"


def read(ctx):
    return spans.span_ms_per_step(ctx, lambda path: path[-1:] == ("layout",))

"""planner_ms (ms): device milliseconds a window step of the kernels
whose innermost program span is ``planner`` (the block selection and the
kernel's block lists, ``jenga_tpu_torch.obs``): 0 where the planner
launched nothing, none where the window holds no program span."""

from benchmark import spans

UNIT = "ms"


def read(ctx):
    return spans.span_ms_per_step(ctx, lambda path: path[-1:] == ("planner",))

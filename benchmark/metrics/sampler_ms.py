"""sampler_ms (ms): device milliseconds a window step of the kernels
inside a program ``step`` span but outside its ``trunk``: embed, head,
classifier-free guidance, the solver and the loop's own copies
(``jenga_tpu_torch.obs``); none where the window holds no program
span."""

from benchmark import spans

UNIT = "ms"


def read(ctx):
    return spans.span_ms_per_step(
        ctx, lambda path: "step" in path and "trunk" not in path)

"""elementwise_ms (ms): device milliseconds a window step of the kernels
whose innermost program span is ``norm``, ``modulate``, ``rope`` or
``act``: the f32 elementwise chains of the DiT (``jenga_tpu_torch.obs``);
none where the window holds no program span."""

from benchmark import spans

UNIT = "ms"


def read(ctx):
    return spans.span_ms_per_step(
        ctx, lambda path: bool(path) and path[-1] in spans.ELEMENTWISE)

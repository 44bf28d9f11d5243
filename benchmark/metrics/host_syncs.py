"""host_syncs (count): host-device synchronisations a window step made
inside a program span, each marked by the program as a ``jenga.sync``
event in the span open at the time (``jenga_tpu_torch.obs``, the count
``obs.syncs()`` keeps); none where the window holds no program span."""

from benchmark import spans

UNIT = "count"


def read(ctx):
    w = spans.window(ctx)
    if w is None:
        return None
    return sum(n for path, n in w["syncs"].items() if path) / ctx["steps"]

"""P2: locate the joint grouped kernel's epilogue cost (port of
``tools/epilogue_probe.py``).

At the TPU probe's shape (b=1, h=24, d=128, 904 blocks = 115,712 tokens,
tsb = 902, q_rows 4, banded lists of density 0.27 per row, text_amp 1.0,
every key valid), five epilogues of the production kernel
(``ops/attention_probe.py``) run on the same lists:

  base      online softmax, the key mask applied in every tile
  condqk    online softmax, the mask only in tiles that need it (the
            production online kernel)
  fixedmax  the per-row Cauchy-Schwarz bound (the production default)
  oracle    online softmax, no mask and no text_amp
  nomax     a constant row max of 20, no mask and no text_amp

    python -m jenga_tpu_torch.tools.epilogue_probe
"""

from __future__ import annotations

import torch

from ..ops.attention_probe import EPILOGUE_VARIANTS, attention_probe
from ..ops.sparse_dispatch import block_lists_from_mask
from ._common import gpu_line, resolve_device, time_ms, timed
from .kernel_split_probe import PAIR_FLOP, attended_pairs, check_vs_plain
from .library_baseline import flex_block_sparse

__all__ = ["run", "banded_mask", "NB", "Q_ROWS", "DENSITY", "TEXT_AMP"]

NB = 904
Q_ROWS = 4
DENSITY = 0.27
TEXT_AMP = 1.0
HEADLINE = "fixedmax"   # the variant checked over every row


def banded_mask(b: int, h: int, nb: int, density: float = DENSITY,
                device="cpu"):
    """The TPU probe's per-row mask [b, h, nb, nb]: a window of
    ``int(density * nb)`` blocks around each video row (clipped inside the
    video blocks), text columns and text rows attending everything;
    tsb = nb - 2."""
    tsb = nb - 2
    win = int(density * nb)
    rows = torch.arange(nb, device=device)[:, None]
    cols = torch.arange(nb, device=device)[None, :]
    center = rows.clamp(win // 2, tsb - win // 2)
    local = (cols - center).abs() <= win // 2
    local[:, tsb:] = True
    local[tsb:] = True
    return local.expand(b, h, nb, nb)


def run(nb: int = NB, *, reps: int = 4, check: bool = False,
        library: bool = False, heads: int = 24, device="cuda"):
    """Time each epilogue on the banded group lists; with ``check`` also
    hold the warm-up launch's output against the plain version
    (``kernel_split_probe.check_vs_plain``: ``HEADLINE`` over every row,
    the others over three slices). Returns {"shape", "tsb", "q_rows",
    "density", "list_density", "pairs", "variants": {variant: {"ms",
    "tflops", "gap_ms", and with ``check`` "max_abs_err", "rel_err",
    "plain_ms", "checked_blocks"}}, "library_ms"?}, ``gap_ms`` against
    fixedmax. ``library`` times ``flex_attention`` on the same lists with
    text_amp (the yardstick of ``tools/library_baseline.py``)."""
    device = resolve_device(device)
    tsb = nb - 2
    gen = torch.Generator(device=device).manual_seed(0)
    q, k, v = (torch.randn((1, heads, nb * 128, 128), generator=gen,
                           device=device, dtype=torch.bfloat16)
               for _ in range(3))
    mask = banded_mask(1, heads, nb, DENSITY, device)
    idx, cnt, _ = block_lists_from_mask(mask, Q_ROWS, True)
    sl = torch.full((1,), nb * 128, dtype=torch.int32, device=device)
    pairs = attended_pairs(cnt, Q_ROWS, nb)
    out = {"shape": list(q.shape), "tsb": tsb, "q_rows": Q_ROWS,
           "density": mask.float().mean().item(),
           "list_density": pairs / (heads * nb * nb), "pairs": pairs,
           "variants": {}}
    kw = dict(q_rows=Q_ROWS, text_amp=TEXT_AMP, text_start_block=tsb)
    for var in EPILOGUE_VARIANTS:
        def call(var=var):
            return attention_probe(var, q, k, v, idx, cnt, sl, **kw)
        ms, first = timed(call, reps, device)
        r = {"ms": ms, "tflops": pairs * PAIR_FLOP / (ms * 1e-3) / 1e12}
        if check:
            r.update(check_vs_plain(var, first, q, k, v, idx, cnt, sl,
                                    full=var == HEADLINE, **kw))
        del first
        out["variants"][var] = r
    if library:
        out["library_ms"] = time_ms(
            flex_block_sparse(q, k, v, idx, cnt, sl, **kw), reps, device)
    ref = out["variants"].get("fixedmax")
    for r in out["variants"].values():
        r["gap_ms"] = None if ref is None else r["ms"] - ref["ms"]
    return out


def print_table(res):
    b, h, s, _ = res["shape"]
    print(f"P2 epilogues: b={b} h={h} S={s} ({s // 128} blocks, tsb "
          f"{res['tsb']}), q_rows={res['q_rows']}, density "
          f"{res['density']:.3f} per row, {res['list_density']:.3f} per "
          f"group list")
    if "library_ms" in res:
        print(f"  flex_attention {res['library_ms']:.3f} ms")
    for var, r in res["variants"].items():
        gap = ("" if r["gap_ms"] is None
               else f"  (vs fixedmax {r['gap_ms']:+9.3f} ms)")
        err = (f"  max abs err {r['max_abs_err']:.2e}, rel "
               f"{r['rel_err']:.2e} over {r['checked_blocks']} blocks"
               if "max_abs_err" in r else "")
        print(f"  {var:9s} {r['ms']:10.3f} ms {r['tflops']:8.1f} TFLOP/s"
              f"{gap}{err}", flush=True)


def main():
    device = resolve_device("cuda")
    print(gpu_line(), flush=True)
    print_table(run(device=device))


if __name__ == "__main__":
    main()

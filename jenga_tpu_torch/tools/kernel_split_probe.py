"""P1: split the block-sparse kernel's time into its gather and its tile
math (port of ``tools/kernel_split_probe.py``).

At the HunyuanVideo 1280x720x125f shape (b=1, h=24, d=128, gilbert grid
(32, 45, 80) + 256 text tokens = 115,456 tokens, 902 blocks, tsb 900) with
the planner's lists (``build_block_mask(top_k=225, p_remain=0.05)`` over
the curve's adjacency, text rows attending everything), three variants of
the production kernel (``ops/attention_probe.py``) run in two modes, K2
(per-row lists, q_rows 1, the TPU probe's mode) and K1 (joint q8, the
main path's):

  both          the production kernel (text_amp 0, seqlen = S)
  copy_only     the producer warp's TMA ring over the same blocks; the
                consumers wait on and release each stage, no tile math
  compute_only  the tile math over each group's first block, no gather

With the producer warp feeding the consumer warpgroups, the gather
overlaps the math: copy_only + compute_only exceed both by what the
overlap hides.

The TPU tool also swept its DMA group width (8-48 blocks); the card's
ring holds one block per stage, so there is nothing to sweep.

    python -m jenga_tpu_torch.tools.kernel_split_probe
"""

from __future__ import annotations

import torch

from ..curves.blocks import build_curve_plan
from ..ops.attention_probe import (SPLIT_VARIANTS, attention_probe,
                                   attention_probe_plain)
from ..ops.sparse_dispatch import block_lists_from_mask
from ..sparse.planner import build_block_mask
from ._common import (gpu_line, max_abs_err, once_ms, rel_err,
                      resolve_device, sq_sums, time_ms, timed)
from .library_baseline import flex_block_sparse

__all__ = ["run", "probe_inputs", "attended_pairs", "GRID", "MODES"]

GRID = (32, 45, 80)          # HY 1280x720x125f latent
TEXT_TOKENS = 256
MODES = {"k2_q1": 1, "k1_q8": 8}
PAIR_FLOP = 4 * 128 * 128 * 128     # QK^T and PV of one 128x128 tile
PAIR_BYTES = 2 * 128 * 128 * 2      # the K and V tiles of one block
CHECK_BLOCKS = 16       # query blocks the plain version takes at a time
HEADLINE = "both"       # the variant checked over every row


def probe_inputs(grid=GRID, *, device="cpu"):
    """Seeded bf16 q, k, v [1, 24, S, 128] for a gilbert grid plus 256
    text tokens, S padded to whole blocks; returns (q, k, v, plan, tsb)."""
    plan = build_curve_plan(tuple(grid), "gilbert", 128)
    s = -(-(plan.seq_len + TEXT_TOKENS) // 128) * 128
    gen = torch.Generator(device=device).manual_seed(0)
    q, k, v = (torch.randn((1, 24, s, 128), generator=gen, device=device,
                           dtype=torch.bfloat16) for _ in range(3))
    return q, k, v, plan, s // 128 - 2


def probe_lists(q, k, plan, tsb: int, q_rows: int, top_k: int,
                p_remain: float = 0.05):
    """The planner's selection for the video rows (groups of ``q_rows``),
    the text rows attending every block, as (indices, counts)."""
    nb = k.shape[2] // 128
    mask = build_block_mask(
        q[:, :, :tsb * 128], k, top_k=top_k, p_remain=p_remain,
        text_start_block=tsb, text_blocks=nb - tsb,
        block_neighbors=plan.block_neighbors,
        sel_group=q_rows)
    full = torch.ones((*mask.shape[:2], nb - tsb, nb), dtype=torch.bool,
                      device=mask.device)
    idx, cnt, _ = block_lists_from_mask(torch.cat([mask, full], 2), q_rows,
                                        q_rows > 1)
    return idx, cnt


def check_vs_plain(variant, out, q, k, v, indices, counts, seqlens, *,
                   q_rows: int, full: bool, **kw):
    """Hold a variant's output against its plain version (f32) at the
    launch's own shape, ``CHECK_BLOCKS`` query blocks (whole groups) at a
    time: every chunk with ``full``, else the first, middle and last (one
    head's logits over all keys cannot be held at once at 115k tokens).
    Returns {"max_abs_err", "rel_err" (||out - plain|| / ||plain|| over
    the checked rows), "plain_ms" (the plain version's time over those
    chunks), "checked_blocks"}."""
    nqb = q.shape[2] // 128
    step = max(1, CHECK_BLOCKS // q_rows) * q_rows
    starts = list(range(0, nqb, step))
    if not full:
        starts = sorted({starts[0], starts[len(starts) // 2], starts[-1]})
    kf, vf = k.float(), v.float()
    err, diff_sq, ref_sq, ms, rows = 0.0, 0.0, 0.0, 0.0, 0
    for r0 in starts:
        r1 = min(r0 + step, nqb)
        g0, g1 = r0 // q_rows, -(-r1 // q_rows)
        t, ref = once_ms(lambda: attention_probe_plain(
            variant, q[:, :, r0 * 128:r1 * 128].float(), kf, vf,
            indices[:, :, g0:g1], counts[:, :, g0:g1], seqlens,
            q_rows=q_rows, q_start_block=r0, **kw), q.device)
        part = out[:, :, r0 * 128:r1 * 128]
        err = max(err, max_abs_err(part, ref))
        d_sq, r_sq = sq_sums(part, ref)
        diff_sq, ref_sq, ms, rows = (diff_sq + d_sq, ref_sq + r_sq, ms + t,
                                     rows + r1 - r0)
    return {"max_abs_err": err, "rel_err": rel_err(diff_sq, ref_sq),
            "plain_ms": ms, "checked_blocks": rows}


def attended_pairs(counts, q_rows: int, nqb: int) -> int:
    """(query block, key block) tiles a launch attends: each group's count
    times its real rows."""
    ngroups = counts.shape[-1]
    rows = (nqb - torch.arange(ngroups, device=counts.device) * q_rows) \
        .clamp(max=q_rows)
    return int((counts.long() * rows).sum().item())


def run(grid=GRID, *, reps: int = 4, check: bool = False,
        library: bool = False, device="cuda"):
    """Time each variant in each mode, with the planner's top_k at a
    quarter of the video blocks (225 of 900); with ``check`` also hold the
    output of each variant's warm-up launch against its plain version
    (``check_vs_plain``: ``HEADLINE`` over every row, the others over
    three slices). Returns {"shape", "tsb", "top_k", "modes": {mode:
    {"q_rows", "density", "pairs", "variants": {variant: {"ms", "tflops"
    | "gbps", "gap_ms", and with ``check`` "max_abs_err", "rel_err",
    "plain_ms", "checked_blocks"}}, "library_ms"?}}}.
    ``library`` times ``flex_attention`` on the same lists (the
    yardstick of ``tools/library_baseline.py``; its compile is not
    timed)."""
    device = resolve_device(device)
    q, k, v, plan, tsb = probe_inputs(grid, device=device)
    nb = q.shape[2] // 128
    top_k = tsb // 4
    sl = torch.full((q.shape[0],), q.shape[2], dtype=torch.int32,
                    device=device)
    out = {"shape": list(q.shape), "tsb": tsb, "top_k": top_k, "modes": {}}
    for mode, q_rows in MODES.items():
        idx, cnt = probe_lists(q, k, plan, tsb, q_rows, top_k)
        pairs = attended_pairs(cnt, q_rows, nb)
        rec = {"q_rows": q_rows, "pairs": pairs,
               "density": pairs / (q.shape[0] * q.shape[1] * nb * nb),
               "variants": {}}
        for var in SPLIT_VARIANTS:
            call = (lambda var=var: attention_probe(
                var, q, k, v, idx, cnt, sl, q_rows=q_rows,
                text_start_block=tsb))
            ms, first = timed(call, reps, device)
            r = {"ms": ms}
            if var == "copy_only":
                r["gbps"] = pairs * PAIR_BYTES / (ms * 1e-3) / 1e9
            else:
                r["tflops"] = pairs * PAIR_FLOP / (ms * 1e-3) / 1e12
            if check:
                r.update(check_vs_plain(
                    var, first, q, k, v, idx, cnt, sl, q_rows=q_rows,
                    full=var == HEADLINE, text_start_block=tsb))
            del first
            rec["variants"][var] = r
        if library:
            flex = flex_block_sparse(q, k, v, idx, cnt, sl, q_rows=q_rows,
                                     text_start_block=tsb)
            rec["library_ms"] = time_ms(flex, reps, device)
        both = rec["variants"].get("both")
        for r in rec["variants"].values():
            r["gap_ms"] = None if both is None else r["ms"] - both["ms"]
        out["modes"][mode] = rec
    return out


def print_table(res):
    b, h, s, _ = res["shape"]
    print(f"P1 gather/compute split: b={b} h={h} S={s} ({s // 128} blocks, "
          f"tsb {res['tsb']}), top_k {res['top_k']}, p_remain 0.05")
    for mode, rec in res["modes"].items():
        lib = (f"; flex_attention {rec['library_ms']:.3f} ms"
               if "library_ms" in rec else "")
        print(f"{mode} (q_rows {rec['q_rows']}): density "
              f"{rec['density']:.4f}, {rec['pairs']} tiles{lib}")
        for var, r in rec["variants"].items():
            rate = (f"{r['gbps']:8.1f} GB/s gathered" if "gbps" in r
                    else f"{r['tflops']:8.1f} TFLOP/s")
            gap = ("" if r["gap_ms"] is None
                   else f"  (vs both {r['gap_ms']:+9.3f} ms)")
            err = (f"  max abs err {r['max_abs_err']:.2e}, rel "
                   f"{r['rel_err']:.2e} over {r['checked_blocks']} blocks"
                   if "max_abs_err" in r else "")
            print(f"  {var:13s} {r['ms']:10.3f} ms {rate}{gap}{err}",
                  flush=True)


def main():
    device = resolve_device("cuda")
    print(gpu_line(), flush=True)
    print_table(run(device=device))


if __name__ == "__main__":
    main()

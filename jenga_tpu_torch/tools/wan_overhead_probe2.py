"""P4: resident-KV cross-attention against kernel D, with the pooling rows
and the harness floor (port of ``tools/wan_overhead_probe2.py``).

Wan bench shape: q [2, 12, 32768, 128] bf16, the cross-attention's 512
text keys k, v [2, 12, 512, 128] bf16.

  (A) the pooling rows of the pool probe (``tools/pool_probe.py``) on
      this q and k;
  (B) the harness floor: one elementwise pass over q (read q, write a
      tensor of its size), the bytes any cross-attention must move;
  (C) the P4 kernel (``ops/cross_attention_resident.py``) at bq
      1024/2048/4096 rows per thread block, kernel D
      (``ops/flash_attention.py``, the model's cross-attention) and
      ``F.scaled_dot_product_attention`` (flash backend, a yardstick from
      ``tools/library_baseline.py``) on the same operands, each held
      against the f32 softmax (the plain version, timed once).

    python -m jenga_tpu_torch.tools.wan_overhead_probe2
"""

from __future__ import annotations

import torch

from ..ops.cross_attention_resident import (NUM_KEYS,
                                            cross_attention_resident,
                                            cross_attention_resident_plain)
from ..ops.flash_attention import dense_attention
from ._common import (gpu_line, max_abs_err, once_ms, rel_err,
                      resolve_device, sq_sums, time_ms, timed)
from .library_baseline import sdpa_flash
from .pool_probe import pool_rows

__all__ = ["run", "BQS"]

SEQ = 32768
BQS = (1024, 2048, 4096)


def run(seq: int = SEQ, *, bqs=BQS, reps: int = 10, pool: bool = True,
        heads: int = 12, device="cuda"):
    """Returns {"shape", "flop", "bytes", "floor_ms", "pool_ms"?,
    "plain_ms", "attn": {name: {"ms", "tflops", "max_abs_err", "rel_err"}}}
    with names ``resident bq<bq>``, ``D`` and (on the card) ``sdpa``;
    ``rel_err`` is ||out - plain|| / ||plain||."""
    device = resolve_device(device)
    gen = torch.Generator(device=device).manual_seed(0)
    q = torch.randn((2, heads, seq, 128), generator=gen, device=device,
                    dtype=torch.bfloat16)
    k, v = (torch.randn((2, heads, NUM_KEYS, 128), generator=gen,
                        device=device, dtype=torch.bfloat16)
            for _ in range(2))
    flop = 4 * q.shape[0] * heads * seq * NUM_KEYS * 128
    out = {"shape": [list(q.shape), list(k.shape)], "flop": flop,
           "bytes": 2 * q.numel() * 2 + 2 * k.numel() * 2}
    out["floor_ms"] = time_ms(lambda: q * 1.05, reps, device)
    if pool:
        kp = torch.randn(q.shape, generator=gen, device=device,
                         dtype=torch.bfloat16)
        out["pool_ms"] = pool_rows(q, kp, reps=reps)
        del kp
    out["plain_ms"], ref = once_ms(lambda: cross_attention_resident_plain(
        q.float(), k.float(), v.float()), device)
    fns = {f"resident bq{bq}": (lambda bq=bq: cross_attention_resident(
        q, k, v, bq=bq)) for bq in bqs}
    fns["D"] = lambda: dense_attention(q, k, v)
    if device.type == "cuda":
        fns["sdpa"] = lambda: sdpa_flash(q, k, v)
    out["attn"] = {}
    for name, fn in fns.items():
        ms, first = timed(fn, reps, device)
        out["attn"][name] = {"ms": ms, "max_abs_err": max_abs_err(first, ref),
                             "rel_err": rel_err(*sq_sums(first, ref)),
                             "tflops": flop / (ms * 1e-3) / 1e12}
    return out


def print_table(res):
    (b, h, s, d), kv = res["shape"]
    floor = res["floor_ms"]
    print(f"P4 cross-attention: q [{b}, {h}, {s}, {d}], k/v {kv}")
    print(f"harness floor (q * 1.05)  {floor:8.4f} ms")
    for name, ms in res.get("pool_ms", {}).items():
        print(f"pool {name:14s}  {ms:8.4f} ms (net {ms - floor:+8.4f})",
              flush=True)
    for name, r in res["attn"].items():
        print(f"cross {name:13s} {r['ms']:8.4f} ms (net {r['ms'] - floor:+8.4f}"
              f"; {r['tflops']:6.1f} TFLOP/s; max abs err "
              f"{r['max_abs_err']:.2e}, rel {r['rel_err']:.2e})", flush=True)


def main():
    device = resolve_device("cuda")
    print(gpu_line(), flush=True)
    print_table(run(device=device))


if __name__ == "__main__":
    main()

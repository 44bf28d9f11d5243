"""P3: isolate the planner's pooling cost at the Wan-1.3B stage-1 shape
(port of ``tools/pool_probe.py``).

b=2, h=12, d=128, the sliced curve over the 832x480x81f latent (21, 30,
52): 32,760 tokens padded to 32,768 (256 blocks). Every row pools both q
and k, as the planner does:

  read floor      a sum over the token axis (each byte read once, a tiny
                  output): the least any pooling can take
  planner _pool   the port planner's own pooling (``sparse/planner.py``)
  plain           the kernel's plain version, ``.float().mean(3)``
  torch mean      one torch call, ``.mean(3, dtype=float32)``
  kernel c8..c32  the P3 kernel (``ops/block_pool.py``) at chunk 8/16/32
  planner[...]    the whole joint-q8 planner (``build_block_mask``, the
                  tool's top_k 0.15 * nb and p_remain 0.15, the curve's
                  adjacency, first-frame blocks) with its own pool and
                  with the kernel's

The kernel does not replace the planner's pool: that is a measured
end-to-end change of its own.

    python -m jenga_tpu_torch.tools.pool_probe
"""

from __future__ import annotations

from unittest import mock

import torch

from ..curves.blocks import build_curve_plan
from ..ops.block_pool import block_pool, block_pool_plain
from ..sparse import planner
from ._common import gpu_line, max_abs_err, resolve_device, time_ms, timed
from .library_baseline import torch_block_mean

__all__ = ["run", "pool_inputs", "pool_rows", "GRID", "CHUNKS"]

GRID = (21, 30, 52)      # Wan 832x480x81f latent
CHUNKS = (8, 16, 32)
SEL_GROUP = 8


def pool_inputs(grid=GRID, *, h: int = 12, device="cpu"):
    """Seeded bf16 q, k [2, h, S, 128] over the sliced curve of ``grid``,
    S padded to whole blocks; returns (q, k, plan)."""
    plan = build_curve_plan(tuple(grid), "sliced", 128)
    s = -(-plan.seq_len // 128) * 128
    gen = torch.Generator(device=device).manual_seed(0)
    q, k = (torch.randn((2, h, s, 128), generator=gen, device=device,
                        dtype=torch.bfloat16) for _ in range(2))
    return q, k, plan


def _kernel_pool(chunk):
    def pool(x, nb, block_size):
        if block_size != 128:
            raise ValueError("the pool kernel takes 128-token blocks")
        return block_pool(x[:, :, :nb * 128], chunk=chunk)
    return pool


def pool_rows(q, k, *, reps: int = 20, outputs=None):
    """ms of each pooling of q and k: {name: ms}. The kernel rows are
    ``kernel c<chunk>``; ``outputs``, a dict, receives each row's pooled q
    from its warm-up call."""
    nb = q.shape[2] // 128
    fns = {
        "read floor": lambda x: x.sum(2, dtype=torch.float32),
        "planner _pool": lambda x: planner._pool(x, nb, 128),
        "plain": block_pool_plain,
        "torch mean": torch_block_mean,
    }
    for c in CHUNKS:
        fns[f"kernel c{c}"] = (lambda x, c=c: block_pool(x, chunk=c))
    res = {}
    for name, fn in fns.items():
        res[name], first = timed(lambda fn=fn: (fn(q), fn(k)), reps,
                                 q.device)
        if outputs is not None:
            outputs[name] = first[0]
    return res


def run(grid=GRID, *, reps: int = 20, planner_reps: int = 10,
        heads: int = 12, device="cuda"):
    """Time every pooling row and the planner with each pool; hold the
    kernel's output at each chunk against the plain row's. Returns {"shape",
    "bytes", "pool_ms": {row: ms}, "planner_ms": {pool: ms},
    "max_abs_err": {chunk: err}, "planner_masks_equal": bool}."""
    device = resolve_device(device)
    q, k, plan = pool_inputs(grid, h=heads, device=device)
    nb = q.shape[2] // 128
    outs = {}
    out = {"shape": list(q.shape),
           "bytes": 2 * q.numel() * q.element_size(),
           "pool_ms": pool_rows(q, k, reps=reps, outputs=outs)}
    out["max_abs_err"] = {c: max_abs_err(outs[f"kernel c{c}"], outs["plain"])
                          for c in CHUNKS}

    def plan_mask():
        return planner.build_block_mask(
            q, k, top_k=int(0.15 * nb), p_remain=0.15, text_start_block=nb,
            text_blocks=0, block_neighbors=plan.block_neighbors,
            first_frame_blocks=nb // 21, sel_group=SEL_GROUP)

    out["planner_ms"] = {"planner _pool": time_ms(plan_mask, planner_reps,
                                                  device)}
    own = plan_mask()
    with mock.patch.object(planner, "_pool", _kernel_pool(16)):
        out["planner_ms"]["kernel c16"] = time_ms(plan_mask, planner_reps,
                                                  device)
        out["planner_masks_equal"] = bool(torch.equal(own, plan_mask()))
    return out


def print_table(res):
    b, h, s, d = res["shape"]
    floor = res["pool_ms"]["read floor"]
    print(f"P3 pooling of q and k: b={b} h={h} S={s} d={d} "
          f"({res['bytes'] / 1e6:.1f} MB read)")
    for name, ms in res["pool_ms"].items():
        print(f"  pool {name:14s} {ms:8.4f} ms (net over read floor "
              f"{ms - floor:+8.4f}; {res['bytes'] / (ms * 1e-3) / 1e9:7.1f} "
              f"GB/s)", flush=True)
    for c, err in res["max_abs_err"].items():
        print(f"  kernel c{c} max abs err vs f32 mean: {err:.3e}")
    for name, ms in res["planner_ms"].items():
        print(f"  planner[{name:13s}] {ms:8.4f} ms (net over read floor "
              f"{ms - floor:+8.4f})", flush=True)
    print(f"  planner masks equal with either pool: "
          f"{res['planner_masks_equal']}")


def main():
    device = resolve_device("cuda")
    print(gpu_line(), flush=True)
    print_table(run(device=device))


if __name__ == "__main__":
    main()

"""The traced window: ``torch.profiler`` over the window's steps, the
program's launch counters, and the selection K1 was given.

``Probe.arm`` starts the profiler one step before the window, in its
warm-up phase (the tracer starts and its records are dropped), so that
the window holds no start-up of the tracer; ``begin`` makes it record
and ``end`` stops it once the window's last step has synchronised.
Between ``begin`` and ``end`` the block-sparse launches are observed at
the call into the kernel (``ops.sparse_dispatch`` hands each launch its
block lists, made anew for each launch): each launch's list lengths are
kept, and once the window has closed the (query block, key block) tiles
each launch computed are summed from them, so K1's bound counts the
blocks these inputs selected and the window holds no work of the probe.
(A launch with membership words, ``all_member=False``, which no cell
runs yet, has its tiles summed on the device at the call.) Kernel
classes follow ``jenga_tpu_torch/profile_step.py`` (``_kernel_class``,
copied): ``bsa_kernel`` is K1, ``dense_kernel`` D (both routes),
cuBLAS's names GEMMs, the rest "other".
"""

from __future__ import annotations

import collections

import numpy as np
import torch

from .flops import roofline as R

GEMM_TAGS = ("gemm", "xmma", "cutlass", "nvjet", "cublas")
CLASSES = ("block_sparse_kernel", "dense_kernel", "gemm", "other")


def kernel_class(name: str) -> str:
    low = name.lower()
    if "bsa_kernel" in low:
        return "block_sparse_kernel"
    if "dense_kernel" in low:
        return "dense_kernel"
    if any(tag in low for tag in GEMM_TAGS):
        return "gemm"
    return "other"


def _counters():
    from jenga_tpu_torch.ops import block_sparse_attention as bsa
    from jenga_tpu_torch.ops import flash_attention as fa
    f = bsa.block_sparse_attention
    return {"k1": f.launches + f.member_launches,
            "d": fa.dense_attention.launches,
            "d_short": fa.dense_attention.short_launches}


def _union(spans):
    """Merged [start, end] intervals of a sorted list."""
    out = []
    for a, b in spans:
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


class Probe:
    def __init__(self, cuda: bool):
        self.cuda = cuda
        self.prof = None
        self.k1 = []            # (tiles, bytes, head dim) of each launch
        self._rows = {}

    def arm(self):
        acts = [torch.profiler.ProfilerActivity.CPU]
        if self.cuda:
            acts.append(torch.profiler.ProfilerActivity.CUDA)
        self.prof = torch.profiler.profile(
            activities=acts, schedule=torch.profiler.schedule(
                wait=0, warmup=1, active=1 << 30))
        self.prof.start()

    def begin(self):
        from jenga_tpu_torch.ops import sparse_dispatch as sd
        self.prof.step()
        self.before = _counters()
        self._sd, self._orig = sd, sd.block_sparse_attention
        sd.block_sparse_attention = self._observed

    def _observed(self, q, k, v, indices, counts, seqlens, *, q_rows=1,
                  members=None, **kw):
        if members is None:
            # the list lengths [B, H, groups]; a group's list serves each
            # of its query rows, the last group the rows that remain
            tiles = (counts, q.shape[2] // 128, q_rows)
        else:
            tiles = sum(((members >> r) & 1).sum(dtype=torch.int64)
                        for r in range(q_rows))
        self.k1.append((tiles, R.attention_bytes(q.numel(), k.numel(),
                                                 q.element_size()),
                        q.shape[-1]))
        return self._orig(q, k, v, indices, counts, seqlens, q_rows=q_rows,
                          members=members, **kw)

    def end(self):
        self._sd.block_sparse_attention = self._orig
        self.after = _counters()
        self.prof.stop()

    def context(self, cell, steps: int, window_s: float) -> dict:
        """What the metric readers read."""
        evs = self.prof.events()
        # device work only: not the profiler's own step annotations
        dev = [e for e in evs
               if e.device_type == torch.autograd.DeviceType.CUDA
               and not getattr(e, "is_user_annotation", False)
               and not e.name.startswith("ProfilerStep")]
        ms = dict.fromkeys(CLASSES, 0.0)
        by_name = collections.Counter()
        for e in dev:
            t = e.time_range.elapsed_us() / 1e3
            ms[kernel_class(e.name)] += t
            by_name[e.name[:120]] += t
        spans = _union(sorted((e.time_range.start, e.time_range.end)
                              for e in dev))
        busy_s = sum(b - a for a, b in spans) / 1e6
        k1_flop = k1_bound = 0.0
        if self.k1:
            tiles = torch.stack([self._tiles(t) for t, _, _ in self.k1])
            for n, (_, nbytes, hd) in zip(tiles.cpu().tolist(), self.k1):
                flop = R.attention_tiles_flop(n, hd)
                k1_flop += flop
                k1_bound += R.bound_s(flop, nbytes)
        facts = cell.facts()
        launches = {k: self.after[k] - self.before[k] for k in self.after}
        short = launches["d_short"]
        long_ = launches["d"] - short
        d_flop = d_bound = 0.0
        for n, key in ((short, "short"), (long_, "long")):
            if n:
                flop, nbytes = facts["dense_launch"][key]
                d_flop += n * flop
                d_bound += n * R.bound_s(flop, nbytes)
        return {
            "steps": steps, "window_s": window_s, "busy_s": busy_s,
            "device_ms": ms, "launches": launches,
            "k1_flop": k1_flop, "k1_bound_s": k1_bound,
            "d_flop": d_flop, "d_bound_s": d_bound,
            "gemm_flop": facts["gemm_flop_per_step"] * steps,
            "peak_flops": R.PEAK_FLOPS,
            "breakdown": {
                "device_ops": [[n, t / 1e3]
                               for n, t in by_name.most_common(10)],
                "idle_gaps": self._idle_gaps(evs, spans)}}

    def _tiles(self, tiles):
        """A launch's tile count from its list lengths, after the window."""
        if torch.is_tensor(tiles):
            return tiles
        counts, nq, q_rows = tiles
        ng = counts.shape[-1]
        key = (nq, q_rows, ng, counts.device)
        rows = self._rows.get(key)
        if rows is None:
            r = np.full(ng, q_rows, np.int64)
            r[-1] = nq - (ng - 1) * q_rows
            rows = self._rows[key] = torch.as_tensor(r, device=counts.device)
        return (counts.sum(dim=(0, 1), dtype=torch.int64) * rows).sum()

    @staticmethod
    def _idle_gaps(evs, spans, longest: int = 200):
        """The idle seconds between device work, by the innermost host op
        running when each of the ``longest`` gaps began (top 10)."""
        gaps = sorted(((spans[i + 1][0] - spans[i][1], spans[i][1])
                       for i in range(len(spans) - 1)), reverse=True)
        cpu = [e for e in evs
               if e.device_type == torch.autograd.DeviceType.CPU]
        if not gaps or not cpu:
            return []
        starts = np.array([e.time_range.start for e in cpu], np.float64)
        ends = np.array([e.time_range.end for e in cpu], np.float64)
        idle = collections.Counter()
        for length, at in gaps[:longest]:
            hit = np.nonzero((starts <= at) & (ends > at))[0]
            name = (cpu[hit[np.argmax(starts[hit])]].name if len(hit)
                    else "host, no op")
            idle[name[:120]] += length / 1e6
        return [[n, s] for n, s in idle.most_common(10)]

"""The traced window: ``torch.profiler`` over the window's steps, the
program's launch counters, and the shapes K1 and D were given.

``Probe.arm`` starts the profiler one step before the window, in its
warm-up phase (the tracer starts and its records are dropped), so that
the window holds no start-up of the tracer; ``begin`` makes it record
and ``end`` stops it once the window's last step has synchronised.
Between ``begin`` and ``end`` the attention launches are observed at the
call into each kernel, on the host alone:

- K1: ``ops.sparse_dispatch`` hands each launch its block lists, made
  anew for each launch; each launch's list lengths are kept, and once
  the window has closed the (query block, key block) tiles each launch
  computed are summed from them, so K1's bound counts the blocks these
  inputs selected and the window holds no work of the probe. (A launch
  with membership words, ``all_member=False``, which no cell runs yet,
  has its tiles summed on the device at the call.)
- D: every call into ``flash_attention.dense_attention_forward`` (each
  forward launch of D, either route) keeps its batch, heads, query rows,
  key rows, head dim and route, and each launch is priced at its own
  shape once the window has closed (``dense_totals``). The launches
  observed have to be the counters' (``dense_attention.launches`` and
  ``.short_launches``): where they are not, D has no price and the
  metrics that need one read nothing.

``end`` undoes both observations; the harness calls it on every path
out of the window. Kernel classes follow
``jenga_tpu_torch/profile_step.py`` (``_kernel_class``, copied):
``bsa_kernel`` is K1, ``dense_kernel`` D (both routes), cuBLAS's names
GEMMs, the rest "other".
"""

from __future__ import annotations

import collections
import sys
from typing import NamedTuple

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


class DenseCall(NamedTuple):
    """One call into D: whether it launched the kernel (CUDA operands),
    its route, and its shape."""
    cuda: bool
    short: bool
    batch: int
    heads: int
    q_rows: int
    k_rows: int
    head_dim: int
    itemsize: int


def dense_totals(calls, launches: dict):
    """(operations, bound seconds) of D's launches among ``calls``, each
    priced at its own shape, keys counted over the key tensor's length;
    (None, None) where the launches and short launches observed differ
    from the counters' deltas ``launches["d"]`` and ``["d_short"]``."""
    launched = [c for c in calls if c.cuda]
    seen = (len(launched), sum(c.short for c in launched))
    if seen != (launches["d"], launches["d_short"]):
        return None, None
    flop = bound = 0.0
    for c in launched:
        f, nbytes = R.dense_attention(c.batch, c.heads, c.q_rows, c.k_rows,
                                      c.head_dim, c.itemsize)
        flop += f
        bound += R.bound_s(f, nbytes)
    return flop, bound


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
        self.d = []             # a DenseCall of each call into D
        self._rows = {}
        self._patches = []      # (module, name, original) while observing

    def arm(self):
        acts = [torch.profiler.ProfilerActivity.CPU]
        if self.cuda:
            acts.append(torch.profiler.ProfilerActivity.CUDA)
        self.prof = torch.profiler.profile(
            activities=acts, schedule=torch.profiler.schedule(
                wait=0, warmup=1, active=1 << 30))
        self.prof.start()

    def begin(self):
        from jenga_tpu_torch.ops import flash_attention as fa
        from jenga_tpu_torch.ops import sparse_dispatch as sd
        self.prof.step()
        self.before = _counters()
        self._orig = sd.block_sparse_attention
        self._orig_d, self._route = fa.dense_attention_forward, fa.dense_route
        self._patches = [(sd, "block_sparse_attention", self._orig),
                         (fa, "dense_attention_forward", self._orig_d)]
        sd.block_sparse_attention = self._observed
        fa.dense_attention_forward = self._observed_d

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

    def _observed_d(self, q, k, v, **kw):
        b, h, sq, hd = q.shape
        skv = k.shape[2]
        self.d.append(DenseCall(q.is_cuda, self._route(skv) == "short", b,
                                h, sq, skv, hd, q.element_size()))
        return self._orig_d(q, k, v, **kw)

    def end(self):
        """Stop observing and recording: on every path out of the window,
        also one that raised before ``begin`` or ``arm``."""
        for module, name, original in self._patches:
            setattr(module, name, original)
        self._patches = []
        self.after = _counters()
        if self.prof is not None:
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
        launches = {k: self.after[k] - self.before[k] for k in self.after}
        d_flop, d_bound = dense_totals(self.d, launches)
        seen = [c for c in self.d if c.cuda]
        print(f"dense launches: observed {len(seen)} "
              f"({sum(c.short for c in seen)} short), counted "
              f"{launches['d']} ({launches['d_short']} short)"
              + ("" if d_flop is not None else "; D is not priced"),
              file=sys.stderr)
        return {
            "steps": steps, "window_s": window_s, "busy_s": busy_s,
            "device_ms": ms, "launches": launches,
            "k1_flop": k1_flop, "k1_bound_s": k1_bound,
            "d_flop": d_flop, "d_bound_s": d_bound,
            "gemm_flop": cell.facts()["gemm_flop_per_step"] * steps,
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

"""The program's own spans in a traced window: device milliseconds, host
synchronisations and idle seconds by the span of the port that caused
them.

While a profiler records, the port (``jenga_tpu_torch.obs``) names the
stretches of its sampler step with ``record_function("jenga.<name>")``
(step; embed, trunk, head, guidance, solver; block; planner; norm,
modulate, rope, act; layout) and marks each host-device synchronisation
it makes as a ``jenga.sync`` event inside the span open at the time. Here

- ``span_ms``: each kernel of the window goes to exactly one path of
  nested spans (``("step", "trunk", "block", "norm")``; ``()`` for a
  kernel launched outside every span): the spans open on the host when
  the kernel was launched, found through the correlation id that the
  profiler gives a kernel and its launch alike, split by kernel class
  (``tracing.kernel_class``). (The profiler's device-side ranges of the
  spans are no help: each covers only the kernels launched while its
  span was the innermost one, so they do not nest.)
- ``syncs``: the window's ``jenga.sync`` events by path;
- ``idle_by_span``: the idle seconds of the window's 200 longest device
  gaps, by the path of spans open on the host when each gap began.

Self-check: a kernel whose correlation id no launch carries, or two do,
goes to no path; per kernel class, the milliseconds of all paths must
equal the window's ``device_ms`` within 0.5%. A window that misses
writes a ``span attribution`` line to standard error and gives no span
metric. (Launch and kernel times are not compared: in a 45-s window the
trace put some kernels up to 0.6 ms before their own launch, early in
the window, on an H100.) A window with no program span (a program without
``obs``) gives none either. The harness hands the metric readers its
``ctx`` alone, so the window's profiler is found on the reader's call
stack, as the harness's ``tracing.Probe``; the window is read once, kept
in ``ctx``, and ``obs`` is switched off once it is read (it switched
itself on at the window's first step, the profiler being on).
"""

from __future__ import annotations

import collections
import json
import sys

import numpy as np
import torch

from . import tracing

PREFIX = "jenga."
SYNC = "jenga.sync"
TOLERANCE = 0.005
LONGEST_GAPS = 200


def _paths(points, ranges, depth):
    """The path of nested ranges holding each of ``points`` (sorted
    times): ``ranges`` (start, end, name) nest or are disjoint; of two
    equal ranges the one whose name has the larger ``depth`` is inner."""
    order = sorted(ranges, key=lambda r: (r[0], -r[1], depth.get(r[2], 0)))
    out, stack, i = [], [], 0
    for t in points:
        while i < len(order) and order[i][0] <= t:
            r = order[i]
            i += 1
            while stack and stack[-1][1] <= r[0]:
                stack.pop()
            stack.append(r)
        while stack and stack[-1][1] <= t:
            stack.pop()
        out.append(tuple(r[2] for r in stack))
    return out


def _depths(ranges):
    """The most common nesting depth of each name among the ranges."""
    seen = collections.defaultdict(collections.Counter)
    stack = []
    for start, end, name in sorted(ranges, key=lambda r: (r[0], -r[1])):
        while stack and stack[-1] <= start:
            stack.pop()
        seen[name][len(stack)] += 1
        stack.append(end)
    return {n: c.most_common(1)[0][0] for n, c in seen.items()}


def launch_times(launches, ids):
    """The host time of the launch of each of the kernels ``ids``, from
    ``launches`` (correlation id, time): None where no launch carries the
    id, or more than one does."""
    at = {}
    for cid, t in launches:
        at[cid] = None if cid in at else t
    return [at.get(cid) for cid in ids]


def attribute(kernels, launches, ranges):
    """{path: {class: ms}} of ``kernels`` (start us, end us, class), each
    by the host ``ranges`` (start, end, name) open at its launch
    (``launches``: each kernel's launch time on the host). A kernel whose
    launch is None goes to no path."""
    depth = _depths(ranges)
    ms = collections.defaultdict(lambda: collections.defaultdict(float))
    order = sorted((j for j, at in enumerate(launches) if at is not None),
                   key=lambda j: launches[j])
    for j, path in zip(order, _paths([launches[j] for j in order], ranges,
                                     depth)):
        start, end, cls = kernels[j]
        ms[path][cls] += (end - start) / 1e3
    return {p: dict(c) for p, c in ms.items()}


def check(span_ms, device_ms, tolerance=TOLERANCE):
    """The classes whose milliseconds over all paths miss ``device_ms``
    by more than ``tolerance`` of it: [(class, attributed, total)]."""
    bad = []
    for cls, total in device_ms.items():
        got = sum(c.get(cls, 0.0) for c in span_ms.values())
        if abs(got - total) > tolerance * max(total, 1e-9):
            bad.append((cls, got, total))
    return bad


def _probe():
    """The harness's ``tracing.Probe`` of this run, a local of a frame
    that called the metric readers (``run.run_cell``)."""
    frame = sys._getframe(1)
    while frame is not None:
        for value in frame.f_locals.values():
            if isinstance(value, tracing.Probe):
                return value
        frame = frame.f_back
    return None


def _events(prof):
    """(device events, host ops, span ranges, sync times) of a finished
    profile: the device events as ``Probe.context`` takes them, the spans
    as (start, end, name) without the prefix, and the syncs, of the
    thread that opened the most spans (the sampler loop's)."""
    cuda, cpu = torch.autograd.DeviceType.CUDA, torch.autograd.DeviceType.CPU
    dev, hosts, ranges, syncs = [], [], [], []
    for e in prof.events():
        if e.device_type == cuda:
            if not (getattr(e, "is_user_annotation", False)
                    or e.name.startswith("ProfilerStep")):
                dev.append(e)
        elif e.device_type == cpu:
            if e.name == SYNC:
                syncs.append(e)
            elif e.name.startswith(PREFIX):
                ranges.append(e)
            else:
                hosts.append(e)
    threads = collections.Counter(e.thread for e in ranges)
    main = threads.most_common(1)[0][0] if threads else None
    return (dev, hosts,
            [(e.time_range.start, e.time_range.end, e.name[len(PREFIX):])
             for e in ranges if e.thread == main],
            sorted(e.time_range.start for e in syncs if e.thread == main))


def _idle(dev, hosts, ranges, depth):
    """[[path, seconds]] of the longest idle gaps by the spans open on the
    host when each began, and [[path | host op, seconds]] the same with
    the innermost host op."""
    busy = tracing._union(sorted((e.time_range.start, e.time_range.end)
                                 for e in dev))
    gaps = sorted(((busy[i + 1][0] - busy[i][1], busy[i][1])
                   for i in range(len(busy) - 1)), reverse=True)
    gaps = sorted(gaps[:LONGEST_GAPS], key=lambda g: g[1])
    paths = _paths([at for _, at in gaps], ranges, depth)
    starts = np.array([e.time_range.start for e in hosts], np.float64)
    ends = np.array([e.time_range.end for e in hosts], np.float64)
    by_span, by_op = collections.Counter(), collections.Counter()
    for (length, at), path in zip(gaps, paths):
        key = "/".join(path) or "unspanned"
        by_span[key] += length / 1e6
        hit = np.nonzero((starts <= at) & (ends > at))[0]
        op = (hosts[hit[np.argmax(starts[hit])]].name[:80] if len(hit)
              else "host, no op")
        by_op[f"{key} | {op}"] += length / 1e6
    return ([[k, t] for k, t in by_span.most_common(10)],
            [[k, t] for k, t in by_op.most_common(10)])


def _read(ctx):
    """The window's spans from the probe's profile, after the check; the
    lines it prints go to standard error beside the harness's."""
    probe = _probe()
    if probe is None or probe.prof is None:
        return None
    dev, hosts, ranges, syncs = _events(probe.prof)
    try:
        from jenga_tpu_torch import obs
        obs.disable()
    except ImportError:
        pass
    if not ranges:
        return None
    launches = launch_times(
        [(e.id, e.time_range.start) for e in hosts
         if e.name.startswith("cu") and e.id > 0], [e.id for e in dev])
    span_ms = attribute(
        [(e.time_range.start, e.time_range.end, tracing.kernel_class(e.name))
         for e in dev], launches, ranges)
    bad = check(span_ms, ctx["device_ms"])
    if bad:
        print("span attribution: failed the per-class check (" + ", ".join(
            f"{c} {got:.3f} of {total:.3f} ms" for c, got, total in bad)
            + "): no span metric", file=sys.stderr)
        return None
    depth = _depths(ranges)
    sync_paths = collections.Counter(_paths(syncs, ranges, depth))
    idle, idle_ops = _idle(dev, hosts, ranges, depth)
    steps = ctx["steps"]
    print("span_ms (a step, by path and class): " + json.dumps(
        {"/".join(p) or "unspanned": {c: t / steps for c, t in v.items()}
         for p, v in sorted(span_ms.items())}), file=sys.stderr)
    print("syncs (a step, by path): " + json.dumps(
        {"/".join(p) or "unspanned": n / steps
         for p, n in sync_paths.items()}), file=sys.stderr)
    print("idle_by_span (s): " + json.dumps(idle), file=sys.stderr)
    print("idle_by_span and host op (s): " + json.dumps(idle_ops),
          file=sys.stderr)
    return {"span_ms": span_ms, "syncs": dict(sync_paths),
            "idle_by_span": idle}


def window(ctx):
    """The window's spans (``span_ms``, ``syncs``, ``idle_by_span``), or
    None where it recorded no program span or failed the check; read
    once, kept in ``ctx["spans"]``."""
    if "spans" not in ctx:
        ctx["spans"] = (_read(ctx) if ctx["busy_s"] > 0 and ctx["steps"]
                        else None)
    return ctx["spans"]


def span_ms_per_step(ctx, keep):
    """Device ms a window step of the kernels whose path ``keep(path)``
    accepts: 0 where none, None with no program span."""
    w = window(ctx)
    if w is None:
        return None
    return sum(sum(c.values()) for p, c in w["span_ms"].items()
               if keep(p)) / ctx["steps"]


ELEMENTWISE = ("norm", "modulate", "rope", "act")

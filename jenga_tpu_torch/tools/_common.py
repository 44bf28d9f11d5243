"""What the probe tools share: the device, the card's name and power limit,
and the timer."""

from __future__ import annotations

import math
import subprocess
import time

import torch

from ..runtime import resolve_device

__all__ = ["resolve_device", "gpu_line", "timed", "time_ms", "once_ms",
           "max_abs_err", "rel_err", "sq_sums"]

MIN_WINDOW_MS = 50.0
MAX_REPS = 1000


def gpu_line() -> str:
    """``name, power.limit`` of the card as nvidia-smi gives them."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def timed(fn, reps: int, device: torch.device):
    """(mean ms of ``fn()`` over ``reps`` calls, the output of the warm-up
    call before them): CUDA events on the card, the host clock on the CPU
    (a CPU time is no device number). On the card ``reps`` grows until the
    timed window spans ``MIN_WINDOW_MS`` by the warm-up call's time (which
    can only overstate a call's), so one late launch cannot move a short
    kernel's mean by percents."""
    if device.type != "cuda":
        first = fn()
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        return (time.perf_counter() - t0) * 1e3 / reps, first
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize(device)
    start.record()
    first = fn()
    end.record()
    end.synchronize()
    reps = max(reps, min(MAX_REPS, math.ceil(
        MIN_WINDOW_MS / max(start.elapsed_time(end), 1e-3))))
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps, first


def time_ms(fn, reps: int, device: torch.device) -> float:
    return timed(fn, reps, device)[0]


def once_ms(fn, device: torch.device):
    """(ms, output) of one call with no warm-up: for the slow plain
    versions."""
    _sync(device)
    t0 = time.perf_counter()
    out = fn()
    _sync(device)
    return (time.perf_counter() - t0) * 1e3, out


def max_abs_err(out, ref) -> float:
    return (out.float() - ref.float()).abs().max().item()


def rel_err(diff_sq: float, ref_sq: float) -> float:
    """||out - ref|| / ||ref|| from the two sums of squares; 0 where both
    are 0 (an output that must be all zeros and is)."""
    if ref_sq == 0.0:
        return 0.0 if diff_sq == 0.0 else math.inf
    return math.sqrt(diff_sq / ref_sq)


def sq_sums(out, ref):
    """(sum of (out - ref)^2, sum of ref^2) in f32."""
    d = out.float() - ref.float()
    return d.square().sum().item(), ref.float().square().sum().item()

"""Tracing of the port: named spans on the profiler's clock and a count of
the host-device synchronisations each span makes.

A span names a stretch of the program, ``with obs.span("layout"):`` or
``@obs.spanned("norm")``. While tracing is on, a span enters
``torch.profiler.record_function("jenga." + name)``: it lands in the
profiler's trace on the clock of the kernels it launches, nested in the
span that was open when it began. While tracing is off (the default) a
span tests one module-level bool and returns one shared
``contextlib.nullcontext()``: no ``record_function``, no allocation, no
string.

``enable()`` and ``disable()`` switch tracing; ``enabled()`` reads it.
The sampler loops open each denoising step with ``step``, and there
tracing also follows a running ``torch.profiler``: a step that starts
while one records turns tracing on, and the first step after it stopped
turns it off again (tracing switched on by ``enable()`` stays on until
``disable()``). So a profiled ``generate`` carries its spans without a
call of its own; code outside the sampler loops calls ``enable()``.

While tracing is on and CUDA is available, the CUDA sync debug mode is
"warn": each synchronising CUDA call (``.item()``, ``nonzero``, a copy
from pageable host memory, a copy to the host, ``torch.cuda.synchronize``)
raises PyTorch's sync warning. This module prints none of them: it counts
each once under the innermost open span (``None`` outside every span),
readable as ``syncs()``, and marks it in the trace as a ``jenga.sync``
event inside that span. ``disable()`` restores the debug mode and the
warning filters it found. On a CPU-only torch the debug mode is left
alone (a sync warning raised by hand is still counted).

Span names (``PERF.md`` lists where each one sits): ``step``; ``embed``,
``trunk``, ``head``, ``guidance``, ``solver``; ``block``; ``planner``;
``norm``, ``modulate``, ``rope``, ``act``; ``layout``.
"""

from __future__ import annotations

import collections
import contextlib
import functools
import itertools
import threading
import warnings

import torch

__all__ = ["span", "spanned", "step", "next_clip", "enable", "disable",
           "enabled", "syncs", "PREFIX", "SYNC_MESSAGE"]

PREFIX = "jenga."
SYNC_MESSAGE = "called a synchronizing CUDA operation"

_on = False             # spans recorded and syncs counted
_follows = False        # switched on by a running profiler, not enable()
_OFF = contextlib.nullcontext()
_open = threading.local()       # .names: this thread's open spans
_lock = threading.Lock()
_counts = collections.Counter()
_clips = itertools.count()
_restore = None         # what enable() changed, for disable()
_shown = warnings.showwarning   # the hook _show hands other warnings to


def _names() -> list:
    names = getattr(_open, "names", None)
    if names is None:
        names = _open.names = []
    return names


class _Span:
    __slots__ = ("name", "rf")

    def __init__(self, name: str, args: str | None = None):
        self.name = name
        self.rf = torch.profiler.record_function(PREFIX + name, args)

    def __enter__(self):
        _names().append(self.name)
        self.rf.__enter__()
        return self

    def __exit__(self, *exc):
        self.rf.__exit__(*exc)
        _names().pop()
        return False


def span(name: str, args: str | None = None):
    """A context manager: the span ``jenga.<name>`` while tracing is on
    (``args`` a string the trace shows beside it), else one shared
    ``nullcontext``."""
    if not _on:
        return _OFF
    return _Span(name, args)


def spanned(name: str):
    """Decorator: each call of the function is a span ``name``."""
    def wrap(fn):
        @functools.wraps(fn)
        def traced(*args, **kwargs):
            if not _on:
                return fn(*args, **kwargs)
            with _Span(name):
                return fn(*args, **kwargs)
        return traced
    return wrap


def next_clip() -> int:
    """The number of the clip a sampler loop starts, for its step spans."""
    return next(_clips)


def step(clip: int, index: int, kind: str):
    """The span of one denoising step (``kind``: dense, carved or skip),
    where tracing follows a running ``torch.profiler`` (module docstring).
    The caller closes it before its ``on_step`` callback, so that a
    caller's synchronisation is not counted as the program's."""
    global _follows
    if not _on and torch.autograd.profiler._is_profiler_enabled:
        _switch(True)
        _follows = True
    elif _follows and not torch.autograd.profiler._is_profiler_enabled:
        disable()
    if not _on:
        return _OFF
    return _Span("step", f"clip={clip},step={index},kind={kind}")


def _show(message, category, filename, lineno, file=None, line=None):
    """``warnings.showwarning`` while tracing is on: a sync warning is
    counted and marked, every other warning goes on to the hook it
    replaced."""
    if _on and issubclass(category, UserWarning) and str(
            message).startswith(SYNC_MESSAGE):
        names = _names()
        with _lock:
            _counts[names[-1] if names else None] += 1
        with torch.profiler.record_function(PREFIX + "sync"):
            pass
        return
    _shown(message, category, filename, lineno, file, line)


def _switch(on: bool):
    global _on, _restore, _shown
    if on == _on:
        return
    if on:
        warnings.filterwarnings("always", message=SYNC_MESSAGE,
                                category=UserWarning)
        _restore = {"filter": warnings.filters[0], "mode": None}
        _shown = warnings.showwarning
        warnings.showwarning = _show
        if torch.cuda.is_available():
            _restore["mode"] = torch.cuda.get_sync_debug_mode()
            torch.cuda.set_sync_debug_mode("warn")
        _on = True
        return
    _on = False
    if _restore["mode"] is not None:
        torch.cuda.set_sync_debug_mode(_restore["mode"])
    if warnings.showwarning is _show:
        warnings.showwarning = _shown
    with contextlib.suppress(ValueError):
        warnings.filters.remove(_restore["filter"])
        warnings._filters_mutated()
    _restore = None


def enable():
    """Turn tracing on until ``disable()``."""
    global _follows
    _follows = False
    _switch(True)


def disable():
    """Turn tracing off and restore the sync debug mode and the warning
    filters that ``enable`` found."""
    global _follows
    _follows = False
    _switch(False)


def enabled() -> bool:
    return _on


def syncs() -> dict:
    """Synchronisations counted since the process started, by the
    innermost span open at each (``None``: outside every span)."""
    with _lock:
        return dict(_counts)

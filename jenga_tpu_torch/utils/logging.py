# Copy of jenga_tpu/utils/logging.py, kept so that the port never imports it.
"""Rank-gated logging + run-config dumps.

Counterpart of the reference's observability layer: loguru with a debug
arg-dump (the reference's `hyvideo/inference.py:642-655`), stdlib logging
gated to rank 0 (the reference's `jenga_wan.py:872-881`), and output
filenames that encode id/seed/time/prompt
(the reference's `jenga_hyvideo.py:316`, `jenga_wan.py:1114-1119`).
Built on stdlib logging so it works in every environment.
"""

from __future__ import annotations

import logging
import re
import sys
import time

__all__ = ["get_logger", "log_args", "stamp_filename"]

_FORMAT = "[%(asctime)s] %(levelname)s %(name)s: %(message)s"


def get_logger(name: str = "jenga_tpu", rank: int = 0,
               level: int = logging.INFO) -> logging.Logger:
    """Logger that emits on rank/host 0 and stays silent elsewhere (the
    reference's ``rank == 0`` logging gate)."""
    logger = logging.getLogger(name)
    if not logger.handlers:
        if rank == 0:
            h = logging.StreamHandler(sys.stderr)
            h.setFormatter(logging.Formatter(_FORMAT, "%H:%M:%S"))
            logger.addHandler(h)
        else:
            logger.addHandler(logging.NullHandler())
        logger.setLevel(level if rank == 0 else logging.CRITICAL)
        logger.propagate = False
    return logger


def log_args(logger: logging.Logger, args, title: str = "run config"):
    """Debug-dump every flag, one per line (reference arg dump,
    the reference's `hyvideo/inference.py:642-655`)."""
    logger.info("%s:", title)
    items = sorted(vars(args).items()) if hasattr(args, "__dict__") \
        else sorted(dict(args).items())
    for k, v in items:
        logger.info("  %s = %r", k, v)


def stamp_filename(prompt: str, seed: int, ident=None,
                   gen_time: float | None = None, ext: str = "mp4") -> str:
    """id/seed/time/prompt-slug output name, the reference's convention
    (the reference's `jenga_hyvideo.py:309-316``)."""
    slug = re.sub(r"[^A-Za-z0-9]+", "_", prompt)[:60].strip("_")
    parts = []
    if ident is not None:
        parts.append(f"{ident}")
    parts.append(time.strftime("%Y%m%d-%H%M%S"))
    parts.append(f"seed{seed}")
    if gen_time is not None:
        parts.append(f"{gen_time:.0f}s")
    parts.append(slug or "prompt")
    return "_".join(parts) + f".{ext}"

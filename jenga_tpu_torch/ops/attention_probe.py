"""Probe kernels P1 and P2: the CUDA wrapper, the plain torch version of
each variant and the launch counters.

The kernels (``csrc/attn_probe.cu``) are instances of the production
block-sparse mainloop (``csrc/attn_sm90.cuh``) with parts of its work
switched off, and replace the JAX package's Pallas TPU probes P1
(``tools/kernel_split_probe.py:140``, the gather/compute split) and P2
(``tools/epilogue_probe.py:250``, the epilogue variants). No main path
calls them; the port's probe tools (``jenga_tpu_torch/tools/``) do.

``attention_probe`` launches the kernel for CUDA tensors and takes the
plain version only for CPU tensors; a build or launch failure raises.
``attention_probe.split_launches`` counts P1 launches and
``attention_probe.epilogue_launches`` P2 launches.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from .attention_ref import block_sparse_attention_reference
from .block_sparse_attention import (_check_operands, lists_to_mask,
                                     max_key_norms)
from .cuda_build import CSRC, build_library

__all__ = ["attention_probe", "attention_probe_plain", "SPLIT_VARIANTS",
           "EPILOGUE_VARIANTS", "build_kernel", "KERNEL_SOURCE"]

KERNEL_SOURCE = CSRC / "attn_probe.cu"
# P1: the production kernel, its gather alone, its tile math alone
SPLIT_VARIANTS = ("both", "copy_only", "compute_only")
# P2: masks in every tile, masks where needed, the fixed-max default, no
# masks, no masks and a constant max
EPILOGUE_VARIANTS = ("base", "condqk", "fixedmax", "oracle", "nomax")
_VARIANT_ID = {name: i for i, name in
               enumerate(SPLIT_VARIANTS + EPILOGUE_VARIANTS)}
_HEAD_DIM = 128


@functools.lru_cache(maxsize=1)
def build_kernel() -> ctypes.CDLL:
    """Build (once per source hash) and load the kernel library."""
    lib = build_library(KERNEL_SOURCE)
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.attn_probe_forward.argtypes = [i, p, p, p, p, p, p, p, p, i, i, i, i,
                                       i, i, i, i, f, f, p]
    lib.attn_probe_forward.restype = ctypes.c_int
    lib.attn_probe_error_string.argtypes = [ctypes.c_int]
    lib.attn_probe_error_string.restype = ctypes.c_char_p
    return lib


def attention_probe_plain(variant: str, q, k, v, indices, counts, seqlens,
                          *, q_rows: int = 1, sm_scale=None,
                          text_amp: float = 0.0, text_start_block: int = 0,
                          q_start_block: int = 0):
    """What each variant computes, in plain torch:
    - ``both``, ``base``, ``condqk``, ``fixedmax``: block-sparse attention
      over the lists (the production kernel's function);
    - ``oracle``, ``nomax``: the same with no text_amp and every key valid
      (they apply no mask);
    - ``copy_only``: zeros (no tile math, so l = 0);
    - ``compute_only``: attention over each group's first listed block
      alone (the tile math runs ``n`` times over that one block).

    ``q`` with ``indices``/``counts`` may be a slice of whole groups that
    starts at query block ``q_start_block`` (a multiple of ``q_rows``)."""
    if variant not in _VARIANT_ID:
        raise ValueError(f"unknown probe variant {variant!r}")
    if q_start_block % q_rows:
        raise ValueError(f"q_start_block {q_start_block} does not start a "
                         f"group of {q_rows} rows")
    if variant == "copy_only":
        return torch.zeros_like(q)
    if variant == "compute_only":
        counts = counts.clamp(max=1)
    if variant in ("oracle", "nomax"):
        text_amp = 0.0
        seqlens = torch.full_like(seqlens, k.shape[2])
    mask = lists_to_mask(indices, counts, q_rows, q.shape[2] // 128)
    return block_sparse_attention_reference(
        q, k, v, mask, sm_scale=sm_scale, text_amp=text_amp,
        text_start_block=text_start_block, seqlen=seqlens,
        q_start_block=q_start_block)


def attention_probe(variant: str, q, k, v, indices, counts, seqlens, *,
                    q_rows: int = 1, sm_scale=None, text_amp: float = 0.0,
                    text_start_block: int = 0):
    """One probe variant over the all-member lists of
    ``block_sparse_attention`` (``indices`` int32 [B, H, ngroups, nkb],
    ``counts`` [B, H, ngroups], ``seqlens`` [B]); bf16 [B, H, S, 128]
    operands. Returns [B, H, S, 128].

    CPU tensors take the plain version; CUDA tensors launch the kernel or
    raise."""
    if variant not in _VARIANT_ID:
        raise ValueError(f"unknown probe variant {variant!r}")
    if sm_scale is None:
        sm_scale = q.shape[-1] ** -0.5
    kw = dict(q_rows=q_rows, sm_scale=sm_scale, text_amp=text_amp,
              text_start_block=text_start_block)
    if not q.is_cuda:
        return attention_probe_plain(variant, q, k, v, indices, counts,
                                     seqlens, **kw)
    _check_operands(q, k, v, indices, counts, None, seqlens, q_rows)
    b, h, s, d = q.shape
    if d != _HEAD_DIM:
        raise ValueError(f"attention_probe: head dim {d} is not supported "
                         f"(the kernel takes {_HEAD_DIM})")
    q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
    for x in (q, k, v):
        if x.data_ptr() % 16:
            raise ValueError("attention_probe: operands must be 16-byte "
                             "aligned")
    skv = k.shape[2]
    maxk = max_key_norms(k)
    out = torch.empty_like(q)
    lib = build_kernel()
    err = lib.attn_probe_forward(
        _VARIANT_ID[variant], q.data_ptr(), k.data_ptr(), v.data_ptr(),
        out.data_ptr(), indices.data_ptr(), counts.data_ptr(),
        seqlens.data_ptr(), maxk.data_ptr(), b * h, h, s, skv, skv // 128,
        indices.shape[2], int(q_rows), int(text_start_block), float(sm_scale),
        float(text_amp), torch.cuda.current_stream(q.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"attention_probe {variant} launch failed: "
                           + lib.attn_probe_error_string(err).decode())
    if variant in SPLIT_VARIANTS:
        attention_probe.split_launches += 1
    else:
        attention_probe.epilogue_launches += 1
    return out


attention_probe.split_launches = 0
attention_probe.epilogue_launches = 0

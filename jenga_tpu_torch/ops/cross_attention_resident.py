"""Resident-KV cross-attention over 512 keys, probe kernel P4: the CUDA
wrapper, its plain torch version and its launch counter.

The kernel (``csrc/cross_attn_resident.cu``) replaces the JAX package's
Pallas TPU probe ``cross_resident`` (``tools/wan_overhead_probe2.py:122``):
Wan's cross-attention, every query row attending all 512 text keys with
no mask, one thread block staying on one (batch, head) for ``bq`` query
rows with K resident in shared memory, on the Hopper primitives of
``csrc/attn_sm90.cuh`` (a TMA producer warp, two wgmma consumer
warpgroups). No main path calls it: the model's cross-attention runs
kernel D (``ops/flash_attention.py``), and the port's
``tools/wan_overhead_probe2.py`` times the two on the same operands.

``cross_attention_resident`` launches the kernel for CUDA tensors and takes
the plain version only for CPU tensors; a build or launch failure raises.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from .cuda_build import CSRC, build_library
from .flash_attention import dense_attention_plain

__all__ = ["cross_attention_resident", "cross_attention_resident_plain",
           "NUM_KEYS", "build_kernel", "KERNEL_SOURCE"]

NUM_KEYS = 512
_HEAD_DIM = 128
_BLOCK = 128
KERNEL_SOURCE = CSRC / "cross_attn_resident.cu"


@functools.lru_cache(maxsize=1)
def build_kernel() -> ctypes.CDLL:
    """Build (once per source hash) and load the kernel library."""
    lib = build_library(KERNEL_SOURCE)
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.xattn_resident_forward.argtypes = [p, p, p, p, i, i, i, f, p]
    lib.xattn_resident_forward.restype = ctypes.c_int
    lib.xattn_resident_error_string.argtypes = [ctypes.c_int]
    lib.xattn_resident_error_string.restype = ctypes.c_char_p
    return lib


def cross_attention_resident_plain(q, k, v, *, sm_scale=None):
    """The kernel's plain version: dense softmax attention in f32 over
    every key, cast to q's dtype."""
    return dense_attention_plain(q, k, v, sm_scale=sm_scale)


def cross_attention_resident(q, k, v, *, bq: int = 2048, sm_scale=None):
    """Softmax attention of ``q`` [B, H, S, 128] over all 512 keys of
    ``k``, ``v`` [B, H, 512, 128] (bf16 on CUDA); a thread block covers
    ``bq`` query rows (a multiple of 128) of one (batch, head); ``sm_scale``
    (default 128 ** -0.5) must be positive. Returns [B, H, S, 128] in q's
    dtype.

    CPU tensors take the plain version; CUDA tensors launch the kernel or
    raise."""
    if sm_scale is None:
        sm_scale = q.shape[-1] ** -0.5
    if not q.is_cuda:
        return cross_attention_resident_plain(q, k, v, sm_scale=sm_scale)
    if not (k.is_cuda and v.is_cuda):
        raise ValueError("cross_attention_resident: q, k and v must lie on "
                         "the same CUDA device")
    for name, x in (("q", q), ("k", k), ("v", v)):
        if x.dtype != torch.bfloat16:
            raise TypeError(f"cross_attention_resident: {name} must be "
                            f"bfloat16, got {x.dtype}")
    b, h, s, d = q.shape
    if d != _HEAD_DIM or k.shape != (b, h, NUM_KEYS, d) or v.shape != k.shape:
        raise ValueError(f"cross_attention_resident takes q [B, H, S, "
                         f"{_HEAD_DIM}] and k, v [B, H, {NUM_KEYS}, "
                         f"{_HEAD_DIM}], got q{tuple(q.shape)} "
                         f"k{tuple(k.shape)} v{tuple(v.shape)}")
    if bq < _BLOCK or bq % _BLOCK:
        raise ValueError(f"bq must be a positive multiple of {_BLOCK}, got "
                         f"{bq}")
    if not sm_scale > 0:
        raise ValueError(f"sm_scale must be positive, got {sm_scale}")
    q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
    for x in (q, k, v):
        if x.data_ptr() % 16:
            raise ValueError("cross_attention_resident: operands must be "
                             "16-byte aligned")
    out = torch.empty_like(q)
    lib = build_kernel()
    err = lib.xattn_resident_forward(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), b * h, s,
        int(bq), float(sm_scale),
        torch.cuda.current_stream(q.device).cuda_stream)
    if err != 0:
        raise RuntimeError("cross_attention_resident launch failed: "
                           + lib.xattn_resident_error_string(err).decode())
    cross_attention_resident.launches += 1
    return out


cross_attention_resident.launches = 0

"""Block mean pooling, probe kernel P3: the CUDA wrapper, its plain torch
version and its launch counter.

The kernel (``csrc/block_pool.cu``) replaces the JAX package's Pallas TPU
probe ``pool_pallas`` (``tools/pool_probe.py:111``): the f32 mean of each
128-token block, bf16 [B, H, S, D] -> f32 [B, H, S // 128, D], the
planner's pooling. No main path calls it: the planner keeps its own
``_pool`` (``sparse/planner.py``), and the pool probe
(``jenga_tpu_torch/tools/pool_probe.py``) times the two side by side.

``block_pool`` launches the kernel for CUDA tensors and takes the plain
version only for CPU tensors; a build or launch failure raises.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from .cuda_build import CSRC, build_library

__all__ = ["block_pool", "block_pool_plain", "build_kernel",
           "KERNEL_SOURCE"]

_BLOCK = 128
_HEAD_DIM = 128
KERNEL_SOURCE = CSRC / "block_pool.cu"


@functools.lru_cache(maxsize=1)
def build_kernel() -> ctypes.CDLL:
    """Build (once per source hash) and load the kernel library."""
    lib = build_library(KERNEL_SOURCE)
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.block_pool_forward.argtypes = [p, p, i, i, i, p]
    lib.block_pool_forward.restype = ctypes.c_int
    lib.block_pool_error_string.argtypes = [ctypes.c_int]
    lib.block_pool_error_string.restype = ctypes.c_char_p
    return lib


def block_pool_plain(x):
    """The kernel's plain version: the f32 mean of each whole 128-token
    block (tail tokens past the last whole block are dropped)."""
    b, h, s, d = x.shape
    nb = s // _BLOCK
    return x[:, :, :nb * _BLOCK].reshape(b, h, nb, _BLOCK, d).float() \
        .mean(3)


def block_pool(x, *, chunk: int = 16):
    """f32 [B, H, S // 128, D] block means of ``x`` [B, H, S, D]; on CUDA
    ``x`` is bf16 with D = 128 and one thread block covers ``chunk``
    consecutive blocks of one (batch, head).

    CPU tensors take the plain version; CUDA tensors launch the kernel or
    raise."""
    if not x.is_cuda:
        return block_pool_plain(x)
    b, h, s, d = x.shape
    if x.dtype != torch.bfloat16:
        raise TypeError(f"block_pool: x must be bfloat16, got {x.dtype}")
    if d != _HEAD_DIM or s < _BLOCK:
        raise ValueError(f"block_pool: takes D = {_HEAD_DIM} and S >= "
                         f"{_BLOCK}, got {tuple(x.shape)}")
    if chunk < 1:
        raise ValueError(f"block_pool: chunk must be >= 1, got {chunk}")
    x = x.contiguous()
    out = torch.empty((b, h, s // _BLOCK, d), dtype=torch.float32,
                      device=x.device)
    lib = build_kernel()
    err = lib.block_pool_forward(
        x.data_ptr(), out.data_ptr(), b * h, s, int(chunk),
        torch.cuda.current_stream(x.device).cuda_stream)
    if err != 0:
        raise RuntimeError("block_pool launch failed: "
                           + lib.block_pool_error_string(err).decode())
    block_pool.launches += 1
    return out


block_pool.launches = 0

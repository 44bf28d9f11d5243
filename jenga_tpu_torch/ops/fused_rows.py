"""The DiT trunk's row kernels: LayerNorm or RMSNorm with modulation or
RoPE in one pass, and the gated residual. The CUDA wrappers, the rule for
the inputs they take, and their launch counters.

The kernels (``csrc/fused_rows.cu``) replace no Pallas kernel: the JAX
package leaves these chains to XLA's fusions, and eager PyTorch runs each
as some ten kernels with an f32 intermediate of the whole activation
between each two. Each entry point here reads its bf16 rows once and
writes them once:

- ``norm_modulate``: ``modulate(layer_norm(x, weight, bias), shift,
  scale)`` (``rms_norm(x, weight)`` with ``rms``; no modulation when
  ``shift`` and ``scale`` are None);
- ``rms_norm_rope``: ``rms_norm(x, weight)`` and then ``apply_rope`` on
  the interleaved pairs of each head (``2 * cos.shape[1]`` elements of the
  last dim) of the first ``rope_rows`` tokens (dim 1); the later tokens
  are normed only;
- ``gated_residual``: ``(x.float() + y.float() * gate).to(bf16)``.

The plain versions are the chains themselves, in ``models/layers.py``
(``layer_norm``, ``rms_norm``, ``modulate``, ``apply_rope``), whose
``norm_modulate``, ``rms_norm_rope`` and ``gated`` choose between the two
paths: an input takes a kernel when ``row_refusal`` (``gated_refusal``)
finds nothing against it, that is, no autograd (``torch.is_grad_enabled()``
and an input that requires grad), bf16 rows whose last dim is contiguous,
a row length that is a multiple of 8 and at most ``MAX_ROW``, f32 [R]
weights, f32 [B or 1, 1, R] modulation vectors and gates, f32 RoPE tables
over heads of a power of two, 16-byte aligned data, and CUDA tensors.
Everything else (HunyuanVideo-I2V's token replacement too) takes the chain
unchanged. Each wrapper here launches its kernel or raises; the
``layers`` functions, having asked the rule once, launch through
``launch_row_norm`` and ``launch_gated``, which check nothing.

Counters: ``norm_modulate.launches``, ``rms_norm_rope.launches``,
``gated_residual.launches``; ``.fallbacks`` on each counts the CUDA calls
of its ``layers`` function that took the chain.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from .cuda_build import CSRC, build_library

__all__ = ["norm_modulate", "rms_norm_rope", "gated_residual",
           "launch_row_norm", "launch_gated", "row_refusal", "gated_refusal",
           "build_kernel", "KERNEL_SOURCE", "MAX_ROW"]

KERNEL_SOURCE = CSRC / "fused_rows.cu"
MAX_ROW = 5120          # Wan-14B's width: 20 vectors of 8 in each of 32 lanes
_MAX_ROWS = 2 ** 31     # row indices are 32-bit in the kernels


@functools.lru_cache(maxsize=1)
def build_kernel() -> ctypes.CDLL:
    """Build (once per source hash) and load the kernel library."""
    lib = build_library(KERNEL_SOURCE)
    p, i, u, ll = (ctypes.c_void_p, ctypes.c_int, ctypes.c_uint,
                   ctypes.c_longlong)
    lib.fused_rows_norm.argtypes = [p, p, u, u, u, i, ll, ll, ll, i,
                                    ctypes.c_float, p, p, p, ll, p, ll, p, p,
                                    i, i, p]
    lib.fused_rows_norm.restype = ctypes.c_int
    lib.fused_rows_gated.argtypes = [p, p, p, p, u, u, i, ll, p]
    lib.fused_rows_gated.restype = ctypes.c_int
    lib.fused_rows_error_string.argtypes = [ctypes.c_int]
    lib.fused_rows_error_string.restype = ctypes.c_char_p
    return lib


def _aligned(t) -> bool:
    return t.data_ptr() % 16 == 0


def _autograd(*tensors) -> bool:
    return torch.is_grad_enabled() and any(
        t is not None and t.requires_grad for t in tensors)


def _rows_refusal(x, what: str = "x"):
    """Why bf16 rows ``x`` ([B, S, R] or [B, S, G, R], last dim contiguous)
    do not fit the kernels, or None."""
    if x.dtype != torch.bfloat16:
        return f"{what} is {x.dtype}, not bfloat16"
    if x.dim() not in (3, 4):
        return f"{what} has {x.dim()} dims, not 3 or 4"
    r = x.shape[-1]
    if r % 8 or not 0 < r <= MAX_ROW:
        return f"row length {r} is not a multiple of 8 up to {MAX_ROW}"
    if x.stride(-1) != 1 or any(st % 8 for st in x.stride()[:-1]) \
            or not _aligned(x):
        return f"{what}'s rows are not contiguous 16-byte aligned vectors"
    if not 0 < x.numel() // r < _MAX_ROWS:
        return f"{what} has {x.numel() // r} rows"
    return None


def _vector_refusal(v, x, name: str):
    """Why ``v`` is neither an f32 [R] vector nor an f32 [B or 1, 1, ..,
    R] vector per batch of ``x``, or None."""
    if v is None:
        return None
    r = x.shape[-1]
    if v.dtype != torch.float32:
        return f"{name} is {v.dtype}, not float32"
    if v.shape[-1] != r or v.stride(-1) != 1 or not _aligned(v):
        return f"{name} is not 16-byte aligned f32 rows of {r}"
    if v.dim() == 1:
        return None
    if v.dim() != x.dim() or v.shape[0] not in (1, x.shape[0]) \
            or any(n != 1 for n in v.shape[1:-1]) or v.stride(0) % 4:
        return f"{name} of shape {tuple(v.shape)} is not [B or 1, 1, {r}]"
    return None


def row_refusal(x, weight=None, bias=None, shift=None, scale=None,
                cos=None, sin=None, rope_rows: int = 0):
    """Why the row-norm kernel does not take these inputs (a string), or
    None when it does. ``weight`` and ``bias`` are f32 [R]; ``shift`` and
    ``scale`` f32 [B or 1, 1, R] (one vector per batch of x); ``cos`` and
    ``sin`` f32 [>= rope_rows, head_dim / 2] with the head_dim a power of
    two from 8 and R a multiple of it. The device is checked last, so that a CPU test reads the
    other reasons."""
    if _autograd(x, weight, bias, shift, scale, cos, sin):
        return "autograd: an input requires grad"
    reason = _rows_refusal(x)
    if reason:
        return reason
    for v, name in ((weight, "weight"), (bias, "bias")):
        if v is not None and (v.dim() != 1 or _vector_refusal(v, x, name)):
            return f"{name} is not an aligned f32 [{x.shape[-1]}]"
    for v, name in ((shift, "shift"), (scale, "scale")):
        if v is not None and v.dim() == 1:
            return f"{name} is not [B or 1, 1, {x.shape[-1]}]"
        reason = _vector_refusal(v, x, name)
        if reason:
            return reason
    if cos is not None:
        hd = 2 * cos.shape[-1]
        if any(t.dtype != torch.float32 or t.dim() != 2
               or t.shape != cos.shape or not t.is_contiguous()
               or not _aligned(t) for t in (cos, sin)):
            return "cos and sin are not aligned contiguous f32 tables alike"
        if hd < 8 or hd & (hd - 1) or x.shape[-1] % hd \
                or cos.shape[0] < rope_rows:
            return (f"RoPE tables {tuple(cos.shape)} do not fit rows of "
                    f"{x.shape[-1]} over {rope_rows} tokens")
    if not all(t.is_cuda for t in (x, weight, bias, shift, scale, cos, sin)
               if t is not None):
        return "not on a CUDA device"
    return None


def gated_refusal(x, y, gate):
    """Why the gated-residual kernel does not take these inputs, or None:
    x and y bf16 [B, S, R] or [B, S, G, R] alike and contiguous, gate an
    f32 [B or 1, 1, .., R] vector per batch. The device is checked last."""
    if _autograd(x, y, gate):
        return "autograd: an input requires grad"
    for t, name in ((x, "x"), (y, "y")):
        reason = _rows_refusal(t, name)
        if reason:
            return reason
        if not t.is_contiguous():
            return f"{name} is not contiguous"
    if y.shape != x.shape:
        return f"y {tuple(y.shape)} is not shaped as x {tuple(x.shape)}"
    reason = _vector_refusal(gate, x, "gate")
    if reason or gate.dim() == 1:
        return reason or "gate is not [B or 1, 1, R]"
    if not all(t.is_cuda for t in (x, y, gate)):
        return "not on a CUDA device"
    return None


def _check(name: str, reason):
    if reason:
        raise ValueError(f"{name}: {reason}")


def _batch_stride(v) -> int:
    return 0 if v is None or v.shape[0] == 1 else v.stride(0)


def _row_norm(x, weight, bias, shift, scale, cos, sin, rope_rows, eps, rms):
    lib = build_kernel()
    b, s = x.shape[:2]
    g = x.shape[2] if x.dim() == 4 else 1
    sb, ss = x.stride(0), x.stride(1)
    sg = x.stride(2) if x.dim() == 4 else 0
    out = torch.empty(x.shape, dtype=x.dtype, device=x.device)

    def ptr(t):
        return None if t is None else t.data_ptr()

    err = lib.fused_rows_norm(
        x.data_ptr(), out.data_ptr(), b * s * g, s, g, x.shape[-1], sb, ss,
        sg, int(rms), float(eps), ptr(weight), ptr(bias), ptr(shift),
        _batch_stride(shift), ptr(scale), _batch_stride(scale), ptr(cos),
        ptr(sin), 0 if cos is None else 2 * cos.shape[-1], int(rope_rows),
        torch.cuda.current_stream(x.device).cuda_stream)
    if err != 0:
        raise RuntimeError("fused_rows_norm launch failed: "
                           + lib.fused_rows_error_string(err).decode())
    return out


def _gated(x, y, gate):
    lib = build_kernel()
    r = x.shape[-1]
    rows = x.numel() // r
    out = torch.empty_like(x)
    err = lib.fused_rows_gated(
        x.data_ptr(), y.data_ptr(), gate.data_ptr(), out.data_ptr(), rows,
        rows // x.shape[0], r, _batch_stride(gate),
        torch.cuda.current_stream(x.device).cuda_stream)
    if err != 0:
        raise RuntimeError("fused_rows_gated launch failed: "
                           + lib.fused_rows_error_string(err).decode())
    return out


def launch_row_norm(x, weight=None, bias=None, shift=None, scale=None,
                    cos=None, sin=None, rope_rows: int = 0, *,
                    eps: float = 1e-6, rms: bool = False):
    """The row-norm kernel on inputs ``row_refusal`` has taken, unchecked:
    counted under ``rms_norm_rope`` with RoPE tables, else under
    ``norm_modulate``. RMSNorm takes no bias."""
    out = _row_norm(x, weight, None if rms else bias, shift, scale, cos, sin,
                    rope_rows, eps, rms)
    (norm_modulate if cos is None else rms_norm_rope).launches += 1
    return out


def launch_gated(x, y, gate):
    """The gated-residual kernel on inputs ``gated_refusal`` has taken,
    unchecked and counted."""
    out = _gated(x, y, gate)
    gated_residual.launches += 1
    return out


def norm_modulate(x, weight=None, bias=None, shift=None, scale=None, *,
                  eps: float = 1e-6, rms: bool = False):
    """LayerNorm (RMSNorm with ``rms``) over x's last dim with the optional
    f32 ``weight`` and ``bias``, rounded to bf16, then ``x * (1 + scale) +
    shift`` with the optional f32 [B or 1, 1, R] vectors: one kernel
    launch, a new contiguous bf16 tensor shaped as x. Raises on an input
    ``row_refusal`` refuses."""
    _check("norm_modulate", row_refusal(x, weight, bias, shift, scale))
    if rms and bias is not None:
        raise ValueError("norm_modulate: RMSNorm takes no bias")
    return launch_row_norm(x, weight, bias, shift, scale, eps=eps, rms=rms)


def rms_norm_rope(x, weight, cos, sin, *, eps: float = 1e-6,
                  rope_rows: int | None = None):
    """RMSNorm over x's last dim with the f32 ``weight``, rounded to bf16,
    then the interleaved RoPE of each head (``2 * cos.shape[1]`` elements)
    of the tokens ``s < rope_rows`` (x's dim 1; all by default) by
    ``cos[s]``, ``sin[s]``: one kernel launch, a new contiguous bf16 tensor
    shaped as x. x may be a strided view ([B, S, G, R] rows of a fused qkv
    projection). Raises on an input ``row_refusal`` refuses."""
    rope_rows = x.shape[1] if rope_rows is None else int(rope_rows)
    _check("rms_norm_rope", row_refusal(x, weight, cos=cos, sin=sin,
                                        rope_rows=rope_rows))
    return launch_row_norm(x, weight, cos=cos, sin=sin, rope_rows=rope_rows,
                           eps=eps, rms=True)


def gated_residual(x, y, gate):
    """``(x.float() + y.float() * gate).to(bf16)`` in one kernel launch:
    x, y bf16 alike and contiguous, gate f32 [B or 1, 1, R]. Raises on an
    input ``gated_refusal`` refuses."""
    _check("gated_residual", gated_refusal(x, y, gate))
    return launch_gated(x, y, gate)


for _fn in (norm_modulate, rms_norm_rope, gated_residual):
    _fn.launches = 0
    _fn.fallbacks = 0
del _fn

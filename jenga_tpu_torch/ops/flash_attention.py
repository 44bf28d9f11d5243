"""Dense attention with per-sample ``kv_len``: the CUDA kernel's wrapper,
its plain torch version and its launch counter.

Port of ``jenga_tpu/ops/flash_attention.py``'s semantics: keys at
positions >= ``kv_len[b]`` are masked out, and a row whose every key is
masked gives zeros, not NaN (``_masked_softmax``). The kernel
(``csrc/dense_attn.cu``) replaces the stock Pallas TPU flash kernel that
``dense_attention`` calls on the TPU; it serves Wan's cross-attention,
Wan's dense warm-up steps and HunyuanVideo's dense arm. It is built at
first use by ``cuda_build.build_library``.

``dense_attention`` launches the kernel for CUDA tensors (bf16, head dim
128, non-causal, or it raises) and uses the plain version only for CPU
tensors; there is no fallback between the two.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from .cuda_build import CSRC, build_library

__all__ = ["dense_attention", "dense_attention_plain", "attention_bshd",
           "build_kernel", "KERNEL_SOURCE"]

_HEAD_DIM = 128
_SLAB = 1 << 28     # logits elements per query chunk of the plain version
KERNEL_SOURCE = CSRC / "dense_attn.cu"


@functools.lru_cache(maxsize=1)
def build_kernel() -> ctypes.CDLL:
    """Build (once per source hash) and load the kernel library."""
    lib = build_library(KERNEL_SOURCE)
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.dense_attn_forward.argtypes = [p, p, p, p, p, i, i, i, i, f, p]
    lib.dense_attn_forward.restype = ctypes.c_int
    lib.dense_attn_error_string.argtypes = [ctypes.c_int]
    lib.dense_attn_error_string.restype = ctypes.c_char_p
    return lib


def _masked_softmax(logits):
    """Softmax giving all-zero weights for fully masked (-inf) rows."""
    m = logits.amax(dim=-1, keepdim=True)
    p = torch.exp(logits - torch.where(torch.isfinite(m), m, 0.0))
    return p / p.sum(dim=-1, keepdim=True).clamp_min(1e-30)


def _kv_len_tensor(kv_len, b: int, device):
    return torch.as_tensor(kv_len, device=device).reshape(-1).expand(b)


def dense_attention_plain(q, k, v, *, sm_scale: float | None = None,
                          kv_len=None):
    """The kernel's plain version over [B, H, S, D], in f32: the query
    axis is chunked so one chunk's logits stay under 2^28 elements."""
    b, h, sq, d = q.shape
    skv = k.shape[2]
    if sm_scale is None:
        sm_scale = d ** -0.5
    kmask = None
    if kv_len is not None:
        kl = _kv_len_tensor(kv_len, b, q.device)
        kmask = (torch.arange(skv, device=q.device)[None] < kl[:, None]
                 )[:, None, None]
    kf, vf = k.float(), v.float()
    out = torch.empty_like(q)
    chunk = max(1, _SLAB // max(1, b * h * skv))
    for c0 in range(0, sq, chunk):
        qc = q[:, :, c0:c0 + chunk].float()
        logits = torch.einsum("bhqd,bhkd->bhqk", qc, kf) * sm_scale
        if kmask is not None:
            logits = logits.masked_fill(~kmask, float("-inf"))
        p = _masked_softmax(logits)
        out[:, :, c0:c0 + chunk] = torch.einsum(
            "bhqk,bhkd->bhqd", p, vf).to(q.dtype)
    return out


def _check_operands(q, k, v):
    if not (q.is_cuda and k.is_cuda and v.is_cuda):
        raise ValueError("dense_attention: q, k and v must lie on the same "
                         "CUDA device")
    for name, x in (("q", q), ("k", k), ("v", v)):
        if x.dtype != torch.bfloat16:
            raise TypeError(f"dense_attention: {name} must be bfloat16, got "
                            f"{x.dtype}")
    b, h, _, d = q.shape
    skv = k.shape[2]
    if k.shape != (b, h, skv, d) or v.shape != k.shape:
        raise ValueError(f"shape mismatch q{tuple(q.shape)} "
                         f"k{tuple(k.shape)} v{tuple(v.shape)}")
    if d != _HEAD_DIM:
        raise ValueError(f"dense_attention: head dim {d} is not supported "
                         f"on CUDA (the kernel takes {_HEAD_DIM})")


def dense_attention(q, k, v, *, sm_scale: float | None = None,
                    causal: bool = False, kv_len=None):
    """Dense non-causal attention over [B, H, S, D]; ``kv_len`` None or [B]
    valid key counts. Returns [B, H, Sq, D] in q's dtype.

    CPU tensors take the plain version; CUDA tensors launch the kernel or
    raise."""
    if causal:
        raise NotImplementedError("causal dense attention is not ported")
    b, h, sq, d = q.shape
    if sm_scale is None:
        sm_scale = d ** -0.5
    if not q.is_cuda:
        return dense_attention_plain(q, k, v, sm_scale=sm_scale,
                                     kv_len=kv_len)
    _check_operands(q, k, v)
    q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
    for x in (q, k, v):
        if x.data_ptr() % 16:
            raise ValueError("dense_attention: operands must be 16-byte "
                             "aligned")
    kl_ptr = None
    if kv_len is not None:
        kl = _kv_len_tensor(kv_len, b, q.device).to(torch.int32).contiguous()
        kl_ptr = kl.data_ptr()
    out = torch.empty_like(q)
    lib = build_kernel()
    err = lib.dense_attn_forward(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), kl_ptr,
        b * h, h, sq, k.shape[2], float(sm_scale),
        torch.cuda.current_stream(q.device).cuda_stream)
    if err != 0:
        raise RuntimeError("dense_attention launch failed: "
                           + lib.dense_attn_error_string(err).decode())
    dense_attention.launches += 1
    return out


dense_attention.launches = 0


def attention_bshd(q, k, v, **kwargs):
    """Dense attention over the model-side [B, S, H, D] layout."""
    out = dense_attention(q.transpose(1, 2), k.transpose(1, 2),
                          v.transpose(1, 2), **kwargs)
    return out.transpose(1, 2)

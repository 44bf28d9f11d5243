"""Dense attention with per-sample ``kv_len``: the CUDA kernels' wrappers
(forward D on two routes, backward dK|dV and dQ), their plain torch
versions, the autograd Function that joins them, and the launch counters.

Port of ``jenga_tpu/ops/flash_attention.py``'s semantics: keys at
positions >= ``kv_len[b]`` are masked out, and a row whose every key is
masked gives zeros, not NaN (``_masked_softmax``). The forward kernels
replace the stock Pallas TPU flash kernel that ``dense_attention`` calls
on the TPU. Which one a CUDA call launches follows from its key count
alone (``dense_route``): up to ``SHORT_KEYS`` keys the short-key kernel
(``csrc/dense_attn_short.cu``: persistent blocks with every key
resident, reading and writing the caller's strides, so
``attention_bshd`` takes the model's [B, S, H, D] layout without a
copy), over it the mainloop instance (``csrc/dense_attn.cu``, on
contiguous [B, H, S, D] copies). They serve Wan's cross-attention (short)
and Wan's dense warm-up steps and HunyuanVideo's dense arm (mainloop).
Under autograd (``torch.is_grad_enabled()`` and an operand that requires
grad) the call goes through ``_DenseAttention``: the forward kernel also
stores each row's base-2 log-sum-exp, and the backward replaces the stock
kernel's ``_flash_attention_bwd_dkv`` and ``_flash_attention_bwd_dq`` on
the same two routes. Up to ``SHORT_KEYS`` keys one call
(``csrc/dense_attn_bwd_short.cu``) launches a dQ kernel that also computes
``di = rowsum(dO * O)`` from the tiles it loads, then a dK|dV kernel (and
the sum of its chunks' partials), reading and writing the caller's
strides; over it ``di`` is computed in torch (as JAX does in jnp outside
its kernels) and the dK|dV and dQ kernels of ``csrc/dense_attn_bwd.cu``
run on contiguous copies. Each source is built at first use by
``cuda_build.build_library``.

Every entry point launches its kernel for CUDA tensors (bf16, head dim
128, or it raises) and uses its plain version only for CPU tensors; there
is no fallback between the two, and none between the routes.
``dense_attention(causal=True)`` reaches no kernel: as in JAX, which
computes it in jnp, it is plain torch on either device
(``_causal_attention``). Counters: ``dense_attention.launches`` (every
forward launch, on either route, with or without the statistics),
``dense_attention.short_launches`` (those of the short-key route),
``dense_attention_backward.dkv_launches`` and ``.dq_launches`` (the
route over ``SHORT_KEYS`` keys) and ``.short_launches`` (the short-key
backward, one per call).
"""

from __future__ import annotations

import ctypes
import functools
import math

import torch

from .. import obs
from .cuda_build import CSRC, build_library

__all__ = ["dense_attention", "dense_attention_plain",
           "dense_attention_forward", "dense_attention_backward",
           "dense_attention_backward_plain", "attention_bshd",
           "dense_route", "build_kernel", "build_short_kernel",
           "bind_short_kernel", "build_bwd_kernel",
           "build_bwd_short_kernel", "bind_bwd_short_kernel",
           "KERNEL_SOURCE", "SHORT_KERNEL_SOURCE", "BWD_KERNEL_SOURCE",
           "BWD_SHORT_KERNEL_SOURCE", "SHORT_KEYS"]

_HEAD_DIM = 128
_BLOCK = 128        # query rows per forward thread block (the lse padding)
_SLAB = 1 << 28     # logits elements per query chunk of the plain versions
_LOG2E = 1.4426950408889634
SHORT_KEYS = 512    # the most keys the short-key kernel holds resident
KERNEL_SOURCE = CSRC / "dense_attn.cu"
SHORT_KERNEL_SOURCE = CSRC / "dense_attn_short.cu"
BWD_KERNEL_SOURCE = CSRC / "dense_attn_bwd.cu"
BWD_SHORT_KERNEL_SOURCE = CSRC / "dense_attn_bwd_short.cu"
# the short backward's dK|dV grid: estimated microseconds of one (64-query,
# 128-key) item and of one f32 partial written and summed (256 KB at the
# H100's 3.35 TB/s), which set its query chunk count (``_dkv_chunks``)
_ITEM_US = 1.9
_PART_US = 0.08


@functools.lru_cache(maxsize=1)
def build_kernel() -> ctypes.CDLL:
    """Build (once per source hash) and load the forward kernel library."""
    lib = build_library(KERNEL_SOURCE)
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.dense_attn_forward.argtypes = [p, p, p, p, p, p, i, i, i, i, f, p]
    lib.dense_attn_forward.restype = ctypes.c_int
    lib.dense_attn_error_string.argtypes = [ctypes.c_int]
    lib.dense_attn_error_string.restype = ctypes.c_char_p
    return lib


@functools.lru_cache(maxsize=1)
def build_short_kernel() -> ctypes.CDLL:
    """Build (once per source hash) and load the short-key forward kernel
    library."""
    return bind_short_kernel(build_library(SHORT_KERNEL_SOURCE))


def bind_short_kernel(lib: ctypes.CDLL) -> ctypes.CDLL:
    """Declare the short-key kernel library's C interface on ``lib``."""
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.dense_attn_short_forward.argtypes = [p] * 6 + [i, i, i, i, p, f, p]
    lib.dense_attn_short_forward.restype = ctypes.c_int
    lib.dense_attn_short_error_string.argtypes = [ctypes.c_int]
    lib.dense_attn_short_error_string.restype = ctypes.c_char_p
    return lib


@functools.lru_cache(maxsize=1)
def build_bwd_kernel() -> ctypes.CDLL:
    """Build (once per source hash) and load the backward kernel library."""
    lib = build_library(BWD_KERNEL_SOURCE)
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.dense_attn_bwd_dkv.argtypes = [p] * 9 + [i, i, i, i, f, p]
    lib.dense_attn_bwd_dkv.restype = ctypes.c_int
    lib.dense_attn_bwd_dq.argtypes = [p] * 8 + [i, i, i, i, f, p]
    lib.dense_attn_bwd_dq.restype = ctypes.c_int
    lib.dense_attn_bwd_error_string.argtypes = [ctypes.c_int]
    lib.dense_attn_bwd_error_string.restype = ctypes.c_char_p
    return lib


@functools.lru_cache(maxsize=1)
def build_bwd_short_kernel() -> ctypes.CDLL:
    """Build (once per source hash) and load the short-key backward
    kernel library."""
    return bind_bwd_short_kernel(build_library(BWD_SHORT_KERNEL_SOURCE))


def bind_bwd_short_kernel(lib: ctypes.CDLL) -> ctypes.CDLL:
    """Declare the short-key backward library's C interface on ``lib``."""
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.dense_attn_bwd_short.argtypes = [p] * 12 + [i, i, i, i, p, f, i, i,
                                                    i, p]
    lib.dense_attn_bwd_short.restype = ctypes.c_int
    lib.dense_attn_bwd_short_error_string.argtypes = [ctypes.c_int]
    lib.dense_attn_bwd_short_error_string.restype = ctypes.c_char_p
    return lib


def _masked_softmax(logits):
    """Softmax giving all-zero weights for fully masked (-inf) rows."""
    m = logits.amax(dim=-1, keepdim=True)
    p = torch.exp(logits - torch.where(torch.isfinite(m), m, 0.0))
    return p / p.sum(dim=-1, keepdim=True).clamp_min(1e-30)


def _kv_len_tensor(kv_len, b: int, device):
    return torch.as_tensor(kv_len, device=device).reshape(-1).expand(b)


def _key_mask(kv_len, b: int, skv: int, device):
    """[B, 1, 1, Skv] bool of the keys below ``kv_len``, or None."""
    if kv_len is None:
        return None
    kl = _kv_len_tensor(kv_len, b, device)
    return (torch.arange(skv, device=device)[None] < kl[:, None]
            )[:, None, None]


def _chunk(b: int, h: int, skv: int) -> int:
    return max(1, _SLAB // max(1, b * h * skv))


def _plain_forward(q, k, v, sm_scale: float, kv_len, with_lse: bool):
    """(out, lse or None), in f32 with the query axis chunked so one
    chunk's logits stay under 2^28 elements. ``lse`` [B, H, Sq] f32 is the
    log-sum-exp of the base-2 logits ``q.k * sm_scale * log2(e)``, +inf
    for a row with no valid key (the kernel's statistics)."""
    b, h, sq, d = q.shape
    skv = k.shape[2]
    kmask = _key_mask(kv_len, b, skv, q.device)
    kf, vf = k.float(), v.float()
    out = torch.empty_like(q)
    lse = (torch.empty((b, h, sq), dtype=torch.float32, device=q.device)
           if with_lse else None)
    chunk = _chunk(b, h, skv)
    for c0 in range(0, sq, chunk):
        qc = q[:, :, c0:c0 + chunk].float()
        logits = torch.einsum("bhqd,bhkd->bhqk", qc, kf) * sm_scale
        if kmask is not None:
            logits = logits.masked_fill(~kmask, float("-inf"))
        p = _masked_softmax(logits)
        out[:, :, c0:c0 + chunk] = torch.einsum(
            "bhqk,bhkd->bhqd", p, vf).to(q.dtype)
        if with_lse:
            ls = torch.logsumexp(logits, dim=-1) * _LOG2E
            lse[:, :, c0:c0 + chunk] = ls.nan_to_num(nan=float("inf"),
                                                    neginf=float("inf"))
    return out, lse


def dense_attention_plain(q, k, v, *, sm_scale: float | None = None,
                          kv_len=None):
    """The forward kernel's plain version over [B, H, S, D], in f32."""
    if sm_scale is None:
        sm_scale = q.shape[-1] ** -0.5
    return _plain_forward(q, k, v, sm_scale, kv_len, False)[0]


def dense_attention_backward_plain(q, k, v, o, lse, do, *,
                                   sm_scale: float | None = None,
                                   kv_len=None):
    """The backward kernels' plain version: (dq, dk, dv) in the operands'
    dtypes from the forward's output ``o`` and statistics ``lse`` [B, H,
    Sq] (base 2, as ``dense_attention_forward`` returns them), computed
    in f32 with the query axis chunked: P = exp2(s * log2(e) - lse), di =
    rowsum(dO * O), dS = P * (dP - di), dQ = sm_scale dS K, dK = sm_scale
    dS^T Q, dV = P^T dO. Keys at or past ``kv_len`` get zero gradients,
    and a row with no valid key (lse +inf) gives dQ = 0."""
    b, h, sq, d = q.shape
    skv = k.shape[2]
    if sm_scale is None:
        sm_scale = d ** -0.5
    kmask = _key_mask(kv_len, b, skv, q.device)
    kf, vf = k.float(), v.float()
    dq = torch.empty(q.shape, dtype=torch.float32, device=q.device)
    dk = torch.zeros(k.shape, dtype=torch.float32, device=q.device)
    dv = torch.zeros(v.shape, dtype=torch.float32, device=q.device)
    chunk = _chunk(b, h, skv)
    for c0 in range(0, sq, chunk):
        sl = slice(c0, c0 + chunk)
        qc, oc, doc = (x[:, :, sl].float() for x in (q, o, do))
        s2 = torch.einsum("bhqd,bhkd->bhqk", qc, kf) * (sm_scale * _LOG2E)
        p = torch.exp2(s2 - lse[:, :, sl, None].float())
        if kmask is not None:
            p = p.masked_fill(~kmask, 0.0)
        di = (doc * oc).sum(dim=-1, keepdim=True)
        dv += torch.einsum("bhqk,bhqd->bhkd", p, doc)
        ds = p * (torch.einsum("bhqd,bhkd->bhqk", doc, vf) - di)
        dq[:, :, sl] = torch.einsum("bhqk,bhkd->bhqd", ds, kf) * sm_scale
        dk += torch.einsum("bhqk,bhqd->bhkd", ds, qc) * sm_scale
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


def _check_operands(name, *xs):
    q = xs[0]
    if not all(x.is_cuda and x.device == q.device for x in xs):
        raise ValueError(f"{name}: every operand must lie on the same CUDA "
                         f"device")
    for x in xs:
        if x.dtype != torch.bfloat16:
            raise TypeError(f"{name}: operands must be bfloat16, got "
                            f"{x.dtype} (on CUDA build the model with "
                            f'dtype="bfloat16")')
    b, h, sq, d = q.shape
    k, v = xs[1], xs[2]
    skv = k.shape[2]
    if k.shape != (b, h, skv, d) or v.shape != k.shape:
        raise ValueError(f"shape mismatch q{tuple(q.shape)} "
                         f"k{tuple(k.shape)} v{tuple(v.shape)}")
    for x in xs[3:]:
        if x.shape != q.shape:
            raise ValueError(f"{name}: {tuple(x.shape)} != q's "
                             f"{tuple(q.shape)}")
    if d != _HEAD_DIM:
        raise ValueError(f"{name}: head dim {d} is not supported on CUDA "
                         f"(the kernels take {_HEAD_DIM})")


def _contiguous(name, *xs):
    xs = tuple(x.contiguous() for x in xs)
    if any(x.data_ptr() % 16 for x in xs):
        raise ValueError(f"{name}: operands must be 16-byte aligned")
    return xs


def _kv_len_int32(kv_len, b: int, device):
    if kv_len is None:
        return None
    return _kv_len_tensor(kv_len, b, device).to(torch.int32).contiguous()


def _padded_rows(x, sq_pad: int, fill: float):
    """[B, H, Sq] f32 -> contiguous [B*H, sq_pad] with ``fill`` past Sq."""
    b, h, sq = x.shape
    out = torch.full((b * h, sq_pad), fill, dtype=torch.float32,
                     device=x.device)
    out[:, :sq] = x.reshape(b * h, sq)
    return out


def dense_route(skv: int) -> str:
    """The forward kernel a CUDA call over ``skv`` keys launches: "short"
    (``csrc/dense_attn_short.cu``) up to ``SHORT_KEYS`` keys, "mainloop"
    (``csrc/dense_attn.cu``) over it. A function of the shape alone."""
    return "short" if skv <= SHORT_KEYS else "mainloop"


def _map_operand(x):
    """``x`` itself where a 4-D tensor map can address it (the last dim
    contiguous, every other stride of a dim longer than 1 a positive
    multiple of 8 elements, the pointer 16-byte aligned), else a
    contiguous copy."""
    ok = x.stride(-1) == 1 and x.data_ptr() % 16 == 0 and all(
        st > 0 and st % 8 == 0
        for n, st in zip(x.shape[:-1], x.stride()[:-1]) if n > 1)
    return x if ok else x.clone(memory_format=torch.contiguous_format)


def _map_strides(x) -> list[int]:
    """(row, head, sample) element strides of [B, H, S, D] ``x``; a dim of
    length 1 is never stepped, and gets 8 (a map wants 16-byte strides)."""
    return [st if n > 1 else 8 for n, st in zip(
        (x.shape[2], x.shape[1], x.shape[0]),
        (x.stride(2), x.stride(1), x.stride(0)))]


def _launch(fn, err_fn, *args):
    """Call a kernel's entry point; raise with its CUDA error string."""
    err = fn(*args)
    if err != 0:
        raise RuntimeError("dense_attention launch failed: "
                           + err_fn(err).decode())


def dense_attention_forward(q, k, v, *, sm_scale: float | None = None,
                            kv_len=None, with_lse: bool = False):
    """(out, lse): dense non-causal attention over [B, H, S, D] in q's
    dtype, and with ``with_lse`` the rows' base-2 log-sum-exp [B, H, Sq]
    f32 (+inf for a row with no valid key), else None. CPU tensors take
    the plain version; CUDA tensors launch the kernel of
    ``dense_route(Skv)`` or raise. The short route reads q, k and v
    through their strides and gives ``out`` q's layout (a [B, S, H, D]
    tensor seen as [B, H, S, D] stays one); the mainloop takes contiguous
    copies."""
    b, h, sq, d = q.shape
    skv = k.shape[2]
    if sm_scale is None:
        sm_scale = d ** -0.5
    if not q.is_cuda:
        return _plain_forward(q, k, v, sm_scale, kv_len, with_lse)
    _check_operands("dense_attention", q, k, v)
    short = dense_route(skv) == "short"
    with obs.span("layout"):
        if short:
            q, k, v = (_map_operand(x) for x in (q, k, v))
        else:
            q, k, v = _contiguous("dense_attention", q, k, v)
        kl = _kv_len_int32(kv_len, b, q.device)
    kl_ptr = None if kl is None else kl.data_ptr()
    nqb = -(-sq // _BLOCK)
    lse = (torch.full((b, h, nqb * _BLOCK), float("inf"),
                      dtype=torch.float32, device=q.device)
           if with_lse else None)
    lse_ptr = None if lse is None else lse.data_ptr()
    out = torch.empty_like(q)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    if short:
        lib = build_short_kernel()
        strides = (ctypes.c_longlong * 12)(
            *(st for x in (q, k, v, out) for st in _map_strides(x)))
        _launch(lib.dense_attn_short_forward,
                lib.dense_attn_short_error_string, q.data_ptr(),
                k.data_ptr(), v.data_ptr(), out.data_ptr(), kl_ptr, lse_ptr,
                b, h, sq, skv, strides, float(sm_scale), stream)
        dense_attention.short_launches += 1
    else:
        lib = build_kernel()
        _launch(lib.dense_attn_forward, lib.dense_attn_error_string,
                q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                kl_ptr, lse_ptr, b * h, h, sq, skv,
                float(sm_scale), stream)
    dense_attention.launches += 1
    return out, None if lse is None else lse[..., :sq]


def _dkv_chunks(segments: int, nq64: int, sms: int) -> int:
    """Query chunks per (batch*head, 128-key tile) of the short backward's
    dK|dV kernel: the count in 1..16 (at most the 64-row query tiles) that
    minimises the estimated time of its waves over ``sms`` SMs plus that
    of writing and summing the chunks' f32 partials (none for one chunk)."""
    def cost(c):
        waves = math.ceil(segments * c / sms) / c * nq64 * _ITEM_US
        return waves + (c > 1) * c * segments * _PART_US
    return min(range(1, min(16, nq64) + 1), key=lambda c: (cost(c), c))


def _like(x, y):
    """``y``'s values in a tensor laid out as ``empty_like(x)``."""
    return torch.empty_like(x).copy_(y)


def _backward_short(q, k, v, o, lse, do, sm_scale: float, kv_len):
    """The short-key backward on the card: one call of
    ``csrc/dense_attn_bwd_short.cu`` (its dQ kernel computes di; its dK|dV
    kernel, and the sum of its chunks), every operand read through its
    strides and the gradients ``empty_like`` the operands."""
    b, h, sq, _ = q.shape
    skv = k.shape[2]
    q, k, v, o, do = (_map_operand(x) for x in (q, k, v, o, do))
    if lse.dtype != torch.float32 or lse.stride(-1) != 1:
        lse = lse.float().contiguous()
    kl = _kv_len_int32(kv_len, b, q.device)
    dq, dk, dv = (torch.empty_like(x) for x in (q, k, v))
    sq_pad = -(-sq // _BLOCK) * _BLOCK
    ws = torch.empty((2, b * h, sq_pad), dtype=torch.float32,
                     device=q.device)
    sms = torch.cuda.get_device_properties(q.device).multi_processor_count
    nkt = -(-skv // _BLOCK)
    chunks = _dkv_chunks(b * h * nkt, -(-sq // 64), sms)
    # f32 partials of dK|dV: one per chunk, and always for a last key tile
    # of at most 64 keys (its two warpgroups' halves)
    narrow_tail = skv - (nkt - 1) * _BLOCK <= 64
    part = (torch.empty((b * h * nkt * chunks, 2, _BLOCK, _HEAD_DIM),
                        dtype=torch.float32, device=q.device)
            if chunks > 1 or narrow_tail else None)
    strides = (ctypes.c_longlong * 26)(
        *(st for x in (q, k, v, o, do, dq, dk, dv)
          for st in _map_strides(x)), lse.stride(0), lse.stride(1))
    lib = build_bwd_short_kernel()
    _launch(lib.dense_attn_bwd_short, lib.dense_attn_bwd_short_error_string,
            q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
            do.data_ptr(), lse.data_ptr(),
            None if kl is None else kl.data_ptr(), dq.data_ptr(),
            dk.data_ptr(), dv.data_ptr(), ws.data_ptr(),
            None if part is None else part.data_ptr(), b, h, sq, skv,
            strides, float(sm_scale), q.device.index, sms, chunks,
            torch.cuda.current_stream(q.device).cuda_stream)
    dense_attention_backward.short_launches += 1
    return dq, dk, dv


def dense_attention_backward(q, k, v, o, lse, do, *,
                             sm_scale: float | None = None, kv_len=None):
    """(dq, dk, dv) of dense attention from the forward's output and
    statistics (``dense_attention_forward(..., with_lse=True)``). CPU
    tensors take the plain version; CUDA tensors launch the kernels of
    ``dense_route(Skv)`` or raise. On the short route (both devices) the
    gradients take the operands' layouts (``empty_like`` of q, k and v as
    handed in: a [B, S, H, D] tensor seen as [B, H, S, D] gets its
    gradient in that layout); over it they are contiguous, and on the card
    ``di`` is computed in torch and the dK|dV kernel, then the dQ kernel,
    run on contiguous copies."""
    b, h, sq, d = q.shape
    if sm_scale is None:
        sm_scale = d ** -0.5
    short = dense_route(k.shape[2]) == "short"
    if not q.is_cuda:
        grads = dense_attention_backward_plain(q, k, v, o, lse, do,
                                               sm_scale=sm_scale,
                                               kv_len=kv_len)
        return (tuple(_like(x, g) for x, g in zip((q, k, v), grads))
                if short else grads)
    _check_operands("dense_attention_backward", q, k, v, o, do)
    if short:
        return _backward_short(q, k, v, o, lse, do, sm_scale, kv_len)
    q, k, v, do = _contiguous("dense_attention_backward", q, k, v, do)
    skv = k.shape[2]
    sq_pad = -(-sq // _BLOCK) * _BLOCK
    lse_p = _padded_rows(lse, sq_pad, float("inf"))
    di_p = _padded_rows((do.float() * o.float()).sum(dim=-1), sq_pad, 0.0)
    kl = _kv_len_int32(kv_len, b, q.device)
    kl_ptr = None if kl is None else kl.data_ptr()
    dq, dk, dv = (torch.empty_like(x) for x in (q, k, v))
    stream = torch.cuda.current_stream(q.device).cuda_stream
    lib = build_bwd_kernel()
    common = (q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
              lse_p.data_ptr(), di_p.data_ptr(), kl_ptr)
    for fn, outs, counter in (
            (lib.dense_attn_bwd_dkv, (dk.data_ptr(), dv.data_ptr()),
             "dkv_launches"),
            (lib.dense_attn_bwd_dq, (dq.data_ptr(),), "dq_launches")):
        err = fn(*common, *outs, b * h, h, sq, skv, float(sm_scale), stream)
        if err != 0:
            raise RuntimeError(
                "dense_attention_backward launch failed: "
                + lib.dense_attn_bwd_error_string(err).decode())
        setattr(dense_attention_backward, counter,
                getattr(dense_attention_backward, counter) + 1)
    return dq, dk, dv


dense_attention_backward.dkv_launches = 0
dense_attention_backward.dq_launches = 0
dense_attention_backward.short_launches = 0


class _DenseAttention(torch.autograd.Function):
    """D under autograd: the forward keeps (q, k, v, out, lse), the
    backward is ``dense_attention_backward``. ``kv_len`` gets no gradient
    (the counterpart of the stock kernel's ``custom_vjp``)."""

    @staticmethod
    def forward(ctx, q, k, v, kv_len, sm_scale):
        out, lse = dense_attention_forward(q, k, v, sm_scale=sm_scale,
                                           kv_len=kv_len, with_lse=True)
        ctx.save_for_backward(q, k, v, out, lse, kv_len)
        ctx.sm_scale = sm_scale
        return out

    @staticmethod
    def backward(ctx, do):
        q, k, v, out, lse, kv_len = ctx.saved_tensors
        dq, dk, dv = dense_attention_backward(
            q, k, v, out, lse, do, sm_scale=ctx.sm_scale, kv_len=kv_len)
        return dq, dk, dv, None, None


def _causal_attention(q, k, v, sm_scale: float, kv_len):
    """Causal dense attention as JAX computes it (in jnp, outside any
    Pallas kernel, on every backend): f32 logits times ``sm_scale``, the
    mask ``tril(ones(Sq, Skv))`` aligned top-left (query i sees keys
    0..i, also when Sq != Skv) and the keys below ``kv_len``, the
    softmax with zeros for a row with no key, the product with v in f32,
    the output in q's dtype. The query axis is chunked so one chunk's
    logits stay under 2^28 elements. Plain torch ops, so autograd
    differentiates it."""
    b, h, sq, _ = q.shape
    skv = k.shape[2]
    kmask = _key_mask(kv_len, b, skv, q.device)
    kf, vf = k.float(), v.float()
    keys = torch.arange(skv, device=q.device)
    outs = []
    chunk = _chunk(b, h, skv)
    for c0 in range(0, sq, chunk):
        qc = q[:, :, c0:c0 + chunk].float()
        rows = torch.arange(c0, c0 + qc.shape[2], device=q.device)
        mask = (keys[None] <= rows[:, None])[None, None]
        if kmask is not None:
            mask = mask & kmask
        logits = torch.einsum("bhqd,bhkd->bhqk", qc, kf) * sm_scale
        p = _masked_softmax(logits.masked_fill(~mask, float("-inf")))
        outs.append(torch.einsum("bhqk,bhkd->bhqd", p, vf))
    return torch.cat(outs, dim=2).to(q.dtype)


def dense_attention(q, k, v, *, sm_scale: float | None = None,
                    causal: bool = False, kv_len=None):
    """Dense attention over [B, H, S, D]; ``kv_len`` None or [B] valid key
    counts (or one count for every sample). Returns [B, H, Sq, D] in q's
    dtype; differentiable in q, k and v.

    Non-causal: CPU tensors take the plain versions; CUDA tensors launch
    the kernels or raise. The kernels take bfloat16 operands with head
    dim 128 only (a ``TypeError`` or ``ValueError`` otherwise): a model
    run on the card must be built with ``dtype="bfloat16"``, which every
    published config has.

    ``causal=True``: ``_causal_attention`` on either device, for any
    dtype and head dim: plain torch ops, as JAX computes it, and never
    kernel D or a library kernel (those would give NaN, not zeros, for a
    row with no key). No pipeline calls it, in either package."""
    if sm_scale is None:
        sm_scale = q.shape[-1] ** -0.5
    if causal:
        return _causal_attention(q, k, v, float(sm_scale), kv_len)
    if torch.is_grad_enabled() and any(x.requires_grad for x in (q, k, v)):
        if kv_len is not None:
            kv_len = _kv_len_tensor(kv_len, q.shape[0], q.device)
        return _DenseAttention.apply(q, k, v, kv_len, float(sm_scale))
    return dense_attention_forward(q, k, v, sm_scale=sm_scale,
                                   kv_len=kv_len)[0]


dense_attention.launches = 0
dense_attention.short_launches = 0


def attention_bshd(q, k, v, **kwargs):
    """Dense attention over the model-side [B, S, H, D] layout. The
    transposes are views: on the short route the kernel reads q, k and v
    in this layout and writes the output in it, so the result is a
    contiguous [B, S, H, D] tensor and no copy is made."""
    out = dense_attention(q.transpose(1, 2), k.transpose(1, 2),
                          v.transpose(1, 2), **kwargs)
    return out.transpose(1, 2)

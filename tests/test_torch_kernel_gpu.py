"""The CUDA kernels (block-sparse attention in its all-member and
membership modes, dense attention and its backward, and the probe kernels
P1-P4) against
their plain torch versions, the HunyuanVideo token_replace pinning, the
fp8 ``linear``, the CLI's ``--tiny`` runs (T2V and I2V, dpm++), the
VAEs, the image encode, the resize, the text and image encoders and the
checkpoint loads (``from_pretrained`` of the smoke's small
reference-layout directories) against the CPU, on a CUDA card (skipped
without one). This file imports no JAX, so it also runs on a
machine that has only the port's dependencies:

    python -m pytest --noconftest -q tests/test_torch_kernel_gpu.py
"""

from unittest import mock

import numpy as np
import pytest
import torch

from jenga_tpu_torch.models.fp8 import (quantize_linear_fp8,
                                        quantize_tree_fp8)
from jenga_tpu_torch.models.layers import Affine, linear
from jenga_tpu_torch.ops.attention_probe import (EPILOGUE_VARIANTS,
                                                 SPLIT_VARIANTS,
                                                 attention_probe,
                                                 attention_probe_plain)
from jenga_tpu_torch.ops.block_pool import block_pool, block_pool_plain
from jenga_tpu_torch.ops.block_sparse_attention import (
    block_sparse_attention, block_sparse_attention_plain)
from jenga_tpu_torch.ops.cross_attention_resident import (
    cross_attention_resident, cross_attention_resident_plain)
from jenga_tpu_torch.ops import flash_attention
from jenga_tpu_torch.ops.flash_attention import (
    _plain_forward, attention_bshd, dense_attention, dense_attention_backward,
    dense_attention_backward_plain, dense_attention_forward,
    dense_attention_plain)
from jenga_tpu_torch.ops.sparse_dispatch import block_lists_from_mask

NB, TSB = 11, 9     # 9 video + 2 text blocks, as in the slice tests


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU: the attention kernels have no CPU "
                    "or interpret mode")
    return torch.device("cuda")


def _inputs(seed, device, h=2, d=128):
    rng = np.random.default_rng(seed)
    q, k, v = (torch.as_tensor(rng.standard_normal((1, h, NB * 128, d)),
                               dtype=torch.bfloat16, device=device)
               for _ in range(3))
    m = rng.random((1, h, NB, NB)) < 0.4
    m[..., TSB:] = True
    m[:, :, TSB:] = True
    m[0, 0, 3] = False          # an empty row
    return q, k, v, torch.as_tensor(m, device=device)


@pytest.mark.gpu
@pytest.mark.parametrize("q_rows,fixed_max,d", [
    (1, True, 128), (1, False, 128), (8, True, 128), (8, False, 128),
    (8, True, 64)])
def test_kernel_matches_plain_on_card(cuda_device, q_rows, fixed_max, d):
    """The CUDA kernel vs its plain version at the slice's shape, bf16
    operands (d=64 goes through the wrapper's zero padding to 128).
    1e-2 covers the bf16 rounding of P and of the output."""
    q, k, v, mask = _inputs(12, cuda_device, d=d)
    idx, cnt, _ = block_lists_from_mask(mask, q_rows, q_rows > 1)
    sl = torch.tensor([NB * 128 - 40], dtype=torch.int32, device=cuda_device)
    kw = dict(q_rows=q_rows, text_amp=0.5, text_start_block=TSB,
              fixed_max=fixed_max)
    before = block_sparse_attention.launches
    out = block_sparse_attention(q, k, v, idx, cnt, sl, **kw)
    torch.cuda.synchronize()
    assert block_sparse_attention.launches == before + 1
    assert out.shape == q.shape and out.dtype == torch.bfloat16
    ref = block_sparse_attention_plain(q.float(), k.float(), v.float(), idx,
                                       cnt, sl, **kw)
    assert (out.float() - ref).abs().max().item() <= 1e-2
    if q_rows == 1:     # in joint mode row 3 attends its group's union
        assert not out[0, 0, 3 * 128:4 * 128].any()     # empty row -> 0


@pytest.mark.gpu
@pytest.mark.parametrize("q_rows,fixed_max", [(8, True), (8, False),
                                              (3, True)])
def test_membership_kernel_matches_plain_and_per_row(cuda_device, q_rows,
                                                     fixed_max):
    """The membership mode (union lists + membership words) vs its plain
    version and vs the per-row mode (q_rows=1) on the same per-row mask,
    with text_amp, a seqlen tail, an empty row and an all-empty group row
    set. Each query block attends its own blocks in ascending order in
    both modes, so the two kernel outputs are identical."""
    q, k, v, mask = _inputs(16, cuda_device)
    mask[0, 1, 1] = False               # a second empty row, other head
    idx, cnt, mem = block_lists_from_mask(mask, q_rows)
    sl = torch.tensor([NB * 128 - 40], dtype=torch.int32, device=cuda_device)
    kw = dict(text_amp=0.431, text_start_block=TSB, fixed_max=fixed_max)
    before = (block_sparse_attention.launches,
              block_sparse_attention.member_launches)
    out = block_sparse_attention(q, k, v, idx, cnt, sl, q_rows=q_rows,
                                 members=mem, **kw)
    torch.cuda.synchronize()
    assert (block_sparse_attention.launches,
            block_sparse_attention.member_launches) == (before[0],
                                                        before[1] + 1)
    ref = block_sparse_attention_plain(q.float(), k.float(), v.float(), idx,
                                       cnt, sl, q_rows=q_rows, members=mem,
                                       **kw)
    assert (out.float() - ref).abs().max().item() <= 1e-2
    assert not out[0, 0, 3 * 128:4 * 128].any()
    assert not out[0, 1, 1 * 128:2 * 128].any()
    idx1, cnt1, _ = block_lists_from_mask(mask, 1)
    per_row = block_sparse_attention(q, k, v, idx1, cnt1, sl, **kw)
    assert torch.equal(out, per_row)


def _ring_edge_inputs(seed, device, h=2):
    """Two samples whose rows attend 0, 1, 2 and all NB blocks, so the
    2-stage K|V ring is never filled, filled once and wrapped five times
    (the mbarrier parity), with seqlen cutting inside block 5 in sample 0
    (row 3's blocks all lie past it: a row of zeros) and inside the last
    text block in sample 1."""
    rng = np.random.default_rng(seed)
    q, k, v = (torch.as_tensor(rng.standard_normal((2, h, NB * 128, 128)),
                               dtype=torch.bfloat16, device=device)
               for _ in range(3))
    m = np.zeros((2, h, NB, NB), bool)
    m[:, :, 1, 4] = True                 # n = 1 (row 0: n = 0)
    m[:, :, 2, [0, 7]] = True
    m[:, :, 3, [8, 10]] = True           # past seqlen in sample 0
    m[:, :, 4, [2, 5]] = True            # block 5 cut by seqlen
    m[:, :, 5:] = True                   # n = NB: the boundary group too
    m[1, 1, 6, 9:] = False               # video row, no text block
    sl = torch.tensor([5 * 128 + 17, NB * 128 - 40], dtype=torch.int32,
                      device=device)
    return q, k, v, torch.as_tensor(m, device=device), sl


@pytest.mark.gpu
@pytest.mark.parametrize("mode,q_rows", [("per_row", 1), ("joint", 8),
                                         ("members", 8), ("members", 3)])
@pytest.mark.parametrize("fixed_max", [True, False])
def test_kernel_ring_and_mask_edges_on_card(cuda_device, mode, q_rows,
                                            fixed_max):
    """The traps of the TMA ring and the masks, vs the plain version: rows
    with n = 0, 1, 2 and n past the ring, a membership group in which one
    query block has no bit (row 0), seqlen inside a block and past whole
    listed blocks, text_amp != 0 on the video/text boundary group, both
    epilogues. A row with no valid key stores zeros; the membership mode
    equals the per-row mode on the same mask."""
    q, k, v, mask, sl = _ring_edge_inputs(23, cuda_device)
    idx, cnt, mem = block_lists_from_mask(mask, q_rows, mode == "joint")
    kw = dict(text_amp=-0.7, text_start_block=TSB, fixed_max=fixed_max)
    out = block_sparse_attention(q, k, v, idx, cnt, sl, q_rows=q_rows,
                                 members=mem, **kw)
    torch.cuda.synchronize()
    ref = block_sparse_attention_plain(q.float(), k.float(), v.float(), idx,
                                       cnt, sl, q_rows=q_rows, members=mem,
                                       **kw)
    assert torch.isfinite(out).all()
    assert (out.float() - ref).abs().max().item() <= 1e-2
    if mode == "joint":
        return
    assert not out[:, :, :128].any()                # n = 0
    assert not out[0, :, 3 * 128:4 * 128].any()     # every key masked
    if mode == "members":
        idx1, cnt1, _ = block_lists_from_mask(mask, 1)
        assert torch.equal(out, block_sparse_attention(
            q, k, v, idx1, cnt1, sl, **kw))


@pytest.mark.gpu
def test_kernel_rejects_f32_operands(cuda_device):
    q, k, v, mask = _inputs(13, cuda_device)
    idx, cnt, _ = block_lists_from_mask(mask, 1, False)
    sl = torch.tensor([NB * 128], dtype=torch.int32, device=cuda_device)
    with pytest.raises(TypeError):
        block_sparse_attention(q.float(), k.float(), v.float(), idx, cnt, sl)


@pytest.mark.gpu
def test_kernel_rejects_bad_membership_words(cuda_device):
    """members is checked like indices (int32, shape, device), and covers
    at most 8 rows."""
    q, k, v, mask = _inputs(17, cuda_device)
    idx, cnt, mem = block_lists_from_mask(mask, 8)
    sl = torch.tensor([NB * 128], dtype=torch.int32, device=cuda_device)
    for bad in (mem.long(), mem.float(), mem[..., :-1].contiguous(),
                mem[:, :1].contiguous(), mem.cpu()):
        with pytest.raises(ValueError):
            block_sparse_attention(q, k, v, idx, cnt, sl, q_rows=8,
                                   members=bad)
    idx16, cnt16, _ = block_lists_from_mask(mask, 16, True)
    with pytest.raises(ValueError):
        block_sparse_attention(q, k, v, idx16, cnt16, sl, q_rows=16,
                               members=torch.zeros_like(idx16))


def _dense_inputs(seed, device, b, sq, skv, h=2):
    rng = np.random.default_rng(seed)
    return (torch.as_tensor(rng.standard_normal((b, h, n, 128)),
                            dtype=torch.bfloat16, device=device)
            for n in (sq, skv, skv))


@pytest.mark.gpu
@pytest.mark.parametrize("b,sq,skv,kv_len", [
    (1, 1024, 1024, None),          # whole tiles
    (2, 1000, 300, [0, 137]),       # ragged Sq/Skv; an empty sample
    (2, 700, 512, None),            # Wan cross-attention's 512 keys
    (1, 1408, 1408, [1368]),        # HY joint length with padded text
    (2, 1000, 300, None),           # ragged Sq/Skv, no kv_len: B*H = 4
    (3, 130, 257, [257, 1, 128])])  # 3 tiles (past the ring), 1, 1 whole
def test_dense_kernel_matches_plain_on_card(cuda_device, b, sq, skv, kv_len):
    """The dense kernel vs its plain version, bf16 operands; 1e-2 covers the
    bf16 rounding of P and of the output. kv_len 0 gives zeros. With
    several (batch, head) slices and a ragged Sq or Skv, the rows past a
    slice's end must read as zeros (a 2-D tensor map would read the next
    head's)."""
    q, k, v = _dense_inputs(14, cuda_device, b, sq, skv)
    kl = None if kv_len is None else torch.tensor(kv_len, dtype=torch.int32,
                                                  device=cuda_device)
    before = dense_attention.launches
    out = dense_attention(q, k, v, kv_len=kl)
    torch.cuda.synchronize()
    assert dense_attention.launches == before + 1
    assert out.shape == q.shape and out.dtype == torch.bfloat16
    ref = dense_attention_plain(q.float(), k.float(), v.float(), kv_len=kl)
    assert torch.isfinite(out).all()
    assert (out.float() - ref).abs().max().item() <= 1e-2
    if kv_len is not None and kv_len[0] == 0:
        assert not out[0].any()


@pytest.mark.gpu
@pytest.mark.parametrize("skv", [257, 512])
def test_dense_kernel_wan14b_cross_attention_on_card(cuda_device, skv):
    """D at Wan2.1-14B's cross-attention head count (40) over the 257 CLIP
    image keys (a ragged last key tile of one key) and the 512 text keys,
    no kv_len, CFG batch 2 with a ragged query count; 1e-2 max abs."""
    q, k, v = _dense_inputs(16, cuda_device, 2, 1000, skv, h=40)
    before = dense_attention.launches
    out = dense_attention(q, k, v)
    torch.cuda.synchronize()
    assert dense_attention.launches == before + 1
    ref = dense_attention_plain(q.float(), k.float(), v.float())
    assert torch.isfinite(out).all()
    assert (out.float() - ref).abs().max().item() <= 1e-2


KERNEL_TOL, KERNEL_REL_TOL = 1e-2, 2e-2    # chip_smoke.py phase 2's bounds


def _assert_short_matches_plain(out, q, k, v, kl):
    """``out`` within phase 2's bounds of the plain version (1e-2 max abs
    and 2e-2 relative L2: the bf16 rounding of P and of the output, ~2^-9
    each), finite, and zero for a sample with kv_len 0."""
    ref = dense_attention_plain(q.float(), k.float(), v.float(), kv_len=kl)
    assert out.shape == q.shape and out.dtype == torch.bfloat16
    assert torch.isfinite(out).all()
    assert (out.float() - ref).abs().max().item() <= KERNEL_TOL
    assert _rel_l2(out, ref) <= KERNEL_REL_TOL
    for i, n in enumerate([] if kl is None else kl.tolist()):
        if n <= 0:
            assert not out[i].any()


def _short_call(fn):
    """fn() on the card; asserts it launched D once, on the short route."""
    before = (dense_attention.launches, dense_attention.short_launches)
    out = fn()
    torch.cuda.synchronize()
    assert (dense_attention.launches, dense_attention.short_launches) == (
        before[0] + 1, before[1] + 1)
    return out


@pytest.mark.gpu
@pytest.mark.parametrize("skv", [1, 16, 17, 128, 129, 257, 384, 512])
@pytest.mark.parametrize("sq", [1, 127, 1000, 32760])
def test_dense_short_kernel_matches_plain_on_card(cuda_device, sq, skv):
    """D's short-key kernel vs its plain version across the narrow last
    tile's widths (1, 16, 17 keys: one 16-key chunk or two; 129, 257: a
    tile and a chunk), whole tiles with V resident (128, 384) and streamed
    (512), a single query row, a ragged last query tile and Wan's 32,760
    rows; CFG batch 2 over 2 heads."""
    q, k, v = _dense_inputs(20, cuda_device, 2, sq, skv)
    out = _short_call(lambda: dense_attention(q, k, v))
    _assert_short_matches_plain(out, q, k, v, None)


@pytest.mark.gpu
@pytest.mark.parametrize("skv,kv_len", [
    (17, [0, 17]),          # an empty sample beside a full one
    (129, [1, 129]),        # one key; a tile and one key
    (257, [0, 1]),          # empty, one key
    (257, [250, 257]),      # inside the tail tile; the whole tail
    (384, [260, 383]),      # inside the last resident tile
    (512, [0, 500]),        # V streamed: empty, inside the last tile
    (512, [129, 7])])       # V streamed over fewer tiles than resident
def test_dense_short_kernel_kv_len_on_card(cuda_device, skv, kv_len):
    """The short-key kernel with per-sample key lengths: a sample with
    kv_len 0 is all zeros, one key, and lengths inside the last tile,
    over 3 heads and a ragged query count."""
    q, k, v = _dense_inputs(21, cuda_device, 2, 1000, skv, h=3)
    kl = torch.tensor(kv_len, dtype=torch.int32, device=cuda_device)
    out = _short_call(lambda: dense_attention(q, k, v, kv_len=kl))
    _assert_short_matches_plain(out, q, k, v, kl)


def _device_kernels(fn):
    """Names of the CUDA kernels fn() ran, from torch.profiler."""
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU,
                        torch.profiler.ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return [e.name for e in prof.events()
            if e.device_type == torch.autograd.DeviceType.CUDA]


@pytest.mark.gpu
@pytest.mark.parametrize("skv", [257, 512])
@pytest.mark.parametrize("layout", ["bhsd", "bshd", "sliced", "misaligned"])
def test_dense_short_kernel_layouts_on_card(cuda_device, layout, skv):
    """The short-key kernel reads q, k, v through their strides: [B, H, S,
    D], the model's [B, S, H, D] through ``attention_bshd`` (one kernel
    on the card, no copy, and a contiguous [B, S, H, D] output, so Wan's
    reshape is a view), views sliced along the head dim's storage and the
    rows; an operand whose pointer is not 16-byte aligned is copied."""
    b, h, sq = 2, 3, 1000
    gen = torch.Generator(device=cuda_device).manual_seed(22)

    def randn(*shape):
        return torch.randn(shape, generator=gen, device=cuda_device,
                           dtype=torch.bfloat16)
    if layout == "bshd":
        q, k, v = randn(b, sq, h, 128), randn(b, skv, h, 128), randn(
            b, skv, h, 128)
        names = _device_kernels(lambda: attention_bshd(q, k, v))
        assert len(names) == 1 and "dense_kernel_short" in names[0], names
        out = _short_call(lambda: attention_bshd(q, k, v))
        assert out.shape == q.shape and out.is_contiguous()
        _assert_short_matches_plain(out.transpose(1, 2), q.transpose(1, 2),
                                    k.transpose(1, 2), v.transpose(1, 2),
                                    None)
        return
    if layout == "bhsd":
        q, k, v = randn(b, h, sq, 128), randn(b, h, skv, 128), randn(
            b, h, skv, 128)
    elif layout == "sliced":
        # rows 256 elements apart, a row offset into each head
        q = randn(b, h, sq + 5, 256)[:, :, 5:, 64:192]
        k, v = (randn(b, h, skv + 3, 256)[:, :, 3:, :128] for _ in range(2))
        assert not q.is_contiguous()
    else:
        flat = randn(b * h * sq * 128 + 1)
        q = flat[1:].view(b, h, sq, 128)
        assert q.data_ptr() % 16
        k, v = randn(b, h, skv, 128), randn(b, h, skv, 128)
    out = _short_call(lambda: dense_attention(q, k, v))
    _assert_short_matches_plain(out, q, k, v, None)


@pytest.mark.gpu
@pytest.mark.parametrize("skv,kv_len", [
    (1, None), (257, [0, 250]), (512, [500, 1]), (100, [37, 100])])
def test_dense_short_kernel_statistics_on_card(cuda_device, skv, kv_len):
    """The short-key kernel's base-2 log-sum-exp (the backward's input)
    against the plain statistics: within 1e-3 (log2 units; ex2.approx),
    +inf exactly where a row has no valid key."""
    q, k, v = _dense_inputs(23, cuda_device, 2, 333, skv)
    kl = None if kv_len is None else torch.tensor(
        kv_len, dtype=torch.int32, device=cuda_device)
    o, lse = _short_call(lambda: dense_attention_forward(
        q, k, v, kv_len=kl, with_lse=True))
    _assert_short_matches_plain(o, q, k, v, kl)
    _, lse_ref = _plain_forward(q, k, v, 128 ** -0.5, kl, True)
    fin = torch.isfinite(lse_ref)
    assert torch.equal(torch.isfinite(lse), fin)
    assert (lse[fin] - lse_ref[fin]).abs().max().item() <= 1e-3


@pytest.mark.gpu
@pytest.mark.parametrize("sm_scale", [-0.05, 0.0, 0.3])
def test_dense_short_kernel_sm_scale_on_card(cuda_device, sm_scale):
    """A negative scale (Q negated in registers), zero (uniform weights
    over the valid keys) and a large one, with a ragged tail."""
    q, k, v = _dense_inputs(24, cuda_device, 2, 500, 257)
    kl = torch.tensor([257, 100], dtype=torch.int32, device=cuda_device)
    out = _short_call(lambda: dense_attention(q, k, v, sm_scale=sm_scale,
                                              kv_len=kl))
    ref = dense_attention_plain(q.float(), k.float(), v.float(),
                                sm_scale=sm_scale, kv_len=kl)
    assert (out.float() - ref).abs().max().item() <= KERNEL_TOL
    assert _rel_l2(out, ref) <= KERNEL_REL_TOL


@pytest.mark.gpu
@pytest.mark.parametrize("skv", [512, 513])
def test_dense_route_follows_key_count_on_card(cuda_device, skv):
    """512 keys launch the short-key kernel, 513 the mainloop: the
    counters show which."""
    q, k, v = _dense_inputs(25, cuda_device, 1, 300, skv)
    before = (dense_attention.launches, dense_attention.short_launches)
    out = dense_attention(q, k, v)
    torch.cuda.synchronize()
    assert (dense_attention.launches - before[0],
            dense_attention.short_launches - before[1]) == (
                1, int(skv <= 512))
    _assert_short_matches_plain(out, q, k, v, None)


def _bwd_counts():
    """D's backward counters: (dK|dV, dQ, short-key backward calls)."""
    return (dense_attention_backward.dkv_launches,
            dense_attention_backward.dq_launches,
            dense_attention_backward.short_launches)


def _bwd_counts_after(before, skv):
    """The counters after one backward over ``skv`` keys: the short-key
    call up to 512 keys, else one dK|dV and one dQ launch."""
    short = int(skv <= 512)
    return (before[0] + 1 - short, before[1] + 1 - short, before[2] + short)


@pytest.mark.gpu
@pytest.mark.parametrize("b,sq,skv,kv_len", [
    (1, 1024, 1024, None),          # whole tiles
    (2, 1000, 300, [0, 137]),       # Sq % 128 != 0, ragged keys, kv_len 0
    (2, 700, 512, None),            # Wan cross-attention's 512 keys
    (1, 1408, 1408, [1368]),        # HY joint length with padded text
    (2, 1000, 257, None),           # 257 image keys: a last tile of 1 key
    (3, 130, 257, [257, 1, 128])])  # 3 key tiles, 1 key, 1 whole tile
def test_dense_backward_kernels_match_plain_on_card(cuda_device, b, sq, skv,
                                                    kv_len):
    """The forward's statistics and the dK|dV and dQ kernels vs their plain
    versions on the same bf16 operands (the card's o and lse fed to both):
    lse within 1e-3 (log2 units; ex2.approx), each gradient within 2e-2
    relative L2 (P and dS are rounded to bf16 before their products, ~2^-9
    each, and the gradients are stored in bf16). Keys at or past kv_len get
    exactly zero dK and dV, and a kv_len 0 sample zero dQ."""
    q, k, v = _dense_inputs(17, cuda_device, b, sq, skv)
    do = torch.randn(q.shape, generator=torch.Generator(
        device=cuda_device).manual_seed(3), device=cuda_device).bfloat16()
    kl = None if kv_len is None else torch.tensor(kv_len, dtype=torch.int32,
                                                  device=cuda_device)
    o, lse = dense_attention_forward(q, k, v, kv_len=kl, with_lse=True)
    _, lse_ref = _plain_forward(q, k, v, 128 ** -0.5, kl, True)
    fin = torch.isfinite(lse_ref)
    assert torch.equal(torch.isfinite(lse), fin)
    assert (lse[fin] - lse_ref[fin]).abs().max().item() <= 1e-3
    before = _bwd_counts()
    got = dense_attention_backward(q, k, v, o, lse, do, kv_len=kl)
    torch.cuda.synchronize()
    assert _bwd_counts() == _bwd_counts_after(before, skv)
    want = dense_attention_backward_plain(q.float(), k.float(), v.float(),
                                          o.float(), lse, do.float(),
                                          kv_len=kl)
    for name, x, y in zip(("dq", "dk", "dv"), got, want):
        assert x.dtype == torch.bfloat16 and torch.isfinite(x).all(), name
        assert _rel_l2(x, y) <= 2e-2, (name, _rel_l2(x, y))
    for i, n in enumerate(kv_len or []):
        assert not got[1][i, :, n:].any() and not got[2][i, :, n:].any()
        if n == 0:
            assert not got[0][i].any()


@pytest.mark.gpu
@pytest.mark.parametrize("skv", [200, 600])
def test_dense_attention_autograd_on_card(cuda_device, skv):
    """``dense_attention`` under autograd launches the forward with its
    statistics once and the backward once, each on the route of its key
    count (200 keys: the short-key kernels; 600: the mainloop and the dK|dV
    and dQ kernels), and its gradients match the plain backward (2e-2
    relative L2)."""
    q, k, v = (x.requires_grad_() for x in _dense_inputs(
        18, cuda_device, 2, 333, skv))
    kl = torch.tensor([skv, 77], dtype=torch.int32, device=cuda_device)
    before = dense_attention.launches
    bwd = _bwd_counts()
    short = dense_attention.short_launches
    out = dense_attention(q, k, v, kv_len=kl)
    g = torch.randn_like(out)
    out.backward(g)
    torch.cuda.synchronize()
    assert dense_attention.launches == before + 1
    assert _bwd_counts() == _bwd_counts_after(bwd, skv)
    assert dense_attention.short_launches - short == int(skv <= 512)
    o, lse = _plain_forward(q.detach(), k.detach(), v.detach(), 128 ** -0.5,
                            kl, True)
    want = dense_attention_backward_plain(
        *(x.detach().float() for x in (q, k, v)), out.detach().float(), lse,
        g.float(), kv_len=kl)
    for x, y in zip((q.grad, k.grad, v.grad), want):
        assert _rel_l2(x, y) <= 2e-2


@pytest.mark.gpu
def test_dense_backward_rejects_what_it_does_not_cover(cuda_device):
    q, k, v = _dense_inputs(19, cuda_device, 1, 256, 256)
    o, lse = dense_attention_forward(q, k, v, with_lse=True)
    with pytest.raises(TypeError):
        dense_attention_backward(q, k, v, o, lse, o.float())
    with pytest.raises(ValueError):
        dense_attention_backward(q, k, v, o, lse, o[:, :, :128])


BWD_ABS_TOL = 1e-2   # chip_smoke.py's backward bound, times |reference|


def _short_bwd_operands(seed, device, b, sq, skv, h=2, kv_len=None,
                        sm_scale=None, layout="bhsd"):
    """(q, k, v, o, lse, do, kl) on the card for D's short backward: bf16
    operands in [B, H, S, D] or, with ``layout="bshd"``, [B, S, H, D]
    tensors seen as [B, H, S, D]; o and lse from the card's forward."""
    gen = torch.Generator(device=device).manual_seed(seed)

    def randn(n):
        shape = (b, n, h, 128) if layout == "bshd" else (b, h, n, 128)
        x = torch.randn(shape, generator=gen, device=device,
                        dtype=torch.bfloat16)
        return x.transpose(1, 2) if layout == "bshd" else x
    q, k, v, do = randn(sq), randn(skv), randn(skv), randn(sq)
    kl = None if kv_len is None else torch.tensor(
        kv_len, dtype=torch.int32, device=device)
    o, lse = dense_attention_forward(q, k, v, sm_scale=sm_scale, kv_len=kl,
                                     with_lse=True)
    return q, k, v, o, lse, do, kl


def _short_bwd(q, k, v, o, lse, do, kl, sm_scale=None):
    """The short-key backward on the card: one call counted, no launch of
    the dK|dV or dQ kernels of the route over 512 keys."""
    before = _bwd_counts()
    got = dense_attention_backward(q, k, v, o, lse, do, kv_len=kl,
                                   sm_scale=sm_scale)
    torch.cuda.synchronize()
    assert _bwd_counts() == (before[0], before[1], before[2] + 1)
    return got


def _assert_bwd_matches_plain(got, q, k, v, o, lse, do, kl, sm_scale=None):
    """Each gradient against the plain backward on the same operands in f32
    (the card's o and lse fed to both), within chip_smoke.py's bounds: max
    abs error within 1e-2 of the reference's largest element and 2e-2
    relative L2 (P and dS are rounded to bf16 before their products, ~2^-9
    each, and the gradients are stored in bf16). Keys at or past kv_len get
    exactly zero dK and dV, a sample with kv_len 0 exactly zero dQ, and
    each gradient has its operand's shape and strides. Over one key dQ and
    dK cancel to rounding noise (dS = P (dP - di) with dP = di, both f32
    sums in different orders): a gradient under 1e-2 of the largest of the
    three is held to the absolute bound at that scale (1e-4 of the largest)
    and has no relative bound."""
    want = dense_attention_backward_plain(
        q.float(), k.float(), v.float(), o.float(), lse, do.float(),
        sm_scale=sm_scale, kv_len=kl)
    top = max(y.abs().max().item() for y in want)
    for name, x, y, like in zip(("dq", "dk", "dv"), got, want, (q, k, v)):
        assert x.dtype == torch.bfloat16 and torch.isfinite(x).all(), name
        assert x.shape == like.shape and x.stride() == like.stride(), name
        ref_max = y.abs().max().item()
        err = (x.float() - y).abs().max().item()
        assert err <= BWD_ABS_TOL * max(ref_max, 1e-2 * top), (name, err)
        if ref_max >= 1e-2 * top > 0:
            assert _rel_l2(x, y) <= KERNEL_REL_TOL, (name, _rel_l2(x, y))
    for i, n in enumerate([] if kl is None else kl.tolist()):
        assert not got[1][i, :, max(n, 0):].any()
        assert not got[2][i, :, max(n, 0):].any()
        if n <= 0:
            assert not got[0][i].any()


@pytest.mark.gpu
@pytest.mark.parametrize("skv", [1, 16, 17, 128, 257, 384, 385, 512])
@pytest.mark.parametrize("sq", [1, 127, 129, 1000])
def test_dense_short_backward_matches_plain_on_card(cuda_device, sq, skv):
    """D's short-key backward against the plain backward across the last
    32-key sub-tile's widths (1, 16, 17 keys; 257: a tile and one key;
    385), whole tiles with V resident in the dQ kernel (128) and streamed
    (384, 512), a single query row and ragged query tiles; CFG batch 2 over
    2 heads."""
    ops = _short_bwd_operands(30, cuda_device, 2, sq, skv)
    _assert_bwd_matches_plain(_short_bwd(*ops), *ops)


@pytest.mark.gpu
@pytest.mark.parametrize("skv,kv_len", [
    (17, [0, 17]),          # an empty sample beside a full one
    (129, [1, 129]),        # one key; a tile and one key
    (257, [0, 300]),        # empty; past Skv
    (257, [250, 257]),      # inside the tail sub-tile; the whole tail
    (384, [260, 1000]),     # V streamed: inside a tile; past Skv
    (512, [0, 500]),        # empty; inside the last tile
    (512, [129, 7])])       # fewer key tiles than Skv has
def test_dense_short_backward_kv_len_on_card(cuda_device, skv, kv_len):
    """The short-key backward with per-sample key lengths, 0 and past Skv
    among them, over 3 heads and a ragged query count."""
    ops = _short_bwd_operands(31, cuda_device, 2, 1000, skv, h=3,
                              kv_len=kv_len)
    _assert_bwd_matches_plain(_short_bwd(*ops), *ops)


@pytest.mark.gpu
@pytest.mark.parametrize("skv", [257, 512])
@pytest.mark.parametrize("layout", ["bhsd", "bshd"])
def test_dense_short_backward_layouts_on_card(cuda_device, layout, skv):
    """The short-key backward reads q, k, v, o and dO through their strides
    and gives each gradient its operand's layout: [B, S, H, D] tensors
    seen as [B, H, S, D] get [B, S, H, D] gradients, with no copy kernel
    on the card (the profiler sees the three short-key kernels alone)."""
    ops = _short_bwd_operands(32, cuda_device, 2, 1000, skv, h=3,
                              layout=layout)
    names = _device_kernels(lambda: dense_attention_backward(*ops[:6],
                                                             kv_len=ops[6]))
    assert all("bwd_dq_short" in n or "bwd_dkv_short" in n
               or "bwd_dkv_reduce" in n for n in names), names
    got = _short_bwd(*ops)
    if layout == "bshd":
        assert all(x.transpose(1, 2).is_contiguous() for x in got)
    _assert_bwd_matches_plain(got, *ops)


@pytest.mark.gpu
@pytest.mark.parametrize("skv", [257, 512])
def test_dense_short_backward_through_attention_bshd_on_card(cuda_device,
                                                              skv):
    """``attention_bshd`` under autograd as Wan's cross-attention calls it
    ([B, S, H, D] projections): one short-key forward, one short-key
    backward, and leaf gradients equal to the plain backward's within the
    bounds."""
    gen = torch.Generator(device=cuda_device).manual_seed(33)
    q, k, v = (torch.randn((2, n, 3, 128), generator=gen, device=cuda_device,
                           dtype=torch.bfloat16).requires_grad_()
               for n in (700, skv, skv))
    g = torch.randn((2, 700, 3, 128), generator=gen, device=cuda_device,
                    dtype=torch.bfloat16)
    before = _bwd_counts()
    out = attention_bshd(q, k, v)
    out.backward(g)
    torch.cuda.synchronize()
    assert _bwd_counts() == (before[0], before[1], before[2] + 1)
    qt, kt, vt = (x.detach().transpose(1, 2) for x in (q, k, v))
    o, lse = _plain_forward(qt, kt, vt, 128 ** -0.5, None, True)
    want = dense_attention_backward_plain(
        qt.float(), kt.float(), vt.float(), o.float(), lse,
        g.transpose(1, 2).float())
    for x, y in zip((q.grad, k.grad, v.grad), want):
        assert _rel_l2(x.transpose(1, 2), y) <= KERNEL_REL_TOL


@pytest.mark.gpu
@pytest.mark.parametrize("sm_scale", [-0.05, 0.0, 0.0734])
def test_dense_short_backward_sm_scale_on_card(cuda_device, sm_scale):
    """A negative scale, zero (uniform weights over the valid keys) and an
    odd one, with a ragged tail and a kv_len inside it."""
    ops = _short_bwd_operands(34, cuda_device, 2, 500, 257,
                              kv_len=[257, 100], sm_scale=sm_scale)
    got = _short_bwd(*ops, sm_scale=sm_scale)
    _assert_bwd_matches_plain(got, *ops, sm_scale=sm_scale)


@pytest.mark.gpu
@pytest.mark.parametrize("b,h,sq,skv", [
    (1, 2, 8192, 512),     # few key tiles: dK|dV in chunks, summed
    (2, 40, 1000, 257)])   # many: one chunk
def test_dense_short_backward_is_deterministic_on_card(cuda_device, b, h,
                                                       sq, skv):
    """Two calls on the same operands give equal bits: no atomics, and the
    chunks' dK|dV partials are summed in a fixed order."""
    ops = _short_bwd_operands(35, cuda_device, b, sq, skv, h=h)
    first = _short_bwd(*ops)
    again = _short_bwd(*ops)
    assert all(torch.equal(x, y) for x, y in zip(first, again))
    _assert_bwd_matches_plain(first, *ops)


@pytest.mark.gpu
@pytest.mark.parametrize("skv", [512, 513])
def test_dense_backward_route_follows_key_count_on_card(cuda_device, skv):
    """512 keys take the short-key backward, 513 the dK|dV and dQ kernels:
    the counters show which."""
    q, k, v = _dense_inputs(36, cuda_device, 1, 300, skv)
    do = torch.randn_like(q)
    o, lse = dense_attention_forward(q, k, v, with_lse=True)
    before = _bwd_counts()
    got = dense_attention_backward(q, k, v, o, lse, do)
    torch.cuda.synchronize()
    assert _bwd_counts() == _bwd_counts_after(before, skv)
    want = dense_attention_backward_plain(q.float(), k.float(), v.float(),
                                          o.float(), lse, do.float())
    for x, y in zip(got, want):
        assert _rel_l2(x, y) <= KERNEL_REL_TOL


@pytest.mark.gpu
def test_dense_short_backward_build_failure_raises(cuda_device, tmp_path):
    """A short-key backward source that does not compile raises nvcc's
    output at the first call; nothing falls back to another kernel."""
    bad = tmp_path / "dense_attn_bwd_short.cu"
    bad.write_text("this does not compile;\n")
    ops = _short_bwd_operands(37, cuda_device, 1, 128, 64)
    flash_attention.build_bwd_short_kernel.cache_clear()
    before = _bwd_counts()
    try:
        with mock.patch.object(flash_attention, "BWD_SHORT_KERNEL_SOURCE",
                               bad):
            with pytest.raises(RuntimeError, match="nvcc failed"):
                dense_attention_backward(*ops[:6], kv_len=ops[6])
    finally:
        flash_attention.build_bwd_short_kernel.cache_clear()
    assert _bwd_counts() == before


@pytest.mark.gpu
def test_hy_token_replace_pins_first_frame_on_card(cuda_device):
    """HunyuanVideo-I2V token_replace on the card (the bf16 tiny model of
    ``--tiny``, head dim 128, carved at 256x128x33f): after every step
    frame 0 equals the conditioning latent bit for bit, the rest moves,
    and the block-sparse kernel ran."""
    from jenga_tpu_torch.cli import _tiny_config
    from jenga_tpu_torch.configs.presets import get_hy_i2v_options
    from jenga_tpu_torch.models.hyvideo import hy_i2v_config
    from jenga_tpu_torch.runtime import HunyuanVideoSampler
    cfg = hy_i2v_config("token_replace", _tiny_config("cuda"))
    sampler = HunyuanVideoSampler(cfg, device="cuda", seed=0, i2v=True)
    opts = get_hy_i2v_options("base", size=(256, 128), video_length=33,
                              num_inference_steps=4)
    gen = torch.Generator(device="cuda").manual_seed(5)
    (lat0, _), (lat1, _) = sampler.pipeline._stage_shapes(opts)
    assert lat0 == lat1     # Base: both stages at full resolution
    img = [torch.randn((16, 1, lat0[1], lat0[2]), generator=gen,
                       device="cuda")] * 2
    n = sampler.TEXT_LEN
    txt = torch.randn((n, cfg.text_states_dim), generator=gen, device="cuda")
    mask = torch.ones((n,), dtype=torch.int32, device="cuda")
    txt2 = torch.randn((cfg.text_states_dim_2,), generator=gen,
                       device="cuda")
    pinned = []
    before = block_sparse_attention.launches
    lat = sampler.predict_i2v(
        img, txt, mask, txt2, opts,
        on_step=lambda i, x: pinned.append(torch.equal(x[:, :1], img[0])))
    torch.cuda.synchronize()
    assert pinned == [True] * 4
    assert torch.isfinite(lat).all() and lat[:, 1:].abs().max() > 0
    assert block_sparse_attention.launches > before


@pytest.mark.gpu
def test_dense_kernel_rejects_what_it_does_not_cover(cuda_device):
    q, k, v = _dense_inputs(15, cuda_device, 1, 256, 256)
    with pytest.raises(TypeError):
        dense_attention(q.float(), k.float(), v.float())
    with pytest.raises(ValueError):
        dense_attention(q[..., :64], k[..., :64], v[..., :64])
    with pytest.raises(NotImplementedError):
        dense_attention(q, k, v, causal=True)
    # a launch the short-key kernel refuses (over its 512 keys, routed to
    # it) raises with the CUDA error string and counts nothing
    q, k, v = _dense_inputs(15, cuda_device, 1, 256, 600)
    before = (dense_attention.launches, dense_attention.short_launches)
    with mock.patch.object(flash_attention, "SHORT_KEYS", 1024):
        with pytest.raises(RuntimeError, match="launch failed"):
            dense_attention(q, k, v)
    assert (dense_attention.launches, dense_attention.short_launches) == \
        before


@pytest.mark.gpu
def test_dense_short_kernel_build_failure_raises(cuda_device, tmp_path):
    """A short-key source that does not compile raises nvcc's output at the
    first call; nothing falls back to another kernel."""
    bad = tmp_path / "dense_attn_short.cu"
    bad.write_text("this does not compile;\n")
    q, k, v = _dense_inputs(15, cuda_device, 1, 128, 64)
    flash_attention.build_short_kernel.cache_clear()
    try:
        with mock.patch.object(flash_attention, "SHORT_KERNEL_SOURCE", bad):
            with pytest.raises(RuntimeError, match="nvcc failed"):
                dense_attention(q, k, v)
    finally:
        flash_attention.build_short_kernel.cache_clear()


@pytest.mark.gpu
@pytest.mark.parametrize("variant", SPLIT_VARIANTS + EPILOGUE_VARIANTS)
@pytest.mark.parametrize("q_rows", [1, 4])
def test_probe_kernel_matches_plain_on_card(cuda_device, variant, q_rows):
    """P1 (no text_amp, every key valid, as the TPU probe) and P2 (text_amp
    0.5 and a seqlen tail, which oracle and nomax ignore) vs their plain
    versions, per-row and joint lists with an empty row; 1e-2 covers the
    bf16 rounding of P and of the output. copy_only writes zeros."""
    q, k, v, mask = _inputs(18, cuda_device)
    idx, cnt, _ = block_lists_from_mask(mask, q_rows, q_rows > 1)
    split = variant in SPLIT_VARIANTS
    sl = torch.tensor([NB * 128 - (0 if split else 40)], dtype=torch.int32,
                      device=cuda_device)
    kw = dict(q_rows=q_rows, text_amp=0.0 if split else 0.5,
              text_start_block=TSB)
    before = (attention_probe.split_launches,
              attention_probe.epilogue_launches)
    out = attention_probe(variant, q, k, v, idx, cnt, sl, **kw)
    torch.cuda.synchronize()
    assert (attention_probe.split_launches,
            attention_probe.epilogue_launches) == (before[0] + split,
                                                   before[1] + (not split))
    ref = attention_probe_plain(variant, q.float(), k.float(), v.float(),
                                idx, cnt, sl, **kw)
    assert torch.isfinite(out).all()
    assert (out.float() - ref).abs().max().item() <= 1e-2
    if variant == "copy_only":
        assert not out.any()


@pytest.mark.gpu
@pytest.mark.parametrize("s,chunk", [(11 * 128, 1), (11 * 128 + 40, 3),
                                     (32 * 128, 8)])
def test_block_pool_matches_plain_on_card(cuda_device, s, chunk):
    """P3 vs the f32 mean of each whole block (a chunk that does not divide
    the block count, a tail past the last block). Both sum 128 bf16 values
    in f32, in another order: 1e-4 is far above that rounding."""
    rng = np.random.default_rng(19)
    x = torch.as_tensor(rng.standard_normal((2, 3, s, 128)),
                        dtype=torch.bfloat16, device=cuda_device)
    before = block_pool.launches
    out = block_pool(x, chunk=chunk)
    torch.cuda.synchronize()
    assert block_pool.launches == before + 1
    assert out.shape == (2, 3, s // 128, 128) and out.dtype == torch.float32
    assert (out - block_pool_plain(x)).abs().max().item() <= 1e-4


@pytest.mark.gpu
@pytest.mark.parametrize("b,h,sq,bq,peaked", [
    (2, 2, 1024, 256, False),     # 2 query tiles per block
    (2, 2, 1000, 1024, False),    # bq > sq, ragged last tile
    (2, 2, 640, 128, False),      # one query tile per block
    (1, 3, 2048, 1024, False),    # 8 tiles per block: K reused, Q prefetched
    (1, 3, 1000, 256, False),     # ragged last tile of the last block
    (3, 1, 300, 2048, False),     # bq > sq, 3 (b*h) slices
    (1, 3, 1000, 512, True),      # logits spanning > 30, max in tile 3
])
def test_cross_attention_resident_matches_plain_on_card(cuda_device, b, h,
                                                        sq, bq, peaked):
    """P4 vs dense f32 softmax attention over all 512 keys: whole and
    ragged query tiles, several tiles per thread block (K loaded once, the
    next tile's Q loaded during this one), bq > sq, and at least 3 (b*h) slices
    with their own K and a ragged sq, so a read that crossed into the next
    head's rows would show. In the peaked case q is scaled by 2 and key
    tile kt by kt + 1, so the row max grows tile by tile and the online
    rescale runs with factors far below 1; v is halved there to keep |o|
    under 2, where bf16's rounding stays inside the absolute bound. 1e-2
    max abs and 2e-2 relative L2 (the smoke's PROBE_REL_TOL) cover the
    bf16 rounding of P and O."""
    q, k, v = _dense_inputs(20, cuda_device, b, sq, 512, h=h)
    if peaked:
        q = q * 2
        k = k * torch.arange(1, 5, device=cuda_device).repeat_interleave(
            128)[:, None].to(k.dtype)
        v = v * 0.5
        logits = (q.float() @ k.float().transpose(-1, -2)) * 128 ** -0.5
        span = logits.amax(-1) - logits.amin(-1)
        assert span.median().item() > 30
        assert (logits[..., 384:].amax(-1) > logits[..., :384].amax(-1)
                ).float().mean().item() > 0.8
    before = cross_attention_resident.launches
    out = cross_attention_resident(q, k, v, bq=bq)
    torch.cuda.synchronize()
    assert cross_attention_resident.launches == before + 1
    assert out.shape == q.shape and out.dtype == torch.bfloat16
    ref = cross_attention_resident_plain(q.float(), k.float(), v.float())
    assert torch.isfinite(out).all()
    assert (out.float() - ref).abs().max().item() <= 1e-2
    assert ((out.float() - ref).norm() / ref.norm()).item() <= 2e-2


@pytest.mark.gpu
def test_probe_kernels_reject_what_they_do_not_cover(cuda_device):
    q, k, v = _dense_inputs(21, cuda_device, 1, 256, 512)
    with pytest.raises(ValueError):
        cross_attention_resident(q, k[:, :, :256], v[:, :, :256])
    with pytest.raises(ValueError):
        cross_attention_resident(q, k, v, bq=192)
    with pytest.raises(TypeError):
        cross_attention_resident(q.float(), k.float(), v.float())
    with pytest.raises(TypeError):
        block_pool(q.float())
    with pytest.raises(ValueError):
        block_pool(q[..., :64])
    q, k, v, mask = _inputs(22, cuda_device)
    idx, cnt, _ = block_lists_from_mask(mask, 1)
    sl = torch.tensor([NB * 128], dtype=torch.int32, device=cuda_device)
    with pytest.raises(ValueError):
        attention_probe("dense", q, k, v, idx, cnt, sl)


@pytest.mark.gpu
@pytest.mark.parametrize("argv,kernels", [
    (["hyvideo-t2v", "--video-size", "256", "128", "--video-length", "33",
      "--infer-steps", "3"], ("block_sparse_attn",)),
    (["wan-t2v", "--video-size", "224", "128", "--video-length", "17",
      "--infer-steps", "6"], ("block_sparse_attn", "dense_attn")),
    (["wan-t2v", "--sample-solver", "dpm++", "--video-size", "224", "128",
      "--video-length", "17", "--infer-steps", "6"],
     ("block_sparse_attn", "dense_attn")),
    (["hyvideo-i2v", "--video-size", "256", "128", "--video-length", "33",
      "--infer-steps", "3"], ("block_sparse_attn",)),
    (["hyvideo-i2v", "--i2v-condition-type", "latent_concat",
      "--video-size", "256", "128", "--video-length", "33",
      "--infer-steps", "3"], ("block_sparse_attn",)),
    (["wan-i2v", "--video-size", "224", "128", "--max-area", "28672",
      "--video-length", "17", "--infer-steps", "6"],
     ("block_sparse_attn", "dense_attn")),
])
def test_cli_tiny_runs_on_card(cuda_device, tmp_path, argv, kernels):
    """``--tiny`` with the CLI's default device: the tiny models are bf16
    with head dim 128 there, so their attention launches the kernels (the
    block-sparse kernel on carved steps; D for Wan's cross-attention and
    dense warm-up) instead of raising. Latents finite."""
    from jenga_tpu_torch import cli
    counters = {"block_sparse_attn": block_sparse_attention,
                "dense_attn": dense_attention}
    before = {name: fn.launches for name, fn in counters.items()}
    out = tmp_path / "lat.npy"
    cli.main([argv[0], "--tiny", "--latents-only", "--save-path", str(out),
              *argv[1:]])
    lat = np.load(out)
    assert lat.ndim == 4 and np.isfinite(lat).all() and np.abs(lat).max() > 0
    for name in kernels:
        assert counters[name].launches > before[name], name


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_fp8_linear_on_card(cuda_device, dtype):
    """An fp8 layer on the card: the e4m3 bytes and scale quantized there
    equal the CPU's quantization of the same weight, and its product equals
    ``F.linear`` of its bf16 dequant (in the layer's dtype) bit for bit:
    the same GEMM on the same operands."""
    gen = torch.Generator(device=cuda_device).manual_seed(0)
    mod = Affine(3072, 1024, dtype, cuda_device)
    mod.w.normal_(generator=gen)
    mod.b.normal_(generator=gen)
    w8_cpu, scale_cpu = quantize_linear_fp8(mod.w.cpu())
    x = torch.randn((2, 333, 3072), generator=gen, device=cuda_device,
                    dtype=dtype)
    assert quantize_tree_fp8(mod) == [""] and mod.w is None
    assert torch.equal(mod.w8.cpu().view(torch.uint8),
                       w8_cpu.view(torch.uint8))
    assert mod.scale.item() == scale_cpu.item()
    w = (mod.w8.to(torch.bfloat16) * mod.scale.to(torch.bfloat16)).to(dtype)
    torch.testing.assert_close(linear(mod, x),
                               torch.nn.functional.linear(x, w, mod.b),
                               rtol=0, atol=0)


# the CPU tests' small VAE configs (tests/test_torch_vae.py); cuDNN runs
# the f32 convs in TF32 (PyTorch's default), ~1e-3 relative a conv
HY_VAE_SMALL = dict(block_out_channels=(8, 16, 16, 16), norm_num_groups=4,
                    layers_per_block=1, sample_tsize=16, sample_size=32)
VAE_TF32_TOL = 2e-2


def _rel_l2(got, want):
    got, want = got.cpu().double(), want.cpu().double()
    return ((got - want).norm() / want.norm()).item()


def _small_vaes():
    from jenga_tpu_torch.codec import vae_hy, vae_wan
    gen = torch.Generator().manual_seed(0)
    hy = vae_hy.init_hyvae_(vae_hy.HYVAE(vae_hy.HYVAEConfig(**HY_VAE_SMALL)),
                            gen)
    wan = vae_wan.init_wanvae_(vae_wan.WanVAE(vae_wan.WanVAEConfig(dim=8)),
                               gen)
    with torch.no_grad():   # the zero-initialised attention projections
        for attn in (wan.encoder.mid.attn, wan.decoder.mid.attn):
            attn.proj.w.normal_(0.0, 0.2, generator=gen)
    return hy, wan


@pytest.mark.gpu
def test_hy_vae_tiled_decode_on_card_matches_cpu(cuda_device):
    """The small HY config decodes a 5x5x5 latent (2 temporal x 2x2 spatial
    tiles, both blends) on the card as on the CPU, within the TF32
    bound."""
    from jenga_tpu_torch.codec.vae_hy import vae_decode_tiled
    hy, _ = _small_vaes()
    z = torch.randn((1, 16, 5, 5, 5), generator=torch.Generator()
                    .manual_seed(1))
    want = vae_decode_tiled(hy, z)
    got = vae_decode_tiled(hy.to(cuda_device), z.to(cuda_device))
    assert got.shape == want.shape == (1, 3, 17, 40, 40)
    assert _rel_l2(got, want) <= VAE_TF32_TOL


@pytest.mark.gpu
def test_wan_vae_streamed_on_card_matches_cpu(cuda_device):
    """The small Wan config's streamed decode of a 4-frame latent and
    encode of 9 frames on the card as on the CPU, within the TF32
    bound."""
    from jenga_tpu_torch.codec.vae_wan import wanvae_decode, wanvae_encode
    _, wan = _small_vaes()
    gen = torch.Generator().manual_seed(2)
    z = torch.randn((1, 16, 4, 6, 8), generator=gen)
    x = torch.rand((1, 3, 9, 48, 64), generator=gen) * 2 - 1
    want = wanvae_decode(wan, z), wanvae_encode(wan, x)
    wan.to(cuda_device)
    got = (wanvae_decode(wan, z.to(cuda_device)),
           wanvae_encode(wan, x.to(cuda_device)))
    assert got[0].shape == want[0].shape == (1, 3, 13, 48, 64)
    assert got[1].shape == want[1].shape == (1, 16, 3, 6, 8)
    assert max(_rel_l2(g, w) for g, w in zip(got, want)) <= VAE_TF32_TOL


@pytest.mark.gpu
def test_encode_image_latent_on_card(cuda_device):
    """Both samplers' ``encode_image_latent`` on the card (tiny bf16 DiTs,
    the small f32 VAEs): the I2V latent shapes, finite, as on the CPU
    within the TF32 bound."""
    from jenga_tpu_torch.cli import _tiny_config, _tiny_wan_config
    from jenga_tpu_torch.runtime import HunyuanVideoSampler, WanSampler
    hy, wan = _small_vaes()
    img = torch.rand((3, 70, 90), generator=torch.Generator().manual_seed(3))
    cases = ((HunyuanVideoSampler, _tiny_config, hy, (8, 12), (16, 1, 8, 12)),
             (WanSampler, _tiny_wan_config, wan, (9, 4, 6), (16, 3, 4, 6)))
    for cls, config, vae, args, shape in cases:
        want = cls(config("cpu"), device="cpu", vae=vae).encode_image_latent(
            img, *args)
        got = cls(config("cuda"), device=cuda_device,
                  vae=vae.to(cuda_device)).encode_image_latent(img, *args)
        assert got.device.type == "cuda" and tuple(got.shape) == shape
        assert torch.isfinite(got).all()
        assert _rel_l2(got, want) <= VAE_TF32_TOL


@pytest.mark.gpu
@pytest.mark.parametrize("src,dst", [((333, 777), (256, 512)),
                                     ((100, 60), (256, 128))])
def test_resize_on_card_matches_cpu(cuda_device, src, dst):
    """The antialiased bicubic resize on the card as on the CPU, within
    1e-5 absolute on a [0, 1] image."""
    from jenga_tpu_torch.runtime import _resize_chw
    img = torch.rand((3, *src), generator=torch.Generator().manual_seed(4))
    got = _resize_chw(img, *dst, cuda_device)
    assert got.device.type == "cuda"
    assert (got.cpu() - _resize_chw(img, *dst, "cpu")).abs().max() <= 1e-5


# ------------------------------------------------- text and image encoders


def _encoder_case(name, gen):
    """(module on the CPU, forward(module, device)) of one encoder at a
    small f32 config, seeded."""
    from jenga_tpu_torch.text import clip, llama, llava, t5, xlm_roberta
    ids = torch.randint(300, 500, (2, 19), generator=gen)
    mask = torch.ones_like(ids)
    mask[1, 13:] = 0
    img = torch.randn((2, 3, 28, 28), generator=gen)
    lcfg = llama.LlamaConfig(vocab_size=512, hidden_size=64,
                             intermediate_size=128, num_layers=3,
                             num_heads=4, num_kv_heads=2)
    vcfg = clip.CLIPVisionConfig(image_size=28, patch_size=14,
                                 hidden_size=64, intermediate_size=128,
                                 num_layers=3, num_heads=4)
    if name == "llama":
        m = llama.init_llama_(llama.Llama(lcfg, dtype=torch.float32), gen)
        return m, lambda m, d: llama.llama_hidden_states(
            m, lcfg, ids.to(d), mask.to(d), num_layers=2)[-1]
    if name == "clip_text":
        cfg = clip.CLIPTextConfig(vocab_size=512, hidden_size=32,
                                  intermediate_size=64, num_layers=2,
                                  num_heads=2, eos_token_id=499)
        m = clip.init_clip_text_(clip.CLIPText(cfg), gen)
        return m, lambda m, d: clip.clip_text_encode(m, cfg, ids.to(d))[1]
    if name == "clip_vision":
        m = clip.init_clip_vision_(clip.CLIPVision(vcfg), gen)
        return m, lambda m, d: clip.clip_vision_encode(
            m, vcfg, img.to(d), use_31_block=True)
    if name == "llava":
        m = llava.init_llava_(llava.Llava(lcfg, vcfg, dtype=torch.float32),
                              gen)
        return m, lambda m, d: llava.llava_encode(
            m, lcfg, ids.to(d), mask.to(d), img.to(d), 3,
            vision_cfg=vcfg)[0][-1]
    if name == "t5":
        cfg = t5.T5Config(vocab_size=512, dim=64, dim_attn=64, dim_ffn=128,
                          num_heads=2, num_layers=2)
        m = t5.init_t5_(t5.T5Encoder(cfg, dtype=torch.float32), gen)
        return m, lambda m, d: t5.t5_encode(m, cfg, ids.to(d), mask.to(d))
    cfg = xlm_roberta.XLMRobertaConfig(vocab_size=512, max_positions=32,
                                       dim=32, num_heads=2, num_layers=2,
                                       ffn_dim=64)
    m = xlm_roberta.init_xlm_roberta_(xlm_roberta.XLMRoberta(cfg), gen)
    return m, lambda m, d: xlm_roberta.xlm_roberta_encode(m, cfg, ids.to(d))


@pytest.mark.gpu
@pytest.mark.parametrize("name", ["llama", "clip_text", "clip_vision",
                                  "llava", "t5", "xlm_roberta"])
def test_encoder_on_card_matches_cpu(cuda_device, name):
    """Each encoder at a small f32 config: the card's output against the
    CPU's on the same weights, relative L2 <= 2e-2 (the smoke's bound)."""
    module, forward = _encoder_case(name, torch.Generator().manual_seed(7))
    want = forward(module, torch.device("cpu"))
    got = forward(module.to(cuda_device), cuda_device).cpu()
    rel = ((got.double() - want.double()).norm()
           / want.double().norm()).item()
    assert torch.isfinite(got).all() and rel <= 2e-2, rel


@pytest.mark.gpu
@pytest.mark.parametrize("model,kw", [
    ("hy", {}), ("hy", {"use_cpu_offload": True}), ("hy", {"use_fp8": True}),
    ("wan_i2v", {}), ("wan_i2v", {"t5_on_host": True})])
def test_from_pretrained_on_card_matches_cpu(cuda_device, tmp_path, model,
                                             kw):
    """The smoke's small reference-layout directories (chip_smoke.py):
    every module tensor of the card's load equals the CPU's, placed as
    asked, and the prompt encodes agree within 2e-2."""
    import chip_smoke
    from jenga_tpu_torch.runtime import HunyuanVideoSampler, WanSampler
    cfgs = chip_smoke.small_configs()
    dirs = chip_smoke.write_reference_dirs(str(tmp_path), cfgs)
    with chip_smoke.small_published_configs(cfgs):
        if model == "hy":
            load = lambda dev: HunyuanVideoSampler.from_pretrained(  # noqa
                dirs["hy"], device=dev, **kw)
            card, cpu = load("cuda"), load("cpu")
            aux = "cpu" if kw.get("use_cpu_offload") else "cuda"
            parts = [(card.model, cpu.model, "cuda"),
                     (card.vae, cpu.vae, aux),
                     (card.text_encoder[2], cpu.text_encoder[2], aux),
                     (card.text_encoder_2[2], cpu.text_encoder_2[2], aux)]
            for s in (card, cpu):
                chip_smoke._set_standins(hy=s)
            outs = [s.encode_prompt(chip_smoke.PROMPT) for s in (card, cpu)]
            pairs = [(outs[0][0], outs[1][0]), (outs[0][2], outs[1][2])]
        else:
            load = lambda dev: WanSampler.from_pretrained(  # noqa
                "i2v-14B", dirs["wan_i2v"], device=dev, **kw)
            card, cpu = load("cuda"), load("cpu")
            parts = [(card.model, cpu.model, "cuda"),
                     (card.vae, cpu.vae, "cuda"),
                     (card.t5[2], cpu.t5[2],
                      "cpu" if kw.get("t5_on_host") else "cuda"),
                     (card.clip_vision[1], cpu.clip_vision[1], "cuda")]
            for s in (card, cpu):
                chip_smoke._set_standins(wan=s)
            img = torch.rand((3, 40, 30), generator=torch.Generator()
                             .manual_seed(3))
            pairs = [(card.encode_prompt(chip_smoke.PROMPT),
                      cpu.encode_prompt(chip_smoke.PROMPT)),
                     (card.encode_image_clip(img),
                      cpu.encode_image_clip(img))]
    for a, b, dev in parts:
        assert {p.device.type for p in a.parameters()} == {dev}
        sa, sb = a.state_dict(), b.state_dict()
        assert sorted(sa) == sorted(sb)
        for k in sa:
            assert torch.equal(sa[k].cpu().reshape(-1).view(torch.uint8),
                               sb[k].reshape(-1).view(torch.uint8)), k
    for got, want in pairs:
        rel = ((got.cpu().double() - want.double()).norm()
               / want.double().norm()).item()
        assert rel <= 2e-2, rel

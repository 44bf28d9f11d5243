"""The CUDA kernels (block-sparse attention in its all-member and
membership modes, dense attention, and the probe kernels P1-P4) against
their plain torch versions, on a CUDA card (skipped without one). This
file imports
no JAX, so it also runs on a machine that has only the port's
dependencies:

    python -m pytest --noconftest -q tests/test_torch_kernel_gpu.py
"""

import numpy as np
import pytest
import torch

from jenga_tpu_torch.ops.attention_probe import (EPILOGUE_VARIANTS,
                                                 SPLIT_VARIANTS,
                                                 attention_probe,
                                                 attention_probe_plain)
from jenga_tpu_torch.ops.block_pool import block_pool, block_pool_plain
from jenga_tpu_torch.ops.block_sparse_attention import (
    block_sparse_attention, block_sparse_attention_plain)
from jenga_tpu_torch.ops.cross_attention_resident import (
    cross_attention_resident, cross_attention_resident_plain)
from jenga_tpu_torch.ops.flash_attention import (dense_attention,
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
    (1, 1408, 1408, [1368])])       # HY joint length with padded text
def test_dense_kernel_matches_plain_on_card(cuda_device, b, sq, skv, kv_len):
    """The dense kernel vs its plain version, bf16 operands; 1e-2 covers the
    bf16 rounding of P and of the output. kv_len 0 gives zeros."""
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
def test_dense_kernel_rejects_what_it_does_not_cover(cuda_device):
    q, k, v = _dense_inputs(15, cuda_device, 1, 256, 256)
    with pytest.raises(TypeError):
        dense_attention(q.float(), k.float(), v.float())
    with pytest.raises(ValueError):
        dense_attention(q[..., :64], k[..., :64], v[..., :64])
    with pytest.raises(NotImplementedError):
        dense_attention(q, k, v, causal=True)


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
@pytest.mark.parametrize("sq,bq", [(1024, 256), (1000, 1024), (640, 128)])
def test_cross_attention_resident_matches_plain_on_card(cuda_device, sq, bq):
    """P4 vs dense f32 softmax attention over all 512 keys, whole and
    ragged query tiles; 1e-2 covers the bf16 rounding of P and O."""
    q, k, v = _dense_inputs(20, cuda_device, 2, sq, 512)
    before = cross_attention_resident.launches
    out = cross_attention_resident(q, k, v, bq=bq)
    torch.cuda.synchronize()
    assert cross_attention_resident.launches == before + 1
    ref = cross_attention_resident_plain(q.float(), k.float(), v.float())
    assert torch.isfinite(out).all()
    assert (out.float() - ref).abs().max().item() <= 1e-2


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

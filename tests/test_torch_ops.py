"""Parity of the port's attention, planner and dispatch with the JAX
package, on the CPU: the port's plain versions vs the JAX oracle and the
Pallas kernels in interpret mode. The kernel-vs-plain checks on the card
are in test_torch_kernel_gpu.py."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from jenga_tpu.curves.blocks import build_curve_plan
from jenga_tpu.ops.attention_ref import (
    block_sparse_attention_reference as jax_reference)
from jenga_tpu.ops.flash_attention import attention_bshd as jax_bshd
from jenga_tpu.ops.flash_attention import dense_attention as jax_dense
from jenga_tpu.ops.sparse_autodiff import _effective_mask as jax_effective
from jenga_tpu.ops.sparse_autodiff import (
    sparse_attention_from_mask as jax_sparse)
from jenga_tpu.sparse import planner as jax_planner
from jenga_tpu_torch.ops.attention_ref import block_sparse_attention_reference
from jenga_tpu_torch.ops.block_sparse_attention import (
    block_sparse_attention, block_sparse_attention_plain)
from jenga_tpu_torch.ops import flash_attention
from jenga_tpu_torch.ops.flash_attention import (attention_bshd,
                                                 dense_attention,
                                                 dense_attention_plain,
                                                 dense_route)
from jenga_tpu_torch.ops.sparse_dispatch import (block_lists_from_mask,
                                                 effective_mask,
                                                 sparse_attention_from_mask)
from jenga_tpu_torch.sparse import planner

from _torch_parity import t

# 11 blocks: 9 video (grid (9, 8, 16)) + 2 text, as in the slice tests
NB, TSB = 11, 9
GRID = (9, 8, 16)


def _qkv(seed, h=2, nb=NB, d=64):
    """f32 q/k/v with per-block structure so selection is not uniform."""
    rng = np.random.default_rng(seed)
    s = nb * 128

    def one():
        base = rng.standard_normal((1, h, s, d))
        blk = np.repeat(rng.standard_normal((1, h, nb, d)) * 1.5, 128, 2)
        return (base + blk).astype(np.float32)
    return one(), one(), rng.standard_normal((1, h, s, d)).astype(np.float32)


def _rand_mask(seed, h=2, nqb=NB, nkb=NB, density=0.4):
    rng = np.random.default_rng(seed)
    m = rng.random((1, h, nqb, nkb)) < density
    m[..., TSB:] = True
    m[:, :, TSB:] = True
    m[0, 0, 3] = False          # an empty row
    return m


@pytest.mark.parametrize("amp,seqlen", [(0.0, None), (-0.7, NB * 128 - 40),
                                        (0.6, NB * 128 - 200)])
def test_oracle_matches_jax_reference(amp, seqlen):
    """The torch oracle vs the JAX oracle in f32 (same math, summation
    order only: 1e-5)."""
    q, k, v = _qkv(0)
    mask = _rand_mask(1)
    kw = dict(text_amp=amp, text_start_block=TSB, seqlen=seqlen)
    want = np.asarray(jax_reference(jnp.asarray(q), jnp.asarray(k),
                                    jnp.asarray(v), jnp.asarray(mask), **kw))
    got = block_sparse_attention_reference(t(q), t(k), t(v), t(mask),
                                           **kw).numpy()
    assert np.isfinite(got).all()
    assert np.all(got[0, 0, 3 * 128:4 * 128] == 0.0)   # the empty row
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("q_rows,joint", [(1, False), (8, True)])
def test_dispatch_matches_jax_kernels(q_rows, joint):
    """Port dispatch (plain version on CPU) vs JAX ``sparse_attention_from
    _mask`` running the Pallas kernels in interpret mode. The JAX kernels
    use the fixed-max epilogue and feed the MXU q pre-scaled by
    sm_scale*log2(e): 1e-3 covers that deviation."""
    q, k, v = _qkv(2, d=128)
    mask = _rand_mask(3)
    seq = np.array([NB * 128 - 40], np.int32)
    kw = dict(text_start_block=TSB, text_amp=-0.5, q_rows=q_rows,
              joint=joint)
    want = np.asarray(jax_sparse(jnp.asarray(q), jnp.asarray(k),
                                 jnp.asarray(v), jnp.asarray(mask),
                                 seqlens=jnp.asarray(seq), **kw))
    got = sparse_attention_from_mask(t(q), t(k), t(v), t(mask),
                                     seqlens=t(seq), **kw).numpy()
    np.testing.assert_allclose(got, want, atol=1e-3, rtol=1e-3)


@pytest.mark.parametrize("q_rows,joint", [(1, False), (8, False), (8, True),
                                          (4, True)])
def test_effective_mask_bit_exact(q_rows, joint):
    mask = _rand_mask(5)
    want = np.asarray(jax_effective(jnp.asarray(mask), q_rows, joint))
    got = effective_mask(t(mask), q_rows, joint).numpy()
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("sel_group", [1, 8])
def test_planner_mask_bit_exact(sel_group):
    """build_block_mask in f32 vs JAX, bit for bit, with the curve plan's
    26-neighbourhood adjacency. The nearest cumulative sum to p_remain is
    printed, so a rounding tie can be told apart from a bug."""
    q, k, _ = _qkv(6)
    plan = build_curve_plan(GRID)
    kw = dict(top_k=int(0.25 * TSB), p_remain=0.3, text_start_block=TSB,
              text_blocks=NB - TSB, sel_group=sel_group)
    want = np.asarray(jax_planner.build_block_mask(
        jnp.asarray(q[:, :, :TSB * 128]), jnp.asarray(k),
        block_neighbors=jnp.asarray(plan.block_neighbors), **kw))
    got = planner.build_block_mask(
        t(q[:, :, :TSB * 128]), t(k),
        block_neighbors=t(plan.block_neighbors), **kw).numpy()
    # margin of the top-p decision (pooled scores recomputed in torch)
    qp = t(q[:, :, :TSB * 128]).reshape(1, 2, TSB, 128, -1).mean(3)
    qp = torch.stack([qp[:, :, i:i + sel_group].mean(2)
                      for i in range(0, TSB, sel_group)], 2)
    kp = t(k).reshape(1, 2, NB, 128, -1).mean(3)
    probs = torch.softmax((qp @ kp.transpose(-1, -2))[..., :TSB]
                          * q.shape[-1] ** -0.5, -1)
    csum = torch.sort(probs, -1, descending=True).values.cumsum(-1)
    print(f"nearest cumsum to p_remain: "
          f"{(csum - 0.3).abs().min().item():.3e}")
    assert want.sum() < want.size    # the selection is not all-true
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("sel_group", [1, 8])
def test_planner_first_frame_blocks_bit_exact(sel_group):
    """Wan's layout (no text blocks, text_start_block = nb) with
    first-frame forcing: 23 blocks, so q8 has a ragged last group, and 20
    first-frame blocks, so the forced q8 rows span all three groups. Bit
    for bit vs JAX in f32; the forcing must change the mask."""
    nb, ffb = 23, 20
    q, k, _ = _qkv(12, nb=nb)
    plan = build_curve_plan((5, 24, 24), "sliced", 128)
    kw = dict(top_k=int(0.25 * nb), p_remain=0.3, text_start_block=nb,
              text_blocks=0, sel_group=sel_group)
    want = np.asarray(jax_planner.build_block_mask(
        jnp.asarray(q), jnp.asarray(k), first_frame_blocks=ffb,
        block_neighbors=jnp.asarray(plan.block_neighbors), **kw))
    got = planner.build_block_mask(
        t(q), t(k), first_frame_blocks=ffb,
        block_neighbors=t(plan.block_neighbors), **kw).numpy()
    np.testing.assert_array_equal(got, want)
    rows = -(-ffb // sel_group) * sel_group if sel_group > 1 else ffb
    assert got[:, :, :rows, :ffb].all()
    unforced = planner.build_block_mask(
        t(q), t(k), block_neighbors=t(plan.block_neighbors), **kw).numpy()
    assert not np.array_equal(got, unforced)
    assert want.sum() < want.size    # the selection is not all-true


def test_planner_bf16_pooling_matches_jax():
    """The bf16 branch pools with f32 accumulation on both sides."""
    q, k, _ = _qkv(7)
    kw = dict(top_k=2, p_remain=0.3, text_start_block=TSB,
              text_blocks=NB - TSB, block_neighbors=None, sel_group=8)
    want = np.asarray(jax_planner.build_block_mask(
        jnp.asarray(q[:, :, :TSB * 128], jnp.bfloat16),
        jnp.asarray(k, jnp.bfloat16), **kw))
    got = planner.build_block_mask(
        t(q[:, :, :TSB * 128], torch.bfloat16), t(k, torch.bfloat16),
        **kw).numpy()
    np.testing.assert_array_equal(got, want)


def test_mask_to_block_lists_matches_jax():
    mask = _rand_mask(8)
    wi, wc = jax_planner.mask_to_block_lists(jnp.asarray(mask))
    gi, gc = planner.mask_to_block_lists(t(mask))
    np.testing.assert_array_equal(gc.numpy(), np.asarray(wc))
    for row in np.ndindex(mask.shape[:3]):
        n = int(wc[row])
        np.testing.assert_array_equal(gi[row][:n].numpy(),
                                      np.asarray(wi[row])[:n])


@pytest.mark.parametrize("sq,skv,kv_len,slab", [
    (384, 384, None, None), (384, 384, [300, 0], None),
    (1000, 300, [0, 137], None), (1000, 300, [0, 137], 2 * 2 * 300 * 96),
    (700, 512, None, None)])
def test_dense_attention_matches_jax(monkeypatch, sq, skv, kv_len, slab):
    """Dense attention (the CPU wrapper is the plain version) vs JAX's
    dense_attention on the CPU, f32: ragged Sq/Skv, per-sample kv_len with
    a 0 that gives zeros, and (slab) the plain version's query chunking.
    1e-5 covers summation order."""
    if slab is not None:
        monkeypatch.setattr(flash_attention, "_SLAB", slab)
    rng = np.random.default_rng(9)
    q = rng.standard_normal((2, 2, sq, 32)).astype(np.float32)
    k, v = (rng.standard_normal((2, 2, skv, 32)).astype(np.float32)
            for _ in range(2))
    kl = None if kv_len is None else np.array(kv_len, np.int32)
    want = np.asarray(jax_dense(jnp.asarray(q), jnp.asarray(k),
                                jnp.asarray(v),
                                kv_len=None if kl is None else jnp.asarray(kl)))
    got = dense_attention(t(q), t(k), t(v),
                          kv_len=None if kl is None else t(kl)).numpy()
    assert np.isfinite(got).all()
    if kv_len is not None and kv_len[1] == 0:
        assert not got[1].any()
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=1e-5)


def _last_chunk_len(skv: int) -> int:
    """A key count inside the last 16-key chunk of ``skv`` keys (the short
    route's narrow last tile): keys past it in that chunk are masked."""
    lo = 16 * ((skv - 1) // 16)
    return lo + max(1, (skv - lo) // 2)


@pytest.mark.parametrize("kv_len", [None, "last_chunk"])
@pytest.mark.parametrize("skv", [1, 17, 257, 512])
def test_attention_bshd_matches_jax(skv, kv_len):
    """The port's attention_bshd over the model's [B, S, H, D] layout (on
    the CPU the plain version of both of D's routes) vs JAX's
    attention_bshd on the CPU, f32: the short route's key counts (one key,
    a tile and a chunk, Wan's 257 image and 512 text keys), a ragged query
    count (200 rows: a last tile of 72), kv_len None and [0, k] with k
    inside the last 16-key chunk (the empty sample gives zeros). 1e-5
    covers summation order."""
    rng = np.random.default_rng(31 + skv)
    b, sq, h, d = 2, 200, 3, 32
    q = rng.standard_normal((b, sq, h, d)).astype(np.float32)
    k, v = (rng.standard_normal((b, skv, h, d)).astype(np.float32)
            for _ in range(2))
    kl = (None if kv_len is None
          else np.array([0, _last_chunk_len(skv)], np.int32))
    jkl = None if kl is None else jnp.asarray(kl)
    want = np.asarray(jax_bshd(jnp.asarray(q), jnp.asarray(k),
                               jnp.asarray(v), kv_len=jkl))
    got = attention_bshd(t(q), t(k), t(v),
                         kv_len=None if kl is None else t(kl)).numpy()
    assert got.shape == (b, sq, h, d) and np.isfinite(got).all()
    if kl is not None:
        assert not got[0].any()
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=1e-5)


def test_dense_route_is_a_function_of_the_key_count():
    """D's forward kernel on the card follows from Skv alone: the
    short-key kernel up to 512 keys, the mainloop over it."""
    assert flash_attention.SHORT_KEYS == 512
    assert {dense_route(n) for n in (1, 16, 17, 128, 257, 384, 511, 512)} \
        == {"short"}
    assert {dense_route(n) for n in (513, 640, 1024, 32760)} == {"mainloop"}


def test_short_route_reads_the_model_layout_in_place():
    """The short route's operand rule, on the CPU: a [B, S, H, D] tensor
    seen as [B, H, S, D] is taken as it is, through its strides (a dim of
    length 1 gets stride 8); a pointer off 16 bytes or a stride off 8
    elements is copied to a contiguous tensor."""
    x = torch.zeros(2, 300, 3, 128).transpose(1, 2)
    assert flash_attention._map_operand(x) is x
    assert flash_attention._map_strides(x) == [3 * 128, 128, 300 * 3 * 128]
    one = torch.zeros(1, 1, 5, 128)
    assert flash_attention._map_strides(one) == [128, 8, 8]
    flat = torch.zeros(2 * 3 * 300 * 128 + 1)
    y = flat[1:].view(2, 3, 300, 128)
    for bad in (y, torch.zeros(2, 3, 300, 132)[..., :128]):
        c = flash_attention._map_operand(bad)
        assert c is not bad and c.is_contiguous() and torch.equal(c, bad)
        assert c.data_ptr() % 16 == 0


def test_wrapper_takes_plain_version_on_cpu():
    """On CPU tensors the wrapper is its plain version and does not count
    a kernel launch."""
    q, k, v = (t(x) for x in _qkv(10, d=128))
    idx, cnt, _ = block_lists_from_mask(t(_rand_mask(11)), 1, False)
    sl = torch.tensor([NB * 128], dtype=torch.int32)
    before = block_sparse_attention.launches
    a = block_sparse_attention(q, k, v, idx, cnt, sl, text_start_block=TSB)
    b = block_sparse_attention_plain(q, k, v, idx, cnt, sl,
                                     text_start_block=TSB)
    assert block_sparse_attention.launches == before
    assert torch.equal(a, b)


def test_dense_wrapper_takes_plain_version_on_cpu():
    """On CPU tensors D's wrapper is its plain version whatever the route
    (256 keys would take the short-key kernel on the card) and counts no
    launch on either; attention_bshd likewise. ``causal=True`` (ported
    since; held to JAX in ``test_torch_causal.py``) counts none either and
    gives another function: row 0 sees key 0 alone."""
    q, k, v = (t(x) for x in _qkv(13, nb=2, d=128))
    before = (dense_attention.launches, dense_attention.short_launches)
    a = dense_attention(q, k, v, kv_len=[200])
    c = attention_bshd(q.transpose(1, 2), k.transpose(1, 2),
                       v.transpose(1, 2), kv_len=[200])
    assert (dense_attention.launches, dense_attention.short_launches) == \
        before
    assert torch.equal(a, dense_attention_plain(q, k, v, kv_len=[200]))
    assert torch.equal(c, a.transpose(1, 2))
    causal = dense_attention(q, k, v, causal=True)
    assert (dense_attention.launches, dense_attention.short_launches) == \
        before
    assert torch.equal(causal[:, :, 0], v[:, :, 0])
    assert not torch.equal(causal, a)

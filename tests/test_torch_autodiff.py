"""The port's backward passes against the JAX package's: dense attention
D (the plain version of the dK|dV and dQ kernels against the stock Pallas
TPU backward kernels in interpret mode and against ``jax.vjp`` of
``dense_attention``; the autograd Function), and the carved attention's
recompute backward against ``jenga_tpu.ops.sparse_autodiff`` in every
q_rows / joint mode, one (batch, head) slice at a time.

Inputs are numpy draws from a seed handed to both packages, in f32 (the
point is the algorithm; the kernels' bf16 rounding is held on the card).
"""

import weakref

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from jenga_tpu.ops.flash_attention import dense_attention as jax_dense
from jenga_tpu.ops.sparse_autodiff import \
    sparse_attention_from_mask as jax_sparse
from jenga_tpu_torch.ops import sparse_dispatch
from jenga_tpu_torch.ops.flash_attention import (
    dense_attention, dense_attention_backward_plain, dense_attention_forward,
    dense_attention_plain)
from jenga_tpu_torch.ops.sparse_dispatch import (effective_mask,
                                                 sparse_attention_from_mask)

from _torch_parity import rel_err


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread for this module's tiny shapes: they gain
    nothing from more (measured alone: 17.4 s at one thread, 16.3 s at
    eight), and the suite runs several worker processes on the machine's
    cores, where each extra thread only contends."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _np(*shapes, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(s).astype(np.float32) for s in shapes]


def _t(*xs):
    return [torch.from_numpy(np.array(x)) for x in xs]


def test_plain_backward_matches_stock_pallas_kernels():
    """``dense_attention_backward_plain`` against the stock Pallas TPU
    kernels ``_flash_attention_bwd_dkv`` and ``_flash_attention_bwd_dq``
    themselves, run on the CPU under ``force_tpu_interpret_mode`` through
    ``jax.vjp`` of the stock ``flash_attention`` (every block size 128,
    ``SegmentIds`` masking the keys past kv_len 200 of 256), within 1e-5
    relative L2 (both f32; the orders of their sums differ). The keys past
    kv_len get exactly zero dK and dV in both."""
    from jax.experimental.pallas import tpu as pltpu
    from jax.experimental.pallas.ops.tpu.flash_attention import (
        BlockSizes, SegmentIds, flash_attention)
    b, h, s, d, kv_len = 1, 2, 256, 128, 200
    q, k, v, do = _np(*[(b, h, s, d)] * 4, seed=1)
    bs = BlockSizes(block_q=128, block_k_major=128, block_k=128, block_b=1,
                    block_q_major_dkv=128, block_k_major_dkv=128,
                    block_k_dkv=128, block_q_dkv=128, block_k_major_dq=128,
                    block_k_dq=128, block_q_dq=128)
    seg = SegmentIds(q=jnp.zeros((b, s), jnp.int32),
                     kv=jnp.asarray(np.arange(s)[None] >= kv_len, jnp.int32))
    with pltpu.force_tpu_interpret_mode():
        out, vjp = jax.vjp(
            lambda q, k, v: flash_attention(q, k, v, segment_ids=seg,
                                            causal=False, sm_scale=d ** -0.5,
                                            block_sizes=bs), q, k, v)
        want = vjp(jnp.asarray(do))
    kl = torch.tensor([kv_len])
    o, lse = dense_attention_forward(*_t(q, k, v), kv_len=kl, with_lse=True)
    assert rel_err(o, out) <= 1e-5
    got = dense_attention_backward_plain(*_t(q, k, v), o, lse, *_t(do),
                                         kv_len=kl)
    for name, x, y in zip(("dq", "dk", "dv"), got, want):
        assert rel_err(x, y) <= 1e-5, name
    for x, y in zip(got[1:], want[1:]):
        assert not x[:, :, kv_len:].any()
        assert not np.asarray(y)[:, :, kv_len:].any()


@pytest.mark.parametrize("kv_len", [None, [136, 0]])
def test_dense_autograd_matches_jax_vjp(kv_len):
    """The autograd Function around D against ``jax.vjp`` of the JAX
    ``dense_attention`` on the CPU at the cross-attention shape (Sq 384,
    Skv 136) with per-sample kv_len, one sample at 0: output and
    gradients within 1e-5 relative L2, and the kv_len 0 sample's output
    and gradients exactly 0 in both."""
    b, h, sq, skv, d = 2, 2, 384, 136, 64
    q, do = _np((b, h, sq, d), (b, h, sq, d), seed=2)
    k, v = _np((b, h, skv, d), (b, h, skv, d), seed=3)
    jkl = None if kv_len is None else jnp.asarray(kv_len, jnp.int32)
    out, vjp = jax.vjp(lambda q, k, v: jax_dense(q, k, v, kv_len=jkl),
                       q, k, v)
    want = vjp(jnp.asarray(do))
    tq, tk, tv = (x.requires_grad_() for x in _t(q, k, v))
    tkl = None if kv_len is None else torch.tensor(kv_len)
    got_out = dense_attention(tq, tk, tv, kv_len=tkl)
    got_out.backward(*_t(do))
    assert rel_err(got_out.detach(), out) <= 1e-5
    for x, y in zip((tq.grad, tk.grad, tv.grad), want):
        assert rel_err(x, y) <= 1e-5
    if kv_len is not None:
        for x in (got_out.detach(), tq.grad, tk.grad, tv.grad):
            assert not x[1].any()
        assert not tk.grad[0, :, 136:].any()


def test_plain_backward_is_autograd_of_plain_forward():
    """The plain backward from the saved statistics equals torch autograd
    through the plain forward (both f32), ragged kv_len included, within
    1e-5 relative L2."""
    b, h, sq, skv, d = 2, 3, 300, 160, 32
    q, do = _t(*_np((b, h, sq, d), (b, h, sq, d), seed=4))
    k, v = _t(*_np((b, h, skv, d), (b, h, skv, d), seed=5))
    kl = torch.tensor([97, 160])
    o, lse = dense_attention_forward(q, k, v, kv_len=kl, with_lse=True)
    got = dense_attention_backward_plain(q, k, v, o, lse, do, kv_len=kl)
    qq, kk, vv = (x.clone().requires_grad_() for x in (q, k, v))
    want = torch.autograd.grad(dense_attention_plain(qq, kk, vv, kv_len=kl),
                               (qq, kk, vv), do)
    for x, y in zip(got, want):
        assert rel_err(x, y) <= 1e-5


def _sparse_case(seed, b=1, h=2, nqb=4, nkb=4, d=32, density=0.6):
    """tests/test_sparse_autodiff.py's case: random mask, every row keeps
    its diagonal block."""
    rng = np.random.default_rng(seed)
    q, k, v, g = (rng.standard_normal((b, h, n * 128, d)).astype(np.float32)
                  for n in (nqb, nkb, nkb, nqb))
    mask = (rng.random((b, h, nqb, nkb)) < density) | np.eye(
        nqb, nkb, dtype=bool)[None, None]
    return q, k, v, g, mask


def _grads_both(q, k, v, g, mask, **kw):
    def f(q, k, v):
        return jnp.sum(jax_sparse(q, k, v, jnp.asarray(mask), **kw) * g)
    want = jax.grad(f, argnums=(0, 1, 2))(q, k, v)
    tq, tk, tv = (x.requires_grad_() for x in _t(q, k, v))
    out = sparse_attention_from_mask(tq, tk, tv, torch.from_numpy(mask),
                                     **kw)
    got = torch.autograd.grad(out, (tq, tk, tv), *_t(g))
    return got, want


@pytest.mark.parametrize("q_rows,joint", [(1, False), (2, False), (2, True)])
def test_carved_backward_matches_jax(q_rows, joint):
    """The recompute backward against JAX's ``sparse_attention_from_mask``
    grads (its custom VJP through the jnp oracle) in each q_rows / joint
    mode, the joint mode over the group-union mask, within 1e-5 relative
    L2."""
    q, k, v, g, mask = _sparse_case(0)
    got, want = _grads_both(q, k, v, g, mask, q_rows=q_rows, joint=joint)
    for x, y in zip(got, want):
        assert rel_err(x, y) <= 1e-5


def test_carved_backward_text_amp_and_seqlens_match_jax():
    """text_amp on the text key blocks and a per-sample seqlen flow
    through the recompute backward as in JAX (1e-5 relative L2); keys past
    seqlen get exactly zero dK and dV, and a row of the mask with no
    block gives zero gradients, not NaN."""
    q, k, v, g, mask = _sparse_case(4, b=2, h=1, density=0.5)
    mask[1, 0, 2] = False                       # an empty row
    sl = np.array([3 * 128 + 64, 4 * 128], np.int32)
    kw = dict(text_start_block=3, text_amp=-1.5)
    got, want = _grads_both(q, k, v, g, mask, seqlens=sl, **kw)
    for x, y in zip(got, want):
        assert torch.isfinite(x).all()
        assert rel_err(x, y) <= 1e-5
    assert not got[1][0, :, sl[0]:].any() and not got[2][0, :, sl[0]:].any()
    assert not got[0][1, 0, 256:384].any()


def test_carved_backward_holds_one_slice_at_a_time(monkeypatch):
    """The backward calls the oracle once per (batch, head) slice on
    [1, 1, S, D] operands, and each slice's graph (its logits) is freed
    before the next slice is built: a spy keeps a weak reference to each
    call's output and finds the previous one dead. The mask it is handed
    is the effective (joint group-union) mask."""
    q, k, v, g, mask = _sparse_case(5, b=2, h=3)
    real = sparse_dispatch.block_sparse_attention_reference
    calls, alive = [], []
    eff = effective_mask(torch.from_numpy(mask), 2, True)

    def spy(q1, k1, v1, m1, **kw):
        alive.append(calls[-1]() is not None if calls else False)
        b_, h_ = len(calls) // 3, len(calls) % 3
        assert q1.shape[:2] == (1, 1)
        assert torch.equal(m1[0, 0], eff[b_, h_])
        out = real(q1, k1, v1, m1, **kw)
        calls.append(weakref.ref(out))
        return out

    monkeypatch.setattr(sparse_dispatch, "block_sparse_attention_reference",
                        spy)
    tq, tk, tv = (x.requires_grad_() for x in _t(q, k, v))
    out = sparse_attention_from_mask(tq, tk, tv, torch.from_numpy(mask),
                                     q_rows=2, joint=True)
    assert not calls          # the forward is the kernel's (plain) path
    out.backward(*_t(g))
    assert len(calls) == 2 * 3 and not any(alive)
    assert calls[-1]() is None

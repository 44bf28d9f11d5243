"""``dense_attention(causal=True)`` of the port against the JAX package's
on the CPU, forward and gradient.

JAX computes causal attention in jnp on every backend, outside any Pallas
kernel (its TPU dispatch requires ``not causal``): f32 logits times
``sm_scale``, the mask ``tril(ones(Sq, Skv))`` aligned top-left and ANDed
with the per-sample ``kv_len`` keys, a softmax that gives zeros for a row
with no key, the product with v in f32, the output in q's dtype. The port
does the same in torch on either device. Inputs are made with numpy from
a seed. Tolerances: f32 1e-5 (atol and rtol) forward and gradient; bf16
within one bf16 ulp of JAX's output (both round the same f32 numbers,
which differ only in summation order).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from jenga_tpu.ops import flash_attention as jfa
from jenga_tpu_torch.ops import flash_attention as tfa

# name -> (B, H, Sq, Skv, D, kv_len)
CASES = {
    "square": (1, 2, 64, 64, 16, None),
    "fewer_queries": (1, 2, 40, 72, 16, None),
    "more_queries": (1, 2, 72, 40, 32, None),
    "kv_len_empty_and_partial": (2, 2, 48, 64, 16, [0, 29]),
    "kv_len_scalar": (1, 3, 33, 33, 8, 20),
}


def _inputs(case, dtype=np.float32, seed=0):
    b, h, sq, skv, d, kv_len = CASES[case]
    rng = np.random.default_rng(seed)
    q, k, v = (rng.standard_normal(s).astype(np.float32) for s in
               ((b, h, sq, d), (b, h, skv, d), (b, h, skv, d)))
    return q, k, v, kv_len


def _jax(q, k, v, kv_len, dtype=jnp.float32, **kw):
    kl = None if kv_len is None else jnp.asarray(kv_len, jnp.int32)
    return jfa.dense_attention(*(jnp.asarray(x, dtype) for x in (q, k, v)),
                               causal=True, kv_len=kl, **kw)


def _port(q, k, v, kv_len, dtype=torch.float32, **kw):
    kl = None if kv_len is None else torch.as_tensor(kv_len)
    return tfa.dense_attention(*(torch.as_tensor(x, dtype=dtype)
                                 for x in (q, k, v)),
                               causal=True, kv_len=kl, **kw)


@pytest.mark.parametrize("case", list(CASES))
def test_forward_matches_jax_f32(case):
    q, k, v, kv_len = _inputs(case)
    want = np.asarray(_jax(q, k, v, kv_len))
    got = _port(q, k, v, kv_len)
    assert got.dtype == torch.float32 and got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("case", ["square", "kv_len_empty_and_partial"])
def test_forward_matches_jax_bf16(case):
    """bf16 operands: the output is bf16 and within one bf16 ulp of
    JAX's, element by element."""
    q, k, v, kv_len = _inputs(case)
    want = np.asarray(_jax(q, k, v, kv_len, jnp.bfloat16), np.float32)
    got = _port(q, k, v, kv_len, torch.bfloat16)
    assert got.dtype == torch.bfloat16
    got = got.float().numpy()
    mag = np.abs(want)
    ulp = np.where(mag > 0, 2.0 ** (np.floor(np.log2(np.maximum(
        mag, 1e-30))) - 7), 0.0)
    assert np.abs(want).max() > 0 and np.all(np.abs(got - want) <= ulp)


@pytest.mark.parametrize("case", ["square", "more_queries",
                                  "kv_len_empty_and_partial"])
def test_gradient_matches_jax(case):
    """d/d(q, k, v) of <out, w> against ``jax.grad``, f32 1e-5."""
    q, k, v, kv_len = _inputs(case)
    w = np.random.default_rng(1).standard_normal(
        (*q.shape[:3], v.shape[-1])).astype(np.float32)
    want = jax.grad(lambda a, b, c: jnp.sum(
        _jax(a, b, c, kv_len) * w), argnums=(0, 1, 2))(
        *(jnp.asarray(x) for x in (q, k, v)))
    qt, kt, vt = (torch.tensor(x, requires_grad=True) for x in (q, k, v))
    kl = None if kv_len is None else torch.as_tensor(kv_len)
    out = tfa.dense_attention(qt, kt, vt, causal=True, kv_len=kl)
    (out * torch.as_tensor(w)).sum().backward()
    for g, ref in zip((qt.grad, kt.grad, vt.grad), want):
        assert torch.isfinite(g).all()
        np.testing.assert_allclose(g.numpy(), np.asarray(ref), atol=1e-5,
                                   rtol=1e-5)


def test_empty_row_gives_zeros_and_no_kernel(monkeypatch):
    """A sample with ``kv_len`` 0 gives zero output and zero gradients,
    not NaN; every other row attends keys 0..i only (a key past the
    diagonal changes nothing). The path reaches neither kernel D's
    wrapper nor its autograd Function."""
    def refuse(*a, **k):
        raise AssertionError("causal attention reached kernel D")

    monkeypatch.setattr(tfa, "dense_attention_forward", refuse)
    monkeypatch.setattr(tfa._DenseAttention, "apply", refuse)
    q, k, v, kv_len = _inputs("kv_len_empty_and_partial")
    qt, kt, vt = (torch.tensor(x, requires_grad=True) for x in (q, k, v))
    out = tfa.dense_attention(qt, kt, vt, causal=True,
                              kv_len=torch.as_tensor(kv_len))
    assert torch.equal(out[0], torch.zeros_like(out[0]))
    out.sum().backward()
    assert torch.equal(qt.grad[0], torch.zeros_like(qt.grad[0]))
    assert torch.isfinite(kt.grad).all() and torch.isfinite(vt.grad).all()
    k2 = kt.detach().clone()
    k2[1, :, 20] += 5.0         # key 20: past the diagonal of rows 0..19
    with torch.no_grad():
        out2 = tfa.dense_attention(qt, k2, vt, causal=True,
                                   kv_len=torch.as_tensor(kv_len))
    assert torch.equal(out2[1, :, :20], out.detach()[1, :, :20])
    assert not torch.equal(out2[1, :, 20:], out.detach()[1, :, 20:])


def test_chunked_query_axis_matches(monkeypatch):
    """Chunking the query axis (``_SLAB``, forced here to a few rows)
    gives the same function: within 1e-6 of one chunk."""
    q, k, v, kv_len = _inputs("kv_len_empty_and_partial")
    whole = _port(q, k, v, kv_len)
    monkeypatch.setattr(tfa, "_SLAB", 7 * 2 * 2 * 64)
    assert tfa._chunk(2, 2, 64) == 7
    np.testing.assert_allclose(_port(q, k, v, kv_len).numpy(),
                               whole.numpy(), atol=1e-6, rtol=1e-6)


def test_attention_bshd_passes_causal():
    """``attention_bshd(causal=True)`` over [B, S, H, D] against JAX's,
    with ``sm_scale``, f32 1e-5."""
    rng = np.random.default_rng(2)
    q, k, v = (rng.standard_normal((2, s, 3, 16)).astype(np.float32)
               for s in (40, 56, 56))
    want = jfa.attention_bshd(jnp.asarray(q), jnp.asarray(k),
                              jnp.asarray(v), causal=True, sm_scale=0.3,
                              kv_len=jnp.asarray([56, 17], jnp.int32))
    got = tfa.attention_bshd(torch.as_tensor(q), torch.as_tensor(k),
                             torch.as_tensor(v), causal=True, sm_scale=0.3,
                             kv_len=torch.as_tensor([56, 17]))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5,
                               rtol=1e-5)

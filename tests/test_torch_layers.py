"""Parity of ``jenga_tpu_torch.models.layers`` with ``jenga_tpu.models.
layers`` on the CPU, in f32 (same inputs from numpy; tolerances cover
summation order and transcendental implementations only)."""

import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from jenga_tpu.models import layers as JL
from jenga_tpu_torch.models import layers as TL

from _torch_parity import t

RNG = np.random.default_rng(0)
X = RNG.standard_normal((2, 12, 4, 32)).astype(np.float32)
W = RNG.standard_normal((32,)).astype(np.float32)
B = RNG.standard_normal((32,)).astype(np.float32)


def _close(got, want, tol=1e-5):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), atol=tol,
                               rtol=tol)


def test_linear_transposed_weight():
    w = RNG.standard_normal((32, 48)).astype(np.float32)      # JAX [in, out]
    b = RNG.standard_normal((48,)).astype(np.float32)
    want = JL.linear({"w": jnp.asarray(w), "b": jnp.asarray(b)},
                     jnp.asarray(X))
    p = types.SimpleNamespace(w=t(w.T.copy()), b=t(b))        # torch [out, in]
    _close(TL.linear(p, t(X)), want, 1e-4)


@pytest.mark.parametrize("affine", [False, True])
def test_norms(affine):
    w, b = (W, B) if affine else (None, None)
    jw = None if w is None else jnp.asarray(w)
    jb = None if b is None else jnp.asarray(b)
    tw = None if w is None else t(w)
    tb = None if b is None else t(b)
    _close(TL.rms_norm(t(X), tw), JL.rms_norm(jnp.asarray(X), jw))
    _close(TL.layer_norm(t(X), tw, tb),
           JL.layer_norm(jnp.asarray(X), jw, jb))


def test_norm_affine_keeps_bf16():
    """Affine in f32 before the cast: a bf16 input stays bf16 under f32
    weights (the q/k dtype leak)."""
    xb = t(X).to(torch.bfloat16)
    assert TL.rms_norm(xb, t(W)).dtype == torch.bfloat16
    assert TL.layer_norm(xb, t(W), t(B)).dtype == torch.bfloat16
    assert TL.modulate(xb, t(B), t(W)).dtype == torch.bfloat16


def test_activations_and_modulate():
    _close(TL.gelu_tanh(t(X)), JL.gelu_tanh(jnp.asarray(X)))
    _close(TL.silu(t(X)), JL.silu(jnp.asarray(X)))
    _close(TL.modulate(t(X), shift=t(B), scale=t(W)),
           JL.modulate(jnp.asarray(X), shift=jnp.asarray(B),
                       scale=jnp.asarray(W)))


@pytest.mark.parametrize("flip", [True, False])
def test_sinusoidal_embedding(flip):
    pos = np.array([0.0, 1.0, 250.5, 999.0], np.float32)
    _close(TL.sinusoidal_embedding(256, t(pos), flip_sin_cos=flip),
           JL.sinusoidal_embedding(256, jnp.asarray(pos), flip_sin_cos=flip),
           1e-4)


@pytest.mark.parametrize("channel_last", [False, True])
def test_patchify_unpatchify(channel_last):
    x = RNG.standard_normal((1, 4, 3, 8, 6)).astype(np.float32)
    w = RNG.standard_normal((16, 32)).astype(np.float32)
    jy, jgrid = JL.patchify_3d({"w": jnp.asarray(w)}, jnp.asarray(x),
                               (1, 2, 2))
    proj = TL.Affine(16, 32, torch.float32, "cpu", bias=False)
    with torch.no_grad():
        proj.w.copy_(t(w.T.copy()))
    ty, tgrid = TL.patchify_3d(proj, t(x), (1, 2, 2))
    assert tgrid == jgrid
    _close(ty, jy, 1e-4)
    feat = RNG.standard_normal((1, 36, 16)).astype(np.float32)
    _close(TL.unpatchify_3d(t(feat), (3, 4, 3), (1, 2, 2), 4, channel_last),
           JL.unpatchify_3d(jnp.asarray(feat), (3, 4, 3), (1, 2, 2), 4,
                            channel_last), 0)


def test_rope_tables_and_apply():
    order = RNG.permutation(3 * 4 * 5)
    cos, sin = TL.rope_table_3d((3, 4, 5), (8, 12, 12), 256.0, order)
    jcos, jsin = JL.rope_table_3d((3, 4, 5), (8, 12, 12), 256.0, order)
    np.testing.assert_array_equal(cos, jcos)
    np.testing.assert_array_equal(sin, jsin)
    x = RNG.standard_normal((2, 60, 3, 32)).astype(np.float32)
    _close(TL.apply_rope(t(x), t(cos), t(sin)),
           JL.apply_rope(jnp.asarray(x), jnp.asarray(cos), jnp.asarray(sin)))

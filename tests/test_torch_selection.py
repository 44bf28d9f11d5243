"""The first-block selection diagnostics of the port against the JAX
package's on the CPU: ``hy_first_selection_mask`` and
``wan_first_selection_mask``.

Each returns the carving planner's mask for the first block with no
attention run. In f32 the port's mask must equal JAX's bit for bit, and
equal the mask that the first block's planner hands the carved dispatch
inside the port's own forward on the same inputs (HunyuanVideo: its video
query rows; the text rows there are all True). Sizes are those of the
forward tests: HunyuanVideo (256, 128) x 33f, 11 blocks; Wan 2 layers of
dim 256 at latent (16, 5, 48, 48), 23 blocks with ``first_frame_blocks``
1. The forward is stopped at its first planner mask (nothing after it
can change it), and the JAX diagnostics are jitted, as the JAX bench
calls them.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from unittest import mock

from jenga_tpu.curves.blocks import build_curve_plan
from jenga_tpu.models import hyvideo as jhy
from jenga_tpu.models import wan as jwan
from jenga_tpu_torch.convert import hyvideo_params_from_jax, \
    wan_params_from_jax
from jenga_tpu_torch.models import hyvideo as thy
from jenga_tpu_torch.models import wan as twan

from _torch_parity import LATENT, SMALL, t, text_inputs

HY_GRID = (9, 8, 16)
WAN_SMALL = dict(dim=256, ffn_dim=512, num_heads=2, num_layers=2,
                 text_dim=64, text_len=32, dtype="float32")
WAN_GRID, WAN_LATENT = (5, 24, 24), (16, 5, 48, 48)

# name -> (model, config overrides, q_rows, joint_sel, guidance)
CASES = {
    "hy_joint_q8": ("hy", {}, 8, True, 6000.0),
    "hy_q1": ("hy", {}, 1, False, None),
    "hy_token_replace": ("hy", {"i2v_condition_type": "token_replace"}, 8,
                         True, None),
    "wan_ffb1_joint_q8": ("wan", {}, 8, True, None),
}


def _np_tree(init, cfg, seed):
    """A numpy tree of ``init(key, cfg)``'s layout (``jax.eval_shape``, so
    nothing of the JAX init runs): linear weights ``[in, out]``
    U(+-1/sqrt(in)), biases N(0, 0.02), every other leaf (norm scales,
    modulation tables) 1 + N(0, 0.1), so the zero-init layers act too."""
    rng = np.random.default_rng(seed)
    shapes = jax.eval_shape(lambda k: init(k, cfg), jax.random.PRNGKey(0))

    def fill(path, s):
        name = jax.tree_util.keystr(path)
        if name.endswith("['w']") and s.ndim == 2:
            x = rng.uniform(-1, 1, s.shape) / np.sqrt(s.shape[0])
        elif name.endswith("['b']"):
            x = 0.02 * rng.standard_normal(s.shape)
        else:
            x = 1 + 0.1 * rng.standard_normal(s.shape)
        return x.astype(s.dtype)

    return jax.tree_util.tree_map_with_path(fill, shapes)


@functools.cache
def _hy_models(overrides):
    kw = dict(SMALL, **dict(overrides))
    cfg = jhy.HYVideoConfig(**kw)
    params = _np_tree(jhy.init_hyvideo_params, cfg, 0)
    model = thy.HYVideoDiT(thy.HYVideoConfig(**kw))
    model.load_state_dict(hyvideo_params_from_jax(params), strict=True)
    return cfg, params, model


@functools.cache
def _wan_models():
    cfg = jwan.WanConfig(**WAN_SMALL)
    params = _np_tree(jwan.init_wan_params, cfg, 1)
    model = twan.WanDiT(twan.WanConfig(**WAN_SMALL))
    model.load_state_dict(wan_params_from_jax(params), strict=True)
    return cfg, params, model


class _Stop(Exception):
    pass


def _first_mask(module, forward):
    """The planner mask ``forward()`` hands ``module``'s carved dispatch
    first; the forward stops there."""
    masks = []

    def recording(qt, kt, vt, mask, **kw):
        masks.append(mask.clone())
        raise _Stop

    with mock.patch.object(module, "sparse_attention_from_mask",
                           recording), pytest.raises(_Stop):
        forward()
    return masks[0]


def _hy_case(overrides, q_rows, joint, guidance):
    cfg, params, model = _hy_models(tuple(overrides.items()))
    rng = np.random.default_rng(3)
    x = rng.standard_normal((1, *LATENT)).astype(np.float32)
    tt = np.array([900.0], np.float32)
    txt, mask, txt2 = (a[None] for a in text_inputs(SMALL))
    g = None if guidance is None else np.array([guidance], np.float32)
    jc = jhy.make_hy_carve(cfg, build_curve_plan(HY_GRID), 0.75, 0.3,
                           q_rows=q_rows, joint_sel=joint)
    want = jax.jit(jhy.hy_first_selection_mask, static_argnums=1)(
        jax.tree.map(jnp.asarray, params), cfg,
        *(jnp.asarray(a) for a in (x, tt, txt, mask, txt2)), jc,
        guidance=None if g is None else jnp.asarray(g))
    tc = thy.make_hy_carve(model.cfg, HY_GRID, 0.75, 0.3, q_rows=q_rows,
                           joint_sel=joint)
    args = (t(x), t(tt), t(txt), t(mask), t(txt2), tc,
            None if g is None else t(g))
    with torch.inference_mode():
        got = thy.hy_first_selection_mask(model, *args)
        first = _first_mask(thy, lambda: model(*args[:5], carve=tc,
                                               guidance=args[6]))
    tsb = got.shape[2]
    assert first[:, :, tsb:].all()
    return got, np.asarray(want), first[:, :, :tsb]


def _wan_case(q_rows, joint):
    cfg, params, model = _wan_models()
    rng = np.random.default_rng(3)
    x = rng.standard_normal((1, *WAN_LATENT)).astype(np.float32)
    tt = np.array([900.0], np.float32)
    ctx = np.zeros((1, WAN_SMALL["text_len"], WAN_SMALL["text_dim"]),
                   np.float32)
    ctx[:, :20] = rng.standard_normal((1, 20, WAN_SMALL["text_dim"]))
    jc = jwan.make_wan_carve(cfg, build_curve_plan(WAN_GRID, "sliced", 128),
                             0.75, 0.3, q_rows=q_rows, joint_sel=joint)
    want = jax.jit(jwan.wan_first_selection_mask, static_argnums=1)(
        jax.tree.map(jnp.asarray, params), cfg,
        *(jnp.asarray(a) for a in (x, tt, ctx)), jc)
    tc = twan.make_wan_carve(model.cfg, WAN_GRID, 0.75, 0.3, curve="sliced",
                             q_rows=q_rows, joint_sel=joint)
    assert tc.first_frame_blocks == jc.first_frame_blocks == 1
    with torch.inference_mode():
        got = twan.wan_first_selection_mask(model, t(x), t(tt), t(ctx), tc)
        first = _first_mask(twan, lambda: model(t(x), t(tt), t(ctx),
                                                carve=tc))
    return got, np.asarray(want), first


@functools.cache
def _masks(name):
    kind, overrides, q_rows, joint, guidance = CASES[name]
    if kind == "hy":
        return _hy_case(overrides, q_rows, joint, guidance)
    return _wan_case(q_rows, joint)


@pytest.mark.parametrize("name", list(CASES))
def test_mask_matches_jax(name):
    """The port's mask equals JAX's bit for bit (shape [B, H, rows, nkb],
    bool), and selects neither nothing nor everything."""
    got, want, _ = _masks(name)
    assert got.dtype == torch.bool and tuple(got.shape) == want.shape
    assert np.array_equal(got.numpy(), want)
    assert 0 < want.mean() < 1


@pytest.mark.parametrize("name", list(CASES))
def test_mask_matches_the_carved_forward(name):
    """The port's mask equals the first block's planner mask in its own
    carved forward on the same inputs."""
    got, _, first = _masks(name)
    assert torch.equal(got, first)


def test_top_k_override():
    """``top_k`` replaces the drop rate's floor, as in JAX: a larger one
    selects a superset."""
    cfg, params, model = _wan_models()
    rng = np.random.default_rng(3)
    x = t(rng.standard_normal((1, *WAN_LATENT)).astype(np.float32))
    ctx = t(np.zeros((1, WAN_SMALL["text_len"], WAN_SMALL["text_dim"]),
                     np.float32))
    tc = twan.make_wan_carve(model.cfg, WAN_GRID, 0.75, 0.3, curve="sliced")
    with torch.inference_mode():
        lo = twan.wan_first_selection_mask(model, x, t([900.0]), ctx, tc)
        hi = twan.wan_first_selection_mask(model, x, t([900.0]), ctx, tc,
                                           top_k=12)
        dflt = twan.wan_first_selection_mask(
            model, x, t([900.0]), ctx,
            dataclasses.replace(tc, sa_drop_rate=1 - 12 / 23))
    assert torch.equal(hi, dflt) and bool((hi >= lo).all())
    assert hi.sum() > lo.sum()

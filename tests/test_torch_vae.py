"""The VAEs of the port against the JAX package on the CPU, in f32:
HunyuanVideo's causal 3-D VAE (encode, decode, the tiled encode and
decode with temporal and spatial tiles and both blends, the gaussian's
mode), Wan2.1's VAE streamed frame by frame against JAX's one-shot
encode and decode, the bicubic resize against ``jax.image.resize``, and
the CLI's output rule against the JAX CLI's.

The weights are numpy trees in the layout of ``init_hyvae_params`` /
``init_wanvae_params`` (``_torch_parity.np_vae_tree``), filled from a
numpy seed with non-zero biases, norm affines and attention projections,
so that every parameter of the bridge reaches the output. The JAX side is
jitted (op by op the tiled decode takes a minute)."""

import functools
import os
from unittest import mock

import jax
import numpy as np
import pytest
import torch

from jenga_tpu import cli as jcli
from jenga_tpu.codec import vae_hy as jhy
from jenga_tpu.codec import vae_wan as jwan
from jenga_tpu_torch import cli as tcli
from jenga_tpu_torch.codec import vae_hy as thy
from jenga_tpu_torch.codec import vae_wan as twan
from jenga_tpu_torch.convert import (hyvae_params_from_jax,
                                     wanvae_params_from_jax)
from jenga_tpu_torch.runtime import _resize_chw

from _torch_parity import np_vae_tree, rel_err, t

TOL = 1e-5
# the JAX VAE tests' small HY config, with tiles small enough that a
# 5x40x40 latent takes two temporal and 2x2 spatial tiles
HY_SMALL = dict(block_out_channels=(8, 16, 16, 16), norm_num_groups=4,
                layers_per_block=1, sample_tsize=16, sample_size=32)


@pytest.fixture(scope="module")
def hy():
    jcfg = jhy.HYVAEConfig(**HY_SMALL)
    params = np_vae_tree(jhy.init_hyvae_params, jcfg, 0)
    vae = thy.HYVAE(thy.HYVAEConfig(**HY_SMALL))
    vae.load_state_dict(hyvae_params_from_jax(params), strict=True)
    return jcfg, params, vae


def _jit(fn, cfg, **kw):
    return jax.jit(functools.partial(fn, cfg=cfg, **kw))


# ------------------------------------------------------------------ HY


def test_hy_bridge_and_seeded_init(hy):
    """Every leaf of the JAX tree lands on the parameter of its path; the
    attention linears are transposed, conv weights keep their layout. The
    seeded init follows the JAX init's distributions."""
    _, params, vae = hy
    sd = hyvae_params_from_jax(params)
    assert set(sd) == set(vae.state_dict())
    q = params["decoder"]["mid"]["attn"]["q"]["w"]
    assert torch.equal(vae.decoder.mid.attn.q.w, t(q).T)
    conv = params["encoder"]["blocks"][1]["down"]["w"]
    assert torch.equal(vae.encoder.blocks[1].down.w, t(conv))
    fresh = thy.init_hyvae_(thy.HYVAE(thy.HYVAEConfig(**HY_SMALL)),
                            torch.Generator().manual_seed(0))
    w = fresh.decoder.conv_out.w
    bound = 1 / np.sqrt(w[0].numel())
    assert 0.9 * bound < w.abs().max() <= bound
    a = fresh.encoder.mid.attn.o.w
    assert 0.9 / 4 < a.abs().max() <= 1 / 4     # 1/sqrt(16)
    assert not fresh.quant_conv.b.any()
    assert torch.equal(fresh.decoder.norm_out.w, torch.ones(8))


@pytest.mark.parametrize("kind,shape", [
    ("encode", (1, 3, 9, 16, 24)), ("decode", (1, 16, 3, 3, 4))])
def test_hy_encode_decode_match_jax(hy, kind, shape):
    """One-tile encode and decode: moments [1, 32, 3, 2, 3] from 9 frames,
    video [1, 3, 9, 24, 32] from 3 latent frames."""
    jcfg, params, vae = hy
    x = np.random.default_rng(1).uniform(-1, 1, shape).astype(np.float32)
    jfn, tfn = ((jhy.vae_encode, thy.vae_encode) if kind == "encode"
                else (jhy.vae_decode, thy.vae_decode))
    want = _jit(jfn, jcfg)(params, x)
    got = tfn(vae, t(x))
    assert got.shape == want.shape
    err = rel_err(got, want)
    print(f"{kind} rel err {err:.3e}")
    assert err < TOL


def test_hy_tiled_decode_matches_jax(hy):
    """A 5x5x5 latent over 4-frame, 4x4 latent tiles: two temporal tiles
    (the second from latent frame 3, its first output frame dropped, 4
    frames blended) each of 2x2 spatial tiles (8-pixel blends against the
    already-blended neighbour, rows cut at 24 pixels)."""
    jcfg, params, vae = hy
    z = np.random.default_rng(2).standard_normal((1, 16, 5, 5, 5)).astype(
        np.float32)
    want = _jit(jhy.vae_decode_tiled, jcfg)(params, z)
    got = thy.vae_decode_tiled(vae, t(z))
    assert got.shape == want.shape == (1, 3, 17, 40, 40)
    err = rel_err(got, want)
    print(f"tiled decode rel err {err:.3e}")
    assert err < TOL


def test_hy_tiled_encode_matches_jax(hy):
    """21 frames of 40x40 over 16-frame, 32-pixel tiles: temporal tiles
    at frames 0 and 12 (the second's first latent frame dropped, one frame
    blended), each of 2x2 spatial tiles blended and cropped in latent
    space; then the gaussian's mode."""
    jcfg, params, vae = hy
    x = np.random.default_rng(3).uniform(-1, 1, (1, 3, 21, 40, 40)).astype(
        np.float32)
    want = _jit(jhy.vae_encode_tiled, jcfg)(params, x)
    got = thy.vae_encode_tiled(vae, t(x))
    assert got.shape == want.shape == (1, 32, 6, 5, 5)
    err = rel_err(got, want)
    print(f"tiled encode rel err {err:.3e}")
    assert err < TOL
    np.testing.assert_array_equal(thy.gaussian_sample(got).numpy(),
                                  got[:, :16].numpy())
    np.testing.assert_array_equal(np.asarray(jhy.gaussian_sample(want)),
                                  np.asarray(want)[:, :16])


def test_hy_gaussian_sample_with_generator():
    """A draw is mean + exp(logvar / 2) * N(0, 1) from the generator, the
    log-variance clipped to [-30, 20] as in JAX; the same generator seed
    gives the same draw."""
    mean = torch.full((1, 4, 2, 3, 3), 3.0)
    logvar = torch.tensor([-40.0, 0.0, 10.0, 50.0]).reshape(1, 4, 1, 1, 1)
    moments = torch.cat([mean, logvar.expand_as(mean)], dim=1)
    draw = thy.gaussian_sample(moments, torch.Generator().manual_seed(5))
    noise = torch.randn(mean.shape, generator=torch.Generator().manual_seed(5))
    std = torch.exp(0.5 * logvar.clamp(-30.0, 20.0))
    torch.testing.assert_close(draw, mean + std * noise)
    assert torch.equal(thy.gaussian_sample(moments), mean)


# ------------------------------------------------------------------ Wan


@pytest.fixture(scope="module")
def wan():
    out = {}
    for z_dim in (4, 16):
        jcfg = jwan.WanVAEConfig(dim=8, z_dim=z_dim)
        params = np_vae_tree(jwan.init_wanvae_params, jcfg, z_dim)
        vae = twan.WanVAE(twan.WanVAEConfig(dim=8, z_dim=z_dim))
        vae.load_state_dict(wanvae_params_from_jax(params), strict=True)
        out[z_dim] = jcfg, params, vae
    return out


WAN_CASES = [(4, False, 1), (4, False, 2), (4, False, 4), (16, True, 4)]


@pytest.mark.parametrize("z_dim,normalize,frames", WAN_CASES)
def test_wan_streamed_decode_matches_jax_one_shot(wan, z_dim, normalize,
                                                  frames):
    """The decode, one latent frame at a time through the carried causal
    caches, against JAX's one-shot over the whole clip: 1 + 4(T-1) frames
    of 32x48, clamped; at z_dim 16 with the published mean and std."""
    jcfg, params, vae = wan[z_dim]
    z = np.random.default_rng(frames).standard_normal(
        (1, z_dim, frames, 4, 6)).astype(np.float32)
    want = _jit(jwan.wanvae_decode, jcfg, normalize=normalize)(params, z)
    got = twan.wanvae_decode(vae, t(z), normalize=normalize)
    assert got.shape == want.shape == (1, 3, 1 + 4 * (frames - 1), 32, 48)
    assert 0.1 < float(np.abs(np.asarray(want)).mean()) < 0.9  # not clamped
    err = rel_err(got, want)
    print(f"wan decode z{z_dim} T={frames} rel err {err:.3e}")
    assert err < TOL


@pytest.mark.parametrize("z_dim,normalize,frames", [
    (4, False, 1), (4, False, 5), (4, False, 9), (4, False, 13),
    (16, True, 9)])
def test_wan_streamed_encode_matches_jax_one_shot(wan, z_dim, normalize,
                                                  frames):
    """The encode in pixel chunks of 1, 4, 4, ... (the downsamples' time
    convs carrying a frame between chunks) against JAX's one-shot."""
    jcfg, params, vae = wan[z_dim]
    x = np.random.default_rng(frames).uniform(
        -1, 1, (1, 3, frames, 32, 48)).astype(np.float32)
    want = _jit(jwan.wanvae_encode, jcfg, normalize=normalize)(params, x)
    got = twan.wanvae_encode(vae, t(x), normalize=normalize)
    assert got.shape == want.shape == (1, z_dim, 1 + (frames - 1) // 4, 4, 6)
    err = rel_err(got, want)
    print(f"wan encode z{z_dim} F={frames} rel err {err:.3e}")
    assert err < TOL


def test_wan_encode_refuses_other_frame_counts(wan):
    """The streamed encoder takes 1 + 4k frames (the reference's chunks);
    JAX's one-shot takes any count, the reference drops the rest."""
    with pytest.raises(ValueError, match="1 \\+ 4k"):
        twan.wanvae_encode(wan[4][2], torch.zeros(1, 3, 3, 16, 16))


def test_wan_seeded_init_follows_jax():
    """Conv weights U(+-1/sqrt(fan_in)), the attention's proj zero (as
    JAX), norm gains 1, and every JAX leaf has its parameter."""
    cfg = jwan.WanVAEConfig(dim=8, z_dim=4)
    vae = twan.init_wanvae_(twan.WanVAE(twan.WanVAEConfig(dim=8, z_dim=4)),
                            torch.Generator().manual_seed(0))
    shapes = jax.eval_shape(lambda k: jwan.init_wanvae_params(k, cfg),
                            jax.random.PRNGKey(0))
    zeros = wanvae_params_from_jax(jax.tree.map(
        lambda s: np.zeros(s.shape, np.float32), shapes))
    assert {k: v.shape for k, v in zeros.items()} == {
        k: v.shape for k, v in vae.state_dict().items()}
    assert not vae.decoder.mid.attn.proj.w.any()
    w = vae.encoder.head_conv.w
    bound = 1 / np.sqrt(w[0].numel())
    assert 0.9 * bound < w.abs().max() <= bound
    assert torch.equal(vae.encoder.head_norm.g, torch.ones(32))


# ------------------------------------------------------------------ resize


@pytest.mark.parametrize("src,dst", [
    ((33, 77), (64, 128)), ((77, 33), (40, 16)), ((100, 60), (256, 128)),
    ((333, 777), (256, 512)), ((48, 80), (48, 80))])
def test_resize_matches_jax_cubic(src, dst):
    """``_resize_chw`` (torch's antialiased bicubic) against
    ``jax.image.resize(..., "cubic")`` up, down and mixed at odd sizes:
    within 1e-5 absolute on [0, 1] images. Without ``antialias`` torch's
    bicubic is another kernel (a = -0.75), off by far more."""
    img = np.random.default_rng(sum(src)).uniform(0, 1, (3, *src)).astype(
        np.float32)
    want = np.asarray(jax.image.resize(img, (3, *dst), method="cubic"))
    got = _resize_chw(img, *dst, "cpu").numpy()
    err = np.abs(got - want).max()
    print(f"resize {src} -> {dst} max abs err {err:.3e}")
    assert got.shape == want.shape and err <= 1e-5
    if src != dst:
        plain = torch.nn.functional.interpolate(
            t(img)[None], size=dst, mode="bicubic", align_corners=False)[0]
        assert np.abs(plain.numpy() - want).max() > 1e-3


# ------------------------------------------------------------------ CLI


@pytest.mark.parametrize("shape,latents_only", [
    ((3, 5, 16, 16), False), ((3, 5, 16, 16), True), ((16, 2, 2, 2), False),
    ((3, 16, 16), False)])
def test_save_output_rule_matches_jax(tmp_path, shape, latents_only):
    """``.npy`` when --latents-only or the output is not [3, F, H, W], else
    ``save_video`` on the same path, in both CLIs."""
    out = np.random.default_rng(0).uniform(-1, 1, shape).astype(np.float32)
    seen = {}

    def record(pkg):
        def save_video(path, video):
            seen[pkg] = (path, video.shape)
            return path
        return save_video

    results = {}
    for pkg, mod, video in (("jax", jcli, "jenga_tpu.utils.video"),
                            ("port", tcli, "jenga_tpu_torch.utils.video")):
        path = str(tmp_path / pkg / "out.mp4")
        os.makedirs(os.path.dirname(path))
        with mock.patch(f"{video}.save_video", record(pkg)):
            written = mod._save_output(path, out, latents_only)
        results[pkg] = (os.path.basename(written), pkg in seen)
        if written.endswith(".npy"):
            np.testing.assert_array_equal(np.load(written), out)
    assert results["port"] == results["jax"]
    assert results["port"][1] == (shape[0] == 3 and len(shape) == 4
                                  and not latents_only)

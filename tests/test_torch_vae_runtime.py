"""The VAEs in the port's samplers, pipelines and CLI against the JAX
package on the CPU, in f32: ``decode_latents`` and ``encode_image_latent``
of both samplers against the JAX runtime's methods (called on a stub that
holds the same VAE params), a HunyuanVideo T2V and a Wan T2V
``generate(..., decode=True)`` against JAX's pipelines with their
``vae_decode``, a token_replace HunyuanVideo-I2V run conditioned on the
port's encoding of an image, the I2V pipelines' decode, and
``hyvideo-i2v --i2v-image-path`` against the JAX handler.

The DiTs are the small f32 configs of the other parity tests with drop
rates 0 (dense steps), which keeps JAX's interpret-mode kernel out; the
VAEs are the JAX tests' small configs at the published tile sizes, so
these sizes take one tile (``tests/test_torch_vae.py`` holds the tiling).
The JAX VAE functions are jitted in place (op by op they take tens of
seconds)."""

import argparse
import contextlib
import dataclasses
import functools
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from jenga_tpu import cli as jcli
from jenga_tpu import runtime as jruntime
from jenga_tpu.codec import vae_hy as jvhy
from jenga_tpu.codec import vae_wan as jvwan
from jenga_tpu.models import hyvideo as jhy
from jenga_tpu.models import wan as jwan
from jenga_tpu.pipelines import hyvideo_i2v as jhy_i2v
from jenga_tpu.pipelines.hyvideo_t2v import HYT2VOptions as JHYOptions
from jenga_tpu.pipelines.hyvideo_t2v import HYVideoT2VPipeline as JHYPipe
from jenga_tpu.pipelines.wan_t2v import WanT2VOptions as JWanOptions
from jenga_tpu.pipelines.wan_t2v import WanT2VPipeline as JWanPipe
from jenga_tpu_torch import cli as tcli
from jenga_tpu_torch import runtime as truntime
from jenga_tpu_torch.codec import vae_hy as tvhy
from jenga_tpu_torch.codec import vae_wan as tvwan
from jenga_tpu_torch.configs.presets import (get_hy_i2v_options,
                                             get_hy_preset,
                                             get_wan_i2v_options,
                                             get_wan_preset)
from jenga_tpu_torch.convert import (hyvae_params_from_jax,
                                     hyvideo_params_from_jax,
                                     wan_params_from_jax,
                                     wanvae_params_from_jax)
from jenga_tpu_torch.models import hyvideo as thy
from jenga_tpu_torch.models import wan as twan

from _torch_parity import SMALL, np_params, np_vae_tree, rel_err, \
    text_inputs

TOL = 1e-5      # one VAE pass
TRAJ_TOL = 1e-4  # a short trajectory, then the decode
HY_VAE = dict(block_out_channels=(8, 16, 16, 16), norm_num_groups=4,
              layers_per_block=1)
WAN_VAE = dict(dim=8)
WAN_SMALL = dict(dim=256, ffn_dim=512, num_heads=2, num_layers=1,
                 text_dim=64, text_len=32, dtype="float32")


@pytest.fixture(scope="module")
def vaes():
    hcfg = jvhy.HYVAEConfig(**HY_VAE)
    hp = np_vae_tree(jvhy.init_hyvae_params, hcfg, 0)
    hvae = tvhy.HYVAE(tvhy.HYVAEConfig(**HY_VAE))
    hvae.load_state_dict(hyvae_params_from_jax(hp), strict=True)
    wcfg = jvwan.WanVAEConfig(**WAN_VAE)
    wp = np_vae_tree(jvwan.init_wanvae_params, wcfg, 1)
    wvae = tvwan.WanVAE(tvwan.WanVAEConfig(**WAN_VAE))
    wvae.load_state_dict(wanvae_params_from_jax(wp), strict=True)
    return {"hy": (hcfg, hp, hvae), "wan": (wcfg, wp, wvae)}


@contextlib.contextmanager
def _jitted_jax_vaes():
    """The JAX runtime calls its VAE functions op by op; the same functions
    jitted (the config, argument 2, static)."""
    with contextlib.ExitStack() as stack:
        for mod, name in ((jvhy, "vae_decode_tiled"),
                          (jvhy, "vae_encode_tiled"),
                          (jvwan, "wanvae_encode"),
                          (jvwan, "wanvae_decode")):
            fn = jax.jit(getattr(mod, name), static_argnums=(2,))
            stack.enter_context(mock.patch.object(mod, name, fn))
        yield


def _jax_sampler(kind, vaes):
    """The JAX runtime's VAE methods bound to a stub holding the params."""
    jcfg, params, _ = vaes[kind]
    stub = argparse.Namespace(vae_params=params, vae_cfg=jcfg,
                              offload=False)
    stub._vae_params_for_compute = lambda: params
    cls = (jruntime.HunyuanVideoSampler if kind == "hy"
           else jruntime.WanSampler)
    stub.decode_latents = functools.partial(cls.decode_latents, stub)
    stub.encode_image_latent = functools.partial(cls.encode_image_latent,
                                                 stub)
    return stub


def _image(h, w, seed=0):
    return np.random.default_rng(seed).uniform(0, 1, (3, h, w)).astype(
        np.float32)


# ------------------------------------------------------------------ runtime


def test_hy_runtime_vae_methods_match_jax(vaes):
    """HunyuanVideo: ``decode_latents`` (un-scale, tiled decode, clip) of
    [16, 3, 6, 8] latents to [3, 9, 48, 64], and ``encode_image_latent`` of
    a 37x53 image at latent 6x8 (bicubic resize to 48x64, 2x-1, tiled
    encode, the mode, x scaling_factor) to [16, 1, 6, 8]."""
    jax_s = _jax_sampler("hy", vaes)
    port = argparse.Namespace(vae=vaes["hy"][2], offload=False)
    lat = np.random.default_rng(1).standard_normal((16, 3, 6, 8)).astype(
        np.float32)
    img = _image(37, 53)
    with _jitted_jax_vaes():
        want_v = jax_s.decode_latents(lat)
        want_l = jax_s.encode_image_latent(img, 6, 8)
    got_v = truntime.HunyuanVideoSampler.decode_latents(port, lat)
    got_l = truntime.HunyuanVideoSampler.encode_image_latent(port, img, 6, 8)
    assert got_v.shape == want_v.shape == (3, 9, 48, 64)
    assert got_l.shape == want_l.shape == (16, 1, 6, 8)
    assert float(got_v.abs().max()) <= 1.0
    errs = rel_err(got_v, want_v), rel_err(got_l, want_l)
    print(f"hy runtime decode / encode rel err {errs}")
    assert max(errs) < TOL
    without = argparse.Namespace(vae=None)
    assert truntime.HunyuanVideoSampler.decode_latents(without, lat) is lat
    with pytest.raises(RuntimeError, match="no VAE"):
        truntime.HunyuanVideoSampler.encode_image_latent(without, img, 6, 8)


def test_wan_runtime_vae_methods_match_jax(vaes):
    """Wan: ``decode_latents`` (un-normalize, streamed decode, clamp) of
    [16, 3, 4, 6] latents to [3, 9, 32, 48], and ``encode_image_latent``
    of a 45x29 image at frame_num 9 and latent 4x6 (the resized first
    frame, then 8 zero frames, through the streamed encoder) to
    [16, 3, 4, 6]."""
    jax_s = _jax_sampler("wan", vaes)
    port = argparse.Namespace(vae=vaes["wan"][2])
    lat = np.random.default_rng(2).standard_normal((16, 3, 4, 6)).astype(
        np.float32)
    img = _image(45, 29, seed=1)
    with _jitted_jax_vaes():
        want_v = jax_s.decode_latents(lat)
        want_l = jax_s.encode_image_latent(img, 9, 4, 6)
    got_v = truntime.WanSampler.decode_latents(port, lat)
    got_l = truntime.WanSampler.encode_image_latent(port, img, 9, 4, 6)
    assert got_v.shape == want_v.shape == (3, 9, 32, 48)
    assert got_l.shape == want_l.shape == (16, 3, 4, 6)
    errs = rel_err(got_v, want_v), rel_err(got_l, want_l)
    print(f"wan runtime decode / encode rel err {errs}")
    assert max(errs) < TOL
    without = argparse.Namespace(vae=None)
    assert truntime.WanSampler.decode_latents(without, lat) is lat


# ------------------------------------------------------------------ pipelines


def test_hy_t2v_generate_decodes_as_jax(vaes):
    """A 2-step HunyuanVideo T2V run at 64x64x5f (latent 16x2x8x8, drop
    rates 0) through ``HunyuanVideoSampler(..., vae=...).predict`` against
    JAX's pipeline with the runtime's ``decode_latents`` as its
    ``vae_decode``: the video [3, 5, 64, 64]; ``decode=False`` gives the
    latents."""
    cfg, params = np_params(SMALL)
    sampler = truntime.HunyuanVideoSampler(
        thy.HYVideoConfig(**SMALL), params=hyvideo_params_from_jax(params),
        device="cpu", vae=vaes["hy"][2])
    opts = get_hy_preset("base", size=(64, 64), video_length=5,
                         num_inference_steps=2, sa_drop_rates=(0.0, 0.0))
    txt, mask, txt2 = text_inputs(SMALL, seed=3)
    lat0 = np.random.default_rng(4).standard_normal((16, 2, 8, 8)).astype(
        np.float32)
    jpipe = JHYPipe(cfg, jax.tree.map(jnp.asarray, params),
                    vae_decode=_jax_sampler("hy", vaes).decode_latents)
    with _jitted_jax_vaes():
        want = jpipe.generate(jnp.asarray(txt), jnp.asarray(mask),
                              jnp.asarray(txt2),
                              JHYOptions(**dataclasses.asdict(opts)),
                              initial_latents=lat0)
    got = sampler.predict(txt, mask, txt2, opts, initial_latents=lat0)
    assert got.shape == want.shape == (3, 5, 64, 64)
    err = rel_err(got, want)
    print(f"hy t2v decoded rel err {err:.3e}")
    assert err < TRAJ_TOL
    lat = sampler.predict(txt, mask, txt2, opts, initial_latents=lat0,
                          decode=False)
    assert lat.shape == (16, 2, 8, 8)
    torch.testing.assert_close(sampler.decode_latents(lat), got)


def test_wan_t2v_generate_decodes_as_jax(vaes):
    """A 2-step Wan T2V run at 64x64x5f (latent 16x2x8x8, drop rates 0)
    through ``WanSampler(..., vae=...).generate`` against JAX's pipeline
    with the runtime's ``decode_latents``: the video [3, 5, 64, 64]."""
    jcfg = jwan.WanConfig(**WAN_SMALL)
    params = jax.tree.map(np.asarray, jax.jit(
        jwan.init_wan_params, static_argnums=1)(jax.random.PRNGKey(0), jcfg))
    w = params["head"]["linear"]["w"]
    params["head"]["linear"]["w"] = (np.random.default_rng(5)
                                     .standard_normal(w.shape) * 0.05
                                     ).astype(w.dtype)
    sampler = truntime.WanSampler(
        twan.WanConfig(**WAN_SMALL), params=wan_params_from_jax(params),
        device="cpu", vae=vaes["wan"][2])
    opts = get_wan_preset("1.3b-base", size=(64, 64), frame_num=5,
                          sampling_steps=2, sa_drop_rates=(0.0, 0.0))
    rng = np.random.default_rng(6)
    lat0 = rng.standard_normal((16, 2, 8, 8)).astype(np.float32)
    ctx = rng.standard_normal((20, WAN_SMALL["text_dim"])).astype(np.float32)
    null = np.zeros((10, WAN_SMALL["text_dim"]), np.float32)
    jpipe = JWanPipe(jcfg, jax.tree.map(jnp.asarray, params),
                     vae_decode=_jax_sampler("wan", vaes).decode_latents)
    with _jitted_jax_vaes():
        want = jpipe.generate(jnp.asarray(ctx), jnp.asarray(null),
                              JWanOptions(**dataclasses.asdict(opts)),
                              initial_latents=lat0)
    got = sampler.generate(ctx, null, opts, initial_latents=lat0)
    assert got.shape == want.shape == (3, 5, 64, 64)
    err = rel_err(got, want)
    print(f"wan t2v decoded rel err {err:.3e}")
    assert err < TRAJ_TOL


def _jax_draws(seed, shape):
    """JAX ``generate_i2v``'s initial draw: PRNGKey(seed) -> split ->
    normal."""
    _, k = jax.random.split(jax.random.PRNGKey(seed))
    return np.array(jax.random.normal(k, (1, 16, *shape), jnp.float32))[0]


def test_hy_i2v_token_replace_on_encoded_image(vaes):
    """token_replace HunyuanVideo-I2V conditioned on the port's encoding of
    a 70x90 image (one latent per stage, 16x1x8x8), 2 steps at 64x64x5f:
    frame 0 equals the encoded latent after every step, and the decoded
    video equals JAX's pipeline on the same latents with its
    ``decode_latents``."""
    kw = dict(SMALL, i2v_condition_type="token_replace")
    cfg, params = np_params(kw)
    sampler = truntime.HunyuanVideoSampler(
        thy.HYVideoConfig(**kw), params=hyvideo_params_from_jax(params),
        device="cpu", i2v=True, vae=vaes["hy"][2])
    opts = get_hy_i2v_options("base", size=(64, 64), video_length=5,
                              num_inference_steps=2,
                              sa_drop_rates=(0.0, 0.0), seed=3)
    shapes = [lat for lat, _ in sampler.pipeline._stage_shapes(opts)]
    img = _image(70, 90, seed=2)
    img_lats = [sampler.encode_image_latent(img, s[1], s[2]) for s in shapes]
    assert all(tuple(a.shape) == (16, 1, 8, 8) for a in img_lats)
    txt, mask, txt2 = text_inputs(SMALL, seed=4)
    pinned = []
    got = sampler.predict_i2v(
        img_lats, txt, mask, txt2, opts,
        initial_latents=_jax_draws(opts.seed, shapes[0]),
        on_step=lambda i, lat: pinned.append(
            torch.equal(lat[:, :1], img_lats[0])))
    assert pinned == [True, True]
    jpipe = jhy_i2v.HYVideoI2VPipeline(
        cfg, jax.tree.map(jnp.asarray, params),
        vae_decode=_jax_sampler("hy", vaes).decode_latents)
    with _jitted_jax_vaes():
        want = jpipe.generate_i2v(
            [jnp.asarray(a.numpy()) for a in img_lats], jnp.asarray(txt),
            jnp.asarray(mask), jnp.asarray(txt2),
            jhy_i2v.HYI2VOptions(**dataclasses.asdict(opts)))
    assert got.shape == want.shape == (3, 5, 64, 64)
    err = rel_err(got, want)
    print(f"hy-i2v token_replace decoded rel err {err:.3e}")
    assert err < TRAJ_TOL


def test_i2v_pipelines_decode_only_with_vae_and_decode(vaes):
    """Wan-I2V (and HunyuanVideo-I2V latent_concat) return the decoded
    video with a VAE and ``decode=True``, the latents with
    ``decode=False`` or without a VAE; the Wan image latent comes from the
    port's encoder (first frame + 4 zero frames)."""
    wkw = dict(WAN_SMALL, model_type="i2v", in_dim=36)
    wan = truntime.WanSampler(twan.WanConfig(**wkw), device="cpu",
                              vae=vaes["wan"][2])
    wopts = get_wan_i2v_options(64 * 64, frame_num=5, sampling_steps=2,
                                sa_drop_rates=(0.0, 0.0))
    img_lat = wan.encode_image_latent(_image(50, 50), 5, 8, 8)
    assert tuple(img_lat.shape) == (16, 2, 8, 8)
    args = (img_lat, np.zeros((257, twan.CLIP_DIM), np.float32),
            np.ones((8, 64), np.float32), np.zeros((8, 64), np.float32), 5,
            8, 8, wopts)
    lat = wan.generate_i2v(*args, decode=False)
    video = wan.generate_i2v(*args)
    assert lat.shape == (16, 2, 8, 8) and video.shape == (3, 5, 64, 64)
    torch.testing.assert_close(video, wan.decode_latents(lat))

    hkw = dict(SMALL, in_channels=33)
    hy = truntime.HunyuanVideoSampler(thy.HYVideoConfig(**hkw),
                                      device="cpu", i2v=True)
    hopts = get_hy_i2v_options("base", size=(64, 64), video_length=5,
                               num_inference_steps=2,
                               i2v_condition_type="latent_concat",
                               sa_drop_rates=(0.0, 0.0))
    cond = [np.zeros((16, 1, 8, 8), np.float32)] * 2
    txt, mask, txt2 = text_inputs(SMALL)
    no_vae = hy.predict_i2v(cond, txt, mask, txt2, hopts)
    hy.vae = vaes["hy"][2]
    assert torch.equal(hy.predict_i2v(cond, txt, mask, txt2, hopts,
                                      decode=False), no_vae)
    video = hy.predict_i2v(cond, txt, mask, txt2, hopts)
    assert no_vae.shape == (16, 2, 8, 8) and video.shape == (3, 5, 64, 64)
    torch.testing.assert_close(video, hy.decode_latents(no_vae))


# ------------------------------------------------------------------ CLI


class _Captured(Exception):
    pass


class _PortPipe:
    _stage_shapes = truntime.HYVideoI2VPipeline._stage_shapes
    VAE_STRIDE = truntime.HYVideoI2VPipeline.VAE_STRIDE


def _png(tmp_path, h, w):
    from PIL import Image
    path = tmp_path / "image.png"
    rgb = (np.random.default_rng(0).uniform(0, 255, (h, w, 3))
           ).astype(np.uint8)
    Image.fromarray(rgb).save(path)
    return str(path), rgb


@pytest.mark.parametrize("extra,with_vae", [
    ([], True), ([], False), (["--i2v-resolution", "360p"], True),
    (["--video-size", "256", "128"], True)])
def test_hy_i2v_image_path_matches_jax_cli(tmp_path, capsys, extra,
                                           with_vae):
    """``hyvideo-i2v --i2v-image-path`` on a 180x320 PNG, both samplers
    stubbed: the options and the latent size each stage's encode is asked
    for equal the JAX handler's, but for the bucketed size: the port reads
    a bucket as (h, w), as the reference does, so the landscape image gets
    a landscape video (1248x704 at 720p), where the JAX CLI swaps it
    (704x1248). The image reaches the encoder as [3, H, W] in [0, 1].
    Without a VAE both take zero latents and print JAX's message."""
    path, rgb = _png(tmp_path, 180, 320)
    argv = ["hyvideo-i2v", "--i2v-image-path", path, "--infer-steps", "2",
            "--video-length", "5", *extra]
    seen = {}

    def encode(pkg):
        def encode_image_latent(image, lat_h, lat_w):
            np.testing.assert_allclose(np.asarray(image),
                                       rgb.transpose(2, 0, 1) / 255.0)
            seen.setdefault(pkg + "_encoded", []).append((lat_h, lat_w))
            return np.full((16, 1, lat_h, lat_w), 0.5, np.float32)
        return encode_image_latent

    class JaxPipe:
        _stage_shapes = jhy_i2v.HYVideoI2VPipeline._stage_shapes
        VAE_STRIDE = jhy_i2v.HYVideoI2VPipeline.VAE_STRIDE

        def generate_i2v(self, image_latents, txt, mask, txt2, opts,
                         decode=True):
            seen["jax"] = (opts, [np.asarray(a) for a in image_latents],
                           decode)
            raise _Captured

    jstub = argparse.Namespace(
        pipeline=JaxPipe(), text_encoder=None,
        vae_params={} if with_vae else None,
        encode_image_latent=encode("jax"),
        cfg=jhy.HYVideoConfig(text_states_dim=8, text_states_dim_2=4))
    with mock.patch.object(jcli, "_apply_backend"), \
            mock.patch.object(jcli, "_hy_sampler", return_value=jstub), \
            pytest.raises(_Captured):
        jcli.run_hyvideo_i2v(jcli.build_parser().parse_args(argv))
    jax_out = capsys.readouterr().out

    def port_sampler(*a, **kw):
        def predict_i2v(image_latents, txt, mask, txt2, opts, decode=True):
            seen["port"] = (opts, [np.asarray(a) for a in image_latents],
                            decode)
            raise _Captured
        return argparse.Namespace(
            pipeline=_PortPipe(), TEXT_LEN=8, predict_i2v=predict_i2v,
            text_encoder=None, cfg=thy.HYVideoConfig(text_states_dim=8,
                                                     text_states_dim_2=4),
            vae=object() if with_vae else None,
            encode_image_latent=encode("port"))

    with mock.patch.object(truntime.HunyuanVideoSampler, "from_pretrained",
                           staticmethod(port_sampler)), \
            pytest.raises(_Captured):
        tcli.run_hyvideo_i2v(tcli.build_parser().parse_args(argv))
    port_out = capsys.readouterr().out
    (jopts, jlats, jdec), (popts, plats, pdec) = seen["jax"], seen["port"]
    bucketed = not extra or extra[0] == "--i2v-resolution"
    if bucketed:
        assert popts.size == tuple(reversed(jopts.size))
        assert popts.size == {"720p": (1248, 704), "360p": (640, 352)}[
            "360p" if extra else "720p"]
        jopts = dataclasses.replace(jopts, size=popts.size)
        jlats = [a.transpose(0, 1, 3, 2) for a in jlats]
        seen["jax_encoded"] = [s[::-1] for s in seen.get("jax_encoded", [])]
    else:
        assert popts.size == (256, 128)
    assert dataclasses.asdict(popts) == dataclasses.asdict(jopts)
    assert pdec == jdec is True
    assert [a.shape for a in plats] == [a.shape for a in jlats]
    for a, b in zip(plats, jlats):
        np.testing.assert_array_equal(a, b)
    assert seen.get("port_encoded", []) == seen.get("jax_encoded", [])
    assert bool(seen.get("port_encoded")) == with_vae
    msg = "no VAE in ckpt dir: zero conditioning latents"
    assert (msg in port_out) == (msg in jax_out) == (not with_vae)


def test_hy_i2v_requires_an_image_without_tiny():
    """Without --i2v-image-path and without --tiny both CLIs exit with the
    same message (the port before it builds the model)."""
    argv = ["hyvideo-i2v", "--infer-steps", "2"]

    class JaxPipe:
        _stage_shapes = jhy_i2v.HYVideoI2VPipeline._stage_shapes
        VAE_STRIDE = jhy_i2v.HYVideoI2VPipeline.VAE_STRIDE

    jstub = argparse.Namespace(pipeline=JaxPipe(), vae_params=None)
    with mock.patch.object(jcli, "_apply_backend"), \
            mock.patch.object(jcli, "_hy_sampler", return_value=jstub), \
            pytest.raises(SystemExit) as jexit:
        jcli.run_hyvideo_i2v(jcli.build_parser().parse_args(argv))
    with mock.patch.object(truntime, "HunyuanVideoSampler",
                           side_effect=AssertionError("built")), \
            pytest.raises(SystemExit) as texit:
        tcli.run_hyvideo_i2v(tcli.build_parser().parse_args(argv))
    assert str(texit.value) == str(jexit.value)
    assert "--i2v-image-path" in str(texit.value)

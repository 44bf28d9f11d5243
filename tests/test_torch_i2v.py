"""The image-to-video slice of the port against the JAX package on the CPU:
HunyuanVideo-I2V (token_replace and latent_concat) and Wan2.1-I2V, each a
forward and a trajectory against JAX with the same weights and draws; the
param bridge on the I2V leaves; the numpy host helpers against their
originals; the CLI's I2V commands, and the options they build against the
JAX CLI's own."""

import argparse
import dataclasses
import os
import subprocess
import sys
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from jenga_tpu import cli as jcli
from jenga_tpu.curves.blocks import build_curve_plan
from jenga_tpu.models import hyvideo as jhy
from jenga_tpu.models import wan as jwan
from jenga_tpu.pipelines import hyvideo_i2v as jhy_i2v
from jenga_tpu.pipelines import wan_i2v as jwan_i2v
from jenga_tpu_torch import cli as tcli
from jenga_tpu_torch.configs.presets import (get_hy_i2v_options,
                                             get_wan_i2v_options)
from jenga_tpu_torch.convert import hyvideo_params_from_jax, wan_params_from_jax
from jenga_tpu_torch.models import hyvideo as thy
from jenga_tpu_torch.models import wan as twan
from jenga_tpu_torch.pipelines import hyvideo_i2v as thy_i2v
from jenga_tpu_torch.pipelines import wan_i2v as twan_i2v

from _torch_parity import (LATENT, SMALL, np_params, rel_err, t,
                           text_inputs, torch_model)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GRID = (9, 8, 16)   # LATENT's token grid: 1152 video tokens, 11 blocks
HY_COND = {"token_replace": dict(SMALL, i2v_condition_type="token_replace"),
           "latent_concat": dict(SMALL, in_channels=33)}
# a full Wan I2V block stack at small width and depth, head dim 128
WAN_SMALL = dict(dim=256, ffn_dim=512, num_heads=2, num_layers=2,
                 text_dim=64, text_len=32, dtype="float32", model_type="i2v",
                 in_dim=36)
# frame_num 17 at latent 16x28: (16, 5, 16, 28), token grid (5, 8, 14) =
# 560 tokens, 5 blocks with an 80-token pad tail
WAN_FRAMES, WAN_LAT = 17, (16, 28)


@pytest.fixture(scope="module")
def hy():
    """Per condition type: the JAX config, the numpy params (heads
    perturbed) and the port's model loaded strictly from the bridge."""
    out = {}
    for cond, kw in HY_COND.items():
        cfg, params = np_params(kw)
        out[cond] = (cfg, params, torch_model(kw, params))
    return out


def _wan_params(seed=0):
    cfg = jwan.WanConfig(**WAN_SMALL)
    params = jax.tree.map(np.asarray,
                          jwan.init_wan_params(jax.random.PRNGKey(seed), cfg))
    w = params["head"]["linear"]["w"]
    params["head"]["linear"]["w"] = (np.random.default_rng(seed + 100)
                                     .standard_normal(w.shape) * 0.05
                                     ).astype(w.dtype)
    return cfg, params


@pytest.fixture(scope="module")
def wan():
    cfg, params = _wan_params()
    model = twan.WanDiT(twan.WanConfig(**WAN_SMALL))
    model.load_state_dict(wan_params_from_jax(params), strict=True)
    return cfg, params, model


def _tree_names(params):
    names = []
    for path, leaf in jax.tree_util.tree_flatten_with_path(params)[0]:
        names.append(".".join(str(getattr(p, "key", getattr(p, "idx", p)))
                              for p in path))
    return names


def test_bridge_carries_i2v_leaves(hy, wan):
    """The I2V leaves (the 33-channel img_in; img_emb.*, cross_attn.k_img,
    v_img, norm_k_img) cross the bridge under their tree paths, transposed
    where they are linear weights, and load with strict=True (as the
    fixtures' models did)."""
    _, params, _ = hy["latent_concat"]
    sd = hyvideo_params_from_jax(params)
    assert len(sd) == len(_tree_names(params))
    assert sd["img_in.w"].shape == (256, 33 * 4)
    _, params, model = wan
    sd = wan_params_from_jax(params)
    assert len(sd) == len(_tree_names(params))
    for name, shape in (("img_emb.norm_in.w", (1280,)),
                        ("img_emb.fc1.w", (1280, 1280)),
                        ("img_emb.fc2.w", (256, 1280)),
                        ("img_emb.norm_out.b", (256,)),
                        ("blocks.1.cross_attn.k_img.w", (256, 256)),
                        ("blocks.1.cross_attn.v_img.b", (256,)),
                        ("blocks.1.cross_attn.norm_k_img", (256,))):
        assert tuple(sd[name].shape) == shape, name
    np.testing.assert_array_equal(sd["img_emb.fc2.w"].numpy(),
                                  params["img_emb"]["fc2"]["w"].T)
    model.load_state_dict(sd, strict=True)


def test_hy_i2v_config_by_condition_type():
    """16 channels with token_replace, 33 without it for latent_concat;
    the pipeline refuses a model that does not match its condition."""
    tr = thy.hy_i2v_config("token_replace")
    lc = thy.hy_i2v_config("latent_concat")
    assert (tr.in_channels, tr.i2v_condition_type) == (16, "token_replace")
    assert (lc.in_channels, lc.i2v_condition_type) == (33, None)
    assert (tr.hidden_size, tr.heads_num, tr.double_blocks,
            tr.single_blocks) == (3072, 24, 20, 40)
    with pytest.raises(ValueError):
        thy.hy_i2v_config("concat")
    model = thy.HYVideoDiT(thy.HYVideoConfig(**HY_COND["token_replace"]))
    opts = get_hy_i2v_options("base", i2v_condition_type="latent_concat",
                              size=(256, 128), video_length=33)
    with pytest.raises(ValueError, match="in_channels=33"):
        thy_i2v.HYVideoI2VPipeline(model).generate_i2v(
            [np.zeros((16, 1, 16, 32), np.float32)] * 2,
            *text_inputs(SMALL), opts)


def _hy_x(cond, seed):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((1, *LATENT)).astype(np.float32)
    if cond == "latent_concat":
        img = rng.standard_normal((16, 1, *LATENT[2:])).astype(np.float32)
        rep = np.zeros((1, *LATENT), np.float32)
        rep[0, :, :1] = img
        m = np.zeros((1, 1, *LATENT[1:]), np.float32)
        m[:, :, 0] = 1.0
        x = np.concatenate([x, rep, m], axis=1)
    return x


@pytest.mark.parametrize("cond", ["token_replace", "latent_concat"])
@pytest.mark.parametrize("drop", [0.75, 0.0])
def test_hy_i2v_forward_matches_jax(hy, cond, drop):
    """Full forward of the slice config under each condition type, carved
    (joint q8, a video/text boundary group) and dense, vs hyvideo_forward.
    token_replace gives the first frame's curve-ordered tokens the t=0
    modulation in every block. f32; 1e-4 relative (the T2V forwards
    measure ~1.5e-6; a first-frame mask on the wrong tokens or a wrong
    t=0 vector moves whole rows)."""
    cfg, params, model = hy[cond]
    x = _hy_x(cond, 3)
    tt = np.array([900.0], np.float32)
    txt, mask, txt2 = text_inputs(SMALL)
    plan = build_curve_plan(GRID)
    jc = jhy.make_hy_carve(cfg, plan, drop, 0.3, q_rows=8, joint_sel=True)
    tc = thy.make_hy_carve(model.cfg, GRID, drop, 0.3, q_rows=8,
                           joint_sel=True)
    want = jhy.hyvideo_forward(
        jax.tree.map(jnp.asarray, params), cfg, jnp.asarray(x),
        jnp.asarray(tt), jnp.asarray(txt[None]), jnp.asarray(mask[None]),
        jnp.asarray(txt2[None]), carve=jc)
    with torch.inference_mode():
        got = model(t(x), t(tt), t(txt[None]), t(mask[None]), t(txt2[None]),
                    carve=tc)
    assert got.shape == want.shape == (1, *LATENT)
    err = rel_err(got.numpy(), want)
    print(f"{cond} drop {drop}: forward rel err {err:.3e}")
    assert err < 1e-4


def test_hy_token_replace_branch_changes_velocity(hy):
    """The token-replace modulation acts: the same weights without it give
    another velocity, so the forward test above pins the branch."""
    _, _, model = hy["token_replace"]
    plain = thy.HYVideoDiT(thy.HYVideoConfig(**SMALL))
    plain.load_state_dict(model.state_dict(), strict=True)
    x = t(_hy_x("token_replace", 4))
    tt = t(np.array([900.0], np.float32))
    txt, mask, txt2 = (t(a[None]) for a in text_inputs(SMALL))
    with torch.inference_mode():
        a = model(x, tt, txt, mask, txt2)
        b = plain(x, tt, txt, mask, txt2)
    assert rel_err(a.numpy(), b.numpy()) > 1e-3


def _jax_draws(seed, shapes):
    """The raw normal draws of the JAX generate_i2v: split, normal(k0) for
    the stage-0 latents, then split, normal(kn) at each re-noise."""
    key = jax.random.PRNGKey(seed)
    out = []
    for shape in shapes:
        key, k = jax.random.split(key)
        out.append(np.array(jax.random.normal(k, (1, 16, *shape),
                                              jnp.float32))[0])
    return out


HY_TRAJ = {
    # two ProRes stages (res 0.5 -> 1.0, the switch after step 3), step 3
    # and step 5 skipped on the cached residual
    "token_replace": dict(num_inference_steps=6, res_rate_list=(0.5, 1.0),
                          step_rate_list=(0.5, 1.0),
                          scheduler_shift_list=(7.0, 9.0),
                          non_skip_steps=(0, 1, 2, 4)),
    # one stage, step 2 skipped
    "latent_concat": dict(num_inference_steps=4, res_rate_list=(1.0,),
                          step_rate_list=(1.0,), scheduler_shift_list=(7.0,),
                          non_skip_steps=(0, 1, 3)),
}


@pytest.mark.parametrize("cond", ["token_replace", "latent_concat"])
def test_hy_i2v_trajectory_matches_jax(hy, cond):
    """generate_i2v against the JAX pipeline with the options the CLI
    builds (base preset merged over the I2V defaults, joint q8), seeded
    non-zero conditioning latents and the JAX draws fed to the hooks. The
    host skip schedule equals JAX's; 1e-4 relative on the final latents;
    under token_replace frame 0 is the stage's conditioning latent exactly
    after every step."""
    cfg, params, model = hy[cond]
    opts = get_hy_i2v_options("base", size=(256, 128), video_length=33,
                              i2v_condition_type=cond, seed=5,
                              **HY_TRAJ[cond])
    jopts = jhy_i2v.HYI2VOptions(**dataclasses.asdict(opts))
    pipe = thy_i2v.HYVideoI2VPipeline(model)
    shapes = [lat for lat, _ in pipe._stage_shapes(opts)]
    rng = np.random.default_rng(7)
    img_lats = [rng.standard_normal((16, 1, *s[1:])).astype(np.float32)
                for s in shapes]
    txt, mask, txt2 = text_inputs(SMALL, seed=5)
    want = jhy_i2v.HYVideoI2VPipeline(
        cfg, jax.tree.map(jnp.asarray, params)).generate_i2v(
        [jnp.asarray(a) for a in img_lats], jnp.asarray(txt),
        jnp.asarray(mask), jnp.asarray(txt2), jopts, decode=False)
    draws = _jax_draws(opts.seed, shapes)
    splits = [int(opts.num_inference_steps * r) for r in opts.step_rate_list]
    pinned = []

    def on_step(i, lat):
        stage = sum(i >= s for s in splits[:-1])
        pinned.append(torch.equal(lat[:, :1], t(img_lats[stage])))
    got = pipe.generate_i2v(img_lats, txt, mask, txt2, opts,
                            initial_latents=draws[0],
                            stage_noises=dict(enumerate(draws[1:], 1)),
                            on_step=on_step)
    assert list(pipe.compute_schedule(opts)) == (
        [True, True, True, False, True, False] if cond == "token_replace"
        else [True, True, False, True])
    assert got.shape == want.shape == (16, *shapes[-1])
    err = rel_err(got.numpy(), want)
    print(f"{cond} trajectory rel err {err:.3e}")
    assert err < 1e-4
    if cond == "token_replace":
        assert len(pinned) == opts.num_inference_steps and all(pinned)
        np.testing.assert_array_equal(np.asarray(want)[:, :1], img_lats[-1])


def test_wan_i2v_forward_matches_jax(wan):
    """Full I2V forward (CFG batch of 2): y on the channel axis, 257 CLIP
    tokens through img_emb (tanh GELU) ahead of the text, and the image
    cross-attention over those keys added to the text attention over the
    rest, vs wan_forward. f32, dense self-attention; 1e-5 relative (the
    erf GELU alone moves the output ~1e-3)."""
    cfg, params, model = wan
    rng = np.random.default_rng(3)
    lat = (16, 5, *WAN_LAT)
    x = rng.standard_normal((2, *lat)).astype(np.float32)
    y = rng.standard_normal((2, 20, *lat[1:])).astype(np.float32)
    clip = rng.standard_normal((2, 257, 1280)).astype(np.float32)
    ctx = np.zeros((2, WAN_SMALL["text_len"], WAN_SMALL["text_dim"]),
                   np.float32)
    ctx[:, :20] = rng.standard_normal((2, 20, WAN_SMALL["text_dim"]))
    tt = np.array([900.0, 900.0], np.float32)
    grid = (5, WAN_LAT[0] // 2, WAN_LAT[1] // 2)
    jc = jwan.make_wan_carve(cfg, build_curve_plan(grid, "sliced", 128), 0.0,
                             0.9)
    tc = twan.make_wan_carve(model.cfg, grid, 0.0, 0.9)
    want = jwan.wan_forward(jax.tree.map(jnp.asarray, params), cfg,
                            jnp.asarray(x), jnp.asarray(tt), jnp.asarray(ctx),
                            carve=jc, clip_fea=jnp.asarray(clip),
                            y=jnp.asarray(y))
    with torch.inference_mode():
        got = model(t(x), t(tt), t(ctx), carve=tc, clip_fea=t(clip), y=t(y))
        # the image branch matters: without it the output moves
        no_img = model(t(x), t(tt), t(ctx), carve=tc,
                       clip_fea=t(clip * 0.0), y=t(y))
    err = rel_err(got.numpy(), want)
    print(f"wan i2v forward rel err {err:.3e}")
    assert err < 1e-5
    assert rel_err(no_img.numpy(), got.numpy()) > 1e-3


def test_wan_i2v_trajectory_matches_jax(wan):
    """6-step I2V trajectory with the CLI's options at a 480p-class area
    (shift 3.0, joint q8) and the tiny CLI sampler's model_id
    (wan-t2v-1.3b: under random weights the relative change of the time
    embedding between steps is ~1, where the wan-i2v-720p ret-steps
    polynomial is ~1e4 and never skips): a dense warm-up step, four carved
    steps and a TeaCache skip, from the JAX draw. The plan equals JAX's;
    1e-4 relative on the final latents."""
    cfg, params, model = wan
    opts = get_wan_i2v_options(832 * 480, sampling_steps=6,
                               frame_num=WAN_FRAMES, seed=4)
    assert (opts.shift, opts.q_group) == (3.0, 8)
    jopts = jwan_i2v.WanI2VOptions(**dataclasses.asdict(opts))
    pipe = twan_i2v.WanI2VPipeline(model, model_id="wan-t2v-1.3b")
    kinds = pipe.step_plan(opts)
    assert kinds == ["dense"] + ["carved"] * 4 + ["skip"]
    jpipe = jwan_i2v.WanI2VPipeline(cfg, jax.tree.map(jnp.asarray, params),
                                    model_id="wan-t2v-1.3b")
    sched = jwan_i2v._solver("unipc")[0](6, shift=opts.shift)
    jcompute = jpipe._teacache_schedule(
        np.array([sched.timestep(i) for i in range(6)]), jopts, set())
    assert [k != "skip" for k in kinds] == list(jcompute)

    rng = np.random.default_rng(9)
    t_lat = (WAN_FRAMES - 1) // 4 + 1
    img_lat = np.zeros((16, t_lat, *WAN_LAT), np.float32)
    img_lat[:, 0] = rng.standard_normal((16, *WAN_LAT))
    clip = rng.standard_normal((257, 1280)).astype(np.float32)
    ctx = rng.standard_normal((20, WAN_SMALL["text_dim"])).astype(np.float32)
    null = np.zeros((10, WAN_SMALL["text_dim"]), np.float32)
    want = jpipe.generate_i2v(jnp.asarray(img_lat), jnp.asarray(clip),
                              jnp.asarray(ctx), jnp.asarray(null), WAN_FRAMES,
                              *WAN_LAT, jopts, decode=False)
    lat0 = np.array(jax.random.normal(jax.random.PRNGKey(opts.seed),
                                      (1, 16, t_lat, *WAN_LAT)))[0]
    steps = []
    got = pipe.generate_i2v(img_lat, clip, ctx, null, WAN_FRAMES, *WAN_LAT,
                            opts, initial_latents=lat0,
                            on_step=lambda i, lat: steps.append(i))
    assert steps == list(range(6))
    err = rel_err(got.numpy(), want)
    print(f"wan i2v trajectory {kinds} rel err {err:.3e}")
    assert err < 1e-4


@pytest.mark.parametrize("frame_num,lat_h,lat_w", [
    (1, 4, 6), (5, 8, 12), (9, 4, 6), (17, 16, 28), (81, 60, 104)])
def test_build_i2v_mask_matches_jax(frame_num, lat_h, lat_w):
    got = twan_i2v.build_i2v_mask(frame_num, lat_h, lat_w)
    want = jwan_i2v.build_i2v_mask(frame_num, lat_h, lat_w)
    assert got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)


def test_i2v_latent_size_matches_jax():
    """Value for value over a grid of image sizes and the published areas.
    A 480x832 image under max_area 832*480 gets 58x104, not 60x104: the
    formula's sqrt gives 479.99999..., floored to 59 latent rows, then to
    an even 58 (the reference's rounding, kept)."""
    areas = (720 * 1280, 832 * 480, 480 * 480, 128 * 128)
    sizes = [(h, w) for h in (64, 240, 480, 481, 720, 1080)
             for w in (64, 300, 832, 1280, 1920)]
    for area in areas:
        for h, w in sizes:
            assert twan_i2v.i2v_latent_size(h, w, area) == \
                jwan_i2v.i2v_latent_size(h, w, area), (h, w, area)
    assert twan_i2v.i2v_latent_size(480, 832, 832 * 480) == (58, 104)
    assert twan_i2v.i2v_latent_size(720, 1280, 720 * 1280) == (90, 160)


@pytest.mark.parametrize("base", [960, 720, 480])
def test_crop_buckets_match_jax(base):
    """The three --i2v-resolution bucket bases at the JAX CLI's patch 32,
    and the closest bucket for a range of aspect ratios."""
    got = thy_i2v.generate_crop_size_list(base, 32)
    assert got == jhy_i2v.generate_crop_size_list(base, 32)
    ratios = [round(float(h) / float(w), 5) for h, w in got]
    for h, w in ((720, 1280), (1280, 720), (512, 512), (100, 400),
                 (333, 777)):
        assert thy_i2v.get_closest_ratio(h, w, ratios, got) == \
            jhy_i2v.get_closest_ratio(h, w, ratios, got)


HY_I2V_ARGV = [
    ["hyvideo-i2v", "--tiny", "--seed", "3"],
    ["hyvideo-i2v", "--tiny", "--i2v-condition-type", "latent_concat",
     "--video-size", "256", "128", "--video-length", "33", "--infer-steps",
     "8", "--q-group", "4", "--no-joint-sel"],
]
WAN_I2V_ARGV = [
    ["wan-i2v", "--tiny"],
    ["wan-i2v", "--tiny", "--video-length", "17", "--infer-steps", "6",
     "--max-area", str(832 * 480), "--q-group", "1"],
    ["wan-i2v", "--max-area", str(832 * 480), "--video-size", "832", "480",
     "--no-joint-sel"],
]


class _Captured(Exception):
    pass


@pytest.mark.parametrize("argv", HY_I2V_ARGV)
def test_hy_i2v_cli_options_match_jax_cli(argv):
    """The options ``hyvideo-i2v`` builds, field for field, against the
    ones the JAX CLI hands to its pipeline for the same flags (its sampler
    stubbed): the base preset's flow_shift 7.0, txt_block_num 2 and T2V
    skip list win over the I2V defaults. The zero conditioning latents
    have the JAX shapes.

    txt_block_num is compared too, but it diverges at generation (ROADMAP
    Queue 3, closed): the port's ``generate_i2v`` replaces it by
    ``text_block_count`` of the text states given, ceil(tokens / 128),
    where JAX keeps the options' 2 and its planner fails on the ~396 and
    ~540 llava tokens of an image prompt. For the CLI's zero text states
    (256 tokens) the two counts agree."""
    got = tcli.hy_i2v_options(tcli.build_parser().parse_args(argv))
    seen = {}

    class Pipe:
        _stage_shapes = jhy_i2v.HYVideoI2VPipeline._stage_shapes
        VAE_STRIDE = jhy_i2v.HYVideoI2VPipeline.VAE_STRIDE

        def generate_i2v(self, image_latents, txt, mask, txt2, opts,
                         decode=True):
            seen.update(opts=opts, latents=image_latents)
            raise _Captured

    stub = argparse.Namespace(pipeline=Pipe(), text_encoder=None,
                              cfg=jhy.HYVideoConfig(text_states_dim=8,
                                                    text_states_dim_2=4))
    args = jcli.build_parser().parse_args(argv + ["--cpu"])
    with mock.patch.object(jcli, "_apply_backend"), \
            mock.patch.object(jcli, "_hy_sampler", return_value=stub), \
            pytest.raises(_Captured):
        jcli.run_hyvideo_i2v(args)
    assert dataclasses.asdict(got) == dataclasses.asdict(seen["opts"])
    assert (got.flow_shift, got.txt_block_num) == (7.0, 2)
    assert thy_i2v.text_block_count(np.zeros((256, 8), np.float32)) == 2
    shapes = thy_i2v.HYVideoI2VPipeline._stage_shapes(Pipe(), got)
    assert [(16, 1, lat[1], lat[2]) for lat, _ in shapes] == \
        [a.shape for a in seen["latents"]]


@pytest.mark.parametrize("cond,n_text,blocks", [
    ("token_replace", 396, 4), ("latent_concat", 540, 5),
    ("token_replace", 256, 2), ("latent_concat", 256, 2)])
def test_hy_i2v_text_blocks_follow_the_text_states(hy, monkeypatch, cond,
                                                   n_text, blocks):
    """``generate_i2v`` takes ceil(text tokens / 128) text blocks whatever
    the options carry (the CLI's are the base preset's 2): the llava
    states of an image prompt (144 image + ~252 text tokens under
    token_replace, 288 + ~252 under latent_concat) and the 256 zero
    states. Every carve of the run has the derived count, and a carved
    2-step run at the parity size finishes with finite latents (with the
    options' 2 the 396- and 540-token states leave the planner more video
    rows than video blocks, and it fails)."""
    _, _, model = hy[cond]
    opts = get_hy_i2v_options("base", size=(256, 128), video_length=33,
                              i2v_condition_type=cond, num_inference_steps=2)
    assert opts.txt_block_num == 2
    pipe = thy_i2v.HYVideoI2VPipeline(model)
    shapes = [lat for lat, _ in pipe._stage_shapes(opts)]
    rng = np.random.default_rng(3)
    img_lats = [rng.standard_normal((16, 1, *sh[1:])).astype(np.float32)
                for sh in shapes]
    txt = rng.standard_normal((n_text, SMALL["text_states_dim"])).astype(
        np.float32)
    mask = np.ones((n_text,), np.int32)
    txt2 = rng.standard_normal((SMALL["text_states_dim_2"],)).astype(
        np.float32)
    seen = []
    real = thy.make_hy_carve

    def spy(*a, **kw):
        seen.append(kw["txt_block_num"])
        return real(*a, **kw)

    monkeypatch.setattr(thy, "make_hy_carve", spy)
    got = pipe.generate_i2v(img_lats, txt, mask, txt2, opts, decode=False)
    assert seen and set(seen) == {blocks}
    assert torch.isfinite(got).all() and got.shape == (16, *shapes[-1])


def test_hy_i2v_text_blocks_refuse_unequal_negative(hy):
    """CFG stacks the negative prompt's states with the positive ones, so
    one count must serve both: unequal lengths raise a ValueError naming
    both token counts before the first step."""
    _, _, model = hy["token_replace"]
    opts = get_hy_i2v_options("base", size=(256, 128), video_length=33,
                              num_inference_steps=2, guidance_scale=6.0)
    pipe = thy_i2v.HYVideoI2VPipeline(model)
    n = SMALL["text_states_dim"]
    neg = (np.zeros((256, n), np.float32), np.ones((256,), np.int32),
           np.zeros((SMALL["text_states_dim_2"],), np.float32))
    with pytest.raises(ValueError, match="256 tokens and the positive 396"):
        pipe.generate_i2v([None, None], np.zeros((396, n), np.float32),
                          np.ones((396,), np.int32), neg[2], opts,
                          negative=neg, decode=False)
    assert thy_i2v.text_block_count(np.zeros((540, n))) == 5


@pytest.mark.parametrize("argv", WAN_I2V_ARGV)
def test_wan_i2v_cli_options_match_jax_cli(argv):
    """The options, frame count and latent size ``wan-i2v`` builds against
    the JAX CLI's for the same flags: q_group 8 unless given, shift 3.0
    when max_area <= 832*480; with --tiny and no --video-size the JAX
    smoke shape (16x16 over --video-length or 9 frames). Without --tiny
    the JAX side takes its image path, here a stubbed 832x480 image (the
    port's --video-size) through the runtime's i2v_latent_size rule."""
    opts, frame_num, lat_h, lat_w = tcli.wan_i2v_inputs(
        tcli.build_parser().parse_args(argv))
    seen = {}

    class Pipe:
        def generate_i2v(self, img_lat, clip_fea, ctx, null, frame_num,
                         lat_h, lat_w, opts, decode=True):
            seen.update(opts=opts, frame_num=frame_num, lat=(lat_h, lat_w))
            raise _Captured

    def generate_image(image, prompt, opts, **kw):
        # jenga_tpu.runtime.WanSampler.generate_image's size rule
        lat = jwan_i2v.i2v_latent_size(image.shape[1], image.shape[2],
                                       opts.max_area)
        Pipe().generate_i2v(None, None, None, None, opts.frame_num, *lat,
                            opts)

    stub = argparse.Namespace(pipeline=Pipe(), t5=None,
                              cfg=jwan.WanConfig(text_dim=8),
                              generate_image=generate_image)
    jargs = jcli.build_parser().parse_args(argv + ["--cpu"])
    if not jargs.tiny:
        jargs.image, stub.t5 = "image.png", object()
    with mock.patch.object(jcli, "_apply_backend"), \
            mock.patch.object(jcli, "_wan_sampler", return_value=stub), \
            mock.patch("jenga_tpu.runtime.load_image",
                       return_value=np.zeros((3, 480, 832), np.float32)), \
            pytest.raises(_Captured):
        jcli.run_wan_i2v(jargs)
    assert dataclasses.asdict(opts) == dataclasses.asdict(seen["opts"])
    assert (frame_num, (lat_h, lat_w)) == (seen["frame_num"], seen["lat"])
    assert opts.shift == (3.0 if opts.max_area <= 832 * 480 else 5.0)


def _run(args, cwd):
    env = dict(os.environ, PYTHONPATH=ROOT)
    return subprocess.run([sys.executable, "-m", "jenga_tpu_torch.cli",
                           *args], capture_output=True, text=True, env=env,
                          cwd=cwd, timeout=300)


@pytest.mark.parametrize("argv,shape", [
    (["hyvideo-i2v", "--video-size", "256", "128", "--video-length", "33",
      "--infer-steps", "4"], (16, 9, 16, 32)),
    (["hyvideo-i2v", "--i2v-condition-type", "latent_concat",
      "--video-size", "256", "128", "--video-length", "33",
      "--infer-steps", "4"], (16, 9, 16, 32)),
    (["wan-i2v", "--infer-steps", "6"], (16, 3, 16, 16)),
])
def test_i2v_cli_tiny_cpu(tmp_path, argv, shape):
    """Each I2V command end to end on the CPU with --tiny: finite latents
    of the expected shape; token_replace pins the zero conditioning as
    frame 0."""
    out = tmp_path / "v.npy"
    r = _run([*argv, "--tiny", "--device", "cpu", "--latents-only",
              "--save-path", str(out)], tmp_path)
    assert r.returncode == 0, r.stderr[-2000:]
    assert "gen_time_s" in r.stdout
    lat = np.load(out)
    assert lat.shape == shape and np.isfinite(lat).all()
    assert np.abs(lat).max() > 0
    if "latent_concat" not in argv and argv[0] == "hyvideo-i2v":
        assert not lat[:, 0].any()

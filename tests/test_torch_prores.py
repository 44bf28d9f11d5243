"""ProRes and Wan Turbo in the port against the JAX package on the CPU:
the flow-match x0 revert and re-noise, the trilinear resize, the grouped
membership encoding and the membership-mode dispatch (``--no-joint-sel``),
the HunyuanVideo ProRes trajectories (Turbo, 3Stage, AccVideo) and the
Wan Turbo trajectory, each in joint and per-row selection, and the CLI."""

import dataclasses
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from jenga_tpu.diffusion import flow_match as jfm
from jenga_tpu.diffusion import unipc as junipc
from jenga_tpu.models import wan as jwan
from jenga_tpu.ops.sparse_autodiff import (
    sparse_attention_from_mask as jax_sparse)
from jenga_tpu.pipelines.hyvideo_t2v import HYT2VOptions as JaxHYOptions
from jenga_tpu.pipelines.hyvideo_t2v import HYVideoT2VPipeline as JaxHYPipe
from jenga_tpu.pipelines.wan_t2v import WanT2VOptions as JaxWanOptions
from jenga_tpu.pipelines.wan_t2v import WanT2VPipeline as JaxWanPipe
from jenga_tpu.sparse import planner as jax_planner
from jenga_tpu_torch.configs.presets import get_hy_preset, get_wan_preset
from jenga_tpu_torch.convert import wan_params_from_jax
from jenga_tpu_torch.diffusion import flow_match as tfm
from jenga_tpu_torch.diffusion.prores import trilinear_resize
from jenga_tpu_torch.models import wan as twan
from jenga_tpu_torch.ops.block_sparse_attention import (
    block_sparse_attention, block_sparse_attention_plain, lists_to_mask)
from jenga_tpu_torch.ops.attention_ref import block_sparse_attention_reference
from jenga_tpu_torch.ops.sparse_dispatch import (block_lists_from_mask,
                                                 sparse_attention_from_mask)
from jenga_tpu_torch.pipelines.hyvideo_t2v import HYVideoT2VPipeline
from jenga_tpu_torch.pipelines.wan_t2v import WanT2VPipeline

from _torch_parity import (SMALL, np_params, rel_err, t, text_inputs,
                           torch_model)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NB, TSB = 11, 9     # 9 video + 2 text blocks, as in the other slice tests

# the 2-layer dim-256 Wan of tests/test_torch_wan.py
WAN_SMALL = dict(dim=256, ffn_dim=512, num_heads=2, num_layers=2,
                 text_dim=64, text_len=32, dtype="float32")


@pytest.mark.parametrize("shift,i", [(7.0, 0), (7.0, 3), (9.0, 4),
                                     (11.0, 7)])
def test_flow_match_revert_and_renoise_match_jax(shift, i):
    rng = np.random.default_rng(0)
    x, v, noise = (rng.standard_normal((2, 3, 4, 5)).astype(np.float32)
                   for _ in range(3))
    js = jfm.flow_match_schedule(8, shift=shift)
    ts = tfm.flow_match_schedule(8, shift=shift)
    np.testing.assert_array_equal(ts.sigmas, js.sigmas)
    np.testing.assert_allclose(
        ts.predict_x0(i, t(x), t(v)).numpy(),
        js.predict_x0(i, jnp.asarray(x), jnp.asarray(v)),
        rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(
        ts.renoise_to_step(i + 1, t(x), t(noise)).numpy(),
        js.renoise_to_step(i + 1, jnp.asarray(x), jnp.asarray(noise)),
        rtol=1e-6, atol=1e-6)


# every preset's stage pairs: the test sizes (HY 256x128x33f, Wan
# 224x128x17f and 64x64x9f) and the production sizes (HY 1280x720x33f,
# Wan 832x480x81f)
@pytest.mark.parametrize("src,dst", [
    ((9, 12, 24), (9, 16, 32)),         # HY turbo/flash/accvideo, test
    ((9, 8, 16), (9, 12, 24)),          # HY 3stage, test, switch 1
    ((5, 12, 20), (5, 16, 28)),         # Wan turbo, test
    ((3, 6, 6), (3, 8, 8)),             # Wan turbo, CLI smoke
    ((9, 66, 120), (9, 90, 160)),       # HY turbo/flash/accvideo, 720p
    ((9, 44, 80), (9, 66, 120)),        # HY 3stage, 720p, switch 1
    ((21, 44, 78), (21, 60, 104)),      # Wan turbo, 480p
])
def test_trilinear_resize_matches_jax(src, dst):
    """F.interpolate(trilinear, align_corners=False) vs jax.image.resize
    on unit-normal input; both interpolate linearly between half-pixel
    centres, so only f32 rounding differs (measured <= 2e-5)."""
    x = np.random.default_rng(1).standard_normal((1, 16, *src)) \
        .astype(np.float32)
    want = np.asarray(jax.image.resize(jnp.asarray(x), (1, 16, *dst),
                                       method="trilinear"))
    got = trilinear_resize(t(x), dst).numpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=0)


def test_trilinear_resize_refuses_downsampling():
    """JAX antialiases a downsample; no preset downsamples, so the port
    refuses rather than differing."""
    with pytest.raises(ValueError):
        trilinear_resize(torch.zeros((1, 2, 3, 8, 8)), (3, 6, 8))


def _rand_mask(seed, nqb=NB, nkb=NB, h=2, density=0.4):
    rng = np.random.default_rng(seed)
    m = rng.random((1, h, nqb, nkb)) < density
    m[..., TSB:] = True
    m[:, :, TSB:] = True
    m[0, 0, 3] = False          # an empty row
    return m


@pytest.mark.parametrize("q_rows", [8, 4, 3])
def test_membership_encoding_bit_exact_with_jax(q_rows):
    """(indices, counts, members) vs JAX pack_block_lists_grouped decoded
    (ids half and membership half, tails included), bit for bit; the
    rows are padded to a q_rows multiple as grouped_attention_from_mask
    does (a padded, video/text boundary last group), and the lists with
    their words realize exactly the per-row mask."""
    mask = _rand_mask(2)
    idx, cnt, mem = block_lists_from_mask(t(mask), q_rows, joint=False)
    padded = np.pad(mask, ((0, 0), (0, 0), (0, -NB % q_rows), (0, 0)))
    packed = np.asarray(jax_planner.pack_block_lists_grouped(
        jnp.asarray(padded), q_rows))
    row = jax_planner.packed_row_size(NB)
    assert idx.dtype == cnt.dtype == mem.dtype == torch.int32
    np.testing.assert_array_equal(cnt.numpy(), packed[..., 0])
    np.testing.assert_array_equal(idx.numpy(), packed[..., 2:2 + NB])
    np.testing.assert_array_equal(mem.numpy(),
                                  packed[..., row + 2:row + 2 + NB])
    assert mem.numpy().any() and (mem.numpy() < (1 << q_rows)).all()
    np.testing.assert_array_equal(
        lists_to_mask(idx, cnt, q_rows, NB, mem).numpy(), mask)


def test_membership_encoding_refuses_wide_groups():
    with pytest.raises(ValueError):
        block_lists_from_mask(t(_rand_mask(3)), 9, joint=False)


def _qkv(seed, d=128, h=2):
    rng = np.random.default_rng(seed)
    s = NB * 128

    def one():
        base = rng.standard_normal((1, h, s, d))
        blk = np.repeat(rng.standard_normal((1, h, NB, d)) * 1.5, 128, 2)
        return (base + blk).astype(np.float32)
    return one(), one(), rng.standard_normal((1, h, s, d)).astype(np.float32)


@pytest.mark.parametrize("q_rows,amp,tail", [(8, 0.431, 40), (8, -0.5, 200),
                                             (4, 1.02, 40)])
def test_membership_dispatch_matches_jax_kernel(q_rows, amp, tail):
    """sparse_attention_from_mask(q_rows, joint=False) vs JAX's, which
    runs the grouped Pallas kernel with membership words in interpret mode
    (fixed-max epilogue, q pre-scaled for the MXU: 1e-3), with a text
    amplitude and a seqlen tail. The plain version over the membership
    lists equals the oracle over the per-row mask exactly."""
    q, k, v = _qkv(4)
    mask = _rand_mask(5)
    seq = np.array([NB * 128 - tail], np.int32)
    kw = dict(text_start_block=TSB, text_amp=amp, q_rows=q_rows,
              joint=False)
    want = np.asarray(jax_sparse(jnp.asarray(q), jnp.asarray(k),
                                 jnp.asarray(v), jnp.asarray(mask),
                                 seqlens=jnp.asarray(seq), **kw))
    got = sparse_attention_from_mask(t(q), t(k), t(v), t(mask),
                                     seqlens=t(seq), **kw)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-3, rtol=1e-3)
    assert not got[0, 0, 3 * 128:4 * 128].any()     # the empty row
    oracle = block_sparse_attention_reference(
        t(q), t(k), t(v), t(mask), text_amp=amp, text_start_block=TSB,
        seqlen=t(seq))
    assert torch.equal(got, oracle)


def test_membership_wrapper_takes_plain_version_on_cpu():
    """With members the CPU wrapper is still the plain version and counts
    no launch of either mode."""
    q, k, v = (t(x) for x in _qkv(6))
    idx, cnt, mem = block_lists_from_mask(t(_rand_mask(7)), 8, joint=False)
    sl = torch.tensor([NB * 128], dtype=torch.int32)
    before = (block_sparse_attention.launches,
              block_sparse_attention.member_launches)
    kw = dict(q_rows=8, members=mem, text_start_block=TSB, text_amp=0.3)
    a = block_sparse_attention(q, k, v, idx, cnt, sl, **kw)
    assert (block_sparse_attention.launches,
            block_sparse_attention.member_launches) == before
    assert torch.equal(a, block_sparse_attention_plain(q, k, v, idx, cnt,
                                                       sl, **kw))


# the slice config cut to one double and one single block: each JAX
# trajectory compiles every stage's forwards, and its time grows with depth
HY_PRORES = dict(SMALL, single_blocks=1)


@pytest.fixture(scope="module")
def hy_small():
    cfg, params = np_params(HY_PRORES)
    return cfg, params, torch_model(HY_PRORES, params)


@pytest.mark.parametrize("preset,steps,joint", [
    ("turbo", 6, True), ("turbo", 6, False), ("3stage", 6, True),
    ("3stage", 6, False), ("accvideo", 5, True), ("accvideo", 5, False)])
def test_hy_prores_trajectory_matches_jax(hy_small, preset, steps, joint):
    """ProRes trajectory at 256x128x33f (stage 0 at 0.75: latent (9, 12,
    24), 8 blocks; 3stage starts at 0.5: 5 blocks) from the same initial
    latents and re-noise draws, in joint q8 and --no-joint-sel mode.
    Turbo: the switch after step 3 re-shifts to 9, reverts, upsamples and
    re-noises, step 5 is skipped; 3stage switches twice (after steps 1
    and 3), step 5 is skipped; accvideo has no skip. 1e-4 relative on the final latents, as
    the Base trajectory (the forward's ~1.5e-6 compounds over the
    steps)."""
    cfg, params, model = hy_small
    opts = get_hy_preset(preset, size=(256, 128), video_length=33,
                         num_inference_steps=steps, joint_sel=joint)
    jopts = JaxHYOptions(**dataclasses.asdict(opts))
    pipe = HYVideoT2VPipeline(model)
    shapes = [lat for lat, _ in pipe._stage_shapes(opts)]
    rng = np.random.default_rng(8)
    lat0 = rng.standard_normal((16, *shapes[0])).astype(np.float32)
    noises = {si: rng.standard_normal((16, *shapes[si])).astype(np.float32)
              for si in range(1, len(shapes))}
    txt, mask, txt2 = text_inputs(HY_PRORES, seed=5)
    want = JaxHYPipe(cfg, jax.tree.map(jnp.asarray, params)).generate(
        jnp.asarray(txt), jnp.asarray(mask), jnp.asarray(txt2), jopts,
        decode=False, initial_latents=lat0, stage_noises=noises)
    steps_seen = []
    got = pipe.generate(txt, mask, txt2, opts, initial_latents=lat0,
                        stage_noises=noises,
                        on_step=lambda i, lat: steps_seen.append(
                            tuple(lat.shape)))
    assert len(steps_seen) == steps
    assert steps_seen[-1] == (16, 9, 16, 32) != steps_seen[0]
    assert got.shape == (16, 9, 16, 32)
    err = rel_err(got.numpy(), want)
    print(f"{preset} joint={joint} trajectory rel err {err:.3e}")
    assert err < 1e-4


@pytest.fixture(scope="module")
def wan_small():
    cfg = jwan.WanConfig(**WAN_SMALL)
    params = jax.tree.map(np.asarray,
                          jwan.init_wan_params(jax.random.PRNGKey(0), cfg))
    w = params["head"]["linear"]["w"]
    params["head"]["linear"]["w"] = (np.random.default_rng(100)
                                     .standard_normal(w.shape) * 0.05
                                     ).astype(w.dtype)
    model = twan.WanDiT(twan.WanConfig(**WAN_SMALL))
    model.load_state_dict(wan_params_from_jax(params), strict=True)
    return cfg, params, model


@pytest.mark.parametrize("joint", [True, False])
def test_wan_turbo_trajectory_matches_jax(wan_small, joint):
    """6-step 1.3b-turbo trajectory at 224x128x17f with the switch after
    step 2: stage 0 at latent (5, 12, 20) (3 blocks), stage 1 at (5, 16,
    28) (5 blocks). The host plan must equal JAX's TeaCache schedule over
    the realized timesteps (stage start forced) and its skip rule (no skip
    before a computed step of the new stage); the final latents from the
    same initial latents and stage2_noise agree to 1e-4 relative."""
    cfg, params, model = wan_small
    opts = get_wan_preset("1.3b-turbo", size=(224, 128), frame_num=17,
                          sampling_steps=6, turbo_switch_step=2,
                          joint_sel=joint)
    jopts = JaxWanOptions(**dataclasses.asdict(opts))
    pipe = WanT2VPipeline(model)
    kinds = pipe.step_plan(opts)
    jpipe = JaxWanPipe(cfg, jax.tree.map(jnp.asarray, params))
    s1 = junipc.unipc_schedule(6, shift=opts.shift)
    s2 = junipc.unipc_schedule(6, shift=opts.shift + 2)
    realized = np.array([(s2 if i > 2 else s1).timestep(i)
                         for i in range(6)])
    jcompute = jpipe._teacache_schedule(realized, jopts, {3})
    jkinds, residual = [], False
    for i, c in enumerate(jcompute):
        jkinds.append("skip" if not c and residual else "computed")
        residual = i != 2   # the switch after step 2 drops the residual
    assert [k if k == "skip" else "computed" for k in kinds] == jkinds
    assert kinds[0] == "dense" and kinds[3] == "carved"
    assert "carved" in kinds[:3]

    rng = np.random.default_rng(9)
    lat0 = rng.standard_normal((16, 5, 12, 20)).astype(np.float32)
    noise2 = rng.standard_normal((16, 5, 16, 28)).astype(np.float32)
    ctx = rng.standard_normal((20, WAN_SMALL["text_dim"])).astype(np.float32)
    null = np.zeros((10, WAN_SMALL["text_dim"]), np.float32)
    want = jpipe.generate(jnp.asarray(ctx), jnp.asarray(null), jopts,
                          decode=False, initial_latents=lat0,
                          stage2_noise=noise2)
    got = pipe.generate(ctx, null, opts, initial_latents=lat0,
                        stage2_noise=noise2)
    assert got.shape == (16, 5, 16, 28)
    err = rel_err(got.numpy(), want)
    print(f"wan turbo joint={joint} kinds {kinds} rel err {err:.3e}")
    assert err < 1e-4


def _run(args, cwd):
    env = dict(os.environ, PYTHONPATH=ROOT)
    return subprocess.run([sys.executable, "-m", "jenga_tpu_torch.cli",
                           *args], capture_output=True, text=True, env=env,
                          cwd=cwd, timeout=300)


@pytest.mark.parametrize("args,shape", [
    (["hyvideo-t2v", "--preset", "turbo", "--no-joint-sel"],
     (16, 9, 16, 32)),
    (["hyvideo-t2v", "--preset", "flash"], (16, 9, 16, 32)),
    (["hyvideo-t2v", "--preset", "3stage"], (16, 9, 16, 32)),
    (["hyvideo-t2v", "--preset", "accvideo", "--no-joint-sel"],
     (16, 9, 16, 32)),
    (["wan-t2v", "--preset", "1.3b-turbo", "--no-joint-sel"],
     (16, 3, 8, 8))])
def test_cli_prores_presets_tiny_cpu(tmp_path, args, shape):
    """Every ProRes preset end to end through the CLI on the CPU (tiny
    model; HY at 256x128x33f for 8 steps, Wan at 64x64x9f for the
    preset's 50 steps across its switch at 25)."""
    size = (["--video-size", "256", "128", "--video-length", "33",
             "--infer-steps", "8"] if args[0] == "hyvideo-t2v" else
            ["--video-size", "64", "64", "--video-length", "9"])
    out = tmp_path / "v.npy"
    r = _run([*args, "--tiny", "--device", "cpu", "--latents-only", *size,
              "--save-path", str(out)], tmp_path)
    assert r.returncode == 0, r.stderr[-2000:]
    lat = np.load(out)
    assert lat.shape == shape and np.isfinite(lat).all() and lat.any()


@pytest.mark.parametrize("cmd", ["hyvideo-t2v", "wan-t2v"])
def test_cli_rejects_wide_groups_without_joint_selection(tmp_path, cmd):
    """--q-group > 8 with --no-joint-sel: membership words cover 8 rows,
    so the pipeline build refuses it, as in the JAX CLI."""
    r = _run([cmd, "--q-group", "12", "--no-joint-sel", "--tiny",
              "--device", "cpu", "--latents-only", "--infer-steps", "2",
              "--video-size", "64", "64", "--video-length", "9",
              "--save-path", str(tmp_path / "v.npy")], tmp_path)
    assert r.returncode != 0
    assert "requires joint selection" in r.stderr

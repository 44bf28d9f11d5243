"""The Wan2.1 T2V slice of the port against the JAX package on the CPU:
the param bridge and random init, a carved forward (joint q8 with
first-frame forcing and a ragged last group) and the dense fallback, both
with a pad tail, UniPC against ``jenga_tpu.diffusion.unipc``, a 6-step
Base trajectory through a dense warm-up step, carved steps and a TeaCache
skip, and the CLI and import hygiene."""

import dataclasses
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from jenga_tpu.curves.blocks import build_curve_plan
from jenga_tpu.diffusion import unipc as junipc
from jenga_tpu.models import wan as jwan
from jenga_tpu.diffusion.skip import TEACACHE_COEFFS as JAX_TEACACHE_COEFFS
from jenga_tpu.pipelines.wan_t2v import WanT2VOptions as JaxOptions
from jenga_tpu.pipelines.wan_t2v import WanT2VPipeline as JaxPipeline
from jenga_tpu_torch.configs.presets import get_wan_preset
from jenga_tpu_torch.convert import wan_params_from_jax
from jenga_tpu_torch.diffusion import unipc as tunipc
from jenga_tpu_torch.models import wan as twan
from jenga_tpu_torch.pipelines.wan_t2v import WanT2VPipeline

from _torch_parity import rel_err, t

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# a full Wan block stack at small width and depth, head dim 128 as in the
# published configs, in f32 so the comparison tests the algorithm
SMALL = dict(dim=256, ffn_dim=512, num_heads=2, num_layers=2, text_dim=64,
             text_len=32, dtype="float32")
# latent (16, 5, 48, 48) -> token grid (5, 24, 24) = 2880 tokens: 23 blocks
# with a 64-token pad tail, first_frame_blocks = 23 // 21 = 1, and joint q8
# groups {0-7}, {8-15}, {16-22}, the last ragged
GRID = (5, 24, 24)
LATENT = (16, 5, 48, 48)


def _np_params(cfg_kwargs, seed=0, perturb=True):
    """JAX init as a numpy tree; the zero-init head is perturbed (else
    every velocity is 0)."""
    cfg = jwan.WanConfig(**cfg_kwargs)
    params = jax.tree.map(np.asarray,
                          jwan.init_wan_params(jax.random.PRNGKey(seed), cfg))
    if perturb:
        w = params["head"]["linear"]["w"]
        rng = np.random.default_rng(seed + 100)
        params["head"]["linear"]["w"] = (
            rng.standard_normal(w.shape) * 0.05).astype(w.dtype)
    return cfg, params


@pytest.fixture(scope="module")
def small():
    cfg, params = _np_params(SMALL)
    model = twan.WanDiT(twan.WanConfig(**SMALL))
    model.load_state_dict(wan_params_from_jax(params), strict=True)
    return cfg, params, model


def test_bridge_shapes_and_values():
    """Every non-None leaf arrives under its tree path (``head`` as
    ``head_layer``) with its dtype and values; linear weights transposed."""
    kw = dict(SMALL, dtype="bfloat16")
    _, params = _np_params(kw, perturb=False)
    sd = wan_params_from_jax(params)
    flat = jax.tree_util.tree_flatten_with_path(params)[0]
    assert len(sd) == len(flat)
    for path, leaf in flat:
        keys = [str(getattr(p, "key", getattr(p, "idx", p))) for p in path]
        if keys[0] == "head":
            keys[0] = "head_layer"
        name = ".".join(keys)
        got = sd[name]
        assert str(got.dtype).split(".")[-1] == np.asarray(leaf).dtype.name
        want = np.asarray(leaf, np.float32)
        if name.endswith(".w") and want.ndim == 2:
            want = want.T
        np.testing.assert_array_equal(got.float().numpy(), want, name)
    assert sd["blocks.1.modulation"].dtype == torch.float32
    assert sd["blocks.1.self_attn.q.w"].dtype == torch.bfloat16
    model = twan.WanDiT(twan.WanConfig(**kw))
    model.load_state_dict(sd, strict=True)


def test_random_init_follows_jax_distribution():
    """Device init: same zero/one/uniform/normal layout as init_wan_params."""
    model = twan.WanDiT(twan.WanConfig(**SMALL))
    twan.init_wan_(model, torch.Generator().manual_seed(0))
    _, params = _np_params(SMALL, perturb=False)
    sd = wan_params_from_jax(params)
    for name, p in model.state_dict().items():
        ref = sd[name]
        if not ref.any():
            assert not p.any(), name
        elif bool((ref == 1).all()):
            assert bool((p == 1).all()), name
        else:
            assert float(p.abs().max()) <= float(ref.abs().max()) * 1.5, name
            assert 0.7 < float(p.std()) / float(ref.std()) < 1.3, name


def _carves(cfg, drop, p_remain=0.3):
    plan = build_curve_plan(GRID, "sliced", 128)
    jc = jwan.make_wan_carve(cfg, plan, drop, p_remain, q_rows=8,
                             joint_sel=True)
    tc = twan.make_wan_carve(twan.WanConfig(**SMALL), GRID, drop, p_remain,
                             curve="sliced", q_rows=8, joint_sel=True)
    assert tc.first_frame_blocks == jc.first_frame_blocks == 1
    assert tc.seqlen == jc.seqlen == 2880
    return jc, tc


@pytest.mark.parametrize("drop", [0.75, 0.0])
def test_forward_matches_jax(small, drop):
    """Full forward, carved (joint q8, first-frame forcing, ragged last
    group, pad tail masked by seqlen) and the dense fallback (pad tail
    attended), vs wan_forward. f32; 1e-5 relative covers the JAX kernels'
    fixed-max epilogue and summation order (measured ~1.6e-6)."""
    cfg, params, model = small
    rng = np.random.default_rng(3)
    x = rng.standard_normal((1, *LATENT)).astype(np.float32)
    tt = np.array([900.0], np.float32)
    ctx = np.zeros((1, SMALL["text_len"], SMALL["text_dim"]), np.float32)
    ctx[:, :20] = rng.standard_normal((1, 20, SMALL["text_dim"]))
    jc, tc = _carves(cfg, drop)
    want = jwan.wan_forward(jax.tree.map(jnp.asarray, params), cfg,
                            jnp.asarray(x), jnp.asarray(tt),
                            jnp.asarray(ctx), carve=jc)
    with torch.inference_mode():
        got = model(t(x), t(tt), t(ctx), carve=tc)
    assert got.shape == want.shape == (1, *LATENT)
    err = rel_err(got.numpy(), want)
    print(f"forward rel err {err:.3e}")
    assert err < 1e-5


@pytest.mark.parametrize("solver_type,order,disable", [
    ("bh2", 2, ()), ("bh1", 2, ()), ("bh2", 3, ()), ("bh2", 2, (3, 4))])
def test_unipc_matches_jax(solver_type, order, disable):
    """A 10-step trajectory with fixed seeded velocities through predictor
    and corrector, port vs JAX; the host coefficients are the same f64
    numpy, the device combination f32 (1e-6 relative)."""
    rng = np.random.default_rng(11)
    vel = rng.standard_normal((10, 2, 3, 4, 5)).astype(np.float32)
    x0 = rng.standard_normal((2, 3, 4, 5)).astype(np.float32)
    kw = dict(shift=8.0, solver_order=order, solver_type=solver_type)
    js, ts = junipc.unipc_schedule(10, **kw), tunipc.unipc_schedule(10, **kw)
    np.testing.assert_array_equal(ts.sigmas, js.sigmas)
    assert [ts.timestep(i) for i in range(10)] == \
        [js.timestep(i) for i in range(10)]
    jst = junipc.unipc_init(js, disable_corrector=disable)
    tst = tunipc.unipc_init(ts, disable_corrector=disable)
    jx, tx = jnp.asarray(x0), t(x0)
    for i in range(10):
        jst, jx = junipc.unipc_step(js, jst, jnp.asarray(vel[i]), jx)
        tst, tx = tunipc.unipc_step(ts, tst, t(vel[i]), tx)
        assert tst.this_order == jst.this_order
        assert rel_err(tx.numpy(), jx) < 1e-6, i
    np.testing.assert_allclose(
        tunipc.unipc_add_noise(ts, 4, t(x0), t(vel[0])).numpy(),
        junipc.unipc_add_noise(js, 4, jnp.asarray(x0), jnp.asarray(vel[0])),
        rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(
        tunipc.unipc_step_to_zero(ts, 4, t(vel[0]), t(x0)).numpy(),
        junipc.unipc_step_to_zero(js, 4, jnp.asarray(vel[0]),
                                  jnp.asarray(x0)), rtol=1e-6, atol=1e-6)


def test_trajectory_matches_jax(small):
    """6-step 1.3b-base trajectory (joint q8) at 224x128x17f (5 blocks, an
    80-token pad tail) from the same initial latents: step 0 is the dense
    warm-up, steps 1-4 carved, step 5 a TeaCache skip on the cached
    residual. The schedule must equal JAX's exactly; 1e-4 relative on the
    final latents (the forward's ~1.6e-6 compounds over 6 UniPC steps;
    measured ~1.4e-6)."""
    cfg, params, model = small
    opts = get_wan_preset("1.3b-base", size=(224, 128), frame_num=17,
                          sampling_steps=6)
    jopts = JaxOptions(**dataclasses.asdict(opts))
    pipe = WanT2VPipeline(model)
    kinds = pipe.step_plan(opts)
    assert kinds == ["dense"] + ["carved"] * 4 + ["skip"]

    jpipe = JaxPipeline(cfg, jax.tree.map(jnp.asarray, params))
    sched = junipc.unipc_schedule(6, shift=opts.shift)
    jcompute = jpipe._teacache_schedule(
        np.array([sched.timestep(i) for i in range(6)]), jopts, set())
    assert [k != "skip" for k in kinds] == list(jcompute)

    rng = np.random.default_rng(6)
    lat0 = rng.standard_normal((16, 5, 16, 28)).astype(np.float32)
    ctx = rng.standard_normal((20, SMALL["text_dim"])).astype(np.float32)
    null = np.zeros((10, SMALL["text_dim"]), np.float32)
    want = jpipe.generate(jnp.asarray(ctx), jnp.asarray(null), jopts,
                          decode=False, initial_latents=lat0)
    steps = []
    got = pipe.generate(ctx, null, opts, initial_latents=lat0,
                        on_step=lambda i, lat: steps.append(i))
    assert steps == list(range(6))
    err = rel_err(got.numpy(), want)
    print(f"trajectory rel err {err:.3e}")
    assert err < 1e-4


@pytest.mark.parametrize("key", sorted(JAX_TEACACHE_COEFFS))
def test_teacache_schedule_keyed_by_model_id(small, key):
    """Each (model_id, use_ret_steps) key of TEACACHE_COEFFS: the pipeline
    built with that model_id takes that polynomial, and its 50-step skip
    schedule over the realized timesteps equals the JAX pipeline's with
    the same model_id (an unknown id falls back to the 1.3B polynomial in
    both)."""
    cfg, params, model = small
    model_id, ret = key
    opts = get_wan_preset("1.3b-base", use_ret_steps=ret, shift=5.0)
    pipe = WanT2VPipeline(model, model_id=model_id)
    assert pipe.teacache_coeffs(ret) == JAX_TEACACHE_COEFFS[key]
    assert WanT2VPipeline(model, model_id="unknown").teacache_coeffs(ret) \
        == JAX_TEACACHE_COEFFS[("wan-t2v-1.3b", ret)]
    sched = junipc.unipc_schedule(50, shift=opts.shift)
    ts = np.array([sched.timestep(i) for i in range(50)])
    jpipe = JaxPipeline(cfg, jax.tree.map(jnp.asarray, params),
                        model_id=model_id)
    want = jpipe._teacache_schedule(
        ts, JaxOptions(**dataclasses.asdict(opts)), set())
    got = pipe._teacache_compute(ts, opts)
    print(f"{key}: {int(got.sum())} of 50 computed")
    np.testing.assert_array_equal(got, want)


def _run(args, cwd=None):
    env = dict(os.environ, PYTHONPATH=ROOT)
    return subprocess.run([sys.executable, *args], capture_output=True,
                          text=True, env=env, cwd=cwd or ROOT, timeout=300)


def test_cli_tiny_cpu(tmp_path):
    out = tmp_path / "v.npy"
    r = _run(["-m", "jenga_tpu_torch.cli", "wan-t2v", "--tiny", "--device",
              "cpu", "--latents-only", "--infer-steps", "6", "--video-size",
              "64", "64", "--video-length", "9", "--save-path", str(out)],
             tmp_path)
    assert r.returncode == 0, r.stderr[-2000:]
    assert "gen_time_s" in r.stdout
    lat = np.load(out)
    assert lat.shape == (16, 3, 8, 8) and np.isfinite(lat).all()


def test_cli_tiny_cpu_14b_preset(tmp_path):
    """``--preset 14b-base`` runs (its size, drop rates and p_remain on the
    tiny model); the full-width command builds WAN_T2V_14B with model_id
    wan-t2v-14b through WanSampler.from_task."""
    from jenga_tpu_torch.runtime import WanSampler
    assert WanSampler.CONFIGS["t2v-14B"] == twan.WAN_T2V_14B
    assert WanSampler.MODEL_IDS == {"t2v-1.3B": "wan-t2v-1.3b",
                                    "t2v-14B": "wan-t2v-14b",
                                    "i2v-14B": "wan-i2v-720p"}
    out = tmp_path / "v.npy"
    r = _run(["-m", "jenga_tpu_torch.cli", "wan-t2v", "--tiny", "--device",
              "cpu", "--preset", "14b-base", "--latents-only",
              "--infer-steps", "6", "--video-size", "64", "64",
              "--video-length", "9", "--save-path", str(out)], tmp_path)
    assert r.returncode == 0, r.stderr[-2000:]
    lat = np.load(out)
    assert lat.shape == (16, 3, 8, 8) and np.isfinite(lat).all()


def test_wan_modules_import_no_jax():
    r = _run(["-c", "import sys; import jenga_tpu_torch.cli, "
              "jenga_tpu_torch.runtime, jenga_tpu_torch.pipelines.wan_t2v, "
              "jenga_tpu_torch.pipelines.wan_i2v, "
              "jenga_tpu_torch.pipelines.hyvideo_i2v, "
              "jenga_tpu_torch.models.wan, jenga_tpu_torch.diffusion.unipc; "
              "assert 'jax' not in sys.modules, 'jax imported'; print('ok')"])
    assert r.returncode == 0 and "ok" in r.stdout, r.stderr[-2000:]

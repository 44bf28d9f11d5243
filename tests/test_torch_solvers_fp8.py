"""DPM-Solver++ and fp8 weight storage of the port against the JAX package
on the CPU: the dpm++ schedule (both grids) and its steps against
``jenga_tpu.diffusion.dpm``; Wan T2V Base and Turbo, and Wan-I2V,
trajectories under dpm++; the e4m3 bytes of ``quantize_linear_fp8``, the
set of layers ``quantize_tree_fp8`` takes, the bridge of a quantized JAX
tree, and the HunyuanVideo and Wan forwards with fp8 weights against
JAX's ``quantize_tree_fp8`` and ``linear``."""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from jenga_tpu.diffusion import dpm as jdpm
from jenga_tpu.models import fp8 as jfp8
from jenga_tpu.models import hyvideo as jhy
from jenga_tpu.models import wan as jwan
from jenga_tpu.pipelines import wan_i2v as jwan_i2v
from jenga_tpu.pipelines.wan_t2v import WanT2VOptions as JaxOptions
from jenga_tpu.pipelines.wan_t2v import WanT2VPipeline as JaxPipeline
from jenga_tpu_torch.configs.presets import get_wan_i2v_options, get_wan_preset
from jenga_tpu_torch.convert import hyvideo_params_from_jax, wan_params_from_jax
from jenga_tpu_torch.diffusion import dpm as tdpm
from jenga_tpu_torch.models import fp8 as tfp8
from jenga_tpu_torch.models import wan as twan
from jenga_tpu_torch.models.layers import Affine, linear
from jenga_tpu_torch.pipelines import wan_i2v as twan_i2v
from jenga_tpu_torch.pipelines.wan_t2v import WanT2VPipeline

from _torch_parity import SMALL, rel_err, t, text_inputs, torch_model

# the dim-256 Wan of tests/test_torch_wan.py at one layer, T2V and I2V
WAN_SMALL = dict(dim=256, ffn_dim=512, num_heads=2, num_layers=1,
                 text_dim=64, text_len=32, dtype="float32")
WAN_I2V_SMALL = dict(WAN_SMALL, model_type="i2v", in_dim=36)


def _wan_np_params(kw, seed=0):
    """JAX init (jitted: op by op it takes seconds) as numpy, the
    zero-init head perturbed."""
    cfg = jwan.WanConfig(**kw)
    params = jax.tree.map(np.asarray, jax.jit(
        jwan.init_wan_params, static_argnums=1)(jax.random.PRNGKey(seed),
                                                cfg))
    w = params["head"]["linear"]["w"]
    params["head"]["linear"]["w"] = (np.random.default_rng(seed + 100)
                                     .standard_normal(w.shape) * 0.05
                                     ).astype(w.dtype)
    return cfg, params


def _wan_model(kw, params):
    model = twan.WanDiT(twan.WanConfig(**kw))
    model.load_state_dict(wan_params_from_jax(params), strict=True)
    return model


@pytest.fixture(scope="module")
def wan():
    cfg, params = _wan_np_params(WAN_SMALL)
    return cfg, params, _wan_model(WAN_SMALL, params)


# ------------------------------------------------------------------ dpm++

@pytest.mark.parametrize("grid,shift,n", [("sampling", 8.0, 12),
                                          ("train", 5.0, 12),
                                          ("sampling", 1.0, 7)])
def test_dpm_schedule_matches_jax(grid, shift, n):
    """The f64 sigma table, the floored ``timesteps`` and the truncated
    ``timestep(i)`` equal JAX's exactly on both grids; "sampling" starts at
    sigma 1.0, "train" at 1 - 1/1000 before the shift."""
    js = jdpm.dpm_schedule(n, shift=shift, grid=grid)
    ts = tdpm.dpm_schedule(n, shift=shift, grid=grid)
    np.testing.assert_array_equal(ts.sigmas, js.sigmas)
    np.testing.assert_array_equal(ts.timesteps, js.timesteps)
    assert [ts.timestep(i) for i in range(n)] == \
        [js.timestep(i) for i in range(n)]
    m = 1.0 if grid == "sampling" else 0.999
    assert ts.sigmas[0] == shift * m / (1.0 + (shift - 1.0) * m)
    assert ts.sigmas[-1] == 0.0 and ts.num_steps == n
    with pytest.raises(ValueError):
        tdpm.dpm_schedule(n, grid="other")


@pytest.mark.parametrize("grid,order,start", [
    ("sampling", 2, 0), ("train", 2, 0), ("sampling", 1, 0),
    ("sampling", 2, 5)])
def test_dpm_steps_match_jax(grid, order, start):
    """12 steps (from ``start``, a fresh state as at the Turbo switch) with
    fixed seeded velocities, port vs JAX: the host coefficients are the
    same f64 numpy, the device combination f32 (1e-6 relative). The last
    step lands on sigma 0 (lambda +inf) and returns the x0 prediction,
    finite."""
    rng = np.random.default_rng(11)
    vel = rng.standard_normal((12, 2, 3, 4, 5)).astype(np.float32)
    x0 = rng.standard_normal((2, 3, 4, 5)).astype(np.float32)
    kw = dict(shift=8.0, solver_order=order, grid=grid)
    js, ts = jdpm.dpm_schedule(12, **kw), tdpm.dpm_schedule(12, **kw)
    jst = dataclasses.replace(jdpm.dpm_init(js), step_index=start)
    tst = dataclasses.replace(tdpm.dpm_init(ts), step_index=start)
    jx, tx = jnp.asarray(x0), t(x0)
    for i in range(start, 12):
        jst, jx = jdpm.dpm_step(js, jst, jnp.asarray(vel[i]), jx)
        tst, tx = tdpm.dpm_step(ts, tst, t(vel[i]), tx)
        assert (tst.step_index, tst.lower_order_nums) == \
            (jst.step_index, jst.lower_order_nums)
        assert rel_err(tx.numpy(), jx) < 1e-6, i
    assert torch.isfinite(tx).all()
    for fn in ("dpm_add_noise", "dpm_step_to_zero"):
        np.testing.assert_allclose(
            getattr(tdpm, fn)(ts, 4, t(x0), t(vel[0])).numpy(),
            getattr(jdpm, fn)(js, 4, jnp.asarray(x0), jnp.asarray(vel[0])),
            rtol=1e-6, atol=1e-6)


def test_wan_dpm_base_trajectory_matches_jax(wan):
    """6-step 1.3b-base trajectory under dpm++ (joint q8) at 224x128x17f:
    the host plan over dpm++'s own timesteps equals JAX's TeaCache
    schedule, with a dense warm-up, carved steps and a skip; 1e-4
    relative on the final latents from the same initial latents."""
    cfg, params, model = wan
    opts = get_wan_preset("1.3b-base", size=(224, 128), frame_num=17,
                          sampling_steps=6, solver="dpm++")
    jopts = JaxOptions(**dataclasses.asdict(opts))
    pipe = WanT2VPipeline(model)
    kinds = pipe.step_plan(opts)
    jpipe = JaxPipeline(cfg, jax.tree.map(jnp.asarray, params))
    sched = jdpm.dpm_schedule(6, shift=opts.shift)
    jcompute = jpipe._teacache_schedule(
        np.array([sched.timestep(i) for i in range(6)]), jopts, set())
    assert [k != "skip" for k in kinds] == list(jcompute)
    assert {"dense", "carved", "skip"} <= set(kinds), kinds

    rng = np.random.default_rng(6)
    lat0 = rng.standard_normal((16, 5, 16, 28)).astype(np.float32)
    ctx = rng.standard_normal((20, WAN_SMALL["text_dim"])).astype(np.float32)
    null = np.zeros((10, WAN_SMALL["text_dim"]), np.float32)
    want = jpipe.generate(jnp.asarray(ctx), jnp.asarray(null), jopts,
                          decode=False, initial_latents=lat0)
    got = pipe.generate(ctx, null, opts, initial_latents=lat0)
    err = rel_err(got.numpy(), want)
    print(f"wan dpm++ base {kinds} rel err {err:.3e}")
    assert err < 1e-4


def test_wan_dpm_turbo_trajectory_matches_jax(wan):
    """6-step 1.3b-turbo trajectory under dpm++ with the switch after step
    2: stage 0 at latent (5, 12, 20), then a fresh dpm++ state (no model
    outputs, first order) at step index 3 on the schedule shifted by 2.
    The plan equals JAX's over the realized timesteps; 1e-4 relative on
    the final latents from the same initial latents and stage-2 noise.
    The drop rates are 0 (dense steps): the solver's path is the same, and
    JAX's interpret-mode kernel would cost ~10 s here (the carved dpm++
    steps are the Base test's)."""
    cfg, params, model = wan
    opts = get_wan_preset("1.3b-turbo", size=(224, 128), frame_num=17,
                          sampling_steps=6, turbo_switch_step=2,
                          sa_drop_rates=(0.0, 0.0), solver="dpm++")
    jopts = JaxOptions(**dataclasses.asdict(opts))
    pipe = WanT2VPipeline(model)
    kinds = pipe.step_plan(opts)
    jpipe = JaxPipeline(cfg, jax.tree.map(jnp.asarray, params))
    s1 = jdpm.dpm_schedule(6, shift=opts.shift)
    s2 = jdpm.dpm_schedule(6, shift=opts.shift + 2)
    realized = np.array([(s2 if i > 2 else s1).timestep(i)
                         for i in range(6)])
    jcompute = jpipe._teacache_schedule(realized, jopts, {3})
    assert [k != "skip" for k in kinds] == list(jcompute)
    assert kinds[3] == "dense"

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
    print(f"wan dpm++ turbo {kinds} rel err {err:.3e}")
    assert err < 1e-4


def test_wan_i2v_dpm_trajectory_matches_jax():
    """6-step Wan-I2V trajectory with ``WanI2VOptions(solver="dpm++")`` at
    the CLI's 480p-class options (the ``wan-i2v`` command has no solver
    flag in either package), from the JAX draw; 1e-4 relative. Dense
    steps, as in the Turbo test (carved I2V steps are held in
    tests/test_torch_i2v.py)."""
    cfg, params = _wan_np_params(WAN_I2V_SMALL)
    model = _wan_model(WAN_I2V_SMALL, params)
    frames, lat = 17, (16, 28)
    opts = get_wan_i2v_options(832 * 480, sampling_steps=6, frame_num=frames,
                               seed=4, sa_drop_rates=(0.0, 0.0),
                               solver="dpm++")
    jopts = jwan_i2v.WanI2VOptions(**dataclasses.asdict(opts))
    pipe = twan_i2v.WanI2VPipeline(model, model_id="wan-t2v-1.3b")
    jpipe = jwan_i2v.WanI2VPipeline(cfg, jax.tree.map(jnp.asarray, params),
                                    model_id="wan-t2v-1.3b")
    rng = np.random.default_rng(9)
    t_lat = (frames - 1) // 4 + 1
    img_lat = np.zeros((16, t_lat, *lat), np.float32)
    img_lat[:, 0] = rng.standard_normal((16, *lat))
    clip = rng.standard_normal((257, 1280)).astype(np.float32)
    ctx = rng.standard_normal((20, WAN_SMALL["text_dim"])).astype(np.float32)
    null = np.zeros((10, WAN_SMALL["text_dim"]), np.float32)
    want = jpipe.generate_i2v(jnp.asarray(img_lat), jnp.asarray(clip),
                              jnp.asarray(ctx), jnp.asarray(null), frames,
                              *lat, jopts, decode=False)
    lat0 = np.array(jax.random.normal(jax.random.PRNGKey(opts.seed),
                                      (1, 16, t_lat, *lat)))[0]
    got = pipe.generate_i2v(img_lat, clip, ctx, null, frames, *lat, opts,
                            initial_latents=lat0)
    err = rel_err(got.numpy(), want)
    print(f"wan i2v dpm++ {pipe.step_plan(opts)} rel err {err:.3e}")
    assert err < 1e-4


def test_unknown_solver_raises(wan):
    opts = get_wan_preset("1.3b-base", size=(64, 64), frame_num=9,
                          sampling_steps=4, solver="euler")
    with pytest.raises(ValueError, match="unknown solver"):
        WanT2VPipeline(wan[2]).step_plan(opts)


# -------------------------------------------------------------------- fp8

@pytest.mark.parametrize("dtype,shape", [
    (np.float32, (300, 500)), ("bfloat16", (256, 768)),
    (np.float32, (4, 4))])
def test_fp8_bytes_match_jax(dtype, shape):
    """The e4m3 bytes and the f32 scale of one weight, port vs JAX, bit
    for bit (a value at max|w| among them), and the bf16 dequant
    ``linear`` computes."""
    rng = np.random.default_rng(2)
    w = (rng.standard_normal(shape) * 0.05).astype(np.float32)
    w.flat[7] = -3.0 * np.abs(w).max()
    jw = jnp.asarray(w, jnp.bfloat16 if dtype == "bfloat16" else w.dtype)
    jq = jfp8.quantize_linear_fp8({"w": jw})
    tw = torch.as_tensor(np.array(jw.astype(jnp.float32)))
    if dtype == "bfloat16":
        tw = tw.to(torch.bfloat16)
    w8, scale = tfp8.quantize_linear_fp8(tw)
    assert w8.dtype == torch.float8_e4m3fn and scale.dtype == torch.float32
    np.testing.assert_array_equal(w8.view(torch.uint8).numpy(),
                                  np.asarray(jq["w8"]).view(np.uint8))
    assert scale.item() == float(jq["scale"])
    want = np.asarray((jq["w8"].astype(jnp.bfloat16)
                       * jq["scale"].astype(jnp.bfloat16))
                      .astype(jnp.float32))
    got = (w8.to(torch.bfloat16) * scale.to(torch.bfloat16)).float()
    np.testing.assert_array_equal(got.numpy(), want)


def _w8_names(state_dict):
    return sorted(n[:-len(".w8")] for n in state_dict if n.endswith(".w8"))


@pytest.mark.parametrize("model", ["hyvideo", "wan"])
def test_fp8_quantized_names_match_jax(hy, wan, model):
    """``quantize_tree_fp8`` at its default 2^16 takes the same layers,
    name for name, as JAX's on the same tree (at SMALL width some linears
    fall under the threshold and stay), and the bridge of JAX's quantized
    tree loads strictly into the quantized port module with every byte
    kept."""
    if model == "hyvideo":
        params = hy[1]
        mod = torch_model(SMALL, params)
        convert = hyvideo_params_from_jax
    else:
        params = wan[1]
        mod = _wan_model(WAN_SMALL, params)
        convert = wan_params_from_jax
    jq = jax.tree.map(np.asarray, jax.jit(jfp8.quantize_tree_fp8)(params))
    sd = convert(jq)
    got = sorted(tfp8.quantize_tree_fp8(mod))
    assert got == _w8_names(sd) and got
    kept = [n for n, m in mod.named_modules()
            if isinstance(m, Affine) and m.w is not None]
    assert kept, "some linears stay unquantized at SMALL width"
    mod.load_state_dict(sd, strict=True)
    for name in got[:3]:
        np.testing.assert_array_equal(
            mod.get_submodule(name).w8.view(torch.uint8).numpy(),
            sd[f"{name}.w8"].view(torch.uint8).numpy())


def test_fp8_dequantize_restores_linear():
    """``dequantize_tree_fp8`` gives each layer back a weight in its own
    dtype that computes what the fp8 layer did, bit for bit."""
    torch.manual_seed(0)
    mod = Affine(384, 256, torch.float32, "cpu")
    mod.w.normal_()
    mod.b.normal_()
    x = torch.randn(5, 384)
    assert tfp8.quantize_tree_fp8(mod, min_size=1) == [""]
    y8 = linear(mod, x)
    tfp8.dequantize_tree_fp8(mod)
    assert mod.w8 is None and mod.w.dtype == torch.float32
    torch.testing.assert_close(linear(mod, x), y8, rtol=0, atol=0)


def _jit_exact(fn, cfg, params, *args):
    """``fn(params, cfg, *args)`` jitted with XLA's excess precision off:
    by default XLA may skip the bf16 rounding of the dequant product
    ``w8.astype(bf16) * scale.astype(bf16)`` that the JAX ``linear``
    writes (and op-by-op JAX performs), which moves the output by ~2e-3
    here; the port rounds as the source says."""
    lowered = jax.jit(fn, static_argnums=1).lower(params, cfg, *args)
    return np.asarray(lowered.compile(compiler_options={
        "xla_allow_excess_precision": False})(params, *args))


@pytest.fixture(scope="module")
def hy():
    """The HunyuanVideo slice config's JAX init (jitted) as numpy, heads
    perturbed as in ``_torch_parity.np_params``."""
    cfg = jhy.HYVideoConfig(**SMALL)
    params = jax.tree.map(np.asarray, jax.jit(
        jhy.init_hyvideo_params, static_argnums=1)(jax.random.PRNGKey(0),
                                                   cfg))
    rng = np.random.default_rng(100)
    for lin in [params["final_layer"]["linear"],
                params["final_layer"]["adaLN"]] + [
            blk["adaLN"] for blk in params["txt_in"]["blocks"]]:
        lin["w"] = (rng.standard_normal(lin["w"].shape) * 0.05).astype(
            lin["w"].dtype)
    return cfg, params


def test_hyvideo_fp8_forward_matches_jax(hy):
    """The dense HunyuanVideo forward of the slice config with fp8 weights
    (every linear of at least 2^12 elements): port (quantized in place) vs
    JAX (``quantize_tree_fp8`` and its ``linear``), f32 activations with
    the bf16-rounded dequant; 1e-4 relative. The fp8 weights move the
    output by far more than that."""
    cfg, params = hy
    model = torch_model(SMALL, params)
    tfp8.quantize_tree_fp8(model, min_size=2 ** 12)
    jparams = jax.jit(functools.partial(jfp8.quantize_tree_fp8,
                                        min_size=2 ** 12))(params)
    rng = np.random.default_rng(3)
    x = rng.standard_normal((1, 16, 5, 8, 16)).astype(np.float32)
    tt = np.array([900.0], np.float32)
    txt, mask, txt2 = text_inputs(SMALL)
    want = _jit_exact(jhy.hyvideo_forward, cfg, jparams, jnp.asarray(x),
                      jnp.asarray(tt), jnp.asarray(txt[None]),
                      jnp.asarray(mask[None]), jnp.asarray(txt2[None]))
    with torch.inference_mode():
        got = model(t(x), t(tt), t(txt[None]), t(mask[None]),
                    t(txt2[None]), carve=None)
        bf = torch_model(SMALL, params)(
            t(x), t(tt), t(txt[None]), t(mask[None]), t(txt2[None]),
            carve=None)
    err = rel_err(got.numpy(), want)
    print(f"hyvideo fp8 forward rel err {err:.3e}; fp8 vs f32 weights "
          f"{rel_err(got.numpy(), bf.numpy()):.3e}")
    assert err < 1e-4
    assert rel_err(got.numpy(), bf.numpy()) > 1e-3


def test_wan_fp8_forward_matches_jax(wan):
    """The dense Wan forward with fp8 weights at the default threshold,
    port vs JAX; 1e-4 relative."""
    cfg, params, _ = wan
    model = _wan_model(WAN_SMALL, params)
    assert tfp8.quantize_tree_fp8(model)
    jparams = jax.jit(jfp8.quantize_tree_fp8)(params)
    rng = np.random.default_rng(3)
    x = rng.standard_normal((1, 16, 5, 8, 16)).astype(np.float32)
    tt = np.array([900.0], np.float32)
    ctx = np.zeros((1, WAN_SMALL["text_len"], WAN_SMALL["text_dim"]),
                   np.float32)
    ctx[:, :20] = rng.standard_normal((1, 20, WAN_SMALL["text_dim"]))
    want = _jit_exact(jwan.wan_forward, cfg, jparams, jnp.asarray(x),
                      jnp.asarray(tt), jnp.asarray(ctx))
    with torch.inference_mode():
        got = model(t(x), t(tt), t(ctx), carve=None)
    err = rel_err(got.numpy(), want)
    print(f"wan fp8 forward rel err {err:.3e}")
    assert err < 1e-4


def test_sampler_use_fp8_quantizes_after_init():
    """``HunyuanVideoSampler(use_fp8=True)`` quantizes the seeded init in
    place: the same layers as ``quantize_tree_fp8`` on a bf16 twin, with
    the same bytes, and no bf16 copy of them left."""
    from jenga_tpu_torch.models.hyvideo import HYVideoConfig
    from jenga_tpu_torch.runtime import HunyuanVideoSampler
    cfg = HYVideoConfig(**dict(SMALL, dtype="bfloat16"))
    fp8 = HunyuanVideoSampler(cfg, device="cpu", seed=2, use_fp8=True).model
    twin = HunyuanVideoSampler(cfg, device="cpu", seed=2).model
    names = tfp8.quantize_tree_fp8(twin)
    got = [n for n, m in fp8.named_modules()
           if isinstance(m, Affine) and m.w8 is not None]
    assert got == names and all(fp8.get_submodule(n).w is None
                                for n in names)
    for n in names:
        assert torch.equal(fp8.get_submodule(n).w8.view(torch.uint8),
                           twin.get_submodule(n).w8.view(torch.uint8))

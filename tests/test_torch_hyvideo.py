"""The HunyuanVideo slice of the port against the JAX package on the CPU:
the param bridge, a carved forward (joint q8 and per-row q1) and the
dense fallback, an 8-step Base-shaped trajectory through the stage switch
and a skip step, and the port's CLI and import hygiene."""

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
from jenga_tpu.models import hyvideo as jhy
from jenga_tpu.pipelines.hyvideo_t2v import HYT2VOptions as JaxOptions
from jenga_tpu.pipelines.hyvideo_t2v import HYVideoT2VPipeline as JaxPipeline
from jenga_tpu_torch.configs.presets import get_hy_preset
from jenga_tpu_torch.convert import hyvideo_params_from_jax
from jenga_tpu_torch.models import hyvideo as thy
from jenga_tpu_torch.pipelines.hyvideo_t2v import HYVideoT2VPipeline

from _torch_parity import (LATENT, SMALL, np_params, rel_err, t,
                           text_inputs, torch_model)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GRID = (9, 8, 16)


@pytest.fixture(scope="module")
def small():
    cfg, params = np_params(SMALL)
    return cfg, params, torch_model(SMALL, params)


def test_bridge_shapes_and_dtypes():
    """Every leaf arrives under its tree path with its dtype kept; linear
    weights are transposed to [out, in]. The bf16 config keeps the f32
    modulation/embedder/norm leaves f32."""
    kw = dict(SMALL, dtype="bfloat16")
    _, params = np_params(kw, perturb=False)
    sd = hyvideo_params_from_jax(params)
    flat = jax.tree_util.tree_flatten_with_path(params)[0]
    assert len(sd) == len(flat)
    for path, leaf in flat:
        name = ".".join(str(getattr(p, "key", getattr(p, "idx", p)))
                        for p in path)
        got = sd[name]
        assert str(got.dtype).split(".")[-1] == np.asarray(leaf).dtype.name
        want_shape = leaf.shape[::-1] if name.endswith(".w") and \
            leaf.ndim == 2 else leaf.shape
        assert tuple(got.shape) == tuple(want_shape), name
    assert sd["double_blocks.0.img_mod.w"].dtype == torch.float32
    assert sd["double_blocks.0.img_qkv.w"].dtype == torch.bfloat16
    model = thy.HYVideoDiT(thy.HYVideoConfig(**kw))
    model.load_state_dict(sd, strict=True)
    np.testing.assert_array_equal(
        model.img_in.w.float().numpy().T,
        np.asarray(params["img_in"]["w"], np.float32))


def test_random_init_follows_jax_distribution():
    """Device init: same zero/one/uniform layout as init_hyvideo_params."""
    model = thy.HYVideoDiT(thy.HYVideoConfig(**SMALL))
    thy.init_hyvideo_(model, torch.Generator().manual_seed(0))
    _, params = np_params(SMALL, perturb=False)
    sd = hyvideo_params_from_jax(params)
    for name, p in model.state_dict().items():
        ref = sd[name]
        if not ref.any():
            assert not p.any(), name
        elif bool((ref == 1).all()):
            assert bool((p == 1).all()), name
        else:
            bound = float(ref.abs().max())
            assert float(p.abs().max()) <= bound * 1.01 + 1e-6, name
            assert float(p.std()) > 0.3 * float(ref.std()), name


def _carves(cfg, drop, q_rows, joint):
    plan = build_curve_plan(GRID)
    jc = jhy.make_hy_carve(cfg, plan, drop, 0.3, q_rows=q_rows,
                           joint_sel=joint)
    tc = thy.make_hy_carve(thy.HYVideoConfig(**SMALL), GRID, drop, 0.3,
                           q_rows=q_rows, joint_sel=joint)
    return jc, tc


@pytest.mark.parametrize("drop,q_rows,joint", [(0.75, 8, True),
                                               (0.75, 1, False),
                                               (0.0, 1, False)])
def test_forward_matches_jax(small, drop, q_rows, joint):
    """Full forward of the slice config, carved (joint q8 with a
    video/text boundary group, per-row q1) and dense, vs hyvideo_forward.
    f32 throughout; 2e-5 relative covers the JAX kernels' fixed-max
    epilogue and summation order (measured ~1.5e-6); a flipped block
    selection or a masking fault moves whole rows, far above it."""
    cfg, params, model = small
    rng = np.random.default_rng(3)
    x = rng.standard_normal((1, *LATENT)).astype(np.float32)
    tt = np.array([900.0], np.float32)
    txt, mask, txt2 = text_inputs(SMALL)
    jc, tc = _carves(cfg, drop, q_rows, joint)
    want = jhy.hyvideo_forward(
        jax.tree.map(jnp.asarray, params), cfg, jnp.asarray(x),
        jnp.asarray(tt), jnp.asarray(txt[None]), jnp.asarray(mask[None]),
        jnp.asarray(txt2[None]), carve=jc)
    with torch.inference_mode():
        got = model(t(x), t(tt), t(txt[None]), t(mask[None]), t(txt2[None]),
                    carve=tc)
    assert got.shape == want.shape
    err = rel_err(got.numpy(), want)
    print(f"forward rel err {err:.3e}")
    assert err < 2e-5


def test_trajectory_matches_jax(small):
    """8-step Base-shaped trajectory (joint q8, drop 0.75 then 0.85 with
    the stage split after step 4, step 6 skipped on the cached residual)
    from the same initial latents. 1e-4 relative on the final latents:
    the forward's ~1.5e-6 deviation compounds over 8 Euler steps
    (measured ~5e-6)."""
    cfg, params, model = small
    base = get_hy_preset("base", size=(256, 128), video_length=33,
                         num_inference_steps=8)
    jopts = JaxOptions(**dataclasses.asdict(base))
    txt, mask, txt2 = text_inputs(SMALL, seed=5)
    lat0 = np.random.default_rng(6).standard_normal(LATENT).astype(
        np.float32)
    want = JaxPipeline(cfg, jax.tree.map(jnp.asarray, params)).generate(
        jnp.asarray(txt), jnp.asarray(mask), jnp.asarray(txt2), jopts,
        decode=False, initial_latents=lat0)
    steps = []
    got = HYVideoT2VPipeline(model).generate(
        txt, mask, txt2, base, initial_latents=lat0,
        on_step=lambda i, lat: steps.append(i))
    assert steps == list(range(8))
    err = rel_err(got.numpy(), want)
    print(f"trajectory rel err {err:.3e}")
    assert err < 1e-4


def _run(code_or_args, tmp_path=None):
    env = dict(os.environ, PYTHONPATH=ROOT)
    return subprocess.run([sys.executable, *code_or_args],
                          capture_output=True, text=True, env=env,
                          cwd=tmp_path or ROOT, timeout=300)


def test_cli_tiny_cpu(tmp_path):
    out = tmp_path / "v.npy"
    r = _run(["-m", "jenga_tpu_torch.cli", "hyvideo-t2v", "--tiny",
              "--device", "cpu", "--latents-only", "--infer-steps", "3",
              "--video-size", "256", "128", "--video-length", "33",
              "--save-path", str(out)], tmp_path)
    assert r.returncode == 0, r.stderr[-2000:]
    assert "gen_time_s" in r.stdout
    lat = np.load(out)
    assert lat.shape == LATENT and np.isfinite(lat).all()


@pytest.mark.parametrize("device", ["cpu", "cuda"])
def test_cli_tiny_configs_by_device(device):
    """--tiny builds configs the device can run: on the card bf16 with head
    dim 128 (the attention kernels take nothing else) and a RoPE split
    that covers the head; on the CPU the f32 head-dim-64 models the CPU
    CLI tests run. Only the config objects are built."""
    from jenga_tpu_torch.cli import _tiny_config, _tiny_wan_config
    hy, wan = _tiny_config(device), _tiny_wan_config(device)
    assert sum(hy.rope_dim_list) == hy.head_dim
    assert sum(wan.rope_dims) == wan.head_dim
    if device == "cuda":
        assert hy.dtype == wan.dtype == "bfloat16"
        assert hy.head_dim == wan.head_dim == 128
        assert hy.rope_dim_list == thy.HUNYUAN_VIDEO_T2V.rope_dim_list
    else:
        assert hy.dtype == wan.dtype == "float32"
        assert hy.head_dim == wan.head_dim == 64
        assert (hy.hidden_size, hy.rope_dim_list, wan.dim) == (
            128, (16, 24, 24), 128)


def test_port_imports_no_jax():
    r = _run(["-c", "import sys; import jenga_tpu_torch.cli, "
              "jenga_tpu_torch.runtime, jenga_tpu_torch.pipelines."
              "hyvideo_t2v, jenga_tpu_torch.configs.presets; "
              "assert 'jax' not in sys.modules, 'jax imported'; print('ok')"])
    assert r.returncode == 0 and "ok" in r.stdout, r.stderr[-2000:]


def test_device_cuda_raises_without_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    r = _run(["-m", "jenga_tpu_torch.cli", "hyvideo-t2v", "--tiny",
              "--latents-only"])
    assert r.returncode != 0
    assert "no CUDA device" in r.stderr

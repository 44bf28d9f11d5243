"""The port's fidelity harness and the CLI flags of the DiT loop against
the JAX package on the CPU: the ``.npz`` trajectory format read across
packages, ``trajectory_mse``, ``reference_fidelity_report`` and
``carving_fidelity_report`` against JAX's on the same tiny pipeline, the
fidelity tool at its smoke sizes, and, per new flag, the options each
command builds against the ones the JAX CLI's handler builds (its
sampler's entry point patched to record them), with the two JAX quirks the
port decides on: ``--task``'s default and ``--use-fp8`` under ``--tiny``."""

import dataclasses
import json
import math
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from jenga_tpu import cli as jcli
from jenga_tpu import runtime as jruntime
from jenga_tpu.models import wan as jwan
from jenga_tpu.pipelines import hyvideo_i2v as jhy_i2v
from jenga_tpu.pipelines import loss_eval as jloss
from jenga_tpu.pipelines import wan_i2v as jwan_i2v
from jenga_tpu.pipelines.wan_t2v import WanT2VOptions as JaxOptions
from jenga_tpu.pipelines.wan_t2v import WanT2VPipeline as JaxPipeline
from jenga_tpu_torch import cli as tcli
from jenga_tpu_torch import runtime as truntime
from jenga_tpu_torch.convert import wan_params_from_jax
from jenga_tpu_torch.models import wan as twan
from jenga_tpu_torch.pipelines import loss_eval as tloss
from jenga_tpu_torch.pipelines.wan_t2v import WanT2VOptions, WanT2VPipeline
from jenga_tpu_torch.tools import fidelity

from _torch_parity import rel_err

WAN_SMALL = dict(dim=256, ffn_dim=512, num_heads=2, num_layers=1,
                 text_dim=64, text_len=32, dtype="float32")


def _trace(seed, n=3, shape=(2, 3, 4)):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(shape).astype(np.float32) for _ in range(n)]


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_trajectory_npz_reads_across_packages(tmp_path, writer):
    """A trajectory written by either package loads in the other: the same
    arrays in step order and the same meta dict; the reference report over
    it agrees with JAX's."""
    trace, meta = _trace(0, n=12), {"seed": 7, "schedule": "unipc",
                                    "shape": [2, 3, 4]}
    path = str(tmp_path / "ref.npz")
    (tloss if writer == "port" else jloss).save_trajectory(path, trace, meta)
    for reader in (tloss, jloss):
        steps, got_meta = reader.load_trajectory(path)
        assert got_meta == meta and len(steps) == 12
        for a, b in zip(steps, trace):
            np.testing.assert_array_equal(a, b)
    ours = _trace(1, n=10)
    got = tloss.reference_fidelity_report(ours, path)
    want = jloss.reference_fidelity_report(ours, path)
    assert got["steps_compared"] == want["steps_compared"] == 10
    assert got["meta"] == want["meta"]
    np.testing.assert_allclose(got["per_step_mse"], want["per_step_mse"],
                               rtol=1e-6)
    for key in ("final_mse", "final_relative_error"):
        assert math.isclose(got[key], want[key], rel_tol=1e-6)


def test_trajectory_mse_matches_jax():
    a, b = _trace(2), _trace(3)
    np.testing.assert_allclose(tloss.trajectory_mse(a, b),
                               jloss.trajectory_mse(a, b), rtol=1e-6)
    assert tloss.trajectory_mse(a, a) == [0.0] * 3


class _JaxDraw:
    """The port's Wan pipeline fed the initial latents JAX's ``generate``
    draws from ``opts.seed`` (``PRNGKey`` -> split -> normal), so both
    reports run the same trajectories."""

    def __init__(self, pipe):
        self.pipe = pipe

    def generate(self, context, context_null, opts, decode=True):
        k0, _ = jax.random.split(jax.random.PRNGKey(opts.seed))
        lat0 = jax.random.normal(k0, (1, *self.pipe._latent_shape(opts)))
        return self.pipe.generate(context, context_null, opts,
                                  initial_latents=np.array(lat0)[0],
                                  decode=decode)


def test_carving_fidelity_report_matches_jax():
    """The carved (joint q8, drop .75/.85) vs dense report of a 3-step
    Wan trajectory at 224x128x17f (5 blocks; no TeaCache) through the
    port's ``carving_fidelity_report`` and JAX's, same weights and draws:
    each number within 1e-4 relative (the trajectories agree to ~1e-6, the
    carving moves the latents by percents)."""
    cfg = jwan.WanConfig(**WAN_SMALL)
    params = jax.tree.map(np.asarray, jax.jit(
        jwan.init_wan_params, static_argnums=1)(jax.random.PRNGKey(0), cfg))
    w = params["head"]["linear"]["w"]
    params["head"]["linear"]["w"] = (np.random.default_rng(100)
                                     .standard_normal(w.shape) * 0.05
                                     ).astype(w.dtype)
    model = twan.WanDiT(twan.WanConfig(**WAN_SMALL))
    model.load_state_dict(wan_params_from_jax(params), strict=True)
    base = WanT2VOptions(size=(224, 128), frame_num=17, sampling_steps=3,
                         teacache_thresh=None, seed=7)
    carved = dataclasses.replace(base, q_group=8)
    dense = dataclasses.replace(base, sa_drop_rates=(0.0, 0.0))
    rng = np.random.default_rng(1)
    ctx = rng.standard_normal((20, WAN_SMALL["text_dim"])).astype(np.float32)
    null = rng.standard_normal((10, WAN_SMALL["text_dim"])).astype(
        np.float32)
    want = jloss.carving_fidelity_report(
        JaxPipeline(cfg, jax.tree.map(jnp.asarray, params)), None,
        jnp.asarray(ctx), jnp.asarray(null),
        JaxOptions(**dataclasses.asdict(carved)),
        JaxOptions(**dataclasses.asdict(dense)))
    got = tloss.carving_fidelity_report(
        _JaxDraw(WanT2VPipeline(model)), (ctx, null), carved, dense)
    print(f"report port {got} jax {want}")
    assert got.keys() == want.keys()
    assert want["relative_error"] > 1e-3
    for key in got:
        assert math.isclose(got[key], want[key], rel_tol=1e-4), key


def test_fidelity_tool_quick_cpu(tmp_path):
    """Every suite of the fidelity tool at the JAX tools' smoke sizes on
    the CPU: the JAX tools' rows (5 Wan, 3 each for HY, HY-I2V and
    Wan-14B), finite, carving against dense moving the latents, the I2V
    frame-0 pin checked inside; ``--out`` writes the rows."""
    out = tmp_path / "rows.jsonl"
    fidelity.main(["--quick", "--device", "cpu", "--out", str(out)])
    rows = [json.loads(line) for line in out.read_text().splitlines()]
    assert [(r["suite"], r["row"]) for r in rows] == [
        ("wan", "per_row_vs_dense"), ("wan", "q4_vs_dense"),
        ("wan", "q4_vs_per_row"), ("wan", "q8_vs_dense"),
        ("wan", "q8_vs_per_row")] + [
        (s, r) for s in ("hy", "i2v", "wan14b")
        for r in ("q8_vs_dense", "per_row_vs_dense", "q8_vs_per_row")]
    for r in rows:
        assert r["device"] == "cpu"
        assert all(math.isfinite(r[k]) for k in
                   ("final_mse", "relative_error", "dense_norm"))
    assert all(r["relative_error"] > 0 for r in rows
               if r["row"].endswith("_vs_dense") and r["suite"] != "i2v")


def test_fidelity_tool_needs_a_card_by_default():
    with pytest.raises(RuntimeError, match="no CUDA device"):
        fidelity.run(["wan"], quick=True)


# ------------------------------------------------------------------- CLI

class _Captured(Exception):
    pass


# the JAX entry point each command hands its options to
JAX_ENTRY = {"hyvideo-t2v": (jruntime.HunyuanVideoSampler, "predict"),
             "hyvideo-i2v": (jhy_i2v.HYVideoI2VPipeline, "generate_i2v"),
             "wan-t2v": (jruntime.WanSampler, "generate"),
             "wan-i2v": (jwan_i2v.WanI2VPipeline, "generate_i2v")}
JAX_RUN = {"hyvideo-t2v": "run_hyvideo_t2v", "hyvideo-i2v": "run_hyvideo_i2v",
           "wan-t2v": "run_wan_t2v", "wan-i2v": "run_wan_i2v"}


def _jax_options(argv):
    """The options the JAX handler builds for ``argv`` with ``--tiny
    --no-compile-cache --cpu``, recorded at its sampler's entry point."""
    seen = {}

    def record(self, *args, **kw):
        seen["opts"] = next(a for a in args if dataclasses.is_dataclass(a))
        raise _Captured

    cls, name = JAX_ENTRY[argv[0]]
    args = jcli.build_parser().parse_args(
        argv + ["--tiny", "--no-compile-cache", "--cpu"])
    with mock.patch.object(cls, name, record), pytest.raises(_Captured):
        getattr(jcli, JAX_RUN[argv[0]])(args)
    return seen["opts"]


def _port_options(argv):
    args = tcli.build_parser().parse_args(argv + ["--tiny"])
    return {"hyvideo-t2v": tcli.hy_t2v_options,
            "hyvideo-i2v": tcli.hy_i2v_options,
            "wan-t2v": tcli.wan_t2v_options,
            "wan-i2v": lambda a: tcli.wan_i2v_inputs(a)[0]}[argv[0]](args)


DROP = ["--sa-drop-rates", "0.6", "0.7"]
P_REMAIN = ["--p-remain-rates", "0.45"]
FLAG_CASES = [
    ["hyvideo-t2v", *DROP], ["hyvideo-t2v", "--sa-drop-rates"],
    ["hyvideo-t2v", *P_REMAIN], ["hyvideo-t2v", "--curve-type", "sliced"],
    ["hyvideo-t2v", "--embedded-cfg-scale", "4.5"],
    ["hyvideo-t2v", "--use-fp8"],
    ["hyvideo-i2v", *DROP], ["hyvideo-i2v", *P_REMAIN],
    ["hyvideo-i2v", "--curve-type", "transposed"],
    ["wan-t2v", *DROP], ["wan-t2v", "--sa-drop-rates"],
    ["wan-t2v", *P_REMAIN], ["wan-t2v", "--curve-type", "gilbert"],
    ["wan-t2v", "--sample-shift", "5"], ["wan-t2v", "--enable-turbo"],
    ["wan-t2v", "--sample-solver", "dpm++"],
    ["wan-t2v", "--task", "t2v-14B"],
    ["wan-i2v", *DROP], ["wan-i2v", *P_REMAIN],
]


@pytest.mark.parametrize("argv", FLAG_CASES, ids=" ".join)
def test_cli_flag_builds_jax_options(argv):
    """Each new flag: the options the port's command builds, field for
    field, equal the JAX handler's for the same flags, and the flag took
    effect where JAX applies it (an empty ``--sa-drop-rates`` keeps the
    preset's; the I2V ``--curve-type`` is parsed and not applied)."""
    want = _jax_options(argv)
    got = _port_options(argv)
    assert type(got).__name__ == type(want).__name__
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    default = _port_options(argv[:1])
    flag = argv[1]
    changed = {f.name for f in dataclasses.fields(got)
               if getattr(got, f.name) != getattr(default, f.name)}
    expect = {"--sa-drop-rates": {"sa_drop_rates"} if len(argv) > 2 else
              set(),
              "--p-remain-rates": {"p_remain"},
              "--curve-type": set() if argv[0] == "hyvideo-i2v"
              else {"curve"},
              "--embedded-cfg-scale": {"embedded_guidance_scale"},
              "--sample-shift": {"shift"}, "--enable-turbo": {"enable_turbo"},
              "--sample-solver": {"solver"}, "--use-fp8": set(),
              "--task": set()}[flag]
    assert changed == expect


@pytest.mark.parametrize("argv,jax_task,port_task", [
    (["wan-t2v", "--preset", "14b-base"], "t2v-1.3B", "t2v-14B"),
    (["wan-t2v", "--preset", "1.3b-turbo"], "t2v-1.3B", "t2v-1.3B"),
    (["wan-t2v", "--preset", "14b-base", "--task", "t2v-1.3B"], "t2v-1.3B",
     "t2v-1.3B"),
    (["wan-t2v", "--task", "t2v-14B"], "t2v-14B", "t2v-14B"),
])
def test_wan_task_quirk(argv, jax_task, port_task):
    """The model ``wan-t2v`` builds without ``--tiny``: JAX's ``--task``
    defaults to t2v-1.3B whatever the preset says, so ``--preset
    14b-base`` alone builds the 1.3B model there; in the port ``--task``
    decides when given, else the preset does."""
    seen = {}

    def record(task, *a, **kw):
        seen["task"] = task
        raise _Captured

    with mock.patch.object(jruntime.WanSampler, "from_pretrained",
                           staticmethod(record)), pytest.raises(_Captured):
        jcli.run_wan_t2v(jcli.build_parser().parse_args(
            argv + ["--no-compile-cache", "--cpu"]))
    assert seen.pop("task") == jax_task
    with mock.patch.object(truntime.WanSampler, "from_pretrained",
                           staticmethod(record)), pytest.raises(_Captured):
        tcli.run_wan_t2v(tcli.build_parser().parse_args(argv))
    assert seen["task"] == port_task


@pytest.mark.parametrize("tiny", [False, True])
def test_use_fp8_quirk(tiny):
    """``hyvideo-t2v --use-fp8`` quantizes the published model and not the
    ``--tiny`` one, in both CLIs: JAX hands ``use_fp8`` to
    ``from_pretrained`` only on the non-tiny path; the port's sampler gets
    ``use_fp8=not tiny``."""
    argv = ["hyvideo-t2v", "--use-fp8"] + (["--tiny"] if tiny else [])
    seen = {}

    def from_pretrained(*a, **kw):
        seen["jax"] = kw["use_fp8"]
        raise _Captured

    def predict(self, *a, **kw):
        raise _Captured

    with mock.patch.object(jruntime.HunyuanVideoSampler, "from_pretrained",
                           staticmethod(from_pretrained)), \
            mock.patch.object(jruntime.HunyuanVideoSampler, "predict",
                              predict), pytest.raises(_Captured):
        jcli.run_hyvideo_t2v(jcli.build_parser().parse_args(
            argv + ["--no-compile-cache", "--cpu"]))
    assert seen.get("jax", False) is (not tiny)

    def sampler(*a, **kw):
        seen["port"] = kw["use_fp8"]
        raise _Captured

    # --tiny builds its model, else the handler calls from_pretrained
    with (mock.patch.object(truntime, "HunyuanVideoSampler", sampler)
          if tiny else mock.patch.object(
              truntime.HunyuanVideoSampler, "from_pretrained",
              staticmethod(sampler))), pytest.raises(_Captured):
        tcli.run_hyvideo_t2v(tcli.build_parser().parse_args(
            argv + ["--device", "cpu"]))
    assert seen["port"] is (not tiny)


def test_loss_eval_report_rel_err_helper():
    """``fidelity_row`` on host arrays: zero for equal latents, and the
    JAX report's formula otherwise."""
    a, b = _trace(4, n=2)
    row = tloss.fidelity_row(a, b)
    assert math.isclose(row["relative_error"],
                        rel_err(a, b) * np.linalg.norm(b)
                        / (np.linalg.norm(b) + 1e-8), rel_tol=1e-5)
    assert tloss.fidelity_row(a, a)["final_mse"] == 0.0

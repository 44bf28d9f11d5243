"""The JAX package's multichip dryrun paths (``jenga_tpu/_dryrun_worker``)
in the port, on 4 gloo ranks.

The seven paths: Wan's carved CFG step, Wan Turbo's stage switch (256 ->
512 tokens under one mesh), HunyuanVideo joint q8, q_rows 16, HY-I2V
token_replace, the ring fallback (6 heads on 4 ranks) and ring x Ulysses
(2 x 2). Beside them: an image stream of 297 tokens (a multiple of
neither 4 nor 128), HunyuanVideo carved under a ring axis (the warning,
no K1, the dense result), Wan's carved CFG step on the 2 x 2 mesh (its
tokens sliced over ``sp`` and copied over ``ring``: it keeps carving),
Wan's ring fallback (2 heads) and its carved refusal.

One group of 4 ranks runs every case as subprocesses
(``_torch_sp_worker.py``, time-limited) while this process computes the
port at world 1 and JAX on its 4-device virtual mesh (Pallas in interpret
mode), on the same weights (the JAX init, zero-initialised heads
perturbed, through the converters and ``convert.save_params``) and the
same inputs. Every rank's output must be the same bytes, within 1e-5 of
world 1, and within the port's single-device parity bounds of JAX's mesh
result: 2e-5 for HunyuanVideo (tests/test_torch_hyvideo.py), 1e-5 for
Wan (tests/test_torch_wan.py), its two steps included.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from jenga_tpu.curves.blocks import build_curve_plan
from jenga_tpu.diffusion.unipc import unipc_schedule
from jenga_tpu.models import hyvideo as jhy
from jenga_tpu.models import wan as jwan
from jenga_tpu.parallel.mesh import make_sp_mesh as jax_sp_mesh
from jenga_tpu_torch import convert

import _torch_sp_worker as W
from _torch_parity import np_params, rel_err, wan_np_params

WORLD = 4
WORLD_TOL = 1e-5
JAX_TOL = {"hy": 2e-5, "wan": 1e-5}
TIMEOUT = 240
# weights file -> (kind, config kwargs, seed)
WEIGHTS = {"hy_dry4": ("hy", W.hy_dry_cfg(4), 1),
           "hy_dry4_tr": ("hy", W.hy_dry_cfg(4, "token_replace"), 2),
           "hy_dry6": ("hy", W.hy_dry_cfg(6), 3),
           "hy_dry2": ("hy", W.hy_dry_cfg(2), 4),
           "wan_dry": ("wan", W.WAN_DRY, 5),
           "wan_dry2h": ("wan", W.WAN_DRY_2H, 6)}


def _mesh(key):
    return jax_sp_mesh(jax.devices()[:WORLD], ring=2 if key == "2d" else 1)


def _jax_hy(name, params):
    wfile, cfgkw, grid, lat, kw, key = W.HY_DRY[name]
    cfg, p = params[wfile]
    carve = jhy.make_hy_carve(
        cfg, build_curve_plan(grid, "gilbert", 128), kw["sa_drop_rate"],
        0.5, text_amp=0.5, txt_block_num=2, q_rows=kw.get("q_rows", 1),
        joint_sel=kw.get("joint_sel", False))
    x, tt, txt, mask, txt2 = map(jnp.asarray, W.hy_inputs(cfgkw, lat))
    mesh = _mesh(key)
    fwd = jax.jit(lambda p, a, b, c, d: jhy.hyvideo_forward(
        p, cfg, a, tt, b, c, d, carve=carve, mesh=mesh))
    return fwd(p, x, txt, mask, txt2)


def _wan_carve(cfg, lat, q_rows=1, joint_sel=False, drop=0.5):
    grid = (lat[0], lat[1] // 2, lat[2] // 2)
    return jwan.make_wan_carve(cfg, build_curve_plan(grid, "sliced", 128),
                               drop, 0.9, q_rows=q_rows, joint_sel=joint_sel)


def _jax_wan_velocity(p, cfg, x, t, ctx, carve, mesh):
    v2 = jwan.wan_forward(p, cfg, jnp.concatenate([x, x]),
                          jnp.full((2,), t, jnp.float32), ctx, carve=carve,
                          mesh=mesh)
    return v2[1:2] + 5.0 * (v2[0:1] - v2[1:2])


def _jax_wan_step(params, key="1d"):
    cfg, p = params["wan_dry"]
    lat = (2, 16, 32)
    x, ctx = map(jnp.asarray, W.wan_inputs(W.WAN_DRY, lat))
    sched = unipc_schedule(10, shift=5.0)
    s0, s1 = float(sched.sigmas[0]), float(sched.sigmas[1])
    carve, mesh = _wan_carve(cfg, lat), _mesh(key)

    @jax.jit
    def step(p, x, ctx):
        v = _jax_wan_velocity(p, cfg, x, float(sched.timestep(0)), ctx,
                              carve, mesh)
        return (1.0 - s1) * (x - s0 * v) + s1 * (x - (1 - s0) * v) / s0
    return step(p, x, ctx)


def _jax_wan_turbo(params):
    cfg, p = params["wan_dry"]
    lat0, lat1 = (2, 16, 32), (2, 32, 32)
    x, ctx = map(jnp.asarray, W.wan_inputs(W.WAN_DRY, lat0, seed=11))
    noise = jnp.asarray(np.random.default_rng(12).standard_normal(
        (1, 16, *lat1)).astype(np.float32))
    sig0, sig1 = W.WAN_STEP_SIGMAS
    c0, c1, mesh = (_wan_carve(cfg, lat0, 2, True),
                    _wan_carve(cfg, lat1, 2, True), _mesh("1d"))

    @jax.jit
    def stage0(p, x, ctx):
        v = _jax_wan_velocity(p, cfg, x, 800.0, ctx, c0, mesh)
        clean = jax.image.resize(x - sig0 * v, (1, 16, *lat1),
                                 method="trilinear")
        return (1.0 - sig1) * clean + sig1 * noise

    @jax.jit
    def stage1(p, x, ctx):
        return _jax_wan_velocity(p, cfg, x, 600.0, ctx, c1, mesh)
    return stage1(p, stage0(p, x, ctx), ctx)


def _jax_wan_ring(params):
    cfg, p = params["wan_dry2h"]
    x, ctx = map(jnp.asarray, W.wan_inputs(W.WAN_DRY_2H, (2, 8, 16),
                                           seed=1))
    return jwan.wan_forward(p, cfg, x, jnp.array([300.0]), ctx[:1],
                            mesh=_mesh("1d"))


# case -> JAX's result from the params
JAX_CASES = {
    "wan_step": _jax_wan_step,
    "wan_step_2d": lambda params: _jax_wan_step(params, "2d"),
    "wan_turbo": _jax_wan_turbo,
    "wan_ring_fallback": _jax_wan_ring,
    **{n: (lambda n: lambda params: _jax_hy(n, params))(n)
       for n in W.HY_DRY},
}
# the same computation at world 1 (no mesh)
SAME_WORLD1 = {"wan_step_2d": "wan_step"}
# the cases whose ranks carve: K1 calls and masks as at world 1
CARVED = ("hy_q8", "hy_q16", "hy_i2v_tr", "hy_uneven", "wan_step",
          "wan_step_2d", "wan_turbo")


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The 4 ranks' results, the port at world 1 and JAX on its mesh."""
    d = str(tmp_path_factory.mktemp("dryrun"))
    params = {}
    for wfile, (kind, cfgkw, seed) in WEIGHTS.items():
        if kind == "hy":
            cfg, p = np_params(cfgkw, seed=seed)
            sd = convert.hyvideo_params_from_jax(p)
        else:
            cfg, p = wan_np_params(cfgkw, seed)
            sd = convert.wan_params_from_jax(p)
        convert.save_params(os.path.join(d, wfile + ".npz"), sd)
        params[wfile] = (cfg, jax.tree.map(jnp.asarray, p))
    procs = W.start_ranks("dryrun", WORLD, d)
    try:
        jax_out = {n: np.asarray(fn(params)) for n, fn in JAX_CASES.items()}
        world1 = {n: W.SUITES["dryrun"][n]({"1d": None, "2d": None}, "1d",
                                           d)
                  for n in jax_out if n not in SAME_WORLD1}
        world1.update({n: world1[m] for n, m in SAME_WORLD1.items()})
        ranks, logs = W.finish_ranks(procs, d, TIMEOUT)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    return ranks, world1, jax_out, logs


@pytest.mark.parametrize("name", sorted(JAX_CASES))
def test_path_matches_world1_and_jax(runs, name):
    """Every rank's output is the same bytes, within 1e-5 of world 1 and
    within the parity bound of JAX's mesh result; under Ulysses each rank
    calls K1 and D as often as one device does, and the union of the
    masks of one Ulysses group's local heads is the single-device mask
    (on the 2 x 2 mesh, each ring index's group holds the same masks)."""
    ranks, world1, jax_out, _ = runs
    outs = [r[name] for r in ranks]
    for o in outs:
        np.testing.assert_array_equal(o["out"], outs[0]["out"])
    got, want = outs[0]["out"], world1[name]["out"]
    assert got.shape == want.shape == jax_out[name].shape
    assert np.isfinite(got).all() and np.abs(got).max() > 0
    err_w1, err_jax = rel_err(got, want), rel_err(got, jax_out[name])
    print(f"{name}: rel err world 1 {err_w1:.3e}, JAX {err_jax:.3e}")
    assert err_w1 < WORLD_TOL
    assert err_jax < JAX_TOL["wan" if name.startswith("wan") else "hy"]
    k1 = {int(o["k1_calls"]) for o in outs}
    if name in CARVED:
        assert k1 == {int(world1[name]["k1_calls"])} and k1 != {0}
        assert {int(o["d_calls"]) for o in outs} == {
            int(world1[name]["d_calls"])}
        nu = WORLD // 2 if name.endswith("_2d") else WORLD
        want = W.head_union([world1[name]])
        assert len(want) == int(world1[name]["k1_calls"])
        for group in range(0, WORLD, nu):
            got = W.head_union(outs[group:group + nu])
            assert len(got) == len(want)
            for g, w in zip(got, want):
                np.testing.assert_array_equal(g, w)
    else:
        assert k1 == {0}


def test_ring_axis_disables_carving(runs):
    """Carving on a ring axis: each rank logs JAX's warning, launches no
    K1, and gives the dense forward (the same curve order, drop 0)."""
    ranks, world1, _, logs = runs
    assert all("carving DISABLED: heads_num=2 / mesh sp=2 ring=2" in log
               for log in logs[:1])
    assert {int(r["hy_ring_carved"]["k1_calls"]) for r in ranks} == {0}
    assert int(world1["hy_ring_carved"]["k1_calls"]) == 0


def test_wan_carved_heads_not_dividing_raise(runs):
    """Wan carved with 2 heads on 4 ranks: JAX's ValueError, on every
    rank, before any collective."""
    for r in runs[0]:
        assert "carved attention requires num_heads (2) divisible by the " \
            "sp mesh (4)" in str(r["wan_carved_bad_heads"]["message"])

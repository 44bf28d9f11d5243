"""The port's sequence parallelism (``jenga_tpu_torch/parallel``) against
its single-device path and against the JAX package's mesh.

Counterparts of tests/test_ulysses.py, test_ring_attention.py and
test_distributed_init.py. One group of 2 ranks (``("sp",)``) and one of 4
(``("sp",)`` of 4 and ``("ring", "sp")`` of 2 x 2) run on gloo as
subprocesses (``_torch_sp_worker.py``), each with its own time limit, while
this process computes the references: the port at world 1 (no mesh) and
JAX on its virtual CPU mesh (2 devices; 2 x 2 for ring x Ulysses), with
the Pallas kernels in interpret mode as the JAX tests run them. f32, tiny
widths. Where JAX's mesh cannot hold a case (token counts its
``shard_map`` does not divide), JAX's single-device function is the
reference, as in its own tests.

Bounds: against the port at world 1, 1e-5 relative (the slices change
the order of some sums); against JAX, 2e-5 relative, the forward bound of
tests/test_torch_hyvideo.py (the kernels' fixed-max epilogue and
summation order); masks bit for bit; every rank's model output the same
bytes.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from jenga_tpu.ops.flash_attention import attention_bshd as jax_attention
from jenga_tpu.parallel.mesh import make_sp_mesh as jax_sp_mesh
from jenga_tpu.parallel.mesh import shard_params_fsdp as jax_fsdp
from jenga_tpu.parallel.ring import ring_attention as jax_ring
from jenga_tpu.parallel.ring import ring_ulysses_attention as jax_ring_uly
from jenga_tpu.parallel.ulysses import ulysses_self_attention as jax_uly
from jenga_tpu_torch import convert
from jenga_tpu_torch.parallel import mesh as pmesh

import _torch_sp_worker as W
from _torch_parity import np_params, rel_err, wan_np_params

WORLD_TOL = 1e-5
JAX_TOL = 2e-5
TIMEOUT = 240       # seconds a rank may take; the run takes ~10
WORLDS = (2, 4)


def _jax_op(name):
    """JAX's result for op case ``name``: its mesh functions on 2 devices
    (2 x 2 for ring x Ulysses), else its dense attention."""
    spec, x = W.OPS[name], {k: jnp.asarray(v)
                            for k, v in W.op_inputs(name).items()}
    if spec["kind"] == "ulysses":
        return jax_uly(x["q"], x["k"], x["v"], x.get("cos"), x.get("sin"),
                       jax_sp_mesh(jax.devices()[:2]),
                       **W._ulysses_kw(spec))
    if spec["kind"] == "joint":
        s = spec["img"] + spec["txt"]
        s_pad, kw = W._joint_carve(spec)
        q, k, v = (jnp.concatenate([x[a], x["j" + a]], axis=1)
                   for a in "qkv")
        if not spec["sparse"]:
            return jax_attention(q, k, v, kv_len=jnp.asarray(
                kw["seqlen"].numpy()))
        q, k, v = (jnp.pad(a, ((0, 0), (0, s_pad - s), (0, 0), (0, 0)))
                   for a in (q, k, v))
        kw["seqlen"] = int(kw["seqlen"][0])
        return jax_uly(q, k, v, None, None, jax_sp_mesh(jax.devices()[:2]),
                       **kw)[:, :s]
    joint = {}
    if spec.get("st"):
        joint = dict(joint_k=x["jk"], joint_v=x["jv"],
                     joint_kv_len=x["jlen"])
    if spec["s"] % 4:
        k, v = x["k"], x["v"]
        if joint:
            k = jnp.concatenate([k, x["jk"]], axis=1)
            v = jnp.concatenate([v, x["jv"]], axis=1)
        return jax_attention(x["q"], k, v, kv_len=spec["s"] + x["jlen"])
    if spec["kind"] == "ring_ulysses":
        return jax_ring_uly(x["q"], x["k"], x["v"],
                            jax_sp_mesh(jax.devices()[:4], ring=2), **joint)
    return jax_ring(x["q"], x["k"], x["v"], jax_sp_mesh(jax.devices()[:2]),
                    **joint)


def _jax_fsdp_shapes(cfg, params, to_port, n):
    """The per-device shapes of JAX's ``shard_params_fsdp`` over n devices,
    under the port's names and layout (the converter's transposes)."""
    sharded = jax_fsdp(jax.tree.map(jnp.asarray, params),
                       jax_sp_mesh(jax.devices()[:n]))
    shapes = jax.tree.map(
        lambda a: np.zeros(a.sharding.shard_shape(a.shape), np.float32),
        sharded)
    return {k: tuple(v.shape) for k, v in to_port(shapes).items()}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The rank groups' results (world -> [per-rank dict]) and the
    references, computed while the groups run."""
    d = str(tmp_path_factory.mktemp("sp"))
    hy_cfg, hy_params = np_params(W.HY_SP, seed=0)
    wan_cfg, wan_params = wan_np_params(W.WAN_SP, seed=0)
    hy_sd = convert.hyvideo_params_from_jax(hy_params)
    wan_sd = convert.wan_params_from_jax(wan_params)
    convert.save_params(os.path.join(d, "hy_sp.npz"), hy_sd)
    convert.save_params(os.path.join(d, "wan_sp.npz"), wan_sd)
    procs = {n: W.start_ranks("parallel", n, d) for n in WORLDS}
    try:
        ref = {"op": {}, "jax_op": {}, "pipe": {}, "fsdp": {},
               "full_shapes": {m: {k: tuple(v.shape) for k, v in sd.items()}
                               for m, sd in (("hy", hy_sd),
                                             ("wan", wan_sd))}}
        for name in W.OPS:
            ref["op"][name] = W.op_reference(name)
            ref["jax_op"][name] = np.asarray(_jax_op(name))
        for name, fn in W.PIPES.items():
            spy = W.Spy()
            with spy.on():
                ref["pipe"][name] = spy.record({"out": W._np(fn(1))})
        ref["fsdp"]["hy"] = W._np(W.hy_fsdp_forward(W.load_model(
            W.thy.HYVideoDiT, W.HY_SP, os.path.join(d, "hy_sp.npz")), None))
        ref["fsdp"]["wan"] = W._np(W.wan_fsdp_forward(W.load_model(
            W.twan.WanDiT, W.WAN_SP, os.path.join(d, "wan_sp.npz")), None))
        ref["jax_fsdp"] = {
            (m, n): _jax_fsdp_shapes(cfg, params, conv, n)
            for m, cfg, params, conv in (
                ("hy", hy_cfg, hy_params, convert.hyvideo_params_from_jax),
                ("wan", wan_cfg, wan_params, convert.wan_params_from_jax))
            for n in WORLDS}
        res = {n: W.finish_ranks(procs[n], d, TIMEOUT)[0] for n in WORLDS}
    finally:
        for group in procs.values():
            for p in group:
                if p.poll() is None:
                    p.kill()
                    p.communicate()
    return res, ref, d


def _assembled(ranks, name):
    """The whole op output from the ranks' slices (joint: the text rows
    after the image slices, the same on every rank)."""
    spec = W.OPS[name]
    outs = [r["op/" + name]["out"] for r in ranks]
    if spec["kind"] != "joint":
        return np.concatenate(outs, axis=1)
    st = spec["txt"]
    for o in outs:
        np.testing.assert_array_equal(o[:, -st:], outs[0][:, -st:])
    return np.concatenate([o[:, :-st] for o in outs] + [outs[0][:, -st:]],
                          axis=1)


def _worlds(kind):
    return [n for n in WORLDS if kind != "ring_ulysses" or n == 4]


OP_CASES = [(n, name) for name, spec in W.OPS.items()
            for n in _worlds(spec["kind"])]


@pytest.mark.parametrize("world,name", OP_CASES)
def test_op_matches_world1_and_jax(runs, world, name):
    """Ulysses (dense, carved q_rows 1/4/8, HunyuanVideo's joint form over
    an uneven image stream), ring (with joint keys, a sample with zero
    joint keys, uneven slices) and ring x Ulysses: the ranks' slices
    assembled equal the single-device result within 1e-5 and JAX's within
    2e-5; the sparse calls' masks, the union of every rank's local heads,
    equal the single-device planner's bit for bit; each rank calls K1
    once where one device does, and D once per ring chunk (+1 for joint
    keys)."""
    res, ref, _ = runs
    ranks = res[world]
    got = _assembled(ranks, name)
    want = ref["op"][name]["out"]
    assert got.shape == want.shape and np.isfinite(got).all()
    err_w1, err_jax = rel_err(got, want), rel_err(got, ref["jax_op"][name])
    print(f"{name} at {world}: rel err world 1 {err_w1:.3e}, JAX "
          f"{err_jax:.3e}")
    assert err_w1 < WORLD_TOL
    assert err_jax < JAX_TOL
    spec = W.OPS[name]
    calls = {(int(r["op/" + name]["k1_calls"]),
              int(r["op/" + name]["d_calls"])) for r in ranks}
    want_masks = W.head_union([ref["op"][name]])
    if want_masks:
        # Ulysses runs on the ("sp",) mesh of all ranks
        got_masks = W.head_union([r["op/" + name] for r in ranks])
        assert len(got_masks) == len(want_masks) == 1
        np.testing.assert_array_equal(got_masks[0], want_masks[0])
        assert calls == {(1, 0)}
    elif spec["kind"] in ("ulysses", "joint"):
        assert calls == {(0, 1)}
    else:
        chunks = 2 if spec["kind"] == "ring_ulysses" else world
        assert calls == {(0, chunks + bool(spec.get("st")))}


def test_ring_zero_joint_keys(runs):
    """A sample whose joint keys are all padding (``joint_kv_len`` 0) gets
    zero weight from them, not NaN: D marks its rows +inf (base 2), the
    merge needs -inf (natural log). It equals attention over the image
    keys alone."""
    res, ref, _ = runs
    x = W.op_inputs("ring_joint")
    assert x["jlen"][1] == 0
    want = W.op_reference("ring_joint")["out"][1:]
    img_only = W.flash_attention.attention_bshd(
        *(torch.as_tensor(x[a][1:]) for a in "qkv")).numpy()
    assert rel_err(want, img_only) < 1e-6
    for world in WORLDS:
        got = _assembled(res[world], "ring_joint")[1:]
        assert np.isfinite(got).all()
        assert rel_err(got, img_only) < WORLD_TOL


@pytest.mark.parametrize("model", ["hy", "wan"])
@pytest.mark.parametrize("world", WORLDS)
def test_fsdp_shards_as_jax(runs, model, world):
    """``shard_params_fsdp`` leaves each rank the shapes JAX's
    ``shard_params_fsdp`` gives a device of the same mesh (the same
    tensors split, along the same logical dimension); the forward on the
    sharded model (weights gathered by the blocks' hooks) is bit-equal to
    the forward on the whole weights, every rank has the same output,
    within 1e-5 of world 1, and the shards are back after the forward."""
    res, ref, _ = runs
    want = ref["jax_fsdp"][(model, world)]
    full = ref["full_shapes"][model]
    assert sum(want[k] != full[k] for k in full) >= 10
    for r in res[world]:
        rec = r["fsdp_" + model]
        got = {k[len("shape/"):]: tuple(v) for k, v in rec.items()
               if k.startswith("shape/")}
        assert got == want
        np.testing.assert_array_equal(rec["fsdp_out"], rec["out"])
        np.testing.assert_array_equal(rec["out"],
                                      res[world][0]["fsdp_" + model]["out"])
        assert bool(rec["resharded"])
        assert rel_err(rec["out"], ref["fsdp"][model]) < WORLD_TOL


@pytest.mark.parametrize("name", sorted(W.PIPES))
@pytest.mark.parametrize("world", WORLDS)
def test_pipeline_on_mesh(runs, world, name):
    """The four pipelines through their samplers with ``sp_degree`` =
    world (mesh + FSDP): the same latents on every rank, within 1e-5 of
    world 1 (which JAX parity holds in the pipelines' own tests), and
    each rank calls K1 and D as often as one device does."""
    res, ref, _ = runs
    outs = [r["pipe/" + name] for r in res[world]]
    want = ref["pipe"][name]
    for o in outs:
        np.testing.assert_array_equal(o["out"], outs[0]["out"])
        assert (int(o["k1_calls"]), int(o["d_calls"])) == (
            int(want["k1_calls"]), int(want["d_calls"]))
    assert np.isfinite(outs[0]["out"]).all()
    assert rel_err(outs[0]["out"], want["out"]) < WORLD_TOL


def test_cli_writes_on_rank0_only(runs):
    """``wan-t2v --tiny --ulysses-degree 2`` in a group of 2: rank 0 prints
    the JSON line and writes the latents, rank 1 prints nothing."""
    res, _, d = runs
    r0, r1 = (r["cli"] for r in res[2])
    assert '"gen_time_s"' in str(r0["stdout"])
    assert "saved latents to" in str(r0["stdout"])
    assert str(r1["stdout"]) == ""
    assert np.isfinite(np.load(os.path.join(d, "cli_wan.npy"))).all()


@pytest.mark.parametrize("world", WORLDS)
def test_init_distributed(runs, world):
    """One process without a launcher: a no-op that returns 1 and makes no
    group. In a group, the group's size, again on a second call."""
    assert pmesh.init_distributed("cpu") == 1
    assert not torch.distributed.is_initialized()
    for r in runs[0][world]:
        assert list(r["init"]["world"]) == [world, world]


def test_mesh_and_heads_messages(runs):
    """``ring x ulysses != world`` raises with JAX's words; ring x Ulysses
    refuses heads the Ulysses axis does not divide."""
    res, _, _ = runs
    for r in res[2]:
        assert str(r["mesh_message"]["message"]).startswith(
            "world (2) must equal ring (2) x ulysses (2)")
    for r in res[4]:
        assert str(r["bad_heads"]["message"]) == \
            "heads (3) must divide the ulysses axis (2)"
    with pytest.raises(ValueError, match=r"world \(1\) must equal ring"):
        pmesh.make_sp_mesh(ring=2, device="cpu")


@pytest.mark.parametrize("model", ["hy", "wan"])
def test_multihost_mesh(runs, model):
    """``make_multihost_sp_mesh`` on 4 ranks: (dp, sp) = (1, 4) on one
    host, (2, 2) with two ranks per host (torchrun's LOCAL_WORLD_SIZE).
    On the (2, 2) mesh the model with FSDP slices its tokens and weights
    over ``sp`` and copies them over ``dp``: every rank has the same
    output, within 1e-5 of world 1."""
    res, ref, _ = runs
    outs = [r["multihost"]["out_" + model] for r in res[4]]
    for r, o in zip(res[4], outs):
        assert r["multihost"]["shapes"].tolist() == [[1, 4], [2, 2]]
        np.testing.assert_array_equal(o, outs[0])
    assert rel_err(outs[0], ref["fsdp"][model]) < WORLD_TOL


def test_sel_mask_on_a_mesh_raises(runs):
    """A replayed selection is single-device only, as in JAX."""
    for r in runs[0][2]:
        assert "single-device only" in str(r["sel_mask"]["message"])


def test_shard_sizes_and_ranges():
    """Slices of ceil(L / n) tokens, the last ones shorter or empty, in
    ring-major order, covering the stream once."""
    assert pmesh.shard_sizes(17820, 8) == [2228] * 7 + [2224]
    assert pmesh.shard_sizes(5, 4) == [2, 2, 1, 0]
    assert sum(pmesh.shard_sizes(1001, 4)) == 1001
    assert pmesh._shard_dim((3072, 3072), 4) == 1
    assert pmesh._shard_dim((9216, 3072), 4) == 0
    assert pmesh._shard_dim((6, 1536), 4) == 1
    assert pmesh._shard_dim((3, 5), 4) is None

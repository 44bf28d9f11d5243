"""One rank of the port's sequence-parallel tests, and the cases they share.

    python tests/_torch_sp_worker.py <suite> <rank> <world> <store> <dir>

Each rank joins a gloo group through the ``file://`` store (no TCP port,
so test files running side by side cannot collide), runs every case of
``suite`` ("parallel", "dryrun" or "extend") on its meshes, writes what
each case returned to ``<dir>/w<world>/rank<rank>.npz`` and prints
``RANK_OK``. Model weights come from ``<dir>/<name>.npz``
(``convert.save_params``), written by the test from the JAX init through
the converters. No JAX here: the test files import this module and run
the same cases with ``mesh=None``, the single-device (world 1)
reference, and hold both against JAX.

Every case returns a dict of numpy arrays. Op cases return this rank's
token slice (with its ``start``); model cases the whole, gathered output,
which must be the same bytes on every rank. ``k1_calls`` / ``d_calls``
count the calls into the block-sparse and the dense kernel's wrappers
(the launches on the card; on the CPU their plain versions), and
``mask/<i>`` the planner mask of the i-th sparse call, on this rank's
heads.
"""

import contextlib
import dataclasses
import io
import os
import sys
import traceback
from unittest import mock

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

import numpy as np  # noqa: E402
import torch  # noqa: E402

from jenga_tpu_torch import convert  # noqa: E402
from jenga_tpu_torch.models import hyvideo as thy  # noqa: E402
from jenga_tpu_torch.models import wan as twan  # noqa: E402
from jenga_tpu_torch.models.layers import apply_rope, rope_table_1d  # noqa
from jenga_tpu_torch.ops import flash_attention, sparse_dispatch  # noqa
from jenga_tpu_torch.ops.sparse_dispatch import \
    sparse_attention_from_mask  # noqa: E402
from jenga_tpu_torch.parallel import mesh as pmesh  # noqa: E402
from jenga_tpu_torch.parallel import ring as pring  # noqa: E402
from jenga_tpu_torch.parallel import ulysses as puly  # noqa: E402

# ------------------------------------------------------------- counting


class Spy:
    """Counts the kernel wrappers' calls and records the planner masks of
    the sparse calls (through every module that dispatches them)."""

    def __init__(self):
        self.k1 = self.d = 0
        self.masks = []

    @contextlib.contextmanager
    def on(self):
        real_k1 = sparse_dispatch.block_sparse_attention
        real_d = flash_attention._plain_forward
        real_sp = sparse_attention_from_mask

        def k1(*a, **kw):
            self.k1 += 1
            return real_k1(*a, **kw)

        def d(*a, **kw):
            self.d += 1
            return real_d(*a, **kw)

        def sp(qt, kt, vt, mask, **kw):
            self.masks.append(mask.clone())
            return real_sp(qt, kt, vt, mask, **kw)

        with mock.patch.object(sparse_dispatch, "block_sparse_attention",
                               k1), \
                mock.patch.object(flash_attention, "_plain_forward", d), \
                mock.patch.object(puly, "sparse_attention_from_mask", sp), \
                mock.patch.object(thy, "sparse_attention_from_mask", sp), \
                mock.patch.object(twan, "sparse_attention_from_mask", sp):
            yield self

    def record(self, out: dict):
        out["k1_calls"] = np.array(self.k1)
        out["d_calls"] = np.array(self.d)
        for i, m in enumerate(self.masks):
            out[f"mask/{i}"] = m.numpy()
        return out


def head_union(records):
    """The masks of every sparse call, each the union over ``records``
    (one per rank, in Ulysses order) of their local heads: [B, H, nqb,
    nkb] per call."""
    calls = sorted((k for k in records[0] if k.startswith("mask/")),
                   key=lambda k: int(k.split("/")[1]))
    return [np.concatenate([r[k] for r in records], axis=1) for k in calls]


def _np(x):
    return x.detach().float().numpy()


# ------------------------------------------------------------- op cases

B, H, D = 1, 4, 32
# name -> spec; "s" whole tokens, "sparse", "q_rows", "joint_sel", "rope";
# q_rows 8 is HunyuanVideo's joint form (its text rows, text_amp);
# joint: "img"/"txt" token counts, "valid" real text tokens; ring: "st"
# joint keys with "jlen" valid per sample (B = len(jlen))
OPS = {
    "ulysses_dense": dict(kind="ulysses", s=512, sparse=False, rope=True),
    "ulysses_q1": dict(kind="ulysses", s=512, sparse=True, q_rows=1,
                       rope=True),
    "ulysses_q4": dict(kind="ulysses", s=1024, sparse=True, q_rows=4,
                       joint_sel=True),
    # uneven: 1001 image tokens are a multiple of neither 2 nor 4
    "joint_q8": dict(kind="joint", img=1001, txt=200, valid=180,
                     sparse=True, q_rows=8, joint_sel=True),
    "joint_dense": dict(kind="joint", img=1001, txt=200, valid=180,
                        sparse=False),
    "ring": dict(kind="ring", s=512),
    "ring_joint": dict(kind="ring", s=512, st=24, jlen=(19, 0)),
    "ring_uneven": dict(kind="ring", s=501, st=24, jlen=(19,)),
    "ring_ulysses": dict(kind="ring_ulysses", s=512, st=16, jlen=(11,)),
    "ring_ulysses_uneven": dict(kind="ring_ulysses", s=501, st=16,
                                jlen=(11,)),
}
TOP_K, P_REMAIN, TEXT_AMP, TEXT_BLOCKS = 2, 0.5, 0.5, 2


def op_inputs(name):
    """The case's numpy inputs, the same in every process."""
    spec = OPS[name]
    rng = np.random.default_rng(sorted(OPS).index(name))
    b = len(spec.get("jlen", (0,)))

    def randn(*shape):
        return rng.standard_normal(shape).astype(np.float32)

    if spec["kind"] == "joint":
        si, st = spec["img"], spec["txt"]
        return dict(q=randn(B, si, H, D), k=randn(B, si, H, D),
                    v=randn(B, si, H, D), jq=randn(B, st, H, D),
                    jk=randn(B, st, H, D), jv=randn(B, st, H, D))
    s = spec["s"]
    out = dict(q=randn(b, s, H, D), k=randn(b, s, H, D), v=randn(b, s, H, D))
    if spec.get("st"):
        out.update(jk=randn(b, spec["st"], H, D), jv=randn(b, spec["st"], H,
                                                           D),
                   jlen=np.array(spec["jlen"], np.int32))
    if spec.get("rope"):
        cos, sin = rope_table_1d(np.arange(s), D)
        out.update(cos=cos, sin=sin)
    return out


def _joint_carve(spec):
    """(padded joint length, carve kwargs) of a joint case."""
    s = spec["img"] + spec["txt"]
    nb = -(-s // 128)
    kw = dict(sparse=spec["sparse"],
              seqlen=torch.tensor([spec["img"] + spec["valid"]]))
    if spec["sparse"]:
        kw.update(top_k=TOP_K, p_remain=P_REMAIN,
                  text_start_block=nb - TEXT_BLOCKS, text_blocks=TEXT_BLOCKS,
                  text_amp=TEXT_AMP, q_rows=spec["q_rows"],
                  joint_sel=spec["joint_sel"])
    return nb * 128, kw


def _ulysses_kw(spec):
    if not spec["sparse"]:
        return dict(sparse=False)
    return dict(sparse=True, top_k=TOP_K, p_remain=P_REMAIN,
                q_rows=spec["q_rows"], joint_sel=spec.get("joint_sel", False))


def op_reference(name):
    """The single-device result of op case ``name`` with the port's ops:
    {"out": whole output [B, S, H, D], "mask/0": [B, H, nqb, nkb]}."""
    spec, x = OPS[name], {k: torch.as_tensor(v)
                          for k, v in op_inputs(name).items()}
    spy = Spy()
    with spy.on():
        if spec["kind"] == "ulysses":
            q, k = x["q"], x["k"]
            if spec.get("rope"):
                q = apply_rope(q, x["cos"], x["sin"])
                k = apply_rope(k, x["cos"], x["sin"])
            out = puly._attend(q, k, x["v"], dense_kv_len=None,
                               **puly._carve_kw(**_ulysses_kw(spec)))
        elif spec["kind"] == "joint":
            s_pad, kw = _joint_carve(spec)
            q, k, v = (torch.nn.functional.pad(
                torch.cat([x[a], x["j" + a]], dim=1),
                (0, 0, 0, 0, 0, s_pad - spec["img"] - spec["txt"]
                 if spec["sparse"] else 0)) for a in "qkv")
            ckw = puly._carve_kw(**kw)
            out = puly._attend(q, k, v, dense_kv_len=ckw["seqlen"], **ckw)
            out = out[:, :spec["img"] + spec["txt"]]
        else:
            k, v, kv_len = x["k"], x["v"], None
            if spec.get("st"):
                k = torch.cat([k, x["jk"]], dim=1)
                v = torch.cat([v, x["jv"]], dim=1)
                kv_len = spec["s"] + x["jlen"]
            out = flash_attention.attention_bshd(x["q"], k, v,
                                                 kv_len=kv_len)
    res = spy.record({"out": _np(out)})
    return res


def op_run(name, meshes):
    """This rank's slice of op case ``name`` on its mesh: {"out", "start",
    "mask/0" (this rank's heads), counts}."""
    spec = OPS[name]
    x = {k: torch.as_tensor(v) for k, v in op_inputs(name).items()}
    mesh = meshes["2d" if spec["kind"] == "ring_ulysses" else "1d"]
    length = spec["img"] if spec["kind"] == "joint" else spec["s"]
    start, stop = pmesh.token_range(length, mesh)
    q, k, v = (x[a][:, start:stop] for a in "qkv")
    spy = Spy()
    with spy.on():
        if spec["kind"] == "ulysses":
            out = puly.ulysses_self_attention(
                q, k, v, x.get("cos"), x.get("sin"), mesh, length=length,
                **_ulysses_kw(spec))
        elif spec["kind"] == "joint":
            _, kw = _joint_carve(spec)
            out, txt = puly.ulysses_joint_attention(
                q, k, v, x["jq"], x["jk"], x["jv"], mesh, length=length,
                **kw)
            out = torch.cat([out, txt], dim=1)
        else:
            fn = pring.ring_ulysses_attention \
                if spec["kind"] == "ring_ulysses" else pring.ring_attention
            jk = dict(joint_k=x["jk"], joint_v=x["jv"],
                      joint_kv_len=x["jlen"]) if spec.get("st") else {}
            out = fn(q, k, v, mesh, length=length, **jk)
    return spy.record({"out": _np(out), "start": np.array(start)})


# --------------------------------------------------------- model configs

# FSDP and the pipelines: heads divide 2 and 4
HY_SP = dict(hidden_size=256, heads_num=4, rope_dim_list=(16, 24, 24),
             double_blocks=1, single_blocks=1, refiner_depth=1,
             text_states_dim=64, text_states_dim_2=24, dtype="float32")
WAN_SP = dict(dim=256, ffn_dim=512, num_heads=4, num_layers=2,
              text_dim=64, text_len=32, freq_dim=32, dtype="float32")
WAN_SP_I2V = dict(WAN_SP, model_type="i2v", in_dim=36)


def seeded_state(model_cls, init_fn, cfg, seed):
    """A seeded init with the zero-initialised heads perturbed, as a state
    dict: the same on every rank and in the test process."""
    model = model_cls(cfg)
    gen = torch.Generator().manual_seed(seed)
    init_fn(model, gen)
    with torch.no_grad():
        if isinstance(model, thy.HYVideoDiT):
            layers = [model.final_layer.linear, model.final_layer.adaLN] + [
                blk.adaLN for blk in model.txt_in.blocks]
        else:
            layers = [model.head_layer.linear]
        for lin in layers:
            lin.w.copy_(torch.randn(lin.w.shape, generator=gen) * 0.05)
    return model.state_dict()


def load_model(model_cls, cfg_kwargs, path):
    """The port's model of ``cfg_kwargs`` with the weights ``path`` holds
    (``convert.save_params``)."""
    cfg = (thy.HYVideoConfig if model_cls is thy.HYVideoDiT
           else twan.WanConfig)(**cfg_kwargs)
    model = model_cls(cfg)
    model.load_state_dict(convert.load_params(path, model), strict=True)
    return model


def hy_inputs(cfg_kwargs, lat, txt_len=256, txt_pad=40, seed=7):
    rng = np.random.default_rng(seed)
    c = 16
    x = rng.standard_normal((1, c, *lat)).astype(np.float32)
    txt = rng.standard_normal(
        (1, txt_len, cfg_kwargs["text_states_dim"])).astype(np.float32)
    mask = np.ones((1, txt_len), np.int32)
    mask[:, txt_len - txt_pad:] = 0
    txt2 = rng.standard_normal(
        (1, cfg_kwargs["text_states_dim_2"])).astype(np.float32)
    return x, np.array([500.0], np.float32), txt, mask, txt2


def hy_forward(model, carve, inputs, mesh):
    x, tt, txt, mask, txt2 = (torch.as_tensor(a) for a in inputs)
    with torch.inference_mode():
        return model(x, tt, txt, mask, txt2, carve=carve, mesh=mesh)


def wan_inputs(cfg_kwargs, lat, seed=42):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((1, 16, *lat)).astype(np.float32)
    ctx = np.zeros((2, cfg_kwargs["text_len"], cfg_kwargs["text_dim"]),
                   np.float32)
    n = min(12, cfg_kwargs["text_len"])
    ctx[:, :n] = rng.standard_normal((2, n, cfg_kwargs["text_dim"]))
    return x, ctx


# ----------------------------------------------------- "parallel" suite


def case_init(meshes, mesh_key, d):
    """init_distributed: the group's size, again on a second call."""
    n = pmesh.init_distributed("cpu")
    return {"world": np.array([n, pmesh.init_distributed("cpu")])}


def case_mesh_message(meshes, mesh_key, d):
    """make_sp_mesh refuses ring x ulysses != world, with JAX's words."""
    world = torch.distributed.get_world_size()
    try:
        pmesh.make_sp_mesh(ring=2, ulysses=world, device="cpu")
    except ValueError as e:
        return {"message": np.array(str(e))}
    return {"message": np.array("")}


def case_multihost(meshes, mesh_key, d):
    """make_multihost_sp_mesh: (dp, sp) = (hosts, ranks per host), from
    torchrun's LOCAL_WORLD_SIZE, or one host without it; and the FSDP
    forwards of both models on the (2, 2) mesh, whose tokens and weights
    are sliced over ``sp`` and copied over ``dp``."""
    world = torch.distributed.get_world_size()
    with mock.patch.dict(os.environ, {"LOCAL_WORLD_SIZE": "2"}):
        two = pmesh.make_multihost_sp_mesh(device="cpu")
    with mock.patch.dict(os.environ):
        os.environ.pop("LOCAL_WORLD_SIZE", None)
        one = pmesh.make_multihost_sp_mesh(device="cpu")
    assert one.mesh_dim_names == two.mesh_dim_names == ("dp", "sp")
    out = {"shapes": np.array([one.shape, two.shape]),
           "world": np.array(world)}
    for name, cls, cfg, fwd in (
            ("hy", thy.HYVideoDiT, HY_SP, hy_fsdp_forward),
            ("wan", twan.WanDiT, WAN_SP, wan_fsdp_forward)):
        model = pmesh.shard_params_fsdp(load_model(
            cls, cfg, os.path.join(d, f"{name}_sp.npz")), two)
        out[f"out_{name}"] = _np(fwd(model, two))
    return out


def case_sel_mask(meshes, mesh_key, d):
    """A recorded selection (``sel_mask``) on a mesh raises, as in JAX: the
    sequence-parallel paths have no planner bypass."""
    model = load_model(thy.HYVideoDiT, HY_SP, os.path.join(d, "hy_sp.npz"))
    carve = thy.make_hy_carve(model.cfg, (5, 8, 16), 0.6, 0.5)
    carve = dataclasses.replace(carve, sel_mask=torch.ones(
        (1, 4, 7, 7), dtype=torch.bool))
    try:
        hy_forward(model, carve, hy_inputs(HY_SP, HY_FSDP_LAT),
                   meshes[mesh_key])
    except NotImplementedError as e:
        return {"message": np.array(str(e))}
    return {"message": np.array("")}


def case_bad_heads(meshes, mesh_key, d):
    """ring_ulysses_attention refuses heads the Ulysses axis does not
    divide, before any collective."""
    x = torch.zeros((1, 8, 3, D))
    try:
        pring.ring_ulysses_attention(x, x, x, meshes["2d"])
    except ValueError as e:
        return {"message": np.array(str(e))}
    return {"message": np.array("")}


def fsdp_case(model_cls, cfg_kwargs, fwd, name, meshes, mesh_key, d):
    """Per-rank FSDP shapes, and the forward with FSDP against the same
    forward without it."""
    mesh = meshes[mesh_key]
    path = os.path.join(d, f"{name}.npz")
    plain = load_model(model_cls, cfg_kwargs, path)
    sharded = pmesh.shard_params_fsdp(load_model(model_cls, cfg_kwargs,
                                                 path), mesh)
    shapes = {k: tuple(v.shape) for k, v in sharded.state_dict().items()}
    out = {"shape/" + k: np.array(s) for k, s in shapes.items()}
    out["fsdp_out"] = _np(fwd(sharded, mesh))
    # the forward hook put the shards back
    out["resharded"] = np.array(all(
        tuple(v.shape) == shapes[k]
        for k, v in sharded.state_dict().items()))
    out["out"] = _np(fwd(plain, mesh))
    return out


HY_FSDP_LAT = (5, 16, 32)   # grid (5, 8, 16): 640 image tokens


def hy_fsdp_forward(model, mesh):
    carve = thy.make_hy_carve(model.cfg, (5, 8, 16), 0.6, 0.5,
                              text_amp=0.5, q_rows=8, joint_sel=True)
    return hy_forward(model, carve, hy_inputs(HY_SP, HY_FSDP_LAT), mesh)


WAN_FSDP_LAT = (5, 16, 28)  # grid (5, 8, 14): 560 tokens, 5 blocks


def wan_fsdp_forward(model, mesh):
    carve = twan.make_wan_carve(model.cfg, (5, 8, 14), 0.5, 0.9, q_rows=2,
                                joint_sel=True)
    x, ctx = wan_inputs(WAN_SP, WAN_FSDP_LAT)
    with torch.inference_mode():
        return model(torch.as_tensor(np.concatenate([x, x])),
                     torch.tensor([800.0, 800.0]), torch.as_tensor(ctx),
                     carve=carve, mesh=mesh)


def case_fsdp_hy(meshes, mesh_key, d):
    return fsdp_case(thy.HYVideoDiT, HY_SP, hy_fsdp_forward, "hy_sp",
                     meshes, mesh_key, d)


def case_fsdp_wan(meshes, mesh_key, d):
    return fsdp_case(twan.WanDiT, WAN_SP, wan_fsdp_forward, "wan_sp",
                     meshes, mesh_key, d)


def pipe_hy_t2v(sp):
    from jenga_tpu_torch.configs.presets import get_hy_preset
    from jenga_tpu_torch.runtime import HunyuanVideoSampler
    cfg = thy.HYVideoConfig(**HY_SP)
    sampler = HunyuanVideoSampler(
        cfg, seeded_state(thy.HYVideoDiT, thy.init_hyvideo_, cfg, 1),
        device="cpu", sp_degree=sp)
    opts = get_hy_preset("base", size=(256, 128), video_length=17,
                         num_inference_steps=4, non_skip_steps=(0, 1))
    _, _, txt, mask, txt2 = hy_inputs(HY_SP, (5, 16, 32))
    return sampler.predict(txt[0], mask[0], txt2[0], opts, decode=False)


def pipe_hy_i2v(sp):
    from jenga_tpu_torch.configs.presets import get_hy_i2v_options
    from jenga_tpu_torch.runtime import HunyuanVideoSampler
    cfg = thy.hy_i2v_config("token_replace", thy.HYVideoConfig(**HY_SP))
    sampler = HunyuanVideoSampler(
        cfg, seeded_state(thy.HYVideoDiT, thy.init_hyvideo_, cfg, 2),
        device="cpu", i2v=True, sp_degree=sp)
    opts = get_hy_i2v_options("base", size=(256, 128), video_length=17,
                              num_inference_steps=3, seed=5)
    rng = np.random.default_rng(8)
    img = rng.standard_normal((16, 1, 16, 32)).astype(np.float32)
    _, _, txt, mask, txt2 = hy_inputs(HY_SP, (5, 16, 32))
    return sampler.predict_i2v([img] * len(opts.res_rate_list), txt[0],
                               mask[0], txt2[0], opts, decode=False)


def pipe_wan_t2v(sp):
    from jenga_tpu_torch.configs.presets import get_wan_preset
    from jenga_tpu_torch.runtime import WanSampler
    cfg = twan.WanConfig(**WAN_SP)
    sampler = WanSampler(cfg, seeded_state(twan.WanDiT, twan.init_wan_, cfg,
                                           3), device="cpu", sp_degree=sp)
    opts = get_wan_preset("1.3b-base", size=(224, 128), frame_num=17,
                          sampling_steps=6)
    rng = np.random.default_rng(6)
    ctx = rng.standard_normal((20, WAN_SP["text_dim"])).astype(np.float32)
    null = np.zeros((10, WAN_SP["text_dim"]), np.float32)
    return sampler.generate(ctx, null, opts, decode=False)


def pipe_wan_i2v(sp):
    from jenga_tpu_torch.configs.presets import get_wan_i2v_options
    from jenga_tpu_torch.models.wan import CLIP_DIM
    from jenga_tpu_torch.runtime import WanSampler
    cfg = twan.WanConfig(**WAN_SP_I2V)
    sampler = WanSampler(cfg, seeded_state(twan.WanDiT, twan.init_wan_, cfg,
                                           4), device="cpu", sp_degree=sp)
    opts = get_wan_i2v_options(832 * 480, sampling_steps=4, frame_num=17,
                               seed=4)
    rng = np.random.default_rng(9)
    img_lat = np.zeros((16, 5, 16, 28), np.float32)
    img_lat[:, 0] = rng.standard_normal((16, 16, 28))
    clip = rng.standard_normal((257, CLIP_DIM)).astype(np.float32)
    ctx = rng.standard_normal((20, WAN_SP["text_dim"])).astype(np.float32)
    null = np.zeros((10, WAN_SP["text_dim"]), np.float32)
    return sampler.generate_i2v(img_lat, clip, ctx, null, 17, 16, 28, opts,
                                decode=False)


PIPES = {"hy_t2v": pipe_hy_t2v, "hy_i2v": pipe_hy_i2v,
         "wan_t2v": pipe_wan_t2v, "wan_i2v": pipe_wan_i2v}


def pipe_case(name):
    def case(meshes, mesh_key, d):
        spy = Spy()
        with spy.on():
            out = PIPES[name](torch.distributed.get_world_size())
        return spy.record({"out": _np(out)})
    return case


def case_cli(meshes, mesh_key, d):
    """``wan-t2v --tiny --ulysses-degree <world>`` in the running group:
    only rank 0 writes the latents and prints the JSON line."""
    from jenga_tpu_torch import cli
    world = torch.distributed.get_world_size()
    path = os.path.join(d, "cli_wan.npy")
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        cli.main(["wan-t2v", "--tiny", "--device", "cpu", "--latents-only",
                  "--infer-steps", "2", "--video-size", "64", "64",
                  "--video-length", "9", "--ulysses-degree", str(world),
                  "--save-path", path])
    torch.distributed.barrier()
    return {"stdout": np.array(buf.getvalue()),
            "exists": np.array(os.path.exists(path))}


# ------------------------------------------------------- "extend" suite

# prompt extension under torchrun: rank 0 alone builds the expander and
# extends, every rank takes its text (or its failure). The stubs answer
# each rank with another text, so a rank that extended for itself shows.
EXTEND_ARGS = {
    "api": ["wan-t2v", "--prompt-extend-method", "api"],
    "local": ["wan-t2v", "--prompt-extend-model", "lm"],
    "vl_api": ["wan-i2v", "--prompt-extend-method", "api",
               "--prompt-extend-mode", "vl", "--image", "IMG"],
    "api_fails": ["wan-t2v", "--prompt-extend-method", "api"],
    "vl_without_image": ["wan-t2v", "--prompt-extend-model", "lm",
                         "--prompt-extend-mode", "vl"],
}
EXTEND_PROMPT = "a red fox"


def extend_case(name):
    """``cli._maybe_extend_prompt`` with the ``EXTEND_ARGS[name]`` flags:
    the text this rank returns (or its ``SystemExit`` message, or the
    ``RuntimeError`` it raised), the
    requests its transport took, the expanders and image parts it built
    and the lines it printed. Run without a group, the world-1
    reference."""
    def case(meshes, mesh_key, d):
        import json
        from jenga_tpu_torch import cli
        from jenga_tpu_torch.text import prompt_extend as tpe
        dist = torch.distributed
        rank = dist.get_rank() if dist.is_initialized() else 0
        counts = {"requests": 0, "expanders": 0, "image_parts": 0}

        def post(url, headers, body, timeout):
            counts["requests"] += 1
            if name == "api_fails":
                raise ConnectionError("endpoint unreachable")
            return json.dumps({"output": {"text": f"api text of rank "
                                                  f"{rank}"}}).encode()

        def image_part(image):
            counts["image_parts"] += 1
            return {"type": "image_url", "image_url": {"url": image}}

        def counted(cls):
            class Counted(cls):
                def __init__(self, *a, **k):
                    counts["expanders"] += 1
                    super().__init__(*a, **k)
            return Counted

        class LocalStub:
            def __init__(self, model_dir, *a, **k):
                counts["expanders"] += 1

            def __call__(self, system, user, image=None):
                return f"local text of rank {rank}"

        argv = [a.replace("IMG", os.path.join(d, "img.png"))
                for a in EXTEND_ARGS[name]]
        args = cli.build_parser().parse_args(
            argv + ["--prompt", EXTEND_PROMPT, "--device", "cpu"])
        buf = io.StringIO()
        with mock.patch.object(tpe.APIExpander, "_http_post",
                               staticmethod(post)), \
                mock.patch.object(tpe.APIExpander, "_image_part",
                                  staticmethod(image_part)), \
                mock.patch.object(tpe, "APIExpander",
                                  counted(tpe.APIExpander)), \
                mock.patch.object(tpe, "LocalLLMExpander", LocalStub), \
                mock.patch.object(tpe, "LocalVLExpander", LocalStub), \
                mock.patch("time.sleep"), contextlib.redirect_stdout(buf):
            try:
                out = {"prompt": np.array(cli._maybe_extend_prompt(
                    args, args.prompt))}
            except SystemExit as e:
                out = {"exit": np.array(str(e.code))}
            except RuntimeError as e:
                out = {"error": np.array(f"{type(e).__name__}: {e}")}
        out.update({k: np.array(v) for k, v in counts.items()})
        out["stdout"] = np.array(buf.getvalue())
        return out
    return case


# ------------------------------------------------------- "dryrun" suite

# JAX's _dryrun_worker cases at n = 4 ranks (head dim 128, f32)
N4 = 4
WAN_DRY = dict(dim=128 * N4, ffn_dim=256 * N4, freq_dim=32, num_heads=N4,
               num_layers=1, text_dim=64, text_len=16, dtype="float32")
WAN_DRY_2H = dict(dim=64, ffn_dim=128, freq_dim=32, num_heads=2,
                  num_layers=1, text_dim=32, text_len=8, dtype="float32")


def hy_dry_cfg(heads, i2v=None):
    return dict(hidden_size=128 * heads, heads_num=heads, double_blocks=1,
                single_blocks=1, text_states_dim=128, text_states_dim_2=32,
                dtype="float32", i2v_condition_type=i2v)


# name -> (weights file, HY config kwargs, token grid, latent, carve
# kwargs, mesh key)
HY_DRY = {
    "hy_q8": ("hy_dry4", hy_dry_cfg(N4), (4, 16, 32), (4, 32, 64),
              dict(sa_drop_rate=0.6, q_rows=8, joint_sel=True), "1d"),
    "hy_q16": ("hy_dry4", hy_dry_cfg(N4), (4, 16, 32), (4, 32, 64),
               dict(sa_drop_rate=0.6, q_rows=16, joint_sel=True), "1d"),
    "hy_i2v_tr": ("hy_dry4_tr", hy_dry_cfg(N4, "token_replace"),
                  (4, 16, 32), (4, 32, 64),
                  dict(sa_drop_rate=0.6, q_rows=8, joint_sel=True), "1d"),
    # 297 image tokens: a multiple of neither 4 nor 128
    "hy_uneven": ("hy_dry4", hy_dry_cfg(N4), (3, 9, 11), (3, 18, 22),
                  dict(sa_drop_rate=0.6, q_rows=8, joint_sel=True), "1d"),
    "hy_ring_fallback": ("hy_dry6", hy_dry_cfg(6), (4, 8, 12), (4, 16, 24),
                         dict(sa_drop_rate=0.0), "1d"),
    "hy_ring_ulysses": ("hy_dry2", hy_dry_cfg(2), (4, 16, 32), (4, 32, 64),
                        dict(sa_drop_rate=0.0), "2d"),
    # carved on a ring axis: the warning, then the same dense ring x
    # Ulysses attention (at world 1 its reference is the dense forward;
    # JAX's is its own carved forward on the 2 x 2 mesh)
    "hy_ring_carved": ("hy_dry2", hy_dry_cfg(2), (4, 16, 32), (4, 32, 64),
                       dict(sa_drop_rate=0.6, q_rows=8, joint_sel=True),
                       "2d"),
}


def hy_dry_carve(cfg, grid, kw):
    return thy.make_hy_carve(cfg, grid, kw["sa_drop_rate"], 0.5,
                             text_amp=0.5, txt_block_num=2,
                             q_rows=kw.get("q_rows", 1),
                             joint_sel=kw.get("joint_sel", False))


def hy_dry(name, mesh, d):
    """One HY forward of the dryrun case (world 1: ``mesh=None``)."""
    wfile, cfgkw, grid, lat, kw, _ = HY_DRY[name]
    model = load_model(thy.HYVideoDiT, cfgkw, os.path.join(d, wfile
                                                           + ".npz"))
    carve = hy_dry_carve(model.cfg, grid, kw)
    if mesh is None and name == "hy_ring_carved":
        carve = dataclasses.replace(carve, sa_drop_rate=0.0)
    spy = Spy()
    with spy.on():
        out = hy_forward(model, carve, hy_inputs(cfgkw, lat), mesh)
    return spy.record({"out": _np(out)})


WAN_STEP_SIGMAS = (0.8, 0.6)


def wan_dry_carve(cfg, lat, q_rows=1, joint_sel=False, drop=0.5):
    grid = (lat[0], lat[1] // 2, lat[2] // 2)
    return twan.make_wan_carve(cfg, grid, drop, 0.9, q_rows=q_rows,
                               joint_sel=joint_sel)


def wan_cfg_velocity(model, x, t, ctx2, carve, mesh):
    x2 = torch.cat([x, x])
    v2 = model(x2, torch.full((2,), t), ctx2, carve=carve, mesh=mesh)
    return v2[1:2] + 5.0 * (v2[0:1] - v2[1:2])


def wan_step(mesh, d):
    """JAX's wan_step: a carved CFG step with a first-order flow update,
    at a 10-step UniPC schedule's first two sigmas. On the 2 x 2 mesh the
    tokens are sliced over ``sp`` and copied over ``ring``, and the step
    keeps carving, as in JAX."""
    from jenga_tpu_torch.diffusion.unipc import unipc_schedule
    model = load_model(twan.WanDiT, WAN_DRY, os.path.join(d, "wan_dry.npz"))
    lat = (2, 16, 32)
    x, ctx = wan_inputs(WAN_DRY, lat)
    x, ctx = torch.as_tensor(x), torch.as_tensor(ctx)
    sched = unipc_schedule(10, shift=5.0)
    s0, s1 = float(sched.sigmas[0]), float(sched.sigmas[1])
    spy = Spy()
    with spy.on(), torch.inference_mode():
        v = wan_cfg_velocity(model, x, float(sched.timestep(0)), ctx,
                             wan_dry_carve(model.cfg, lat), mesh)
        x0 = x - s0 * v
        out = (1.0 - s1) * x0 + s1 * (x - (1 - s0) * v) / max(s0, 1e-6)
    return spy.record({"out": _np(out)})


def wan_turbo(mesh, d):
    """JAX's wan_turbo_switch: a carved CFG step at the stage-0 geometry,
    x0, trilinear upsample, re-noise, then a carved CFG velocity at the
    stage-1 geometry (256 -> 512 tokens under the same mesh)."""
    from jenga_tpu_torch.diffusion.prores import trilinear_resize
    model = load_model(twan.WanDiT, WAN_DRY, os.path.join(d, "wan_dry.npz"))
    lat0, lat1 = (2, 16, 32), (2, 32, 32)
    x, ctx = wan_inputs(WAN_DRY, lat0, seed=11)
    noise = np.random.default_rng(12).standard_normal(
        (1, 16, *lat1)).astype(np.float32)
    x, ctx, noise = (torch.as_tensor(a) for a in (x, ctx, noise))
    sig0, sig1 = WAN_STEP_SIGMAS
    spy = Spy()
    with spy.on(), torch.inference_mode():
        v = wan_cfg_velocity(model, x, 800.0, ctx, wan_dry_carve(
            model.cfg, lat0, 2, True), mesh)
        clean = trilinear_resize(x - sig0 * v, lat1)
        mid = (1.0 - sig1) * clean + sig1 * noise
        out = wan_cfg_velocity(model, mid, 600.0, ctx, wan_dry_carve(
            model.cfg, lat1, 2, True), mesh)
    return spy.record({"out": _np(out)})


def wan_ring_fallback(mesh, d):
    """2 heads on 4 ranks, dense: Wan's self-attention runs as ring
    attention."""
    model = load_model(twan.WanDiT, WAN_DRY_2H,
                       os.path.join(d, "wan_dry2h.npz"))
    x, ctx = wan_inputs(WAN_DRY_2H, (2, 8, 16), seed=1)
    spy = Spy()
    with spy.on(), torch.inference_mode():
        out = model(torch.as_tensor(x), torch.tensor([300.0]),
                    torch.as_tensor(ctx[:1]), mesh=mesh)
    return spy.record({"out": _np(out)})


def wan_carved_bad_heads(mesh, d):
    """Carved with 2 heads on 4 ranks: ValueError, as in JAX."""
    model = load_model(twan.WanDiT, WAN_DRY_2H,
                       os.path.join(d, "wan_dry2h.npz"))
    carve = wan_dry_carve(model.cfg, (2, 16, 32), drop=0.75)
    try:
        with torch.inference_mode():
            model(torch.zeros((1, 16, 2, 16, 32)), torch.tensor([300.0]),
                  torch.zeros((1, 8, 32)), carve=carve, mesh=mesh)
    except ValueError as e:
        return {"message": np.array(str(e))}
    return {"message": np.array("")}


def dry_case(fn, name=None, key=None):
    def case(meshes, mesh_key, d):
        k = HY_DRY[name][5] if name else key or mesh_key
        return fn(name, meshes[k], d) if name else fn(meshes[k], d)
    return case


SUITES = {
    "parallel": {
        **{f"op/{n}": (lambda n: lambda m, k, d: op_run(n, m))(n)
           for n in OPS},
        "init": case_init, "mesh_message": case_mesh_message,
        "fsdp_hy": case_fsdp_hy, "fsdp_wan": case_fsdp_wan,
        **{f"pipe/{n}": pipe_case(n) for n in PIPES},
        "cli": case_cli, "multihost": case_multihost,
        "sel_mask": case_sel_mask,
    },
    "dryrun": {
        "wan_step": dry_case(wan_step), "wan_turbo": dry_case(wan_turbo),
        "wan_step_2d": dry_case(wan_step, key="2d"),
        "wan_ring_fallback": dry_case(wan_ring_fallback),
        "wan_carved_bad_heads": dry_case(wan_carved_bad_heads),
        **{n: dry_case(hy_dry, n) for n in HY_DRY},
    },
    "extend": {n: extend_case(n) for n in EXTEND_ARGS},
}
# cases that need the 2 x 2 mesh, and those only a world of 2 runs
NEEDS_2D = {"op/ring_ulysses", "op/ring_ulysses_uneven", "bad_heads"}
WORLD2_ONLY = {"cli", "mesh_message", "sel_mask"}
WORLD4_ONLY = {"multihost"}
SUITES["parallel"]["bad_heads"] = case_bad_heads


def cases_for(suite: str, world: int) -> list[str]:
    names = []
    for name in SUITES[suite]:
        if name in NEEDS_2D and world != 4:
            continue
        if name in WORLD2_ONLY and world != 2:
            continue
        if name in WORLD4_ONLY and world != 4:
            continue
        names.append(name)
    return names


def start_ranks(suite: str, world: int, d: str):
    """Start the ``world`` rank processes of ``suite`` on directory ``d``
    (the store lives there too); ``finish_ranks`` collects them."""
    import subprocess
    store = os.path.join(d, f"store{world}")
    env = dict(os.environ, OMP_NUM_THREADS="1")
    env.pop("WORLD_SIZE", None)
    return [subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), suite, str(r),
         str(world), store, d], cwd=ROOT, env=env, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True) for r in range(world)]


def finish_ranks(procs, d: str, timeout: float):
    """Every rank's results and output, after each exits 0 within
    ``timeout`` seconds (one rank that fails or hangs fails them all;
    none is left running)."""
    import subprocess
    logs = []
    try:
        for p in procs:
            try:
                logs.append(p.communicate(timeout=timeout)[0])
            except subprocess.TimeoutExpired:
                logs.append(f"timed out after {timeout} s")
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    for r, (p, log) in enumerate(zip(procs, logs)):
        if p.returncode != 0 or "RANK_OK" not in log:
            raise AssertionError(f"rank {r} of {len(procs)} failed "
                                 f"(rc {p.returncode}):\n{log[-4000:]}")
    out = []
    for r in range(len(procs)):
        with np.load(os.path.join(d, f"w{len(procs)}",
                                  f"rank{r}.npz")) as z:
            res = {}
            for key in z.files:
                case, name = key.split("|", 1)
                res.setdefault(case, {})[name] = z[key]
        out.append(res)
    return out, logs


def main():
    suite, rank, world, store, d = sys.argv[1:6]
    rank, world = int(rank), int(world)
    torch.set_num_threads(1)
    pmesh.init_distributed("cpu", init_method=f"file://{store}",
                           world_size=world, rank=rank)
    meshes = {"1d": pmesh.make_sp_mesh(device="cpu")}
    if world == 4:
        meshes["2d"] = pmesh.make_sp_mesh(ring=2, device="cpu")
    out = {}
    for name in cases_for(suite, world):
        try:
            res = SUITES[suite][name](meshes, "1d", d)
        except Exception:
            print(f"case {name} failed on rank {rank}", flush=True)
            traceback.print_exc()
            raise
        out.update({f"{name}|{k}": v for k, v in res.items()})
    os.makedirs(os.path.join(d, f"w{world}"), exist_ok=True)
    np.savez(os.path.join(d, f"w{world}", f"rank{rank}.npz"), **out)
    torch.distributed.destroy_process_group()
    print("RANK_OK", flush=True)


if __name__ == "__main__":
    main()
